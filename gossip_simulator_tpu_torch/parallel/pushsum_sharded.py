"""Mesh-sharded PushSum: numeric mass gossip on S shards of one device
(the JAX package's ``parallel/pushsum_sharded.py``).

Each shard drains its own slot of the mail ring with the SUM combine, and
the emission routes (value, weight) mass shares to their destination's
owner shard: the mass limbs ride the exchange as one ``(M, C)`` payload
beside the packed wire word, and land in the owner's wide ring through
``fused_recv_land`` under ``-phase2-kernel auto|pallas`` (its words
form), through the decode and ring-append chain under ``xla``.

PushSum draws only (tick, global id)-keyed delays off the unfolded base
key and its deposits are integer adds, which commute, so S = 1 and S = 8
give the same mass states.  The drain chunk count is pmax-agreed (one
host read under ``xla``; the pallas drain reads the count on the card);
the converged count is summed and the relative error's maximum taken
over the shards.  Route overflow goes to ``exchange_overflow``, slot
overflow to ``mail_dropped``: either destroys mass, and both stay 0.
The float32 metric is the single-device engine's (``pushsum.metric_rel``),
computed per shard on the same rows, so nothing compiled by nvcc touches
it.

Fault scenarios run per shard at the window's start on global ids off
the unfolded key, the partition mask on global (src, dst) ids inside the
emission, and ``-overlay-heal on`` only clears the reboot markers, a
shard-local pass: so a scenario run too is the same at every shard count.

Under ``-telemetry-spatial on`` the route counts its traffic into the
shards' ``exch_counts`` and the run-to-target loop
(``make_run_to_coverage_fn``) records the panels.  It takes
``-exchange-pipeline double`` as the JAX package does: its one route a
window stays serial, and the history's ``exchange_inflight_hwm`` reads 2.
"""

from __future__ import annotations

import torch

from gossip_simulator_tpu_torch.config import Config
from gossip_simulator_tpu_torch.models import event, graphs, pushsum
from gossip_simulator_tpu_torch.ops import mailbox, megakernel
from gossip_simulator_tpu_torch.parallel import exchange
from gossip_simulator_tpu_torch.parallel.event_sharded import _check_packing
from gossip_simulator_tpu_torch.parallel.mesh import (Mesh, pmax, psum,
                                                      shard_size)

I32 = torch.int32
I64 = torch.int64
F32 = torch.float32


def make_sharded_pushsum_init(cfg: Config, mesh: Mesh):
    """Per-shard graph slices and PushSum states (row-keyed generators and
    gid-keyed masses: the slices of a one-device init)."""
    n_local = shard_size(cfg.n, mesh)

    def init():
        key = graphs.graph_key(cfg, mesh.device)
        states = []
        for i in range(mesh.n_shards):
            friends, cnt = graphs.generate(cfg, key, row0=i * n_local,
                                           rows=n_local, static_row0=False)
            states.append(pushsum.init_state(cfg, friends, cnt,
                                             gid0=i * n_local,
                                             n_shards=mesh.n_shards))
        return states

    return init


def _mass_append(cfg: Config, n_local: int, st, dropped, payload, rows,
                 wslot, valid) -> None:
    """Append packed entries and their mass rows into the shard's rings,
    in place."""
    dw = pushsum.ring_windows(cfg)
    cap = (st.mail_ids.shape[0] - pushsum.ring_tail(cfg, n_local)) // dw
    mailbox.ring_append((st.mail_ids, st.mail_mass), st.mail_cnt, dropped,
                        (payload.to(I32), rows), wslot.to(I32), valid, dw,
                        cap, kernel=cfg.deliver_kernel_resolved)


def _route_append_mass(cfg: Config, n_local: int, states, drops, xovfs,
                       dst, wslot, off, valid, rcap: int, share,
                       phase2: str = "xla") -> None:
    """Route mass shares (per source shard) to their owner shards and
    append them, in place (the route's traffic counted into the shards'
    ``exch_counts`` under -telemetry-spatial on).  One shard appends
    directly: the route is the identity there."""
    s = len(states)
    b = pushsum.batch_ticks(cfg)
    dw = pushsum.ring_windows(cfg)
    if s == 1:
        _mass_append(cfg, n_local, states[0], drops[0], dst[0] * b + off[0],
                     share[0], wslot[0], valid[0])
        return
    dest = [torch.where(v, d // n_local, s).to(I32)
            for d, v in zip(dst, valid)]
    wire = [torch.where(v, (d % n_local) * (dw * b) + w * b + o, -1).to(I32)
            for d, w, o, v in zip(dst, wslot, off, valid)]
    traffic = ([st.exch_counts for st in states]
               if cfg.telemetry_spatial_enabled else None)
    recvs, ovfs = exchange.route_multi(list(zip(wire, share)), dest, valid,
                                       s, rcap, traffic=traffic)
    for d, st in enumerate(states):
        xovfs[d] += ovfs[d]
        recv, rows = recvs[d]
        if phase2 == "pallas":
            cap = (st.mail_ids.shape[0]
                   - pushsum.ring_tail(cfg, n_local)) // dw
            megakernel.fused_recv_land(
                st.mail_ids, st.mail_cnt, drops[d], recv, dw=dw, cap=cap,
                b=b, words=rows, mail_words=st.mail_mass)
        else:
            # Empty wire slots carry -1 in every column; their rows never
            # land (a stray add would create mass).
            entry, rw, live, _ = megakernel.recv_decode(recv, dw=dw, b=b)
            _mass_append(cfg, n_local, st, drops[d], entry, rows, rw, live)


def make_sharded_pushsum_step(cfg: Config, mesh: Mesh):
    """One B-tick window of every shard, in place: drain, normalize, the
    float32 metric, emission and the routed append."""
    s = mesh.n_shards
    n_local = shard_size(cfg.n, mesh)
    b = pushsum.batch_ticks(cfg)
    dw = pushsum.ring_windows(cfg)
    cap = pushsum.slot_cap(cfg, n_local)
    ccap = pushsum.drain_chunk(cfg, n_local)
    dim = cfg.pushsum_dim
    ncol = pushsum.mass_cols(cfg)
    tgt = pushsum.eps_target(cfg)
    dkern = cfg.deliver_kernel_resolved
    p2 = cfg.phase2_kernel_resolved
    k = cfg.graph_width
    _check_packing(cfg, n_local, b, dw)
    # Every live node emits <= k lanes a window: the zero-loss-leaning
    # per-pair bound (overflow counted; it destroys mass, so it stays 0).
    rcap = min(exchange.epidemic_cap(n_local, k, s), n_local * k)

    def step_fn(states, base_key: torch.Tensor):
        dev = states[0].mass.device
        tick = states[0].tick
        slot = (tick // b) % dw
        lane_ids = torch.arange(n_local, dtype=I32, device=dev)
        # Scenario faults: (window, global id)-keyed off the unfolded key.
        fault_d = [event.apply_fault_window_flags(
            cfg, st, i * n_local + lane_ids, base_key, b)
            for i, st in enumerate(states)]
        if p2 == "pallas":
            # The whole slot in one pass per shard (integer adds commute,
            # so any chunking gives the same bits).
            for st in states:
                megakernel.fused_drain_sum(st.mass, st.mail_ids,
                                           st.mail_mass, st.mail_cnt, slot,
                                           cap=cap, b=b)
        else:
            ms = torch.stack([st.mail_cnt[0, slot] for st in states]).tolist()
            lane = torch.arange(ccap, dtype=I32, device=dev)
            for j in range((max(ms) + ccap - 1) // ccap):
                off0 = slot * cap + j * ccap
                for st, m in zip(states, ms):
                    mailbox.deposit_sum(
                        st.mass, torch.div(st.mail_ids[off0:off0 + ccap], b,
                                           rounding_mode="floor"),
                        st.mail_mass[off0:off0 + ccap],
                        j * ccap + lane < m, kernel=dkern)
        recvs, reps, lanes, blks = [], [], [], []
        dst, wsl, offs, valid, shares = [], [], [], [], []
        for i, st in enumerate(states):
            gids = i * n_local + lane_ids
            m3 = pushsum._normalize(st.mass.view(n_local, dim + 1,
                                                 pushsum.LIMBS))
            crashed = (st.flags & event.CRASHED) > 0
            rel, rep = pushsum.metric_rel(cfg, m3, crashed)
            conv = rel <= torch.tensor(cfg.pushsum_eps, dtype=F32,
                                       device=dev)
            st.flags = torch.where(conv, st.flags | event.RECEIVED,
                                   st.flags & (0xFF ^ event.RECEIVED))
            recvs.append(conv.sum())
            reps.append(rep.max())
            new_m3, share, d, w, o, lane_valid, blk = pushsum.emit_shares(
                cfg, m3, crashed, st.friends, st.friend_cnt, tick, gids,
                base_key)
            blks.append(blk)
            st.mass = new_m3.reshape(n_local, ncol)
            dst.append(d)
            wsl.append(w)
            offs.append(o)
            valid.append(lane_valid)
            shares.append(share)
            lanes.append(lane_valid.sum())
        drops = [torch.zeros((), dtype=I32, device=dev) for _ in range(s)]
        xovfs = [torch.zeros((), dtype=I32, device=dev) for _ in range(s)]
        _route_append_mass(cfg, n_local, states, drops, xovfs, dst, wsl,
                           offs, valid, rcap, shares, phase2=p2)
        recv = psum(recvs)
        maxrel = pmax(reps)
        relerr = (maxrel * torch.tensor(1e9, dtype=F32, device=dev)).to(
            I32).to(I64)
        dm = psum(lanes)
        ddrop, dxovf = psum(drops).to(I32), psum(xovfs).to(I64)
        dsc = sum(f[0] for f in fault_d)
        dsr = sum(f[1] for f in fault_d)
        dpart = psum(blks)
        new_tick = tick + b
        for st in states:
            st.mail_cnt[0, slot] = 0
            st.eps_tick = torch.where((st.eps_tick < 0) & (recv >= tgt),
                                      torch.full_like(st.eps_tick, new_tick),
                                      st.eps_tick)
            st.tick = new_tick
            st.total_message += dm
            st.total_received = recv.clone()
            st.mail_dropped += ddrop
            st.exchange_overflow += dxovf
            st.relerr_ppb = relerr.clone()
            st.scen_crashed += dsc
            st.scen_recovered += dsr
            st.part_dropped += dpart
        return states

    return step_fn


def make_sharded_pushsum_heal(cfg: Config, mesh: Mesh):
    """Reboot-marker clearing on every shard (None when -overlay-heal is
    off): pushsum.make_heal_fn's pass, shard-local, so it needs no
    collective."""
    heal = pushsum.make_heal_fn(cfg)
    if heal is None:
        return None

    def heal_fn(states, base_key: torch.Tensor):
        for st in states:
            heal(st, base_key)
        return states

    return heal_fn


def make_window_fn(cfg: Config, mesh: Mesh, window: int):
    """Advance ~`window` simulated ms: ceil(window / B) window steps, then
    (-overlay-heal on) the healing pass."""
    step = make_sharded_pushsum_step(cfg, mesh)
    heal = make_sharded_pushsum_heal(cfg, mesh)
    steps = max(1, -(-window // pushsum.batch_ticks(cfg)))

    def window_fn(states, base_key: torch.Tensor):
        for _ in range(steps):
            step(states, base_key)
        if heal is not None:
            heal(states, base_key)
        return states

    return window_fn


def make_seed_fn(cfg: Config, mesh: Mesh):
    """No-op: every node's mass exists from init."""

    def seed_fn(states, base_key: torch.Tensor):
        return states

    return seed_fn


def make_run_to_coverage_fn(cfg: Config, mesh: Mesh):
    """The sharded PushSum run-to-target loop: the test of
    pushsum.make_run_to_coverage_fn, its in-flight term over every shard
    (past the first batch, and not under -overlay-heal on); the probe over
    every shard."""
    from gossip_simulator_tpu_torch.models.state import in_flight
    from gossip_simulator_tpu_torch.utils import telemetry as telem

    window = make_window_fn(cfg, mesh, 10)
    max_steps = cfg.max_rounds
    ihwm = exchange.inflight_hwm(cfg, mesh.n_shards)
    spatial = telem.spatial_spec(cfg, mesh.n_shards)
    b = pushsum.batch_ticks(cfg)
    check_in_flight = not cfg.overlay_heal_resolved

    def live(states, target_count: int, until: int) -> bool:
        st = states[0]
        if st.tick >= max_steps or st.tick >= until:
            return False
        if st.tick < b or not check_in_flight:
            return int(st.total_received) < target_count
        alive = torch.stack([in_flight(x) for x in states]).any()
        recv, alive = torch.stack([st.total_received,
                                   alive.to(torch.int64)]).tolist()
        return recv < target_count and bool(alive)

    def run_fn(states, base_key, target_count: int, until: int, hist=None):
        while live(states, target_count, until):
            window(states, base_key)
            if hist is not None:
                rel = states[0].relerr_ppb
                telem.record_window(hist, telem.gossip_probe(
                    states[0], False, inflight_hwm=ihwm, relerr=rel,
                    shards=states), states, spatial, relerr=rel)
        return states, hist

    return run_fn
