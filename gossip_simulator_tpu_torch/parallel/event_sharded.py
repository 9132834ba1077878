"""Mesh-sharded event engine: S shards of the event-list engine on one
device (the JAX package's ``parallel/event_sharded.py``, serial exchange
schedule).

Each shard drains its own packed mail ring locally, and each emission
batch routes every message to its destination's owner shard
(``parallel/exchange.py``), where the wire word ``dst_local * (dw*B) +
wslot * B + off`` lands in that shard's ring: through ``fused_recv_land``
under ``-phase2-kernel auto|pallas``, through the decode, filter and
ring-append chain under ``xla``.  The shards run in lockstep as a loop
over a list of per-shard ``EventState``s (``parallel/mesh.py``); every
replicated counter (tick, totals) is kept equal on every shard.

Collective counts are pmax-agreed, as in the JAX package, so every shard
runs the same schedule: the drain chunks per window (one host read of
the slots' counts) and the compacted emission batches per chunk
(``event.batch_schedule`` on the largest shard's sender count, one host
read).  Per-window deltas are summed over the shards.

Differences from the single-device engine, as in the JAX package:
* the step key is folded per shard (``fold_in(base_key, shard)``), so
  crash, drop, delay and removal draws differ from a one-device run's;
  the seed draws from the unfolded key;
* duplicate suppression is split around the exchange: locally-owned
  destinations are filtered before the route, routed arrivals at the
  receiving shard;
* at S = 1 the route is the identity and is skipped (DIRECT_SELF_APPEND):
  SI emits through ``event.append_messages``, SIR appends its edges then
  its triggers directly;
* destination-uniform graphs (kout, erdos) size each batch's per-pair
  wire buffer with ``exchange.chernoff_cap``; overflow is counted in
  ``exchange_overflow``, slot overflow in ``mail_dropped``;
* SIR re-broadcast triggers are shard-local and never cross the
  exchange.

Not yet ported: the pipelined schedule (``-exchange-pipeline double``,
ROADMAP A13), the sharded fault branches (scenarios and healing run on
one device; their sharded heal and exchange-route partition mask are
A13), the rumor words (A11) and the spatial panels (the rest of A6,
with A13).  The run-to-target loop (``make_run_to_coverage_fn``) runs
the lockstep shard list a poll window at a time.
"""

from __future__ import annotations

import torch

from gossip_simulator_tpu_torch.config import Config
from gossip_simulator_tpu_torch.models import epidemic, event, graphs
from gossip_simulator_tpu_torch.ops import megakernel
from gossip_simulator_tpu_torch.ops.mailbox import ring_append
from gossip_simulator_tpu_torch.parallel import exchange
from gossip_simulator_tpu_torch.parallel.mesh import Mesh, psum, shard_size
from gossip_simulator_tpu_torch.utils import rng as _rng

I32 = torch.int32
I64 = torch.int64


def make_sharded_event_init(cfg: Config, mesh: Mesh):
    """Per-shard graph slices and event states.  The generators are keyed
    by global row, so a slice equals that row block of a one-device
    table; like the JAX package's traced row0, the slices never take the
    static-offset ``erdos_pallas`` path."""
    n_local = shard_size(cfg.n, mesh)

    def init():
        key = graphs.graph_key(cfg, mesh.device)
        states = []
        for i in range(mesh.n_shards):
            friends, cnt = graphs.generate(cfg, key, row0=i * n_local,
                                           rows=n_local, static_row0=False)
            states.append(event.init_state(cfg, friends, cnt))
        return states

    return init


def _ring_append(cfg: Config, n_local: int, st, dropped, payload, wslot,
                 valid) -> None:
    """Append one packed entry per True in `valid` into its `wslot` slot of
    the shard's ring, in place (overflow counted in the int32 `dropped`)."""
    dw = event.ring_windows(cfg)
    cap = (st.mail_ids.shape[0] - event.ring_tail(cfg, n_local)) // dw
    ring_append((st.mail_ids,), st.mail_cnt, dropped, (payload.to(I32),),
                wslot.to(I32), valid, dw, cap,
                kernel=cfg.deliver_kernel_resolved)


def _append_local_triggers(cfg: Config, n_local: int, st, dropped, rows,
                           strig, wslot, off) -> None:
    """Append SIR re-broadcast triggers (``trigger_base + row*b + off``)
    into the shard's own ring: triggers never cross shards.  An all-False
    mask reserves nothing (its lanes write the trash cell)."""
    b = event.batch_ticks(cfg)
    tb = event.trigger_base(n_local, b)
    _ring_append(cfg, n_local, st, dropped, tb + rows * b + off, wslot,
                 strig)


def _route_and_append(cfg: Config, n_local: int, states, drops, xovfs,
                      dst, wslot, off, valid, rcap: int,
                      suppress: bool = False, phase2: str = "xla"):
    """Route (global dst, window slot, tick offset) messages, given per
    source shard, to their owner shards and append them into the owners'
    rings, in place; `drops` and `xovfs` are the shards' int32 slot and
    route overflow counters.  With `suppress`, locally-owned duplicate
    destinations are filtered before the route and routed arrivals at the
    receiving shard; returns each shard's suppressed counts per arrival
    window, sup[dw]."""
    s = len(states)
    b = event.batch_ticks(cfg)
    dw = event.ring_windows(cfg)
    dev = states[0].mail_ids.device
    valid = list(valid)
    sups = []
    for i, st in enumerate(states):
        sup = torch.zeros(dw, dtype=I32, device=dev)
        if suppress:
            if s == 1:
                local, dstl = valid[i], dst[i]
            else:
                local = valid[i] & (dst[i] // n_local == i)
                dstl = dst[i] % n_local
            dup = local & ((st.flags[torch.where(local, dstl, 0).long()]
                            & event.RECEIVED) > 0)
            sup.index_add_(0, wslot[i].long(), dup.to(I32))
            valid[i] = valid[i] & ~dup
        sups.append(sup)
    if s == 1:
        # The tiled one-shard all_to_all is the identity on entry order.
        _ring_append(cfg, n_local, states[0], drops[0], dst[0] * b + off[0],
                     wslot[0], valid[0])
        return sups
    dest = [torch.where(v, d // n_local, s).to(I32)
            for d, v in zip(dst, valid)]
    wire = [torch.where(v, (d % n_local) * (dw * b) + w * b + o, -1).to(I32)
            for d, w, o, v in zip(dst, wslot, off, valid)]
    recvs, ovfs = exchange.route_one(wire, dest, valid, s, rcap)
    for d, st in enumerate(states):
        xovfs[d] += ovfs[d]
        flags = st.flags if suppress else None
        if phase2 == "pallas":
            cap = (st.mail_ids.shape[0] - event.ring_tail(cfg, n_local)) // dw
            rsup = megakernel.fused_recv_land(
                st.mail_ids, st.mail_cnt, drops[d], recvs[d], dw=dw,
                cap=cap, b=b, flags=flags, received_bit=event.RECEIVED)[3]
        else:
            entry, rw, live, rsup = megakernel.recv_decode(
                recvs[d], dw=dw, b=b, flags=flags,
                received_bit=event.RECEIVED)
            _ring_append(cfg, n_local, st, drops[d], entry, rw, live)
        sups[d] += rsup
    return sups


def _check_packing(cfg: Config, n_local: int, b: int, dw: int) -> None:
    if n_local * dw * b >= 2**31:
        raise ValueError(
            f"wire packing overflow: n_local ({n_local}) * dw ({dw}) * B "
            f"({b}) must stay below 2^31; use more shards")
    if cfg.protocol == "sir" and (2 * n_local + 3) * b >= 2**31:
        raise ValueError(
            f"SIR trigger packing overflow: (2*n_local+3) ({2*n_local+3}) "
            f"* B ({b}) must stay below 2^31; use more shards")


def make_sharded_event_step(cfg: Config, mesh: Mesh):
    """One B-tick window transition of every shard, in place."""
    s = mesh.n_shards
    n_local = shard_size(cfg.n, mesh)
    b = event.batch_ticks(cfg)
    dw = event.ring_windows(cfg)
    ccap = event.drain_chunk(cfg, n_local)
    tail = event.ring_tail(cfg, n_local)
    crash_p = epidemic.p_eff(cfg, cfg.crashrate)
    drop_p = epidemic.p_eff(cfg, cfg.droprate)
    sir = cfg.protocol == "sir"
    removal_p = epidemic.p_eff(cfg, cfg.removal_rate) if sir else 0.0
    _check_packing(cfg, n_local, b, dw)
    scap = event.sender_compaction_cap(cfg, ccap)
    suppress = cfg.dup_suppress_resolved
    # Destination-uniform graphs size each batch's per-pair wire buffer
    # from its high-water mark; ring lattices can concentrate a batch on
    # one pair and keep the zero-loss bound.
    uniform_dest = cfg.graph in ("kout", "erdos")
    p2 = cfg.phase2_kernel_resolved
    dkern = cfg.deliver_kernel_resolved
    direct_si = s == 1 and not sir

    def wire_cap(m_edges: int) -> int:
        return exchange.chernoff_cap(m_edges, s) if uniform_dest else m_edges

    def emit(states, skeys, drops, xovfs, sups, batches, width: int,
             ecap: int) -> None:
        """Route one batch of senders per shard (`batches`: (sids,
        svalid, sticks) each) at a static `width`: the delay and drop
        draws, SIR removal, the exchange and ring append, then SIR's
        local triggers."""
        if direct_si:
            # One-shard SI: the emission IS the one-device append.
            st = states[0]
            sids, svalid, sticks = batches[0]
            _, _, dropped, sa, _ = event.append_messages(
                cfg, st.mail_ids, st.mail_cnt, drops[0], sids, svalid,
                sticks, st.friends, skeys[0],
                flags=st.flags if suppress else None, kernel=dkern,
                phase2=p2)
            drops[0].copy_(dropped)
            sups[0] += sa
            return
        dst, wsl, offs, valid, trig = [], [], [], [], []
        for st, skey, (sids, svalid, sticks) in zip(states, skeys, batches):
            kwidth = st.friends.shape[1]
            rows = torch.where(svalid, sids, n_local)
            sf = st.friends[torch.where(svalid, sids, 0).long()]
            dk = event._sender_keys(skey, _rng.OP_DELAY, sticks, rows)
            pk = event._sender_keys(skey, _rng.OP_DROP, sticks, rows)
            delay = torch.clamp_min(
                _rng.randint(dk, (), cfg.delaylow, cfg.delayhigh), 1)
            drop = _rng.bernoulli_masked(pk, drop_p, (kwidth,))
            arrive = sticks + delay
            wslot2 = (arrive // b) % dw
            off2 = arrive % b
            if sir:
                # Removal at the send tick, before the route; survivors
                # schedule their next trigger locally.
                strig = event._remove_draw(st.flags, skey, removal_p,
                                           sticks, sids, svalid, n_local)
                trig.append((rows, strig, wslot2, off2))
            edge = svalid[:, None] & ~drop & (sf >= 0)
            dst.append(torch.where(edge, sf, 0).reshape(-1))
            wsl.append(wslot2[:, None].expand(width, kwidth).reshape(-1))
            offs.append(off2[:, None].expand(width, kwidth).reshape(-1))
            valid.append(edge.reshape(-1))
        for sup, sa in zip(sups, _route_and_append(
                cfg, n_local, states, drops, xovfs, dst, wsl, offs, valid,
                ecap, suppress=suppress, phase2=p2)):
            sup += sa
        for st, dropped, t in zip(states, drops, trig):
            _append_local_triggers(cfg, n_local, st, dropped, *t)

    def step_fn(states, base_key: torch.Tensor):
        dev = states[0].mail_ids.device
        skeys = [_rng.fold_in(base_key, i) for i in range(s)]
        tick = states[0].tick
        w = tick // b
        slot = w % dw
        cap0 = (states[0].mail_ids.shape[0] - tail) // dw
        # One host read: every slot's entry count and the (replicated)
        # received count that gates pre-drain compaction.
        *ms, recv = torch.stack(
            [st.mail_cnt[0, slot].to(I64) for st in states]
            + [states[0].total_received]).tolist()
        dms = [st.sup_cnt[0, slot].to(I64) for st in states]
        if suppress and recv >= int(event.PREDRAIN_MIN_RECV_FRAC * cfg.n):
            kept = []
            for i, st in enumerate(states):
                _, k, fdat = event.predrain_compact(
                    b, n_local, dw, cap0, ccap, sir, st.flags, st.mail_ids,
                    slot, ms[i])
                kept.append(k)
                dms[i] = dms[i] + fdat
            ms = torch.stack(kept).tolist()
        chunks = (max(ms) + ccap - 1) // ccap
        ckeys = [_rng.tick_key(k, w, _rng.OP_CRASH) for k in skeys]
        kwidth = states[0].friends.shape[1]
        rcap = (wire_cap(ccap * kwidth) if uniform_dest
                else min(exchange.epidemic_cap(n_local, kwidth, s),
                         ccap * kwidth))
        drops = [torch.zeros((), dtype=I32, device=dev) for _ in range(s)]
        xovfs = [torch.zeros((), dtype=I32, device=dev) for _ in range(s)]
        sups = [st.sup_cnt[0] for st in states]
        drs = [torch.zeros((), dtype=I64, device=dev) for _ in range(s)]
        dcs = [torch.zeros((), dtype=I64, device=dev) for _ in range(s)]
        lane = torch.arange(ccap, dtype=I32, device=dev)
        for j in range(chunks):
            entry_pos = j * ccap + lane
            drained = []
            for i, st in enumerate(states):
                start = slot * cap0 + j * ccap
                _, cdm, cdr, cdc, ids_s, toff_s, senders = \
                    event.drain_chunk_core(
                        crash_p, b, n_local, st.flags,
                        st.mail_ids[start:start + ccap], entry_pos < ms[i],
                        entry_pos, ckeys[i], sir=sir)
                dms[i], drs[i], dcs[i] = dms[i] + cdm, drs[i] + cdr, \
                    dcs[i] + cdc
                drained.append((ids_s, toff_s, senders))
            if not scap:
                emit(states, skeys, drops, xovfs, sups,
                     [(ids_s, senders, w * b + toff_s)
                      for ids_s, toff_s, senders in drained], ccap, rcap)
                continue
            # Sender compaction on the pmax-agreed sender count: every
            # shard runs the same batches.
            comp = []
            for ids_s, toff_s, senders in drained:
                comp.append((senders, torch.cumsum(senders, dim=0,
                                                   dtype=I32) - 1,
                             ids_s * b + toff_s))
            scnts = torch.stack([c[0].sum() for c in comp]).tolist()
            for width, lo in event.batch_schedule(max(scnts), scap):
                batches = []
                for (senders, srank, spacked), scnt in zip(comp, scnts):
                    sids, stoff, svalid = event.sender_batch(
                        senders, srank, scnt, spacked, b, width, 0, lo=lo)
                    batches.append((sids, svalid, w * b + stoff))
                emit(states, skeys, drops, xovfs, sups, batches, width,
                     wire_cap(width * kwidth))
        dm, dr, dc = psum(dms), psum(drs), psum(dcs)
        ddrop, dxovf = psum(drops).to(I64), psum(xovfs).to(I64)
        for st in states:
            # Appends during the drain target later windows only.
            st.mail_cnt[0, slot] = 0
            st.sup_cnt[0, slot] = 0
            st.tick += b
            st.total_message += dm
            st.total_received += dr
            st.total_crashed += dc
            st.mail_dropped += ddrop
            st.exchange_overflow += dxovf
        return states

    return step_fn


def make_seed_fn(cfg: Config, mesh: Mesh):
    """Uniform-random global sender: every shard draws the same sender from
    the unfolded key, only its owner emits, and the messages ride the
    route (the xla chain, as in the JAX package's seed)."""
    s = mesh.n_shards
    n_local = shard_size(cfg.n, mesh)
    b = event.batch_ticks(cfg)
    dw = event.ring_windows(cfg)

    def seed_fn(states, base_key: torch.Tensor):
        dev = states[0].mail_ids.device
        ks = _rng.tick_key(base_key, epidemic.SEED_TICK, _rng.OP_SEED_NODE)
        kd = _rng.tick_key(base_key, epidemic.SEED_TICK, _rng.OP_DELAY)
        kp = _rng.tick_key(base_key, epidemic.SEED_TICK, _rng.OP_DROP)
        sender = int(_rng.randint(ks, (), 0, cfg.n))
        owner, own_row = divmod(sender, n_local)
        kwidth = states[0].friends.shape[1]
        delay = max(int(_rng.randint(_rng.fold_in(kd, sender), (),
                                     cfg.delaylow, cfg.delayhigh)), 1)
        drop = _rng.bernoulli_masked(_rng.fold_in(kp, sender),
                                     epidemic.p_eff(cfg, cfg.droprate),
                                     (kwidth,))
        arrive = states[0].tick + delay
        mark = cfg.protocol == "sir" or not cfg.compat_reference
        lanes = torch.arange(kwidth, dtype=I32, device=dev)
        dst, valid = [], []
        for i, st in enumerate(states):
            srow = own_row if i == owner else 0
            sf = st.friends[srow]
            edge = ((lanes < st.friend_cnt[srow]) & ~drop & (sf >= 0)
                    & (i == owner))
            if mark and i == owner:
                st.flags[srow] |= event.RECEIVED
            dst.append(torch.where(edge, sf, 0))
            valid.append(edge)
        wslot = torch.full((kwidth,), (arrive // b) % dw, dtype=I32,
                           device=dev)
        off = torch.full((kwidth,), arrive % b, dtype=I32, device=dev)
        drops = [torch.zeros((), dtype=I32, device=dev) for _ in range(s)]
        xovfs = [torch.zeros((), dtype=I32, device=dev) for _ in range(s)]
        # The seed emits at most kwidth messages in all.
        rcap = min(exchange.epidemic_cap(n_local, kwidth, s), kwidth)
        _route_and_append(cfg, n_local, states, drops, xovfs, dst,
                          [wslot] * s, [off] * s, valid, rcap)
        if cfg.protocol == "sir":
            # The seed's removal draw decides its re-broadcast trigger
            # (replicated key; only the owner appends one).
            kr = _rng.tick_key(base_key, epidemic.SEED_TICK, _rng.OP_REMOVE)
            keep = not bool(_rng.bernoulli_masked(
                kr, epidemic.p_eff(cfg, cfg.removal_rate), ()))
            for i, (st, dropped) in enumerate(zip(states, drops)):
                own = torch.tensor([i == owner and keep], device=dev)
                _append_local_triggers(
                    cfg, n_local, st, dropped,
                    torch.tensor([own_row if i == owner else 0],
                                 dtype=I32, device=dev),
                    own, wslot[:1], off[:1])
        ddrop, dxovf = psum(drops).to(I64), psum(xovfs).to(I64)
        for st in states:
            if mark:
                st.total_received += 1
            st.mail_dropped += ddrop
            st.exchange_overflow += dxovf
        return states

    return seed_fn


def make_window_fn(cfg: Config, mesh: Mesh, window: int):
    """Advance ~`window` simulated ms: ceil(window / B) window steps."""
    step = make_sharded_event_step(cfg, mesh)
    steps = max(1, -(-window // event.batch_ticks(cfg)))

    def window_fn(states, base_key: torch.Tensor):
        for _ in range(steps):
            step(states, base_key)
        return states

    return window_fn


def make_run_to_coverage_fn(cfg: Config, mesh: Mesh):
    """The sharded event engine's run-to-target loop
    (event.make_run_to_coverage_fn's test, the in-flight term over every
    shard), the lockstep shard list run a poll window at a time; the
    probe reads the replicated totals from shard 0, the removed count
    summed and the mail high-water largest over the shards."""
    from gossip_simulator_tpu_torch.models.state import in_flight
    from gossip_simulator_tpu_torch.utils import telemetry as telem

    window = make_window_fn(cfg, mesh, 10)
    max_steps = cfg.max_rounds
    ihwm = exchange.inflight_hwm(mesh.n_shards)
    sir = cfg.protocol == "sir"

    def live(states, target_count: int, until: int) -> bool:
        st = states[0]
        if st.tick >= max_steps or st.tick >= until:
            return False
        alive = torch.stack([in_flight(x) for x in states]).any()
        recv, alive = torch.stack([st.total_received,
                                   alive.to(torch.int64)]).tolist()
        return recv < target_count and bool(alive)

    def run_fn(states, base_key, target_count: int, until: int, hist=None):
        while live(states, target_count, until):
            window(states, base_key)
            if hist is not None:
                telem.record(hist, telem.gossip_probe(
                    states[0], sir, inflight_hwm=ihwm, shards=states))
        return states, hist

    return run_fn
