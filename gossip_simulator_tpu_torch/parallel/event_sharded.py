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
  the seed, the scenario's faults, the rumor sources and the heal's
  makeup draw take the unfolded key and global ids, so they are the
  same at any shard count;
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

Fault scenarios (``-scenario``) run per shard at the window's start on
global ids; the partition mask filters every emission on global (src,
dst) ids before the route; ``-overlay-heal on`` heals after a poll
window's steps (``make_sharded_event_heal``).  Under the rumor axis
(``-rumors R``, ``-traffic stream``) each shard injects the sources it
owns before its slot count is read, the drain folds the entries' words,
every edge carries its sender's new bits as W more int32 columns of the
route, and the per-rumor counts are summed over the shards.

Under ``-telemetry-spatial on`` every route (the emission's, the seed's,
the heal's re-sends) counts its traffic into the shards' ``exch_counts``.
``-exchange-pipeline double`` keeps the serial schedule (one process
holds every shard: there is no collective for a staged drain to
overlap); only the history's ``exchange_inflight_hwm`` reads 2.  The
run-to-target loop (``make_run_to_coverage_fn``) runs the lockstep shard
list a poll window at a time and records a history row (and the panels)
a window.
"""

from __future__ import annotations

import torch

from gossip_simulator_tpu_torch import scenario as _scen
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
            states.append(event.init_state(cfg, friends, cnt,
                                           n_shards=mesh.n_shards))
        return states

    return init


def _ring_append(cfg: Config, n_local: int, st, dropped, payload, wslot,
                 valid, words=None) -> None:
    """Append one packed entry per True in `valid` into its `wslot` slot of
    the shard's ring, in place (overflow counted in the int32 `dropped`);
    with `words` (int32 (M, W), rumor words) each entry's row lands at the
    same position of the word ring."""
    dw = event.ring_windows(cfg)
    cap = (st.mail_ids.shape[0] - event.ring_tail(cfg, n_local)) // dw
    rings, pays = (st.mail_ids,), (payload.to(I32),)
    if words is not None:
        rings, pays = rings + (st.mail_words,), pays + (words,)
    ring_append(rings, st.mail_cnt, dropped, pays, wslot.to(I32), valid, dw,
                cap, kernel=cfg.deliver_kernel_resolved)


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
                      suppress: bool = False, phase2: str = "xla",
                      words=None):
    """Route (global dst, window slot, tick offset) messages, given per
    source shard, to their owner shards and append them into the owners'
    rings, in place; `drops` and `xovfs` are the shards' int32 slot and
    route overflow counters.  With `suppress`, locally-owned duplicate
    destinations are filtered before the route and routed arrivals at the
    receiving shard; returns each shard's suppressed counts per arrival
    window, sup[dw].  Under -telemetry-spatial on the route counts its
    traffic into the shards' ``exch_counts``.

    `words` (per source shard, int32 (M, W): the messages' rumor words)
    ride the route as one more payload beside the wire word and land at
    the entries' positions of the word rings.  The exchange's -1 fill
    marks an empty slot in the wire word only: a word is any 32 bits
    (rumor 31's bit, a full word, are negative as int32)."""
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
                     wslot[0], valid[0],
                     None if words is None else words[0])
        return sups
    dest = [torch.where(v, d // n_local, s).to(I32)
            for d, v in zip(dst, valid)]
    wire = [torch.where(v, (d % n_local) * (dw * b) + w * b + o, -1).to(I32)
            for d, w, o, v in zip(dst, wslot, off, valid)]
    pays = ([(w,) for w in wire] if words is None
            else list(zip(wire, words)))
    traffic = ([st.exch_counts for st in states]
               if cfg.telemetry_spatial_enabled else None)
    got, ovfs = exchange.route_multi(pays, dest, valid, s, rcap,
                                     traffic=traffic)
    for d, st in enumerate(states):
        xovfs[d] += ovfs[d]
        recv = got[d][0]
        rwords = got[d][1] if words is not None else None
        flags = st.flags if suppress else None
        wkw = {} if rwords is None else dict(words=rwords,
                                             mail_words=st.mail_words)
        if phase2 == "pallas":
            cap = (st.mail_ids.shape[0] - event.ring_tail(cfg, n_local)) // dw
            rsup = megakernel.fused_recv_land(
                st.mail_ids, st.mail_cnt, drops[d], recv, dw=dw,
                cap=cap, b=b, flags=flags, received_bit=event.RECEIVED,
                **wkw)[3]
        else:
            entry, rw, live, rsup = megakernel.recv_decode(
                recv, dw=dw, b=b, flags=flags,
                received_bit=event.RECEIVED)
            # An empty slot's -1 words never land (the append writes a
            # zero row for every lane that does not).
            _ring_append(cfg, n_local, st, drops[d], entry, rw, live,
                         rwords)
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
    """One B-tick window transition of every shard, in place: the
    scenario's fault pass, the rumor injection, the drain chunks and their
    emission batches, then the window's summed counters."""
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
    scen = cfg.scenario_resolved
    # The drain honors crashed bits at crash rate 0 once faults can set
    # them; reception crashes stamp the crash clock when it is carried.
    track_crashed = cfg.faults_enabled
    track_down = cfg.faults_enabled and crash_p > 0.0
    track_part = scen.has_partitions
    multi = cfg.multi_rumor

    def wire_cap(m_edges: int) -> int:
        return exchange.chernoff_cap(m_edges, s) if uniform_dest else m_edges

    def emit(states, skeys, drops, xovfs, sups, parts, batches, width: int,
             ecap: int) -> None:
        """Route one batch of senders per shard (`batches`: (sids,
        svalid, sticks, words) each; words, the senders' new rumor bits,
        None without the rumor axis) at a static `width`: the delay and
        drop draws, SIR removal, the partition mask, the exchange and ring
        append, then SIR's local triggers."""
        if direct_si:
            # One-shard SI: the emission IS the one-device append (the
            # partition mask inside it, on ids that are global at S = 1).
            st = states[0]
            sids, svalid, sticks, sw = batches[0]
            out = event.append_messages(
                cfg, st.mail_ids, st.mail_cnt, drops[0], sids, svalid,
                sticks, st.friends, skeys[0],
                flags=st.flags if suppress else None, kernel=dkern,
                phase2=p2, swords=sw,
                mail_words=st.mail_words if multi else None)
            drops[0].copy_(out[2])
            sups[0] += out[3]
            if track_part:
                parts[0] += out[4]
            return
        # Every shard's batch drawn at once: a lane's key is its shard's
        # folded key, so the draws are the shard-by-shard ones.
        kwidth = states[0].friends.shape[1]
        dev = states[0].mail_ids.device
        sids, svalid, sticks = (torch.cat([bt[j] for bt in batches])
                                for j in range(3))
        rows = torch.where(svalid, sids, n_local)
        sidx = torch.where(svalid, sids, 0).long().view(s, width)
        sf = torch.cat([st.friends[ix] for st, ix in zip(states, sidx)])
        keys = torch.stack(skeys).repeat_interleave(width, dim=0)
        dk = event._sender_keys(keys, _rng.OP_DELAY, sticks, rows)
        pk = event._sender_keys(keys, _rng.OP_DROP, sticks, rows)
        delay = torch.clamp_min(
            _rng.randint(dk, (), cfg.delaylow, cfg.delayhigh), 1)
        drop = _rng.bernoulli_masked(pk, drop_p, (kwidth,))
        arrive = sticks + delay
        wslot2 = (arrive // b) % dw
        off2 = arrive % b
        trig = []
        if sir:
            # Removal at the send tick, before the route; survivors
            # schedule their next trigger locally.
            for i, st in enumerate(states):
                lo, hi = i * width, (i + 1) * width
                strig = event._remove_draw(st.flags, skeys[i], removal_p,
                                           sticks[lo:hi], sids[lo:hi],
                                           svalid[lo:hi], n_local)
                trig.append((rows[lo:hi], strig, wslot2[lo:hi],
                             off2[lo:hi]))
        edge = svalid[:, None] & ~drop & (sf >= 0)
        if track_part:
            # Send-time partition mask on global (src, dst) ids, before
            # the route and before the duplicate filter.
            gid0 = (torch.arange(s, dtype=I32, device=dev) * n_local
                    ).repeat_interleave(width)
            blocked = _scen.partition_blocked(
                scen, cfg.n, sticks[:, None], (gid0 + rows)[:, None],
                sf) & edge
            for part, blk in zip(parts, blocked.view(s, -1).sum(dim=1)):
                part += blk
            edge = edge & ~blocked
        dst = list(torch.where(edge, sf, 0).view(s, -1))
        wsl = list(wslot2[:, None].expand(s * width, kwidth).reshape(s, -1))
        offs = list(off2[:, None].expand(s * width, kwidth).reshape(s, -1))
        valid = list(edge.view(s, -1))
        ewords = None
        if multi:
            # Every edge of a sender carries the sender's new bits.
            ewords = [sw[:, None, :].expand(width, kwidth, sw.shape[1])
                      .reshape(-1, sw.shape[1]) for *_, sw in batches]
        for sup, sa in zip(sups, _route_and_append(
                cfg, n_local, states, drops, xovfs, dst, wsl, offs, valid,
                ecap, suppress=suppress, phase2=p2, words=ewords)):
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
        lane_ids = torch.arange(n_local, dtype=I32, device=dev)
        drops = [torch.zeros((), dtype=I32, device=dev) for _ in range(s)]
        fault_d = []
        # The window's injections (the sources drawn once; each shard
        # keeps the lanes it owns).
        inj = (event.injection_batch(cfg, tick, base_key, b, dw)
               if multi else None)
        for i, st in enumerate(states):
            # Scenario faults: (window, global id)-keyed off the unfolded
            # key, so the schedule is the same at any shard count.
            fault_d.append(event.apply_fault_window_flags(
                cfg, st, i * n_local + lane_ids, base_key, b))
            if multi:
                # The window's injections, before the slot count is read;
                # only the source's owner keeps the lane.  Their drops
                # join the window's summed delta.
                pay, iw, iws, iv = event.injection_shard(inj, b, n_local, i)
                ring_append((st.mail_ids, st.mail_words), st.mail_cnt,
                            drops[i], (pay, iw), iws, iv, dw, cap0,
                            kernel=dkern)
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
        xovfs = [torch.zeros((), dtype=I32, device=dev) for _ in range(s)]
        sups = [st.sup_cnt[0] for st in states]
        parts = [torch.zeros((), dtype=I64, device=dev) for _ in range(s)]
        drs = [torch.zeros((), dtype=I64, device=dev) for _ in range(s)]
        dcs = [torch.zeros((), dtype=I64, device=dev) for _ in range(s)]
        rrecvs = [torch.zeros_like(st.rumor_recv) for st in states]
        lane = torch.arange(ccap, dtype=I32, device=dev)
        for j in range(chunks):
            entry_pos = j * ccap + lane
            drained = []
            for i, st in enumerate(states):
                start = slot * cap0 + j * ccap
                rw = {}
                if multi:
                    rw = dict(words=st.mail_words[start:start + ccap],
                              rumor_words=st.rumor_words)
                out = event.drain_chunk_core(
                    crash_p, b, n_local, st.flags,
                    st.mail_ids[start:start + ccap], entry_pos < ms[i],
                    entry_pos, ckeys[i], sir=sir,
                    track_crashed=track_crashed,
                    down_since=st.down_since if track_down else None,
                    win_tick=tick, **rw)
                _, cdm, cdr, cdc, ids_s, toff_s, senders = out[:7]
                delta_w = None
                if multi:
                    delta_w = out[7]
                    rrecvs[i] += out[8]
                dms[i], drs[i], dcs[i] = dms[i] + cdm, drs[i] + cdr, \
                    dcs[i] + cdc
                drained.append((ids_s, toff_s, senders, delta_w))
            if not scap:
                emit(states, skeys, drops, xovfs, sups, parts,
                     [(ids_s, senders, w * b + toff_s, delta_w)
                      for ids_s, toff_s, senders, delta_w in drained],
                     ccap, rcap)
                continue
            # Sender compaction on the pmax-agreed sender count: every
            # shard runs the same batches.
            comp = []
            for ids_s, toff_s, senders, delta_w in drained:
                comp.append((senders, torch.cumsum(senders, dim=0,
                                                   dtype=I32) - 1,
                             ids_s * b + toff_s, delta_w))
            scnts = torch.stack([c[0].sum() for c in comp]).tolist()
            for width, lo in event.batch_schedule(max(scnts), scap):
                batches = []
                for (senders, srank, spacked, delta_w), scnt in zip(comp,
                                                                     scnts):
                    sids, stoff, svalid, *sw = event.sender_batch(
                        senders, srank, scnt, spacked, b, width, 0, lo=lo,
                        sdelta=delta_w)
                    batches.append((sids, svalid, w * b + stoff,
                                    sw[0] if sw else None))
                emit(states, skeys, drops, xovfs, sups, parts, batches,
                     width, wire_cap(width * kwidth))
        dm, dr, dc = psum(dms), psum(drs), psum(dcs)
        ddrop, dxovf = psum(drops).to(I64), psum(xovfs).to(I64)
        dsc = sum(d[0] for d in fault_d)
        dsr = sum(d[1] for d in fault_d)
        dpart = psum(parts)
        rrecv = psum(rrecvs) if multi else None
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
            st.scen_crashed += dsc
            st.scen_recovered += dsr
            st.part_dropped += dpart
            if multi:
                # Stamped at the window's end tick.
                st.rumor_recv += rrecv
                event.stamp_rumor_done(cfg, st.rumor_recv, st.rumor_done,
                                       st.tick)
        return states

    return step_fn


def make_seed_fn(cfg: Config, mesh: Mesh):
    """Uniform-random global sender: every shard draws the same sender from
    the unfolded key, only its owner emits, and the messages ride the
    route.  An identity under the rumor axis: the window step injects
    every source."""
    s = mesh.n_shards
    n_local = shard_size(cfg.n, mesh)
    b = event.batch_ticks(cfg)
    dw = event.ring_windows(cfg)
    scen = cfg.scenario_resolved

    if cfg.multi_rumor:
        def seed_noop(states, base_key: torch.Tensor):
            return states

        return seed_noop

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
        tick = states[0].tick
        arrive = tick + delay
        mark = cfg.protocol == "sir" or not cfg.compat_reference
        lanes = torch.arange(kwidth, dtype=I32, device=dev)
        dst, valid = [], []
        blk = torch.zeros((), dtype=I64, device=dev)
        for i, st in enumerate(states):
            srow = own_row if i == owner else 0
            sf = st.friends[srow]
            edge = ((lanes < st.friend_cnt[srow]) & ~drop & (sf >= 0)
                    & (i == owner))
            if scen.has_partitions:
                blocked = _scen.partition_blocked(scen, cfg.n, tick, sender,
                                                  sf) & edge
                blk = blk + blocked.sum()
                edge = edge & ~blocked
            if mark and i == owner:
                st.flags[srow] |= event.RECEIVED
            dst.append(torch.where(edge, sf, 0))
            valid.append(edge)
        wslot = torch.full((kwidth,), (arrive // b) % dw, dtype=I32,
                           device=dev)
        off = torch.full((kwidth,), arrive % b, dtype=I32, device=dev)
        drops = [torch.zeros((), dtype=I32, device=dev) for _ in range(s)]
        xovfs = [torch.zeros((), dtype=I32, device=dev) for _ in range(s)]
        # The seed emits at most kwidth messages in all; it lands through
        # the decode and the append under every gate, as in the JAX
        # package.
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
            st.part_dropped += blk
        return states

    return seed_fn


def make_sharded_event_heal(cfg: Config, mesh: Mesh):
    """The sharded event engine's overlay healing (None when
    -overlay-heal is off), in place, after a poll window's steps: the
    detector verdicts and infective bits of every shard (the JAX
    package's all_gather: a concatenation over the shard list) decide the
    repairs, condemned friends are replaced by the global-id-keyed makeup
    draw (``scenario.heal_and_wave``, run once over the shards'
    concatenated rows), the infected healers' re-sends ride the route, and
    the rejoin pulls' responses append locally (they deliver to the
    puller's own row).  Under the rumor axis a re-send carries the
    healer's full rumor words and a pull response the friend's, read from
    the shards' concatenated ``rumor_words``."""
    if not cfg.overlay_heal_resolved:
        return None
    s = mesh.n_shards
    n_local = shard_size(cfg.n, mesh)
    b = event.batch_ticks(cfg)
    dw = event.ring_windows(cfg)
    detect = cfg.heal_detect_ms
    multi = cfg.multi_rumor

    def heal_fn(states, base_key: torch.Tensor):
        dev = states[0].mail_ids.device
        tick = states[0].tick
        n, k = cfg.n, states[0].friends.shape[1]
        # One pass over the shards' concatenated rows: every draw is
        # keyed by global id off the unfolded key, so it is each shard's
        # pass, side by side.
        f = torch.cat([st.flags[:n_local] for st in states])
        down = torch.cat([st.down_since for st in states])
        crashed = (f & event.CRASHED) > 0
        inf = ((f & event.RECEIVED) > 0) & ~crashed \
            & ((f & event.REMOVED) == 0)
        bits = _scen.heal_peer_bits(
            _scen.detect_dead(crashed, down, tick, detect), inf)
        friends, resend, pull, delay, clear, rep, blk = _scen.heal_and_wave(
            cfg, torch.cat([st.friends for st in states]),
            torch.cat([st.friend_cnt for st in states]), bits, ~crashed,
            inf, _scen.rejoined_mask(down),
            torch.arange(n, dtype=I32, device=dev), tick, base_key)
        arrive = tick + delay  # per healer row, shared by its lanes
        wslot = ((arrive // b) % dw)[:, None].expand(n, k).reshape(s, -1)
        off = (arrive % b)[:, None].expand(n, k)
        # Rejoin pull responses deliver to the puller's own (local) row.
        rows = torch.arange(n, dtype=I32, device=dev) % n_local
        ppay = ((rows * b)[:, None] + off).reshape(s, -1)
        sw = fw = [None] * s
        if multi:
            words = torch.cat([st.rumor_words[:n_local] for st in states])
            wc = words.shape[1]
            sw = list(words[:, None, :].expand(n, k, wc).reshape(s, -1, wc))
            fw = words[torch.where(friends >= 0, friends, 0).long()]
            fw = list(fw.reshape(s, -1, wc))
        down = torch.where(clear, -1, down).view(s, -1)
        for st, fr, dn in zip(states, friends.view(s, n_local, k), down):
            st.friends, st.down_since = fr, dn
        drops = [torch.zeros((), dtype=I32, device=dev) for _ in range(s)]
        xovfs = [torch.zeros((), dtype=I32, device=dev) for _ in range(s)]
        # The re-sends land through the decode and the append under every
        # gate, as in the JAX package.
        rcap = min(exchange.epidemic_cap(n_local, k, s), n_local * k)
        _route_and_append(cfg, n_local, states, drops, xovfs,
                          list(torch.where(resend, friends, 0).view(s, -1)),
                          list(wslot), list(off.reshape(s, -1)),
                          list(resend.view(s, -1)), rcap,
                          words=sw if multi else None)
        for st, dropped, pp, ws, pv, w in zip(states, drops, ppay, wslot,
                                              pull.view(s, -1), fw):
            _ring_append(cfg, n_local, st, dropped, pp, ws, pv, w)
        ddrop, dxovf = psum(drops).to(I64), psum(xovfs).to(I64)
        for st in states:
            st.mail_dropped += ddrop
            st.exchange_overflow += dxovf
            st.heal_repaired += rep
            st.part_dropped += blk
        return states

    return heal_fn


def make_window_fn(cfg: Config, mesh: Mesh, window: int):
    """Advance ~`window` simulated ms: ceil(window / B) window steps, then
    (-overlay-heal on) one healing pass."""
    step = make_sharded_event_step(cfg, mesh)
    heal = make_sharded_event_heal(cfg, mesh)
    steps = max(1, -(-window // event.batch_ticks(cfg)))

    def window_fn(states, base_key: torch.Tensor):
        for _ in range(steps):
            step(states, base_key)
        if heal is not None:
            heal(states, base_key)
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
    ihwm = exchange.inflight_hwm(cfg, mesh.n_shards)
    spatial = telem.spatial_spec(cfg, mesh.n_shards)
    sir = cfg.protocol == "sir"
    check_in_flight = not cfg.overlay_heal_resolved
    multi = cfg.multi_rumor
    rumors = cfg.rumors
    last_inj = cfg.last_inject_tick

    def live(states, target_count: int, until: int) -> bool:
        st = states[0]
        if st.tick >= max_steps or st.tick >= until:
            return False
        recv = st.rumor_recv[:rumors].min() if multi else st.total_received
        if not check_in_flight:
            # Healing can revive an empty ring.
            return int(recv) < target_count
        alive = torch.stack([in_flight(x) for x in states]).any()
        recv, alive = torch.stack([recv.to(I64),
                                   alive.to(I64)]).tolist()
        # An empty ring is not death while the injection schedule still
        # has rumors to start.
        return recv < target_count and bool(
            alive or (multi and st.tick <= last_inj))

    def run_fn(states, base_key, target_count: int, until: int, hist=None):
        while live(states, target_count, until):
            window(states, base_key)
            if hist is not None:
                telem.record_window(hist, telem.gossip_probe(
                    states[0], sir, rumors=rumors if multi else 0,
                    inflight_hwm=ihwm, shards=states), states, spatial)
        return states, hist

    return run_fn
