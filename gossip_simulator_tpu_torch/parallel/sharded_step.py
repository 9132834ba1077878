"""Mesh-sharded ring engine and rounds overlay: S shards on one device (the
JAX package's ``parallel/sharded_step.py``, serial exchange schedule).

Each shard owns a contiguous row block (global id of local row r on
shard i: ``i * n_local + r``) and its columns of the ``pending[d, n]``
delay ring.  A tick runs the single-device physics (``epidemic.tick_core``)
on every shard, routes each shard's outgoing wave to the owners of its
destinations (``parallel/exchange.py``: the wire word packs the local
destination and the ring slot) and deposits the arrivals into the
owners' rings; the totals are summed over the shards and kept equal on
every shard.  The shards run in lockstep as a loop over a list of
per-shard ``SimState``s (``parallel/mesh.py``).

As in the JAX package:
* the step keys fold in the shard (``epidemic.tick_keys(..., shard)``),
  and so do push-pull's five keys and the seed's drop key; the seed's
  sender and delay, the scenario's faults and the heal's draws take the
  unfolded key and global ids;
* the dense path routes one wave a tick at ``exchange.epidemic_cap``;
  the compacted path routes chunks of ``epidemic.compact_chunk_cap``
  sender rows, the chunk count agreed over the shards (the largest
  shard's sender count, one host read a tick), at
  ``exchange.chernoff_cap`` on kout and erdos and the smaller of the
  dense cap and the chunk's lanes elsewhere;
* push-pull routes three times a round (push, request, answer) and
  launches no kernel;
* the heal publishes every shard's detector and infective bits (the
  all_gather: the shards' rows side by side), routes the re-sends and
  deposits the rejoin pulls on the shard itself.

Every route counts its traffic into the shards' ``exch_counts`` under
``-telemetry-spatial on``.  ``-exchange-pipeline double`` keeps the
serial route (the JAX package's staged deposit lands the same counts one
chunk later; nothing in the chunk loop reads the ring), so only the
history's ``exchange_inflight_hwm`` reads 2.

The rounds overlay (``make_sharded_overlay_round``) runs the shared
round pieces (``overlay.round_pieces`` with the shards' rows, in
lockstep: a slot's draws for every shard at once) around a routed
delivery: the emission rows, flattened slot-major with the
global ids as sources, ride one route to their destinations' shards and
land in 2-D ``(n_local, cap)`` mailboxes through ``mailbox.deliver``,
the route's overflow counted as dropped.  The round key folds in the
shard; the window counters are summed over the shards.
"""

from __future__ import annotations

import warnings

import torch

from gossip_simulator_tpu_torch import scenario as _scen
from gossip_simulator_tpu_torch.config import Config
from gossip_simulator_tpu_torch.models import epidemic, graphs, overlay
from gossip_simulator_tpu_torch.models.state import OverlayState, in_flight
from gossip_simulator_tpu_torch.ops import mailbox
from gossip_simulator_tpu_torch.ops.select import first_true_indices
from gossip_simulator_tpu_torch.parallel import exchange
from gossip_simulator_tpu_torch.parallel.mesh import Mesh, psum, shard_size
from gossip_simulator_tpu_torch.utils import rng as _rng

I32 = torch.int32
I64 = torch.int64
_TOTALS = ("total_message", "total_received", "total_crashed")


def _traffic(cfg: Config, states):
    """The shards' exch_counts leaves when the route counts its traffic
    (spatial panels on S > 1 shards), else None."""
    if cfg.telemetry_spatial_enabled and len(states) > 1:
        return [st.exch_counts for st in states]
    return None


def _deposit_routed(cfg: Config, n_local: int, states, dst_global, slots,
                    valid, cap: int) -> list:
    """Route (global dst, ring slot) messages, given per source shard, to
    their owner shards and add them into the owners' pending rings, in
    place.  `cap` is the per-destination-shard buffer.  Returns each
    source shard's route overflow (int32 0-d)."""
    s = len(states)
    d = epidemic.ring_depth(cfg)
    dest = [torch.where(v, g // n_local, s).to(I32)
            for g, v in zip(dst_global, valid)]
    packed = [torch.where(v, exchange.pack_dst_slot(g % n_local, sl, d),
                          -1).to(I32)
              for g, sl, v in zip(dst_global, slots, valid)]
    recv, ovfs = exchange.route_one(packed, dest, valid, s, cap,
                                    traffic=_traffic(cfg, states))
    for st, r in zip(states, recv):
        rvalid = r >= 0
        rdst, rslot = exchange.unpack_dst_slot(torch.clamp_min(r, 0), d)
        epidemic.deposit_local(st.pending, rdst, rslot, rvalid,
                               kernel=cfg.deliver_kernel_resolved)
    return ovfs


def _add_replicated(states, **deltas) -> None:
    """Add each summed delta to its replicated counter on every shard."""
    for name, delta in deltas.items():
        for st in states:
            getattr(st, name).add_(delta)


def make_sharded_tick(cfg: Config, mesh: Mesh):
    """One tick of every shard, in place: the scenario's fault pass on
    global ids, the tick physics with the shard-folded keys, the routed
    deposit of the wave (dense, or compacted in pmax-agreed chunks), and
    the summed counters.  Every shard's draws of a kind are made at once
    (the key of a shard's lanes is its folded key, so they are the
    shard-by-shard draws): the keys, the crash uniforms, SIR's removal
    mask and dense slots, and each compacted chunk's delays and drops
    over the shards' sender rows side by side."""
    s = mesh.n_shards
    n_local = shard_size(cfg.n, mesh)
    crash = epidemic.CrashDraw(epidemic.p_eff(cfg, cfg.crashrate))
    scen = cfg.scenario_resolved
    uniform_dest = cfg.graph in ("kout", "erdos")
    sir = cfg.protocol == "sir"
    removal_p = epidemic.p_eff(cfg, cfg.removal_rate)
    dense_slots = sir or not cfg.compact_resolved

    def tick_fn(states, base_key: torch.Tensor):
        dev = states[0].pending.device
        tick = states[0].tick
        rows = torch.arange(n_local, dtype=I32, device=dev)
        shard_ids = torch.arange(s, dtype=I32, device=dev)
        keys = epidemic.tick_keys(_rng.fold_in(base_key, shard_ids), tick)
        drawn = {}
        if crash.crash_p > 0.0:
            drawn["crash"] = _rng.uniform(keys["crash"], (n_local,))
        if sir:
            drawn["remove"] = _rng.bernoulli_masked(keys["remove"],
                                                    removal_p, (n_local,))
        if dense_slots:
            drawn["dslot"] = epidemic.row_slot(
                cfg, keys["delay"][:, None, :], tick, rows).expand(
                    s, n_local)
        before = [states[0].total_message.clone(),
                  states[0].total_received.clone(),
                  states[0].total_crashed.clone()]
        dsc = dsr = 0
        if scen.has_faults:
            # The fault pass over the shards' rows side by side (keyed by
            # tick and global id, off the unfolded key).
            new_crash, recover, down, dsc, dsr = _scen.fault_window(
                scen, cfg.n, tick, 1, torch.arange(cfg.n, dtype=I32,
                                                   device=dev),
                torch.cat([st.crashed for st in states]),
                torch.cat([st.down_since for st in states]), base_key)
            crashed = torch.cat([st.crashed for st in states])
            crashed = (crashed & ~recover) | new_crash
            for st, c, d in zip(states, crashed.view(s, -1),
                                down.view(s, -1)):
                st.crashed, st.down_since = c, d
        waves = []
        for i, st in enumerate(states):
            senders, dslot, _ = epidemic.tick_core(
                cfg, st, {k: v[i] for k, v in keys.items()}, crash,
                {k: v[i] for k, v in drawn.items()})
            waves.append((senders, dslot))
        # Each shard's totals now hold T + its own delta: the global total
        # is their sum less the S - 1 extra copies of T.
        for name, t0 in zip(_TOTALS, before):
            tot = psum([getattr(st, name) for st in states]) - (s - 1) * t0
            for st in states:
                getattr(st, name).copy_(tot)
        width = states[0].friends.shape[1]
        blk = torch.zeros((), dtype=I64, device=dev)
        xovfs = [torch.zeros((), dtype=I32, device=dev) for _ in range(s)]
        if cfg.compact_resolved:
            ccap = epidemic.compact_chunk_cap(cfg, n_local)
            # One host read: every shard's sender count; the chunk count
            # is the largest shard's, so every shard routes as often.
            counts = torch.stack([w[0].sum() for w in waves]).tolist()
            chunks = (max(counts) + ccap - 1) // ccap
            if uniform_dest:
                rcap = exchange.chernoff_cap(ccap * width, s)
            else:
                rcap = min(exchange.epidemic_cap(n_local, width, s),
                           ccap * width)
            idxs = [first_true_indices(w[0], c) for w, c in zip(waves,
                                                                counts)]
            for j in range(chunks):
                lens = [min(ccap, max(0, c - j * ccap)) for c in counts]
                parts = [ix[j * ccap:(j + 1) * ccap].long() for ix in idxs]
                idx = torch.cat(parts).to(I32)
                lane = torch.cat([torch.full((m,), i, dtype=torch.long,
                                             device=dev)
                                  for i, m in enumerate(lens)])
                slot = (torch.cat([w[1][p] for w, p in zip(waves, parts)])
                        if dense_slots else epidemic.row_slot(
                            cfg, keys["delay"][lane], tick, idx))
                d_, sl, v, b = epidemic.edges_from_senders(
                    cfg, torch.cat([st.friends[p] for st, p in zip(states,
                                                                   parts)]),
                    torch.cat([st.friend_cnt[p] for st, p in zip(states,
                                                                 parts)]),
                    torch.ones(idx.shape, dtype=torch.bool, device=dev),
                    slot, keys["drop"][lane], idx, tick,
                    gid0=lane.to(I32) * n_local)
                blk = blk + b
                sizes = [m * width for m in lens]
                for x, o in zip(xovfs, _deposit_routed(
                        cfg, n_local, states, d_.split(sizes),
                        sl.split(sizes), v.split(sizes), rcap)):
                    x += o
        else:
            dst, slots, valid = [], [], []
            for i, (st, (senders, dslot)) in enumerate(zip(states, waves)):
                d_, sl, v, b = epidemic.edges_from_senders(
                    cfg, st.friends, st.friend_cnt, senders, dslot,
                    keys["drop"][i], rows, tick, gid0=i * n_local)
                dst.append(d_)
                slots.append(sl)
                valid.append(v)
                blk = blk + b
            xovfs = _deposit_routed(
                cfg, n_local, states, dst, slots, valid,
                exchange.epidemic_cap(n_local, width, s))
        _add_replicated(states, exchange_overflow=psum(xovfs).to(I64))
        if scen.active:
            _add_replicated(states, scen_crashed=dsc, scen_recovered=dsr,
                            part_dropped=blk)
        return states

    return tick_fn


def make_sharded_pushpull(cfg: Config, mesh: Mesh):
    """One push-pull anti-entropy round of every shard, in place: the push
    and the pull's request and answer each ride one route (the request's
    target row and requester id share it).  Plain torch: the round
    launches no kernel."""
    s = mesh.n_shards
    n_local = shard_size(cfg.n, mesh)
    f = cfg.fanout
    drop_p = epidemic.p_eff(cfg, cfg.droprate)
    crash = epidemic.CrashDraw(epidemic.p_eff(cfg, cfg.crashrate))
    cap = exchange.epidemic_cap(n_local, f, s)

    def round_fn(states, base_key: torch.Tensor):
        dev = states[0].received.device
        tick = states[0].tick
        traffic = _traffic(cfg, states)
        rows = torch.arange(n_local, dtype=I32, device=dev)
        keys = []
        pay, dest, valid = [], [], []
        for i, st in enumerate(states):
            skey = _rng.fold_in(base_key, i)
            keys.append({op: _rng.tick_key(skey, tick, code) for op, code in (
                ("push", _rng.OP_BOOTSTRAP), ("pull", _rng.OP_PULL),
                ("drop1", _rng.OP_DROP), ("drop2", _rng.OP_DELAY),
                ("crash", _rng.OP_CRASH))})
            inf = st.received & ~st.crashed
            peers = _rng.randint(keys[i]["push"], (n_local, f), 0, cfg.n)
            kept = ~_rng.bernoulli_masked(keys[i]["drop1"], drop_p,
                                          (n_local, f))
            edge = (inf[:, None] & kept).reshape(-1)
            dstg = peers.reshape(-1)
            pay.append(torch.where(edge, dstg % n_local, -1).to(I32))
            dest.append(torch.where(edge, dstg // n_local, s).to(I32))
            valid.append(edge)
        recv, ovf1 = exchange.route_one(pay, dest, valid, s, cap,
                                        traffic=traffic)
        dms, dcs, crashed, newly_push = [], [], [], []
        for i, (st, r) in enumerate(zip(states, recv)):
            arriving = torch.zeros((n_local + 1,), dtype=I32, device=dev)
            slot = torch.where(r >= 0, r, n_local).long()
            arriving.index_add_(0, slot, torch.ones_like(slot, dtype=I32))
            counted = torch.where(st.crashed, 0, arriving[:n_local])
            dms.append(counted.sum(dtype=I64))
            new_crash = torch.zeros_like(st.crashed)
            if crash.crash_p > 0.0:
                new_crash = crash.draw(keys[i]["crash"], counted)
            dcs.append(new_crash.sum(dtype=I64))
            crashed.append(st.crashed | new_crash)
            newly_push.append((counted > 0) & ~crashed[i] & ~st.received)
        # Pull: request (target row, requester id), then the answer.
        pays, dest, valid = [], [], []
        for i, st in enumerate(states):
            sus = ~st.received & ~st.crashed
            peers = _rng.randint(keys[i]["pull"], (n_local, f), 0, cfg.n)
            kept = ~_rng.bernoulli_masked(keys[i]["drop2"], drop_p,
                                          (n_local, f))
            req = (sus[:, None] & kept & ~crashed[i][:, None]).reshape(-1)
            tgt = peers.reshape(-1)
            gids = (i * n_local + rows)[:, None].expand(n_local, f)
            pays.append((torch.where(req, tgt % n_local, -1).to(I32),
                         torch.where(req, gids.reshape(-1), -1).to(I32)))
            dest.append(torch.where(req, tgt // n_local, s).to(I32))
            valid.append(req)
        got, ovf2 = exchange.route_multi(pays, dest, valid, s, cap,
                                         traffic=traffic)
        pay, dest, valid = [], [], []
        for i, (st, (rtgt, rreq)) in enumerate(zip(states, got)):
            tvalid = rtgt >= 0
            # The peer's pre-round state answers (see packed_peer_state).
            peer = epidemic.packed_peer_state(st.received, st.crashed)[
                torch.where(tvalid, rtgt, 0).long()]
            answered = tvalid & (peer < 2)
            dms[i] = dms[i] + answered.sum(dtype=I64)
            hit = answered & (peer == 1)
            pay.append(torch.where(hit, rreq % n_local, -1).to(I32))
            dest.append(torch.where(hit, rreq // n_local, s).to(I32))
            valid.append(hit)
        back, ovf4 = exchange.route_one(pay, dest, valid, s, cap,
                                        traffic=traffic)
        drs = []
        for i, (st, b) in enumerate(zip(states, back)):
            pull_hit = torch.zeros((n_local + 1,), dtype=torch.bool,
                                   device=dev)
            pull_hit[torch.where(b >= 0, b, n_local).long()] = True
            newly = ((newly_push[i] | pull_hit[:n_local]) & ~crashed[i]
                     & ~st.received)
            st.received = st.received | newly
            st.crashed = crashed[i]
            drs.append(newly.sum(dtype=I64))
            st.tick += 1
        _add_replicated(
            states, total_message=psum(dms), total_received=psum(drs),
            total_crashed=psum(dcs),
            exchange_overflow=(psum(ovf1) + psum(ovf2)
                               + psum(ovf4)).to(I64))
        return states

    return round_fn


def make_sharded_step(cfg: Config, mesh: Mesh):
    if cfg.protocol == "pushpull":
        return make_sharded_pushpull(cfg, mesh)
    return make_sharded_tick(cfg, mesh)


def make_sharded_heal(cfg: Config, mesh: Mesh):
    """The sharded ring engine's overlay healing (None when -overlay-heal
    is off), in place, after a poll window's steps: every shard's detector
    verdicts and infective bits (the JAX package's all_gather) decide the
    repairs, the global-id-keyed pass (``scenario.heal_and_wave``) runs
    once over the shards' rows side by side, the infected healers'
    re-sends ride the route, and the rejoin pulls deposit on the puller's
    own shard."""
    if not cfg.overlay_heal_resolved:
        return None
    s = mesh.n_shards
    n_local = shard_size(cfg.n, mesh)
    detect = cfg.heal_detect_ms
    d = epidemic.ring_depth(cfg)
    dkern = cfg.deliver_kernel_resolved

    def heal_fn(states, base_key: torch.Tensor):
        dev = states[0].pending.device
        tick = states[0].tick
        n, k = cfg.n, states[0].friends.shape[1]
        crashed = torch.cat([st.crashed for st in states])
        down = torch.cat([st.down_since for st in states])
        inf = (torch.cat([st.received for st in states]) & ~crashed
               & ~torch.cat([st.removed for st in states]))
        bits = _scen.heal_peer_bits(
            _scen.detect_dead(crashed, down, tick, detect), inf)
        friends, resend, pull, delay, clear, rep, blk = _scen.heal_and_wave(
            cfg, torch.cat([st.friends for st in states]),
            torch.cat([st.friend_cnt for st in states]), bits, ~crashed,
            inf, _scen.rejoined_mask(down),
            torch.arange(n, dtype=I32, device=dev), tick, base_key)
        if cfg.effective_time_mode == "rounds":
            dslot = torch.full((n,), (tick + 1) % d, dtype=I32, device=dev)
        else:
            dslot = ((tick + delay) % d).to(I32)
        slots = list(dslot[:, None].expand(n, k).reshape(s, -1))
        xovfs = _deposit_routed(
            cfg, n_local, states,
            list(torch.where(resend, friends, -1).reshape(s, -1)), slots,
            list(resend.reshape(s, -1)),
            exchange.epidemic_cap(n_local, k, s))
        # Rejoin pull responses deliver to the puller's own (local) row.
        own = torch.arange(n_local, dtype=I32, device=dev)[:, None].expand(
            n_local, k).reshape(-1)
        down = torch.where(clear, -1, down).view(s, -1)
        for st, sl, pv, fr, dn in zip(states, slots, pull.view(s, -1),
                                      friends.view(s, n_local, k), down):
            epidemic.deposit_local(st.pending, own, sl, pv, kernel=dkern)
            st.friends, st.down_since = fr, dn
        _add_replicated(states, heal_repaired=rep, part_dropped=blk,
                        exchange_overflow=psum(xovfs).to(I64))
        return states

    return heal_fn


def make_seed_fn(cfg: Config, mesh: Mesh):
    """The initial broadcast: every shard draws the same global sender
    from the unfolded key, the owner emits its row (delay keyed by its
    local row on the unfolded key, drops by the shard-folded key), and the
    edges ride the route.  Push-pull only marks the sender."""
    s = mesh.n_shards
    n_local = shard_size(cfg.n, mesh)
    scen = cfg.scenario_resolved
    mark = cfg.protocol == "pushpull" or not cfg.compat_reference

    def seed_fn(states, base_key: torch.Tensor):
        dev = states[0].received.device
        tick = states[0].tick
        ks = _rng.tick_key(base_key, epidemic.SEED_TICK, _rng.OP_SEED_NODE)
        kd = _rng.tick_key(base_key, epidemic.SEED_TICK, _rng.OP_DELAY)
        sender = int(_rng.randint(ks, (), 0, cfg.n))
        owner, own_row = divmod(sender, n_local)
        if mark:
            states[owner].received[own_row] = True
            _add_replicated(states, total_received=torch.ones(
                (), dtype=I64, device=dev))
        if cfg.protocol == "pushpull":
            return states
        k = states[0].friends.shape[1]
        row = torch.tensor([own_row], dtype=I32, device=dev)
        dslot = epidemic.row_slot(cfg, kd, tick, row)
        dst, slots, valid = [], [], []
        blk = torch.zeros((), dtype=I64, device=dev)
        for i, st in enumerate(states):
            kp = _rng.tick_key(_rng.fold_in(base_key, i),
                               epidemic.SEED_TICK, _rng.OP_DROP)
            d_, sl, v, b = epidemic.edges_from_senders(
                cfg, st.friends[own_row:own_row + 1],
                st.friend_cnt[own_row:own_row + 1],
                torch.tensor([i == owner], device=dev), dslot, kp, row, tick,
                gid0=i * n_local)
            dst.append(d_)
            slots.append(sl)
            valid.append(v)
            blk = blk + b
        if scen.has_partitions:
            _add_replicated(states, part_dropped=blk)
        xovfs = _deposit_routed(cfg, n_local, states, dst, slots, valid,
                                exchange.epidemic_cap(n_local, k, s))
        if cfg.protocol == "sir":
            kr = _rng.tick_key(base_key, epidemic.SEED_TICK, _rng.OP_REMOVE)
            keep = ~_rng.bernoulli_masked(
                kr, epidemic.p_eff(cfg, cfg.removal_rate), ())
            rb = states[owner].rebroadcast
            cell = (dslot.long(), row.long())
            rb[cell] = rb[cell] | keep
        _add_replicated(states, exchange_overflow=psum(xovfs).to(I64))
        return states

    return seed_fn


def make_sharded_init(cfg: Config, mesh: Mesh):
    """Per-shard graph slices and ring-engine states.  The generators are
    keyed by global row, so a slice equals that row block of a one-device
    table (the slices take the fold_in generators, as the JAX package's
    traced row0 does)."""
    n_local = shard_size(cfg.n, mesh)

    def init():
        key = graphs.graph_key(cfg, mesh.device)
        states = []
        for i in range(mesh.n_shards):
            friends, cnt = graphs.generate(cfg, key, row0=i * n_local,
                                           rows=n_local, static_row0=False)
            states.append(epidemic.init_state(cfg, friends, cnt,
                                              n_shards=mesh.n_shards))
        return states

    return init


def make_window_fn(cfg: Config, mesh: Mesh, window: int):
    """`window` steps (ticks, or rounds), then (-overlay-heal on) one
    healing pass."""
    step = make_sharded_step(cfg, mesh)
    heal = make_sharded_heal(cfg, mesh)

    def window_fn(states, base_key: torch.Tensor):
        for _ in range(window):
            step(states, base_key)
        if heal is not None:
            heal(states, base_key)
        return states

    return window_fn


def make_run_to_coverage_fn(cfg: Config, mesh: Mesh):
    """The sharded ring engine's run-to-target loop: poll windows (one
    round in rounds mode, 10 ticks in ticks mode) while under the target,
    max_rounds and `until`, and with a message in flight on any shard (not
    under push-pull or healing); a telemetry row a window with the removed
    count summed and the ring high-water largest over the shards."""
    from gossip_simulator_tpu_torch.utils import telemetry as telem

    window = make_window_fn(
        cfg, mesh, 1 if cfg.effective_time_mode == "rounds" else 10)
    max_steps = cfg.max_rounds
    check_in_flight = (cfg.protocol != "pushpull"
                       and not cfg.overlay_heal_resolved)
    ihwm = exchange.inflight_hwm(cfg, mesh.n_shards)
    spatial = telem.spatial_spec(cfg, mesh.n_shards)
    sir = cfg.protocol == "sir"

    def live(states, target_count: int, until: int) -> bool:
        st = states[0]
        if st.tick >= max_steps or st.tick >= until:
            return False
        if not check_in_flight:
            return int(st.total_received) < target_count
        alive = torch.stack([in_flight(x) for x in states]).any()
        recv, alive = torch.stack([st.total_received,
                                   alive.to(I64)]).tolist()
        return recv < target_count and bool(alive)

    def run_fn(states, base_key, target_count: int, until: int, hist=None):
        while live(states, target_count, until):
            window(states, base_key)
            if hist is not None:
                telem.record_window(hist, telem.gossip_probe(
                    states[0], sir, inflight_hwm=ihwm, shards=states),
                    states, spatial)
        return states, hist

    return run_fn


# --- the rounds overlay --------------------------------------------------------


def make_sharded_overlay_init(cfg: Config, mesh: Mesh):
    """Every shard's empty rounds-overlay state (the per-round bootstrap
    fills the table)."""
    n_local = shard_size(cfg.n, mesh)

    def init():
        return [overlay.init_state(cfg, None, n_local=n_local, device=mesh.device)
                for _ in range(mesh.n_shards)]

    return init


def make_sharded_overlay_round(cfg: Config, mesh: Mesh):
    """One rounds-overlay round of every shard: round_fn([states], key) ->
    states (the list handed over in a box and popped, as the one-device
    round takes its state).  Two host reads a round: the shards' breakup
    and makeup mailbox loads."""
    s = mesh.n_shards
    n_local = shard_size(cfg.n, mesh)
    cap = cfg.mailbox_cap_for(n_local)
    # Membership messages per node per round: at most cap + 1 rows.
    route_cap = exchange.epidemic_cap(n_local, cap + 2, s)
    bk_shards, mk_shards = overlay.round_pieces(cfg, n_rows=n_local)[2:]
    dkern = cfg.deliver_kernel_resolved
    if n_local >= overlay.SPLIT_ROUND_MIN_ROWS:
        warnings.warn(
            f"sharded overlay: {n_local} rows/shard is at the split-round "
            f"band (>= {overlay.SPLIT_ROUND_MIN_ROWS}); the sharded engine "
            "has no split round -- use at least "
            f"{-(-cfg.n // overlay.SPLIT_ROUND_MIN_ROWS)} shards for this n",
            stacklevel=2)

    def routed_deliver(mats, ids):
        """Each shard's emission rows (slot-major, global ids as sources)
        routed to their destinations' shards and delivered into 2-D
        mailboxes.  Returns per shard (mbox, dropped) and the shards'
        mailbox loads, read in one host read."""
        srcs, dsts, dest, valid = [], [], [], []
        for m, g in zip(mats, ids):
            flat = torch.cat(m, dim=0).reshape(-1)
            v = flat >= 0
            srcs.append(torch.where(v, g.repeat(flat.shape[0] // n_local),
                                    -1))
            dsts.append(torch.where(v, flat % n_local, -1))
            dest.append(torch.where(v, flat // n_local, s).to(I32))
            valid.append(v)
        got, ovfs = exchange.route_multi(list(zip(srcs, dsts)), dest, valid,
                                         s, route_cap)
        out = []
        for (rsrc, rdst), ovf in zip(got, ovfs):
            rvalid = rsrc >= 0
            mbox, cnt, dropped = mailbox.deliver(
                rsrc, torch.where(rvalid, rdst, 0), rvalid, n_local, cap,
                kernel=dkern)
            out.append((mbox, cnt.max(), dropped + ovf))
        loads = torch.stack([o[1] for o in out]).tolist()
        return [(o[0], o[2]) for o in out], loads

    def round_fn(box, base_key: torch.Tensor):
        states = box.pop()
        dev = states[0].friends.device
        keys = _rng.fold_in(base_key, torch.arange(s, dtype=I32, device=dev))
        ids = [i * n_local + torch.arange(n_local, dtype=I32, device=dev)
               for i in range(s)]
        prev = states[0]
        friends = [st.friends for st in states]
        cnts = [st.friend_cnt for st in states]
        bk, n_bk = routed_deliver([(st.bk_dst,) for st in states], ids)
        for st in states:
            st.bk_dst = st.friends = st.friend_cnt = None
        mk_out = bk_shards(friends, cnts, [m for m, _ in bk], n_bk,
                           prev.round, keys, ids)
        drops = [d for _, d in bk]
        del bk
        mk, n_mk = routed_deliver(
            [(st.mk_dst, st.boot_dst[None, :]) for st in states], ids)
        for st in states:
            st.mk_dst = st.boot_dst = None
        bk_out = mk_shards(friends, cnts, [m for m, _ in mk], n_mk,
                           prev.round, keys, ids)
        drops = [d + d1 for d, (_, d1) in zip(drops, mk)]
        del mk
        # The window counters are each shard's own: summed over the
        # shards onto the replicated counters.
        wm = psum([o[1] for o in bk_out])
        wb = psum([o[1] for o in mk_out])
        dr = prev.mailbox_dropped + psum(drops)
        return [OverlayState(
            friends=fr, friend_cnt=cn, mk_dst=mo[0], bk_dst=bo[0],
            boot_dst=bo[3], mk_spill=st.mk_spill, bk_spill=st.bk_spill,
            round=prev.round + 1, makeups=prev.makeups + wm,
            breakups=prev.breakups + wb, win_makeups=wm.clone(),
            win_breakups=wb.clone(), mailbox_dropped=dr.clone())
            for st, fr, cn, mo, bo in zip(states, friends, cnts, mk_out,
                                          bk_out)]

    return round_fn
