"""Mesh-sharded tick-faithful overlay: S shards on one device (the JAX
package's ``parallel/overlay_ticks_sharded.py``, serial exchange
schedule).

Each shard owns a contiguous row block and its own packed window ring
(entries hold local destinations).  A B-tick step drains every shard's
slot and runs the shared drain and decision pieces
(``overlay_ticks.make_step_fn(cfg, n_local=...).pieces``, node-major at
any n) on its rows; each emission buffer is then compacted, its entries
drawn their delays (keyed by the global emission index ``shard *
flat_n + idx`` on the unfolded key) and routed in chunks of
``emit_chunk`` to their destinations' shards, where ``ring_append``
(``fused_ring_append``) lands them in received-lane order, the route's
overflow counted as dropped.  The chunk count is the largest shard's
(pmax), so every shard routes as often; the decision keys fold in the
shard; the window counters and drops are summed over the shards and
kept equal on every shard.

The bootstrap burst draws the initial friends with global row keys and
its delays by global emission index, so the table and the in-flight
burst are a one-device run's, placed by shard.

Host reads a step: the shards' slot counts, their mailbox depths, and
each emission buffer's totals -- one read each for all shards.
``-exchange-pipeline double`` keeps the serial route (the JAX package's
staged append lands the same entries one chunk later).
"""

from __future__ import annotations

import torch

from gossip_simulator_tpu_torch.config import Config
from gossip_simulator_tpu_torch.models import overlay_ticks as ot
from gossip_simulator_tpu_torch.ops.mailbox import ring_append
from gossip_simulator_tpu_torch.ops.select import first_true_indices
from gossip_simulator_tpu_torch.parallel import exchange
from gossip_simulator_tpu_torch.parallel.mesh import Mesh, psum, shard_size
from gossip_simulator_tpu_torch.utils import rng as _rng

I32 = torch.int32


def _route_append(cfg: Config, n_local: int, states, drops, dst_g, pay,
                  wslot, rcap: int) -> None:
    """Route (global dst, pay, window slot) entries, given per source shard
    (every lane valid), to their owner shards and append them into the
    owners' rings, in place; each source shard's route overflow and each
    owner's ring overflow add to its int32 `drops`."""
    s = len(states)
    dw = ot.ring_windows(cfg)
    valid = [torch.ones_like(d, dtype=torch.bool) for d in dst_g]
    got, ovfs = exchange.route_multi(
        [(d % n_local, p, w) for d, p, w in zip(dst_g, pay, wslot)],
        [(d // n_local).to(I32) for d in dst_g], valid, s, rcap)
    for st, dropped, ovf, (rd, rp, rw) in zip(states, drops, ovfs, got):
        dropped += ovf
        rvalid = rd >= 0
        cap = (st.ring_dst.shape[0] - 1) // dw
        ring_append((st.ring_dst, st.ring_pay), st.ring_cnt, dropped,
                    (torch.where(rvalid, rd, 0), torch.where(rvalid, rp, 0)),
                    torch.where(rvalid, rw, 0), rvalid, dw, cap,
                    kernel=cfg.deliver_kernel_resolved)


def make_sharded_init(cfg: Config, mesh: Mesh):
    """Per-shard states and the routed window-0 bootstrap burst:
    init(base_key) -> states."""
    n, f, k = cfg.n, cfg.fanout, cfg.max_degree
    s = mesh.n_shards
    n_local = shard_size(cfg.n, mesh)
    b = ot.batch_ticks(cfg)
    dw = ot.ring_windows(cfg)
    cap = ot.slot_cap(cfg, n_local)
    chunk = ot.emit_chunk(cfg, n_local)
    flat_n = n_local * f
    rcap = exchange.epidemic_cap(chunk, 1, s)

    def init(base_key: torch.Tensor):
        dev = base_key.device
        kb = _rng.tick_key(base_key, 0, _rng.OP_BOOTSTRAP)
        states, ws = [], []
        for i in range(s):
            gids = i * n_local + torch.arange(n_local, dtype=I32, device=dev)
            # Global row keys: the friends table a one-device run draws.
            w = _rng.randint(_rng.row_keys(kb, gids), (f,), 0, n)
            w = torch.where(w == gids[:, None], (w + 1) % n, w)
            friends = torch.full((n_local, k), -1, dtype=I32, device=dev)
            friends[:, :f] = w
            ws.append(w.reshape(-1))

            def z():
                return torch.zeros((), dtype=I32, device=dev)

            states.append(ot.OverlayTickState(
                friends=friends,
                friend_cnt=torch.full((n_local,), f, dtype=I32, device=dev),
                ring_dst=torch.zeros(dw * cap + 1, dtype=I32, device=dev),
                ring_pay=torch.zeros(dw * cap + 1, dtype=I32, device=dev),
                ring_cnt=torch.zeros((1, dw), dtype=I32, device=dev),
                spill=torch.full((2, 1), -1, dtype=I32, device=dev),
                tick=0, makeups=z(), breakups=z(), win_makeups=z(),
                win_breakups=z(), mailbox_dropped=z()))
        kd = _rng.tick_key(base_key, 0, _rng.OP_DELAY)
        drops = [torch.zeros((), dtype=I32, device=dev) for _ in range(s)]
        for lo in range(0, flat_n, chunk):
            idx = torch.arange(lo, min(lo + chunk, flat_n), dtype=I32,
                               device=dev)
            # The global emission index keys the one-device burst's
            # delays (emitted at t = 0), every shard's in one draw.
            gidx = (torch.arange(s, dtype=I32, device=dev)[:, None] * flat_n
                    + idx)
            arrive = _rng.row_uniform_delay(kd, cfg.delaylow, cfg.delayhigh,
                                            gidx.reshape(-1)).view(s, -1)
            src = (torch.arange(s, dtype=I32, device=dev)[:, None] * n_local
                   + idx // f)
            _route_append(cfg, n_local, states, drops,
                          [wi[lo:lo + chunk] for wi in ws],
                          list((src * 2 + ot.MK) * b + arrive % b),
                          list((arrive // b) % dw), rcap)
        dropped = psum(drops)
        for st in states:
            st.mailbox_dropped += dropped
        return states

    return init


def make_poll_fn(cfg: Config, mesh: Mesh):
    """One 10 ms poll window of every shard, in place: poll(states, key)
    -> states; win_makeups / win_breakups count the window."""
    s = mesh.n_shards
    n_local = shard_size(cfg.n, mesh)
    b = ot.batch_ticks(cfg)
    dw = ot.ring_windows(cfg)
    cap_mb = cfg.mailbox_cap_for(n_local, stacked=True)
    echunk = ot.emit_chunk(cfg, n_local)
    rcap = exchange.epidemic_cap(echunk, 1, s)
    flat_n = n_local * cap_mb
    steps = max(1, -(-ot.POLL_MS // b))
    drain, process = ot.make_step_fn(cfg, n_local=n_local).pieces

    def emit_routed(states, drops, base_key, w: int, em, typ: int,
                    op: int) -> None:
        """Compact each shard's (n_local, depth) emission buffer, draw each
        entry's delay by its global emission index in the (n_local,
        cap_mb) buffer (every shard's entries of a chunk in one draw: the
        key is unfolded), and route the entries in pmax-agreed chunks."""
        kd = _rng.tick_key(base_key, w, op)
        totals = torch.stack([(d >= 0).sum() for d, _ in em]).tolist()
        nchunks = (max(totals) + echunk - 1) // echunk
        ridx_all = [first_true_indices(d.reshape(-1) >= 0, total).long()
                    for (d, _), total in zip(em, totals)]
        for j in range(nchunks):
            gidx, srcs, dsts, toffs = [], [], [], []
            for i, ((d, t), ridx) in enumerate(zip(em, ridx_all)):
                ridx = ridx[j * echunk:(j + 1) * echunk]
                depth = max(d.shape[1], 1)
                row = ridx // depth
                gidx.append(i * flat_n + row * cap_mb + ridx % depth)
                srcs.append(i * n_local + row)
                dsts.append(d.reshape(-1)[ridx])
                toffs.append(t.reshape(-1)[ridx])
            sizes = [x.shape[0] for x in dsts]
            delay = _rng.row_uniform_delay(kd, cfg.delaylow, cfg.delayhigh,
                                           torch.cat(gidx).to(I32))
            arrive = w * b + torch.cat(toffs) + delay
            pay = ((torch.cat(srcs).to(I32) * 2 + typ) * b
                   + arrive % b).split(sizes)
            wsl = ((arrive // b) % dw).split(sizes)
            _route_append(cfg, n_local, states, drops, dsts, pay, wsl, rcap)

    def step(states, base_key: torch.Tensor) -> None:
        dev = states[0].ring_dst.device
        w = states[0].tick // b
        slot = w % dw
        ms = torch.stack([st.ring_cnt[0, slot] for st in states]).tolist()
        for st in states:
            st.tick += b
        if max(ms) == 0:
            return  # nothing arrives anywhere: no decision, no emission
        drops = [torch.zeros((), dtype=I32, device=dev) for _ in range(s)]
        empty = torch.full((n_local, 0), -1, dtype=I32, device=dev)
        mk_boxes, bk_boxes = [], []
        for st, m, dropped in zip(states, ms, drops):
            mk_mbox, bk_mbox = empty, empty
            if m:
                mk_mbox, bk_mbox, dr = drain(st, slot, m)
                st.ring_cnt[0, slot] = 0
                dropped += dr
            mk_boxes.append(mk_mbox)
            bk_boxes.append(bk_mbox)
        # One host read: every shard's two mailbox depths.
        depths = torch.stack([(mb >= 0).sum(dim=1).max() if mb.shape[1]
                              else torch.zeros((), dtype=torch.long,
                                               device=dev)
                              for mb in bk_boxes + mk_boxes]).tolist()
        skeys = _rng.fold_in(base_key, torch.arange(s, dtype=I32, device=dev))
        friends = [st.friends for st in states]
        cnts = [st.friend_cnt for st in states]
        gids = [i * n_local + torch.arange(n_local, dtype=I32, device=dev)
                for i in range(s)]
        # Breakups (simulator.go:76-94), then makeups (66-75), the shards
        # in lockstep.
        mk_em = process(True, bk_boxes, depths[:s],
                        _rng.tick_key(skeys, w, _rng.OP_REPLACE), friends,
                        cnts, gids)
        bk_em = process(False, mk_boxes, depths[s:],
                        _rng.tick_key(skeys, w, _rng.OP_EVICT), friends,
                        cnts, gids)
        del mk_boxes, bk_boxes
        for st, fr, cn in zip(states, friends, cnts):
            st.friends, st.friend_cnt = fr, cn
        win_bk = [e[2] for e in mk_em]
        win_mk = [e[2] for e in bk_em]
        emit_routed(states, drops, base_key, w, [e[:2] for e in mk_em],
                    ot.MK, _rng.OP_DELAY)
        emit_routed(states, drops, base_key, w, [e[:2] for e in bk_em],
                    ot.BK, _rng.OP_DELAY_BK)
        wm, wb, dropped = psum(win_mk), psum(win_bk), psum(drops)
        for st in states:
            st.makeups += wm
            st.breakups += wb
            st.win_makeups += wm
            st.win_breakups += wb
            st.mailbox_dropped += dropped

    def poll(states, base_key: torch.Tensor):
        for st in states:
            st.win_makeups.zero_()
            st.win_breakups.zero_()
        for _ in range(steps):
            step(states, base_key)
        return states

    return poll
