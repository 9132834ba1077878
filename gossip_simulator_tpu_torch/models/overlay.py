"""Overlay construction by rounds, and the membership decisions shared
by the phase-1 engines.

The port of the JAX package's ``models/overlay.py``: the per-slot
decision rules of the membership protocol, applied to every node at once
for one mailbox slot (simulator.go:66-94), the ``-phase1-kernel`` seam
that swaps them for the fused kernel, and the rounds engine that runs
them -- the default overlay above n = 10M and ``-overlay-mode rounds``.

* makeup  (simulator.go:66-75): under fanin -> append the sender; else
  evict a uniform-random friend (sending it a breakup) and take its slot.
* breakup (simulator.go:76-94): first-match scan; over fanout -> remove
  (swap-with-last); else replace in place with a fresh random peer (!=
  self, != leaver) and send it a makeup.
* bootstrap (simulator.go:95-106): while under fanout, add one uniform
  random friend per round (self patched as (id+1)%N) and send a makeup --
  or, with the static bootstrap, draw all fanout friends at init and
  stage the n*fanout makeup burst as the first emission rows.

A round delivers last round's breakups, processes them slot by slot (all
nodes at once), delivers last round's makeups and bootstrap requests,
processes those, and runs the bootstrap; emissions wait in slot-major
(cap, n) buffers for the next round.  The delivery is banded by n, as in
the JAX package: node-major over the flattened buffers up to
COLUMN_DELIVERY_MIN_ROWS, per emission row above it (rank-major
mailboxes, overflow kept as spill pairs when cap < 16), and from
SPLIT_ROUND_MIN_ROWS the split round, whose hosted delivery picks chunk
widths per row and skips rows counted empty at write time.  The JAX
package's fori_loops over mailbox slots and delivery chunks are Python
loops with one host read each; its jit boundaries, donation and fences
have no counterpart here.

Column reads and writes are one-hot elementwise ops over the narrow
friends table, as in the JAX package.
"""

from __future__ import annotations

import math

import torch

from gossip_simulator_tpu_torch import config as _config
from gossip_simulator_tpu_torch.config import Config, flat_addressing_fits
from gossip_simulator_tpu_torch.models.state import OverlayState
from gossip_simulator_tpu_torch.ops import mailbox, overlay_kernel
from gossip_simulator_tpu_torch.utils import rng as _rng

I32 = torch.int32

# Above this many rows the rounds engine delivers per emission row
# (mailbox.deliver_columns, slot-major arrival order) instead of the
# flattened node-major path.  Module-level so tests can lower it.
COLUMN_DELIVERY_MIN_ROWS = 4_000_000
# Spill capacity (pairs per message type) of the settled regime; the
# static-boot band adds room for the burst (spill_cap_for).
SPILL_CAP = 65_536
# Fattest rung of the split round's hosted-chunk ladder
# (hosted_chunk_widths).  Module-level so tests can lower it.
ADAPTIVE_CHUNK_MAX = 8_388_608
# From this many rows the rounds engine runs the split round
# (make_split_round_fn).  Module-level so tests can lower it.
SPLIT_ROUND_MIN_ROWS = 32_000_000


def spill_enabled(cap: int) -> bool:
    """Overflow spills only below the full cap 16: the memory-banded cap
    8 and explicit small caps."""
    return cap < 16


def _poisson_excess(lam: float, cap: int) -> float:
    """E[(X - cap)+] for X ~ Poisson(lam): the expected per-node mailbox
    overflow when a whole wave of uniform sends lands in one round; terms
    summed to a ~10-sigma tail."""
    p = math.exp(-lam)
    e = 0.0
    for k in range(1, int(lam + 10.0 * math.sqrt(max(lam, 1.0)) + 20)):
        p = p * lam / k
        if k > cap:
            e += (k - cap) * p
    return e


def static_boot_applies(cfg: Config, hooked: bool = False) -> bool:
    """Whether init_state stages the one-shot bootstrap burst: the
    static-boot band on the one-device engine (the sharded round's
    routed delivery, `hooked`, has no burst: its per-round bootstrap
    fills the table), and the burst must fit the cap-wide emission rows
    (fanout <= cap; always true for auto caps)."""
    return (not hooked and cfg.static_boot_for(cfg.n)
            and cfg.fanout <= cfg.mailbox_cap_for(cfg.n))


def spill_cap_for(cfg: Config, n_rows: int) -> int:
    """Spill capacity (pairs) of a rounds surface of `n_rows` rows; 0 =
    no spill.  With the static bootstrap the whole n*fanout burst lands
    in one round, so in-degree is Poisson(fanout) at once: the capacity
    adds margin * n * E[(X - cap)+] pairs (~12.2M expected at 1e8, cap
    8)."""
    cap = cfg.mailbox_cap_for(n_rows)
    if not spill_enabled(cap):
        return 0
    if static_boot_applies(cfg):
        return SPILL_CAP + int(_config.OVERLAY_SPILL_MARGIN * n_rows
                               * _poisson_excess(float(cfg.fanout), cap))
    return SPILL_CAP


def init_state(cfg: Config, base_key, n_local: int | None = None,
               device=None) -> OverlayState:
    """The initial rounds state.  With the static bootstrap, every node's
    fanout friends are drawn here (lane-keyed draws, one column at a
    time, self patched (id+1)%n) and staged as the first fanout makeup
    emission rows; otherwise the table starts empty and the per-round
    bootstrap fills it.  `n_local` builds one shard's rows for the
    sharded round (no static bootstrap; its routed delivery never
    spills, and the spill buffers keep the flat floor's size)."""
    hooked = n_local is not None
    n = n_local if hooked else cfg.n
    k = cfg.max_degree
    cap = cfg.mailbox_cap_for(n)
    dev = base_key.device if device is None else device
    if hooked:
        sc = SPILL_CAP if spill_enabled(cap) else 0
    else:
        sc = spill_cap_for(cfg, n)
    friends = torch.full((n, k), -1, dtype=I32, device=dev)
    mk_dst = torch.full((cap, n), -1, dtype=I32, device=dev)
    if static_boot_applies(cfg, hooked):
        f = cfg.fanout
        ids = torch.arange(n, dtype=I32, device=dev)
        kb = _rng.tick_key(base_key, 0, _rng.OP_BOOTSTRAP)
        for j in range(f):
            wj = _rng.row_randint(kb, n, ids * f + j, 1)[:, 0]
            wj = torch.where(wj == ids, (wj + 1) % n, wj)
            friends[:, j] = wj
            mk_dst[j] = wj
            del wj
        cnt = torch.full((n,), f, dtype=I32, device=dev)
    else:
        cnt = torch.zeros(n, dtype=I32, device=dev)

    def z():
        return torch.zeros((), dtype=I32, device=dev)

    return OverlayState(
        friends=friends, friend_cnt=cnt, mk_dst=mk_dst,
        bk_dst=torch.full((cap, n), -1, dtype=I32, device=dev),
        boot_dst=torch.full((n,), -1, dtype=I32, device=dev),
        mk_spill=torch.full((2, sc + 1), -1, dtype=I32, device=dev),
        bk_spill=torch.full((2, sc + 1), -1, dtype=I32, device=dev),
        round=0, makeups=z(), breakups=z(), win_makeups=z(),
        win_breakups=z(), mailbox_dropped=z())


def delivery_chunk(cfg: Config, n_rows: int) -> int:
    """Delivery chunk of the rounds engine: 64k, n/128 above ~8.4M rows,
    at most 1M; -compact-chunk overrides.  Chunk size never changes a
    mailbox (ascending ranges, ranks continuing across chunks)."""
    if cfg.compact_chunk > 0:
        return cfg.compact_chunk
    return min(n_rows, max(_config.OVERLAY_DELIVERY_CHUNK_BASE,
                           n_rows // 128),
               _config.OVERLAY_DELIVERY_CHUNK_CAP)


def hosted_chunk_widths(cfg: Config, n_rows: int) -> tuple[int, ...]:
    """The split round's chunk-width ladder: x4 rungs from delivery_chunk
    up to ADAPTIVE_CHUNK_MAX (the base width alone with
    -overlay-adaptive-chunks off)."""
    base = delivery_chunk(cfg, n_rows)
    if not cfg.overlay_adaptive_chunks_resolved:
        return (base,)
    hi = max(base, min(n_rows, ADAPTIVE_CHUNK_MAX))
    widths = [base]
    while widths[-1] < hi:
        widths.append(min(widths[-1] * 4, hi))
    return tuple(widths)


def _col_onehot(cols, k: int):
    """bool[n, k]: row r's `cols[r]` column."""
    return torch.arange(k, dtype=I32, device=cols.device)[None, :] \
        == cols[:, None]


def _col_get(arr, cols):
    """arr[rows, cols] via a one-hot select (0 where cols is out of
    range)."""
    return torch.where(_col_onehot(cols, arr.shape[1]), arr, 0).sum(
        dim=1, dtype=arr.dtype)


def _col_set(arr, cols, vals, mask=None):
    """arr[rows, cols] = vals (where mask) via a one-hot blend."""
    oh = _col_onehot(cols, arr.shape[1])
    if mask is not None:
        oh = oh & mask[:, None]
    return torch.where(oh, vals[:, None], arr)


def breakup_draw(n, kk, src, ids):
    """A breakup slot's replacement peers, != self and != the leaver (a
    leading axis of `kk`, `src` and `ids` draws several shards' at
    once)."""
    return _rng.randint_excluding(kk, n, src.shape[-1:], src, ids)


def makeup_draw(kk, cnt):
    """A makeup slot's eviction positions in [0, max(cnt, 1)) (batched
    like breakup_draw).  Drawn with the counts before the slot's appends:
    a row either appends or evicts, so only evicting rows' draws escape,
    and their counts do not change."""
    return _rng.randint(kk, cnt.shape[-1:], 0, torch.clamp_min(cnt, 1))


def process_breakup_slot(n, fanout, friends, cnt, src, has, ids, kk,
                         draw=None):
    """One mailbox slot of breakup decisions for all nodes.  Returns
    (friends, cnt, reply_dst, reply_mask): a makeup goes to reply_dst
    where reply_mask.  `draw`: breakup_draw's value, when the caller made
    it beforehand."""
    k = friends.shape[1]
    iok = torch.arange(k, dtype=I32, device=friends.device)[None, :]
    match = (friends == src[:, None]) & (iok < cnt[:, None]) & has[:, None]
    found = match.any(dim=1)
    # jnp.argmax(match): the first True column, 0 when there is none.
    pos = torch.where(found, torch.where(match, iok, k).amin(dim=1), 0)
    over = cnt > fanout
    rm = has & found & over
    rp = has & found & ~over
    nf = breakup_draw(n, kk, src, ids) if draw is None else draw
    lastpos = torch.clamp_min(cnt - 1, 0)
    lastval = _col_get(friends, lastpos)
    posval = torch.where(rm, lastval,
                         torch.where(rp, nf, _col_get(friends, pos)))
    friends = _col_set(friends, pos, posval)
    friends = _col_set(friends, lastpos, torch.full_like(cnt, -1), rm)
    cnt = cnt - rm.to(I32)
    return friends, cnt, nf, rp


def process_makeup_slot(fanin, friends, cnt, src, has, kk, draw=None):
    """One mailbox slot of makeup decisions.  Returns (friends, cnt,
    victim_dst, victim_mask): a breakup goes to victim_dst where
    victim_mask.  `draw`: makeup_draw's value on the slot's incoming
    counts, when the caller made it beforehand (else drawn here on the
    counts after the appends, as the JAX package's unfused path does;
    the same values where they are used)."""
    k = friends.shape[1]
    under = cnt < fanin
    app = has & under
    friends = _col_set(friends, torch.clamp_max(cnt, k - 1), src, app)
    cnt = cnt + app.to(I32)
    ev = has & ~under
    vpos = makeup_draw(kk, cnt) if draw is None else draw
    victim = _col_get(friends, vpos)
    friends = _col_set(friends, vpos, src, ev)
    return friends, cnt, victim, ev


def process_breakup_slot_pallas(n, fanout, friends, cnt, src, has, ids, kk,
                                draw=None):
    """process_breakup_slot through ``fused_negotiate`` (friends and cnt in
    place): the same replacement draw, made outside the kernel on the same
    key; the reply is where(rp, nf, -1) and nf >= 0, so (reply, reply >=
    0) reproduces the callers' blends."""
    nf = breakup_draw(n, kk, src, ids) if draw is None else draw
    friends, cnt, reply = overlay_kernel.fused_negotiate(
        friends, cnt, src, has, nf, kind="breakup", limit=fanout)
    return friends, cnt, reply, reply >= 0


def process_makeup_slot_pallas(fanin, friends, cnt, src, has, kk,
                               draw=None):
    """process_makeup_slot through ``fused_negotiate``.  The eviction
    position is drawn with the pre-append counts (makeup_draw), as the
    JAX package's fused path does."""
    vpos = makeup_draw(kk, cnt) if draw is None else draw
    friends, cnt, reply = overlay_kernel.fused_negotiate(
        friends, cnt, src, has, vpos, kind="makeup", limit=fanin)
    return friends, cnt, reply, reply >= 0


def heal_dead_friends(n_global: int, friends, friend_cnt, detected_global,
                      healer_ok, ids_global, heal_key):
    """Phase-2 re-entry of the bootstrap/needNewFriend draw
    (simulator.go:95-106): every live node replaces the friends its
    failure detector has condemned with a fresh uniform random peer, self
    patched ``(id + 1) % N`` as in the phase-1 bootstrap.  The reciprocal
    fanin-side accept is not simulated (as in the JAX package).
    `detected_global` is the full-axis bool detector verdict; draws are
    row-keyed on GLOBAL ids, and made only for the rows that replace a
    friend (a row's draw depends on its own key alone).  Updates `friends`
    in place; returns (friends, dead_mask, repaired count (int64 0-d))."""
    k = friends.shape[1]
    cols = torch.arange(k, dtype=torch.int32, device=friends.device)
    valid = (cols[None, :] < friend_cnt[:, None]) & (friends >= 0)
    dead = (detected_global[torch.clamp_min(friends, 0).long()] & valid
            & healer_ok[:, None])
    rows = torch.nonzero(dead.any(dim=1)).flatten()
    if rows.numel():
        g = ids_global[rows]
        w = _rng.row_randint(heal_key, n_global, g, k)
        w = torch.where(w == g[:, None], (w + 1) % n_global, w)
        friends[rows] = torch.where(dead[rows], w.to(friends.dtype),
                                    friends[rows])
    return friends, dead, dead.sum(dtype=torch.int64)


def phase1_slot_fns(cfg: Config):
    """(breakup_slot_fn, makeup_slot_fn) for cfg's -phase1-kernel gate."""
    if cfg.phase1_kernel_resolved == "pallas":
        return process_breakup_slot_pallas, process_makeup_slot_pallas
    return process_breakup_slot, process_makeup_slot


# --- the rounds engine ---------------------------------------------------------


def _slot(mbox, r: int, n: int):
    """Mailbox slot r of every node: a contiguous range of the flat
    rank-major mailbox, a column of the 2-D one."""
    if mbox.dim() == 1:
        return mbox[r * n:(r + 1) * n]
    return mbox[:, r]


def round_pieces(cfg: Config, n_rows: int | None = None):
    """The round's processing pieces for the whole node axis or, with
    `n_rows`, for each shard's rows of the sharded round (which delivers
    their mailboxes itself and runs the per-round bootstrap): returns
    (p_bk_process, p_mk_process, bk_shards, mk_shards), the last two
    taking the shards in lockstep, one list entry a shard, each slot's
    draws for every shard in one call."""
    n = cfg.n
    hooked = n_rows is not None
    rows_n = n_rows if hooked else n
    fanout, fanin = cfg.fanout, cfg.fanin_resolved
    cap = cfg.mailbox_cap_for(rows_n)
    bk_slot_fn, mk_slot_fn = phase1_slot_fns(cfg)
    request_fn = (overlay_kernel.fused_request_round
                  if cfg.phase1_kernel_resolved == "pallas"
                  else overlay_kernel.request_round_plain)
    static_boot = static_boot_applies(cfg, hooked)

    def slots(breakup: bool, friends, cnts, mboxes, depths, keys, ids):
        """The slot loop of each shard's breakup (makeup) mailbox, in
        lockstep; `keys` (S, 2) are the shards' round keys
        fold_in(base_key, round).  Updates `friends` and `cnts` in place;
        returns each shard's (emission rows (cap, rows), processed count,
        each row's entry count at write time)."""
        dev = keys.device
        op = _rng.OP_REPLACE if breakup else _rng.OP_EVICT
        kr = _rng.fold_in(keys, op)
        out = [(torch.full((cap, rows_n), -1, dtype=I32, device=dev),
                torch.zeros((), dtype=I32, device=dev),
                torch.zeros(cap, dtype=I32, device=dev)) for _ in depths]
        if breakup:
            ids_all = torch.stack(ids)
        none = torch.full((rows_n,), -1, dtype=I32, device=dev)
        for slot in range(max(depths, default=0)):
            kk = _rng.fold_in(kr, slot)
            srcs = [_slot(mb, slot, rows_n) if d > slot else none
                    for mb, d in zip(mboxes, depths)]
            if breakup:
                draws = breakup_draw(n, kk, torch.stack(srcs), ids_all)
            else:
                draws = makeup_draw(kk, torch.stack(cnts))
            for i, (src, d) in enumerate(zip(srcs, depths)):
                if d <= slot:
                    continue
                has = src >= 0
                if breakup:
                    friends[i], cnts[i], dst, mask = bk_slot_fn(
                        n, fanout, friends[i], cnts[i], src, has, ids[i],
                        kk[i], draw=draws[i])
                else:
                    friends[i], cnts[i], dst, mask = mk_slot_fn(
                        fanin, friends[i], cnts[i], src, has, kk[i],
                        draw=draws[i])
                em, done, em_cnt = out[i]
                em[slot] = torch.where(mask, dst, -1)
                em_cnt[slot] = mask.sum(dtype=I32)
                done += has.sum(dtype=I32)
        return out

    def bk_shards(friends, cnts, mboxes, depths, round_: int, keys, ids):
        """Process the breakup mailboxes (simulator.go:76-94), emitting
        replacement makeups: each shard's (mk_em, win_bk, mk_cnt)."""
        return slots(True, friends, cnts, mboxes, depths,
                     _rng.fold_in(keys, round_), ids)

    def mk_shards(friends, cnts, mboxes, depths, round_: int, keys, ids):
        """Process the makeup mailboxes (simulator.go:66-75) and run the
        bootstrap (simulator.go:95-106): each shard's (bk_em, win_mk,
        bk_cnt, boot_em, boot_cnt)."""
        rkeys = _rng.fold_in(keys, round_)
        out = slots(False, friends, cnts, mboxes, depths, rkeys, ids)
        dev = keys.device
        if static_boot:
            # cnt >= fanout holds from round 0 on (a breakup at or under
            # fanout replaces in place), so the bootstrap never fires.
            boot = [(torch.full((rows_n,), -1, dtype=I32, device=dev),
                     torch.zeros((), dtype=I32, device=dev))] * len(out)
        else:
            w = _rng.randint(_rng.fold_in(rkeys, _rng.OP_BOOTSTRAP),
                             (rows_n,), 0, n)
            w = torch.where(w == torch.stack(ids), (w + 1) % n, w)
            boot = []
            for i in range(len(out)):
                friends[i], cnts[i], boot_em, boot_cnt = request_fn(
                    friends[i], cnts[i], w[i], fanout=fanout)
                boot.append((boot_em, boot_cnt))
        return [o + b for o, b in zip(out, boot)]

    def p_bk_process(friends, cnt, bk_mbox, n_bk: int, round_: int,
                     base_key):
        """bk_shards on the whole node axis: (friends, cnt, mk_em, win_bk,
        mk_cnt)."""
        fr, cn = [friends], [cnt]
        (mk_em, win_bk, mk_cnt), = bk_shards(
            fr, cn, [bk_mbox], [n_bk], round_, base_key[None],
            [torch.arange(n, dtype=I32, device=friends.device)])
        return fr[0], cn[0], mk_em, win_bk, mk_cnt

    def p_mk_process(mk_mbox, n_mk: int, dropped, friends, cnt, mk_em,
                     win_bk, prev: OverlayState, base_key, mk_spill,
                     bk_spill, mk_cnt=None, aux: bool = False):
        """mk_shards on the whole node axis, and the next state assembled
        from `prev`'s counters.  With `aux` also returns the split round's
        write-time bookkeeping: (mk_cnt, bk_cnt, boot_cnt, live makeup
        spill pairs, live breakup spill pairs, quiesced) as host values,
        read in one transfer; quiesced equals quiesced(st)."""
        fr, cn = [friends], [cnt]
        (bk_em, win_mk, bk_cnt, boot_em, boot_cnt), = mk_shards(
            fr, cn, [mk_mbox], [n_mk], prev.round, base_key[None],
            [torch.arange(n, dtype=I32, device=friends.device)])
        del mk_mbox
        st = OverlayState(
            friends=fr[0], friend_cnt=cn[0], mk_dst=mk_em, bk_dst=bk_em,
            boot_dst=boot_em, mk_spill=mk_spill, bk_spill=bk_spill,
            round=prev.round + 1, makeups=prev.makeups + win_mk,
            breakups=prev.breakups + win_bk, win_makeups=win_mk,
            win_breakups=win_bk, mailbox_dropped=prev.mailbox_dropped
            + dropped)
        if not aux:
            return st
        mk_sp_live = (mk_spill[1] >= 0).sum(dtype=I32)
        bk_sp_live = (bk_spill[1] >= 0).sum(dtype=I32)
        vals = torch.cat([mk_cnt, bk_cnt, torch.stack([
            boot_cnt, mk_sp_live, bk_sp_live, win_mk, win_bk])]).tolist()
        a_mk, a_bk = vals[:cap], vals[cap:2 * cap]
        boot, msp, bsp, wm, wb = vals[2 * cap:]
        pending = sum(a_mk) + sum(a_bk) + boot + msp + bsp
        q = wm == 0 and wb == 0 and pending == 0 and st.round > 0
        return st, (a_mk, a_bk, boot, msp, bsp, q)

    return p_bk_process, p_mk_process, bk_shards, mk_shards


def make_round_fn(cfg: Config):
    """One overlay round, round_fn([st], base_key) -> st (the state is
    handed over in a one-element list and popped, so no caller frame keeps
    the old buffers alive through the round).  Its two processing pieces
    (round_pieces) are exposed as ``round_fn.pieces`` for the split
    round."""
    n = cfg.n
    cap = cfg.mailbox_cap_for(n)
    dchunk = delivery_chunk(cfg, n)
    dkern = cfg.deliver_kernel_resolved
    sc_band = spill_cap_for(cfg, n)
    p_bk_process, p_mk_process = round_pieces(cfg)[:2]

    if n > COLUMN_DELIVERY_MIN_ROWS and flat_addressing_fits(n, cap):
        def deliver_matrix_fn(mats, spill_in):
            """Per emission row, rank-major; overflow spills when the
            band has a spill (last round's pairs first)."""
            if sc_band == 0:
                return mailbox.deliver_columns(mats, n, cap, dchunk,
                                               kernel=dkern) + (None,)
            spill = mailbox.new_spill(sc_band, mats[0].device)
            out = mailbox.deliver_columns(mats, n, cap, dchunk,
                                          spill_in=spill_in, spill=spill,
                                          kernel=dkern)
            return out + (spill[0],)
    else:
        def deliver_matrix_fn(mats, spill_in):
            """Node-major over the slot-major flattened rows (sender =
            flat index % n); overflow is counted, never spilled."""
            flat = torch.cat([m.reshape(-1) for m in mats])
            mbox, cnt, dropped = mailbox.deliver(
                None, flat, flat >= 0, n, cap, compact_chunk=dchunk,
                src_mod=n, kernel=dkern)
            return mbox, int(cnt.max()), dropped, None

    def round_fn(box, base_key) -> OverlayState:
        st = box.pop()
        bk_mbox, n_bk, drop2, bk_sp = deliver_matrix_fn(
            (st.bk_dst,), st.bk_spill)
        st.bk_dst = None
        friends, cnt, mk_em, win_bk, _ = p_bk_process(
            st.friends, st.friend_cnt, bk_mbox, n_bk, st.round, base_key)
        del bk_mbox
        st.friends = st.friend_cnt = None
        mk_mbox, n_mk, drop1, mk_sp = deliver_matrix_fn(
            (st.mk_dst, st.boot_dst[None, :]), st.mk_spill)
        st.mk_dst = st.boot_dst = None
        return p_mk_process(
            mk_mbox, n_mk, drop1 + drop2, friends, cnt, mk_em, win_bk, st,
            base_key, mk_sp if mk_sp is not None else st.mk_spill,
            bk_sp if bk_sp is not None else st.bk_spill)

    round_fn.pieces = (p_bk_process, p_mk_process)
    return round_fn


def make_split_round_fn(cfg: Config):
    """One overlay round for the split-round band (use_split_round): the
    same two processing pieces as make_round_fn, with both deliveries run
    by mailbox.make_hosted_column_delivery (per-row chunk widths from
    hosted_chunk_widths).  With -overlay-dead-skip the pieces' write-time
    row counts are carried to the next round, which then skips the empty
    rows without counting them, skips an empty spill's re-delivery, and
    reports quiescence from the counts (``round4.last_quiesced``).  The
    first round, and a round whose state is not the one the counts
    describe, count rows instead (fused_hosted_chunk under
    -phase1-kernel pallas/auto)."""
    p_bk_process, p_mk_process = make_round_fn(cfg).pieces
    n = cfg.n
    cap = cfg.mailbox_cap_for(n)
    dead_skip = cfg.overlay_dead_skip_resolved
    sc_split = spill_cap_for(cfg, n)
    hosted = mailbox.make_hosted_column_delivery(
        n, cap, hosted_chunk_widths(cfg, n), spill_cap=sc_split,
        kernel=cfg.deliver_kernel_resolved,
        occupancy=cfg.phase1_kernel_resolved)
    carry = {"mk": None, "bk": None, "boot": None, "round": None,
             "mk_sp": None, "bk_sp": None}

    def deliver(mats, spill, totals, skip_spill: bool):
        if sc_split == 0:
            return hosted(mats, row_totals=totals) + (spill,)
        return hosted(mats, spill_in=None if skip_spill else spill,
                      row_totals=totals)

    def round4(box, base_key) -> OverlayState:
        st = box.pop()
        if dead_skip and carry["mk"] is not None \
                and carry["round"] != st.round:
            carry["mk"] = carry["bk"] = carry["boot"] = None
        known = dead_skip and carry["mk"] is not None
        bk_mbox, n_bk, drop2, bk_sp = deliver(
            (st.bk_dst,), st.bk_spill, carry["bk"] if dead_skip else None,
            known and carry["bk_sp"] == 0)
        st.bk_dst = None
        friends, cnt, mk_em, win_bk, mk_cnt = p_bk_process(
            st.friends, st.friend_cnt, bk_mbox, n_bk, st.round, base_key)
        del bk_mbox
        st.friends = st.friend_cnt = None
        mk_mbox, n_mk, drop1, mk_sp = deliver(
            (st.mk_dst, st.boot_dst[None, :]), st.mk_spill,
            carry["mk"] + [carry["boot"]] if known else None,
            known and carry["mk_sp"] == 0)
        st.mk_dst = st.boot_dst = None
        out = p_mk_process(mk_mbox, n_mk, drop1 + drop2, friends, cnt, mk_em,
                           win_bk, st, base_key, mk_sp, bk_sp, mk_cnt=mk_cnt,
                           aux=dead_skip)
        if not dead_skip:
            return out
        out, (a_mk, a_bk, boot, msp, bsp, q) = out
        carry.update(mk=a_mk, bk=a_bk, boot=boot, mk_sp=msp, bk_sp=bsp,
                     round=out.round)
        round4.last_quiesced = q
        return out

    round4.last_quiesced = None
    return round4


def use_split_round(cfg: Config) -> bool:
    """The split round runs from SPLIT_ROUND_MIN_ROWS rows, within int32
    flat mailbox addressing."""
    return (cfg.n >= SPLIT_ROUND_MIN_ROWS
            and flat_addressing_fits(cfg.n, cfg.mailbox_cap_for(cfg.n)))


def pending_emissions(st: OverlayState) -> torch.Tensor:
    """Messages still in flight: emission entries and spilled pairs."""
    return ((st.mk_dst >= 0).sum(dtype=I32) + (st.bk_dst >= 0).sum(dtype=I32)
            + (st.boot_dst >= 0).sum(dtype=I32)
            + (st.mk_spill[1] >= 0).sum(dtype=I32)
            + (st.bk_spill[1] >= 0).sum(dtype=I32))


def quiesced(st: OverlayState) -> torch.Tensor:
    """0-d bool: nothing processed this round and nothing in flight, after
    round 0."""
    return ((st.win_makeups == 0) & (st.win_breakups == 0)
            & (pending_emissions(st) == 0) & (st.round > 0))


def run_call_budget(cfg: Config, shards: int = 1) -> int:
    """Rounds per bounded call of overlay_run_to_quiescence (the JAX
    package's watchdog budget: 4e7 / n, capped at 1024; `shards` scales
    it for the sharded round, whose work a call tracks one shard's rows,
    before the clamp)."""
    return max(1, min(1024, int(4e7 * shards // max(cfg.n, 1))))


def make_bounded_run(round_fn, quiesced_fn):
    """The phase-1 run-to-quiescence loop: up to `max_polls` windows a
    call, testing quiescence before each (so an overlay already quiesced
    runs none), each window's quiescence read back in one host read, and
    with a History one overlay_probe row a window.  `round_fn(box, key)`
    pops the state from its one-element list (no caller frame keeps the
    old buffers alive through a round).  run_fn(box, key, max_polls,
    hist) -> (st, polls, quiesced, hist); keys are by round or tick, so
    the trajectory is the windowed loop's."""
    from gossip_simulator_tpu_torch.utils import telemetry as telem

    def run_fn(box, base_key, max_polls: int, hist=None):
        st = box.pop()
        polls = 0
        q = bool(quiesced_fn(st))
        while polls < max_polls and not q:
            box = [st]
            st = None
            st = round_fn(box, base_key)
            polls += 1
            if hist is not None:
                telem.record(hist, telem.overlay_probe(st))
            q = bool(quiesced_fn(st))
        return st, polls, q, hist

    return run_fn
