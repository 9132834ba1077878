"""Tick-faithful dynamic-overlay construction (phase 1 of the default run).

The port of the JAX package's ``models/overlay_ticks.py``, node-major band
(n below TICKS_SLOTMAJOR_MIN_ROWS; the slot-major band is not yet ported,
ROADMAP A17; the sharded overlay runs its shards' rows node-major at any
n).  Every makeup/breakup send draws its own uniform delay in
[delaylow, delayhigh) ms (simulator.go:151-168); messages sit in a packed
window-slot ring, and the stabilization clock is true simulated ms.

Per B-tick window (B = min(10, delaylow), so a message emitted in one
window always arrives in a later one):
  1. drain this window's ring slot; stable-sort its entries by arrival
     tick, so per-node mailbox order is arrival order;
  2. deliver breakups and makeups into fixed-capacity mailboxes
     (``ops/mailbox.deliver_pair``) and process them slot by slot, all
     nodes at once, with the shared decision rules (``models/overlay``);
  3. append every emission (replacement makeup, eviction breakup) to the
     ring at its trigger's arrival tick plus a fresh per-message delay.

Bootstrap is a window-0 burst: init_state draws the whole initial friends
table and appends the n*fanout makeup burst.  Quiescence: a full 10 ms
poll window with no processed membership message and an empty ring.

Where the JAX package threads the state through jitted functions, the
port updates the rings, their counts and the counters in place, and its
data-dependent ``fori_loop`` counts are Python loops with one host read
each: the drained slot's entry count, the two mailbox depths, and each
emission buffer's total.  The drain sorts exactly the slot's live
entries (the JAX package picks the narrowest of a few power-of-4 widths
at or above that count; any such width leaves the same mailboxes), and
the emission buffers hold only the mailbox columns the window used.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from gossip_simulator_tpu_torch import config as _config
from gossip_simulator_tpu_torch.config import Config
from gossip_simulator_tpu_torch.models.overlay import (breakup_draw,
                                                       makeup_draw,
                                                       phase1_slot_fns)
from gossip_simulator_tpu_torch.ops.mailbox import deliver_pair, ring_append
from gossip_simulator_tpu_torch.ops.select import first_true_indices
from gossip_simulator_tpu_torch.utils import rng as _rng

I32 = torch.int32

MK = 0  # payload type bit: makeup
BK = 1  # breakup

POLL_MS = 10  # one poll window (simulator.go:221-234)


def batch_ticks(cfg: Config) -> int:
    """Window size B; also bounded so pay = (src*2+type)*b + toff fits
    int32."""
    b = max(1, min(10, cfg.delaylow))
    while b > 1 and (2 * cfg.n + 2) * b >= 2**31:
        b //= 2
    return b


def ring_windows(cfg: Config) -> int:
    b = batch_ticks(cfg)
    return (b - 1 + cfg.delayhigh - 1) // b + 1


def slot_cap(cfg: Config, n_local: int | None = None) -> int:
    """Packed entries per window slot: twice the bootstrap burst spread
    over the delay span, bounded by the JAX package's ~3 GB budget for both
    rings (kept so the ring, hence the trajectory, is sized identically)
    and by int32 flat addressing."""
    n = n_local if n_local is not None else cfg.n
    b = batch_ticks(cfg)
    dw = ring_windows(cfg)
    cap = max(4096, int(math.ceil(
        2.0 * n * cfg.fanout * b / max(cfg.delay_span, 1))))
    cap = min(cap, (3 * 2**30) // (8 * max(dw, 1)))
    return min(cap, (2**31 - 2) // max(dw, 1))


def ticks_spill_cap(cfg: Config, n_rows: int | None = None) -> int:
    """Spill capacity of a single-device ticks surface (0: none): the
    JAX package's, which engages only in the slot-major band at a
    mailbox cap below 16 (that band is not yet ported: ROADMAP A17)."""
    from gossip_simulator_tpu_torch.models import overlay

    n = n_rows if n_rows is not None else cfg.n
    cap_mb = cfg.mailbox_cap_for(n, stacked=True)
    return (overlay.SPILL_CAP
            if (n >= _config.TICKS_SLOTMAJOR_MIN_ROWS
                and overlay.spill_enabled(cap_mb)) else 0)


def emit_chunk(cfg: Config, n_local: int | None = None) -> int:
    """Emission chunk: lanes per ring append."""
    n = n_local if n_local is not None else cfg.n
    return min(slot_cap(cfg, n_local), max(4096, min(262_144, n // 8)))


def ticks_delivery_chunk(cfg: Config, n_rows: int) -> int:
    """Delivery chunk of the slot drain: n/8 rounded up to a power of two,
    floor 64k, cap 2M; -compact-chunk overrides.  Chunking never changes
    the mailboxes (ranks continue across chunks)."""
    if cfg.compact_chunk > 0:
        return cfg.compact_chunk
    cap = _config.OVERLAY_TICKS_DELIVERY_CHUNK_CAP
    want = min(max(65_536, n_rows // 8), cap)
    return 1 << (want - 1).bit_length()


@dataclasses.dataclass
class OverlayTickState:
    """Leaf names follow the JAX package's OverlayTickState; counters are
    int32 0-d tensors on the run's device, ``tick`` a host int.
    ``utils/interop.py`` converts to and from the JAX package's numpy
    form."""

    friends: torch.Tensor  # int32[n, k]  -1 padded
    friend_cnt: torch.Tensor  # int32[n]
    # Packed ring, slot s at [s*cap, (s+1)*cap); last element = trash cell.
    ring_dst: torch.Tensor  # int32[dw*cap + 1]
    ring_pay: torch.Tensor  # int32[dw*cap + 1]  (src*2 + type)*b + toff
    ring_cnt: torch.Tensor  # int32[1, dw]
    # Mailbox-overflow spill pairs: the token (2, 1) of -1 in this band
    # (the spill engages only in the slot-major band).
    spill: torch.Tensor  # int32[2, 1]
    tick: int  # window-aligned simulated ms
    makeups: torch.Tensor  # int32[]  cumulative processed (MakeUps)
    breakups: torch.Tensor  # int32[]
    win_makeups: torch.Tensor  # int32[]  this POLL window's counts
    win_breakups: torch.Tensor  # int32[]
    mailbox_dropped: torch.Tensor  # int32[]  mailbox + ring overflow


def _append(cfg: Config, st: OverlayTickState, dst, pay, wslot, valid):
    """Append one (dst, pay) entry per True in `valid` into its window
    slot, in place (``ops/mailbox.ring_append``)."""
    dw = ring_windows(cfg)
    cap = (st.ring_dst.shape[0] - 1) // dw
    ring_append((st.ring_dst, st.ring_pay), st.ring_cnt, st.mailbox_dropped,
                (dst, pay), wslot, valid, dw, cap,
                kernel=cfg.deliver_kernel_resolved)


def init_state(cfg: Config, base_key: torch.Tensor) -> OverlayTickState:
    """Initial friends table + the window-0 bootstrap makeup burst."""
    n, k, f = cfg.n, cfg.max_degree, cfg.fanout
    dev = base_key.device
    b = batch_ticks(cfg)
    dw = ring_windows(cfg)
    cap = slot_cap(cfg)
    ids = torch.arange(n, dtype=I32, device=dev)
    kb = _rng.tick_key(base_key, 0, _rng.OP_BOOTSTRAP)
    # One independent draw per (node, slot), self patched (id+1)%n
    # (simulator.go:97-100); duplicates allowed, like the reference.
    w = _rng.randint(_rng.row_keys(kb, ids), (f,), 0, n)
    w = torch.where(w == ids[:, None], (w + 1) % n, w)
    friends = torch.full((n, k), -1, dtype=I32, device=dev)
    friends[:, :f] = w

    def z():
        return torch.zeros((), dtype=I32, device=dev)

    st = OverlayTickState(
        friends=friends, friend_cnt=torch.full((n,), f, dtype=I32,
                                               device=dev),
        ring_dst=torch.zeros(dw * cap + 1, dtype=I32, device=dev),
        ring_pay=torch.zeros(dw * cap + 1, dtype=I32, device=dev),
        ring_cnt=torch.zeros((1, dw), dtype=I32, device=dev),
        spill=torch.full((2, 1), -1, dtype=I32, device=dev),
        tick=0, makeups=z(), breakups=z(), win_makeups=z(),
        win_breakups=z(), mailbox_dropped=z())
    # The burst: n*f makeups at t=0, each with its own delay, appended in
    # chunks through the same path as every later emission.  (The JAX
    # package pads the last chunk with invalid lanes, which only write 0
    # to the trash cell.)
    kd = _rng.tick_key(base_key, 0, _rng.OP_DELAY)
    flat_n = n * f
    chunk = emit_chunk(cfg)
    wflat = w.reshape(-1)
    for lo in range(0, flat_n, chunk):
        idx = torch.arange(lo, min(lo + chunk, flat_n), dtype=I32,
                           device=dev)
        arrive = _rng.row_uniform_delay(kd, cfg.delaylow, cfg.delayhigh,
                                        idx)  # emitted at t=0
        _append(cfg, st, wflat[lo:lo + chunk],
                (idx // f * 2 + MK) * b + arrive % b, (arrive // b) % dw,
                torch.ones_like(idx, dtype=torch.bool))
    return st


def _emit_all(cfg: Config, st: OverlayTickState, base_key, w: int, em_dst,
              em_toff, typ: int, op: int, stride: int | None = None):
    """Compact an (n, cols) emission buffer and append every entry (dst >=
    0) in row-major order with a fresh per-message delay drawn at its
    trigger's arrival tick, keyed by the entry's flat index in the JAX
    package's (n, stride) buffer (`stride` defaults to cols; the step's
    buffers hold only the first `cols` of `stride` mailbox columns).

    The JAX package extracts the next `emit_chunk` indices with
    first_true_indices once per chunk; the port extracts them all in one
    call (one host read of the total) and slices: the same indices."""
    b = batch_ticks(cfg)
    dw = ring_windows(cfg)
    cols = em_dst.shape[1]
    stride = stride or cols
    dflat = em_dst.reshape(-1)
    tflat = em_toff.reshape(-1)
    valid_all = dflat >= 0
    total = int(valid_all.sum())
    if total == 0:
        return
    ridx_all = first_true_indices(valid_all, total)
    kd = _rng.tick_key(base_key, w, op)
    chunk = emit_chunk(cfg)
    for lo in range(0, total, chunk):
        ridx = ridx_all[lo:lo + chunk]
        src = ridx // cols
        idx = src * stride + ridx % cols  # keys the delay draw
        delay = _rng.row_uniform_delay(kd, cfg.delaylow, cfg.delayhigh, idx)
        r64 = ridx.long()
        arrive = w * b + tflat[r64] + delay
        _append(cfg, st, dflat[r64], (src * 2 + typ) * b + arrive % b,
                (arrive // b) % dw, torch.ones_like(ridx, dtype=torch.bool))


def make_step_fn(cfg: Config, n_local: int | None = None):
    """One B-tick window transition (drain -> deliver -> process -> emit),
    in place.  Its drain and processing pieces are ``step_fn.pieces``;
    with `n_local` they serve one shard's rows of the sharded overlay
    (``parallel/overlay_ticks_sharded.py``, which routes the emissions
    and passes the rows' global ids to the breakup decisions), node-major
    at any n."""
    n = cfg.n
    rows_n = n_local if n_local is not None else n
    fanout, fanin = cfg.fanout, cfg.fanin_resolved
    b = batch_ticks(cfg)
    dw = ring_windows(cfg)
    cap = slot_cap(cfg, n_local)
    cap_mb = cfg.mailbox_cap_for(rows_n, stacked=True)
    dchunk = ticks_delivery_chunk(cfg, rows_n)
    dkern = cfg.deliver_kernel_resolved
    bk_slot_fn, mk_slot_fn = phase1_slot_fns(cfg)

    def drain(st, slot: int, m: int):
        """The slot's m live entries, stable-sorted by arrival tick, into
        the two mailbox sets."""
        lo = slot * cap
        dst_e = st.ring_dst[lo:lo + m]
        pay_e = st.ring_pay[lo:lo + m]
        order = torch.sort(pay_e % b, stable=True).indices
        dst_e, pay_e = dst_e[order], pay_e[order]
        typ = (pay_e // b) % 2
        mbox_pay = (pay_e // (2 * b)) * b + pay_e % b  # src*b + toff
        return deliver_pair(mbox_pay, dst_e, typ, rows_n, cap_mb, dchunk, m,
                            kernel=dkern)

    def process_shards(breakup: bool, mboxes, depths, keys, friends, cnts,
                       ids):
        """Slot-sequential decisions over each shard's first `depths[i]`
        mailbox columns, all rows at once, the shards in lockstep: a
        slot's draws for every shard in one call (`keys`: (S, 2), a key a
        shard; `ids`: each shard's global row ids, read by the breakup
        decisions only).  Updates the `friends`
        and `cnts` lists in place; returns each shard's (emission dst,
        emission toff, processed count)."""
        dev = keys.device
        out = [(torch.full((rows_n, d), -1, dtype=I32, device=dev),
                torch.zeros((rows_n, d), dtype=I32, device=dev),
                torch.zeros((), dtype=I32, device=dev)) for d in depths]
        if breakup:
            ids_all = torch.stack(ids)
        zero = torch.zeros(rows_n, dtype=I32, device=dev)
        for sl in range(max(depths, default=0)):
            kk = _rng.fold_in(keys, sl)
            pays = [mb[:, sl] if d > sl else zero - 1
                    for mb, d in zip(mboxes, depths)]
            srcs = [torch.where(p >= 0, p // b, 0) for p in pays]
            if breakup:
                draws = breakup_draw(n, kk, torch.stack(srcs), ids_all)
            else:
                draws = makeup_draw(kk, torch.stack(cnts))
            for i, (pay, src, d) in enumerate(zip(pays, srcs, depths)):
                if d <= sl:
                    continue
                has = pay >= 0
                if breakup:
                    friends[i], cnts[i], dst, mask = bk_slot_fn(
                        n, fanout, friends[i], cnts[i], src, has, ids[i],
                        kk[i], draw=draws[i])
                else:
                    friends[i], cnts[i], dst, mask = mk_slot_fn(
                        fanin, friends[i], cnts[i], src, has, kk[i],
                        draw=draws[i])
                em_dst, em_toff, done = out[i]
                em_dst[:, sl] = torch.where(mask, dst, -1)
                em_toff[:, sl] = torch.where(has, pay % b, 0)
                done += has.sum(dtype=I32)
        return out

    def process(breakup: bool, mbox, depth: int, key, friends, cnt):
        """process_shards on one device's rows.  Returns (friends, cnt,
        emission dst, emission toff, processed count)."""
        fr, cn = [friends], [cnt]
        ids = [torch.arange(n, dtype=I32, device=mbox.device)] * breakup
        (em_dst, em_toff, done), = process_shards(
            breakup, [mbox], [depth], key[None], fr, cn, ids)
        return fr[0], cn[0], em_dst, em_toff, done

    def step_fn(st: OverlayTickState, base_key) -> OverlayTickState:
        w = st.tick // b
        slot = w % dw
        m = int(st.ring_cnt[0, slot])
        st.tick += b
        if m == 0:
            return st  # nothing arrives: no decision, no emission
        mk_mbox, bk_mbox, drops = drain(st, slot, m)
        st.ring_cnt[0, slot] = 0
        st.mailbox_dropped += drops
        n_bk, n_mk = torch.stack([(bk_mbox >= 0).sum(dim=1).max(),
                                  (mk_mbox >= 0).sum(dim=1).max()]).tolist()
        # Breakups (simulator.go:76-94), then makeups (simulator.go:66-75),
        # slot-sequential.
        fr, cn, mk_em_dst, mk_em_toff, win_bk = process(
            True, bk_mbox, n_bk, _rng.tick_key(base_key, w, _rng.OP_REPLACE),
            st.friends, st.friend_cnt)
        fr, cn, bk_em_dst, bk_em_toff, win_mk = process(
            False, mk_mbox, n_mk, _rng.tick_key(base_key, w, _rng.OP_EVICT),
            fr, cn)
        st.friends, st.friend_cnt = fr, cn
        del mk_mbox, bk_mbox
        # Emissions -> ring, per-message delays.
        _emit_all(cfg, st, base_key, w, mk_em_dst, mk_em_toff, MK,
                  _rng.OP_DELAY, stride=cap_mb)
        _emit_all(cfg, st, base_key, w, bk_em_dst, bk_em_toff, BK,
                  _rng.OP_DELAY_BK, stride=cap_mb)
        st.makeups += win_mk
        st.breakups += win_bk
        st.win_makeups += win_mk
        st.win_breakups += win_bk
        return st

    step_fn.pieces = (drain, process_shards)
    return step_fn


def make_poll_fn(cfg: Config):
    """One 10 ms poll window: ceil(10 / B) steps, with win_makeups /
    win_breakups counted over the window (simulator.go:221-234)."""
    step = make_step_fn(cfg)
    steps = max(1, -(-POLL_MS // batch_ticks(cfg)))

    def poll(st: OverlayTickState, base_key) -> OverlayTickState:
        st.win_makeups.zero_()
        st.win_breakups.zero_()
        for _ in range(steps):
            step(st, base_key)
        return st

    return poll


def quiesced(st: OverlayTickState) -> torch.Tensor:
    """0-d bool: a full poll window with zero processed messages and an
    empty ring (and spill)."""
    return ((st.win_makeups == 0) & (st.win_breakups == 0)
            & ~torch.any(st.ring_cnt > 0) & ~torch.any(st.spill[1] >= 0)
            & (st.tick > 0))


def run_call_budget(cfg: Config, shards: int = 1) -> int:
    """Poll windows per bounded call of overlay_run_to_quiescence (the
    JAX package's watchdog budget: 2e7 / n, capped at 1024; `shards`
    scales it for the sharded overlay before the clamp)."""
    return max(1, min(1024, int(2e7 * shards // max(cfg.n, 1))))
