"""The phase-2 megakernels: ``fused_emit``, the event engine's emission
chain as one kernel, ``fused_deposit_both``, the ring engine's two
multi-rumor deposits in one pass, and ``fused_drain_sum``, PushSum's
whole-slot drain.

From the gathered friends rows down, for one batch of senders: the edge
mask, the partition mask (the scenario's send-time ``partition_blocked``,
computed outside as the JAX package computes it, counted as blocked),
the duplicate filter against the RECEIVED bit, the SIR trigger lane, the
per-slot weighted exclusive prefix of reservation sizes, the capacity
check and the ring write at reserved cells or unique trash lanes
(``dw*cap + i*kw + kk``).  The random draws (drop mask, delay slot) stay
outside, so the streams are untouched.

On the card the wrapper launches the CUDA kernel ``csrc/fused_emit.cu``
(one launch on the single-pass append of ``csrc/lookback.cuh``, shared
with ``fused_ring_append`` and ``fused_recv_land`` -- deterministic,
bit-identical to the chain below).  On the CPU it takes the plain
version, ``emit_plain``: the JAX package's unfused chain
(``models/event.py`` append_messages), whose layout half ``emit_layout``
the engine's ``-phase2-kernel xla`` path also runs.  A tensor on any
other device raises.

Under multi-rumor traffic every lane also writes its sender's W rumor
words (the int32 view of the JAX package's uint32 words) at its id cell
of the (L, W) word ring: the kept lanes' words at their reserved cells,
every other lane's (0 where its id is 0) at its trash cell.

``fused_deposit_both`` (``csrc/fused_deposit_both.cu``) adds, for every
kept edge, the +1 arrival count and the sender's row of new rumor bits
(``newbits[i // k]``, read in the kernel: one add a set bit) at the shared
(slot, dst) cell;
its plain version ``deposit_both_plain`` is the sequential pair of
``ops/deliver.py`` plain deposits.  Integer adds commute, so both equal
the JAX package's unfused pair bit for bit.

``fused_drain_sum`` (``csrc/fused_drain_sum.cu``) adds the mass row of
every live lane of one window slot into the accumulator row its entry
decodes to (``entry // b``), reading the slot's live count from device
memory; its plain version ``drain_sum_plain`` is one masked
``index_add_`` over the live lanes.  Integer adds commute, so both equal
the JAX package's chunked ``deposit_sum`` loop bit for bit.

``fused_recv_land`` (``csrc/fused_recv_land.cu``) lands one shard's
routed wire words in its mail ring: the decode of ``dst * (dw*b) + slot *
b + off``, the duplicate filter against the RECEIVED bit and the ring
append (lane-order ranks, ok-only count increments, the ``dw*cap`` trash
cell), with an optional row of words per lane (PushSum's mass limbs).
Its plain version ``recv_land_plain`` is the JAX package's unfused chain
(``parallel/event_sharded.py`` _route_and_append's receive half):
``recv_decode`` then ``deliver.ring_append_plain``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from gossip_simulator_tpu_torch.ops import _build, deliver
from gossip_simulator_tpu_torch.ops.deliver import (ring_append_plain,
                                                    slot_prefix)

NAME = "fused_emit"
I32 = torch.int32
_ARGTYPES = ([ctypes.c_void_p] * 8 + [ctypes.c_int] + [ctypes.c_void_p] * 5
             + [ctypes.c_int] * 8 + [ctypes.c_void_p] * 2
             + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
                ctypes.c_longlong, ctypes.c_void_p])
# fused_emit's launches with a partition mask, and with rumor words.
PMASK = NAME + ":pmask"
WORDS = NAME + ":words"


def emit_layout(mail_cnt, sf, drop, svalid, wslot, off, *, dw: int,
                cap: int, b: int, tb=None, strig=None, sender_ids=None,
                pmask=None, flags=None, received_bit: int = 1, swords=None):
    """The unfused chain without its final write: returns (flat, ivals,
    adds[dw], sup[dw], lost, blocked, wvals) with flat/ivals of m*kw
    lanes, int32; wvals (m*kw, W) holds each lane's sender row of
    `swords` (int32 (m, W), the rumor words) where the lane's id value is
    its payload, 0 elsewhere (None without `swords`).

    `pmask` (bool (m, k), the raw partition_blocked matrix) blocks the
    edges it marks before the duplicate filter; `blocked` counts them (0
    without it).  Each row's start is the weighted prefix of its slot
    (``deliver.slot_prefix``); rows with svalid False get zero prefix and
    every consumer masks them with ok.  Dead lanes divert to unique trash
    positions, so the write needs no duplicate handling."""
    m, k = sf.shape
    dev = sf.device
    edge = svalid[:, None] & ~drop & (sf >= 0)
    blocked = torch.zeros((), dtype=torch.int64, device=dev)
    if pmask is not None:
        bl = pmask & edge
        blocked = bl.sum()
        edge = edge & ~bl
    dcnt = None
    if flags is not None:
        dstf = flags[torch.where(sf >= 0, sf, 0).long()]
        dup = edge & ((dstf & received_bit) > 0)
        dcnt = dup.sum(dim=1, dtype=I32)  # suppressed edges per sender
        edge = edge & ~dup
    cols = torch.cumsum(edge, dim=1, dtype=I32) - 1  # kept-edge rank in row
    ec = edge.sum(dim=1, dtype=I32)  # kept edges per sender
    payload = sf * b + off[:, None]
    if strig is not None:
        # The trigger occupies the slot right after the kept edges.
        cols = torch.cat([cols, ec[:, None]], dim=1)
        edge = torch.cat([edge, strig[:, None]], dim=1)
        payload = torch.cat(
            [payload, (tb + sender_ids * b + off)[:, None]], dim=1)
        ec = ec + strig.to(I32)
    seg, _ = slot_prefix(wslot, ec, svalid, dw)
    slot = torch.where(svalid, wslot, 0).long()
    sup = torch.zeros(dw, dtype=I32, device=dev)
    if dcnt is not None:
        sup.index_add_(0, slot, torch.where(svalid, dcnt, 0))
    base = torch.where(svalid, mail_cnt[0][slot], 0)
    start = base + seg
    ok = svalid & (start + ec <= cap)
    kw = edge.shape[1]
    lane = torch.arange(m * kw, dtype=I32, device=dev).reshape(m, kw)
    flat = torch.where(edge & ok[:, None],
                       wslot[:, None] * cap + start[:, None] + cols,
                       dw * cap + lane)
    ivals = torch.where(edge, payload, torch.zeros_like(payload))
    # Overflowed senders are a per-slot suffix (start grows monotonically
    # within a slot), so counting only written reservations keeps
    # positions contiguous.
    adds = torch.zeros(dw, dtype=I32, device=dev)
    adds.index_add_(0, slot, torch.where(ok, ec, 0))
    lost = (edge & ~ok[:, None]).sum()
    wvals = None
    if swords is not None:
        wvals = torch.where(edge[:, :, None], swords[:, None, :],
                            0).reshape(m * kw, swords.shape[1])
    return (flat.reshape(-1), ivals.reshape(-1), adds, sup, lost, blocked,
            wvals)


def emit_plain(mail_ids, mail_cnt, sf, drop, svalid, wslot, off, *,
               dw: int, cap: int, b: int, tb=None, strig=None,
               sender_ids=None, pmask=None, flags=None,
               received_bit: int = 1, swords=None, mail_words=None):
    """Plain version: ``emit_layout`` plus one ``index_put_`` a ring."""
    flat, ivals, adds, sup, lost, blocked, wvals = emit_layout(
        mail_cnt, sf, drop, svalid, wslot, off, dw=dw, cap=cap, b=b,
        tb=tb, strig=strig, sender_ids=sender_ids, pmask=pmask, flags=flags,
        received_bit=received_bit, swords=swords)
    mail_ids.index_put_((flat.long(),), ivals)
    if swords is None:
        return mail_ids, adds, sup, lost, blocked
    mail_words.index_put_((flat.long(),), wvals)
    return mail_ids, adds, sup, lost, blocked, mail_words


# Senders a block of the kernel takes (csrc/fused_emit.cu EMIT_TILE).
EMIT_TILE = 256


def emit_group(kw: int) -> int:
    """Threads of the kernel that serve one sender row of kw lanes (the C
    entry's `group`), by the device times of its forms on the card
    (PERF.md): a thread a row up to 8 lanes (the event engine's 6 and 7),
    eight threads past that (kw 33, erdos1m_wide's 38, kw 112)."""
    return 1 if kw <= 8 else 8


def _words_check(mail_ids, sf, swords, mail_words, strig) -> None:
    """Raise on rumor words the emission does not take (either version):
    int32 (m, W) sender rows and an int32 (L, W) word ring as long as the
    id ring, on its device; not with the SIR trigger lane (the rumor axis
    is SI only)."""
    if (swords is None) != (mail_words is None):
        raise ValueError(f"{NAME}: swords and mail_words go together")
    if swords is None:
        return
    if strig is not None:
        raise ValueError(f"{NAME}: rumor words are SI only (no trigger "
                         "lane)")
    m = sf.shape[0]
    if swords.dtype is not I32 or swords.ndim != 2 \
            or swords.shape[0] != m or swords.shape[1] < 1:
        raise ValueError(f"{NAME}: swords must be int32 ({m}, W), got "
                         f"{swords.dtype} {tuple(swords.shape)}")
    if mail_words.dtype is not I32 or mail_words.ndim != 2 \
            or mail_words.shape != (mail_ids.shape[0], swords.shape[1]):
        raise ValueError(f"{NAME}: mail_words must be int32 "
                         f"({mail_ids.shape[0]}, {swords.shape[1]}), got "
                         f"{mail_words.dtype} {tuple(mail_words.shape)}")
    for t in (swords, mail_words):
        if t.device != mail_ids.device:
            raise ValueError(f"{NAME}: words on {t.device}, the ring on "
                             f"{mail_ids.device}")


def _emit_check(mail_ids, mail_cnt, sf, drop, svalid, wslot, off, dw, cap,
                flags, strig, sender_ids, pmask=None, swords=None,
                mail_words=None) -> None:
    """Raise on what the kernel does not take, in attribute reads (the call
    is short: its host path is most of its time)."""
    card = mail_ids.get_device()
    if dw < 1:
        raise ValueError(f"{NAME}: dw={dw} < 1")
    if sf.dtype is not I32 or sf.ndim != 2:
        raise TypeError(f"{NAME}: sf must be 2-D int32, got {sf.dtype} "
                        f"{tuple(sf.shape)}")
    m, k = sf.shape
    kw = k + (strig is not None)
    if mail_ids.dtype is not I32 or mail_ids.ndim != 1 \
            or mail_ids.shape[0] < dw * cap + m * kw:
        raise ValueError(f"{NAME}: mail_ids must be 1-D int32 of at least "
                         f"dw*cap + m*kw = {dw * cap + m * kw} cells, got "
                         f"{mail_ids.dtype} {tuple(mail_ids.shape)}")
    if mail_cnt.dtype is not I32 or mail_cnt.shape != (1, dw):
        raise ValueError(f"{NAME}: mail_cnt must be int32 (1, {dw}), got "
                         f"{mail_cnt.dtype} {tuple(mail_cnt.shape)}")
    rows = [(drop, "drop", torch.bool, (m, k)),
            (svalid, "svalid", torch.bool, (m,)),
            (wslot, "wslot", I32, (m,)), (off, "off", I32, (m,))]
    if strig is not None:
        rows += [(strig, "strig", torch.bool, (m,)),
                 (sender_ids, "sender_ids", I32, (m,))]
    if pmask is not None:
        rows.append((pmask, "pmask", torch.bool, (m, k)))
    for t, nm, dt, shape in rows:
        if t.dtype is not dt or t.shape != shape:
            raise ValueError(f"{NAME}: {nm} must be {dt} {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
    if flags is not None and (flags.dtype is not torch.uint8
                              or flags.ndim != 1):
        raise TypeError(f"{NAME}: flags must be 1-D uint8, got "
                        f"{flags.dtype} {tuple(flags.shape)}")
    for t in (mail_ids, mail_cnt, sf, drop, svalid, wslot, off, flags,
              strig, sender_ids, pmask, swords, mail_words):
        if t is not None and (t.get_device() != card
                              or not t.is_contiguous()):
            raise ValueError(f"{NAME}: every tensor must be contiguous on "
                             f"{mail_ids.device}, got one on {t.device}")


@functools.cache
def _emit_fn():
    """fused_emit's typed C entry point, held once it is built."""
    return _build.function(NAME, "gossip_fused_emit", _ARGTYPES)


def _launch(mail_ids, mail_cnt, sf, drop, svalid, wslot, off, *, dw, cap,
            b, tb, strig, sender_ids, flags, received_bit, pmask=None,
            swords=None, mail_words=None, group=None):
    """One launch on the (card, stream) workspace of the single-pass
    appends; the outputs (adds, sup, lost, blocked) come from one
    torch.empty, the call's only allocation.  `group` overrides
    emit_group (the card's measurements of the three forms)."""
    _emit_check(mail_ids, mail_cnt, sf, drop, svalid, wslot, off, dw, cap,
                flags, strig, sender_ids, pmask, swords, mail_words)
    m, k = sf.shape
    dev = mail_ids.device
    stream = deliver._stream(dev.index)
    ws, epoch = deliver.workspace(dev, stream,
                                  deliver.workspace_words(m, dw, EMIT_TILE))
    aux, aux_n = deliver.aux_part(dev, stream,
                                  deliver.aux_ints(m, dw, EMIT_TILE), dw)
    out = torch.empty(2 * dw + 2, dtype=I32, device=dev)
    if group is None:
        group = emit_group(k + (strig is not None))
    fn = _emit_fn()
    _build.count_launch(NAME)
    if pmask is not None:
        _build.count_launch(PMASK)
    if swords is not None:
        _build.count_launch(WORDS)
    rc = fn(mail_ids.data_ptr(), mail_cnt.data_ptr(), sf.data_ptr(),
            drop.data_ptr(), svalid.data_ptr(), wslot.data_ptr(),
            off.data_ptr(), None if flags is None else flags.data_ptr(),
            received_bit, None if strig is None else strig.data_ptr(),
            None if strig is None else sender_ids.data_ptr(),
            None if pmask is None else pmask.data_ptr(),
            None if swords is None else swords.data_ptr(),
            None if swords is None else mail_words.data_ptr(),
            0 if tb is None else tb, m, k, dw, cap, b,
            0 if swords is None else swords.shape[1], group,
            out.data_ptr(), ws.data_ptr(), ws.numel(), epoch, aux, aux_n,
            stream)
    if rc:
        _build.check(rc, NAME)
    res = (mail_ids, out[:dw], out[dw:2 * dw], out[2 * dw], out[2 * dw + 1])
    return res if swords is None else res + (mail_words,)


def fused_emit(mail_ids, mail_cnt, sf, drop, svalid, wslot, off, *,
               dw: int, cap: int, b: int, tb=None, strig=None,
               sender_ids=None, pmask=None, flags=None, received_bit=1,
               swords=None, mail_words=None):
    """Emission from the gathered friends rows down, writing `mail_ids` in
    place.  Returns (mail_ids, adds[dw], sup_adds[dw], lost, blocked).
    `pmask` (bool (m, k), the raw partition_blocked matrix) blocks the
    edges it marks, counted in `blocked` (0 without it); `flags` enables
    the duplicate filter; `tb`/`strig`/`sender_ids` the SIR trigger lane.
    Rumor words (`swords` int32 (m, W), `mail_words` int32 (L, W): the
    multi-rumor word ring) write each lane's sender row at the lane's id
    cell, in place, and the return gains mail_words."""
    if (tb is None) != (strig is None) or \
            (strig is not None and sender_ids is None):
        raise ValueError(f"{NAME}: the trigger lane needs tb, strig and "
                         "sender_ids together")
    _words_check(mail_ids, sf, swords, mail_words, strig)
    kw = dict(dw=dw, cap=cap, b=b, tb=tb, strig=strig,
              sender_ids=sender_ids, pmask=pmask, flags=flags,
              received_bit=received_bit, swords=swords,
              mail_words=mail_words)
    dev = mail_ids.device
    if dev.type == "cpu":
        return emit_plain(mail_ids, mail_cnt, sf, drop, svalid, wslot, off,
                          **kw)
    if dev.type == "cuda":
        return _launch(mail_ids, mail_cnt, sf, drop, svalid, wslot, off,
                       **kw)
    raise ValueError(f"{NAME}: no kernel for device {dev}")


# --- fused_deposit_both ------------------------------------------------------

BOTH = "fused_deposit_both"
BOTH_ARGTYPES = ([ctypes.c_void_p] * 6
                 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong,
                    ctypes.c_int, ctypes.c_int, ctypes.c_void_p])


def _both_check(pending, pending_rumors, dst, slots, valid, newbits) -> int:
    """Shapes and types of one fused_deposit_both call; returns k, the
    lanes of one sender."""
    dev = pending.device
    if pending.dtype != I32 or pending.dim() != 2:
        raise ValueError(f"{BOTH}: pending must be int32 (b, n), got "
                         f"{pending.dtype} {tuple(pending.shape)}")
    b, n = pending.shape
    if newbits.dtype != torch.bool or newbits.dim() != 2:
        raise ValueError(f"{BOTH}: newbits must be bool (rows, R), got "
                         f"{newbits.dtype} {tuple(newbits.shape)}")
    rows, r = newbits.shape
    if pending_rumors.dtype != I32 or \
            tuple(pending_rumors.shape) != (b, n, r):
        raise ValueError(f"{BOTH}: pending_rumors must be int32 "
                         f"{(b, n, r)}, got {pending_rumors.dtype} "
                         f"{tuple(pending_rumors.shape)}")
    m = dst.shape[0]
    for t, nm, dt in ((dst, "dst", I32), (slots, "slots", I32),
                      (valid, "valid", torch.bool)):
        if t.dtype != dt or tuple(t.shape) != (m,):
            raise ValueError(f"{BOTH}: {nm} must be {dt} ({m},), got "
                             f"{t.dtype} {tuple(t.shape)}")
    if rows == 0 or m % rows:
        raise ValueError(f"{BOTH}: {m} lanes are not k lanes for each of "
                         f"{rows} senders")
    for t in (pending_rumors, dst, slots, valid, newbits):
        if t.device != dev:
            raise ValueError(f"{BOTH}: tensors on different devices "
                             f"{t.device} and {dev}")
    return m // rows


def deposit_both_plain(pending, pending_rumors, dst, slots, valid, newbits):
    """Plain version: the sequential pair -- the +1 count deposit, then
    the rumor-row deposit of each lane's sender row ``newbits[i // k]``;
    invalid lanes at dst = n.  In place; returns (pending,
    pending_rumors)."""
    k = dst.shape[0] // newbits.shape[0]
    d = torch.where(valid, dst, pending.shape[1])
    deliver.deposit_add_plain(pending, slots, d)
    vals = newbits.to(I32).repeat_interleave(k, dim=0)
    deliver.deposit_rows_plain(pending_rumors, slots, d, vals)
    return pending, pending_rumors


def _both_launch(pending, pending_rumors, dst, slots, valid, newbits, k):
    for t, nm in ((pending, "pending"), (pending_rumors, "pending_rumors")):
        if not t.is_contiguous():
            raise ValueError(f"{BOTH}: {nm} must be contiguous")
    b, n = pending.shape
    fn = _build.function(BOTH, "gossip_fused_deposit_both", BOTH_ARGTYPES)
    stream = deliver._stream(pending.get_device())
    _build.count_launch(BOTH)
    rc = fn(pending.data_ptr(), pending_rumors.data_ptr(), slots.data_ptr(),
            dst.data_ptr(), valid.data_ptr(), newbits.data_ptr(),
            dst.shape[0], b, n, newbits.shape[1], k, stream)
    _build.check(rc, BOTH)
    return pending, pending_rumors


def fused_deposit_both(pending, pending_rumors, dst, slots, valid, newbits):
    """The count and the rumor-row deposit of each kept edge (`valid`) at
    its (slot, dst) cell in one pass, in place: pending int32[b, n],
    pending_rumors int32[b, n, R], dst/slots int32[m] with m = rows * k
    (row-major by sender), valid bool[m], newbits bool[rows, R].  Returns
    (pending, pending_rumors)."""
    k = _both_check(pending, pending_rumors, dst, slots, valid, newbits)
    dev = pending.device
    if dev.type == "cpu":
        return deposit_both_plain(pending, pending_rumors, dst, slots, valid,
                                  newbits)
    if dev.type == "cuda":
        return _both_launch(pending, pending_rumors, dst.contiguous(),
                            slots.contiguous(), valid.contiguous(),
                            newbits.contiguous(), k)
    raise ValueError(f"{BOTH}: no kernel for device {dev}")


# --- fused_drain_sum ---------------------------------------------------------

DRAIN = "fused_drain_sum"
DRAIN_ARGTYPES = ([ctypes.c_void_p] * 4
                  + [ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                     ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong,
                     ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p])
# The drain (csrc/fused_drain_sum.cu) runs its direct kernel while the
# accumulator holds at most DRAIN_DIRECT_MAX bytes.  Past that it cuts the
# rows into even slices of at most DRAIN_BUDGET bytes, each added in shared
# memory (the tile form); where DRAIN_PART_MAX slices would each outgrow
# the DRAIN_TILE_MAX tile, the direct kernel runs again.  Chosen on the card
# (PERF.md; tests/torch_drain_crossover.py: direct is faster up to 12 MiB,
# the tile form from 24 MiB, at 12 and 36 columns).
DRAIN_BUDGET = 96 << 10
DRAIN_DIRECT_MAX = 12 << 20
DRAIN_TILE_MAX = 220 << 10
DRAIN_PART_MAX = 8192  # the kernel's partitions at most
DRAIN_STAGE_MAX = 1024  # past this many, the lanes are scattered twice
DRAIN_COARSE = 64  # the first scatter's groups of partitions


def drain_part_rows(n: int, c: int, budget: int | None = None,
                    direct_max: int | None = None) -> int:
    """Rows a partition of the (n, c) int32 accumulator holds, or 0 for the
    direct kernel: 0 while its n*c*4 bytes are at most `direct_max`
    (DRAIN_DIRECT_MAX); else the rows of ceil(n / R) even slices of at most
    `budget` (DRAIN_BUDGET) bytes each, fewer and larger slices where that
    would take more than DRAIN_PART_MAX, and 0 where a slice would then
    outgrow the DRAIN_TILE_MAX tile."""
    budget = DRAIN_BUDGET if budget is None else budget
    direct_max = DRAIN_DIRECT_MAX if direct_max is None else direct_max
    if n * c * 4 <= direct_max:
        return 0
    rows = max(1, budget // (4 * c))
    parts = min(-(-n // rows), DRAIN_PART_MAX)
    rows = -(-n // parts)
    return rows if rows * c * 4 <= DRAIN_TILE_MAX else 0


def drain_scratch_elems(cap: int, n: int, part_rows: int) -> int:
    """int32 scratch of one partitioned drain, as csrc/fused_drain_sum.cu
    lays it out: a (row, lane) pair per lane of the slot (two pair buffers
    past DRAIN_STAGE_MAX partitions), then P counts, P + 1 offsets and P
    cursors (and, with two passes, G group cursors and G + 1 chunk
    starts).  It grows with cap, never with n's rows (P <=
    DRAIN_PART_MAX); 0 for the direct kernel."""
    if part_rows == 0:
        return 0
    parts = -(-n // part_rows)
    if parts <= DRAIN_STAGE_MAX:
        return 2 * cap + 3 * parts + 1
    group = -(-parts // DRAIN_COARSE)
    return 4 * cap + 3 * parts + 1 + 2 * -(-parts // group) + 1


def _drain_check(acc, mail_ids, mail_mass, mail_cnt, slot: int, cap: int,
                 b: int) -> None:
    dev = acc.device
    if acc.dtype != I32 or acc.dim() != 2:
        raise ValueError(f"{DRAIN}: acc must be int32 (n, C), got "
                         f"{acc.dtype} {tuple(acc.shape)}")
    c = acc.shape[1]
    if mail_ids.dtype != I32 or mail_ids.dim() != 1:
        raise ValueError(f"{DRAIN}: mail_ids must be int32 (L,), got "
                         f"{mail_ids.dtype} {tuple(mail_ids.shape)}")
    if mail_mass.dtype != I32 or tuple(mail_mass.shape) != (
            mail_ids.shape[0], c):
        raise ValueError(f"{DRAIN}: mail_mass must be int32 "
                         f"({mail_ids.shape[0]}, {c}), got {mail_mass.dtype} "
                         f"{tuple(mail_mass.shape)}")
    if mail_cnt.dtype != I32 or mail_cnt.dim() != 2 \
            or not 0 <= slot < mail_cnt.shape[1]:
        raise ValueError(f"{DRAIN}: mail_cnt must be int32 (1, dw) with "
                         f"slot {slot} in range, got {mail_cnt.dtype} "
                         f"{tuple(mail_cnt.shape)}")
    if (slot + 1) * cap > mail_ids.shape[0] or b < 1:
        raise ValueError(f"{DRAIN}: slot {slot} of cap {cap} past the "
                         f"ring's {mail_ids.shape[0]} lanes (b = {b})")
    for t in (mail_ids, mail_mass, mail_cnt):
        if t.device != dev:
            raise ValueError(f"{DRAIN}: tensors on different devices "
                             f"{t.device} and {dev}")


def drain_sum_plain(acc, mail_ids, mail_mass, mail_cnt, slot: int, cap: int,
                    b: int):
    """Plain version: one masked ``index_add_`` of the slot's live lanes'
    mass rows (the live count read to the host); a lane whose row
    ``entry // b`` falls outside [0, n) adds a zero row at ``lane % n``.
    In place; returns `acc`."""
    n = acc.shape[0]
    m = min(int(mail_cnt[0, slot]), cap)
    s0 = slot * cap
    rows = torch.div(mail_ids[s0:s0 + m], b, rounding_mode="floor")
    ok = (rows >= 0) & (rows < n)
    lane = torch.arange(m, dtype=torch.int64, device=acc.device)
    idx = torch.where(ok, rows.to(torch.int64), lane % max(n, 1))
    vals = mail_mass[s0:s0 + m]
    acc.index_add_(0, idx, torch.where(ok[:, None], vals,
                                       torch.zeros_like(vals)))
    return acc


def _drain_launch(acc, mail_ids, mail_mass, mail_cnt, slot, cap, b):
    for t, nm in ((acc, "acc"), (mail_ids, "mail_ids"),
                  (mail_mass, "mail_mass"), (mail_cnt, "mail_cnt")):
        if not t.is_contiguous():
            raise ValueError(f"{DRAIN}: {nm} must be contiguous")
    n, c = acc.shape
    part_rows = drain_part_rows(n, c)
    elems = drain_scratch_elems(cap, n, part_rows)
    scratch = (torch.empty(elems, dtype=I32, device=acc.device)
               if elems else None)
    fn = _build.function(DRAIN, "gossip_fused_drain_sum", DRAIN_ARGTYPES)
    _build.count_launch(DRAIN)
    rc = fn(acc.data_ptr(), mail_ids.data_ptr(), mail_mass.data_ptr(),
            mail_cnt.data_ptr(), slot, cap, b, n, c, part_rows,
            None if scratch is None else scratch.data_ptr(), elems,
            deliver._stream(acc.get_device()))
    _build.check(rc, DRAIN)
    return acc


def fused_drain_sum(acc, mail_ids, mail_mass, mail_cnt, slot: int, *,
                    cap: int, b: int):
    """PushSum's drain of window slot `slot` in one pass, in place:
    ``acc[ids[slot*cap + i] // b] += mass[slot*cap + i]`` for every live
    lane i < mail_cnt[0, slot] whose row lies in [0, n); acc int32[n, C],
    mail_ids int32[L], mail_mass int32[L, C].  On the card the live count
    is read by the kernel, so the call needs no host read.  Returns
    `acc`."""
    _drain_check(acc, mail_ids, mail_mass, mail_cnt, slot, cap, b)
    dev = acc.device
    if dev.type == "cpu":
        return drain_sum_plain(acc, mail_ids, mail_mass, mail_cnt, slot, cap,
                               b)
    if dev.type == "cuda":
        return _drain_launch(acc, mail_ids, mail_mass, mail_cnt, slot, cap, b)
    raise ValueError(f"{DRAIN}: no kernel for device {dev}")


# --- fused_recv_land -----------------------------------------------------------

RECV = "fused_recv_land"
RECV_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
                 + [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int,
                                            ctypes.c_void_p,
                                            ctypes.c_longlong,
                                            ctypes.c_void_p])
# The workspace and epochs: deliver.workspace, shared with fused_ring_append
# (csrc/lookback.cuh).


def recv_decode(recv, *, dw: int, b: int, flags=None,
                received_bit: int = 1):
    """Decode routed wire words (``-1`` = empty slot): returns (entry
    ``d*b + o``, window slot, surviving mask, sup[dw]).  With `flags`, a
    word whose destination row already has `received_bit` does not
    survive and is counted in its slot of ``sup``."""
    live = recv >= 0
    r = torch.clamp_min(recv, 0)
    d = torch.div(r, dw * b, rounding_mode="floor")
    w = torch.remainder(torch.div(r, b, rounding_mode="floor"), dw)
    sup = torch.zeros(dw, dtype=I32, device=recv.device)
    if flags is not None:
        dup = live & ((flags[d.long()] & received_bit) > 0)
        sup.index_add_(0, w.long(), dup.to(I32))
        live = live & ~dup
    return d * b + torch.remainder(r, b), w, live, sup


def recv_land_plain(mail_ids, mail_cnt, dropped, recv, *, dw: int, cap: int,
                    b: int, words=None, mail_words=None, flags=None,
                    received_bit: int = 1):
    """Plain version: ``recv_decode``, then the one-hot ring append (every
    lane that does not land, empty slots included, writes 0 to the trash
    cell and a zero words row).  In place; returns (mail_ids, mail_cnt,
    dropped, sup[, mail_words])."""
    entry, w, live, sup = recv_decode(recv, dw=dw, b=b, flags=flags,
                                      received_bit=received_bit)
    rings, pays = (mail_ids,), (entry,)
    if words is not None:
        rings, pays = rings + (mail_words,), pays + (words,)
    ring_append_plain(rings, mail_cnt, dropped, pays, w, live, dw, cap)
    if words is not None:
        return mail_ids, mail_cnt, dropped, sup, mail_words
    return mail_ids, mail_cnt, dropped, sup


def _recv_check(mail_ids, mail_cnt, dropped, recv, dw, cap, b, words,
                mail_words, flags) -> None:
    """Raise on what neither version takes, in attribute reads (the batch
    call is short: its host path is most of its time)."""
    dev = recv.device
    if dw < 1 or b < 1:
        raise ValueError(f"{RECV}: dw={dw} or b={b} < 1")
    if mail_ids.dtype is not I32 or mail_cnt.dtype is not I32 \
            or dropped.dtype is not I32 or recv.dtype is not I32 \
            or mail_ids.ndim != 1 or recv.ndim != 1 or dropped.ndim != 0:
        raise TypeError(f"{RECV}: mail_ids, recv must be 1-D, dropped 0-D "
                        f"int32, got {mail_ids.dtype} "
                        f"{tuple(mail_ids.shape)}, {recv.dtype} "
                        f"{tuple(recv.shape)}, {dropped.dtype} "
                        f"{tuple(dropped.shape)}")
    if mail_cnt.shape != (1, dw):
        raise ValueError(f"{RECV}: mail_cnt must be (1, {dw}) int32, got "
                         f"{mail_cnt.dtype} {tuple(mail_cnt.shape)}")
    if mail_ids.shape[0] < dw * cap + 1:
        raise ValueError(f"{RECV}: mail_ids of {mail_ids.shape[0]} lanes "
                         f"has no trash cell past dw*cap = {dw * cap}")
    if mail_ids.device != dev or mail_cnt.device != dev \
            or dropped.device != dev:
        raise ValueError(f"{RECV}: the ring, counts and recv lie on "
                         f"{mail_ids.device}, {mail_cnt.device}, "
                         f"{dropped.device} and {dev}")
    if flags is not None and (flags.dtype is not torch.uint8
                              or flags.ndim != 1 or flags.device != dev):
        raise TypeError(f"{RECV}: flags must be 1-D uint8 on {dev}, got "
                        f"{flags.dtype} {tuple(flags.shape)} on "
                        f"{flags.device}")
    if (words is None) != (mail_words is None):
        raise ValueError(f"{RECV}: words and mail_words go together")
    if words is None:
        return
    if words.dtype is not I32 or mail_words.dtype is not I32 \
            or words.ndim != 2 or mail_words.ndim != 2:
        raise TypeError(f"{RECV}: words and mail_words must be 2-D int32, "
                        f"got {words.dtype} {tuple(words.shape)}, "
                        f"{mail_words.dtype} {tuple(mail_words.shape)}")
    if words.device != dev or mail_words.device != dev:
        raise ValueError(f"{RECV}: words on {words.device}, mail_words on "
                         f"{mail_words.device}, not {dev}")
    if (words.shape[0] != recv.shape[0]
            or mail_words.shape[1] != words.shape[1]
            or mail_words.shape[0] < dw * cap + 1):
        raise ValueError(f"{RECV}: words {tuple(words.shape)} and "
                         f"mail_words {tuple(mail_words.shape)} do not fit "
                         f"{recv.shape[0]} lanes and the ring")


@functools.cache
def _recv_fn():
    """fused_recv_land's typed C entry point, held once it is built."""
    return _build.function(RECV, "gossip_fused_recv_land", RECV_ARGTYPES)


def _recv_launch(mail_ids, mail_cnt, dropped, recv, dw, cap, b, words,
                 mail_words, flags, received_bit):
    if not (mail_ids.is_contiguous() and mail_cnt.is_contiguous()
            and (mail_words is None or mail_words.is_contiguous())):
        raise ValueError(f"{RECV}: mail_ids, mail_cnt and mail_words must "
                         f"be contiguous")
    dev = recv.device
    m = recv.shape[0]
    stream = deliver._stream(dev.index)
    ws, epoch = deliver.workspace(dev, stream, deliver.workspace_words(m, dw))
    aux, aux_n = deliver.aux_part(dev, stream, deliver.aux_ints(m, dw), dw)
    sup = torch.empty(dw, dtype=I32, device=dev)
    fn = _recv_fn()
    _build.count_launch(RECV)
    rc = fn(mail_ids.data_ptr(),
            None if words is None else mail_words.data_ptr(),
            recv.data_ptr(), None if words is None else words.data_ptr(),
            None if flags is None else flags.data_ptr(),
            mail_cnt.data_ptr(), m, dw, cap, b,
            1 if words is None else words.shape[1], received_bit,
            dropped.data_ptr(), sup.data_ptr(), ws.data_ptr(), ws.numel(),
            epoch, aux, aux_n, stream)
    if rc:
        _build.check(rc, RECV)
    if words is not None:
        return mail_ids, mail_cnt, dropped, sup, mail_words
    return mail_ids, mail_cnt, dropped, sup


def fused_recv_land(mail_ids, mail_cnt, dropped, recv, *, dw: int, cap: int,
                    b: int, words=None, mail_words=None, flags=None,
                    received_bit: int = 1):
    """Land routed wire words (``-1`` = empty slot) in the local mail ring,
    in place: decode each word into (row d, slot w, tick offset o),
    optionally drop the words whose row already has `received_bit` in
    `flags` (counted per slot in sup), and append ``d*b + o`` at slot w's
    running count while it is below `cap` (a drop otherwise), with the
    lane's `words` row at the same position of `mail_words`.  mail_ids
    int32[L], mail_cnt int32[1, dw], dropped int32[]; words (M, W) and
    mail_words (L, W) int32: PushSum's mass limbs, or the event engine's
    uint32 rumor words as their int32 view.  Only `recv` tells an empty
    slot (``-1``); a words row is any 32 bits a column, and lands only
    with its lane.  Returns (mail_ids, mail_cnt, dropped, sup[dw][,
    mail_words])."""
    _recv_check(mail_ids, mail_cnt, dropped, recv, dw, cap, b, words,
                mail_words, flags)
    dev = recv.device
    if dev.type == "cpu":
        return recv_land_plain(mail_ids, mail_cnt, dropped, recv, dw=dw,
                               cap=cap, b=b, words=words,
                               mail_words=mail_words, flags=flags,
                               received_bit=received_bit)
    if dev.type == "cuda":
        return _recv_launch(mail_ids, mail_cnt, dropped, recv.contiguous(),
                            dw, cap, b,
                            None if words is None else words.contiguous(),
                            mail_words,
                            None if flags is None else flags.contiguous(),
                            received_bit)
    raise ValueError(f"{RECV}: no kernel for device {dev}")
