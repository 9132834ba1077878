"""The fused delivery kernels: ring writes and mailbox delivery.

* ``fused_unique_set`` -- the event engine's unique-index ring write,
  ``ring[flat] = vals`` where the indices are unique and in bounds by
  construction (live reservations are disjoint, dead lanes divert to
  per-lane trash cells), on the id ring alone or on the id ring and the
  multi-rumor (L, W) word ring at the same cells; plain version
  ``index_put_``.
* ``fused_ring_append`` -- ``mailbox.ring_append``'s one-hot rank chain
  (each valid lane takes the next position of its window slot, in lane
  order, if it is below the slot capacity) into a flat id ring and an
  optional companion ring, flat or wide (``(L, W)``: PushSum's mass rows,
  whole rows at the shared positions); plain version
  ``ring_append_plain``.
* ``fused_chunk_step`` -- one chunk of mailbox delivery (each lane's rank
  is its key's carried count plus the earlier lanes of the chunk with the
  same key, the stable-sort rank); overflow dropped, or in the spill form
  collected as (payload, key) pairs in lane order; plain version
  ``chunk_step_plain``, the sort -> segment ranks -> scatter chain.
* ``fused_deposit_add`` / ``fused_deposit_rows`` -- the ring engine's
  deposits, ``pending[slot, dst] += 1`` and ``pending[slot, dst, :] +=
  vals[i]`` for lanes whose slot and dst lie in range (the Pallas
  kernel's rule; other lanes add nothing), fused_deposit_add optionally
  of the lanes a ``valid`` mask keeps; plain versions
  ``deposit_add_plain`` and ``deposit_rows_plain``, one ``index_add_``
  each, which the ``xla`` gate runs too.  fused_deposit_add has two
  forms, picked from the shape (``deposit_part_bits``): a direct pass of
  global atomics for sparse calls, and a dense one that adds by ring
  partitions in shared memory.

On the card each wrapper launches its CUDA kernel (``csrc/<name>.cu``);
on the CPU it takes the plain version.  A tensor on any other device
raises.  All of them update their state tensors in place.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from gossip_simulator_tpu_torch.ops import _build

# Window slots of the event ring (and the tick-faithful overlay's ring) up
# to which fused_emit, fused_ring_append and fused_recv_land keep their
# per-block slot tables in shared memory (DW_LIMIT of csrc/lookback.cuh);
# a deeper ring takes their global form, whose tables and sums live in
# the workspace's second part (aux_ints).
RING_SLOTS_MAX = 1024

I32 = torch.int32
I64 = torch.int64
NAME = "fused_unique_set"
# The C entry points' parameter types (csrc/<name>.cu, extern "C").
UNIQUE_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_longlong,
                                           ctypes.c_void_p]
UNIQUE_WORDS_ARGTYPES = ([ctypes.c_void_p] * 5
                         + [ctypes.c_longlong, ctypes.c_int,
                            ctypes.c_void_p])
# fused_unique_set's launches over the id and word rings.
UNIQUE_WORDS = NAME + ":words"
RING_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 4
                 + [ctypes.c_void_p] * 2 + [ctypes.c_longlong, ctypes.c_int,
                                            ctypes.c_void_p,
                                            ctypes.c_longlong,
                                            ctypes.c_void_p])
CHUNK_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
                  + [ctypes.c_void_p, ctypes.c_longlong]
                  + [ctypes.c_void_p] * 2 + [ctypes.c_int, ctypes.c_void_p])


def unique_set_plain(ring: torch.Tensor, flat: torch.Tensor,
                     vals: torch.Tensor) -> torch.Tensor:
    """Plain version: one ``index_put_`` (in place; the indices are unique,
    so the result does not depend on the write order)."""
    ring.index_put_((flat.long(),), vals)
    return ring


def _check(ring, flat, vals) -> None:
    """Raise on what neither version takes, in attribute reads of well
    under a microsecond each (the call is short: csrc note)."""
    if ring.dtype is not I32 or flat.dtype is not I32 \
            or vals.dtype is not I32:
        raise TypeError(f"{NAME}: ring, flat and vals must be int32, got "
                        f"{ring.dtype}, {flat.dtype}, {vals.dtype}")
    if ring.ndim != 1 or flat.ndim != 1 or flat.shape != vals.shape:
        raise ValueError(f"{NAME}: need 1-D ring and equal 1-D flat/vals, "
                         f"got {tuple(ring.shape)}, {tuple(flat.shape)}, "
                         f"{tuple(vals.shape)}")
    if flat.device != ring.device or vals.device != ring.device:
        raise ValueError(f"{NAME}: tensors on different devices "
                         f"{ring.device}, {flat.device}, {vals.device}")


@functools.cache
def _unique_fn():
    """fused_unique_set's typed C entry point, held once it is built (the
    call is short enough that its host path is most of its time)."""
    return _build.function(NAME, "gossip_fused_unique_set", UNIQUE_ARGTYPES)


def _launch(ring, flat, vals) -> torch.Tensor:
    if not ring.is_contiguous():
        raise ValueError(f"{NAME}: ring must be contiguous")
    fn = _unique_fn()
    _build.count_launch(NAME)
    rc = fn(ring.data_ptr(), flat.data_ptr(), vals.data_ptr(), flat.shape[0],
            _stream(ring.get_device()))
    if rc:
        _build.check(rc, NAME)
    return ring


def _words_check(wring, flat, wvals) -> None:
    """Raise on a word ring the kernel does not take: int32 (L, W) rows
    beside int32 (m, W) values, on the id ring's device."""
    if wring.dtype is not I32 or wvals.dtype is not I32 \
            or wring.ndim != 2 or wvals.ndim != 2 \
            or wvals.shape != (flat.shape[0], wring.shape[1]) \
            or wring.shape[1] < 1:
        raise ValueError(f"{NAME}: the word ring must be int32 (L, W) and "
                         f"its values int32 ({flat.shape[0]}, W), got "
                         f"{wring.dtype} {tuple(wring.shape)}, "
                         f"{wvals.dtype} {tuple(wvals.shape)}")
    if wring.device != flat.device or wvals.device != flat.device:
        raise ValueError(f"{NAME}: tensors on different devices "
                         f"{wring.device}, {wvals.device}, {flat.device}")


@functools.cache
def _unique_words_fn():
    """The two-ring entry point, held once it is built."""
    return _build.function(NAME, "gossip_fused_unique_set_words",
                           UNIQUE_WORDS_ARGTYPES)


def _launch_words(ring, wring, flat, vals, wvals):
    if not (ring.is_contiguous() and wring.is_contiguous()):
        raise ValueError(f"{NAME}: the rings must be contiguous")
    fn = _unique_words_fn()
    _build.count_launch(NAME)
    _build.count_launch(UNIQUE_WORDS)
    rc = fn(ring.data_ptr(), wring.data_ptr(), flat.data_ptr(),
            vals.data_ptr(), wvals.data_ptr(), flat.shape[0],
            wring.shape[1], _stream(ring.get_device()))
    if rc:
        _build.check(rc, NAME)
    return ring, wring


def fused_unique_set(ring, flat: torch.Tensor, vals):
    """``ring[flat] = vals`` in place; returns `ring`.  The JAX package's
    tuple form, ``(ids, words)`` rings and ``(ivals, wvals)`` values (the
    multi-rumor word ring, int32 (L, W), written a row a lane at the same
    cells), writes both in one launch and returns the tuple of rings."""
    if isinstance(ring, tuple):
        (ids, wring), (ivals, wvals) = ring, vals
        _check(ids, flat, ivals)
        _words_check(wring, flat, wvals)
        if ids.is_cuda:
            return _launch_words(ids, wring, flat.contiguous(),
                                 ivals.contiguous(), wvals.contiguous())
        if ids.is_cpu:
            return (unique_set_plain(ids, flat, ivals),
                    unique_set_plain(wring, flat, wvals))
        raise ValueError(f"{NAME}: no kernel for device {ids.device}")
    _check(ring, flat, vals)
    if ring.is_cuda:
        return _launch(ring, flat.contiguous(), vals.contiguous())
    if ring.is_cpu:
        return unique_set_plain(ring, flat, vals)
    raise ValueError(f"{NAME}: no kernel for device {ring.device}")


def _stream(index: int) -> int:
    """The raw handle of card `index`'s current CUDA stream (building a
    torch.cuda.Stream object for it costs ~5 us a call on the card's
    host)."""
    return torch._C._cuda_getCurrentRawStream(index)


def _need(name, t, nm, dtype, dev, dim=1):
    if t.dtype != dtype:
        raise TypeError(f"{name}: {nm} must be {dtype}, got {t.dtype}")
    if t.dim() != dim:
        raise ValueError(f"{name}: {nm} must be {dim}-D, got shape "
                         f"{tuple(t.shape)}")
    if t.device != dev:
        raise ValueError(f"{name}: {nm} is on {t.device}, not {dev}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: {nm} must be contiguous")


# --- fused_ring_append ---------------------------------------------------------

RING = "fused_ring_append"


def slot_prefix(wslot, weight, valid, dw: int):
    """Per-item exclusive prefix of `weight` over the earlier valid items
    of the same slot (items in order; invalid items get 0): the one-hot
    scan up to RING_SLOTS_MAX slots, a stable sort by slot past it (a
    one-hot of m x dw cells would not fit).  Returns (prefix, per-slot
    sums of the valid items' weights), int32."""
    dev = wslot.device
    w = torch.where(valid, weight, torch.zeros_like(weight)).to(I32)
    if dw <= RING_SLOTS_MAX:
        oh = ((wslot[:, None] == torch.arange(dw, dtype=I32,
                                              device=dev)[None])
              & valid[:, None]).to(I32)
        # The scan runs along each slot's row of the (dw, m) transpose: a
        # scan over the first axis of (m, dw) runs on dw sequential threads
        # on the card (6.4 s at 6e7 lanes).
        oht = (oh * w[:, None]).t().contiguous()
        pre = ((torch.cumsum(oht, dim=1, dtype=I32) - oht)
               * oh.t()).sum(dim=0, dtype=I32)
        return pre, oht.sum(dim=1, dtype=I32)
    key = torch.where(valid, wslot.to(I64), dw)
    order = torch.sort(key, stable=True).indices
    ws = w[order].to(I64)
    incl = torch.cumsum(ws, dim=0)
    ks = key[order]
    tot = torch.zeros(dw + 1, dtype=I64, device=dev)
    tot.index_add_(0, ks, ws)
    starts = torch.cumsum(tot, dim=0) - tot  # slot k's first prefix
    pre = torch.empty_like(w)
    pre[order] = (incl - ws - starts[ks]).to(I32)
    return torch.where(valid, pre, 0), tot[:dw].to(I32)


def ring_append_plain(rings, cnt, dropped, payloads, wslot, valid, dw: int,
                      cap: int):
    """Plain version: the JAX package's one-hot chain (``ops/mailbox.py``
    ring_append).  Per-slot ranks are a scan over the slot's lanes
    (``slot_prefix``); a lane that is invalid or past the slot capacity
    writes 0 to the trash cell ``dw*cap`` of every ring (a zero row of a
    wide ring).  Updates rings, cnt (int32[1, dw]) and dropped (0-d) in
    place."""
    rank, _ = slot_prefix(wslot, torch.ones_like(wslot), valid, dw)
    slot = torch.where(valid, wslot, 0).long()
    pos = cnt[0][slot] + rank
    ok = valid & (pos < cap)
    flat = torch.where(ok, wslot.to(I64) * cap + pos, dw * cap)
    for r, p in zip(rings, payloads):
        # Duplicate indices only at the trash cell, all writing 0.
        keep = ok[:, None] if p.dim() == 2 else ok
        r.index_put_((flat,), torch.where(keep, p, torch.zeros_like(p)))
    cnt[0].index_add_(0, slot, ok.to(I32))
    dropped += (valid & ~ok).sum(dtype=I32)
    return rings, cnt, dropped


# The single-pass appends (fused_ring_append, megakernel.fused_recv_land and
# megakernel.fused_emit; csrc/lookback.cuh): lanes a block, the workspace's
# head words (the counters and 2 * RING_SLOTS_MAX + 2 int32 sums: the
# kernels' sup, adds, lost and blocked), the look-back epochs' range, and
# the global form's grid (past RING_SLOTS_MAX slots: blocks that take
# tiles by ticket, each with its own tables in the second part).
APPEND_TILE = 2048
APPEND_WS_HEAD = RING_SLOTS_MAX + 2
APPEND_EPOCH_MAX = 1 << 30
APPEND_GLOBAL_GRID = 264
APPEND_WARPS = 8  # csrc/lookback.cuh WARPS
# (card index, raw stream) -> [int64 workspace, last epoch]: the three
# kernels' look-back state and counters, kept across calls on one stream
# (calls on one stream run in order; two streams never share one); and
# (card index, raw stream) -> the int32 second part of the global form.
_WS: dict = {}
_AUX: dict = {}


def workspace_words(m: int, dw: int, tile: int = APPEND_TILE) -> int:
    """int64 words of a single-pass append's workspace for m items in tiles
    of `tile` (fused_emit's senders: megakernel.EMIT_TILE): the head and
    one look-back word per (block, slot)."""
    return APPEND_WS_HEAD + max(1, -(-m // tile)) * dw


def aux_ints(m: int, dw: int, tile: int = APPEND_TILE) -> int:
    """int32 cells of the global form's second part (csrc/lookback.cuh
    aux_ints): 2 * dw + 2 sums (rounded up to 4 cells), then a table set
    of (2 * WARPS + 2) * dw cells for each block of the bounded grid; 0
    for the shared form."""
    if dw <= RING_SLOTS_MAX:
        return 0
    nb = max(1, -(-m // tile))
    grid = min(nb, APPEND_GLOBAL_GRID)
    return (2 * dw + 2 + 3) // 4 * 4 + grid * (2 * APPEND_WARPS + 2) * dw


def aux_part(dev, stream: int, ints: int, dw: int = 0):
    """(pointer, cells) of the second part of (card, stream), grown to
    `ints`, its first 2 * dw + 2 cells (the call's sums) zeroed on the
    stream: a call of another depth or grid may have left its tables
    there; (None, 0) when the call needs none."""
    if ints == 0:
        return None, 0
    aux = _AUX.get((dev.index, stream))
    if aux is None or aux.numel() < ints:
        aux = _AUX[dev.index, stream] = torch.empty(ints, dtype=I32,
                                                    device=dev)
    aux[:2 * dw + 2].zero_()
    return aux.data_ptr(), aux.numel()


def workspace(dev, stream: int, words: int):
    """The workspace of (card, stream), grown (zeroed) to `words`, and the
    call's epoch: the last one plus 1, back to 1 with the workspace zeroed
    once it reaches APPEND_EPOCH_MAX (a look-back word of an old epoch must
    never read as this call's)."""
    ws = _WS.get((dev.index, stream))
    if ws is None or ws[0].numel() < words:
        ws = _WS[dev.index, stream] = [
            torch.zeros(words, dtype=I64, device=dev), 0]
    ws[1] += 1
    if ws[1] >= APPEND_EPOCH_MAX:
        ws[0].zero_()
        ws[1] = 1
    return ws[0], ws[1]


def _ring_check(rings, cnt, dropped, payloads, wslot, valid, dw, cap) -> int:
    """Raise on what the kernel does not take, in attribute reads of a few
    tenths of a microsecond each (the overlay's call is short: its host
    path is most of its time); returns the companion ring's columns (1
    when flat or absent)."""
    card = wslot.get_device()
    m = wslot.shape[0]
    if dw < 1:
        raise ValueError(f"{RING}: dw={dw} < 1")
    if len(rings) not in (1, 2) or len(payloads) != len(rings):
        raise ValueError(f"{RING}: the kernel takes one or two rings and "
                         f"their payloads, got {len(rings)} and "
                         f"{len(payloads)}")
    w1 = 1
    for i, (r, p) in enumerate(zip(rings, payloads)):
        if r.dtype is not I32 or p.dtype is not I32 or r.ndim != p.ndim:
            raise TypeError(f"{RING}: ring{i} and payload{i} must be int32 "
                            f"of one rank, got {r.dtype} {tuple(r.shape)}, "
                            f"{p.dtype} {tuple(p.shape)}")
        if r.get_device() != card or p.get_device() != card:
            raise ValueError(f"{RING}: ring{i} on {r.device}, payload{i} on "
                             f"{p.device}, not {wslot.device}")
        if not r.is_contiguous():
            raise ValueError(f"{RING}: ring{i} must be contiguous")
        rows, lanes = r.shape[0], p.shape[0]
        if r.ndim == 2:
            w1 = r.shape[1]
            if p.shape[1] != w1 or w1 < 1:
                raise ValueError(f"{RING}: ring1 of {w1} columns and its "
                                 f"payload of {p.shape[1]} differ")
        if rows < dw * cap + 1 or lanes != m:
            raise ValueError(f"{RING}: ring{i} of {rows} rows / payload of "
                             f"{lanes} lanes do not fit dw*cap + 1 = "
                             f"{dw * cap + 1} / m = {m}")
    if wslot.dtype is not I32 or wslot.ndim != 1 \
            or valid.dtype is not torch.bool or valid.ndim != 1 \
            or valid.shape[0] != m or valid.get_device() != card:
        raise TypeError(f"{RING}: wslot must be int32 (m,) and valid bool "
                        f"(m,) on one device, got {wslot.dtype} "
                        f"{tuple(wslot.shape)}, {valid.dtype} "
                        f"{tuple(valid.shape)} on {valid.device}")
    if cnt.dtype is not I32 or cnt.shape != (1, dw) \
            or cnt.get_device() != card or not cnt.is_contiguous():
        raise ValueError(f"{RING}: cnt must be contiguous int32 (1, {dw}) "
                         f"on {wslot.device}, got {cnt.dtype} "
                         f"{tuple(cnt.shape)} on {cnt.device}")
    if dropped.dtype is not I32 or dropped.ndim != 0 \
            or dropped.get_device() != card:
        raise ValueError(f"{RING}: dropped must be a 0-d int32 on "
                         f"{wslot.device}, got {dropped.dtype} "
                         f"{tuple(dropped.shape)} on {dropped.device}")
    return w1


@functools.cache
def _ring_fn():
    """fused_ring_append's typed C entry point, held once it is built."""
    return _build.function(RING, "gossip_fused_ring_append", RING_ARGTYPES)


def _ring_launch(rings, cnt, dropped, payloads, wslot, valid, dw, cap):
    w1 = _ring_check(rings, cnt, dropped, payloads, wslot, valid, dw, cap)
    m = wslot.shape[0]
    stream = _stream(wslot.device.index)
    ws, epoch = workspace(wslot.device, stream, workspace_words(m, dw))
    aux, aux_n = aux_part(wslot.device, stream, aux_ints(m, dw), dw)
    two = len(rings) == 2
    fn = _ring_fn()
    _build.count_launch(RING)
    rc = fn(rings[0].data_ptr(), rings[1].data_ptr() if two else None,
            payloads[0].data_ptr(), payloads[1].data_ptr() if two else None,
            wslot.data_ptr(), valid.data_ptr(), cnt.data_ptr(), m, dw, cap,
            w1, dropped.data_ptr(), ws.data_ptr(), ws.numel(), epoch, aux,
            aux_n, stream)
    if rc:
        _build.check(rc, RING)
    return rings, cnt, dropped


def fused_ring_append(rings, cnt, dropped, payloads, wslot, valid, dw: int,
                      cap: int):
    """Append one (payloads...) entry per True in `valid` into its `wslot`
    window slot of the aligned rings, in place; returns (rings, cnt,
    dropped).  The first ring is a flat id ring; a second may be flat or
    wide, ``(L, W)`` with (m, W) payload rows written whole at the shared
    positions (PushSum's mass ring).  `wslot` must lie in [0, dw)."""
    rings, payloads = tuple(rings), tuple(payloads)
    if rings[0].dim() != 1 or any(r.dim() not in (1, 2) for r in rings):
        raise ValueError(f"{RING}: the id ring must be flat and a "
                         "companion ring flat or (L, W)")
    dev = wslot.device
    if dev.type == "cpu":
        return ring_append_plain(rings, cnt, dropped, payloads, wslot, valid,
                                 dw, cap)
    if dev.type == "cuda":
        return _ring_launch(rings, cnt, dropped,
                            tuple(p.contiguous() for p in payloads),
                            wslot.contiguous(), valid.contiguous(), dw, cap)
    raise ValueError(f"{RING}: no kernel for device {dev}")


# --- fused_chunk_step ----------------------------------------------------------

CHUNK = "fused_chunk_step"
# The spill form's own launch count, beside the kernel's count of both forms.
CHUNK_SPILL = "fused_chunk_step:spill"


def segment_ranks(sorted_keys: torch.Tensor) -> torch.Tensor:
    """Rank of each element within its run of equal values (input
    sorted): one cummax of the run starts."""
    m = sorted_keys.shape[0]
    idx = torch.arange(m, dtype=I32, device=sorted_keys.device)
    if m == 0:
        return idx
    newseg = torch.ones(m, dtype=torch.bool, device=sorted_keys.device)
    newseg[1:] = sorted_keys[1:] != sorted_keys[:-1]
    start = torch.cummax(torch.where(newseg, idx, 0), dim=0).values
    return idx - start


def _spill_append(pairs, scnt, dropped, ovf, pay, key):
    """Append the lanes flagged in `ovf`, in the given order, as (pay, key)
    pairs at scnt, scnt + 1, ...; lanes past the pair capacity scap are
    dropped (counted), and every lane that does not fit writes -1 to the
    trash column scap.  In place."""
    scap = pairs.shape[1] - 1
    pos = scnt.to(I64) + torch.cumsum(ovf, dim=0) - 1
    fit = ovf & (pos < scap)
    tgt = torch.where(fit, pos, scap)
    pairs[0].index_put_((tgt,), torch.where(fit, pay, -1))
    pairs[1].index_put_((tgt,), torch.where(fit, key, -1))
    scnt += fit.sum(dtype=I32)
    dropped += (ovf & ~fit).sum(dtype=I32)


def chunk_step_plain(mbox, count, dropped, key, s, nk: int, cap: int,
                     rank_major: bool, spill=None, sorted_spill=False):
    """Plain version: the JAX package's chain (``ops/mailbox.py``
    _compact_chunk_step).  Stable sort by key; rank = run rank + carried
    count[key]; lanes with key < nk and rank < cap write their payload at
    key*cap + rank (rank*nk + key when `rank_major`), every other lane -1
    at the trash cell nk*cap; count[key] += 1 for every lane, the sentinel
    nk included.  Overflow (key < nk, rank >= cap) adds to `dropped`, or,
    with `spill` = (pairs int32[2, scap + 1], scnt int32[]), is collected
    as (payload, key) pairs: in lane order (the kernel's order and the
    Pallas kernel's), or in sorted order with `sorted_spill` (the JAX
    package's xla chain).  The two orders hold the same pairs while they
    fit; once the pairs fill, they keep different messages.  In place;
    returns (mbox, count, dropped[, (pairs, scnt)])."""
    sd, order = torch.sort(key, stable=True)
    ss = s[order]
    sd64 = sd.to(I64)
    rank = segment_ranks(sd).to(I64) + count[torch.clamp_max(sd64, nk)]
    live = sd64 < nk
    ok = live & (rank < cap)
    cell = rank * nk + sd64 if rank_major else sd64 * cap + rank
    mbox.index_put_((torch.where(ok, cell, nk * cap),),
                    torch.where(ok, ss, torch.full_like(ss, -1)))
    count.index_add_(0, torch.where(live, sd64, nk),
                     torch.ones_like(sd, dtype=count.dtype))
    ovf = live & (rank >= cap)
    if spill is None:
        dropped += ovf.sum(dtype=I32)
        return mbox, count, dropped
    pairs, scnt = spill
    if sorted_spill:
        _spill_append(pairs, scnt, dropped, ovf, ss, sd)
    else:
        lane_ovf = torch.empty_like(ovf)
        lane_ovf[order] = ovf
        _spill_append(pairs, scnt, dropped, lane_ovf, s, key)
    return mbox, count, dropped, (pairs, scnt)


# The kernel's radix tiles, digit bins and passes (TILE, RADIX_MAX and
# PASSES_MAX of csrc/fused_chunk_step.cu).
CHUNK_TILE = 4096
CHUNK_RADIX_MAX = 1024
CHUNK_PASSES_MAX = 4


def chunk_scratch_elems(m: int, spill: bool) -> int:
    """int32 scratch of one fused_chunk_step call of m lanes, as
    csrc/fused_chunk_step.cu lays it out: the sorted keys and payloads
    (and, in the spill form, lanes), double-buffered; each pass's per-tile
    digit histograms; the digit totals; the live count; in the spill form,
    the lanes' overflow flags and their scan's tile sums.  It grows with
    m, never with nk."""
    tiles = -(-m // CHUNK_TILE)
    n = ((6 if spill else 4) * m + CHUNK_PASSES_MAX * CHUNK_RADIX_MAX * tiles
         + CHUNK_RADIX_MAX + 1)
    if spill:
        n += m + -(-m // 4096)
    return n


def _chunk_launch(mbox, count, dropped, key, s, nk, cap, rank_major, spill):
    dev = key.device
    m = key.shape[0]
    for t, nm in ((mbox, "mbox"), (count, "count"), (key, "key"), (s, "s")):
        _need(CHUNK, t, nm, I32, dev)
    _need(CHUNK, dropped, "dropped", I32, dev, dim=0)
    if mbox.numel() < nk * cap + 1 or count.numel() < nk + 1 \
            or s.shape[0] != m:
        raise ValueError(f"{CHUNK}: need mbox >= nk*cap + 1 = "
                         f"{nk * cap + 1} cells, count >= nk + 1, and one "
                         f"payload per key")
    if nk * cap + 1 >= 2**31:
        raise ValueError(f"{CHUNK}: nk*cap = {nk * cap} past int32 flat "
                         "addressing")
    pairs = scnt = None
    scap = 0
    if spill is not None:
        pairs, scnt = spill
        _need(CHUNK, pairs, "pairs", I32, dev, dim=2)
        _need(CHUNK, scnt, "scnt", I32, dev, dim=0)
        scap = pairs.shape[1] - 1
        if pairs.shape[0] != 2 or scap < 0:
            raise ValueError(f"{CHUNK}: pairs must be (2, scap + 1), got "
                             f"{tuple(pairs.shape)}")
    fn = _build.function(CHUNK, "gossip_fused_chunk_step", CHUNK_ARGTYPES)
    scratch = torch.empty(max(chunk_scratch_elems(m, spill is not None), 1),
                          dtype=I32, device=dev)
    _build.count_launch(CHUNK)
    if spill is not None:
        _build.count_launch(CHUNK_SPILL)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    rc = fn(mbox.data_ptr(), count.data_ptr(), dropped.data_ptr(),
            key.data_ptr(), s.data_ptr(), m, nk, cap, int(bool(rank_major)),
            scratch.data_ptr(), scratch.numel(), ptr(pairs), ptr(scnt), scap,
            _stream(dev.index))
    _build.check(rc, CHUNK)
    if spill is None:
        return mbox, count, dropped
    return mbox, count, dropped, (pairs, scnt)


def fused_chunk_step(mbox, count, dropped, key, s, nk: int, cap: int,
                     rank_major: bool, spill=None):
    """One delivery chunk into the flat mailbox, in place; returns (mbox,
    count, dropped[, (pairs, scnt)]).  `key` must lie in [0, nk], nk
    marking invalid lanes.  Overflow is dropped, or with `spill` = (pairs
    int32[2, scap + 1], scnt int32[]) collected as (payload, key) pairs in
    lane order, the Pallas kernel's order (``chunk_step_plain``)."""
    dev = key.device
    if dev.type == "cpu":
        return chunk_step_plain(mbox, count, dropped, key, s, nk, cap,
                                rank_major, spill=spill)
    if dev.type == "cuda":
        return _chunk_launch(mbox, count, dropped, key.contiguous(),
                             s.contiguous(), nk, cap, rank_major, spill)
    raise ValueError(f"{CHUNK}: no kernel for device {dev}")


# --- fused_deposit_add / fused_deposit_rows ----------------------------------

DEPOSIT = "fused_deposit_add"
# The dense form's own launch count, beside the kernel's count of both.
DEPOSIT_DENSE = "fused_deposit_add:dense"
DEPOSIT_ROWS = "fused_deposit_rows"
DEPOSIT_ARGTYPES = ([ctypes.c_void_p] * 4
                    + [ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong,
                       ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_longlong, ctypes.c_void_p])
ROWS_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_int,
                                         ctypes.c_longlong, ctypes.c_int,
                                         ctypes.c_void_p]
# fused_deposit_add's dense form (csrc/fused_deposit_add.cu): the ring's
# b*n cells in partitions of 2**DEPOSIT_PART_BITS cells (a 128 KB
# shared-memory tile; a lane's offset in its partition is 16 bits), at
# most DEPOSIT_PART_MAX of them (b*n up to 2.7e8), each with a bucket of
# offsets sized from m.  The wrapper takes it when a call has at least
# DEPOSIT_DENSE_MIN lanes a ring cell, the direct form below that.  Both
# measured on the card (tests/torch_deposit_crossover.py: the dense form
# faster from 0.75 lanes a cell in both lane layouts, the direct one at
# 0.5 in one of them; tests/torch_kernel_variants.py; PERF.md): 2**15-cell
# partitions listed faster than 2**14 (half the bucket claims).
DEPOSIT_PART_BITS = 15
DEPOSIT_PART_MAX = 8192
DEPOSIT_DENSE_MIN = 0.75
# (card index, raw stream) -> [int32 cursors + overflow word, uint16
# buckets]: the dense form's workspace, kept across calls on one stream.
_DEP_WS: dict = {}


def deposit_part_bits(m: int, cells: int) -> int:
    """log2 of the cells a partition of the dense form holds, or 0 for the
    direct form: 0 below DEPOSIT_DENSE_MIN lanes a ring cell or where the
    partitions would number more than DEPOSIT_PART_MAX, else
    DEPOSIT_PART_BITS.  Shapes alone: no host read."""
    bits = DEPOSIT_PART_BITS
    if cells <= 0 or m < DEPOSIT_DENSE_MIN * cells \
            or (cells + (1 << bits) - 1) >> bits > DEPOSIT_PART_MAX:
        return 0
    return bits


def deposit_bucket_cap(m: int, parts: int) -> int:
    """Offsets a partition's bucket holds: ceil(m / parts) rounded up to 16
    (a bucket starts 32-byte aligned), so the buckets take about 2 bytes a
    lane.  A partition that receives more lanes adds the rest with global
    atomics (counted in the workspace's overflow word): with uniform
    destinations all in one slot of a two-slot ring, as the rounds deposit
    sends them, that begins where more than about half the lanes are
    valid."""
    return -(-max(1, -(-m // parts)) // 16) * 16


def deposit_overflow(dev) -> int:
    """The lanes the dense form has sent past a full bucket to global adds
    on card `dev`'s current stream, summed over its calls there (a host
    read, for reports and tests; 0 before the first dense call)."""
    ws = _DEP_WS.get((dev.index, _stream(dev.index)))
    return 0 if ws is None else int(ws[0][DEPOSIT_PART_MAX])


def deposit_workspace(dev, stream: int, bucket_elems: int):
    """The dense form's (cursors + overflow word, buckets) on (card,
    stream): the cursors zeroed once (each call's partition blocks zero
    theirs), the buckets grown to `bucket_elems` offsets."""
    ws = _DEP_WS.get((dev.index, stream))
    if ws is None:
        ws = _DEP_WS[dev.index, stream] = [
            torch.zeros(DEPOSIT_PART_MAX + 1, dtype=I32, device=dev), None]
    if ws[1] is None or ws[1].numel() < bucket_elems:
        ws[1] = None
        ws[1] = torch.empty(bucket_elems, dtype=torch.int16, device=dev)
    return ws[0], ws[1]


def deposit_index(pending: torch.Tensor, slots: torch.Tensor,
                  dst: torch.Tensor):
    """(flat int64 cell of each lane over pending's (b, n) leading axes,
    in-range mask).  A lane whose slot is outside [0, b) or whose dst is
    outside [0, n) must add nothing (the Pallas kernel's rule; the JAX xla
    scatter drops the same lanes, except that it wraps a negative index,
    which no caller produces).  It indexes cell ``lane % (b*n)``, where
    its zero lands: spread over distinct cells, the zero adds of a
    mostly-invalid deposit do not queue on one address."""
    b, n = pending.shape[0], pending.shape[1]
    ok = (slots >= 0) & (slots < b) & (dst >= 0) & (dst < n)
    lane = torch.arange(slots.shape[0], dtype=I64, device=slots.device)
    flat = torch.where(ok, slots.to(I64) * n + dst.to(I64), lane % (b * n))
    return flat, ok


def deposit_add_plain(pending: torch.Tensor, slots: torch.Tensor,
                      dst: torch.Tensor, valid=None) -> torch.Tensor:
    """Plain version: the lanes `valid` drops (where given) moved to dst =
    n, the flat in-range index, then one ``index_add_`` of the mask on
    ``pending.view(-1)``.  In place."""
    if valid is not None:
        dst = torch.where(valid, dst, pending.shape[1])
    flat, ok = deposit_index(pending, slots, dst)
    pending.view(-1).index_add_(0, flat, ok.to(pending.dtype))
    return pending


def deposit_rows_plain(pending: torch.Tensor, slots: torch.Tensor,
                       dst: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """Plain version: the same index on the ``(b*n, W)`` view, one
    ``index_add_`` of the in-range lanes' rows.  In place."""
    b, n, w = pending.shape
    flat, ok = deposit_index(pending, slots, dst)
    pending.view(b * n, w).index_add_(
        0, flat, torch.where(ok[:, None], vals, torch.zeros_like(vals)))
    return pending


def _deposit_check(name, pending, slots, dst, vals=None) -> None:
    dev = pending.device
    want = 2 if vals is None else 3
    if pending.dtype != I32 or pending.dim() != want:
        raise ValueError(f"{name}: pending must be int32 {want}-D, got "
                         f"{pending.dtype} {tuple(pending.shape)}")
    m = slots.shape[0] if slots.dim() == 1 else -1
    for t, nm in ((slots, "slots"), (dst, "dst")):
        if t.dtype != I32 or t.dim() != 1 or t.shape[0] != m:
            raise ValueError(f"{name}: {nm} must be int32 (m,), got "
                             f"{t.dtype} {tuple(t.shape)}")
    if vals is not None and (vals.dtype != I32
                             or tuple(vals.shape) != (m, pending.shape[2])):
        raise ValueError(f"{name}: vals must be int32 ({m}, "
                         f"{pending.shape[2]}), got {vals.dtype} "
                         f"{tuple(vals.shape)}")
    for t in (slots, dst) + (() if vals is None else (vals,)):
        if t.device != dev:
            raise ValueError(f"{name}: tensors on different devices "
                             f"{t.device} and {dev}")


def _rows_launch(pending, slots, dst, vals):
    if not pending.is_contiguous():
        raise ValueError(f"{DEPOSIT_ROWS}: pending must be contiguous")
    b, n, w = pending.shape
    fn = _build.function(DEPOSIT_ROWS, "gossip_fused_deposit_rows",
                         ROWS_ARGTYPES)
    _build.count_launch(DEPOSIT_ROWS)
    rc = fn(pending.data_ptr(), slots.data_ptr(), dst.data_ptr(),
            vals.data_ptr(), slots.shape[0], b, n, w,
            _stream(pending.device.index))
    _build.check(rc, DEPOSIT_ROWS)
    return pending


def _add_check(pending, slots, dst, valid) -> None:
    """Raise on what the kernel does not take, in attribute reads (the
    chunk-shaped call is short: its host path is most of its time)."""
    card = pending.get_device()
    if pending.dtype is not I32 or pending.ndim != 2 \
            or not pending.is_contiguous():
        raise ValueError(f"{DEPOSIT}: pending must be contiguous int32 "
                         f"2-D, got {pending.dtype} {tuple(pending.shape)}")
    m = slots.shape[0] if slots.ndim == 1 else -1
    if slots.dtype is not I32 or dst.dtype is not I32 or m < 0 \
            or dst.ndim != 1 or dst.shape[0] != m:
        raise ValueError(f"{DEPOSIT}: slots and dst must be int32 (m,), got "
                         f"{slots.dtype} {tuple(slots.shape)}, {dst.dtype} "
                         f"{tuple(dst.shape)}")
    if valid is not None and (valid.dtype is not torch.bool
                              or valid.ndim != 1 or valid.shape[0] != m
                              or valid.get_device() != card):
        raise ValueError(f"{DEPOSIT}: valid must be bool ({m},) on "
                         f"{pending.device}, got {valid.dtype} "
                         f"{tuple(valid.shape)} on {valid.device}")
    if slots.get_device() != card or dst.get_device() != card:
        raise ValueError(f"{DEPOSIT}: tensors on different devices "
                         f"{pending.device}, {slots.device}, {dst.device}")


@functools.cache
def _add_fn():
    """fused_deposit_add's typed C entry point, held once it is built."""
    return _build.function(DEPOSIT, "gossip_fused_deposit_add",
                           DEPOSIT_ARGTYPES)


def _add_launch(pending, slots, dst, valid):
    _add_check(pending, slots, dst, valid)
    if not slots.is_contiguous():
        slots = slots.contiguous()
    if not dst.is_contiguous():
        dst = dst.contiguous()
    if valid is not None and not valid.is_contiguous():
        valid = valid.contiguous()
    b, n = pending.shape
    m = slots.shape[0]
    stream = _stream(pending.device.index)
    bits = deposit_part_bits(m, b * n)
    ws = bucket = None
    bcap = 0
    if bits:
        parts = (b * n + (1 << bits) - 1) >> bits
        bcap = deposit_bucket_cap(m, parts)
        ws, bucket = deposit_workspace(pending.device, stream, parts * bcap)
        _build.count_launch(DEPOSIT_DENSE)
    fn = _add_fn()
    _build.count_launch(DEPOSIT)
    rc = fn(pending.data_ptr(), slots.data_ptr(), dst.data_ptr(),
            None if valid is None else valid.data_ptr(), m, b, n, bits,
            None if ws is None else ws.data_ptr(),
            None if bucket is None else bucket.data_ptr(), bcap, stream)
    if rc:
        _build.check(rc, DEPOSIT)
    return pending


def fused_deposit_add(pending: torch.Tensor, slots: torch.Tensor,
                      dst: torch.Tensor, valid=None) -> torch.Tensor:
    """``pending[slots, dst] += 1`` for the in-range lanes that `valid`
    keeps (every lane when it is None), in place; returns `pending`
    (int32[b, n]).  Without `valid`, callers put invalid lanes at dst =
    n, as the TPU kernel takes them."""
    dev = pending.device
    if dev.type == "cuda":
        return _add_launch(pending, slots, dst, valid)
    _deposit_check(DEPOSIT, pending, slots, dst)
    if valid is not None and (valid.dtype != torch.bool
                              or tuple(valid.shape) != tuple(slots.shape)):
        raise ValueError(f"{DEPOSIT}: valid must be bool "
                         f"{tuple(slots.shape)}, got {valid.dtype} "
                         f"{tuple(valid.shape)}")
    if dev.type == "cpu":
        return deposit_add_plain(pending, slots, dst, valid)
    raise ValueError(f"{DEPOSIT}: no kernel for device {dev}")


def fused_deposit_rows(pending: torch.Tensor, slots: torch.Tensor,
                       dst: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """``pending[slots, dst, :] += vals`` for the in-range lanes, in place
    (int32, two's-complement wrap); returns `pending` (int32[b, n, W];
    vals int32[m, W])."""
    _deposit_check(DEPOSIT_ROWS, pending, slots, dst, vals)
    dev = pending.device
    if dev.type == "cpu":
        return deposit_rows_plain(pending, slots, dst, vals)
    if dev.type == "cuda":
        return _rows_launch(pending, slots.contiguous(), dst.contiguous(),
                            vals.contiguous())
    raise ValueError(f"{DEPOSIT_ROWS}: no kernel for device {dev}")
