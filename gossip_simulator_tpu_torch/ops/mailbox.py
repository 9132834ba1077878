"""Mailbox delivery and ring appends for the two overlay engines, and
PushSum's sum-combine deposit.

The port's subset of the JAX package's ``ops/mailbox.py``:

* the tick-faithful overlay's node-major band -- the packed-ring append
  and ``deliver_pair``'s stacked two-type prefix-drain form, no spill;
* the rounds overlay -- ``deliver`` (node-major, chunked over the live
  lanes), ``deliver_columns`` (per emission row, rank-major, with the
  overflow spill), ``deliver_spill_pairs`` and the split round's
  ``make_hosted_column_delivery`` (per-row chunk widths from a ladder,
  dense rows, write-time row totals, the occupancy count);
* PushSum (``models/pushsum.py``) -- ``ring_append`` with its wide mass
  ring beside the id ring, and ``deposit_sum``, the scatter-add of mass
  rows;
* ``segment_ranks``, the run ranks of sorted keys, for the exchange's
  sorted bucketing past RANK_MAX_SHARDS (defined in ``ops/deliver.py``
  beside the delivery chunk's plain chain, which ranks with it).

A round's messages are flat arrays; delivery is a per-destination rank
(the stable-sort rank: arrival order within a destination), a capacity
check, and a write into a flat ``[nk, cap]`` mailbox whose cell ``nk*cap``
is the trash cell; overflow is dropped (counted) or, with a spill
accumulator, kept as (sender, destination) pairs that the caller
re-delivers first next round.  Every gate point (``kernel`` "pallas" =
the fused kernel, on the CPU its plain version; "xla" = the unfused
chain) sits in ``ring_append`` and ``_compact_chunk_step``, as in the JAX
package.  The mailbox, the counts, the spill and the rings are updated in
place.

The JAX package compacts each delivery chunk with ``first_true_indices``
over the lanes still to deliver; the port takes all live indices of an
emission row with one ``nonzero`` (one host read) and cuts them into the
same ascending ranges.  Its last range stops at the live total where the
JAX package pads it with sentinel lanes, which only write -1 to the trash
cell and add to the sentinel's count, ``count[nk]``: no mailbox cell,
spill pair or drop count changes.
"""

from __future__ import annotations

import torch

from gossip_simulator_tpu_torch.config import flat_addressing_fits
from gossip_simulator_tpu_torch.ops import deliver as kernels
from gossip_simulator_tpu_torch.ops import overlay_kernel
from gossip_simulator_tpu_torch.ops.deliver import segment_ranks  # noqa: F401

I32 = torch.int32


def ring_append(rings, cnt, dropped, payloads, wslot, valid, dw: int,
                cap: int, kernel: str = "xla"):
    """Append one entry per True in `valid` into its `wslot` window slot of
    the aligned rings (every ring gets the same flat positions); overflow
    is counted in `dropped` and its writes go to the dw*cap trash cell.
    "pallas" routes to ``deliver.fused_ring_append``, "xla" runs the
    one-hot chain (``deliver.ring_append_plain``)."""
    if kernel == "pallas":
        return kernels.fused_ring_append(rings, cnt, dropped, payloads,
                                         wslot, valid, dw, cap)
    return kernels.ring_append_plain(rings, cnt, dropped, payloads, wslot,
                                     valid, dw, cap)


def deposit_sum(acc, dst, rows, valid, kernel: str = "xla"):
    """PushSum's sum-combine delivery: ``acc[dst[i]] += rows[i]`` for every
    True in `valid`, in place (acc int32[n, C] fixed-point limbs, rows
    int32[m, C]); integer adds commute, so the order of arrival never moves
    the result.  "pallas" routes to ``deliver.fused_deposit_rows`` with a
    one-deep slot axis, "xla" runs its plain version, the masked
    ``index_add_``.  Returns `acc`."""
    n, c = acc.shape
    d = torch.where(valid, dst, n).to(I32)
    slots = torch.zeros_like(d)
    fn = (kernels.fused_deposit_rows if kernel == "pallas"
          else kernels.deposit_rows_plain)
    fn(acc.view(1, n, c), slots, d, rows)
    return acc


def _compact_chunk_step(mbox, count, dropped, key, s, nk: int, cap: int,
                        rank_major: bool, spill=None, kernel: str = "xla"):
    """ONE delivery chunk: stable sort by key, rank continuation via the
    total-arrivals counter, capacity-checked flat write (trash cell
    nk*cap), count/drop updates.  `key` must already be nk-sentineled for
    invalid lanes; `s` is the payload.  With `spill` = (pairs int32[2,
    scap + 1], scnt int32[]) overflow is collected as (s, key) pairs
    instead of dropped, past scap counted dropped.  "pallas" routes to
    ``deliver.fused_chunk_step`` (pairs in lane order), "xla" runs the
    chain (``deliver.chunk_step_plain``, pairs in sorted order, as the
    JAX package's xla chain keeps them)."""
    if kernel == "pallas":
        return kernels.fused_chunk_step(mbox, count, dropped, key, s, nk,
                                        cap, rank_major, spill=spill)
    return kernels.chunk_step_plain(mbox, count, dropped, key, s, nk, cap,
                                    rank_major, spill=spill,
                                    sorted_spill=True)


def new_carry(nk: int, cap: int, dev):
    """An empty delivery carry: (flat mailbox int32[nk*cap + 1] of -1,
    total-arrivals count int32[nk + 1], dropped int32[])."""
    return (torch.full((nk * cap + 1,), -1, dtype=I32, device=dev),
            torch.zeros(nk + 1, dtype=I32, device=dev),
            torch.zeros((), dtype=I32, device=dev))


def new_spill(scap: int, dev):
    """An empty spill accumulator: (pairs int32[2, scap + 1] of -1, scnt
    int32[])."""
    return (torch.full((2, scap + 1), -1, dtype=I32, device=dev),
            torch.zeros((), dtype=I32, device=dev))


def _live_ranges(valid, chunk: int):
    """The live lanes of `valid` as ascending int32 index ranges of
    `chunk` lanes (one host read for the count)."""
    idx = torch.nonzero(valid).flatten().to(I32)
    return [idx[lo:lo + chunk] for lo in range(0, idx.numel(), chunk)]


def _deliver_compact_keyed(src, key_full, valid, nk: int, cap: int,
                           chunk: int, src_cols=None, src_mod=None,
                           carry=None, rank_major=False, spill=None,
                           kernel="xla"):
    """Chunked delivery of a prepacked key in [0, nk) (nk the invalid
    sentinel) over the live lanes of `valid`, in ascending ranges of
    `chunk` lanes, ranks continuing across chunks (and across calls
    through `carry`, a previous call's (mbox, count, dropped)).  Sender
    ids are `src` gathered, or derived as idx // src_cols or idx %
    src_mod.  Returns the carry: the flat (nk*cap + 1) mailbox with its
    trash cell, the total-arrivals count (nk + 1) and the drop count."""
    if carry is None:
        carry = new_carry(nk, cap, key_full.device)
    for idx in _live_ranges(valid, chunk):
        if src_cols is not None:
            s = idx // src_cols
        elif src_mod is not None:
            s = idx % src_mod
        else:
            s = src[idx.long()]
        _compact_chunk_step(*carry, key_full[idx.long()], s, nk, cap,
                            rank_major, spill=spill, kernel=kernel)
    return carry


def deliver(src, dst, valid, n: int, cap: int, compact_chunk=None,
            src_mod=None, kernel: str = "xla"):
    """Deliver messages into per-destination mailboxes: the JAX package's
    ``deliver`` in its flat-addressing forms (chunked over the live lanes,
    or one pass, which equals one chunk over every lane).  Sender ids come
    from `src`, or derive from the lane as idx % src_mod (a flattened
    slot-major emission matrix).  Returns (mbox int32[n, cap], count
    int32[n] (clamped to cap), dropped)."""
    m = dst.shape[0]
    if not flat_addressing_fits(n, cap):
        raise ValueError(
            f"deliver: (n+1)*cap = {(n + 1) * cap} is past int32 flat "
            "addressing; the dense 2-D fallback is not yet ported "
            "(ROADMAP A18)")
    chunk = compact_chunk if compact_chunk and compact_chunk < m else m
    key_full = torch.where(valid, dst, n).to(I32)
    mbox, count, dropped = _deliver_compact_keyed(
        src, key_full, valid, n, cap, max(chunk, 1), src_mod=src_mod,
        kernel=kernel)
    return (mbox[:n * cap].view(n, cap), torch.clamp_max(count[:n], cap),
            dropped)


def deliver_spill_pairs(carry, pairs, n: int, cap: int, rank_major: bool,
                        spill=None, kernel="xla"):
    """Deliver an explicit (src, dst) pair list -- last round's overflow
    spill, int32[2, S + 1] with -1-padded dst -- as ONE chunk through
    `carry`, before the round's emission rows (delayed messages arrive
    first).  Re-overflow goes into `spill`, or is counted dropped."""
    key = torch.where(pairs[1] >= 0, pairs[1], n).to(I32)
    _compact_chunk_step(*carry, key, pairs[0], n, cap, rank_major,
                        spill=spill, kernel=kernel)
    return carry


def _max_load(count, n: int, cap: int) -> int:
    """The deepest mailbox, min(max arrivals, cap), read to the host."""
    return int(torch.clamp_max(count[:n].max(), cap)) if n else 0


def deliver_columns(mats, n: int, cap: int, chunk: int, spill_in=None,
                    spill=None, kernel: str = "xla"):
    """Per-ROW chunked delivery of (slots, n) emission matrices whose
    sender id is the lane index, into the RANK-MAJOR flat mailbox
    (mailbox slot r is the contiguous range [r*n, (r+1)*n)): the rows of
    `mats` chain in order through one carry, so arrival order is slot-major
    (slot, then node).  `spill_in` pairs are delivered first; `spill`
    collects this delivery's overflow.  Returns (mbox int32[n*cap + 1],
    max load (host int), dropped)."""
    carry = new_carry(n, cap, mats[0].device)
    if spill_in is not None:
        deliver_spill_pairs(carry, spill_in, n, cap, True, spill=spill,
                            kernel=kernel)
    for mat in mats:
        for dcol in mat:
            _deliver_compact_keyed(None, dcol, dcol >= 0, n, cap, chunk,
                                   src_cols=1, carry=carry, rank_major=True,
                                   spill=spill, kernel=kernel)
    mbox, count, dropped = carry
    return mbox, _max_load(count, n, cap), dropped


def make_hosted_column_delivery(n: int, cap: int, widths, spill_cap: int = 0,
                                kernel: str = "xla", occupancy: str = "xla"):
    """``deliver_columns`` as the split round runs it: each emission row
    picks the narrowest width of the ascending ladder `widths` that covers
    its live total in one chunk (the fattest for larger totals); a row
    whose every lane is live is cut into plain ascending ranges with no
    compaction; a row whose total is 0 is skipped.  The totals come from
    the caller (`row_totals`, counted when the rows were written), else
    from ``overlay_kernel.fused_hosted_chunk`` over each matrix
    (`occupancy` "pallas", one host read per matrix), else from one
    popcount per row.  Chunk width never changes a mailbox; under the xla
    chain it sets the order of the spill pairs, which is why the ladder is
    the JAX package's.  With `spill_cap` > 0 the spill pairs of last round
    are re-delivered first and this delivery's overflow is collected into
    a fresh (2, spill_cap + 1) accumulator.  Returns run(mats,
    spill_in=None, row_totals=None) -> (mbox int32[n*cap + 1] rank-major,
    max load (host int), dropped[, pairs])."""
    widths = tuple(sorted({int(w) for w in widths}))
    spilling = spill_cap > 0

    def pick_width(total: int) -> int:
        for w in widths:
            if total <= w:
                return w
        return widths[-1]

    def run(mats, spill_in=None, row_totals=None):
        dev = mats[0].device
        carry = new_carry(n, cap, dev)
        spill = new_spill(spill_cap, dev) if spilling else None
        if spilling and spill_in is not None:
            deliver_spill_pairs(carry, spill_in, n, cap, True, spill=spill,
                                kernel=kernel)
        if row_totals is None and occupancy == "pallas":
            row_totals = torch.cat([overlay_kernel.fused_hosted_chunk(mat)
                                    for mat in mats]).tolist()
        ri = 0
        for mat in mats:
            for dcol in mat:
                total = (int(row_totals[ri]) if row_totals is not None
                         else int((dcol >= 0).sum()))
                ri += 1
                if total == 0:
                    continue
                cw = pick_width(total)
                if total == n:  # every lane live: plain ranges
                    ranges = [torch.arange(lo, min(lo + cw, n), dtype=I32,
                                           device=dev)
                              for lo in range(0, n, cw)]
                else:
                    ranges = _live_ranges(dcol >= 0, cw)
                for idx in ranges:  # sender = lane index
                    _compact_chunk_step(*carry, dcol[idx.long()], idx, n, cap,
                                        True, spill=spill, kernel=kernel)
        mbox, count, dropped = carry
        out = (mbox, _max_load(count, n, cap), dropped)
        return out + (spill[0],) if spilling else out

    return run


def _deliver_prefix_keyed(src, key_full, live: int, nk: int, cap: int,
                          chunk: int, kernel: str = "xla"):
    """Chunked node-major delivery of a prepacked-key stream whose valid
    entries are the first `live` lanes: ascending index ranges of `chunk`
    lanes, ranks continuing across chunks through the carried count.  The JAX
    package pads the last range to `chunk` lanes with the nk sentinel,
    whose lanes only write -1 to the trash cell and add to count[nk]; the
    ranges here stop at `live` instead, which leaves every mailbox cell
    the same.  Returns (mbox, count, dropped)."""
    carry = new_carry(nk, cap, key_full.device)
    for lo in range(0, live, chunk):
        hi = min(lo + chunk, live)
        _compact_chunk_step(*carry, key_full[lo:hi], src[lo:hi], nk, cap,
                            False, kernel=kernel)
    return carry


def deliver_pair(src, dst, typ, n: int, cap: int, compact_chunk: int,
                 prefix_len: int, kernel: str = "xla"):
    """Deliver a two-TYPE message stream into two mailbox sets in one
    pass: key typ*n + dst, a stacked [2n, cap] mailbox split afterwards.
    The node-major, prefix-drain, no-spill form of the JAX package's
    ``deliver_pair``: the valid entries are the first `prefix_len` lanes
    (the ticks drain's sorted layout), so no compaction runs.  Every form
    the JAX package picks here by width (one chunk, the sorted single
    pass, chunked ranges) gives the same mailboxes.  Returns (mbox_t0
    int32[n, cap], mbox_t1 int32[n, cap], dropped)."""
    n2 = 2 * n
    if not flat_addressing_fits(n2 + 1, cap):
        raise ValueError(
            f"deliver_pair: (2n+2)*cap = {(n2 + 2) * cap} is past int32 flat "
            "addressing; its two-pass fallback is not yet ported "
            "(ROADMAP A18)")
    key_full = (typ * n + dst).to(I32)
    mbox, _, dropped = _deliver_prefix_keyed(
        src.to(I32), key_full, prefix_len, n2, cap, compact_chunk,
        kernel=kernel)
    mbox = mbox[:n2 * cap]
    return (mbox[:n * cap].view(n, cap), mbox[n * cap:].view(n, cap),
            dropped)
