"""Cross-shard message routing (the JAX package's ``parallel/exchange.py``).

A shard's outgoing messages (global destination + payload) are bucketed
by destination shard into a fixed-capacity ``[S, cap]`` buffer, and the
buffers are exchanged all to all: on one device that is a transpose of
the per-shard list (``parallel/mesh.py``), so destination d receives
source 0's bucket for d, then source 1's, and so on.  Capacity overflow
is counted, never silently lost.

Bucketing: for S <= RANK_MAX_SHARDS an entry's rank within its bucket is
the count of earlier valid entries with the same destination, a masked
cumsum over the S one-hot columns, scanned along each column's row of the
contiguous ``(S, m)`` transpose (a scan over the first axis of ``(m, S)``
runs on S threads on the card).  Wider meshes take the stable sort and
segment ranks; both land the identical buffers.

A payload is int32 ``(M,)``, or ``(M, W)``: W int32 columns bucketed as
one row, which is W slot-aligned payloads of the JAX package's route
(PushSum's mass limbs, the event engine's rumor words as the int32 view
of their uint32 bits).  ``-1`` fills every column of an empty slot, and
only the first payload (the wire word, never negative when valid) tells
an empty slot: a word column may hold any 32 bits, -1 included.

Spatial panels (``-telemetry-spatial on``): a route given the shards'
``traffic`` leaves (each shard's ``exch_counts``, laid out in
``models/state.py``) adds, per source shard, its delivered sends by
destination shard (overflowed lanes left out, so a column of the traffic
matrix sums to what that shard received), the valid slots of the first
payload it received, and its bucket overflow.  The delivered bits are
the same either way.  Counting in place is the port's form of the JAX
package's ``ovf_split``/``ovf_join`` pair, which threads the leaf
through its loop carries beside the overflow scalar.

``-exchange-pipeline double`` keeps this serial route: one process holds
every shard, so there is no collective for a staged drain to overlap
(the JAX package's ``route_multi_pipelined`` delivers the same bits);
only ``inflight_hwm`` reads 2.
"""

from __future__ import annotations

import math

import torch

from gossip_simulator_tpu_torch.models.state import EXCH_OVERFLOW, EXCH_RCVD
from gossip_simulator_tpu_torch.ops.mailbox import segment_ranks

I32 = torch.int32
I64 = torch.int64

# Widest mesh the one-hot bucketing rank serves; beyond it the M x S
# workspace outgrows the sort pass.
RANK_MAX_SHARDS = 16
# Wire-cap pad multiplier (pad = max(64, CHERNOFF_PAD * sqrt(mean))).
CHERNOFF_PAD = 8


def inflight_hwm(cfg, n_shards: int) -> int:
    """Exchange buffers alive at once (the telemetry column
    exchange_inflight_hwm): 0 without an exchange (S = 1 routes are the
    identity), 1 on the serial route-then-drain schedule, 2 under
    -exchange-pipeline double (the JAX package's double-buffered count;
    the route here stays serial, see the module docstring)."""
    if n_shards <= 1:
        return 0
    return 2 if cfg.exchange_pipeline_resolved == "double" else 1


def _bucket_pack(payloads, dest, valid, n_shards: int, cap: int,
                 sort_buckets: bool | None, count_sent: bool = False):
    """One source shard's send buffers: a ``(S, cap[, W])`` buffer per
    payload (-1 in empty slots), the count of valid entries past their
    bucket's capacity, and with `count_sent` the int32 (S,) count of
    entries delivered to each destination shard (else None)."""
    if sort_buckets is None:
        sort_buckets = n_shards > RANK_MAX_SHARDS
    dev = dest.device
    key = torch.where(valid, dest, n_shards).to(I32)
    shards = torch.arange(n_shards, dtype=I32, device=dev)
    if sort_buckets:
        key, order = torch.sort(key, stable=True)
        payloads = [p[order] for p in payloads]
        rank = segment_ranks(key)
    else:
        oht = (key[None, :] == shards[:, None]).to(I32)
        rank = (torch.cumsum(oht, dim=1, dtype=I32) * oht).sum(
            dim=0, dtype=I32) - 1
    live = key < n_shards
    ok = live & (rank < cap)
    flat = torch.where(ok, key.to(I64) * cap + rank, n_shards * cap)
    overflow = (live & (rank >= cap)).sum(dtype=I32)
    sent = None
    if count_sent:
        # A bucket delivers its first `cap` entries: min(its count, cap),
        # from the one-hot columns or the sorted keys' bounds (no
        # atomics on S counters).
        if sort_buckets:
            bounds = torch.searchsorted(key, torch.arange(
                n_shards + 1, dtype=I32, device=dev))
            counts = (bounds[1:] - bounds[:-1]).to(I32)
        else:
            counts = oht.sum(dim=1, dtype=I32)
        sent = torch.clamp_max(counts, cap)
    bufs = []
    for p in payloads:
        buf = torch.full((n_shards * cap + 1,) + tuple(p.shape[1:]), -1,
                         dtype=I32, device=dev)
        keep = ok.view((-1,) + (1,) * (p.dim() - 1))
        # Unique positions for ok lanes; the rest all write -1 to the
        # trash cell.
        buf.index_put_((flat,), torch.where(keep, p.to(I32),
                                            torch.full_like(p, -1, dtype=I32)))
        bufs.append(buf[:n_shards * cap].view(
            (n_shards, cap) + tuple(p.shape[1:])))
    return bufs, overflow, sent


def _count_traffic(traffic, packs, recvs) -> None:
    """Add one route's counts to the shards' (1, S + 2) leaves, in place:
    [:S] delivered sends by destination, [EXCH_RCVD] valid slots received
    (the first payload's, one message a slot), [EXCH_OVERFLOW] bucket
    overflow."""
    for t, (_, ovf, sent), got in zip(traffic, packs, recvs):
        t[0, :EXCH_RCVD] += sent
        t[0, EXCH_RCVD] += (got[0] >= 0).sum(dtype=I32)
        t[0, EXCH_OVERFLOW] += ovf


def route_multi(payloads, dest, valid, n_shards: int, cap: int,
                sort_buckets: bool | None = None, traffic=None):
    """Exchange several payloads that share one (dest, valid) keying, for
    every shard at once.

    Args:
        payloads: per source shard, a tuple of int32 ``(M,)`` or
            ``(M, W)`` payloads (>= 0 in valid lanes of the first).
        dest: per source shard, int32 ``(M,)`` destination shard.
        valid: per source shard, bool ``(M,)``.
        n_shards: mesh size S.
        cap: per-destination-shard buffer slots.
        sort_buckets: None (auto: sort only past RANK_MAX_SHARDS), or
            force the sort (True) or the one-hot cumsum (False); both
            give the identical buffers.
        traffic: None, or per source shard its int32 (1, S + 2) counter
            leaf, which the route adds to in place (module docstring).

    Returns:
        recvs: per destination shard, a tuple of ``(S*cap[, W])``
            received payloads (-1 = empty slot), slot-aligned.
        overflow: per source shard, int32 0-d count dropped for capacity.
    """
    packs = [_bucket_pack(p, d, v, n_shards, cap, sort_buckets,
                          count_sent=traffic is not None)
             for p, d, v in zip(payloads, dest, valid)]
    recvs = []
    for d in range(n_shards):
        recvs.append(tuple(
            torch.cat([bufs[i][d] for bufs, _, _ in packs], dim=0)
            for i in range(len(packs[0][0]))))
    if traffic is not None:
        _count_traffic(traffic, packs, recvs)
    return recvs, [ovf for _, ovf, _ in packs]


def route_one(payload, dest, valid, n_shards: int, cap: int,
              sort_buckets: bool | None = None, traffic=None):
    """route_multi of one int32 ``(M,)`` payload per source shard: returns
    (per destination shard its ``(S*cap,)`` received payload, per source
    shard its overflow)."""
    recvs, overflow = route_multi([(p,) for p in payload], dest, valid,
                                  n_shards, cap, sort_buckets=sort_buckets,
                                  traffic=traffic)
    return [r[0] for r in recvs], overflow


def pack_dst_slot(dst_local, dslot, d: int):
    """(local destination, ring slot) as one wire word, dst_local * d +
    dslot (valid while n_local * d < 2^31)."""
    return dst_local * d + dslot


def unpack_dst_slot(packed, d: int):
    return packed // d, packed % d


def epidemic_cap(n_local: int, k: int, n_shards: int, safety: int = 4) -> int:
    """Per-pair buffer for a wave of at most n_local*k edges over S
    destination shards; `safety` covers skew; clamped to the zero-loss
    bound n_local*k."""
    mean = max(1, (n_local * k) // max(n_shards, 1))
    return int(min(n_local * k, max(64, safety * mean)))


def chernoff_cap(m_edges: int, n_shards: int) -> int:
    """Per-pair wire cap for a batch of `m_edges` uniform-destination
    messages: mean m/S plus a Chernoff pad max(64, 8*sqrt(mean)), clamped
    to m_edges.  Sound only for destination-uniform graphs (kout, erdos);
    callers gate on the graph."""
    if n_shards <= 1:
        return m_edges
    mean = -(-m_edges // n_shards)
    return int(min(m_edges,
                   mean + max(64, math.ceil(CHERNOFF_PAD * math.sqrt(mean)))))
