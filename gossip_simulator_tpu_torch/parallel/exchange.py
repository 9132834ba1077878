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

Not yet ported: ``route_multi_pipelined`` (``-exchange-pipeline double``,
ROADMAP A13) and the spatial-telemetry ``traffic`` counters with their
``ovf_split``/``ovf_join`` carry (A6).
"""

from __future__ import annotations

import math

import torch

from gossip_simulator_tpu_torch.ops.deliver import segment_ranks

I32 = torch.int32
I64 = torch.int64

# Widest mesh the one-hot bucketing rank serves; beyond it the M x S
# workspace outgrows the sort pass.
RANK_MAX_SHARDS = 16
# Wire-cap pad multiplier (pad = max(64, CHERNOFF_PAD * sqrt(mean))).
CHERNOFF_PAD = 8


def inflight_hwm(n_shards: int) -> int:
    """Exchange buffers alive at once (the telemetry column
    exchange_inflight_hwm): 0 without an exchange (S = 1 routes are the
    identity), 1 on the serial route-then-drain schedule."""
    return 0 if n_shards <= 1 else 1


def _bucket_pack(payloads, dest, valid, n_shards: int, cap: int,
                 sort_buckets: bool | None):
    """One source shard's send buffers: a ``(S, cap[, W])`` buffer per
    payload (-1 in empty slots) and the count of valid entries past their
    bucket's capacity."""
    if sort_buckets is None:
        sort_buckets = n_shards > RANK_MAX_SHARDS
    dev = dest.device
    key = torch.where(valid, dest, n_shards).to(I32)
    if sort_buckets:
        key, order = torch.sort(key, stable=True)
        payloads = [p[order] for p in payloads]
        rank = segment_ranks(key)
    else:
        oht = (key[None, :] == torch.arange(n_shards, dtype=I32,
                                            device=dev)[:, None]).to(I32)
        rank = (torch.cumsum(oht, dim=1, dtype=I32) * oht).sum(
            dim=0, dtype=I32) - 1
    live = key < n_shards
    ok = live & (rank < cap)
    flat = torch.where(ok, key.to(I64) * cap + rank, n_shards * cap)
    overflow = (live & (rank >= cap)).sum(dtype=I32)
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
    return bufs, overflow


def route_multi(payloads, dest, valid, n_shards: int, cap: int,
                sort_buckets: bool | None = None):
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

    Returns:
        recvs: per destination shard, a tuple of ``(S*cap[, W])``
            received payloads (-1 = empty slot), slot-aligned.
        overflow: per source shard, int32 0-d count dropped for capacity.
    """
    packs = [_bucket_pack(p, d, v, n_shards, cap, sort_buckets)
             for p, d, v in zip(payloads, dest, valid)]
    recvs = []
    for d in range(n_shards):
        recvs.append(tuple(
            torch.cat([bufs[i][d] for bufs, _ in packs], dim=0)
            for i in range(len(packs[0][0]))))
    return recvs, [ovf for _, ovf in packs]


def route_one(payload, dest, valid, n_shards: int, cap: int,
              sort_buckets: bool | None = None):
    """Exchange one payload per shard (see route_multi): returns (recv per
    destination shard, overflow per source shard)."""
    recvs, ovf = route_multi([(p,) for p in payload], dest, valid,
                             n_shards, cap, sort_buckets=sort_buckets)
    return [r[0] for r in recvs], ovf


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
