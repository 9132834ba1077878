"""Engine-agnostic state helpers: the 64-bit message total and the
in-flight test; the ring engine's state, ``SimState``; and the rounds
overlay's state, ``OverlayState``.

The JAX package carries ``total_message`` as a uint32 ``[hi, lo]`` pair
(jax runs without 64-bit integers).  torch has int64, so the port holds
the total as one int64 scalar and converts to and from the pair only at
the JAX package's interface (``utils/interop.py``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def msg64_value(c) -> int:
    """Python int from a ``[hi, lo]`` uint32 pair (or a scalar)."""
    a = np.asarray(c)
    if a.ndim == 0:
        return int(a)
    a = a.astype(np.uint64)
    return int((a[0] << np.uint64(32)) | a[1])


def msg64_pair(value: int) -> np.ndarray:
    """The JAX package's uint32 ``[hi, lo]`` pair for a 64-bit total."""
    v = int(value)
    return np.asarray([(v >> 32) & 0xFFFFFFFF, v & 0xFFFFFFFF], np.uint32)


# A shard's exchange counter leaf (``exch_counts``), int32 (1, S + 2) when
# the spatial panels record on S > 1 shards: [:S] the routed lanes it
# delivered to each destination shard, [EXCH_RCVD] the routed lanes it
# received, [EXCH_OVERFLOW] its route overflow.  Otherwise the JAX
# package's (1, 1) placeholder.  parallel/exchange.py counts into it,
# utils/telemetry.py reads it into the panels.
EXCH_RCVD = -2
EXCH_OVERFLOW = -1


def exch_counts_width(cfg, n_shards: int) -> int:
    """Width of the ``exch_counts`` leaf: S + 2 under the spatial panels
    at S > 1, else 1."""
    spatial = cfg.telemetry_spatial_enabled and n_shards > 1
    return n_shards + 2 if spatial else 1


def init_exch_counts(cfg, n_shards: int, device) -> torch.Tensor:
    """A shard's zeroed ``exch_counts`` leaf (the layout above)."""
    return torch.zeros((1, exch_counts_width(cfg, n_shards)),
                       dtype=torch.int32, device=device)


def in_flight(st) -> torch.Tensor:
    """0-d bool tensor: whether any message is still undelivered.
    Engine-agnostic, duck-typed on the mail ring: the event engine's
    ``EventState`` counts its ring slots and the deferred
    duplicate-suppression credits (pending windows must still drain so
    total_message is credited at the same tick); the ring engine's
    ``SimState`` its arrival counts and SIR re-broadcast schedule."""
    if hasattr(st, "mail_cnt"):
        return torch.any(st.mail_cnt > 0) | torch.any(st.sup_cnt > 0)
    return torch.any(st.pending > 0) | torch.any(st.rebroadcast)


@dataclasses.dataclass
class SimState:
    """The ring engine's state (``models/epidemic.py``).  Leaf names,
    shapes and dtypes follow the JAX package's ``SimState``, except that
    ``tick`` is a host int, the totals are int64 0-d tensors (the JAX
    package's uint32 ``[hi, lo]`` total is one int64 here) and the uint32
    rumor words live in int64 lanes masked to 32 bits.  Placeholders keep
    the JAX package's 1-element shapes.  ``utils/interop.py`` converts to
    and from its numpy form."""

    received: torch.Tensor  # bool[n]  ever infected
    crashed: torch.Tensor  # bool[n]
    removed: torch.Tensor  # bool[n]  SIR: stopped forwarding
    friends: torch.Tensor  # int32[n, k]  -1 padded
    friend_cnt: torch.Tensor  # int32[n]
    pending: torch.Tensor  # int32[d, n]  arrival counts, ring over ticks
    rebroadcast: torch.Tensor  # bool[d | 1, n]  SIR re-broadcast schedule
    tick: int
    total_message: torch.Tensor  # int64[]
    total_received: torch.Tensor  # int64[]
    total_crashed: torch.Tensor  # int64[]
    exchange_overflow: torch.Tensor  # int64[]  (always 0 on one device)
    # Scenario leaves: the crash clock (int32[n] under Config.faults_enabled,
    # a 1-element placeholder otherwise) and the fault counters.
    down_since: torch.Tensor  # int32[n | 1]  crash tick, -1 = live/unknown
    scen_crashed: torch.Tensor  # int64[]
    scen_recovered: torch.Tensor  # int64[]
    part_dropped: torch.Tensor  # int64[]
    heal_repaired: torch.Tensor  # int64[]
    # Multi-rumor leaves (Config.multi_rumor), placeholders otherwise.
    pending_rumors: torch.Tensor  # int32[d, n, R | 1, 1, 1]
    rumor_words: torch.Tensor  # int64[n, W | 1, 1]  uint32 bit words
    rumor_recv: torch.Tensor  # int32[W*32 | 1]  per-rumor infected count
    rumor_done: torch.Tensor  # int32[W*32 | 1]  tick rumor hit target (-1)
    exch_counts: torch.Tensor  # int32[1, S + 2 | 1]  a shard's route counts


@dataclasses.dataclass
class OverlayState:
    """The rounds overlay's phase-1 state.  Leaf names, shapes and dtypes
    follow the JAX package's ``OverlayState``: the makeups and breakups
    emitted in a round sit in slot-major buffers (slot, sender lane) and
    are delivered the next round; ``round`` is a host int in the port, the
    counters int32 0-d tensors on the run's device.  ``utils/interop.py``
    converts to and from the JAX package's numpy form."""

    friends: torch.Tensor  # int32[n, k]  -1 padded
    friend_cnt: torch.Tensor  # int32[n]
    mk_dst: torch.Tensor  # int32[cap, n]  makeup emissions (src = lane)
    bk_dst: torch.Tensor  # int32[cap, n]  breakup emissions
    boot_dst: torch.Tensor  # int32[n]  bootstrap makeups, after the replies
    # Mailbox-overflow spill: (src, dst) pairs a full mailbox could not
    # take, re-delivered first next round; -1 padded, trash column last.
    mk_spill: torch.Tensor  # int32[2, sc + 1]
    bk_spill: torch.Tensor  # int32[2, sc + 1]
    round: int
    makeups: torch.Tensor  # int32[]  cumulative processed (MakeUps)
    breakups: torch.Tensor  # int32[]
    win_makeups: torch.Tensor  # int32[]  this round's counts
    win_breakups: torch.Tensor  # int32[]
    mailbox_dropped: torch.Tensor  # int32[]  overflow past the spill
