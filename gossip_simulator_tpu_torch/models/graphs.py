"""Static overlay generators.

All generators return ``(friends int32[n, k] -1-padded, friend_cnt
int32[n])`` with global node ids, generated row by row from a per-row
key, so the table is the JAX package's ``models/graphs.py`` output bit
for bit (``erdos`` through ``utils/rng.poisson``, which computes XLA's
own float32 ``log`` and ``lgamma``).  kout always goes through ``kout_pallas``
(``ops/graph.py``), which draws the fold_in stream; under ``-pallas``
erdos goes through ``erdos_pallas`` where the JAX package's conditions
for its kernel hold, and falls back to the fold_in generator with its
warning elsewhere.
"""

from __future__ import annotations

import warnings

import torch

from gossip_simulator_tpu_torch.config import Config, er_cap
from gossip_simulator_tpu_torch.ops import graph as _graph
from gossip_simulator_tpu_torch.utils import rng as _rng


def kout(cfg: Config, key: torch.Tensor, row0: int = 0,
         rows: int | None = None, static_row0: bool = True):
    """k-out random digraph: each node picks `fanout` uniform peers
    (duplicates allowed, like the reference's bootstrap), drawn from
    fold_in(key, global row id).  ``kout_pallas`` computes that stream at
    any fanout (its kernel on the card, the eager chain on the CPU), so
    ``-pallas`` changes nothing here but the JAX package's warning past
    its kernel's fanout limit (not given for a shard's slice,
    ``static_row0=False``)."""
    n, k = cfg.n, cfg.fanout
    rows = n if rows is None else rows
    if cfg.pallas and static_row0 and k > _graph.LANES:
        warnings.warn(
            "-pallas requested but the Pallas kout generator is unavailable "
            "here (needs a real TPU backend, fanout <= 128, block-aligned "
            "static row offset -- the sharded backend's traced row0 does not "
            "qualify); using the fold_in generator instead", stacklevel=2)
    return (_graph.kout_pallas(n, k, row0, rows, key),
            torch.full((rows,), k, dtype=torch.int32, device=key.device))


def erdos(cfg: Config, key: torch.Tensor, row0: int = 0,
          rows: int | None = None, static_row0: bool = True):
    """Sparse directed Erdős–Rényi approximation: out-degree ~
    Poisson(n * p), clipped to er_cap columns, peers uniform with the self
    patch, -1 at and past the degree.  ``static_row0=False`` marks a
    shard's slice (the JAX package's traced row0 inside its shard_map),
    which takes the fold_in generator under ``-pallas`` too, silently."""
    n = cfg.n
    rows = n if rows is None else rows
    lam = cfg.er_p_resolved * n
    cap = er_cap(lam)
    if cfg.pallas and static_row0:
        if 0.0 < lam <= _graph.LAM_MAX and cap <= _graph.LANES:
            return _graph.erdos_pallas(n, float(lam), row0, rows, key)
        warnings.warn(
            "-pallas requested but the Pallas erdos generator is "
            "unavailable here (needs a real TPU backend, lam <= 60, "
            "cap <= 128 lanes, block-aligned static row offset); using the "
            "fold_in generator instead", stacklevel=2)
    gids = row0 + torch.arange(rows, dtype=torch.int32, device=key.device)
    kd, kp = _rng.split(_rng.row_keys(key, gids))
    deg = torch.clamp_max(_rng.poisson(kd, lam), cap)
    picks = _graph.self_patch(_rng.randint(kp, (cap,), 0, n), gids, n)
    slot = torch.arange(cap, dtype=torch.int32, device=key.device)[None, :]
    return torch.where(slot < deg[:, None], picks, -1), deg


def ring(cfg: Config, key: torch.Tensor, row0: int = 0,
         rows: int | None = None, static_row0: bool = True):
    """Ring lattice: node i -> (i+1..i+fanout) mod n."""
    n, k = cfg.n, cfg.fanout
    rows = n if rows is None else rows
    dev = key.device
    ids = (row0 + torch.arange(rows, dtype=torch.int64, device=dev))[:, None]
    friends = (ids + torch.arange(1, k + 1, dtype=torch.int64,
                                  device=dev)[None, :]) % n
    return (friends.to(torch.int32),
            torch.full((rows,), k, dtype=torch.int32, device=dev))


GENERATORS = {"kout": kout, "erdos": erdos, "ring": ring}


def generate(cfg: Config, key: torch.Tensor, row0: int = 0,
             rows: int | None = None, static_row0: bool = True):
    if cfg.graph not in GENERATORS:
        raise ValueError(f"-graph {cfg.graph} has no static generator here")
    if cfg.protocol == "pushpull":
        # Push-pull draws fresh uniform peers every round and never reads
        # the friends table: a one-column placeholder, as in the JAX
        # package (its (n, fanout) table alone would be GBs at scale).
        rows = cfg.n if rows is None else rows
        return (torch.full((rows, 1), -1, dtype=torch.int32,
                           device=key.device),
                torch.zeros((rows,), dtype=torch.int32, device=key.device))
    return GENERATORS[cfg.graph](cfg, key, row0, rows, static_row0)


def graph_key(cfg: Config, device=None) -> torch.Tensor:
    return _rng.tick_key(_rng.base_key(cfg.seed, device), 0, _rng.OP_GRAPH)
