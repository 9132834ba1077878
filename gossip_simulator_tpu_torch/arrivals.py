"""Open-loop arrival processes for streaming injection.

The port's own copy of the JAX package's ``arrivals.py`` (numpy only).
Stream traffic injects rumor r at a deterministic tick: on the fixed
schedule ``r * 1000 // stream_rate``, computed inside the event engine's
window step (``models/event.injection_batch``); the other processes
(Poisson, bursts, a diurnal load curve) as a precomputed host TABLE that
the window step searches.

* Every schedule is a pure function of (arrivals, stream_rate, rumors,
  seed): no wall clock, no device state.
* ``table_or_none`` returns None for fixed arrivals, and the window step
  then keeps its arithmetic schedule.
* Tables are sorted nondecreasing int32 ticks.

The JAX package's serve admission override of the schedule
(``inject_ticks``) is not here: serving is ROADMAP A14.
"""

from __future__ import annotations

import functools
import math

import numpy as np

# Rumors released together by the "burst" process.
BURST_GROUP = 8
# Diurnal modulation depth: rate swings rate*(1 +/- DIURNAL_DEPTH).
DIURNAL_DEPTH = 0.8


@functools.lru_cache(maxsize=64)
def _table(kind: str, rate: int, rumors: int, seed: int) -> tuple:
    if kind == "fixed":
        return tuple(r * 1000 // rate for r in range(rumors))
    if kind == "poisson":
        # Exponential inter-arrivals, mean 1000/rate ms; the generator is
        # seeded from (seed, rate, rumors) alone so the schedule is a pure
        # config function.
        rng = np.random.default_rng(np.uint64(seed * 1_000_003 + rate))
        gaps = rng.exponential(scale=1000.0 / rate, size=rumors)
        ticks = np.floor(np.cumsum(gaps) - gaps[0]).astype(np.int64)
        return tuple(int(t) for t in ticks)
    if kind == "burst":
        # Groups of BURST_GROUP rumors released together at the tick the
        # fixed schedule would have finished the group: mean rate is
        # preserved, instantaneous rate spikes at each boundary.
        group_span = max(1, BURST_GROUP * 1000 // rate)
        return tuple((r // BURST_GROUP) * group_span for r in range(rumors))
    if kind == "diurnal":
        # Sinusoidal load curve lambda(t) = rate*(1 + depth*sin(2pi t/P))
        # per 1000 ms; inter-arrival r->r+1 is 1000/lambda(t_r), i.e. an
        # Euler inversion of the cumulative intensity.  One full period
        # spans the whole run at the mean rate.
        period = max(1.0, rumors * 1000.0 / rate)
        ticks = []
        t = 0.0
        for _ in range(rumors):
            ticks.append(int(t))
            lam = rate * (1.0 + DIURNAL_DEPTH * math.sin(
                2.0 * math.pi * t / period)) / 1000.0
            t += 1.0 / max(lam, 1e-9)
        return tuple(ticks)
    raise ValueError(f"unknown arrival process {kind!r}")


def arrival_ticks(cfg) -> np.ndarray:
    """The per-rumor injection schedule for `cfg` (stream traffic): sorted
    nondecreasing int32 ticks, length cfg.rumors."""
    tab = _table(cfg.arrivals, max(cfg.stream_rate, 1), cfg.rumors,
                 cfg.seed)
    arr = np.asarray(tab, dtype=np.int32)
    if len(arr) and (np.diff(arr) < 0).any():
        raise ValueError(f"arrival table for {cfg.arrivals!r} not sorted")
    return arr


def table_or_none(cfg):
    """The injection table as a tuple, or None when the arithmetic
    schedule applies (fixed arrivals)."""
    if cfg.traffic != "stream" or cfg.arrivals == "fixed":
        return None
    return _table(cfg.arrivals, max(cfg.stream_rate, 1), cfg.rumors,
                  cfg.seed)
