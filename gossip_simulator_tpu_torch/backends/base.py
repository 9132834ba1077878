"""The Stepper backend seam (the JAX package's ``backends/base.py``).

One ``gossip_window()`` call advances 10 simulated milliseconds -- the
reference driver's poll cadence (simulator.go:223,244) -- so the driver's
printing loop is backend-agnostic.  ``run_bounded_to_target`` is the
run-to-target path both steppers share.
"""

from __future__ import annotations

import abc
import math
import time

from gossip_simulator_tpu_torch.config import Config
from gossip_simulator_tpu_torch.utils.metrics import Stats

WINDOW_MS = 10  # reference poll interval (simulator.go:223, 244)


class Stepper(abc.ABC):
    name: str = "abstract"

    def __init__(self, cfg: Config):
        self.cfg = cfg

    @abc.abstractmethod
    def init(self) -> None:
        """Allocate node state (mirrors simulator.go:207-217)."""

    @abc.abstractmethod
    def overlay_window(self) -> tuple[int, int, bool]:
        """Advance overlay construction by one poll window.  Returns
        ``(makeups, breakups, quiesced)``; static graphs quiesce at once."""

    @abc.abstractmethod
    def seed(self) -> None:
        """Pick a uniform-random node and inject its initial broadcast
        (simulator.go:240-241)."""

    @abc.abstractmethod
    def gossip_window(self) -> Stats:
        """Advance the epidemic by one poll window and return a counters
        snapshot."""

    @abc.abstractmethod
    def stats(self) -> Stats:
        """Current counters snapshot (host-side)."""

    @abc.abstractmethod
    def sim_time_ms(self) -> float:
        """Simulated milliseconds elapsed in the current phase."""

    @property
    def primary_host(self) -> bool:
        """Whether this process writes the snapshots: always, on one
        card (the JAX package's non-zero ranks of a multi-process run
        only gather)."""
        return True

    def state_pytree(self):
        """Phase-2 state as the JAX package's numpy dict for a snapshot;
        None if there is none (yet)."""
        return None

    def load_state_pytree(self, tree) -> None:
        raise NotImplementedError(
            f"{self.name} does not support state restore")

    def overlay_state_pytree(self):
        """Mid-construction phase-1 state for a snapshot; None if there is
        none."""
        return None

    def load_overlay_state_pytree(self, tree, windows: int = 0) -> None:
        raise NotImplementedError(
            f"{self.name} does not support phase-1 state restore")


def run_bounded_to_target(stepper) -> Stats:
    """The run-to-target path (the JAX package's host loop over its
    bounded device calls): re-enter the engine's run loop
    (``stepper._run_fn(state, key, target, until, hist)``, a bounded call
    of at most ``epidemic.run_call_budget`` ticks) until the coverage
    target, max_rounds or exhaustion.  Exhaustion is an empty ring, not
    under push-pull, never under healing, and under -rumors only past
    the last injection's tick.  With a TelemetrySession
    (``stepper._telem``) the loop carries its History and tallies each
    call's wall seconds: the first as compile_s (on the card it includes
    the kernels' first build), the rest as execute_s."""
    from gossip_simulator_tpu_torch.models import epidemic
    from gossip_simulator_tpu_torch.utils import lifecycle as _lifecycle
    from gossip_simulator_tpu_torch.utils import trace as _trace

    cfg = stepper.cfg
    target = int(math.ceil(cfg.coverage_target * cfg.n))
    budget = epidemic.run_call_budget(cfg)
    telem = getattr(stepper, "_telem", None)
    hist = telem.begin_gossip() if telem is not None else None
    calls = 0
    while True:
        until = min(cfg.max_rounds, stepper.tick + budget)
        t0 = time.perf_counter()
        with _trace.span("phase2.compile+run" if calls == 0
                         else "phase2.bounded_call", cat="device") as sp:
            stepper.state, hist = stepper._run_fn(
                stepper.state, stepper.key, target, until, hist)
            tick, recv, live = stepper.progress()
            if sp is not None:
                sp.update(until=int(until), tick=tick, received=recv,
                          in_flight=int(live))
        calls += 1
        if telem is not None:
            telem.tally_gossip_call(time.perf_counter() - t0)
        if (not live and cfg.protocol != "pushpull"
                and not cfg.overlay_heal_resolved
                and (not cfg.multi_rumor or tick > cfg.last_inject_tick)):
            stepper.exhausted = True
        if recv >= target or tick >= cfg.max_rounds or stepper.exhausted:
            break
        if _lifecycle.shutdown_requested():
            break
    if telem is not None:
        telem.end_gossip(hist)
    return stepper.stats()
