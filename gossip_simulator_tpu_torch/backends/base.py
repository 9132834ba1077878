"""The Stepper backend seam (the JAX package's ``backends/base.py``).

One ``gossip_window()`` call advances 10 simulated milliseconds -- the
reference driver's poll cadence (simulator.go:223,244) -- so the driver's
printing loop is backend-agnostic.
"""

from __future__ import annotations

import abc

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
    def stats_and_inflight(self) -> tuple[Stats, bool]:
        """``stats()`` and whether any message is still in flight, in one
        device-to-host read."""

    @abc.abstractmethod
    def sim_time_ms(self) -> float:
        """Simulated milliseconds elapsed in the current phase."""

    def state_pytree(self):
        """Backend state as numpy arrays; None if unsupported."""
        return None

    def load_state_pytree(self, tree) -> None:
        raise NotImplementedError(
            f"{self.name} does not support state restore")
