"""Counters and reference-format progress output.

The port's copy of the JAX package's ``utils/metrics.py`` (its transcript
comes from these lines, so they stay character for character):

    break <B> makeup <M> elasped <t>          (simulator.go:230, typo intact)
    --- Took <t> to stabilize ---             (simulator.go:235)
    <p>% covered, took <t>                    (simulator.go:247)
    --- Took <t> to get 99% ---               (simulator.go:252)
    Total message <M> Total Crashed <C>       (simulator.go:253)

With a ``jsonl_path`` every line is also one JSONL record (schema v4:
the stream opens with the column-schema header, every record carries
``schema_version`` and ``wall_s``), as the JAX package writes it.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import time
from typing import Optional

# JSONL record-format version, stamped on every record.
SCHEMA_VERSION = 4


def header_record() -> dict:
    """The stream header: the column schemas of the telemetry histories,
    the run artifact's trajectory and the spatial panels (listed whether
    or not a run records them).  Deterministic, so twin streams compare."""
    from gossip_simulator_tpu_torch.utils.artifact import TRAJECTORY_COLS
    from gossip_simulator_tpu_torch.utils.telemetry import (
        GOSSIP_COLS, OVERLAY_COLS, SPATIAL_GROUP_COLS, SPATIAL_SHARD_COLS)

    return {"event": "header",
            "columns": {"gossip": list(GOSSIP_COLS),
                        "overlay": list(OVERLAY_COLS),
                        "trajectory": list(TRAJECTORY_COLS),
                        "spatial_group": list(SPATIAL_GROUP_COLS),
                        "spatial_shard": list(SPATIAL_SHARD_COLS)}}


@dataclasses.dataclass
class Stats:
    """Host-side snapshot of the simulation counters."""

    n: int = 0
    round: int = 0
    total_received: int = 0  # nodes infected (reference: TotalReceived)
    total_message: int = 0  # messages delivered to live nodes (TotalMessage)
    total_crashed: int = 0  # nodes crashed by reception (TotalCrashed)
    total_removed: int = 0  # SIR: nodes that stopped re-broadcasting
    makeups: int = 0
    breakups: int = 0
    mailbox_dropped: int = 0  # framework-only: capacity-overflow drops
    exchange_overflow: int = 0
    scen_crashed: int = 0
    scen_recovered: int = 0
    part_dropped: int = 0
    heal_repaired: int = 0
    # True when the run ended with no messages in flight (the wave died).
    exhausted: bool = False
    rumors: int = 1
    rumor_min_recv: int = -1
    rumors_done: int = 0
    shed: int = 0

    @property
    def coverage(self) -> float:
        if not self.n:
            return 0.0
        if self.rumors > 1 or self.rumor_min_recv >= 0:
            return max(self.rumor_min_recv, 0) / self.n
        return self.total_received / self.n

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["coverage"] = self.coverage
        return d


def fmt_sim_ms(ms: float) -> str:
    """Render simulated milliseconds the way Go renders time.Duration
    (e.g. ``231ms``, ``1.24s``)."""
    if ms < 1000:
        return f"{ms:g}ms"
    return f"{ms / 1000.0:g}s"


class ProgressPrinter:
    """Reference-format progress lines plus the optional JSONL log.
    enabled=False ("quiet") suppresses only the per-window progress
    lines; parameters, phase summaries and final totals always print."""

    def __init__(self, enabled: bool = True,
                 jsonl_path: Optional[str] = None, out=None):
        self.enabled = enabled
        self.out = out or sys.stdout
        if jsonl_path:
            # A -run-dir run logs into its not yet created artifact dir.
            parent = os.path.dirname(os.path.abspath(jsonl_path))
            os.makedirs(parent, exist_ok=True)
        self._jsonl = open(jsonl_path, "a") if jsonl_path else None
        self._header_written = False
        self._t0 = time.perf_counter()

    @property
    def observing(self) -> bool:
        """True when per-window lines are seen somewhere (stdout progress
        lines or the JSONL log)."""
        return self.enabled or self._jsonl is not None

    def _emit(self, line: str, progress_only: bool = False, **record):
        if self.enabled or not progress_only:
            print(line, file=self.out, flush=True)
        self._record(**record)

    def _record(self, **record):
        """A JSONL-only record (no stdout line); the header goes first,
        written lazily, so a run that never logs leaves the file empty."""
        if self._jsonl:
            if not self._header_written:
                self._header_written = True
                self._record(**header_record())
            record["schema_version"] = SCHEMA_VERSION
            record["wall_s"] = time.perf_counter() - self._t0
            self._jsonl.write(json.dumps(record) + "\n")
            self._jsonl.flush()

    def params(self, dump: str):
        self._emit(dump, event="params")

    def overlay_window(self, breakups: int, makeups: int, sim_ms: float):
        # simulator.go:230 -- including the `elasped` typo for parity.
        self._emit(
            f"break {breakups} makeup {makeups} elasped {fmt_sim_ms(sim_ms)}",
            progress_only=True,
            event="overlay", breakups=breakups, makeups=makeups, sim_ms=sim_ms)

    def stabilized(self, sim_ms: float):
        self._emit(f"--- Took {fmt_sim_ms(sim_ms)} to stabilize ---\n",
                   event="stabilized", sim_ms=sim_ms)

    def coverage_window(self, pct: float, sim_ms: float):
        # simulator.go:247 prints float32 percent*100 with %v.
        self._emit(f"{pct:g}% covered, took {fmt_sim_ms(sim_ms)}",
                   progress_only=True, event="coverage", pct=pct,
                   sim_ms=sim_ms)

    def done(self, sim_ms: float, stats: Stats, target_pct: float = 99.0,
             converged: bool = True, reason: str = "max rounds"):
        if converged:
            self._emit(
                f"--- Took {fmt_sim_ms(sim_ms)} to get {target_pct:g}% ---\n",
                event="done", sim_ms=sim_ms, **stats.to_dict())
        else:
            self._emit(
                f"--- Did NOT reach {target_pct:g}% after "
                f"{fmt_sim_ms(sim_ms)} ({reason}) ---\n",
                event="nonconvergence", sim_ms=sim_ms, reason=reason,
                **stats.to_dict())
        self._emit(f"Total message {stats.total_message} "
                   f"Total Crashed {stats.total_crashed}",
                   event="totals", **stats.to_dict())

    def note(self, text: str):
        """One-line informational notice (progress-only)."""
        self._emit(f"({text})", progress_only=True, event="note", text=text)

    def section(self, title: str):
        self._emit(f"\n=== {title} ===", event="section", title=title)

    def result(self, payload: dict):
        """The terminal record: the run's result and its wall breakdown,
        JSONL-only."""
        self._record(event="result", **payload)

    def telemetry(self, summary: dict):
        """The telemetry report (phase ledger, throughput, per-window
        trajectory), JSONL-only."""
        self._record(event="telemetry", **summary)

    def block(self, text: str):
        """A multi-line end-of-run stdout block (-telemetry-summary); never
        in the JSONL stream."""
        print(text, file=self.out, flush=True)

    def close(self):
        if self._jsonl:
            self._jsonl.close()
            self._jsonl = None

    def __enter__(self) -> "ProgressPrinter":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        # Close on any exit, so a run that raises still flushes its JSONL.
        self.close()
