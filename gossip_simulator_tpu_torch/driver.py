"""Two-phase driver: overlay construction, then epidemic broadcast.

The port's trimmed copy of the JAX package's ``driver.py``: the
reference-format transcript (simulator.go:207-255), the explicit-gate
and estimated-clock notes, the windowed phase-1 loop (one line per poll
window or round until the overlay quiesces; a static graph quiesces at
once), phase 2 as the JAX package's default run reports it (the
transcript of its device loop's replay under ``-telemetry on``, its
windowed loop under ``-telemetry off``, each with its max-rounds bound),
and the final totals, on one device (``TorchStepper``) or on S shards of it
(``ShardedStepper``, ``-backend sharded``).  JSONL, traces, checkpoints,
serving and supervision are not yet ported; a PushSum run's result
payload (the JAX package's JSONL-only ``pushsum.report``) and a
multi-rumor run's serving report (its ``_multi_rumor_report``) come back
in ``RunResult.report``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np

from gossip_simulator_tpu_torch import arrivals as _arrivals
from gossip_simulator_tpu_torch.backends import (ShardedStepper, Stepper,
                                                 TorchStepper, WINDOW_MS)
from gossip_simulator_tpu_torch.config import Config
from gossip_simulator_tpu_torch.utils.metrics import ProgressPrinter, Stats


@dataclasses.dataclass
class RunResult:
    stats: Stats
    stabilize_ms: float  # simulated ms for overlay construction
    coverage_ms: float  # simulated ms to reach the coverage target
    converged: bool
    overlay_windows: int
    gossip_windows: int
    # -model pushsum: models.pushsum.report's dict (converged_eps,
    # eps_ticks, relerr_ppb); -rumors R / -traffic stream: the serving
    # report (multi_rumor_report); None otherwise.
    report: Optional[dict] = None


def run_simulation(cfg: Config, printer: Optional[ProgressPrinter] = None,
                   stepper: Optional[Stepper] = None,
                   device="cuda") -> RunResult:
    """Run both phases on `device` ("cuda" by default; "cpu" on request).
    A missing card raises; nothing falls back to the CPU."""
    cfg = cfg.validate()
    printer = printer or ProgressPrinter(enabled=cfg.progress)
    if stepper is None:
        stepper = (ShardedStepper(cfg, device=device)
                   if cfg.backend == "sharded"
                   else TorchStepper(cfg, device=device))

    printer.params(cfg.parameter_dump())
    scen = cfg.scenario_resolved
    if scen.active or cfg.overlay_heal_resolved:
        # The one-line fault-model banner, as the JAX package prints it.
        printer.note(
            f"scenario: {len(scen.crashes)} crash / {len(scen.churns)} "
            f"churn / {len(scen.partitions)} partition events, "
            f"groups={scen.groups}, downtime={scen.downtime}ms; "
            f"overlay-heal {cfg.overlay_heal}"
            + (f" (detect {cfg.heal_detect_ms}ms)"
               if cfg.overlay_heal_resolved else ""))
    if cfg.backend == "sharded":
        # What this run's exchange runs, as the JAX package's transcript
        # says it.
        printer.note(f"exchange-pipeline: {cfg.exchange_pipeline_resolved} "
                     f"(requested {cfg.exchange_pipeline})")
    if cfg.phase2_kernel != "auto":
        # Explicit requests only, as in the JAX package: the default
        # transcript stays free of gate notes.
        printer.note(f"phase2-kernel: {cfg.phase2_kernel_resolved} "
                     f"(requested {cfg.phase2_kernel})")
    if cfg.phase1_kernel != "auto":
        printer.note(f"phase1-kernel: {cfg.phase1_kernel_resolved} "
                     f"(requested {cfg.phase1_kernel})")
    stepper.init()

    # --- Phase 1: overlay (simulator.go:219-235) ----------------------------
    printer.section("Constructing Overlay")
    if (cfg.graph == "overlay" and cfg.overlay_mode == "auto"
            and cfg.backend in ("jax", "sharded")
            and cfg.effective_time_mode == "ticks"
            and cfg.overlay_mode_resolved == "rounds"):
        # The size-banded default runs the rounds engine above
        # OVERLAY_TICKS_AUTO_MAX, whose clock is estimated; say so once.
        printer.note("overlay clock estimated as rounds x mean delay "
                     "at this n; -overlay-mode ticks gives per-message-"
                     "faithful timing at ~2x the cost")
    max_overlay_windows = max(cfg.max_rounds, 1000)
    overlay_windows = 0
    while True:
        makeups, breakups, quiesced = stepper.overlay_window()
        overlay_windows += 1
        if quiesced:
            break
        printer.overlay_window(breakups, makeups, stepper.sim_time_ms())
        if overlay_windows >= max_overlay_windows:
            raise RuntimeError(f"overlay did not stabilize within "
                               f"{max_overlay_windows} windows")
    stabilize_ms = stepper.sim_time_ms()
    printer.stabilized(stabilize_ms)

    # --- Phase 2: broadcast (simulator.go:237-253) --------------------------
    printer.section("Broadcast one message")
    stepper.seed()
    target = cfg.coverage_target
    if cfg.telemetry == "on":
        gossip_windows = _telemetry_windows(cfg, stepper, printer)
        converged = False
    else:
        gossip_windows, converged = _windowed(cfg, stepper, printer)
    coverage_ms = stepper.sim_time_ms()
    stats = stepper.stats()
    converged = converged or stats.coverage >= target
    reason = ("exhausted: no messages in flight" if stats.exhausted
              else "max rounds")
    printer.done(coverage_ms, stats, target_pct=target * 100.0,
                 converged=converged, reason=reason)
    report = None
    if cfg.multi_rumor:
        report = multi_rumor_report(cfg, stepper, stats, coverage_ms)
    if cfg.model == "pushsum":
        from gossip_simulator_tpu_torch.models import pushsum

        report = pushsum.report(stepper)
    return RunResult(stats=stats, stabilize_ms=stabilize_ms,
                     coverage_ms=coverage_ms, converged=converged,
                     overlay_windows=overlay_windows,
                     gossip_windows=gossip_windows, report=report)


def latency_summary(lat) -> dict:
    """Interpolated per-rumor latency summary: np.percentile's linear
    interpolation between order statistics, with the exact min, max and
    mean."""
    a = np.asarray(lat, np.int64)
    p50, p90, p99 = np.percentile(a, [50, 90, 99])
    return {
        "min": int(a.min()), "max": int(a.max()),
        "p50": round(float(p50), 2),
        "p90": round(float(p90), 2),
        "p99": round(float(p99), 2),
        "mean": round(float(a.mean()), 2),
    }


def multi_rumor_report(cfg: Config, stepper: Stepper, stats: Stats,
                       coverage_ms: float) -> dict:
    """The serving report of a multi-rumor run (the JAX package's
    result-record fields, simulated time): traffic, rumors and deliveries
    a simulated second, and each done rumor's latency (its rumor_done
    stamp minus its scheduled inject tick: arrivals.arrival_ticks under
    stream traffic, 0 under oneshot) as a summary and a histogram."""
    r = cfg.rumors
    done = stepper.state.rumor_done[:r].cpu().numpy()
    inject = (np.asarray(_arrivals.arrival_ticks(cfg), np.int64)
              if cfg.traffic == "stream" else np.zeros(r, np.int64))
    out: dict = {"traffic": cfg.traffic}
    secs = coverage_ms / 1000.0
    if secs > 0:
        out["rumors_per_sec"] = round(stats.rumors_done / secs, 4)
        out["deliveries_per_sec"] = round(stats.total_message / secs, 1)
    lat = (done.astype(np.int64) - inject)[done >= 0]
    if lat.size:
        out["rumor_latency_ms"] = latency_summary(lat)
        counts, edges = np.histogram(lat, bins=min(10, max(1, lat.size)))
        out["rumor_latency_hist"] = {
            "edges_ms": [round(float(e), 1) for e in edges],
            "counts": [int(c) for c in counts],
        }
    return out


def _windowed(cfg: Config, stepper: Stepper,
              printer: ProgressPrinter) -> tuple[int, bool]:
    """The windowed loop (the JAX package's under ``-telemetry off``): a
    window, its coverage line (``Stats.coverage``: the worst rumor's under
    ``-rumors``), then the target and exhaustion checks; returns (windows,
    converged)."""
    # max_rounds caps simulated time at window granularity: windows of
    # WINDOW_MS ticks, or of one round in rounds mode.
    window_rounds = WINDOW_MS if cfg.effective_time_mode == "ticks" else 1
    max_windows = max(0, -(-cfg.max_rounds // window_rounds))
    windows = 0
    while windows < max_windows:
        stats = stepper.gossip_window()
        windows += 1
        printer.coverage_window(round(stats.coverage * 100.0, 4),
                                stepper.sim_time_ms())
        if stats.coverage >= cfg.coverage_target:
            return windows, True
        if getattr(stepper, "exhausted", False):
            break  # no messages in flight and nothing can change
    return windows, False


def _telemetry_windows(cfg: Config, stepper: Stepper,
                       printer: ProgressPrinter) -> int:
    """What the JAX package's default run (``-telemetry on``) prints: its
    device loop (``run_bounded_to_target``) tests before each window that
    the target count ``ceil(coverage_target * n)`` is unmet (the worst
    rumor's count under ``-rumors``), the tick below ``-max-rounds`` and a
    message in flight (PushSum: or the first batch not yet sent; not under
    ``-overlay-heal on``, where healing can revive an empty ring; on the
    event engine under ``-rumors`` or ``-traffic stream``, or while the
    tick is at most the last injection's), and its replay
    (``telemetry.replay_gossip``) prints each window's coverage as
    ``total_received / n``.  So a broadcast that dies at once prints no
    window line.  Exhaustion is the final state's empty ring (under
    ``-rumors``, past the last injection's tick; never under healing).
    Returns the windows run."""
    from gossip_simulator_tpu_torch.models import event

    target = math.ceil(cfg.coverage_target * cfg.n)
    first_batch = event.batch_ticks(cfg) if cfg.model == "pushsum" else 0
    pushpull = cfg.protocol == "pushpull"
    heal = cfg.overlay_heal_resolved
    # The event engine injects its rumors inside the window step.
    last_inj = (cfg.last_inject_tick
                if cfg.multi_rumor and cfg.engine_resolved == "event"
                else -1)
    stats, live = stepper.stats_and_inflight()
    windows = 0
    while True:
        recv = (stats.rumor_min_recv if cfg.multi_rumor
                else stats.total_received)
        alive = (live or pushpull or heal or stats.round < first_batch
                 or stats.round <= last_inj)
        if recv >= target or stats.round >= cfg.max_rounds or not alive:
            break
        stats = stepper.gossip_window()
        live = not stepper.exhausted
        windows += 1
        pct = (stats.total_received / cfg.n if cfg.n else 0.0) * 100.0
        printer.coverage_window(round(pct, 4), float(stats.round))
    stepper.exhausted = (not live and not pushpull and not heal
                         and (not cfg.multi_rumor
                              or stats.round > cfg.last_inject_tick))
    return windows
