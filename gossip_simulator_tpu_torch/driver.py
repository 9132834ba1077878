"""Two-phase driver: overlay construction, then epidemic broadcast.

The port's copy of the JAX package's ``driver.py`` (simulator.go:207-255):
the reference-format transcript, the explicit-gate and estimated-clock
notes, phase 1 to quiescence and phase 2 to the coverage target with its
max-rounds bound, and the final totals, on one device (``TorchStepper``)
or on S shards of it (``ShardedStepper``, ``-backend sharded``).

Each phase takes the stepper's run-to-target path (phase 1
``overlay_run_to_quiescence``, phase 2 ``run_to_target``) unless a
printer observes every window without telemetry; under ``-telemetry on``
the path records every window on the device and the driver replays the
fetched history through the printer, so stdout and JSONL are the
windowed loop's (``_windowed``, kept for ``-telemetry off``).  The run
leaves the JAX package's records: the JSONL log (``-log-jsonl``) with its
terminal ``result`` record (Stats, gates, the multi-rumor or PushSum
report, ``phases_s``) and ``telemetry`` record, the ``-telemetry-summary``
block, the ``-run-dir`` artifact with its trajectory fingerprint, the
``-trace`` spans, and ``torch.profiler`` traces (``-profile`` around
phase 2, ``-xprof`` around the run).

Checkpoints (``utils/checkpoint.py``, the JAX package's format): with
``-checkpoint-every W -checkpoint-dir D`` each phase runs its windowed
loop and saves a snapshot every W windows (``overlay_*`` in phase 1,
``state_*`` in phase 2), pruned to ``-ckpt-keep``; ``-resume`` continues
from the newest snapshot in D (phase 2 before phase 1), in its windowed
loop.  A shutdown request (``utils/lifecycle.py``: the first SIGTERM or
SIGINT under the CLI) ends the run at the next window boundary with
reason "interrupted" and, with D, a final snapshot.  Serving and
supervision are not yet ported.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from typing import Optional

import numpy as np

from gossip_simulator_tpu_torch import arrivals as _arrivals
from gossip_simulator_tpu_torch.backends import (ShardedStepper, Stepper,
                                                 TorchStepper, WINDOW_MS)
from gossip_simulator_tpu_torch.config import Config
from gossip_simulator_tpu_torch.utils import checkpoint
from gossip_simulator_tpu_torch.utils import lifecycle as _lifecycle
from gossip_simulator_tpu_torch.utils import telemetry as _telemetry
from gossip_simulator_tpu_torch.utils import trace as _trace
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
    # report (multi_rumor_report); None otherwise.  Both are also in the
    # JSONL result record.
    report: Optional[dict] = None


def run_simulation(cfg: Config, printer: Optional[ProgressPrinter] = None,
                   stepper: Optional[Stepper] = None,
                   device="cuda") -> RunResult:
    """Run both phases on `device` ("cuda" by default; "cpu" on request).
    A missing card raises; nothing falls back to the CPU."""
    cfg = cfg.validate()
    own_printer = printer is None
    printer = printer or ProgressPrinter(
        enabled=cfg.progress, jsonl_path=cfg.log_jsonl_resolved or None)
    tracer = None
    if cfg.trace_resolved or cfg.xprof_dir:
        tracer = _trace.Tracer(path=cfg.trace_resolved,
                               xprof_dir=cfg.xprof_dir)
    try:
        with _trace.activated(tracer):
            return _run(cfg, printer, stepper, device)
    finally:
        # On any exit, so a raised run still writes what it got through.
        if tracer is not None and tracer.path:
            tracer.write(metadata={"n": cfg.n, "backend": cfg.backend,
                                   "seed": cfg.seed})
        if own_printer:
            printer.close()


def _run(cfg: Config, printer: ProgressPrinter, stepper: Optional[Stepper],
         device) -> RunResult:
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
    t_init = time.perf_counter()
    with _trace.span("init", cat="phase"):
        stepper.init()
    # The telemetry session lets an observing run take the run-to-target
    # paths: they record every window on the device, replayed below
    # through the same printer calls.
    telem = getattr(stepper, "_telem", None)
    if telem is not None:
        telem.add_phase("init_s", time.perf_counter() - t_init)
    fast_ok = not printer.observing or telem is not None
    run_id = cfg.run_id

    # --- Resume: from a phase-2 snapshot (straight into phase 2) or a
    # phase-1 snapshot (construction continues mid-overlay) -----------------
    resumed = False
    resume_window = 0
    overlay_windows = 0
    if cfg.resume:
        # latest() prefers state_* (phase 2) over overlay_* (phase 1).
        path = checkpoint.latest(cfg.checkpoint_dir)
        if path is None:
            raise FileNotFoundError(
                f"-resume: no snapshot found in {cfg.checkpoint_dir}")
        tree, meta = checkpoint.load(path)
        if run_id:
            checkpoint.verify_provenance(meta, path=path, run_id=run_id,
                                         now_window=0, max_stale=0)
        # Without a sidecar the tree tells the phase (win_makeups is an
        # overlay leaf).
        phase1 = (int(meta["phase"]) == 1 if "phase" in meta
                  else "win_makeups" in tree)
        if phase1:
            overlay_windows = int(meta.get("window", 0))
            stepper.load_overlay_state_pytree(tree, windows=overlay_windows)
            printer.section(f"Resumed from {os.path.basename(path)} "
                            f"(overlay window {overlay_windows})")
        else:
            stepper.load_state_pytree(tree)
            resume_window = int(meta.get("window", 0))
            printer.section(f"Resumed from {os.path.basename(path)} "
                            f"(window {resume_window})")
            resumed = True
        del tree

    # --- Phase 1: overlay (simulator.go:219-235) ----------------------------
    # A shutdown request (utils/lifecycle) ends the current window; one in
    # phase 1 leaves no epidemic state to report or seed.
    p1_interrupted = False
    if not resumed:
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
        ckpt1 = _Checkpointer(cfg, stepper, run_id)
        # Checkpointing saves the state between windows, so it keeps the
        # windowed loop.
        if (fast_ok and not cfg.checkpointing_enabled
                and hasattr(stepper, "overlay_run_to_quiescence")):
            with _trace.span("phase1.quiesce", cat="phase") as sp:
                overlay_windows, oq = stepper.overlay_run_to_quiescence(
                    max_overlay_windows)
                if sp is not None:
                    sp["windows"] = int(overlay_windows)
            if not oq:
                raise RuntimeError(f"overlay did not stabilize within "
                                   f"{max_overlay_windows} windows")
            # A static graph quiesces without a window; the windowed loop
            # counts its one quiesced poll.
            overlay_windows = max(overlay_windows, 1)
            if telem is not None and printer.observing:
                _telemetry.replay_overlay(
                    printer, telem.overlay_snapshot(),
                    clock_scale=getattr(stepper, "overlay_clock_scale", 1.0))
        else:
            while True:
                with _trace.span("phase1.window", cat="window") as sp:
                    makeups, breakups, quiesced = stepper.overlay_window()
                    if sp is not None:
                        sp.update(makeups=int(makeups),
                                  breakups=int(breakups))
                overlay_windows += 1
                if quiesced:
                    break
                printer.overlay_window(breakups, makeups,
                                       stepper.sim_time_ms())
                ckpt1.maybe_save_overlay(overlay_windows)
                if _lifecycle.shutdown_requested():
                    p1_interrupted = True
                    break
                if overlay_windows >= max_overlay_windows:
                    raise RuntimeError(f"overlay did not stabilize within "
                                       f"{max_overlay_windows} windows")
    stabilize_ms = 0.0 if resumed else stepper.sim_time_ms()
    if not resumed and not p1_interrupted:
        printer.stabilized(stabilize_ms)

    # --- Phase 2: broadcast (simulator.go:237-253) --------------------------
    if not p1_interrupted:
        printer.section("Broadcast one message")
        if not resumed:
            stepper.seed()
    target = cfg.coverage_target
    window_rounds = WINDOW_MS if cfg.effective_time_mode == "ticks" else 1
    # max_rounds caps simulated time at window granularity; a resumed run
    # gets the ceil of what remains.
    elapsed = int(stepper.sim_time_ms()) if resumed else 0
    max_windows = max(0, -(-(cfg.max_rounds - elapsed) // window_rounds))
    gossip_windows = 0
    converged = False
    interrupted = p1_interrupted
    # Per-window trajectory rows for the run artifact, when the windowed
    # loop runs (the run-to-target path's come from its history).
    window_rows: list = []
    with _maybe_profile(cfg):
        if p1_interrupted:
            pass
        elif (fast_ok and not resumed and not cfg.checkpointing_enabled
              and hasattr(stepper, "run_to_target")):
            with _trace.span("phase2.run_to_target", cat="phase") as sp:
                stats = stepper.run_to_target()
                if sp is not None:
                    sp.update(rounds=int(stats.round),
                              messages=int(stats.total_message),
                              received=int(stats.total_received))
            hist2 = telem.gossip_snapshot() if telem is not None else None
            if hist2 and printer.observing:
                _telemetry.replay_gossip(printer, hist2, n=cfg.n)
            gossip_windows = (hist2["count"]
                              if hist2 and not hist2["truncated"]
                              else -(-stats.round // window_rounds))
            converged = stats.coverage >= target
            interrupted = _lifecycle.shutdown_requested()
        else:
            gossip_windows, converged, interrupted = _windowed(
                cfg, stepper, printer, max_windows,
                _Checkpointer(cfg, stepper, run_id), resume_window,
                window_rows if cfg.run_dir else None)
    # A run interrupted mid-overlay has no epidemic state to read back.
    coverage_ms = 0.0 if p1_interrupted else stepper.sim_time_ms()
    stats = Stats(n=cfg.n) if p1_interrupted else stepper.stats()
    # A snapshot restored at or past the cap may already be at target.
    converged = converged or stats.coverage >= target
    if interrupted:
        reason = "interrupted"
    else:
        reason = ("exhausted: no messages in flight" if stats.exhausted
                  else "max rounds")
    if interrupted and cfg.checkpoint_dir:
        _final_shutdown_checkpoint(cfg, stepper, stats, p1_interrupted,
                                   resume_window + gossip_windows,
                                   overlay_windows)
    printer.done(coverage_ms, stats, target_pct=target * 100.0,
                 converged=converged, reason=reason)
    report = None
    if cfg.multi_rumor and not p1_interrupted:
        report = multi_rumor_report(cfg, stepper, stats, coverage_ms)
    if cfg.model == "pushsum" and not p1_interrupted:
        from gossip_simulator_tpu_torch.models import pushsum

        report = pushsum.report(stepper)
    # The terminal record: the RunResult, attribution (artifact dir,
    # resolved gates) and the wall breakdown, JSONL-only.
    payload = {
        "converged": converged,
        "stabilize_ms": stabilize_ms, "coverage_ms": coverage_ms,
        "overlay_windows": overlay_windows,
        "gossip_windows": gossip_windows,
        "reason": None if converged else reason,
        "run_dir": os.path.abspath(cfg.run_dir) if cfg.run_dir else None,
        "gates": cfg.resolved_gates(),
        **stats.to_dict(),
        **(report or {}),
    }
    if telem is not None:
        payload["phases_s"] = {k: round(v, 6)
                               for k, v in sorted(telem.phases.items())}
    printer.result(payload)
    if telem is not None:
        summary = _telemetry.TelemetryReport(
            n=cfg.n, phases=telem.phases, overlay=telem.overlay_snapshot(),
            gossip=telem.gossip_snapshot(),
            overlay_clock_scale=getattr(stepper, "overlay_clock_scale", 1.0))
        printer.telemetry(summary.summary())
        if cfg.telemetry_summary:
            printer.block(summary.summary_block())
    if cfg.run_dir:
        _write_run_dir(cfg, telem, window_rows, payload, stats,
                       getattr(stepper, "device", None))
    return RunResult(stats=stats, stabilize_ms=stabilize_ms,
                     coverage_ms=coverage_ms, converged=converged,
                     overlay_windows=overlay_windows,
                     gossip_windows=gossip_windows, report=report)


def _final_shutdown_checkpoint(cfg: Config, stepper: Stepper, stats: Stats,
                               phase1: bool, window: int,
                               overlay_windows: int) -> None:
    """The shutdown path's last snapshot, marked ``interrupted``: the
    furthest state of whichever phase the run was in, so -resume
    continues where the signal struck.  Pruned like every save."""
    if phase1:
        tree = stepper.overlay_state_pytree()
        if tree is not None and stepper.primary_host:
            checkpoint.save(cfg.checkpoint_dir, overlay_windows, tree,
                            Stats(n=cfg.n), prefix="overlay",
                            extra_meta={"phase": 1, "interrupted": True,
                                        "sim_ms": stepper.sim_time_ms()})
            checkpoint.prune(cfg.checkpoint_dir, cfg.ckpt_keep,
                             prefix="overlay")
    else:
        tree = stepper.state_pytree()
        if tree is not None and stepper.primary_host:
            checkpoint.save(cfg.checkpoint_dir, window, tree, stats,
                            extra_meta={"interrupted": True})
            checkpoint.prune(cfg.checkpoint_dir, cfg.ckpt_keep)


class _Checkpointer:
    """The snapshot cadence: a save every -checkpoint-every windows of
    either phase (when -checkpoint-dir is set too), each followed by a
    prune to -ckpt-keep; ``run_id`` in every sidecar when -run-id is
    given."""

    def __init__(self, cfg: Config, stepper: Stepper, run_id: str = ""):
        self.cfg, self.stepper = cfg, stepper
        self.extra_meta = {"run_id": run_id} if run_id else None

    def _due(self, window: int) -> bool:
        cfg = self.cfg
        return (cfg.checkpointing_enabled
                and window % cfg.checkpoint_every == 0)

    def maybe_save(self, window: int, stats: Stats) -> None:
        if not self._due(window):
            return
        tree = self.stepper.state_pytree()
        if tree is not None and self.stepper.primary_host:
            checkpoint.save(self.cfg.checkpoint_dir, window, tree, stats,
                            extra_meta=self.extra_meta)
            checkpoint.prune(self.cfg.checkpoint_dir, self.cfg.ckpt_keep)

    def maybe_save_overlay(self, window: int) -> None:
        """A phase-1 snapshot on the same cadence, under the ``overlay_``
        prefix with phase 1 and the simulated ms in its sidecar."""
        if not self._due(window):
            return
        tree = self.stepper.overlay_state_pytree()
        if tree is not None and self.stepper.primary_host:
            checkpoint.save(
                self.cfg.checkpoint_dir, window, tree,
                Stats(n=self.cfg.n), prefix="overlay",
                extra_meta={"phase": 1,
                            "sim_ms": self.stepper.sim_time_ms()})
            checkpoint.prune(self.cfg.checkpoint_dir, self.cfg.ckpt_keep,
                             prefix="overlay")


def _write_run_dir(cfg: Config, telem, window_rows: list, payload: dict,
                   stats: Stats, device=None) -> None:
    """Write the -run-dir artifact (utils/artifact.py).  The trajectory is
    the device-recorded history's ("telemetry"), else the windowed loop's
    rows ("windows"), else one final-Stats row ("final"), and the basis is
    named so compare_runs never takes one for another."""
    from gossip_simulator_tpu_torch.utils import artifact

    rdir = artifact.RunDir(cfg.run_dir)
    hist_o = telem.overlay_snapshot() if telem is not None else None
    hist_g = telem.gossip_snapshot() if telem is not None else None
    traj = artifact.trajectory_from_history(hist_g)
    basis = "telemetry"
    if traj is None:
        traj = artifact.trajectory_from_rows(window_rows)
        basis = "windows"
    if traj is None:
        traj = artifact.trajectory_from_rows(
            [(stats.round, stats.total_received, stats.total_message,
              stats.total_crashed, stats.total_removed)])
        basis = "final"
    rdir.write_config(cfg)
    rdir.write_env(device=device)
    rdir.write_telemetry(hist_o, hist_g, traj)
    if cfg.telemetry_spatial_enabled:
        # The shard-health watchdog over the fetched panels: its verdict
        # to health.json, its findings to the trace as instants.
        from gossip_simulator_tpu_torch.utils import health as _health

        n_shards = telem.n_shards if telem is not None else 1
        rdir.write_health(_health.report_health(_health.evaluate_health(
            hist_g, cap=_health.ring_slot_cap(cfg, n_shards))))
    rdir.write_result({
        **payload,
        "fingerprint": artifact.fingerprint_rows(traj),
        "fingerprint_windows": int(traj.shape[0]),
        "fingerprint_basis": basis,
    })


@contextlib.contextmanager
def _maybe_profile(cfg: Config):
    """-profile: phase 2 under torch.profiler, its Chrome trace written
    into -profile-dir (inside an -xprof profile, that one records it)."""
    tracer = _trace.active()
    if not cfg.profile or (tracer is not None and tracer.xprof_dir):
        yield
        return
    prof = _trace.start_profile()
    with prof:
        yield
    _trace.write_profile(prof, cfg.profile_dir)


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
    stream traffic, 0 under oneshot) as a summary and a histogram.  The
    sharded backend's stamps are replicated: shard 0's are read."""
    r = cfg.rumors
    st = stepper.state
    st = st[0] if isinstance(st, list) else st
    done = st.rumor_done[:r].cpu().numpy()
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


def _windowed(cfg: Config, stepper: Stepper, printer: ProgressPrinter,
              max_windows: int, ckpt: "_Checkpointer", resume_window: int,
              rows: Optional[list] = None) -> tuple[int, bool, bool]:
    """The windowed loop (``-telemetry off`` with an observing printer,
    checkpointing, or a resumed run): a window, its coverage line
    (``Stats.coverage``: the worst rumor's under ``-rumors``), the
    snapshot when one is due (numbered on from `resume_window`), then
    the target, exhaustion and shutdown checks; each window's trajectory
    row is appended to `rows` when given.  Returns (windows, converged,
    interrupted)."""
    windows = 0
    while windows < max_windows:
        with _trace.span("phase2.window", cat="window") as sp:
            stats = stepper.gossip_window()
            if sp is not None:
                sp.update(round=int(stats.round),
                          received=int(stats.total_received),
                          messages=int(stats.total_message),
                          dropped=int(stats.mailbox_dropped))
        windows += 1
        if rows is not None:
            rows.append((stats.round, stats.total_received,
                         stats.total_message, stats.total_crashed,
                         stats.total_removed))
        printer.coverage_window(round(stats.coverage * 100.0, 4),
                                stepper.sim_time_ms())
        ckpt.maybe_save(resume_window + windows, stats)
        if stats.coverage >= cfg.coverage_target:
            return windows, True, False
        if getattr(stepper, "exhausted", False):
            break  # no messages in flight and nothing can change
        if _lifecycle.shutdown_requested():
            return windows, False, True
    return windows, False, False
