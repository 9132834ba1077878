"""Typed configuration for the PyTorch/CUDA port of the gossip simulator.

The port's own copy of the JAX package's ``config.py``, trimmed to the
flags the ported slices read: the default two-phase run (overlay
construction by the tick-faithful engine up to n = 10M, by the rounds
engine above it or under ``-overlay-mode rounds``, then the event engine
on its friends table), static graphs (``-graph kout``, ``erdos`` or
``ring``, and ``-pallas``'s generators), and the ring engine
(``-time-mode rounds``, ``-engine ring``, ``-compact``, ``-protocol
pushpull``, ``-engine ring -rumors R``), SI or SIR, and PushSum numeric
gossip (``-model pushsum``) on one device, each under fault scenarios
and overlay healing (``-scenario``, ``-overlay-heal``,
``-heal-detect-ms``; ``scenario.py``), and multi-rumor traffic on the
event engine (``-rumors R``, ``-traffic stream`` with ``-stream-rate``
and ``-arrivals``; ``arrivals.py``).  Flag spellings, defaults
and the reference-format parameter dump are the JAX package's, so a
run's transcript matches it byte for byte.

Every flag of the JAX package's parser is parsed here, and ``validate``
rejects a value outside the slices by name with the ROADMAP item that
ports it, e.g. ``-serve ... is not yet ported (ROADMAP A14)``.
The recording flags are the JAX package's too: ``-log-jsonl``,
``-run-dir``, ``-trace``, ``-telemetry-summary``, ``-profile``,
``-profile-dir`` and ``-xprof`` (``log_jsonl_resolved``,
``trace_resolved``, ``resolved_gates``); ``-telemetry on`` (the
default) runs the run-to-target paths with a device-recorded history,
``-telemetry off`` the windowed loop.

The engines' tuned constants (``tuning.py``'s registry defaults in the
JAX package) are copied below as plain constants; the port has no tuning
table yet.
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import os
from typing import Optional

BACKENDS = ("native", "cpp", "jax", "sharded")
PROTOCOLS = ("si", "pushpull", "sir")
GRAPHS = ("overlay", "kout", "erdos", "ring")
TIME_MODES = ("ticks", "rounds")
ENGINES = ("auto", "ring", "event")
KERNEL_GATES = ("auto", "xla", "pallas")
# The tick-faithful overlay's slot-major layout band (overlay_ticks.py).
TICKS_SLOTMAJOR_MIN_ROWS = 32_000_000
DEVICES = ("cuda", "cpu")

# Event-engine tunables: the JAX package's registered defaults
# (tuning.py "event.*").
EVENT_SLOT_HEADROOM = 1.5
EVENT_DRAIN_CHUNK_FLOOR = 131_072
EVENT_DRAIN_CHUNK_HI = 1_048_576
EVENT_DRAIN_CHUNK_HI_LOWDEG = 524_288
EVENT_DRAIN_CHUNK_HI_SUPPRESS = 4_194_304
# Tick-faithful overlay: the slot drain's delivery-chunk ceiling
# (tuning.py "overlay_ticks.delivery_chunk_cap").
OVERLAY_TICKS_DELIVERY_CHUNK_CAP = 2_097_152

# overlay_mode="auto" picks the tick-faithful phase-1 engine up to this n
# (rounds above: the estimated-clock engine).
OVERLAY_TICKS_AUTO_MAX = 10_000_000
# overlay_static_boot="auto" band: at and above this many rows the rounds
# overlay draws the whole initial friends table and stages the n*fanout
# makeup burst at round 0 instead of one bootstrap friend per round.
OVERLAY_STATIC_BOOT_MIN_ROWS = 32_000_000
# The auto mailbox cap drops 16 -> 8 at this many local rows.
MAILBOX_CAP_MEMORY_BAND = 32_000_000
# Rounds-overlay tunables: the JAX package's registered defaults
# (tuning.py "overlay.*"; the fattest hosted-chunk rung,
# "overlay.adaptive_chunk_max", is models/overlay.ADAPTIVE_CHUNK_MAX).
OVERLAY_DELIVERY_CHUNK_BASE = 65_536
OVERLAY_DELIVERY_CHUNK_CAP = 1_048_576
OVERLAY_SPILL_MARGIN = 1.6



def batch_ticks_for(cfg: "Config", n: int) -> int:
    """The event engine's window size B at n rows, bounded so the packed
    id*B+tick_off fits int32 (SIR also packs triggers at (n+1+id)*B+off,
    doubling the range)."""
    b = max(1, min(10, cfg.delaylow))
    span = 2 * n + 3 if cfg.protocol == "sir" else n + 1
    while b > 1 and span * b >= 2**31:
        b //= 2
    return b


def ring_windows_for(cfg: "Config", n: int) -> int:
    """The event engine's window-slot ring depth at n rows: the largest
    arrival offset in windows, plus the current one."""
    b = batch_ticks_for(cfg, n)
    return (b - 1 + cfg.delayhigh - 1) // b + 1


def er_cap(lam: float) -> int:
    """Erdős–Rényi friends-column capacity: covers the Poisson(lam) upper
    tail to ~6 sigma (overflow is clipped in degree)."""
    return max(1, int(math.ceil(lam + 6.0 * math.sqrt(max(lam, 1.0)) + 4)))


def flat_addressing_fits(n: int, cap: int) -> bool:
    """True iff an [n, cap] mailbox plus its trash cell fits int32 flat
    addressing."""
    return (n + 1) * cap < 2**31


class NotYetPorted(ValueError):
    """A flag value the JAX package supports and this port does not yet."""

    def __init__(self, what: str, item: str):
        super().__init__(f"{what} is not yet ported (ROADMAP {item})")


@dataclasses.dataclass(frozen=True)
class Config:
    """Simulation configuration; the first seven fields are the reference
    flags (defaults preserved)."""

    n: int = 50_000
    fanout: int = 5
    fanin: int = -1  # -1 -> resolved fanout + 1
    delaylow: int = 10  # ms (one simulated tick == 1 ms)
    delayhigh: int = 20  # ms, exclusive upper bound
    droprate: float = 0.1
    crashrate: float = 0.001

    backend: str = "jax"
    protocol: str = "si"
    graph: str = "overlay"
    seed: int = 0
    max_rounds: int = 100_000
    coverage_target: float = 0.99
    time_mode: str = "ticks"
    removal_rate: float = 0.1
    er_p: float = -1.0  # <= 0 -> fanout / n (mean degree = fanout)
    compat_reference: bool = False
    mailbox_cap: int = -1  # -1 -> auto (mailbox_cap_for)
    pallas: bool = False
    compact: str = "auto"
    compact_chunk: int = -1  # -1 -> auto (the engine's delivery chunk)
    engine: str = "auto"
    event_slot_cap: int = -1
    event_chunk: int = -1
    dup_suppress: str = "auto"
    overlay_mode: str = "auto"
    overlay_adaptive_chunks: str = "auto"
    overlay_dead_skip: str = "auto"
    overlay_static_boot: str = "auto"
    deliver_kernel: str = "auto"
    phase2_kernel: str = "auto"
    phase1_kernel: str = "auto"
    trace: str = ""
    run_dir: str = ""
    log_jsonl: str = ""
    checkpoint_every: int = 0
    checkpoint_dir: str = ""
    resume: bool = False
    progress: bool = True
    distributed: bool = False
    supervise: bool = False
    # Fault scenario (scenario.py): "off", a path to a JSON timeline, or
    # the JSON inline; overlay self-healing in phase 2 (every poll window,
    # live nodes replace friends dead >= heal_detect_ms with a fresh peer
    # and infected healers re-send over the repaired edge).
    scenario: str = "off"
    overlay_heal: str = "off"
    rumors: int = 1
    traffic: str = "oneshot"
    serve: bool = False
    tuning_table: str = "auto"
    # Model family: "si", the reference's 1-bit infection, or "pushsum",
    # PushSum averaging of a fixed-point (value, weight) mass vector over
    # the event engine's mail ring (models/pushsum.py).
    model: str = "si"
    pushsum_dim: int = 2  # value-vector length (1..8)
    pushsum_eps: float = 1e-3  # convergence: max relative error
    # Device-recorded per-window telemetry (utils/telemetry.py): with it
    # an observing run takes the run-to-target paths and replays the
    # recorded windows; "off" keeps the windowed loop.  -telemetry-spatial
    # on adds the group, shard and traffic panels (npz only).
    telemetry: str = "on"
    telemetry_spatial: str = "off"
    telemetry_summary: bool = False
    # torch.profiler around phase 2 (-profile, its Chrome trace into
    # -profile-dir) or around the whole run (-xprof DIR, one
    # record_function a -trace span).
    profile: bool = False
    profile_dir: str = "/tmp/gossip-trace"
    xprof_dir: str = ""
    heal_detect_ms: int = 30
    stream_rate: int = 100
    arrivals: str = "fixed"
    ckpt_keep: int = 0
    run_id: str = ""
    # "double" accepted on -backend sharded: the route stays serial (one
    # process, nothing to overlap), exchange_inflight_hwm reads 2; "auto"
    # resolves to "off".
    exchange_pipeline: str = "auto"
    coordinator: str = ""
    num_processes: int = -1
    process_id: int = -1
    serve_high: float = 0.85
    serve_low: float = 0.10
    serve_window: int = 3
    serve_min_shards: int = 1
    serve_max_shards: int = -1
    serve_force: str = ""
    serve_max_defer: int = 2000
    workers: int = 2
    heartbeat_dir: str = ""
    heartbeat_timeout_ms: int = 30000
    chaos: str = ""
    recover_max_stale: int = 0
    init_timeout_s: int = 60

    # --- derived --------------------------------------------------------------
    @property
    def fanin_resolved(self) -> int:
        if self.fanin >= 0:
            return self.fanin
        return 6 if self.compat_reference else self.fanout + 1

    @property
    def max_degree(self) -> int:
        return max(self.fanout, self.fanin_resolved)

    @property
    def delay_span(self) -> int:
        return self.delayhigh - self.delaylow

    @property
    def er_p_resolved(self) -> float:
        return self.er_p if self.er_p > 0 else self.fanout / max(self.n, 1)

    @property
    def graph_width(self) -> int:
        """Friends-table column count: the Erdős–Rényi generators pad to
        the Poisson tail cap (er_cap); the others hold max_degree."""
        if self.graph == "erdos":
            return er_cap(self.er_p_resolved * self.n)
        return self.max_degree

    @property
    def ring_windows(self) -> int:
        """Window slots of the event engine's (and PushSum's) mail ring at
        full n; a shard's ring is no deeper."""
        return ring_windows_for(self, self.n)

    @property
    def mean_degree(self) -> float:
        """Expected out-degree: the per-node in-flight budget for the event
        engine's exact-size mail reservations."""
        if self.graph == "erdos":
            return self.er_p_resolved * self.n
        return float(self.max_degree)

    @property
    def crashrate_eff(self) -> float:
        """Per-reception crash probability after the compat gate's
        1%-resolution truncation."""
        if self.compat_reference:
            return int(self.crashrate * 100) / 100.0
        return self.crashrate

    @property
    def effective_time_mode(self) -> str:
        return "rounds" if self.protocol == "pushpull" else self.time_mode

    @property
    def compact_resolved(self) -> bool:
        if self.compact == "auto":
            return (self.effective_time_mode == "ticks"
                    and self.protocol != "pushpull")
        return self.compact == "on"

    @property
    def engine_resolved(self) -> str:
        if self.engine == "event":
            return "event"
        if (self.engine == "auto" and self.backend in ("jax", "sharded")
                and self.protocol in ("si", "sir")
                and self.effective_time_mode == "ticks"
                and self.compact == "auto"):
            return "event"
        return "ring"

    @property
    def scenario_resolved(self):
        """The parsed fault Scenario (scenario.OFF when "off"), cached by
        spec."""
        from gossip_simulator_tpu_torch import scenario as _scen

        return _scen.parse(self.scenario)

    @property
    def overlay_heal_resolved(self) -> bool:
        return self.overlay_heal == "on"

    @property
    def faults_enabled(self) -> bool:
        """Whether phase 2 carries the fault machinery (the per-node crash
        clock down_since and the window's fault pass): scenario crash,
        churn or recovery events, or healing, whose dead-friend detection
        reads the same clock."""
        return (self.scenario_resolved.has_faults
                or self.overlay_heal_resolved)

    @property
    def dup_suppress_resolved(self) -> bool:
        """Append-side duplicate suppression: only sound at an effective
        crash rate of 0, never under scenario faults (a scenario crash can
        black-hole a destination before its window drains), and never
        with a rumor axis (an infected node can still gain new rumor
        bits)."""
        if self.dup_suppress == "off" or self.multi_rumor:
            return False
        if self.scenario_resolved.has_faults:
            return False
        return self.crashrate_eff == 0.0

    @property
    def multi_rumor(self) -> bool:
        """Whether the rumor axis materializes (R > 1, or stream
        traffic)."""
        return self.rumors > 1 or self.traffic == "stream"

    @property
    def rumor_word_count(self) -> int:
        """uint32 words in the packed rumor ladder (W = ceil(R/32))."""
        return (self.rumors + 31) // 32 if self.multi_rumor else 1

    @property
    def last_inject_tick(self) -> int:
        """Tick of the final rumor's injection under stream traffic (rumor
        r enters at r * 1000 // stream_rate on the fixed schedule; the
        other arrival processes consult their table); 0 for oneshot."""
        if self.traffic != "stream":
            return 0
        from gossip_simulator_tpu_torch import arrivals as _arrivals

        table = _arrivals.table_or_none(self)
        if table is not None:
            return int(table[-1])
        return (self.rumors - 1) * 1000 // max(self.stream_rate, 1)

    @property
    def deliver_kernel_resolved(self) -> str:
        """"xla" (index_put_) or "pallas" (the fused_unique_set kernel on the
        card, its plain version on the CPU)."""
        return "xla" if self.deliver_kernel == "xla" else "pallas"

    @property
    def phase1_kernel_resolved(self) -> str:
        """"xla" (the unfused slot decisions) or "pallas" (the
        fused_negotiate kernel on the card, its plain version on the
        CPU)."""
        return "xla" if self.phase1_kernel == "xla" else "pallas"

    @property
    def overlay_mode_resolved(self) -> str:
        """Size-banded "auto": the tick-faithful engine ("ticks") at n <=
        OVERLAY_TICKS_AUTO_MAX on tick-semantics runs, the rounds engine
        otherwise."""
        if self.overlay_mode != "auto":
            return self.overlay_mode
        if (self.backend in ("jax", "sharded")
                and self.effective_time_mode != "ticks"):
            return "rounds"
        return "ticks" if self.n <= OVERLAY_TICKS_AUTO_MAX else "rounds"

    @property
    def overlay_adaptive_chunks_resolved(self) -> bool:
        """The split round's occupancy-adaptive chunk-width ladder (result
        neutral: chunk width never changes a mailbox)."""
        return self.overlay_adaptive_chunks != "off"

    @property
    def overlay_dead_skip_resolved(self) -> bool:
        """The split round skips emission rows counted empty at write
        time (result neutral)."""
        return self.overlay_dead_skip != "off"

    def static_boot_for(self, n_rows: int) -> bool:
        """One-shot static bootstrap for a rounds-overlay surface of
        `n_rows` rows: "auto" is on from OVERLAY_STATIC_BOOT_MIN_ROWS."""
        if self.overlay_static_boot != "auto":
            return self.overlay_static_boot == "on"
        return n_rows >= OVERLAY_STATIC_BOOT_MIN_ROWS

    def mailbox_cap_for(self, n_rows: int, *, stacked: bool = False) -> int:
        """Mailbox capacity for a delivery surface of `n_rows` rows: 16,
        or 8 from MAILBOX_CAP_MEMORY_BAND rows on or where cap 16 would
        overflow int32 flat addressing (`stacked`: deliver_pair's [2n,
        cap] buffer)."""
        if self.mailbox_cap > 0:
            return self.mailbox_cap
        if n_rows >= MAILBOX_CAP_MEMORY_BAND:
            return 8
        rows = 2 * n_rows + 1 if stacked else n_rows
        return 16 if flat_addressing_fits(rows, 16) else 8

    @property
    def exchange_pipeline_resolved(self) -> str:
        """An explicit "off" or "double" passes through; "auto" is "off":
        one process holds every shard, so the exchange has no collective
        to overlap (the JAX package's auto picks double on a mesh of
        several devices)."""
        return "double" if self.exchange_pipeline == "double" else "off"

    @property
    def phase2_kernel_resolved(self) -> str:
        """"xla" (the unfused emission chain) or "pallas" (the fused_emit
        kernel on the card, its plain version on the CPU)."""
        return "xla" if self.phase2_kernel == "xla" else "pallas"

    @property
    def checkpointing_enabled(self) -> bool:
        """Snapshots can be written: both -checkpoint-every and
        -checkpoint-dir are set.  The one predicate of every gate that
        keeps the windowed loop for them (the driver's phase gates,
        _Checkpointer's cadence)."""
        return bool(self.checkpoint_every and self.checkpoint_dir)

    @property
    def telemetry_enabled(self) -> bool:
        """Whether the run-to-target loops record a per-window history."""
        return self.telemetry != "off" and self.backend in ("jax", "sharded")

    @property
    def telemetry_spatial_enabled(self) -> bool:
        """Whether they also record the spatial panels (group, shard and
        traffic, utils/telemetry.py) beside each history row."""
        return self.telemetry_spatial == "on" and self.telemetry_enabled

    def resolved_gates(self) -> dict:
        """The resolved gate set, stamped into run artifacts and the
        terminal `result` record, in the JAX package's keys.  The kernel
        gates are this port's resolution ("pallas": the kernel on the
        card, its plain version on the CPU, where the JAX package says
        "xla"); the port has no tuning table ("defaults") and no compile
        budget ("none").  Only trajectory-affecting gates: telemetry and
        the recording flags stay out, so twin runs' records agree."""
        return {
            "engine": self.engine_resolved,
            "overlay_mode": self.overlay_mode_resolved,
            "compact": self.compact_resolved,
            "overlay_adaptive_chunks": self.overlay_adaptive_chunks_resolved,
            "overlay_dead_skip": self.overlay_dead_skip_resolved,
            "overlay_heal": self.overlay_heal_resolved,
            "dup_suppress": self.dup_suppress_resolved,
            "multi_rumor": self.multi_rumor,
            "time_mode": self.effective_time_mode,
            "model": self.model,
            "deliver_kernel": self.deliver_kernel_resolved,
            "phase2_kernel": self.phase2_kernel_resolved,
            "phase1_kernel": self.phase1_kernel_resolved,
            "exchange_pipeline": (self.exchange_pipeline_resolved
                                  if self.backend == "sharded" else "off"),
            "tuning_table": "defaults",
            "compile_budget": "none",
        }

    @property
    def log_jsonl_resolved(self) -> str:
        """JSONL destination: -log-jsonl, else a -run-dir run's own
        metrics.jsonl."""
        if self.log_jsonl:
            return self.log_jsonl
        if self.run_dir:
            return os.path.join(self.run_dir, "metrics.jsonl")
        return ""

    @property
    def trace_resolved(self) -> str:
        """Trace destination: -trace, else a -run-dir run's own
        trace.json."""
        if self.trace:
            return self.trace
        if self.run_dir:
            return os.path.join(self.run_dir, "trace.json")
        return ""

    def validate(self) -> "Config":
        if self.n < 2:
            raise ValueError(f"n must be >= 2, got {self.n}")
        if self.graph == "overlay" and self.n < 3:
            # Breakup replacement excludes two ids (self + leaver).
            raise ValueError("overlay graph requires n >= 3")
        if self.fanout < 1:
            raise ValueError(f"fanout must be >= 1, got {self.fanout}")
        if self.fanin != -1 and self.fanin < 1:
            raise ValueError(
                f"fanin must be >= 1 (or -1=auto), got {self.fanin}")
        if self.delayhigh <= self.delaylow:
            raise ValueError(
                f"delayhigh ({self.delayhigh}) must be > delaylow "
                f"({self.delaylow})")
        if self.delaylow < 0:
            raise ValueError(f"delaylow must be >= 0, got {self.delaylow}")
        if self.delaylow < 1 and self.effective_time_mode == "ticks":
            raise ValueError(
                "delaylow must be >= 1 in ticks mode on the jax/sharded "
                "backends (drawn delays are clamped to >= 1 tick); use "
                "-time-mode rounds or -backend native/cpp for delaylow=0")
        for name in ("droprate", "crashrate", "removal_rate"):
            v = getattr(self, name)
            if not 0.0 <= v <= 1.0:
                raise ValueError(f"{name} must be in [0,1], got {v}")
        if self.backend not in BACKENDS:
            raise ValueError(
                f"backend must be one of {BACKENDS}, got {self.backend!r}")
        if self.protocol not in PROTOCOLS:
            raise ValueError(
                f"protocol must be one of {PROTOCOLS}, "
                f"got {self.protocol!r}")
        if self.graph not in GRAPHS:
            raise ValueError(
                f"graph must be one of {GRAPHS}, got {self.graph!r}")
        if self.time_mode not in TIME_MODES:
            raise ValueError(
                f"time_mode must be one of {TIME_MODES}, "
                f"got {self.time_mode!r}")
        if self.engine not in ENGINES:
            raise ValueError(
                f"engine must be one of {ENGINES}, got {self.engine!r}")
        if self.overlay_mode not in ("auto", "rounds", "ticks"):
            raise ValueError(
                f"overlay_mode must be 'auto', 'rounds' or 'ticks', "
                f"got {self.overlay_mode!r}")
        if (self.overlay_mode == "ticks" and self.graph == "overlay"
                and self.backend in ("jax", "sharded")
                and self.effective_time_mode != "ticks"):
            raise ValueError("-overlay-mode ticks requires -time-mode ticks")
        for name in ("compact", "dup_suppress", "overlay_adaptive_chunks",
                     "overlay_dead_skip", "overlay_static_boot"):
            if getattr(self, name) not in ("auto", "on", "off"):
                raise ValueError(f"{name} must be auto|on|off, "
                                 f"got {getattr(self, name)!r}")
        for name in ("deliver_kernel", "phase2_kernel", "phase1_kernel"):
            if getattr(self, name) not in KERNEL_GATES:
                raise ValueError(f"{name} must be auto|xla|pallas, "
                                 f"got {getattr(self, name)!r}")
        if self.dup_suppress == "on" and self.crashrate_eff > 0.0:
            raise ValueError(
                "-dup-suppress on requires an effective crash rate of 0 "
                "(crash draws are keyed by mailbox position; suppressing "
                "entries would shift every later draw).  Note the "
                "reference's own default crashrate 0.001 IS 0 under "
                "-compat-reference (1%-resolution truncation).")
        if not 0.0 < self.coverage_target <= 1.0:
            raise ValueError(
                f"coverage_target must be in (0,1], "
                f"got {self.coverage_target}")
        if self.max_rounds < 1:
            raise ValueError(
                f"max_rounds must be >= 1, got {self.max_rounds}")
        if self.ckpt_keep < 0:
            raise ValueError(f"ckpt_keep must be >= 0, got {self.ckpt_keep}")
        if self.resume:
            if not self.checkpoint_dir:
                raise ValueError("-resume requires -checkpoint-dir")
            if self.backend not in ("jax", "sharded"):
                raise ValueError(
                    "-resume requires backend=jax or sharded")
        if self.fanout >= self.n:
            raise ValueError(
                f"fanout ({self.fanout}) must be < n ({self.n})")
        if self.engine == "event" and (
                self.protocol not in ("si", "sir")
                or self.effective_time_mode != "ticks"):
            raise ValueError(
                "engine=event supports protocol=si|sir in ticks mode only")
        if self.telemetry not in ("on", "off"):
            raise ValueError(
                f"telemetry must be on|off, got {self.telemetry!r}")
        if self.telemetry_spatial not in ("on", "off"):
            raise ValueError(f"telemetry_spatial must be on|off, got "
                             f"{self.telemetry_spatial!r}")
        if self.telemetry_spatial == "on" and self.telemetry == "off":
            raise ValueError(
                "-telemetry-spatial on records panels on the telemetry "
                "fast path; it cannot run with -telemetry off")
        if (self.telemetry_spatial == "on"
                and self.backend not in ("jax", "sharded")):
            raise ValueError(
                "-telemetry-spatial needs a device-side loop to record "
                f"panels; backend {self.backend!r} has none")
        self._validate_rumors()
        self._validate_pushsum()
        self._validate_faults()
        self._reject_unported()
        return self

    def _validate_rumors(self) -> None:
        """The JAX package's multi-rumor rules (single device)."""
        if not 1 <= self.rumors <= 1024:
            raise ValueError(
                f"rumors must be in [1, 1024], got {self.rumors}")
        if self.traffic not in ("oneshot", "stream"):
            raise ValueError(
                f"traffic must be oneshot|stream, got {self.traffic!r}")
        if self.multi_rumor:
            if self.backend not in ("jax", "sharded"):
                raise ValueError(
                    "-rumors > 1 / -traffic stream require backend=jax or "
                    "sharded (the discrete-event oracles are single-rumor)")
            if self.protocol != "si":
                raise ValueError(
                    "-rumors > 1 / -traffic stream support protocol=si only "
                    "(SIR removal and push-pull digests are single-rumor)")
            if self.effective_time_mode != "ticks":
                raise ValueError(
                    "-rumors > 1 / -traffic stream require -time-mode ticks")
            if self.compat_reference:
                raise ValueError(
                    "-compat-reference is strictly single-rumor (the "
                    "reference broadcasts exactly one rumor per run)")
            if self.dup_suppress == "on":
                raise ValueError(
                    "-dup-suppress on is unsound with a rumor axis: an "
                    "already-infected destination can still gain new rumor "
                    "bits, so 'guaranteed duplicate' edges carry information")
            if self.engine_resolved == "ring":
                if self.backend == "sharded":
                    raise ValueError(
                        "-rumors > 1 on the ring engine is single-device "
                        "only (use -engine event for -backend sharded)")
                if self.overlay_heal_resolved:
                    raise ValueError(
                        "-overlay-heal with -rumors > 1 requires the event "
                        "engine (ring-engine heal re-sends are single-rumor)")
        if self.traffic == "stream":
            if not 1 <= self.stream_rate <= 1_000_000:
                # The upper bound keeps the injection schedule's clamped
                # tick * rate product in int32 (event.injection_batch).
                raise ValueError(
                    f"stream_rate must be in [1, 1000000], got "
                    f"{self.stream_rate}")
            if self.engine_resolved != "event":
                raise ValueError(
                    "-traffic stream requires the event engine (the jitted "
                    "injection schedule rides the event window step)")

    def _validate_pushsum(self) -> None:
        """The JAX package's numeric-gossip rules, as written there."""
        if self.model not in ("si", "pushsum"):
            raise ValueError(
                f"model must be si|pushsum, got {self.model!r}")
        if self.model != "pushsum":
            return
        if self.backend not in ("jax", "sharded"):
            raise ValueError(
                "-model pushsum requires backend=jax or sharded (the "
                "discrete-event oracles are 1-bit SI only)")
        if self.graph not in ("kout", "erdos"):
            raise ValueError(
                "-model pushsum supports -graph kout|erdos (the rounds "
                "overlay build has no numeric state to average)")
        if self.protocol != "si":
            raise ValueError(
                "-model pushsum replaces the infection protocol; use "
                "the default -protocol si")
        if self.effective_time_mode != "ticks":
            raise ValueError("-model pushsum requires -time-mode ticks")
        if self.engine_resolved != "event":
            raise ValueError(
                "-model pushsum rides the event-engine mail ring; "
                "leave -engine auto/event")
        if self.multi_rumor or self.traffic != "oneshot":
            raise ValueError(
                "-model pushsum is incompatible with -rumors > 1 / "
                "-traffic stream (mass columns replace the rumor words)")
        if self.compat_reference:
            raise ValueError(
                "-compat-reference is strictly 1-bit SI; it has no "
                "PushSum surface")
        if self.dup_suppress == "on":
            raise ValueError(
                "-dup-suppress on is meaningless under -model pushsum: "
                "every delivery carries fresh mass, nothing is a "
                "guaranteed duplicate")
        if self.droprate != 0.0:
            raise ValueError(
                "-model pushsum requires droprate 0 (a dropped message "
                "destroys mass and breaks the conservation invariant; "
                "model lossy links with -scenario partitions instead, "
                "which block at send time)")
        if self.crashrate != 0.0:
            raise ValueError(
                "-model pushsum requires crashrate 0 (per-reception "
                "crashes black-hole in-flight mass; use -scenario "
                "crash/churn events -- crashed nodes park mass and "
                "rejoin with it)")
        if self.serve:
            raise ValueError("-serve streams rumors; it has no "
                             "pushsum surface")
        if not 1 <= self.pushsum_dim <= 8:
            raise ValueError(
                f"pushsum_dim must be in [1, 8], got {self.pushsum_dim}")
        if not self.pushsum_eps > 0.0:
            raise ValueError(
                f"pushsum_eps must be > 0, got {self.pushsum_eps}")

    def _validate_faults(self) -> None:
        """The JAX package's fault-scenario and healing rules, as written
        there."""
        scen = self.scenario_resolved  # raises ValueError on a bad spec
        if scen.active:
            if self.backend not in ("jax", "sharded"):
                raise ValueError(
                    "-scenario requires backend=jax or sharded (the "
                    "discrete-event oracles have no fault timeline)")
            if self.protocol == "pushpull":
                raise ValueError(
                    "-scenario supports protocol=si|sir (push-pull has "
                    "no send-time wave for the partition mask to filter)")
            if scen.groups > self.n:
                raise ValueError(
                    f"scenario groups ({scen.groups}) cannot exceed n "
                    f"({self.n})")
            if self.dup_suppress == "on" and scen.has_faults:
                raise ValueError(
                    "-dup-suppress on is unsound under scenario faults: "
                    "a banked duplicate credit assumes delivery to a "
                    "live node, but a scenario crash can black-hole the "
                    "destination before its window drains")
        if self.overlay_heal not in ("on", "off"):
            raise ValueError(
                f"overlay_heal must be on|off, got {self.overlay_heal!r}")
        if self.overlay_heal_resolved:
            if self.backend not in ("jax", "sharded"):
                raise ValueError(
                    "-overlay-heal requires backend=jax or sharded")
            if self.protocol == "pushpull":
                raise ValueError(
                    "-overlay-heal is meaningless for push-pull (fresh "
                    "random peers every round; there is no friends table "
                    "to repair)")
        if self.heal_detect_ms < 0:
            raise ValueError(
                f"heal_detect_ms must be >= 0, got {self.heal_detect_ms}")

    def _reject_unported(self) -> None:
        """Name every flag value outside the ported slices."""
        if self.backend in ("native", "cpp"):
            raise NotYetPorted(f"-backend {self.backend}", "A16")
        if self.distributed:
            raise NotYetPorted("-distributed", "A13")
        if self.graph == "overlay" and self.backend != "sharded":
            # The sharded overlays run node-major per shard at any n; a
            # shard's mailbox checks its own addressing when it delivers.
            self._reject_unported_overlay()
        defaults = Config()
        for name, (flag, item) in UNPORTED_FLAGS.items():
            value = getattr(self, name)
            if value != getattr(defaults, name):
                raise NotYetPorted(f"{flag} {value}", item)

    def _reject_unported_overlay(self) -> None:
        """Ported: the rounds overlay's three bands and the tick-faithful
        engine's node-major band."""
        if self.overlay_mode_resolved == "rounds":
            cap = self.mailbox_cap_for(self.n)
            if not flat_addressing_fits(self.n, cap):
                raise NotYetPorted(
                    f"the rounds overlay at n = {self.n} with mailbox cap "
                    f"{cap} (past int32 flat mailbox addressing: the dense "
                    "2-D delivery fallback)", "A18")
            return
        if self.n >= TICKS_SLOTMAJOR_MIN_ROWS:
            raise NotYetPorted(
                "the slot-major band of the tick-faithful overlay "
                f"(-overlay-mode ticks at n >= {TICKS_SLOTMAJOR_MIN_ROWS:,})",
                "A17")
        cap = self.mailbox_cap_for(self.n, stacked=True)
        if not flat_addressing_fits(2 * self.n + 1, cap):
            raise NotYetPorted(
                f"-mailbox-cap {cap} at n = {self.n} (past stacked int32 "
                "addressing: the two-pass delivery fallback)", "A18")

    def parameter_dump(self) -> str:
        """Reference-format parameter dump: flags alphabetically, `ms` on
        the delay flags."""
        ref = {
            "crashrate": self.crashrate,
            "delayhigh": f"{self.delayhigh}ms",
            "delaylow": f"{self.delaylow}ms",
            "droprate": self.droprate,
            "fanin": self.fanin_resolved,
            "fanout": self.fanout,
            "n": self.n,
        }
        lines = ["=== Parameters ==="]
        lines += [f"{k}={v}" for k, v in sorted(ref.items())]
        return "\n".join(lines)


# Fields whose value away from the default is not yet ported: the flag's
# spelling and the ROADMAP item that ports it.
UNPORTED_FLAGS = {
    "coordinator": ("-coordinator", "A13"),
    "num_processes": ("-num-processes", "A13"),
    "process_id": ("-process-id", "A13"),
    "serve": ("-serve", "A14"),
    "serve_high": ("-serve-high", "A14"),
    "serve_low": ("-serve-low", "A14"),
    "serve_window": ("-serve-window", "A14"),
    "serve_min_shards": ("-serve-min-shards", "A14"),
    "serve_max_shards": ("-serve-max-shards", "A14"),
    "serve_force": ("-serve-force", "A14"),
    "serve_max_defer": ("-serve-max-defer", "A14"),
    "supervise": ("-supervise", "A14"),
    "workers": ("-workers", "A14"),
    "heartbeat_dir": ("-heartbeat-dir", "A14"),
    "heartbeat_timeout_ms": ("-heartbeat-timeout-ms", "A14"),
    "chaos": ("-chaos", "A14"),
    "recover_max_stale": ("-recover-max-stale", "A14"),
    "init_timeout_s": ("-init-timeout", "A14"),
    "tuning_table": ("-tuning-table", "A15"),
}


def _flag(p, name, **kw):
    p.add_argument(f"-{name}", f"--{name}", **kw)


def _build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="gossip-sim-torch",
        description="PyTorch/CUDA port of the gossip/epidemic simulator "
        "(the tick-faithful and rounds overlays and static graphs, then "
        "the event or the ring engine; see ROADMAP.md for what is not yet "
        "ported).")
    d = Config()
    _flag(p, "n", type=int, default=d.n, help="total number of nodes")
    _flag(p, "fanout", type=int, default=d.fanout, help="fanout")
    _flag(p, "fanin", type=int, default=-1,
          help="fanin (default: fanout+1; reference defaults to the "
               "constant 6)")
    _flag(p, "delaylow", type=int, default=d.delaylow, help="delay low (ms)")
    _flag(p, "delayhigh", type=int, default=d.delayhigh,
          help="delay high (ms)")
    _flag(p, "droprate", type=float, default=d.droprate,
          help="message drop rate")
    _flag(p, "crashrate", type=float, default=d.crashrate,
          help="machine crash rate")
    _flag(p, "backend", choices=BACKENDS, default=d.backend,
          help="jax = the single-device stepper, sharded = S shards laid "
               "out on one device")
    _flag(p, "protocol", choices=PROTOCOLS, default=d.protocol)
    _flag(p, "graph", choices=GRAPHS, default=d.graph)
    _flag(p, "seed", type=int, default=d.seed)
    _flag(p, "max-rounds", dest="max_rounds", type=int, default=d.max_rounds)
    _flag(p, "coverage-target", dest="coverage_target", type=float,
          default=d.coverage_target)
    _flag(p, "time-mode", dest="time_mode", choices=TIME_MODES,
          default=d.time_mode)
    _flag(p, "removal-rate", dest="removal_rate", type=float,
          default=d.removal_rate)
    _flag(p, "er-p", dest="er_p", type=float, default=d.er_p,
          help="Erdos-Renyi edge probability (-graph erdos; <= 0: fanout/n)")
    _flag(p, "compat-reference", dest="compat_reference",
          action="store_true")
    _flag(p, "mailbox-cap", dest="mailbox_cap", type=int,
          default=d.mailbox_cap,
          help="overlay mailbox capacity per node (-1 = auto: 16, or 8 at "
               "32M rows and above)")
    _flag(p, "pallas", action="store_true",
          help="static graphs through the kout_pallas and erdos_pallas "
               "generator kernels (plain versions on the CPU)")
    _flag(p, "compact", choices=("auto", "on", "off"), default=d.compact)
    _flag(p, "compact-chunk", dest="compact_chunk", type=int,
          default=d.compact_chunk,
          help="overlay delivery chunk in lanes (-1 = auto)")
    _flag(p, "engine", choices=ENGINES, default=d.engine)
    _flag(p, "event-slot-cap", dest="event_slot_cap", type=int,
          default=d.event_slot_cap)
    _flag(p, "event-chunk", dest="event_chunk", type=int,
          default=d.event_chunk)
    _flag(p, "dup-suppress", dest="dup_suppress",
          choices=("auto", "on", "off"), default=d.dup_suppress,
          help="suppress guaranteed-duplicate sends at append (crash rate "
               "0 only; auto = on whenever sound)")
    _flag(p, "overlay-mode", dest="overlay_mode",
          choices=("auto", "rounds", "ticks"), default=d.overlay_mode)
    _flag(p, "overlay-adaptive-chunks", dest="overlay_adaptive_chunks",
          choices=("auto", "on", "off"), default=d.overlay_adaptive_chunks,
          help="occupancy-adaptive hosted-delivery chunk ladder for the "
               "split-round overlay (result neutral; auto = on)")
    _flag(p, "overlay-dead-skip", dest="overlay_dead_skip",
          choices=("auto", "on", "off"), default=d.overlay_dead_skip,
          help="skip dead emission rows via counts carried across rounds "
               "(split-round overlay; result neutral; auto = on)")
    _flag(p, "overlay-static-boot", dest="overlay_static_boot",
          choices=("auto", "on", "off"), default=d.overlay_static_boot,
          help="one-shot bootstrap burst for the rounds overlay (auto = on "
               "at >= 32M rows; off is the staggered per-round schedule)")
    _flag(p, "deliver-kernel", dest="deliver_kernel", choices=KERNEL_GATES,
          default=d.deliver_kernel,
          help="ring writes, mailbox delivery and ring-engine deposits: "
               "pallas/auto = the fused_unique_set, fused_ring_append, "
               "fused_chunk_step, fused_deposit_add and fused_deposit_rows "
               "kernels (plain versions on the CPU; PushSum's chunked "
               "drain deposits through fused_deposit_rows), xla = the "
               "unfused chains")
    _flag(p, "phase2-kernel", dest="phase2_kernel", choices=KERNEL_GATES,
          default=d.phase2_kernel,
          help="emission, the ring engine's multi-rumor deposit and "
               "PushSum's drain: pallas/auto = the fused_emit, "
               "fused_deposit_both and fused_drain_sum kernels (plain "
               "versions on the CPU), xla = the unfused chains")
    _flag(p, "phase1-kernel", dest="phase1_kernel", choices=KERNEL_GATES,
          default=d.phase1_kernel,
          help="overlay slot decisions: pallas/auto = the fused_negotiate, "
               "fused_request_round and fused_hosted_chunk kernels (plain "
               "versions on the CPU), xla = the unfused chains")
    _flag(p, "exchange-pipeline", dest="exchange_pipeline",
          choices=("auto", "off", "double"), default=d.exchange_pipeline)
    _flag(p, "telemetry", choices=("on", "off"), default=d.telemetry,
          help="on: the run-to-target paths record every poll window "
               "on the device and replay it through the printer; off: the "
               "windowed loop")
    _flag(p, "telemetry-spatial", dest="telemetry_spatial",
          choices=("on", "off"), default=d.telemetry_spatial)
    _flag(p, "telemetry-summary", dest="telemetry_summary",
          action="store_true")
    _flag(p, "scenario", default=d.scenario)
    _flag(p, "overlay-heal", dest="overlay_heal", choices=("on", "off"),
          default=d.overlay_heal)
    _flag(p, "heal-detect-ms", dest="heal_detect_ms", type=int,
          default=d.heal_detect_ms)
    _flag(p, "rumors", type=int, default=d.rumors)
    _flag(p, "traffic", choices=("oneshot", "stream"), default=d.traffic)
    _flag(p, "stream-rate", dest="stream_rate", type=int,
          default=d.stream_rate)
    _flag(p, "serve", action="store_true")
    _flag(p, "arrivals", choices=("fixed", "poisson", "burst", "diurnal"),
          default=d.arrivals)
    _flag(p, "serve-high", dest="serve_high", type=float,
          default=d.serve_high)
    _flag(p, "serve-low", dest="serve_low", type=float, default=d.serve_low)
    _flag(p, "serve-window", dest="serve_window", type=int,
          default=d.serve_window)
    _flag(p, "serve-min-shards", dest="serve_min_shards", type=int,
          default=d.serve_min_shards)
    _flag(p, "serve-max-shards", dest="serve_max_shards", type=int,
          default=d.serve_max_shards)
    _flag(p, "serve-force", dest="serve_force", default=d.serve_force)
    _flag(p, "serve-max-defer", dest="serve_max_defer", type=int,
          default=d.serve_max_defer)
    _flag(p, "ckpt-keep", dest="ckpt_keep", type=int, default=d.ckpt_keep)
    _flag(p, "model", choices=("si", "pushsum"), default=d.model,
          help="model family: si = the reference's 1-bit infection; "
               "pushsum = numeric PushSum averaging (nodes push half "
               "their (value, weight) mass to friends each window; "
               "delivery is a scatter-add; the run converges when every "
               "live node's estimate is within -pushsum-eps of the true "
               "mean)")
    _flag(p, "pushsum-dim", dest="pushsum_dim", type=int,
          default=d.pushsum_dim, help="pushsum value-vector length (1..8)")
    _flag(p, "pushsum-eps", dest="pushsum_eps", type=float,
          default=d.pushsum_eps,
          help="pushsum convergence threshold: max relative error of any "
               "live node's estimate vs the true network mean")
    _flag(p, "tuning-table", dest="tuning_table", default=d.tuning_table)
    _flag(p, "profile", action="store_true")
    _flag(p, "profile-dir", dest="profile_dir", default=d.profile_dir)
    _flag(p, "trace", default=d.trace)
    _flag(p, "xprof", dest="xprof_dir", default=d.xprof_dir)
    _flag(p, "run-dir", dest="run_dir", default=d.run_dir)
    _flag(p, "log-jsonl", dest="log_jsonl", default=d.log_jsonl)
    _flag(p, "checkpoint-every", dest="checkpoint_every", type=int,
          default=0)
    _flag(p, "checkpoint-dir", dest="checkpoint_dir", default="")
    _flag(p, "resume", action="store_true")
    _flag(p, "quiet", action="store_true",
          help="suppress per-window progress lines")
    _flag(p, "distributed", action="store_true")
    _flag(p, "coordinator", default=d.coordinator)
    _flag(p, "num-processes", dest="num_processes", type=int,
          default=d.num_processes)
    _flag(p, "process-id", dest="process_id", type=int, default=d.process_id)
    _flag(p, "supervise", action="store_true")
    _flag(p, "workers", type=int, default=d.workers)
    _flag(p, "heartbeat-dir", dest="heartbeat_dir", default=d.heartbeat_dir)
    _flag(p, "heartbeat-timeout-ms", dest="heartbeat_timeout_ms", type=int,
          default=d.heartbeat_timeout_ms)
    _flag(p, "chaos", default=d.chaos)
    _flag(p, "recover-max-stale", dest="recover_max_stale", type=int,
          default=d.recover_max_stale)
    _flag(p, "run-id", dest="run_id", default=d.run_id)
    _flag(p, "init-timeout", dest="init_timeout_s", type=int,
          default=d.init_timeout_s)
    _flag(p, "device", choices=DEVICES, default="cuda",
          help="where the run executes: cuda (default; raises when there "
               "is no card) or cpu")
    return p


def parse_cli(argv: Optional[list[str]] = None) -> tuple[Config, str]:
    """(validated Config, device name) from the command line."""
    kw = vars(_build_parser().parse_args(argv))
    kw["progress"] = not kw.pop("quiet")
    device = kw.pop("device")
    return Config(**kw).validate(), device


def parse_args(argv: Optional[list[str]] = None) -> Config:
    return parse_cli(argv)[0]
