"""Fault-injection scenarios: dynamic churn, crash waves, recovery and
partition masks over simulated time, and the overlay's self-healing pass.

The port's copy of the JAX package's ``scenario.py``, trimmed to torch.
The reference's fault model is static -- a fixed per-send drop rate and a
per-reception crash that black-holes a node forever (simulator.go:144,
179-184).  A scenario adds a small timeline of events on the simulated
clock, which every engine applies inside its step.

Config surface: ``-scenario off`` (default: no fault machinery at all), a
path to a JSON timeline file, or the JSON itself inline.  Schema::

    {
      "groups":   4,        # node groups: contiguous global-id ranges
      "downtime": 500,      # ms until a crashed node reboots (0=permanent)
      "events": [
        {"type": "crash",     "at": 100, "frac": 0.05, "group": 2},
        {"type": "churn",     "start": 0, "end": 2000, "rate": 0.2},
        {"type": "partition", "start": 500, "end": 900, "group": 0}
      ]
    }

* ``crash``: one-shot wave at tick ``at``: each live node (in ``group``,
  or everywhere with group omitted/-1) crashes with probability ``frac``.
* ``churn``: steady churn over [start, end): each live node crashes with
  probability ``rate`` per 1000 simulated ms.
* ``partition``: a message whose SEND tick falls in [start, end) and
  whose (src, dst) groups are split is dropped (counted in
  ``Stats.part_dropped``).  With ``group`` set, that group is isolated
  from the rest; with -1/omitted, all cross-group traffic is blocked.

Recovery (``downtime`` > 0) revives every crash -- scenario crashes and
per-reception crashes alike -- ``downtime`` ms after it happened.  A
recovered node rejoins live and susceptible (its received bit, if it had
one, is kept); nobody re-sends to it unless ``-overlay-heal on`` repairs
edges toward it (``models/overlay.heal_dead_friends``).

Every draw is keyed on (seed, window or tick, OP_SCENARIO / OP_HEAL /
OP_HEAL_SEND, event index, GLOBAL node id), as in the JAX package, so a
run here draws the JAX package's values bit for bit (``utils/rng.py``).
The float thresholds are float32, as XLA takes the JAX package's Python
floats: ``u < float32(frac)`` for a crash wave, and the churn probability
``float32(overlap) * float32(rate / 1000)`` multiplied in float32.
Draws whose outcome cannot matter (a wave outside its window, the
replacement and drop draws of rows with nothing to heal) are skipped:
each row's value depends on its own key only, so skipping changes no
other row's.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import os

import torch

from gossip_simulator_tpu_torch.utils import rng as _rng

I32 = torch.int32
I64 = torch.int64
F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class CrashEvent:
    at: int  # tick the wave fires
    frac: float  # per-node crash probability
    group: int = -1  # restrict to one group (-1 = all nodes)


@dataclasses.dataclass(frozen=True)
class ChurnEvent:
    start: int  # [start, end) active window, ticks
    end: int
    rate: float  # expected churned fraction per 1000 simulated ms
    group: int = -1


@dataclasses.dataclass(frozen=True)
class PartitionEvent:
    start: int  # [start, end) send-tick window, ticks
    end: int
    group: int = -1  # isolate this group (-1 = block ALL cross-group)


@dataclasses.dataclass(frozen=True)
class Scenario:
    """Parsed, validated fault timeline; ``OFF`` (the empty Scenario) runs
    no fault machinery."""

    crashes: tuple[CrashEvent, ...] = ()
    churns: tuple[ChurnEvent, ...] = ()
    partitions: tuple[PartitionEvent, ...] = ()
    groups: int = 1
    downtime: int = 0  # ticks until reboot; 0 = crashes stay permanent

    @property
    def has_faults(self) -> bool:
        """Any crash, churn or recovery machinery in the step (the gate for
        the window's fault pass and the down_since array)."""
        return bool(self.crashes or self.churns) or self.downtime > 0

    @property
    def has_partitions(self) -> bool:
        return bool(self.partitions)

    @property
    def active(self) -> bool:
        return self.has_faults or self.has_partitions

    def validate(self) -> "Scenario":
        if self.groups < 1:
            raise ValueError(f"scenario groups must be >= 1, got "
                             f"{self.groups}")
        if self.downtime < 0:
            raise ValueError(f"scenario downtime must be >= 0, got "
                             f"{self.downtime}")
        for e in self.crashes:
            if e.at < 0:
                raise ValueError(f"crash event at={e.at} must be >= 0")
            if not 0.0 <= e.frac <= 1.0:
                raise ValueError(f"crash frac must be in [0,1], got "
                                 f"{e.frac}")
        for e in self.churns:
            if e.end <= e.start or e.start < 0:
                raise ValueError(
                    f"churn window [{e.start},{e.end}) must be nonempty "
                    "and nonnegative")
            if not 0.0 <= e.rate <= 1000.0:
                raise ValueError(f"churn rate must be in [0,1000], got "
                                 f"{e.rate}")
        for e in self.partitions:
            if e.end <= e.start or e.start < 0:
                raise ValueError(
                    f"partition window [{e.start},{e.end}) must be "
                    "nonempty and nonnegative")
        for e in (*self.crashes, *self.churns, *self.partitions):
            if e.group != -1 and not 0 <= e.group < self.groups:
                raise ValueError(
                    f"event group {e.group} outside [0, {self.groups})")
        if self.partitions and self.groups < 2:
            raise ValueError(
                "partition events need scenario groups >= 2 (a 1-group "
                "world has no cross-group traffic to block)")
        return self


OFF = Scenario()


@functools.lru_cache(maxsize=32)
def parse(spec: str) -> Scenario:
    """``off``/empty -> the inert Scenario; otherwise inline JSON (starts
    with ``{``) or a path to a JSON timeline file.  Raises ValueError with
    the JAX package's messages on anything malformed."""
    if not spec or spec == "off":
        return OFF
    if spec.lstrip().startswith("{"):
        try:
            raw = json.loads(spec)
        except json.JSONDecodeError as e:
            raise ValueError(f"-scenario inline JSON is invalid: {e}")
    else:
        if not os.path.exists(spec):
            raise ValueError(
                f"-scenario {spec!r} is neither 'off', inline JSON, nor "
                "an existing timeline file")
        with open(spec) as f:
            try:
                raw = json.load(f)
            except json.JSONDecodeError as e:
                raise ValueError(f"-scenario file {spec} is invalid "
                                 f"JSON: {e}")
    if not isinstance(raw, dict):
        raise ValueError("-scenario JSON must be an object "
                         "{groups, downtime, events}")
    known = {"groups", "downtime", "events"}
    extra = set(raw) - known
    if extra:
        raise ValueError(f"-scenario: unknown keys {sorted(extra)}")
    crashes, churns, partitions = [], [], []
    for i, ev in enumerate(raw.get("events", [])):
        if not isinstance(ev, dict) or "type" not in ev:
            raise ValueError(f"-scenario events[{i}] needs a 'type'")
        t = ev["type"]
        try:
            if t == "crash":
                crashes.append(CrashEvent(
                    at=int(ev["at"]), frac=float(ev["frac"]),
                    group=int(ev.get("group", -1))))
            elif t == "churn":
                churns.append(ChurnEvent(
                    start=int(ev["start"]), end=int(ev["end"]),
                    rate=float(ev["rate"]),
                    group=int(ev.get("group", -1))))
            elif t == "partition":
                partitions.append(PartitionEvent(
                    start=int(ev["start"]), end=int(ev["end"]),
                    group=int(ev.get("group", -1))))
            else:
                raise ValueError(
                    f"-scenario events[{i}]: unknown type {t!r} "
                    "(crash|churn|partition)")
        except KeyError as e:
            raise ValueError(f"-scenario events[{i}] ({t}) is missing "
                             f"field {e}")
    return Scenario(
        crashes=tuple(crashes), churns=tuple(churns),
        partitions=tuple(partitions),
        groups=int(raw.get("groups", 1)),
        downtime=int(raw.get("downtime", 0))).validate()


# RNG op tags of the scenario draws (crash waves, churn) and the healing
# pass (replacement draws, repaired-edge re-sends), as in the JAX package.
OP_SCENARIO = 12
OP_HEAL = 13
OP_HEAL_SEND = 14


def group_size(scen: Scenario, n: int) -> int:
    """Nodes per group: contiguous global-id ranges (ceil, so the last
    group absorbs the remainder)."""
    return -(-n // scen.groups)


def group_of(scen: Scenario, n: int, ids):
    return torch.div(ids, group_size(scen, n), rounding_mode="floor")


def _event_keys(base_key, window_idx, idx: int):
    """Key of scenario event `idx` in window `window_idx` (row keys are
    derived per GLOBAL id by the caller)."""
    return _rng.fold_in(_rng.tick_key(base_key, window_idx, OP_SCENARIO),
                        idx)


def _row_uniform(key, rows) -> torch.Tensor:
    """One float32 uniform[0, 1) per GLOBAL row id."""
    return _rng.uniform(_rng.row_keys(key, rows), ())


def _f32(x: float, dev) -> torch.Tensor:
    """A Python float as XLA takes it beside a float32 array."""
    return torch.tensor(x, dtype=F32, device=dev)


def fault_window(scen: Scenario, n: int, tick0: int, nticks: int,
                 ids_global, crashed, down_since, base_key):
    """The scenario's crash, churn and recovery timeline over the window
    [tick0, tick0 + nticks).

    `crashed` is the caller's bool[n_local] view, `down_since` the int32
    crash ticks (-1 = not crashed).  Returns ``(new_crash, recover,
    down_since', d_crashed, d_recovered)``: masks and int64 0-d counts.
    Recovery comes first (a node whose downtime ends this window is live
    again and exposed to this window's draws), then the crash draws on
    live nodes.  The window index is tick0 // nticks."""
    dev = crashed.device
    widx = tick0 // nticks
    if scen.downtime > 0:
        recover = crashed & (down_since >= 0) & (
            tick0 >= down_since + scen.downtime)
        crashed = crashed & ~recover
        # Reboot marker -(t + 2): reads as live to recovery and detection,
        # distinct from the never-crashed -1; the healing pass's rejoin
        # pull consumes it.
        down_since = torch.where(recover, torch.tensor(
            -(tick0 + 2), dtype=I32, device=dev), down_since)
    else:
        recover = torch.zeros_like(crashed)
    hit = torch.zeros_like(crashed)
    gid = group_of(scen, n, ids_global) if scen.groups > 1 else None
    t1 = tick0 + nticks
    for i, e in enumerate(scen.crashes):
        if not tick0 <= e.at < t1:
            continue  # the wave does not fire: no node is hit
        u = _row_uniform(_event_keys(base_key, widx, i), ids_global)
        m = u < _f32(e.frac, dev)
        if e.group >= 0:
            m = m & (gid == e.group)
        hit = hit | m
    base = len(scen.crashes)
    for i, e in enumerate(scen.churns):
        # Expected per-tick hazard rate/1000; the window draw uses the
        # overlap-scaled probability.
        overlap = max(min(t1, e.end) - max(tick0, e.start), 0)
        if overlap == 0:
            continue  # p = 0: no uniform in [0, 1) is below it
        p = _f32(float(overlap), dev) * _f32(e.rate / 1000.0, dev)
        u = _row_uniform(_event_keys(base_key, widx, base + i), ids_global)
        m = u < p
        if e.group >= 0:
            m = m & (gid == e.group)
        hit = hit | m
    new_crash = hit & ~crashed
    down_since = torch.where(new_crash, torch.tensor(
        tick0, dtype=I32, device=dev), down_since)
    return (new_crash, recover, down_since, new_crash.sum(dtype=I64),
            recover.sum(dtype=I64))


def partition_blocked(scen: Scenario, n: int, send_tick, src_gids,
                      dst_gids) -> torch.Tensor:
    """bool mask, True where a send from src to dst at `send_tick` crosses
    an active partition (send-time semantics).  `send_tick` broadcasts
    against the id tensors (an int, or per-sender ticks); dst < 0 lanes
    (padding) come back False."""
    src_gids = torch.as_tensor(src_gids)
    dst_gids = torch.as_tensor(dst_gids)
    shape = torch.broadcast_shapes(src_gids.shape, dst_gids.shape)
    blocked = torch.zeros(shape, dtype=torch.bool, device=dst_gids.device)
    # A scalar send tick outside an event's window blocks nothing.
    events = [e for e in scen.partitions if not isinstance(send_tick, int)
              or e.start <= send_tick < e.end]
    if not events:
        return blocked
    gs = group_of(scen, n, src_gids)
    gd = group_of(scen, n, torch.clamp_min(dst_gids, 0))
    for e in events:
        live = (send_tick >= e.start) & (send_tick < e.end)
        if e.group >= 0:
            cross = (gs == e.group) != (gd == e.group)
        else:
            cross = gs != gd
        blocked = blocked | (cross & live)
    return blocked & (dst_gids >= 0)


# Packed per-node bits of the healing pass: the detector's verdict and
# "carries the rumor and can answer a rejoin pull".
HEAL_DEAD = 1  # detect_dead verdict
HEAL_INFECTIVE = 2  # infected & live (& not SIR-removed)


def heal_peer_bits(detected, infective) -> torch.Tensor:
    return (detected.to(torch.uint8) * HEAL_DEAD
            + infective.to(torch.uint8) * HEAL_INFECTIVE)


def _rows_of(mask) -> torch.Tensor:
    """The int32 ids of the True rows of a (n,) or (n, k) mask (one host
    read)."""
    if mask.dim() == 2:
        mask = mask.any(dim=1)
    return torch.nonzero(mask).flatten().to(I32)


def _row_mask(key, p: float, rows, ids_global, k: int) -> torch.Tensor:
    """row_bernoulli(key, p, ids_global, k), drawn for the local `rows`
    only (the other rows read False)."""
    out = torch.zeros((ids_global.shape[0], k), dtype=torch.bool,
                      device=ids_global.device)
    if rows.numel():
        out[rows.long()] = _rng.row_bernoulli(key, p,
                                              ids_global[rows.long()], k)
    return out


def heal_and_wave(cfg, friends, friend_cnt, peer_bits_global, healer_ok,
                  sender_inf, rejoined, ids_global, tick: int, base_key):
    """One healing pass (every poll window under ``-overlay-heal on``):

    1. REPAIR: replace detector-condemned friends through the phase-1
       makeup draw (``overlay.heal_dead_friends``).
    2. RE-SEND: an infected healer re-broadcasts the rumor over each
       repaired edge.
    3. REJOIN PULL: a node carrying the reboot marker asks its friends for
       the rumor; each live infected friend's response is a delayed
       delivery back to the rejoined node.

    Re-sends and pull responses are network traffic: per-link drop draws,
    one delay a node, and the partition mask; draws are (tick, GLOBAL
    id)-keyed.  Returns ``(friends', resend[n, k], pull[n, k], delay[n],
    down_clear[n], repaired, partition_blocked)``; `pull` marks friend
    lanes whose response delivers to the lane's own row, `down_clear` the
    consumed reboot markers; the counts are int64 0-d."""
    from gossip_simulator_tpu_torch.models import overlay as _ov

    n = cfg.n
    n_rows, k = friends.shape
    dev = friends.device
    detected_global = (peer_bits_global & HEAL_DEAD) > 0
    hk = _rng.tick_key(base_key, tick, OP_HEAL)
    friends, dead, repaired = _ov.heal_dead_friends(
        n, friends, friend_cnt, detected_global, healer_ok, ids_global, hk)
    kd = _rng.tick_key(base_key, tick, OP_HEAL_SEND)
    kp = _rng.fold_in(kd, 1)
    kq = _rng.fold_in(kd, 2)
    drop_p = (int(cfg.droprate * 100) / 100.0 if cfg.compat_reference
              else cfg.droprate)
    senders = dead & sender_inf[:, None]
    srows = _rows_of(senders)
    resend = senders & ~_row_mask(kp, drop_p, srows, ids_global, k)
    cols = torch.arange(k, dtype=I32, device=dev)
    in_range = cols[None, :] < friend_cnt[:, None]
    fbits = peer_bits_global[torch.clamp_min(friends, 0).long()]
    asks = (rejoined[:, None] & healer_ok[:, None] & in_range
            & (friends >= 0) & ((fbits & HEAL_INFECTIVE) > 0))
    qrows = _rows_of(asks)
    pull = asks & ~_row_mask(kq, drop_p, qrows, ids_global, k)
    if cfg.effective_time_mode == "ticks":
        delay = _rng.row_uniform_delay(kd, cfg.delaylow, cfg.delayhigh,
                                       ids_global).to(I32)
    else:
        delay = torch.ones(n_rows, dtype=I32, device=dev)
    scen = cfg.scenario_resolved
    blocked_n = torch.zeros((), dtype=I64, device=dev)
    if scen.has_partitions:
        cross = partition_blocked(scen, n, tick, ids_global[:, None],
                                  friends)
        # The pull response travels friend -> rejoined node: the same pair
        # the other way, and the masks are symmetric.
        blocked = cross & resend
        qblocked = cross & pull
        blocked_n = blocked.sum(dtype=I64) + qblocked.sum(dtype=I64)
        resend = resend & ~blocked
        pull = pull & ~qblocked
    return friends, resend, pull, delay, rejoined, repaired, blocked_n


def rejoined_mask(down_since) -> torch.Tensor:
    """Nodes carrying fault_window's reboot marker (consumed by the next
    healing pass's rejoin pull)."""
    return down_since <= -2


def detect_dead(crashed, down_since, tick: int, detect_ms: int):
    """The failure detector's verdict on the local rows: a node is
    condemned once it has been crashed for >= detect_ms (the crash clock
    down_since is the accountant)."""
    return crashed & (down_since >= 0) & (tick - down_since >= detect_ms)


def down_shape(enabled: bool, n_local: int) -> int:
    """down_since rows: the full local axis when the fault machinery is on
    (scenario faults or healing), a 1-element placeholder otherwise."""
    return n_local if enabled else 1


def init_down_since(enabled: bool, n_local: int, device=None):
    return torch.full((down_shape(enabled, n_local),), -1, dtype=I32,
                      device=device)
