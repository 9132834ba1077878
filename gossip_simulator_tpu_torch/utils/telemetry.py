"""Device-recorded telemetry: a per-window history kept on the device.

The port's copy of the JAX package's ``utils/telemetry.py``, its scalar
part.  The run-to-target loops (``make_run_to_coverage_fn`` of every
engine, the overlays' ``make_run_fn``) write one row of counters per
poll window into a preallocated int32 ``History`` on the stepper's
device -- a row write at a device index, no host read -- and the host
fetches the whole trajectory in one read after the loop.

``replay_overlay`` / ``replay_gossip`` then drive the fetched history
through the ordinary ProgressPrinter, giving the windowed loop's stdout
and JSONL byte for byte.  ``TelemetrySession`` is what a stepper carries:
the histories of both phases plus the wall-clock phase ledger (init,
compile, execute, fetch); ``TelemetryReport`` turns it into throughput,
per-window columns and the ``-telemetry-summary`` block.

History rows are int32; the int64 ``total_message`` travels as its two
32-bit words, high word first (the JAX package's bitcast of its uint32
``[hi, lo]`` pair), and is reassembled on the host.

Under ``-telemetry-spatial on`` the same loops also record three int32
panels a window at the history's index (``SpatialBundle``): a group panel
(received, down and removed counts of each contiguous id range: the
scenario's groups when it declares more than one, else the shards), a
shard panel (each shard's mail high-water, received count, route
overflow, relative error and routed lanes received) and the exchange's
cumulative traffic matrix (``parallel/exchange.py`` counts it in the
route).  They ride the history's one read at the end of the run and go
only to ``telemetry.npz``: the replayed stdout and JSONL never read them.
"""

from __future__ import annotations

import dataclasses
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from gossip_simulator_tpu_torch.models.state import EXCH_OVERFLOW, EXCH_RCVD

GOSSIP_COLS = ("tick", "received", "msg_hi", "msg_lo", "crashed", "removed",
               "mail_high", "dropped", "overflow", "scen_crashed",
               "recovered", "repaired", "part_dropped", "rumors_done",
               "exchange_inflight_hwm", "relerr_ppb")
OVERLAY_COLS = ("clock", "makeups", "breakups", "dropped")

# Optional trailing per-window blocks of the JSONL `telemetry` record: a
# group is emitted whole, and only when any of its source columns is
# nonzero.  Each entry maps the emitted per_window key to its GOSSIP_COLS
# source column.
OPTIONAL_BLOCK_GROUPS = (
    (("scen_crashed", "scen_crashed"), ("scen_recovered", "recovered"),
     ("heal_repaired", "repaired"), ("part_dropped", "part_dropped")),
    (("rumors_done", "rumors_done"),),
    (("exchange_inflight_hwm", "exchange_inflight_hwm"),),
    (("relerr_ppb", "relerr_ppb"),),
)

# The spatial panels' columns (the JSONL header lists them whatever the
# run records).  Group columns are gauges read at the probe, so summed
# over the groups `received` and `removed` equal the history's columns;
# `down` is the count crashed now.  Shard columns: the shard's mail-ring
# high-water (the largest over the shards is mail_high), its received
# count, and from its exchange counters (`exch_counts`) the route's
# overflow and the routed lanes it received; relerr_ppb is PushSum's
# error, the same on every shard.
SPATIAL_GROUP_COLS = ("received", "down", "removed")
SPATIAL_SHARD_COLS = ("mail_high", "received", "overflow", "relerr_ppb",
                      "exch_rcvd")

GCOL = {name: i for i, name in enumerate(GOSSIP_COLS)}
OCOL = {name: i for i, name in enumerate(OVERLAY_COLS)}

I32 = torch.int32
I64 = torch.int64


class History(NamedTuple):
    """A per-window ring on the device: `idx` rows written (it counts on
    past the capacity, so truncation shows; writes saturate at the last
    row), `cols` the int32 (cap, F) matrix."""

    idx: torch.Tensor  # int64[]
    cols: torch.Tensor  # int32[cap, F]


def empty_history(cap: int, ncols: int, device) -> History:
    return History(idx=torch.zeros((), dtype=I64, device=device),
                   cols=torch.zeros((max(int(cap), 1), ncols), dtype=I32,
                                    device=device))


def record(hist: History, row) -> History:
    """Write one window's row (0-d tensors or host ints) at the device
    index, clamped to the last row, and count it; no host read."""
    dev = hist.cols.device
    vals = torch.stack([
        v.to(I32) if isinstance(v, torch.Tensor)
        else torch.full((), int(v), dtype=I32, device=dev) for v in row])
    i = torch.clamp(hist.idx, max=hist.cols.shape[0] - 1)
    hist.cols.index_copy_(0, i.reshape(1), vals[None, :])
    hist.idx.add_(1)
    return hist


class Panels(NamedTuple):
    """The spatial panels on the device, rows at the history's index."""

    group: torch.Tensor  # int32[cap, G, 3]
    shard: torch.Tensor  # int32[cap, S, 5]
    traffic: torch.Tensor  # int32[cap, S, S]  cumulative routed lanes


class SpatialBundle(NamedTuple):
    """The history of a spatial run: the scalar History and the panels,
    which share its index."""

    hist: History
    panels: Panels


class SpatialSpec(NamedTuple):
    """The panels' geometry: `groups` contiguous id ranges of
    `group_size` = ceil(n / groups) ids each, over `n_shards` shards."""

    groups: int
    group_size: int
    n: int
    n_shards: int


def spatial_spec(cfg, n_shards: int = 1) -> Optional[SpatialSpec]:
    """None when the panels are off; else one group per scenario group
    when a scenario declares more than one, one per shard otherwise."""
    if not cfg.telemetry_spatial_enabled:
        return None
    scen = cfg.scenario_resolved
    s = max(1, int(n_shards))
    g = scen.groups if (scen.active and scen.groups > 1) else s
    return SpatialSpec(groups=g, group_size=-(-cfg.n // g), n=cfg.n,
                       n_shards=s)


def empty_panels(cap: int, spec: SpatialSpec, device) -> Panels:
    cap = max(int(cap), 1)
    g, s = spec.groups, spec.n_shards

    def z(*shape):
        return torch.zeros((cap,) + shape, dtype=I32, device=device)

    return Panels(group=z(g, len(SPATIAL_GROUP_COLS)),
                  shard=z(s, len(SPATIAL_SHARD_COLS)), traffic=z(s, s))


def _node_gauges(st) -> torch.Tensor:
    """bool (n_local, 3): received, down, removed of a shard's nodes (the
    event and PushSum flags' bits, or the ring engine's masks)."""
    n = st.friends.shape[0]
    if hasattr(st, "flags"):
        from gossip_simulator_tpu_torch.models.event import (CRASHED,
                                                             RECEIVED,
                                                             REMOVED)

        f = st.flags[:n]
        return torch.stack([(f & RECEIVED) != 0, (f & CRASHED) != 0,
                            (f & REMOVED) != 0], dim=1)
    return torch.stack([st.received, st.crashed, st.removed], dim=1)


def spatial_probe(states, spec: SpatialSpec, relerr=None):
    """One window's panel rows from the shards' states (one state on a
    single device): group (G, 3), shard (S, 5) and traffic (S, S), int32.
    The group sums reduce the shards' nodes, side by side in id order,
    over equal-width reshaped blocks (no length-n scatter); the counts
    are exact integer sums, so they equal the JAX package's per-shard
    partial sums summed over the shards."""
    dev = states[0].friends.device
    gauges = torch.cat([_node_gauges(st) for st in states])
    n, kg = gauges.shape
    gsz = spec.group_size
    full = min(n // gsz, spec.groups)
    group = torch.zeros((spec.groups, kg), dtype=I32, device=dev)
    group[:full] = gauges[:full * gsz].view(full, gsz, kg).sum(
        dim=1, dtype=I32)
    if full < spec.groups and full * gsz < n:
        group[full] = gauges[full * gsz:].sum(dim=0, dtype=I32)
    s = spec.n_shards
    high = torch.stack([(st.mail_cnt if hasattr(st, "mail_cnt")
                         else st.pending).max() for st in states]).to(I32)
    recv = gauges[:, 0].view(s, -1).sum(dim=1, dtype=I32)
    rel = torch.zeros(s, dtype=I32, device=dev)
    if relerr is not None:
        rel += relerr.to(I32)
    if s > 1:
        ex = torch.cat([st.exch_counts for st in states])
        shard = torch.stack([high, recv, ex[:, EXCH_OVERFLOW], rel,
                             ex[:, EXCH_RCVD]], dim=1)
        return group, shard, ex[:, :EXCH_RCVD]
    zero = torch.zeros(1, dtype=I32, device=dev)
    shard = torch.stack([high, recv, zero, rel, zero], dim=1)
    return group, shard, torch.zeros((1, 1), dtype=I32, device=dev)


def record_window(hist, row, states=None, spec=None, relerr=None):
    """A run-to-target loop's one recording call a window: the scalar row
    alone when the panels are off (`spec` None), else the panel rows of
    `states` (spatial_probe) at the same index, then the row."""
    if spec is None:
        return record(hist, row)
    g, s, t = spatial_probe(states, spec, relerr=relerr)
    i = torch.clamp(hist.hist.idx, max=hist.hist.cols.shape[0] - 1)
    i = i.reshape(1)
    for panel, rows in zip(hist.panels, (g, s, t)):
        panel.index_copy_(0, i, rows[None])
    record(hist.hist, row)
    return hist


def _msg_words(total_message: torch.Tensor):
    """The int64 total's (high, low) 32-bit words as int32 0-d tensors,
    viewed in place (little-endian: the low word is first in memory)."""
    w = total_message.reshape(1).view(I32)
    return w[1], w[0]


def gossip_probe(st, sir: bool, rumors: int = 0, inflight_hwm: int = 0,
                 relerr=None, shards=None):
    """One GOSSIP_COLS row from an engine's state, duck-typed on the mail
    ring: the event and PushSum states carry `mail_cnt`, the ring engine's
    `pending`.  Mail high-water is `mail_cnt.max()` (the ring engine's
    `pending.max()`).  `shards` (the sharded engines' per-shard states)
    sums the removed count and takes the largest high-water over them;
    the totals are kept equal on every shard.  `rumors` (R; 0 = one
    rumor) adds the count of rumors at the target, `inflight_hwm` is the
    exchange's buffers alive at once (0: no exchange), `relerr` PushSum's
    max relative error in parts per billion."""
    from gossip_simulator_tpu_torch.models.event import removed_count

    group = shards if shards is not None else [st]
    z = torch.zeros((), dtype=I64, device=st.total_received.device)
    removed = sum(removed_count(s) for s in group) if sir else z
    if hasattr(st, "mail_cnt"):
        high = torch.stack([s.mail_cnt.max() for s in group]).max()
        dropped = st.mail_dropped
    else:
        high = torch.stack([s.pending.max() for s in group]).max()
        dropped = z
    hi, lo = _msg_words(st.total_message)
    rdone = ((st.rumor_done[:rumors] >= 0).sum() if rumors else z)
    return [st.tick, st.total_received, hi, lo, st.total_crashed, removed,
            high, dropped, st.exchange_overflow, st.scen_crashed,
            st.scen_recovered, st.heal_repaired, st.part_dropped, rdone,
            inflight_hwm, relerr if relerr is not None else z]


def overlay_probe(st):
    """One OVERLAY_COLS row from either overlay engine's state (the
    tick-faithful engine's `tick`, the rounds engine's `round`), or from
    the sharded overlays' shard list, whose counters are kept equal on
    every shard (shard 0's are read)."""
    if isinstance(st, list):
        st = st[0]
    clock = st.tick if hasattr(st, "tick") else st.round
    return [clock, st.win_makeups, st.win_breakups, st.mailbox_dropped]


def gossip_history_cap(cfg) -> int:
    """Phase-2 rows: a poll window advances at least 10 ticks in ticks
    mode and one round in rounds mode, so ceil(max_rounds / window) + 2
    bounds them."""
    window = 1 if cfg.effective_time_mode == "rounds" else 10
    return max(1, -(-cfg.max_rounds // window) + 2)


def fetch_history(hist) -> Optional[dict]:
    """One device-to-host read of a whole history (its index rides
    appended to the flattened rows).  A SpatialBundle's panels ride the
    same read: the dict gains ``spatial_group``, ``spatial_shard`` and
    ``spatial_traffic``, trimmed to the recorded window count."""
    if hist is None:
        return None
    panels = ()
    if isinstance(hist, SpatialBundle):
        hist, panels = hist.hist, hist.panels
    cap, ncols = hist.cols.shape
    parts = [hist.cols] + list(panels)
    flat = torch.cat([p.reshape(-1) for p in parts]
                     + [hist.idx.reshape(1).to(I32)]).cpu().numpy()
    recorded = int(flat[-1])
    count = min(recorded, cap)
    arrays, at = [], 0
    for p in parts:
        arrays.append(flat[at:at + p.numel()].reshape(p.shape).copy())
        at += p.numel()
    out = {"count": count, "recorded": recorded,
           "truncated": recorded > cap, "cols": arrays[0]}
    for name, a in zip(("spatial_group", "spatial_shard", "spatial_traffic"),
                       arrays[1:]):
        out[name] = a[:count]
    return out


def host_history(rows: list) -> Optional[dict]:
    """fetch_history's shape for host-recorded rows (the split overlay
    round's host loop)."""
    if not rows:
        return None
    cols = np.asarray(rows, np.int32).reshape(len(rows), -1)
    return {"count": len(rows), "recorded": len(rows), "truncated": False,
            "cols": cols}


# --- replay -----------------------------------------------------------------

def replay_overlay(printer, hist: Optional[dict], clock_scale: float,
                   quiesced: bool = True) -> None:
    """The phase-1 window lines as the windowed loop prints them: the
    quiescing window prints none (simulator.go:227-230)."""
    if not hist:
        return
    cols, count = hist["cols"], hist["count"]
    last = count - 1 if quiesced else count
    for i in range(max(0, last)):
        printer.overlay_window(int(cols[i, OCOL["breakups"]]),
                               int(cols[i, OCOL["makeups"]]),
                               float(cols[i, OCOL["clock"]]) * clock_scale)


def replay_gossip(printer, hist: Optional[dict], n: int) -> None:
    """The phase-2 coverage lines: received / n a window, rounded to 4
    places, as the windowed loop computes it."""
    if not hist:
        return
    cols = hist["cols"]
    for i in range(hist["count"]):
        pct = (int(cols[i, GCOL["received"]]) / n if n else 0.0) * 100.0
        printer.coverage_window(round(pct, 4), float(cols[i, GCOL["tick"]]))


def _msg64_col(cols: np.ndarray) -> np.ndarray:
    """The [hi, lo] int32 column pair reassembled into uint64."""
    hi = GCOL["msg_hi"]
    pair = cols[:, hi:hi + 2].astype(np.int32).view(np.uint32) \
        .astype(np.uint64)
    return (pair[:, 0] << np.uint64(32)) | pair[:, 1]


# --- host-side session ------------------------------------------------------

class TelemetrySession:
    """A stepper's histories for both phases and the wall-clock phase
    ledger.  The first bounded call of each phase is tallied as
    `compile_s` (on the card it includes the kernels' first build), the
    rest as `execute_s`."""

    def __init__(self, cfg, device, n_shards: int = 1):
        self.cfg = cfg
        self.device = device
        self.n_shards = n_shards  # the panels' geometry on spatial runs
        self.phases: dict[str, float] = {}
        self._gossip: Optional[History] = None
        self._overlay: Optional[History] = None
        self._overlay_host_rows: list = []
        self._gossip_calls = 0
        self._overlay_calls = 0
        self._gossip_fetched: Optional[dict] = None
        self._overlay_fetched: Optional[dict] = None

    def add_phase(self, key: str, seconds: float) -> None:
        self.phases[key] = self.phases.get(key, 0.0) + seconds

    def tally_gossip_call(self, seconds: float) -> None:
        self.add_phase("compile_s" if self._gossip_calls == 0 else
                       "execute_s", seconds)
        self._gossip_calls += 1

    def tally_overlay_call(self, seconds: float) -> None:
        self.add_phase("compile_s" if self._overlay_calls == 0 else
                       "execute_s", seconds)
        self._overlay_calls += 1

    # --- phase 2 ----------------------------------------------------------
    def begin_gossip(self):
        if self._gossip is None:
            cap = gossip_history_cap(self.cfg)
            hist = empty_history(cap, len(GOSSIP_COLS), self.device)
            spec = spatial_spec(self.cfg, self.n_shards)
            self._gossip = hist if spec is None else SpatialBundle(
                hist, empty_panels(cap, spec, self.device))
        return self._gossip

    def end_gossip(self, hist) -> None:
        self._gossip = hist

    def reset_gossip(self) -> None:
        """Drop the phase-2 history (a reset_state rerun records anew)."""
        self._gossip = None
        self._gossip_fetched = None

    def gossip_snapshot(self) -> Optional[dict]:
        if self._gossip_fetched is None and self._gossip is not None:
            t0 = time.perf_counter()
            self._gossip_fetched = fetch_history(self._gossip)
            self.add_phase("fetch_s", time.perf_counter() - t0)
        return self._gossip_fetched

    # --- phase 1 ----------------------------------------------------------
    def begin_overlay(self, cap: int) -> History:
        if self._overlay is None:
            self._overlay = empty_history(cap, len(OVERLAY_COLS),
                                          self.device)
        return self._overlay

    def end_overlay(self, hist: History) -> None:
        self._overlay = hist

    def overlay_host_row(self, row) -> None:
        """A host-recorded row (the split overlay round, which reads its
        counters on the host every round anyway)."""
        self._overlay_host_rows.append([int(v) for v in row])

    def overlay_snapshot(self) -> Optional[dict]:
        if self._overlay_fetched is None:
            if self._overlay is not None:
                t0 = time.perf_counter()
                self._overlay_fetched = fetch_history(self._overlay)
                self.add_phase("fetch_s", time.perf_counter() - t0)
            elif self._overlay_host_rows:
                self._overlay_fetched = host_history(self._overlay_host_rows)
        return self._overlay_fetched


# --- report -----------------------------------------------------------------

@dataclasses.dataclass
class TelemetryReport:
    """One run's telemetry on the host: phase ledger, throughput and the
    per-window trajectory."""

    n: int
    phases: dict
    overlay: Optional[dict] = None
    gossip: Optional[dict] = None
    overlay_clock_scale: float = 1.0

    def summary(self) -> dict:
        out: dict = {"phases_s": {k: round(v, 6)
                                  for k, v in sorted(self.phases.items())}}
        execute = self.phases.get("execute_s", 0.0) \
            + self.phases.get("compile_s", 0.0)
        if self.overlay:
            out["overlay_windows"] = self.overlay["count"]
            if self.overlay["truncated"]:
                out["overlay_truncated"] = True
        if self.gossip:
            cols, count = self.gossip["cols"], self.gossip["count"]
            out["gossip_windows"] = count
            if self.gossip["truncated"]:
                out["gossip_truncated"] = True
            if count:
                c = cols[:count]

                def col(name: str) -> np.ndarray:
                    return c[:, GCOL[name]]

                ticks = int(col("tick")[-1])
                msg = _msg64_col(c)
                out["sim_ticks"] = ticks
                out["total_message"] = int(msg[-1])
                if execute > 0:
                    out["node_updates_per_sec"] = round(
                        self.n * ticks / execute, 1)
                    out["messages_per_sec"] = round(int(msg[-1]) / execute, 1)
                per = {
                    "tick": col("tick").tolist(),
                    "received": col("received").tolist(),
                    "message": [int(v) for v in msg],
                    "crashed": col("crashed").tolist(),
                    "removed": col("removed").tolist(),
                    "mail_high": col("mail_high").tolist(),
                    "dropped": col("dropped").tolist(),
                    "overflow": col("overflow").tolist(),
                }
                for grp in OPTIONAL_BLOCK_GROUPS:
                    srcs = [src for _, src in grp]
                    if bool(np.stack([col(s) for s in srcs]).any()):
                        for key, src in grp:
                            per[key] = col(src).tolist()
                out["per_window"] = per
                out["deltas"] = {
                    "received": np.diff(col("received"),
                                        prepend=0).tolist(),
                    "message": np.diff(msg.astype(np.int64),
                                       prepend=np.int64(0)).tolist(),
                }
        return out

    def summary_block(self) -> str:
        """The `-telemetry-summary` end-of-run stdout block."""
        s = self.summary()
        ph = s.get("phases_s", {})
        lines = ["\n=== Telemetry ==="]
        lines.append("phases: " + " ".join(
            f"{k[:-2]} {v:.3f}s" for k, v in ph.items()) if ph
            else "phases: (none recorded)")
        if "overlay_windows" in s:
            lines.append(f"overlay: {s['overlay_windows']} windows")
        if "gossip_windows" in s:
            g = f"gossip: {s['gossip_windows']} windows"
            if "sim_ticks" in s:
                g += f", {s['sim_ticks']} simulated ms"
            lines.append(g)
        if "node_updates_per_sec" in s:
            lines.append(f"throughput: {s['node_updates_per_sec']:g} "
                         f"node-updates/s, {s['messages_per_sec']:g} "
                         "messages/s")
        return "\n".join(lines)
