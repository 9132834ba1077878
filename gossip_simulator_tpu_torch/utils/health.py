"""Shard-health watchdog: declared predicates over the spatial panels.

The port's copy of the JAX package's ``utils/health.py``.  Each check is
a function of the snapshot dict ``telemetry.fetch_history`` returns, on
the host in numpy, and of the ring's slot capacity where the engine has
one.  The driver writes the verdict to ``health.json`` in a spatial
run's run dir.

Checks (each gives zero or more findings):

- ``occupancy_stuck_at_cap``: a shard's mail-ring high-water sat at the
  slot capacity for the last K windows (the drain is not keeping up:
  ``mailbox_dropped`` grows next).  Needs `cap`; skipped for the ring
  engine, whose pending maximum has no hard cap.
- ``zero_delivery_shard``: a shard received no routed lanes over the last
  K windows while a sibling did (a silent column of the traffic matrix).
- ``group_coverage_stall``: a group's received gauge stayed flat for K
  windows below its own peak (or at 0) while a sibling group grew.

The verdict is ``degraded`` when any finding fired, else ``ok``, or
``no-data`` without panels.  Findings also go to the trace as instant
events (``utils/trace.py`` ``instant``, a no-op without ``-trace``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from gossip_simulator_tpu_torch.utils import trace as _trace

# The fewest trailing windows a stall or stuck predicate judges.
STALL_WINDOWS = 3


def _panel_cols():
    from gossip_simulator_tpu_torch.utils.telemetry import (
        SPATIAL_GROUP_COLS, SPATIAL_SHARD_COLS)

    return (SPATIAL_GROUP_COLS.index("received"),
            SPATIAL_SHARD_COLS.index("mail_high"),
            SPATIAL_SHARD_COLS.index("exch_rcvd"))


def evaluate_health(gossip: Optional[dict], cap: Optional[int] = None,
                    stall_windows: int = STALL_WINDOWS) -> dict:
    """Every predicate over one fetched gossip snapshot (None, or a dict
    without ``spatial_group``, gives ``no-data``); `cap` is the slot
    capacity the shards' mail high-water is held to.  Returns
    ``{"status", "windows", "checks", "findings": [{"check", "subject",
    "index", "windows", "detail"}, ...]}``."""
    if not gossip or "spatial_group" not in gossip:
        return {"status": "no-data", "windows": 0, "checks": [],
                "findings": []}
    i_recv, i_high, i_rcvd = _panel_cols()
    group = np.asarray(gossip["spatial_group"])
    shard = np.asarray(gossip["spatial_shard"])
    w = int(group.shape[0])
    k = min(int(stall_windows), w)
    findings: list[dict] = []
    checks: list[str] = []

    if cap is not None and w >= stall_windows:
        checks.append("occupancy_stuck_at_cap")
        tail = shard[w - k:, :, i_high]
        for s in np.flatnonzero((tail >= int(cap)).all(axis=0)):
            findings.append({
                "check": "occupancy_stuck_at_cap", "subject": "shard",
                "index": int(s), "windows": k,
                "detail": f"mail-ring high-water pinned at cap {int(cap)} "
                          f"for the last {k} windows"})

    if int(shard.shape[1]) > 1 and w > stall_windows:
        checks.append("zero_delivery_shard")
        rcvd = shard[:, :, i_rcvd]
        delta = rcvd[w - 1] - rcvd[w - 1 - k]
        if (delta > 0).any():
            for s in np.flatnonzero(delta == 0):
                findings.append({
                    "check": "zero_delivery_shard", "subject": "shard",
                    "index": int(s), "windows": k,
                    "detail": f"no routed lanes delivered in the last {k} "
                              "windows while sibling shards kept "
                              "receiving"})

    if w > stall_windows:
        checks.append("group_coverage_stall")
        recv = group[:, :, i_recv]
        delta = recv[w - 1] - recv[w - 1 - k]
        # A group at its own peak is done, not stalled (down nodes lower
        # the gauge, so the peak is the group's own).
        peak = recv.max(axis=0)
        stalled = (delta == 0) & (recv[w - 1] < peak) | \
                  ((delta == 0) & (recv[w - 1] == 0))
        if (delta > 0).any():
            for g in np.flatnonzero(stalled):
                findings.append({
                    "check": "group_coverage_stall", "subject": "group",
                    "index": int(g), "windows": k,
                    "detail": f"received gauge flat for the last {k} "
                              "windows below its peak while sibling "
                              "groups kept growing"})

    return {"status": "degraded" if findings else "ok", "windows": w,
            "checks": checks, "findings": findings}


def report_health(verdict: dict) -> dict:
    """One trace instant a finding and one for the verdict (no-ops without
    an active tracer); returns the verdict."""
    for f in verdict.get("findings", ()):
        _trace.instant(f"health.{f['check']}", cat="health",
                       subject=f["subject"], index=f["index"],
                       detail=f["detail"])
    if verdict.get("status") != "no-data":
        _trace.instant("health.verdict", cat="health",
                       status=verdict["status"],
                       findings=len(verdict.get("findings", ())))
    return verdict


def ring_slot_cap(cfg, n_shards: int = 1) -> Optional[int]:
    """The capacity the stuck-at-cap check holds a shard's mail high-water
    to: the event and PushSum engines' slot capacity at one shard's rows;
    None for the ring engine."""
    if cfg.model == "pushsum":
        from gossip_simulator_tpu_torch.models import pushsum as geo
    elif cfg.engine_resolved == "event":
        from gossip_simulator_tpu_torch.models import event as geo
    else:
        return None
    return int(geo.slot_cap(cfg, cfg.n // max(1, int(n_shards))))
