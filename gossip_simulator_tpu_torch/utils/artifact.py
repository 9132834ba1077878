"""Self-describing run artifacts (``-run-dir DIR``) and trajectory
fingerprints.

The port's copy of the JAX package's ``utils/artifact.py``: one directory
holding what attributes, replays and compares a run, in the JAX
package's layout, so ``scripts/compare_runs.py`` diffs a port run
against a reference run:

    run-dir/
      config.json     flag snapshot + the resolved gate set
      env.json        platform fingerprint (python, numpy, torch and its
                      CUDA version, device platform, count and name,
                      hostname, argv)
      metrics.jsonl   the JSONL log (schema v4, header first)
      telemetry.npz   fetched per-window histories + canonical trajectory
                      (and the spatial panels on -telemetry-spatial runs)
      health.json     the shard-health watchdog's verdict over the
                      spatial panels (utils/health.py; spatial runs only)
      trace.json      Chrome trace-event spans
      result.json     final Stats / RunResult payload + the trajectory
                      fingerprint

The trajectory fingerprint hashes the per-window ``(round,
total_received, total_message, total_crashed, total_removed)`` rows as
sha256 of their JSON, first 16 hex characters.  The rows come from the
telemetry history on the run-to-target path and from per-window Stats on
the windowed loop; the two bases agree row for row, so fingerprints
compare across paths.  A run with no per-window record falls back to one
final-Stats row and says so (``fingerprint_basis: "final"``).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import socket
import sys
from typing import Optional

import numpy as np

# Canonical trajectory column order (one row per poll window).
TRAJECTORY_COLS = ("round", "total_received", "total_message",
                   "total_crashed", "total_removed")


def fingerprint_rows(rows) -> str:
    """sha256 of the JSON of int rows, first 16 hex characters."""
    payload = json.dumps([[int(v) for v in r] for r in rows]).encode()
    return hashlib.sha256(payload).hexdigest()[:16]


def trajectory_from_history(hist: Optional[dict]) -> Optional[np.ndarray]:
    """The canonical int64 (count, 5) trajectory of a fetched gossip
    history (telemetry.fetch_history's shape)."""
    if not hist or not hist.get("count"):
        return None
    from gossip_simulator_tpu_torch.utils import telemetry

    count = hist["count"]
    cols = hist["cols"][:count]
    g = telemetry.GCOL
    out = np.empty((count, len(TRAJECTORY_COLS)), np.int64)
    out[:, 0] = cols[:, g["tick"]]
    out[:, 1] = cols[:, g["received"]]
    out[:, 2] = telemetry._msg64_col(cols).astype(np.int64)
    out[:, 3] = cols[:, g["crashed"]]
    out[:, 4] = cols[:, g["removed"]]
    return out


def trajectory_from_rows(rows: list) -> Optional[np.ndarray]:
    """The same array from host-collected per-window Stats rows."""
    if not rows:
        return None
    return np.asarray(rows, np.int64).reshape(len(rows),
                                              len(TRAJECTORY_COLS))


def env_fingerprint(device=None) -> dict:
    """What this run ran on: enough to put a time change down to a
    software or hardware change before suspecting the code.  `device` is
    the run's device (a card unless it is "cpu")."""
    import platform

    import torch

    out = {
        "python": platform.python_version(),
        "platform": platform.platform(),
        "hostname": socket.gethostname(),
        "argv": list(sys.argv),
        "numpy": np.__version__,
        "torch": torch.__version__,
        "torch_cuda": torch.version.cuda,
    }
    dev = torch.device(device if device is not None else
                       ("cuda" if torch.cuda.is_available() else "cpu"))
    if dev.type == "cuda":
        out["backend_platform"] = "gpu"
        out["device_count"] = torch.cuda.device_count()
        out["device_kind"] = torch.cuda.get_device_name(dev)
    else:
        out["backend_platform"] = "cpu"
        out["device_count"] = 1
        out["device_kind"] = platform.processor() or platform.machine()
    return out


class RunDir:
    """Writer for one run's artifact directory (created here); the driver
    calls the ``write_*`` methods at the run's end."""

    def __init__(self, path: str):
        self.path = os.path.abspath(path)
        os.makedirs(self.path, exist_ok=True)

    def file(self, name: str) -> str:
        return os.path.join(self.path, name)

    def _write_json(self, name: str, doc: dict) -> str:
        out = self.file(name)
        tmp = out + ".tmp"
        with open(tmp, "w") as f:
            json.dump(doc, f, indent=1, sort_keys=True, default=str)
            f.write("\n")
        os.replace(tmp, out)
        return out

    def write_config(self, cfg) -> str:
        doc = {"flags": dataclasses.asdict(cfg),
               "resolved": cfg.resolved_gates()}
        return self._write_json("config.json", doc)

    def write_env(self, device=None) -> str:
        return self._write_json("env.json", env_fingerprint(device))

    def write_telemetry(self, overlay: Optional[dict],
                        gossip: Optional[dict],
                        trajectory: Optional[np.ndarray]) -> Optional[str]:
        """One npz with both fetched histories (the named-column layouts
        of utils/telemetry), the spatial panels where the run recorded
        them (trimmed to its windows by fetch_history) and the canonical
        trajectory."""
        from gossip_simulator_tpu_torch.utils import telemetry

        arrays: dict = {}
        if gossip is not None:
            arrays["gossip_cols"] = gossip["cols"][:gossip["count"]]
            arrays["gossip_count"] = np.int64(gossip["count"])
            arrays["gossip_names"] = np.array(telemetry.GOSSIP_COLS)
            if "spatial_group" in gossip:
                arrays["spatial_group"] = gossip["spatial_group"]
                arrays["spatial_group_names"] = np.array(
                    telemetry.SPATIAL_GROUP_COLS)
                arrays["spatial_shard"] = gossip["spatial_shard"]
                arrays["spatial_shard_names"] = np.array(
                    telemetry.SPATIAL_SHARD_COLS)
                arrays["spatial_traffic"] = gossip["spatial_traffic"]
        if overlay is not None:
            arrays["overlay_cols"] = overlay["cols"][:overlay["count"]]
            arrays["overlay_count"] = np.int64(overlay["count"])
            arrays["overlay_names"] = np.array(telemetry.OVERLAY_COLS)
        if trajectory is not None:
            arrays["trajectory"] = trajectory
            arrays["trajectory_names"] = np.array(TRAJECTORY_COLS)
        if not arrays:
            return None
        out = self.file("telemetry.npz")
        tmp = out + ".tmp"
        with open(tmp, "wb") as f:
            np.savez(f, **arrays)
        os.replace(tmp, out)
        return out

    def write_result(self, payload: dict) -> str:
        return self._write_json("result.json", payload)

    def write_health(self, verdict: dict) -> str:
        """The shard-health watchdog's verdict (utils/health.py)."""
        return self._write_json("health.json", verdict)


def load_run(path: str) -> dict:
    """Read a run dir back: the JSON artifacts and the npz arrays (the
    spatial panels among them), and ``health.json`` where the run wrote
    one.  A missing artifact raises FileNotFoundError naming it."""
    out: dict = {"path": os.path.abspath(path)}
    for name in ("config", "env", "result"):
        p = os.path.join(path, name + ".json")
        if not os.path.exists(p):
            raise FileNotFoundError(f"{path}: missing {name}.json "
                                    "(not a run dir?)")
        with open(p) as f:
            out[name] = json.load(f)
    npz = os.path.join(path, "telemetry.npz")
    if os.path.exists(npz):
        with np.load(npz, allow_pickle=False) as z:
            out["telemetry"] = {k: z[k] for k in z.files}
    else:
        out["telemetry"] = {}
    health = os.path.join(path, "health.json")
    if os.path.exists(health):
        with open(health) as f:
            out["health"] = json.load(f)
    return out
