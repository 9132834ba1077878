"""Shared by the port's run-artifact twins (``test_torch_rundir*_cli.py``):
run the port and the JAX package on the same argv with ``-run-dir``,
``-log-jsonl``, ``-trace`` and ``-telemetry-summary``, and the checks that
hold the two sides' records together.

A side runs through its CLI (the port's ``cli.main`` on ``-device cpu``,
the JAX package's in process through ``torch_reference.jax_cli``), or, for
``-backend sharded`` at S shards, in process with ``ShardedStepper(cfg,
n_devices=S)`` on both sides, as ``test_torch_sharded_twins.py`` runs
them.

What depends on the wall clock is masked before comparing: the summary
block's ``phases:`` and ``throughput:`` lines, and the JSONL fields
``wall_s``, ``phases_s``, ``node_updates_per_sec`` and
``messages_per_sec``; ``run_dir`` is each side's own absolute path.  The
resolved gates differ where the port resolves its kernel gates to
"pallas" (its kernels' plain versions on the CPU; the JAX package says
"xla"), has no tuning table ("defaults"; the JAX package's table may
match this host's fake 8-device mesh with a result-neutral entry) and
names no compile budget."""

import contextlib
import importlib.util
import io
import json
import os
import pathlib

import numpy as np

from gossip_simulator_tpu.backends.sharded import ShardedStepper as JStepper
from gossip_simulator_tpu.config import parse_args as jparse
from gossip_simulator_tpu.driver import run_simulation as jrun
from gossip_simulator_tpu.utils.metrics import ProgressPrinter as JPrinter
from gossip_simulator_tpu_torch.backends import ShardedStepper as TStepper
from gossip_simulator_tpu_torch.cli import main as torch_main
from gossip_simulator_tpu_torch.config import parse_cli as tparse
from gossip_simulator_tpu_torch.driver import run_simulation as trun
from gossip_simulator_tpu_torch.utils.metrics import \
    ProgressPrinter as TPrinter
from torch_reference import jax_cli

REPO = pathlib.Path(__file__).resolve().parents[1]
WALL_FIELDS = ("wall_s", "phases_s", "node_updates_per_sec",
               "messages_per_sec")
WALL_LINES = ("phases:", "throughput:")
# Gates the port resolves its own way (see the module docstring).
PORT_GATES = {"deliver_kernel": ("pallas", "xla"),
              "phase1_kernel": ("pallas", "xla"),
              "phase2_kernel": ("pallas", "xla"),
              "tuning_table": ("defaults",), "compile_budget": ("none",)}


def compare_runs_module():
    """scripts/compare_runs.py as a module (it is a script, not a
    package member)."""
    spec = importlib.util.spec_from_file_location(
        "compare_runs", REPO / "scripts" / "compare_runs.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def recording_argv(base: pathlib.Path) -> list:
    return ["-run-dir", str(base / "run"),
            "-log-jsonl", str(base / "log.jsonl"),
            "-trace", str(base / "trace.json"), "-telemetry-summary"]


def run_side(side: str, argv: list, base: pathlib.Path, shards=None):
    """One side's run: (exit code, stdout, the recording dir `base`)."""
    argv = list(argv) + recording_argv(base)
    out = io.StringIO()
    if shards is None:
        if side == "port":
            with contextlib.redirect_stdout(out):
                rc = torch_main(argv + ["-device", "cpu"])
            return rc, out.getvalue(), base
        rc, text, _ = jax_cli(argv)
        return rc, text, base
    if side == "port":
        cfg, _ = tparse(argv)
        stepper = TStepper(cfg, n_devices=shards, device="cpu")
        printer, run = TPrinter, trun
    else:
        cfg = jparse(argv)
        stepper = JStepper(cfg, n_devices=shards)
        printer, run = JPrinter, jrun
    with printer(enabled=cfg.progress, out=out,
                 jsonl_path=cfg.log_jsonl_resolved) as p:
        res = run(cfg, printer=p, stepper=stepper)
    return (0 if res.converged else 2), out.getvalue(), base


def masked_stdout(text: str) -> list:
    return [("<wall>" if x.startswith(WALL_LINES) else x)
            for x in text.splitlines()]


def jsonl_records(path) -> list:
    with open(path) as f:
        return [json.loads(x) for x in f]


def check_jsonl(port_dir: pathlib.Path, ref_dir: pathlib.Path) -> None:
    """The -log-jsonl streams record for record, key for key (an
    explicit -log-jsonl takes the place of the run dir's metrics.jsonl
    on both sides)."""
    assert not (port_dir / "run" / "metrics.jsonl").exists()
    got, want = (jsonl_records(port_dir / "log.jsonl"),
                 jsonl_records(ref_dir / "log.jsonl"))
    assert [r["event"] for r in got] == [r["event"] for r in want]
    for g, w in zip(got, want):
        assert set(g) == set(w), (g["event"], set(g) ^ set(w))
        for key in w:
            if key in WALL_FIELDS:
                continue
            if key == "run_dir":
                assert g[key] == os.path.abspath(port_dir / "run")
            elif key == "gates":
                check_gates(g[key], w[key])
            else:
                assert g[key] == w[key], (g["event"], key)


def check_gates(port: dict, ref: dict) -> None:
    assert set(port) == set(ref)
    for key in ref:
        if key in PORT_GATES:
            assert port[key] in PORT_GATES[key], key
        else:
            assert port[key] == ref[key], key


def check_result_and_npz(port_dir, ref_dir) -> None:
    """result.json's Stats fields (compare_runs' STAT_FIELDS) and every
    telemetry.npz array: the same names, dtypes and values."""
    stat_fields = compare_runs_module().STAT_FIELDS
    got = json.load(open(port_dir / "run" / "result.json"))
    want = json.load(open(ref_dir / "run" / "result.json"))
    assert set(got) == set(want)
    for key in stat_fields:
        assert got.get(key) == want.get(key), key
    assert got["fingerprint_basis"] == want["fingerprint_basis"]
    with np.load(port_dir / "run" / "telemetry.npz") as zp, \
            np.load(ref_dir / "run" / "telemetry.npz") as zr:
        assert sorted(zp.files) == sorted(zr.files)
        for key in zr.files:
            assert zp[key].dtype == zr[key].dtype, key
            assert np.array_equal(zp[key], zr[key]), key


def check_trace(port_dir, ref_dir) -> None:
    """Valid Chrome trace JSON, with the reference's span names."""
    docs = []
    for d in (port_dir, ref_dir):
        with open(d / "trace.json") as f:
            docs.append(json.load(f))
    got, want = docs
    for ev in got["traceEvents"]:
        assert ev["ph"] == "X" and ev["dur"] >= 0
        assert {"name", "cat", "ts", "pid", "tid"} <= set(ev)
    assert (sorted({(e["name"], e["cat"]) for e in got["traceEvents"]})
            == sorted({(e["name"], e["cat"]) for e in want["traceEvents"]}))
    assert got["metadata"] == want["metadata"]
