"""Graceful shutdown and the copy rule, on the CPU.

* A shutdown requested after window j (``lifecycle.request_shutdown``,
  each package's own) in both drivers: the same transcript and
  ``-run-dir`` records, reason "interrupted", exit 2, equal final
  snapshots marked ``interrupted``
  (phase 1: ``phase`` 1 and ``sim_ms``), and both CLIs resume from the
  JAX package's to the same transcript and the uninterrupted run's
  Stats.  Under the run-to-target path the request is read after its
  bounded call, as in the JAX package.
* SIGTERM to the port's CLI in a subprocess: exit 2, reason
  "interrupted" and a final snapshot; a second signal kills.
* Loads and saves copy: a state dict taken, then stepped past, still
  holds what was taken, and a dict loaded twice with a run stepped
  between gives the same run twice."""

import os
import signal
import subprocess
import sys

import numpy as np
import pytest

from gossip_simulator_tpu.utils import lifecycle as jlife
from gossip_simulator_tpu_torch.utils import lifecycle as tlife
from gossip_simulator_tpu_torch.utils import checkpoint as tck
from gossip_simulator_tpu_torch.utils import rng as trng
from test_torch_rng import match_jax_threefry
import torch_ckpt as ck
import torch_rundir as rd

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def threefry_layout():
    """Draw in the counter layout this process's jax uses."""
    old = trng.partitionable()
    match_jax_threefry()
    yield
    trng.set_partitionable(old)


@pytest.fixture(autouse=True)
def no_shutdown_left():
    """No request outlives a test (the flag is process-wide)."""
    tlife.reset()
    jlife.reset()
    yield
    tlife.reset()
    jlife.reset()


KOUT = ["-graph", "kout", "-n", "3000", "-fanout", "6", "-seed", "4"]
TICKS = ["-n", "2000", "-seed", "1", "-coverage-target", "0.9"]
# Checkpointing that never fires keeps the windowed loop (the card's
# SIGTERM case does the same).
NEVER = ["-checkpoint-every", "1000"]
# name: (argv, the stepper method after whose j-th call the request is
# raised, j)
CASES = {
    "phase2_window3": (KOUT + NEVER, "gossip_window", 3),
    "phase2_window1": (KOUT + NEVER, "gossip_window", 1),
    "phase1_window4": (TICKS + NEVER, "overlay_window", 4),
    "run_to_target": (KOUT, "init", 1),
}


def _requesting(cls, method, j, life):
    """`cls` with `life.request_shutdown()` raised after the j-th call of
    `method`."""
    calls = [0]

    def wrapped(self, *a, **kw):
        out = getattr(cls, method)(self, *a, **kw)
        calls[0] += 1
        if calls[0] == j:
            life.request_shutdown()
        return out

    return type(f"Requesting{cls.__name__}", (cls,), {method: wrapped})


def _interrupted_run(side, argv, method, j, ckpt_dir):
    """One side's run of `argv` with a request after window j: (exit
    code, stdout)."""
    import contextlib
    import io

    argv = list(argv) + ["-checkpoint-dir", str(ckpt_dir / "ckpt"),
                         "-run-dir", str(ckpt_dir / "run")]
    out = io.StringIO()
    if side == "port":
        from gossip_simulator_tpu_torch import backends, driver
        from gossip_simulator_tpu_torch.config import parse_cli
        from gossip_simulator_tpu_torch.utils.metrics import ProgressPrinter

        cfg, _ = parse_cli(argv)
        stepper = _requesting(backends.TorchStepper, method, j, tlife)(
            cfg, device="cpu")
        with contextlib.redirect_stdout(out):
            res = driver.run_simulation(cfg, ProgressPrinter(), stepper)
    else:
        from gossip_simulator_tpu import driver
        from gossip_simulator_tpu.backends.jax_backend import JaxStepper
        from gossip_simulator_tpu.config import parse_args
        from gossip_simulator_tpu.utils.metrics import ProgressPrinter

        cfg = parse_args(argv)
        stepper = _requesting(JaxStepper, method, j, jlife)(cfg)
        with contextlib.redirect_stdout(out):
            res = driver.run_simulation(cfg, ProgressPrinter(), stepper)
    return (0 if res.converged else 2), out.getvalue()


@pytest.fixture(scope="module")
def interrupted(tmp_path_factory):
    made = {}

    def get(name):
        if name not in made:
            argv, method, j = CASES[name]
            base = tmp_path_factory.mktemp(name)
            runs = {}
            for side in ck.SIDES:
                tlife.reset()
                jlife.reset()
                runs[side] = _interrupted_run(side, argv, method, j,
                                              base / side)
            tlife.reset()
            jlife.reset()
            made[name] = (runs, base)
        return made[name]

    return get


@pytest.mark.parametrize("name", sorted(CASES))
def test_shutdown_stops_both_drivers_alike(interrupted, name):
    runs, base = interrupted(name)
    assert runs["port"] == runs["ref"]
    rc, out = runs["port"]
    if name == "run_to_target":
        # One bounded call runs the whole wave at this n: the request is
        # read after it, and the run is converged but interrupted.
        assert rc == 0
        return
    assert rc == 2
    assert "(interrupted) ---" in out
    rd.check_result_and_npz(base / "port", base / "ref")
    names = ck.snapshots(base / "port" / "ckpt")
    assert names == ck.snapshots(base / "ref" / "ckpt") and len(names) == 1
    paths = [str(base / side / "ckpt" / names[0]) for side in ck.SIDES]
    ck.assert_same_leaves(ck.load_npz(paths[1]), ck.load_npz(paths[0]))
    metas = [ck.sidecar(p) for p in paths]
    for m in metas:
        assert m.pop("sha256") and m["interrupted"] is True
    assert metas[0] == metas[1]
    if CASES[name][1] == "overlay_window":
        assert names[0].startswith("overlay_")
        assert metas[0]["phase"] == 1 and metas[0]["sim_ms"] > 0


@pytest.mark.parametrize("name", ("phase2_window3", "phase1_window4"))
def test_resume_from_the_final_snapshot(interrupted, name, tmp_path):
    """Both CLIs resume from the JAX package's final snapshot with one
    transcript, and end on the uninterrupted run's Stats."""
    runs, base = interrupted(name)
    argv = [a for a in CASES[name][0] if a not in NEVER]
    outs = {}
    for side in ck.SIDES:
        src = ck.copy_dir(base / "ref" / "ckpt", tmp_path / side)
        log = tmp_path / f"{side}.jsonl"
        rc, text = ck.run_cli(side, argv + [
            "-resume", "-checkpoint-dir", str(src), "-log-jsonl", str(log)])
        outs[side] = (rc, text, ck.result_record(log))
    assert outs["port"][:2] == outs["ref"][:2]
    assert outs["port"][0] == 0
    ck.assert_records_equal(outs["port"][2], outs["ref"][2])
    want = ck.plain_record(tmp_path, argv)
    keys = ck.STATS + (("stabilize_ms",) if "phase1" in name else ())
    assert {k: outs["port"][2].get(k) for k in keys} == \
        {k: want.get(k) for k in keys}


def test_sigterm_ends_the_cli_with_a_final_snapshot(tmp_path):
    """SIGTERM after the first coverage line: the run stops at a window
    boundary, prints reason "interrupted", writes one snapshot marked
    interrupted and exits 2."""
    d = tmp_path / "term"
    argv = [sys.executable, "-u", "-m", "gossip_simulator_tpu_torch",
            "-device", "cpu", "-graph", "kout", "-n", "20000", "-fanout",
            "6", "-seed", "0", "-delayhigh", "600", "-checkpoint-every",
            "1000", "-checkpoint-dir", str(d)]
    proc = subprocess.Popen(argv, cwd=REPO, stdout=subprocess.PIPE,
                            text=True)
    lines = []
    for line in proc.stdout:
        lines.append(line)
        if "% covered" in line:
            proc.send_signal(signal.SIGTERM)
            break
    lines += proc.stdout.readlines()
    assert proc.wait(timeout=120) == 2
    assert "(interrupted) ---" in "".join(lines)
    names = ck.snapshots(d)
    assert len(names) == 1
    meta = ck.sidecar(str(d / names[0]))
    assert meta["interrupted"] is True and meta["window"] >= 1


def test_second_signal_kills():
    code = ("import os, signal\n"
            "from gossip_simulator_tpu_torch.utils import lifecycle\n"
            "assert lifecycle.install_signal_handlers()\n"
            "os.kill(os.getpid(), signal.SIGTERM)\n"
            "assert lifecycle.shutdown_requested()\n"
            "print('flagged', flush=True)\n"
            "os.kill(os.getpid(), signal.SIGTERM)\n"
            "print('still alive', flush=True)\n")
    p = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=60)
    assert p.returncode == -signal.SIGTERM
    assert p.stdout == "flagged\n"


def test_callbacks_fire_once_and_reset_clears():
    seen = []
    tlife.register_on_shutdown(lambda: seen.append(1))
    tlife.register_on_shutdown(lambda: 1 / 0)  # swallowed
    tlife.request_shutdown()
    tlife.request_shutdown(signal.SIGINT)
    assert seen == [1] and tlife.shutdown_requested()
    tlife.reset()
    assert not tlife.shutdown_requested()
    tlife.request_shutdown()
    assert seen == [1]


# --- the copy rule ------------------------------------------------------------

PS = ["-model", "pushsum", "-graph", "kout", "-n", "2000", "-fanout", "6",
      "-droprate", "0", "-crashrate", "0", "-seed", "1"]
COPY = {"event": (KOUT, None), "ring": (["-engine", "ring"] + KOUT, None),
        "pushsum": (PS, None), "sharded_s4": (KOUT, 4),
        "rumors": (KOUT + ["-rumors", "4", "-crashrate", "0"], None)}


def _rows(stepper, windows):
    return [stepper.gossip_window().to_dict() for _ in range(windows)]


@pytest.mark.parametrize("name", sorted(COPY))
def test_saved_and_loaded_trees_are_copies(name, tmp_path):
    """state_pytree copies: stepping on leaves the taken dict as it was.
    load_state_pytree copies: the dict, loaded, stepped past (the plain
    versions write the rings in place) and loaded again, gives the same
    windows twice, and is itself unchanged; so does its snapshot."""
    argv, shards = COPY[name]
    st = ck.port_stepper(argv, shards)
    st.seed()
    _rows(st, 3)
    tree = st.state_pytree()
    kept = {k: np.array(v) for k, v in tree.items()}
    _rows(st, 2)
    ck.assert_same_leaves(kept, tree)
    path = tck.save(str(tmp_path), 3, tree, st.stats())
    runs = []
    for source in ("dict", "dict", "file"):
        t = tree if source == "dict" else tck.load(path)[0]
        st.load_state_pytree(t)
        runs.append(_rows(st, 4))
        ck.assert_same_leaves(kept, t)
    assert runs[0] == runs[1] == runs[2]


def test_overlay_tree_is_a_copy():
    st = ck.port_stepper(TICKS)
    for _ in range(3):
        st.overlay_window()
    tree = st.overlay_state_pytree()
    kept = {k: np.array(v) for k, v in tree.items()}
    st.overlay_window()
    ck.assert_same_leaves(kept, tree)
    rows = []
    for _ in range(2):
        st.load_overlay_state_pytree(tree, windows=3)
        rows.append([st.overlay_window() for _ in range(3)])
        ck.assert_same_leaves(kept, tree)
    assert rows[0] == rows[1]
