"""Shared by the port's checkpoint twins (``test_torch_checkpoint*.py``):
state trees made by the port's steppers on the CPU, the two packages'
CLIs run in process, and the checks that hold a port-side snapshot, run
or tree to its JAX-package twin.

Both CLIs run in this process: the port's ``cli.main`` on ``-device
cpu`` and the JAX package's through ``torch_reference.jax_cli`` (which
installs no signal handlers).  Snapshots are compared by their leaves
(names, dtypes, shapes, values) and sidecar keys, never by file bytes:
``np.savez`` stamps its zip entries."""

import contextlib
import io
import json
import os
import shutil

import numpy as np

from gossip_simulator_tpu_torch.backends import ShardedStepper, TorchStepper
from gossip_simulator_tpu_torch.cli import main as torch_main
from gossip_simulator_tpu_torch.config import parse_cli
from torch_reference import jax_cli

# JSONL fields that depend on the wall clock or on the side.
WALL_FIELDS = ("wall_s", "phases_s", "node_updates_per_sec",
               "messages_per_sec")
# Gates the port resolves its own way (torch_rundir.PORT_GATES).
PORT_GATES = {"deliver_kernel": ("pallas", "xla"),
              "phase1_kernel": ("pallas", "xla"),
              "phase2_kernel": ("pallas", "xla"),
              "tuning_table": ("defaults",), "compile_budget": ("none",)}


def port_cli(argv):
    """(exit code, stdout) of the port's CLI on the CPU."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = torch_main([*argv, "-device", "cpu"])
    return rc, out.getvalue()


def ref_cli(argv):
    """(exit code, stdout) of the JAX package's CLI in this process."""
    rc, out, _ = jax_cli(argv)
    return rc, out


def run_cli(side: str, argv):
    return port_cli(argv) if side == "port" else ref_cli(argv)


def copy_dir(src, dst):
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(src, dst)
    return dst


def jsonl(path) -> list:
    with open(path) as f:
        return [json.loads(x) for x in f]


def result_record(path) -> dict:
    """The terminal ``result`` record of a -log-jsonl file."""
    recs = [r for r in jsonl(path) if r.get("event") == "result"]
    assert len(recs) == 1, path
    return recs[0]


def assert_records_equal(got: dict, want: dict) -> None:
    """Two JSONL records key for key, the wall fields aside, the run dir
    each side's own and the gates each package's resolution."""
    assert set(got) == set(want), set(got) ^ set(want)
    for key in want:
        if key in WALL_FIELDS or key == "run_dir":
            continue
        if key == "gates":
            for g in want[key]:
                if g in PORT_GATES:
                    assert got[key][g] in PORT_GATES[g], g
                else:
                    assert got[key][g] == want[key][g], g
        else:
            assert got[key] == want[key], key


def assert_same_leaves(want: dict, got: dict) -> None:
    """Leaf for leaf: names, dtypes, shapes and values."""
    assert sorted(want) == sorted(got), set(want) ^ set(got)
    for key in want:
        a, b = np.asarray(want[key]), np.asarray(got[key])
        assert a.dtype == b.dtype, (key, a.dtype, b.dtype)
        assert a.shape == b.shape, (key, a.shape, b.shape)
        assert np.array_equal(a, b), key


def load_npz(path) -> dict:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def sidecar(path) -> dict:
    with open(path + ".json") as f:
        return json.load(f)


def snapshots(d) -> list:
    return sorted(p for p in os.listdir(d) if p.endswith(".npz"))


def port_stepper(argv, shards=None):
    """An initialized port stepper on the CPU for `argv` (S = `shards`
    shards of the sharded backend when given)."""
    cfg, _ = parse_cli(list(argv))
    st = (TorchStepper(cfg, device="cpu") if shards is None
          else ShardedStepper(cfg, n_devices=shards, device="cpu"))
    st.init()
    return st


def phase2_tree(argv, windows: int, shards=None) -> dict:
    """The port's phase-2 state dict after `windows` gossip windows (the
    overlay, if any, run to quiescence first)."""
    st = port_stepper(argv, shards)
    while not st.overlay_window()[2]:
        pass
    st.seed()
    for _ in range(windows):
        st.gossip_window()
    return st.state_pytree()


def phase1_tree(argv, windows: int) -> dict:
    """The port's phase-1 state dict after `windows` overlay windows."""
    st = port_stepper(argv)
    for _ in range(windows):
        assert not st.overlay_window()[2]
    return st.overlay_state_pytree()


def decode_entries(tree: dict, cfg, s_ckpt: int) -> np.ndarray:
    """The sorted multiset of in-flight (global destination, slot, tick
    offset) triples of an SI event snapshot of `s_ckpt` shards, each
    packed into one int64 (the reshard's conservation invariant; the
    JAX package's ``tests/test_checkpoint.py::_decode_entries``)."""
    from gossip_simulator_tpu_torch.models import event

    b = event.batch_ticks(cfg)
    dw = event.ring_windows(cfg)
    ocap = int(np.asarray(tree["mail_geom"])[0])
    mail = np.asarray(tree["mail_ids"])
    cnt = np.asarray(tree["mail_cnt"])
    per = mail.shape[0] // s_ckpt
    nlo = cfg.n // s_ckpt
    out = []
    for sh in range(s_ckpt):
        for slot in range(dw):
            c = int(cnt[sh, slot])
            at = sh * per + slot * ocap
            e = mail[at:at + c].astype(np.int64)
            gid = e // b + sh * nlo
            out.append((gid * dw + slot) * b + e % b)
    return np.sort(np.concatenate(out)) if out else np.zeros(0, np.int64)


SIDES = ("port", "ref")
# The result-record fields a resumed run must end on.
STATS = ("round", "total_received", "total_message", "total_crashed",
         "total_removed", "mailbox_dropped", "scen_crashed",
         "scen_recovered", "part_dropped", "heal_repaired", "rumors_done",
         "coverage", "converged", "coverage_ms")


def cross_run(base, argv, write, resume=(), phase1=False):
    """Both CLIs write snapshots of `argv` with the `write` flags (into
    ``base/w_port``, ``base/w_ref``); with `phase1`, the phase-2
    snapshots are deleted, so a resume continues phase 1.  Then both
    resume (`argv` + `resume`) from copies of the JAX package's dir.
    Returns {"write": {side: (rc, stdout, names)}, "resume": {side: (rc,
    stdout, result record)}, "newest": {side: newest snapshot path}}."""
    out = {"write": {}, "resume": {}, "newest": {}}
    for side in SIDES:
        d = base / f"w_{side}"
        rc, text = run_cli(side, list(argv) + list(write)
                           + ["-checkpoint-dir", str(d)])
        if phase1:
            for name in os.listdir(d):
                if name.startswith("state_"):
                    os.remove(d / name)
        out["write"][side] = (rc, text, snapshots(d))
        out["newest"][side] = str(d / snapshots(d)[-1])
    for side in SIDES:
        src = copy_dir(base / "w_ref", base / f"r_{side}")
        log = base / f"r_{side}.jsonl"
        rc, text = run_cli(side, list(argv) + list(resume) + [
            "-resume", "-checkpoint-dir", str(src), "-log-jsonl", str(log)])
        out["resume"][side] = (rc, text, result_record(log))
    return out


def plain_record(base, argv) -> dict:
    """The port's uninterrupted run of `argv`: its result record."""
    log = base / "plain.jsonl"
    port_cli(list(argv) + ["-log-jsonl", str(log), "-quiet"])
    return result_record(log)


def check_cross(run) -> None:
    """The writers print one transcript and write the same snapshots,
    the newest with equal leaves; the resumes print one transcript and
    equal result records."""
    (prc, pout, pnames), (rrc, rout, rnames) = (run["write"]["port"],
                                                run["write"]["ref"])
    assert (prc, pout, pnames) == (rrc, rout, rnames)
    assert pnames
    assert_same_leaves(load_npz(run["newest"]["ref"]),
                       load_npz(run["newest"]["port"]))
    (prc, pout, prec), (rrc, rout, rrec) = (run["resume"]["port"],
                                            run["resume"]["ref"])
    assert prc == rrc
    assert "=== Resumed from " in pout
    assert pout == rout
    assert_records_equal(prec, rrec)
