"""Snapshots cross between the two packages through their CLIs, on the
CPU: the JAX package writes (``-checkpoint-every 2 -max-rounds 30``),
and both CLIs ``-resume`` from copies of its directory with
byte-identical stdout and equal ``result`` records; then the port
writes and both resume.  The two writers' transcripts are one, their
snapshots at the same window have equal leaves and sidecar keys, a
resumed run ends on the uninterrupted run's Stats, ``-ckpt-keep`` keeps
the same files, the resumed runs' ``-run-dir`` artifacts are equal, and
``-run-id`` and a bad ``-resume`` are refused alike.  Exact equality
everywhere."""

import json
import os

import pytest

from gossip_simulator_tpu_torch.utils import rng as trng
from test_torch_rng import match_jax_threefry
import torch_ckpt as ck
import torch_rundir as rd


@pytest.fixture(autouse=True, scope="module")
def threefry_layout():
    """Draw in the counter layout this process's jax uses."""
    old = trng.partitionable()
    match_jax_threefry()
    yield
    trng.set_partitionable(old)


KOUT = ["-graph", "kout", "-n", "3000", "-fanout", "6", "-seed", "1"]
WRITE = ["-checkpoint-every", "2", "-max-rounds", "30"]
SIDES = ck.SIDES


@pytest.fixture(scope="module")
def written(tmp_path_factory):
    """Each side's checkpointing run of KOUT: (exit code, stdout, dir)."""
    runs = {}

    def get(side):
        if side not in runs:
            d = tmp_path_factory.mktemp(f"write_{side}")
            rc, out = ck.run_cli(side, KOUT + WRITE + [
                "-run-id", "run1", "-checkpoint-dir", str(d / "ckpt")])
            runs[side] = (rc, out, d / "ckpt")
        return runs[side]

    return get


@pytest.fixture(scope="module")
def resumed(written, tmp_path_factory):
    """(writer, resumer): the resumer's CLI resumed from a copy of the
    writer's dir, to convergence, with -log-jsonl and -run-dir: (exit
    code, stdout, result record, the recording dir)."""
    runs = {}

    def get(writer, side):
        if (writer, side) not in runs:
            d = tmp_path_factory.mktemp(f"resume_{writer}_{side}")
            src = ck.copy_dir(written(writer)[2], d / "ckpt")
            rc, out = ck.run_cli(side, KOUT + [
                "-resume", "-checkpoint-dir", str(src), "-log-jsonl",
                str(d / "log.jsonl"), "-run-dir", str(d / "run")])
            runs[writer, side] = (rc, out, ck.result_record(d / "log.jsonl"),
                                  d)
        return runs[writer, side]

    return get


@pytest.fixture(scope="module")
def uninterrupted(tmp_path_factory):
    d = tmp_path_factory.mktemp("plain")
    rc, out = ck.port_cli(KOUT + ["-log-jsonl", str(d / "log.jsonl")])
    return rc, out, ck.result_record(d / "log.jsonl")


def test_writers_print_one_transcript(written):
    (prc, pout, pdir), (rrc, rout, rdir) = written("port"), written("ref")
    assert prc == rrc == 2  # -max-rounds 30 ends the wave early
    assert pout == rout
    assert ck.snapshots(pdir) == ck.snapshots(rdir) == ["state_00000002.npz"]


def test_writers_snapshots_equal(written):
    """The same window's snapshot from both stepper families: equal
    leaves, and sidecars equal but for the digest (the zip stamps)."""
    name = "state_00000002.npz"
    paths = [str(written(side)[2] / name) for side in SIDES]
    ck.assert_same_leaves(ck.load_npz(paths[1]), ck.load_npz(paths[0]))
    metas = [ck.sidecar(p) for p in paths]
    for m in metas:
        assert m.pop("sha256") and m["run_id"] == "run1"
    assert metas[0] == metas[1]


@pytest.mark.parametrize("writer", SIDES)
def test_cross_resume_stdout(resumed, writer):
    (prc, pout, _, _), (rrc, rout, _, _) = (resumed(writer, "port"),
                                            resumed(writer, "ref"))
    assert prc == rrc == 0
    assert "=== Resumed from state_00000002.npz (window 2) ===" in pout
    assert pout == rout


@pytest.mark.parametrize("writer", SIDES)
def test_cross_resume_records(resumed, writer):
    _, _, got, _ = resumed(writer, "port")
    _, _, want, _ = resumed(writer, "ref")
    ck.assert_records_equal(got, want)


@pytest.mark.parametrize("writer", SIDES)
def test_cross_resume_run_dirs(resumed, writer):
    """The resumed runs' -run-dir artifacts: result.json's Stats and
    fingerprint (basis "windows": the windows after the resume) and
    every telemetry.npz array equal."""
    pdir, rdir = resumed(writer, "port")[3], resumed(writer, "ref")[3]
    rd.check_result_and_npz(pdir, rdir)
    got = json.load(open(pdir / "run" / "result.json"))
    assert got["fingerprint_basis"] == "windows"
    assert got["fingerprint_windows"] == got["gossip_windows"] > 0


@pytest.mark.parametrize("writer", SIDES)
def test_resume_continues_the_trajectory(resumed, uninterrupted, writer):
    """A resumed run ends on the uninterrupted run's Stats, and its
    coverage lines are that run's from window 3 on."""
    _, out, rec, _ = resumed(writer, "port")
    prc, plain, want = uninterrupted
    assert prc == 0
    assert {k: rec[k] for k in ck.STATS} == {k: want[k] for k in ck.STATS}
    tail = plain.split("=== Broadcast one message ===\n")[1].splitlines()
    assert out.split("=== Broadcast one message ===\n")[1].splitlines() \
        == tail[2:]


@pytest.mark.parametrize("keep", (0, 1, 2))
def test_ckpt_keep_keeps_the_same_files(tmp_path, keep):
    lists = {}
    for side in SIDES:
        d = tmp_path / side
        rc, _ = ck.run_cli(side, KOUT + [
            "-checkpoint-every", "1", "-max-rounds", "50", "-ckpt-keep",
            str(keep), "-checkpoint-dir", str(d), "-quiet"])
        assert rc == 2
        lists[side] = sorted(os.listdir(d))
    assert lists["port"] == lists["ref"]
    assert len(lists["port"]) == 2 * (keep or 5)


@pytest.mark.parametrize("run_id", ("run1", "run2"))
def test_run_id_provenance_alike(written, tmp_path, run_id):
    """-run-id run1 adopts the snapshot; another run id is refused by
    name, with the same text on both sides."""
    out = {}
    for side in SIDES:
        src = ck.copy_dir(written("ref")[2], tmp_path / side)
        argv = KOUT + ["-resume", "-checkpoint-dir", str(src), "-run-id",
                       run_id, "-quiet"]
        try:
            out[side] = ck.run_cli(side, argv)
        except ValueError as e:
            out[side] = str(e).replace(str(src), "<dir>")
    assert out["port"] == out["ref"]
    assert (run_id == "run1") == (not isinstance(out["port"], str))


@pytest.mark.parametrize("case", ("no_dir_flag", "empty_dir"))
def test_bad_resume_refused_alike(tmp_path, case):
    msgs = {}
    for side in SIDES:
        argv = KOUT + ["-resume"]
        if case == "empty_dir":
            argv += ["-checkpoint-dir", str(tmp_path / "none")]
        with pytest.raises((ValueError, FileNotFoundError)) as e:
            ck.run_cli(side, argv)
        msgs[side] = (type(e.value), str(e.value))
    assert msgs["port"] == msgs["ref"]
