"""The spatial panels (``-telemetry-spatial on``) on one device against the
JAX package: the event engine under both ``-phase2-kernel`` gates, the
ring engine and PushSum, each on a 4-group scenario (a crash wave, or a
partition for PushSum), through both CLIs with ``-run-dir``, ``-log-jsonl``,
``-trace`` and ``-telemetry-summary`` (``torch_rundir.py``).  For each
case:

* telemetry.npz, the three panels and their column names among its
  arrays, is the JAX package's array for array;
* ``health.json`` is the JAX package's verdict, and
  ``scripts/compare_runs.py`` exits 0 between the two run dirs with no
  ``panel_deltas``;
* the port's spatial-on run prints the stdout of its spatial-off twin,
  writes its JSONL records (wall fields aside) and its result.json
  fingerprint and Stats: the panels go to the npz only;
* the group panel sums to the history's received and removed columns
  every window.

Then the watchdog's predicates over hand-built panels (the JAX package's
``tests/test_spatial.py`` cases), each verdict the JAX package's."""

import json

import numpy as np
import pytest

import torch_rundir as rd
from gossip_simulator_tpu.utils import health as jhealth
from gossip_simulator_tpu_torch.utils import health as thealth
from gossip_simulator_tpu_torch.utils import rng as trng
from gossip_simulator_tpu_torch.utils.telemetry import GCOL
from test_torch_rng import match_jax_threefry

KOUT = ["-graph", "kout", "-n", "2000", "-fanout", "6", "-seed", "3",
        "-crashrate", "0", "-coverage-target", "0.8"]
# Four id groups, half of group 1 crashed at 30 ms (no recovery).
WAVE = json.dumps({"groups": 4, "events": [
    {"type": "crash", "at": 30, "frac": 0.5, "group": 1}]})
# Four id groups cut apart from 10 to 40 ms.
CUT = json.dumps({"groups": 4, "events": [
    {"type": "partition", "start": 10, "end": 40}]})
CASES = {
    "event": KOUT + ["-scenario", WAVE],
    "event_xla": KOUT + ["-scenario", WAVE, "-phase2-kernel", "xla"],
    "ring": KOUT + ["-scenario", WAVE, "-engine", "ring"],
    "pushsum": ["-model", "pushsum", "-graph", "kout", "-n", "2000",
                "-fanout", "6", "-droprate", "0", "-crashrate", "0",
                "-seed", "1", "-scenario", CUT],
}
SPATIAL = ["-telemetry-spatial", "on"]


@pytest.fixture(autouse=True, scope="module")
def threefry_layout():
    """Draw in the counter layout this process's jax uses."""
    old = trng.partitionable()
    match_jax_threefry()
    yield
    trng.set_partitionable(old)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each case's port spatial-on, port spatial-off and JAX-package
    spatial-on runs, made on first use."""
    made = {}

    def get(name):
        if name not in made:
            base = tmp_path_factory.mktemp(name)
            made[name] = {
                "port": rd.run_side("port", CASES[name] + SPATIAL,
                                    base / "port"),
                "off": rd.run_side("port", CASES[name], base / "off"),
                "ref": rd.run_side("ref", CASES[name] + SPATIAL,
                                   base / "ref")}
        return made[name]

    return get


def _npz(side) -> dict:
    with np.load(side[2] / "run" / "telemetry.npz") as z:
        return {k: z[k] for k in z.files}


@pytest.mark.parametrize("name", sorted(CASES))
def test_panels_and_records_equal_the_jax_package(runs, name, capsys):
    r = runs(name)
    (prc, pout, pdir), (rrc, rout, rdir) = r["port"], r["ref"]
    assert prc == rrc
    assert rd.masked_stdout(pout) == rd.masked_stdout(rout)
    rd.check_result_and_npz(pdir, rdir)
    npz = _npz(r["port"])
    count = int(npz["gossip_count"])
    assert npz["spatial_group"].shape == (count, 4, 3)
    assert npz["spatial_shard"].shape == (count, 1, 5)
    assert npz["spatial_traffic"].shape == (count, 1, 1)
    cols = npz["gossip_cols"]
    grp = npz["spatial_group"]
    assert (grp[:, :, 0].sum(axis=1) == cols[:, GCOL["received"]]).all()
    assert (grp[:, :, 2].sum(axis=1) == cols[:, GCOL["removed"]]).all()
    assert (npz["spatial_shard"][:, 0, 0]
            == cols[:, GCOL["mail_high"]]).all()
    health = [json.load(open(d / "run" / "health.json"))
              for d in (pdir, rdir)]
    assert health[0] == health[1]
    assert health[0]["windows"] == count
    cmp = rd.compare_runs_module()
    capsys.readouterr()
    assert cmp.main([str(pdir / "run"), str(rdir / "run"), "--json"]) == 0
    doc = json.loads(capsys.readouterr().out)
    assert doc["panel_deltas"] == [] and doc["fingerprint"]["match"]


@pytest.mark.parametrize("name", sorted(CASES))
def test_spatial_on_records_equal_spatial_off(runs, name):
    """Arming the panels moves nothing the run prints or logs: the same
    stdout, JSONL records and result.json, and no health.json off."""
    r = runs(name)
    (_, out_on, on), (_, out_off, off) = r["port"], r["off"]
    assert rd.masked_stdout(out_on) == rd.masked_stdout(out_off)
    got, want = (rd.jsonl_records(on / "log.jsonl"),
                 rd.jsonl_records(off / "log.jsonl"))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for key in w:
            if key not in rd.WALL_FIELDS + ("run_dir",):
                assert g[key] == w[key], (w["event"], key)
    res_on, res_off = (json.load(open(d / "run" / "result.json"))
                       for d in (on, off))
    assert set(res_on) == set(res_off)
    for key in rd.compare_runs_module().STAT_FIELDS:
        assert res_on.get(key) == res_off.get(key), key
    assert not (off / "run" / "health.json").exists()
    assert "spatial_group" not in _npz(r["off"])


# The JAX package's hand-built watchdog panels (tests/test_spatial.py):
# name: (received gauge per window and group, mail_high per window and
# shard, exch_rcvd per window and shard, cap).
def _recv(rows):
    return [[[v, 0, 0] for v in row] for row in rows]


HEALTH = {
    "healthy": (_recv([[10 * w] for w in range(1, 6)]), [[3]] * 5,
                [[w] for w in range(1, 6)], 8),
    "stuck_at_cap": (_recv([[w] for w in range(1, 5)]),
                     [[2, 8], [8, 8], [3, 8], [4, 8]],
                     [[1, 1], [2, 2], [3, 3], [4, 4]], 8),
    "stuck_no_cap": (_recv([[w] for w in range(1, 5)]),
                     [[2, 8], [8, 8], [3, 8], [4, 8]],
                     [[1, 1], [2, 2], [3, 3], [4, 4]], None),
    "zero_delivery": (_recv([[w] for w in range(1, 6)]), [[2, 2]] * 5,
                      [[1, 1], [2, 1], [3, 1], [4, 1], [5, 1]], None),
    "all_silent": (_recv([[w] for w in range(1, 6)]), [[2, 2]] * 5,
                   [[3, 3]] * 5, None),
    "group_stall": (_recv([[10, 9, 20], [20, 5, 20], [30, 5, 20],
                           [40, 5, 20], [50, 5, 20]]), [[2]] * 5,
                    [[w] for w in range(1, 6)], None),
    "too_short": (_recv([[1], [2]]), [[8], [8]], [[1], [2]], 8),
}


def _panels(group, high, rcvd) -> dict:
    group = np.asarray(group, np.int32)
    high = np.asarray(high, np.int32)
    w, s = high.shape
    shard = np.zeros((w, s, 5), np.int32)
    shard[:, :, 0] = high
    shard[:, :, 4] = rcvd
    return {"count": w, "spatial_group": group, "spatial_shard": shard,
            "spatial_traffic": np.zeros((w, s, s), np.int32)}


@pytest.mark.parametrize("name", sorted(HEALTH) + ["no_data", "no_panels"])
def test_health_verdict_equals_the_jax_package(name):
    if name == "no_data":
        snap = None
    elif name == "no_panels":
        snap = {"count": 3}
    else:
        group, high, rcvd, cap = HEALTH[name]
        snap = _panels(group, high, rcvd)
    cap = HEALTH[name][3] if name in HEALTH else None
    got = thealth.report_health(thealth.evaluate_health(snap, cap=cap))
    assert got == jhealth.evaluate_health(snap, cap=cap)
    if name in ("healthy", "stuck_no_cap", "all_silent", "too_short"):
        assert got["status"] == "ok"
    elif name in HEALTH:
        assert got["status"] == "degraded"
    else:
        assert got["status"] == "no-data"
