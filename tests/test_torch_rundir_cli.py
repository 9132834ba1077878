"""The port's run records against the JAX package's, on the same argv with
``-run-dir``, ``-log-jsonl``, ``-trace`` and ``-telemetry-summary``
(``torch_rundir.py``): the default overlay run, the rounds overlay, and
the event engine under SI and SIR.  For each case:

* stdout is byte-identical, the summary block's wall lines masked;
* the JSONL records are equal key for key, their wall fields aside;
* result.json's Stats fields and the telemetry.npz arrays are equal;
* ``scripts/compare_runs.py PORT_DIR REF_DIR`` exits 0;
* the trace is valid Chrome JSON with the reference's span names.

Each side runs once a case (module fixture).  ``-profile`` and ``-xprof``
write torch.profiler traces on the CPU."""

import json

import pytest

import torch_rundir as rd
from gossip_simulator_tpu_torch.cli import main as torch_main
from gossip_simulator_tpu_torch.utils import rng as trng
from test_torch_rng import match_jax_threefry

KOUT = ["-graph", "kout", "-n", "2000", "-fanout", "6", "-seed", "1"]
CASES = {
    "default_overlay": ["-n", "2000", "-seed", "1", "-coverage-target",
                        "0.9"],
    "rounds_overlay": ["-overlay-mode", "rounds", "-n", "3000", "-fanout",
                       "5", "-seed", "9", "-coverage-target", "0.9"],
    "event_si": KOUT,
    # A SIR wave that dies out mid-run: exit 2, "exhausted".
    "event_sir": ["-graph", "kout", "-n", "2000", "-fanout", "2", "-seed",
                  "3", "-protocol", "sir", "-removal-rate", "0.6",
                  "-droprate", "0.3"],
}


@pytest.fixture(autouse=True, scope="module")
def threefry_layout():
    """Draw in the counter layout this process's jax uses."""
    old = trng.partitionable()
    match_jax_threefry()
    yield
    trng.set_partitionable(old)


@pytest.fixture(scope="module")
def twins(tmp_path_factory):
    """Each case's (port, reference) runs, made on first use."""
    runs = {}

    def get(name):
        if name not in runs:
            base = tmp_path_factory.mktemp(name)
            runs[name] = tuple(
                rd.run_side(side, CASES[name], base / side)
                for side in ("port", "ref"))
        return runs[name]

    return get


@pytest.mark.parametrize("name", sorted(CASES))
def test_stdout_byte_identical(twins, name):
    (prc, pout, _), (rrc, rout, _) = twins(name)
    assert prc == rrc
    assert rd.masked_stdout(pout) == rd.masked_stdout(rout)
    assert "\n=== Telemetry ===" in pout


@pytest.mark.parametrize("name", sorted(CASES))
def test_jsonl_records_equal(twins, name):
    (_, _, pdir), (_, _, rdir) = twins(name)
    rd.check_jsonl(pdir, rdir)


@pytest.mark.parametrize("name", sorted(CASES))
def test_result_and_telemetry_npz_equal(twins, name):
    (_, _, pdir), (_, _, rdir) = twins(name)
    rd.check_result_and_npz(pdir, rdir)


@pytest.mark.parametrize("name", sorted(CASES))
def test_compare_runs_exits_0(twins, name, capsys):
    (_, _, pdir), (_, _, rdir) = twins(name)
    code = rd.compare_runs_module().main([str(pdir / "run"),
                                          str(rdir / "run")])
    assert code == 0, capsys.readouterr().out
    assert "fingerprint: MATCH" in capsys.readouterr().out


@pytest.mark.parametrize("name", sorted(CASES))
def test_trace_has_the_reference_spans(twins, name):
    (_, _, pdir), (_, _, rdir) = twins(name)
    rd.check_trace(pdir, rdir)


@pytest.mark.parametrize("flag", ("-profile", "-xprof"))
def test_profile_writes_a_trace(tmp_path, flag, capsys):
    """-profile (phase 2) and -xprof (the whole run, one record_function
    a span) write a Chrome trace on the CPU."""
    out = tmp_path / "prof"
    argv = KOUT + ["-device", "cpu", "-quiet"]
    argv += (["-profile", "-profile-dir", str(out)] if flag == "-profile"
             else ["-xprof", str(out)])
    assert torch_main(argv) == 0
    (path,) = out.glob("*.json")
    names = {e.get("name") for e in json.load(open(path))["traceEvents"]}
    if flag == "-xprof":
        assert {"init", "phase2.run_to_target",
                "phase2.compile+run"} <= names
    else:
        assert "phase2.run_to_target" not in names and len(names) > 10
