"""The port's run records against the JAX package's (as in
``test_torch_rundir_cli.py``, helpers in ``torch_rundir.py``) for the
other engines and traffic: the ring engine, PushSum (its ``relerr_ppb``
column and ``report`` keys in the result record), ``-rumors 16``, a
``-scenario`` run with ``-overlay-heal on``, and ``-backend sharded`` at
S = 2 shards (in process, both sides given ``n_devices``)."""

import pytest

import torch_rundir as rd
from gossip_simulator_tpu_torch.utils import rng as trng
from test_torch_rng import match_jax_threefry

CHURN = ('{"groups": 2, "downtime": 60, "events": [{"type": "churn", '
         '"start": 0, "end": 150, "rate": 2.0}, {"type": "crash", "at": '
         '30, "frac": 0.3, "group": 1}, {"type": "partition", "start": '
         '20, "end": 60}]}')
KOUT = ["-graph", "kout", "-n", "3000", "-fanout", "6"]
# name: (argv, shards)
CASES = {
    "ring": (["-time-mode", "rounds", "-n", "3000", "-seed", "9",
              "-coverage-target", "0.9"], None),
    "pushsum": (["-model", "pushsum", "-graph", "kout", "-n", "2000",
                 "-fanout", "6", "-droprate", "0", "-crashrate", "0",
                 "-seed", "1"], None),
    "rumors16": (KOUT + ["-seed", "4", "-crashrate", "0",
                         "-coverage-target", "0.95", "-rumors", "16"], None),
    "scenario_heal": (KOUT + ["-crashrate", "0", "-seed", "0",
                              "-overlay-heal", "on", "-coverage-target",
                              "0.99", "-max-rounds", "2000", "-scenario",
                              CHURN], None),
    "sharded_s2": (["-backend", "sharded", "-graph", "kout", "-n", "4000",
                    "-fanout", "6", "-seed", "5", "-exchange-pipeline",
                    "off"], 2),
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
            argv, shards = CASES[name]
            runs[name] = tuple(
                rd.run_side(side, argv, base / side, shards=shards)
                for side in ("port", "ref"))
        return runs[name]

    return get


@pytest.mark.parametrize("name", sorted(CASES))
def test_stdout_byte_identical(twins, name):
    (prc, pout, _), (rrc, rout, _) = twins(name)
    assert prc == rrc
    assert rd.masked_stdout(pout) == rd.masked_stdout(rout)


@pytest.mark.parametrize("name", sorted(CASES))
def test_jsonl_records_equal(twins, name):
    (_, _, pdir), (_, _, rdir) = twins(name)
    rd.check_jsonl(pdir, rdir)
    result = rd.jsonl_records(pdir / "log.jsonl")[-2]
    assert result["event"] == "result"
    if name == "pushsum":
        assert {"converged_eps", "eps_ticks", "relerr_ppb"} <= set(result)
    if name == "rumors16":
        assert {"traffic", "rumor_latency_ms"} <= set(result)


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


@pytest.mark.parametrize("name", sorted(CASES))
def test_trace_has_the_reference_spans(twins, name):
    (_, _, pdir), (_, _, rdir) = twins(name)
    rd.check_trace(pdir, rdir)
