"""``-backend sharded`` on the overlays and the ring engine through the
user entry points, against the JAX package.

* The CLI at S = 1 (what ``-backend sharded`` runs on one card): the
  port's ``cli.main`` on ``-device cpu`` against the JAX package's
  ``run_simulation`` with ``ShardedStepper(cfg, n_devices=1)``, with
  ``-run-dir``, ``-log-jsonl``, ``-trace`` and ``-telemetry-summary``
  (``torch_rundir.py``), under ``-telemetry on`` and ``off``: the default
  ``-graph overlay`` run (the tick-faithful overlay, then the event
  engine), ``-time-mode rounds`` (the rounds overlay, then the ring
  engine), ``-engine ring`` on kout and ``-protocol pushpull``.  Stdout
  is byte-identical (the summary's wall lines masked), result.json's
  Stats and telemetry.npz are equal, and ``scripts/compare_runs.py``
  exits 0.
* The same recordings on 8 shards, in process on both sides, for the
  overlay run and the ring engine.
"""

import pytest

import torch_rundir as rd
from gossip_simulator_tpu_torch.utils import rng as trng
from test_torch_rng import match_jax_threefry

SHARDED = ["-backend", "sharded", "-exchange-pipeline", "off"]
CLI = {
    "overlay": ["-n", "2000", "-seed", "1", "-coverage-target", "0.9"],
    "rounds_overlay": ["-time-mode", "rounds", "-n", "2000", "-seed", "3",
                       "-coverage-target", "0.9"],
    "ring_kout": ["-engine", "ring", "-graph", "kout", "-n", "2000",
                  "-fanout", "6", "-seed", "1"],
    "pushpull": ["-protocol", "pushpull", "-graph", "kout", "-n", "2000",
                 "-fanout", "4", "-seed", "2", "-coverage-target", "0.9",
                 "-max-rounds", "60"],
}


@pytest.fixture(autouse=True, scope="module")
def threefry_layout():
    """Draw in the counter layout this process's jax uses."""
    old = trng.partitionable()
    match_jax_threefry()
    yield
    trng.set_partitionable(old)


def _check(port, ref, capsys):
    (prc, pout, pdir), (rrc, rout, rdir) = port, ref
    assert prc == rrc == 0
    assert rd.masked_stdout(pout) == rd.masked_stdout(rout)
    assert "covered" in pout
    rd.check_result_and_npz(pdir, rdir)
    code = rd.compare_runs_module().main([str(pdir / "run"),
                                          str(rdir / "run")])
    assert code == 0, capsys.readouterr().out


@pytest.mark.parametrize("telemetry", ("on", "off"))
@pytest.mark.parametrize("name", sorted(CLI))
def test_cli_at_one_shard_matches_the_jax_package(tmp_path, name,
                                                  telemetry, capsys):
    argv = CLI[name] + SHARDED + ["-telemetry", telemetry]
    _check(rd.run_side("port", argv, tmp_path / "port"),
           rd.run_side("ref", argv, tmp_path / "ref", shards=1), capsys)


@pytest.mark.parametrize("name", ("overlay", "ring_kout"))
def test_run_dirs_on_eight_shards_match_the_jax_package(tmp_path, name,
                                                        capsys):
    argv = CLI[name] + SHARDED
    _check(rd.run_side("port", argv, tmp_path / "port", shards=8),
           rd.run_side("ref", argv, tmp_path / "ref", shards=8), capsys)
