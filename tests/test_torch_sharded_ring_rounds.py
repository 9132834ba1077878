"""In-process twins of the sharded ring engine's other steps:
``-time-mode rounds``, ``-protocol pushpull`` (three routes a round, with
reception crashes) and the churn timeline with ``-overlay-heal on``, on
2 and 8 shards, each once under ``-telemetry on`` (the device loop); and
the spatial panels of rounds and push-pull with ``-run-dir`` on both
sides (``torch_sharded_run.py``; the checks of
``test_torch_sharded_ring.py``)."""

import pytest

import torch_sharded_run as sr
from gossip_simulator_tpu_torch.utils import rng as trng
from test_torch_rng import match_jax_threefry
from test_torch_sharded_faults import CHURN
from test_torch_sharded_ring import SPATIAL, check_panels

ROUNDS = dict(time_mode="rounds", graph="kout", n=2000, fanout=6, seed=2,
              coverage_target=0.95)
PP = dict(protocol="pushpull", graph="kout", n=2000, fanout=4, seed=7,
          crashrate=0.02, coverage_target=0.9, max_rounds=60)
HEAL = dict(engine="ring", graph="kout", n=2000, fanout=6, seed=3,
            crashrate=0.0, coverage_target=0.99, scenario=CHURN,
            overlay_heal="on", max_rounds=400)
# name: (Config fields, shards, -telemetry)
CASES = {
    "rounds_s2": (ROUNDS, 2, "off"),
    "rounds_s8": (ROUNDS, 8, "on"),
    "pushpull_s2": (PP, 2, "off"),
    "pushpull_s8": (PP, 8, "on"),
    "heal_s2": (HEAL, 2, "off"),
    "heal_s8": (HEAL, 8, "on"),
}
reference = sr.reference_fixture(CASES)


@pytest.fixture(autouse=True, scope="module")
def threefry_layout():
    """Draw in the counter layout this process's jax uses."""
    old = trng.partitionable()
    match_jax_threefry()
    yield
    trng.set_partitionable(old)


@pytest.mark.parametrize("name", sorted(CASES))
def test_sharded_ring_twin(reference, name):
    sr.check_twin(reference(name), sr.run("port", *CASES[name]),
                  CASES[name][2])


@pytest.mark.parametrize("argv,shards", (
    (SPATIAL[2:] + ["-time-mode", "rounds"], 2),
    (["-protocol", "pushpull", "-graph", "kout", "-n", "2000", "-fanout",
      "4", "-seed", "4", "-coverage-target", "0.9", "-max-rounds", "60",
      "-exchange-pipeline", "off", "-telemetry-spatial", "on"], 8)),
    ids=("rounds_s2", "pushpull_s8"))
def test_sharded_ring_panels(tmp_path, argv, shards):
    check_panels(tmp_path, argv, shards)
