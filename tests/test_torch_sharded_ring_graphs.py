"""In-process twins of the sharded ring engine on its other graphs and
protocols in ticks mode: ``-compact off`` (the dense route, one a tick),
SIR on the ring lattice and on kout, and erdos, on 2 and 8 shards
(``torch_sharded_run.py``; the checks of
``test_torch_sharded_ring.py``)."""

import pytest

import torch_sharded_run as sr
from gossip_simulator_tpu_torch.utils import rng as trng
from test_torch_rng import match_jax_threefry

KOUT = dict(engine="ring", graph="kout", n=2000, fanout=6, seed=5)
# name: (Config fields, shards, -telemetry)
CASES = {
    "si_dense_s8": (dict(KOUT, compact="off"), 8, "off"),
    "sir_ring_s2": (dict(engine="ring", graph="ring", n=400, fanout=8,
                         seed=2, protocol="sir", removal_rate=0.2,
                         coverage_target=0.5), 2, "off"),
    "sir_dense_s8": (dict(KOUT, protocol="sir", removal_rate=0.2,
                          coverage_target=0.8, compact="off"), 8, "off"),
    "erdos_s8": (dict(engine="ring", graph="erdos", n=2000, fanout=8,
                      seed=1), 8, "off"),
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
