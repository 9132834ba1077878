"""In-process twins of the sharded rounds overlay (``-overlay-mode
rounds``, and ``-time-mode rounds``) under ``-backend sharded``, followed
by phase 2 on the event engine or the ring engine, on 2 and 8 shards,
under ``-phase1-kernel`` and ``-deliver-kernel`` auto (the port's
kernels' plain versions: ``fused_request_round``'s per-round bootstrap)
and xla, one case under ``-telemetry on`` (the checks of
``test_torch_sharded_overlay.py``, ``torch_sharded_run.py``)."""

import pytest

import torch_sharded_run as sr
from gossip_simulator_tpu_torch.utils import rng as trng
from test_torch_rng import match_jax_threefry

OV = dict(n=2000, seed=1, coverage_target=0.9)
XLA = dict(phase1_kernel="xla", deliver_kernel="xla")
# name: (Config fields, shards, -telemetry)
CASES = {
    "rounds_event_s2": (dict(OV, overlay_mode="rounds"), 2, "off"),
    "rounds_event_s8_xla": (dict(OV, overlay_mode="rounds", **XLA), 8,
                            "off"),
    "rounds_ring_s8": (dict(OV, time_mode="rounds", seed=3), 8, "off"),
    "rounds_ring_s2_telemetry": (dict(OV, time_mode="rounds", seed=5), 2,
                                 "on"),
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
def test_sharded_overlay_twin(reference, name):
    want = reference(name)
    if CASES[name][2] == "off":
        overlay = want[1].overlay
        assert len(overlay) > sr.OSNAP and overlay[-1][2] == 1
    sr.check_twin(want, sr.run("port", *CASES[name]), CASES[name][2])
