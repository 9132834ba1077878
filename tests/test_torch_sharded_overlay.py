"""In-process twins of the sharded tick-faithful overlay (``-graph
overlay`` under ``-backend sharded`` at n <= 10M, the default run),
followed by phase 2 on the event engine or the ring engine, on 2 and 8
shards, under ``-phase1-kernel`` and ``-deliver-kernel`` auto (the
port's kernels' plain versions) and xla; one case carries ``-rumors 4``
into the event engine, one runs the device loops (``-telemetry on``).
``test_torch_sharded_overlay_rounds.py`` has the rounds overlay.

Both sides run ``run_simulation(cfg, stepper=ShardedStepper(cfg,
n_devices=S))`` (``torch_sharded_run.py``), n = 2000.  Each reference
run is made once; the port's run is held to it window for window: the
overlay's makeups, breakups and quiescence window (the windowed loop's,
under ``-telemetry off``), the phase-1 state after OSNAP windows
(friends, friend_cnt, the rings, mailbox_dropped), the phase-2 Stats,
the transcript (note lines aside) and the final leaves, whose friends
table is the one the overlay built; under ``-telemetry on`` both
phases' histories."""

import pytest

import torch_sharded_run as sr
from gossip_simulator_tpu_torch.utils import rng as trng
from test_torch_rng import match_jax_threefry

OV = dict(n=2000, seed=1, coverage_target=0.9)
XLA = dict(phase1_kernel="xla", deliver_kernel="xla")
# name: (Config fields, shards, -telemetry)
CASES = {
    "ticks_event_s2": (OV, 2, "off"),
    "ticks_event_s8_xla": (dict(OV, **XLA), 8, "off"),
    "ticks_ring_s8": (dict(OV, engine="ring", seed=4), 8, "off"),
    "ticks_event_s8_telemetry": (dict(OV, seed=6), 8, "on"),
    "ticks_rumors_s2": (dict(OV, seed=2, rumors=4, crashrate=0.0), 2,
                        "off"),
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
