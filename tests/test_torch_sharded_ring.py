"""In-process twins of the sharded ring engine in ticks mode (``-engine
ring`` under ``-backend sharded``): SI on kout with ``-compact on``, on 2
and 8 shards, the device loop under ``-telemetry on``, and
``-exchange-pipeline double`` on both sides (the reference's staged
deposit; ``exchange_inflight_hwm`` 2 in the port's history); and the
spatial panels with ``-run-dir`` on both sides (the panels, the traffic
matrix and ``exch_counts`` are the JAX package's, and the matrix's
identities hold every window).  ``test_torch_sharded_ring_graphs.py``
has ``-compact off``, SIR and erdos, ``test_torch_sharded_ring_rounds.py``
rounds, push-pull and healing.

Both sides run ``run_simulation(cfg, stepper=ShardedStepper(cfg,
n_devices=S))`` (``torch_sharded_run.py``; the port's shards on the
CPU, the JAX package's on its fake 8-device mesh), n = 2000; each
reference run is made once, and the port's run of the same Config is
held to it: the same per-window Stats (under ``-telemetry off``), the
same transcript (note lines aside), the same result, the same final
state leaves and histories."""

import numpy as np
import pytest

import torch_rundir as rd
import torch_sharded_run as sr
from gossip_simulator_tpu_torch.utils import rng as trng
from gossip_simulator_tpu_torch.utils.telemetry import GCOL
from test_torch_rng import match_jax_threefry

KOUT = dict(engine="ring", graph="kout", n=2000, fanout=6, seed=5)
# name: (Config fields, shards, -telemetry, -exchange-pipeline)
CASES = {
    "si_s2": (KOUT, 2, "off", "off"),
    "si_s8": (KOUT, 8, "off", "off"),
    "si_telemetry_s8": (KOUT, 8, "on", "off"),
    "si_double_s8": (dict(KOUT, crashrate=0.0), 8, "on", "double"),
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
                  CASES[name][2], CASES[name][3])


SPATIAL = ["-engine", "ring", "-graph", "kout", "-n", "2000", "-fanout",
           "6", "-seed", "4", "-exchange-pipeline", "off",
           "-telemetry-spatial", "on"]


def check_panels(tmp_path, argv, shards):
    """The spatial panels and the exchange counters of the sharded ring
    engine are the JAX package's, and the matrix's identities hold."""
    prc, pout, pdir = rd.run_side("port", argv, tmp_path / "port", shards)
    rrc, rout, rdir = rd.run_side("ref", argv, tmp_path / "ref", shards)
    assert prc == rrc
    assert rd.masked_stdout(pout) == rd.masked_stdout(rout)
    rd.check_result_and_npz(pdir, rdir)
    with np.load(pdir / "run" / "telemetry.npz") as z:
        cols, shd, tr = (z[k] for k in ("gossip_cols", "spatial_shard",
                                        "spatial_traffic"))
    assert shd.shape[1:] == (shards, 5) and tr.shape[1:] == (shards, shards)
    assert (shd[:, :, 1].sum(axis=1) == cols[:, GCOL["received"]]).all()
    assert (tr.sum(axis=1) == shd[:, :, 4]).all()
    assert (np.diff(tr, axis=0) >= 0).all() and (tr[-1] > 0).all()
    assert (shd[:, :, 2].sum(axis=1) == cols[:, GCOL["overflow"]]).all()


def test_sharded_ring_panels(tmp_path):
    check_panels(tmp_path, SPATIAL, 8)
