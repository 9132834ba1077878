"""In-process twins of the sharded backend: ``run_simulation(cfg,
stepper=ShardedStepper(cfg, n_devices=S))`` on both sides, S = 2 and 8
shards (the port's laid out on the CPU, the JAX package's on its fake
8-device mesh), n <= 4000, ``-telemetry off -exchange-pipeline off``.

Each reference run is made once, by the module fixture, and every port
run is held to it under ``-phase2-kernel auto`` (``fused_recv_land``'s
plain version) and ``xla`` (the decode and ring-append chain): the same
per-window Stats, the same transcript (note lines aside: an explicit
``-phase2-kernel`` prints one on the port's side only) and the same final
state leaves.  One case twins the reference's ``-exchange-pipeline
double`` schedule, which it pins equal to ``off``.  Two cases also take
the reference's sharded state after SNAP windows and continue it in the
port to identical Stats and leaves.
"""

import io

import numpy as np
import pytest

from gossip_simulator_tpu.backends.sharded import ShardedStepper as JStepper
from gossip_simulator_tpu.config import Config as JConfig
from gossip_simulator_tpu.driver import run_simulation as jrun
from gossip_simulator_tpu.utils.metrics import ProgressPrinter as JPrinter
from gossip_simulator_tpu_torch.backends import ShardedStepper as TStepper
from gossip_simulator_tpu_torch.config import Config as TConfig
from gossip_simulator_tpu_torch.driver import run_simulation as trun
from gossip_simulator_tpu_torch.utils import rng as trng
from gossip_simulator_tpu_torch.utils.metrics import \
    ProgressPrinter as TPrinter
from test_torch_rng import match_jax_threefry

KOUT = dict(graph="kout", n=4000, fanout=6, seed=5)
ERDOS = dict(graph="erdos", n=4000, fanout=8, seed=1)
PS = dict(model="pushsum", graph="kout", n=2000, fanout=6, droprate=0.0,
          crashrate=0.0, seed=1)
# name: (Config fields, shards, the reference's -exchange-pipeline)
CASES = {
    "si_s8": (KOUT, 8, "off"),
    "si_crash0_s2": (dict(KOUT, crashrate=0.0), 2, "off"),
    "si_crash0_s8_double": (dict(KOUT, crashrate=0.0), 8, "double"),
    "sir_s8": (dict(KOUT, fanout=4, seed=3, protocol="sir",
                    removal_rate=0.2, coverage_target=0.8), 8, "off"),
    "ring_s2": (dict(graph="ring", n=800, fanout=8, seed=2,
                     coverage_target=0.5), 2, "off"),
    "erdos_s8": (ERDOS, 8, "off"),
    "erdos_pallas_s2": (dict(ERDOS, pallas=True), 2, "off"),
    "pushsum_s8": (PS, 8, "off"),
}
SNAP = 3  # windows the reference runs before its state crosses over
CONTINUED = ("si_s8", "pushsum_s8")


def _row(st):
    return (st.round, st.total_received, st.total_message, st.total_crashed,
            st.total_removed, st.mailbox_dropped, st.exchange_overflow,
            st.exhausted)


class Recording:
    """A stepper as run_simulation sees it: records each window's Stats and,
    after window SNAP, the state (the JAX package's leaves)."""

    def __init__(self, stepper):
        self.inner = stepper
        self.rows = []
        self.snap = None

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def gossip_window(self):
        st = self.inner.gossip_window()
        self.rows.append(_row(st))
        if len(self.rows) == SNAP:
            self.snap = self.inner.state_pytree()
        return st


def _twin_lines(text):
    return [x for x in text.splitlines() if not x.startswith("(")]


@pytest.fixture(scope="module")
def reference():
    """The JAX package's run of each case, made on first use."""
    runs = {}

    def get(name):
        if name not in runs:
            kw, shards, pipe = CASES[name]
            cfg = JConfig(**kw, backend="sharded", telemetry="off",
                          exchange_pipeline=pipe).validate()
            rec = Recording(JStepper(cfg, n_devices=shards))
            out = io.StringIO()
            res = jrun(cfg, printer=JPrinter(out=out), stepper=rec)
            runs[name] = (out.getvalue(), rec, res, rec.state_pytree())
        return runs[name]

    return get


@pytest.fixture(autouse=True, scope="module")
def threefry_layout():
    """Draw in the counter layout this process's jax uses."""
    old = trng.partitionable()
    match_jax_threefry()
    yield
    trng.set_partitionable(old)


def _assert_same_leaves(want, got):
    assert set(want) == set(got)
    for key in want:
        assert np.array_equal(np.asarray(want[key]), np.asarray(got[key])), \
            key


@pytest.mark.parametrize("gate", ("auto", "xla"))
@pytest.mark.parametrize("name", sorted(CASES))
def test_sharded_twin(reference, name, gate):
    text, ref, res, leaves = reference(name)
    kw, shards, _ = CASES[name]
    cfg = TConfig(**kw, backend="sharded", telemetry="off",
                  exchange_pipeline="off", phase2_kernel=gate).validate()
    rec = Recording(TStepper(cfg, n_devices=shards, device="cpu"))
    out = io.StringIO()
    got = trun(cfg, printer=TPrinter(out=out), stepper=rec)
    assert len(ref.rows) > SNAP and rec.rows == ref.rows
    assert _twin_lines(out.getvalue()) == _twin_lines(text)
    assert "(exchange-pipeline: off (requested off))" in out.getvalue()
    assert (got.converged, got.coverage_ms) == (res.converged,
                                                res.coverage_ms)
    _assert_same_leaves(leaves, rec.state_pytree())


@pytest.mark.parametrize("name", CONTINUED)
def test_jax_sharded_state_continues_in_the_port(reference, name):
    """The reference's 8-shard state after SNAP windows, loaded into the
    port, runs the rest of the reference's windows to the same Stats and
    the same final leaves."""
    _, ref, _, leaves = reference(name)
    kw, shards, _ = CASES[name]
    cfg = TConfig(**kw, backend="sharded", telemetry="off").validate()
    st = TStepper(cfg, n_devices=shards, device="cpu")
    st.init()
    st.load_state_pytree(ref.snap)
    rows = [_row(st.gossip_window()) for _ in ref.rows[SNAP:]]
    assert rows == ref.rows[SNAP:]
    _assert_same_leaves(leaves, st.state_pytree())
