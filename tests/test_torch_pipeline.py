"""``-exchange-pipeline double`` on the sharded backend against the JAX
package's ``double``: ``run_simulation(cfg, stepper=ShardedStepper(cfg,
n_devices=S))`` on both sides (the port's shards on the CPU, the JAX
package's on its fake 8-device mesh), ``-telemetry on`` (the
run-to-target loop and its history), n <= 4000.  Cases on 2 or 8 shards:
SI on the dense emission (mean degree 2) at both, SI on the compacted
emission with its narrow tail (a 1024-entry drain chunk and both
packages' narrow-tail floor cut, so that full and narrow batches both
run at these sizes), SIR, ``-rumors 4``, the churn timeline
with ``-overlay-heal on``, and PushSum.  The transcript, the final Stats,
every history row (``exchange_inflight_hwm`` reads 2) and the final
state leaves are the JAX package's.

The port's ``double`` keeps the serial route (one process holds every
shard, so a staged drain has nothing to overlap): on the port alone,
``off`` and ``double`` land every batch by the same calls and give the
same bits, ``exchange_inflight_hwm`` 1 against 2."""

import contextlib
import io
from unittest import mock

import numpy as np
import pytest

from gossip_simulator_tpu.backends.sharded import ShardedStepper as JStepper
from gossip_simulator_tpu.config import Config as JConfig
from gossip_simulator_tpu.driver import run_simulation as jrun
from gossip_simulator_tpu.models import event as jevent
from gossip_simulator_tpu.utils.metrics import ProgressPrinter as JPrinter
from gossip_simulator_tpu_torch.backends import ShardedStepper as TStepper
from gossip_simulator_tpu_torch.config import Config as TConfig
from gossip_simulator_tpu_torch.driver import run_simulation as trun
from gossip_simulator_tpu_torch.models import event as tevent
from gossip_simulator_tpu_torch.ops import mailbox, megakernel
from gossip_simulator_tpu_torch.utils import rng as trng
from gossip_simulator_tpu_torch.utils.metrics import \
    ProgressPrinter as TPrinter
from gossip_simulator_tpu_torch.utils.telemetry import GCOL
from test_torch_rng import match_jax_threefry
from test_torch_sharded_faults import CHURN

KOUT = dict(graph="kout", n=4000, fanout=6, seed=3, crashrate=0.0,
            coverage_target=0.99)
# name: (Config fields, shards, narrow tail at these sizes)
CASES = {
    "si_dense_s2": (dict(KOUT, fanout=2, coverage_target=0.9), 2, False),
    "si_dense_s8": (dict(KOUT, fanout=2, coverage_target=0.9), 8, False),
    # A 1024-entry drain chunk: 256-sender full batches, 32-sender narrow
    # ones, both kinds in a run at these sizes.
    "si_compacted_s8": (dict(KOUT, event_chunk=1024), 8, True),
    "sir_s2": (dict(KOUT, fanout=4, protocol="sir", removal_rate=0.2,
                    coverage_target=0.8, crashrate=0.001), 2, False),
    "rumors4_s8": (dict(KOUT, seed=4, rumors=4, coverage_target=0.95), 8,
                   False),
    "churn_heal_s2": (dict(KOUT, scenario=CHURN, overlay_heal="on",
                           max_rounds=300), 2, False),
    "pushsum_s8": (dict(model="pushsum", graph="kout", n=2000, fanout=6,
                        droprate=0.0, crashrate=0.0, seed=1), 8, False),
}


def _narrow(scap: int) -> int:
    """A narrow tail at any width: scap / 8 without the 1024-lane floor."""
    return scap // 8 if scap >= 8 else 0


@contextlib.contextmanager
def narrow_tail(on: bool):
    """Both packages' narrow-tail width without its floor (`on`)."""
    if not on:
        yield
        return
    with mock.patch.object(jevent, "narrow_tail_cap", _narrow), \
            mock.patch.object(tevent, "narrow_tail_cap", _narrow):
        yield


@pytest.fixture(autouse=True, scope="module")
def threefry_layout():
    """Draw in the counter layout this process's jax uses."""
    old = trng.partitionable()
    match_jax_threefry()
    yield
    trng.set_partitionable(old)


def _run(side: str, kw: dict, shards: int, pipeline: str = "double"):
    """(stdout, RunResult, history snapshot, state leaves) of one side."""
    conf, stepper, printer, run = (
        (TConfig, TStepper, TPrinter, trun) if side == "port"
        else (JConfig, JStepper, JPrinter, jrun))
    cfg = conf(**kw, backend="sharded", exchange_pipeline=pipeline
               ).validate()
    st = (stepper(cfg, n_devices=shards, device="cpu") if side == "port"
          else stepper(cfg, n_devices=shards))
    out = io.StringIO()
    res = run(cfg, printer=printer(out=out), stepper=st)
    return out.getvalue(), res, st._telem.gossip_snapshot(), \
        st.state_pytree()


@pytest.mark.parametrize("name", sorted(CASES))
def test_pipeline_double_twin(name):
    kw, shards, tail = CASES[name]
    with narrow_tail(tail):
        want = _run("ref", kw, shards)
        got = _run("port", kw, shards)
    (jout, jres, jhist, jleaves), (out, res, hist, leaves) = want, got
    assert "(exchange-pipeline: double (requested double))" in out
    assert out == jout
    assert res.stats.to_dict() == jres.stats.to_dict()
    assert hist["count"] == jhist["count"] > 2
    cols = hist["cols"][:hist["count"]]
    assert np.array_equal(cols, np.asarray(jhist["cols"])[:jhist["count"]])
    assert (cols[:, GCOL["exchange_inflight_hwm"]] == 2).all()
    assert set(leaves) == set(jleaves)
    for key in jleaves:
        assert np.array_equal(np.asarray(leaves[key]),
                              np.asarray(jleaves[key])), key


@pytest.mark.parametrize("name", ("si_dense_s8", "si_compacted_s8"))
def test_double_runs_the_serial_schedule(name):
    """Under double the dense and the compacted emission land every batch
    as the serial schedule does: the same fused_recv_land and ring-append
    calls, the same transcript (the gate line aside), history columns
    but exchange_inflight_hwm, and state."""
    kw, shards, tail = CASES[name]
    runs = {}
    for pipeline in ("off", "double"):
        calls = {"recv": 0, "append": 0}

        def counted(key, fn):
            def call(*a, **k):
                calls[key] += 1
                return fn(*a, **k)
            return call

        with narrow_tail(tail), mock.patch.object(
                megakernel, "fused_recv_land",
                counted("recv", megakernel.fused_recv_land)), \
                mock.patch("gossip_simulator_tpu_torch.parallel."
                           "event_sharded.ring_append",
                           counted("append", mailbox.ring_append)):
            out, res, hist, leaves = _run("port", kw, shards, pipeline)
        runs[pipeline] = (calls, out, hist, leaves)
    (serial, sout, shist, sleaves), (piped, pout, phist, pleaves) = (
        runs["off"], runs["double"])
    assert serial["recv"] > 0
    assert piped == serial
    cols = [h["cols"][:h["count"]] for h in (shist, phist)]
    hwm = GCOL["exchange_inflight_hwm"]
    assert (cols[0][:, hwm] == 1).all() and (cols[1][:, hwm] == 2).all()
    keep = [c for c in range(cols[0].shape[1]) if c != hwm]
    assert np.array_equal(cols[0][:, keep], cols[1][:, keep])
    assert [x for x in sout.splitlines() if not x.startswith("(")] == \
        [x for x in pout.splitlines() if not x.startswith("(")]
    for key in sleaves:
        assert np.array_equal(np.asarray(sleaves[key]),
                              np.asarray(pleaves[key])), key
