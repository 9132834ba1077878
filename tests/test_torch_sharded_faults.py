"""The sharded backend's fault branches against the JAX package:
``run_simulation(cfg, stepper=ShardedStepper(cfg, n_devices=S))`` on both
sides (the port's shards laid out on the CPU, the JAX package's on its
fake 8-device mesh), n <= 4000, ``-telemetry off -exchange-pipeline off``.

Each reference run is made once, by the module fixture, and the port is
held to it under ``-phase2-kernel auto`` (``fused_recv_land``'s plain
version at S > 1, ``fused_emit``'s at S = 1) and ``xla``: the same Stats
every window (the fault counters too), the same transcript (note lines
aside) and the same final state leaves.  Cases, each on 2 and 8 shards:
the churn timeline with and without healing, a partition alone, a crash
wave healed after 50 ms, and SIR under the timeline; the heal case and
PushSum also under
``-telemetry on`` (the run-to-target loop), and the heal case on 8
shards with its route buffers cut below their load (the exchange's
overflow).  Then the two invariances
that do not
depend on the reference: the scenario's crash and recovery schedule is
the same at S = 1 and S = 8 (its draws take global ids off the unfolded
key), and sharded PushSum under churn with healing equals the
single-device run window for window.
"""

import contextlib
import io
from unittest import mock

import numpy as np
import pytest

from gossip_simulator_tpu.backends.sharded import ShardedStepper as JStepper
from gossip_simulator_tpu.config import Config as JConfig
from gossip_simulator_tpu.driver import run_simulation as jrun
from gossip_simulator_tpu.parallel import exchange as jex
from gossip_simulator_tpu.utils.metrics import ProgressPrinter as JPrinter
from gossip_simulator_tpu_torch.backends import ShardedStepper as TStepper
from gossip_simulator_tpu_torch.backends import TorchStepper
from gossip_simulator_tpu_torch.config import Config as TConfig
from gossip_simulator_tpu_torch.driver import run_simulation as trun
from gossip_simulator_tpu_torch.models import event, pushsum
from gossip_simulator_tpu_torch.parallel import event_sharded
from gossip_simulator_tpu_torch.parallel import exchange as tex
from gossip_simulator_tpu_torch.utils import rng as trng
from gossip_simulator_tpu_torch.utils.metrics import \
    ProgressPrinter as TPrinter
from test_torch_rng import match_jax_threefry

# bench.py's churn timeline: 2 groups, 60 ms reboots, churn, a crash wave
# in group 1, a partition.
CHURN = ('{"groups": 2, "downtime": 60, "events": ['
         '{"type": "churn", "start": 0, "end": 150, "rate": 2.0},'
         '{"type": "crash", "at": 30, "frac": 0.3, "group": 1},'
         '{"type": "partition", "start": 20, "end": 60}]}')
PARTITION = ('{"groups": 2, "events": '
             '[{"type": "partition", "start": 0, "end": 60}]}')
WAVE = ('{"groups": 4, "downtime": 500, "events": '
        '[{"type": "crash", "at": 20, "frac": 0.4}]}')
KOUT = dict(graph="kout", n=4000, fanout=6, seed=3, crashrate=0.0,
            coverage_target=0.99)
HEAL = dict(overlay_heal="on", max_rounds=400)
SIR = dict(KOUT, fanout=4, protocol="sir", removal_rate=0.2,
           coverage_target=0.8, crashrate=0.001, scenario=CHURN)
# name: (Config fields), each on 2 and 8 shards
KINDS = {
    "churn_heal": dict(KOUT, scenario=CHURN, **HEAL),
    "churn_noheal": dict(KOUT, scenario=CHURN, max_rounds=300),
    "partition": dict(KOUT, scenario=PARTITION, max_rounds=400),
    "wave_detect50": dict(KOUT, scenario=WAVE, heal_detect_ms=50, **HEAL),
    "sir_churn": SIR,
}
# name: (Config fields, shards)
CASES = {f"{kind}_s{s}": (kw, s) for kind, kw in KINDS.items()
         for s in (2, 8)}
# The churn timeline with healing on 8 shards, its route buffers cut
# (tight_caps); seed 5, so that no run of another case is reused.
OVERFLOW = (dict(KINDS["churn_heal"], seed=5), 8)
PS_CHURN = dict(model="pushsum", graph="kout", n=2000, fanout=6,
                droprate=0.0, crashrate=0.0, seed=1, scenario=CHURN,
                overlay_heal="on")


def _tight_chernoff(m_edges, n_shards):
    return (m_edges if n_shards <= 1
            else max(1, -(-m_edges // n_shards) // 16))


def _tight_epidemic(n_local, k, n_shards, safety=4):
    return max(1, n_local * k // n_shards // 64)


@contextlib.contextmanager
def tight_caps(ex):
    """`ex` (either package's exchange module) sizes every route buffer
    far below its load: the emission's wire cap a sixteenth of the mean
    pair load, the heal's and the seed's a sixty-fourth, so that the
    exchange drops entries in the emission and in the heal's re-sends."""
    with mock.patch.object(ex, "chernoff_cap", _tight_chernoff), \
            mock.patch.object(ex, "epidemic_cap", _tight_epidemic):
        yield


class Recording:
    """A stepper as run_simulation sees it: records each window's Stats."""

    def __init__(self, stepper):
        self.inner = stepper
        self.rows = []

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def gossip_window(self):
        st = self.inner.gossip_window()
        self.rows.append(st.to_dict())
        return st


def _twin_lines(text):
    return [x for x in text.splitlines() if not x.startswith("(")]


def _ref_run(kw, shards, telemetry="off"):
    cfg = JConfig(**kw, backend="sharded", telemetry=telemetry,
                  exchange_pipeline="off").validate()
    rec = Recording(JStepper(cfg, n_devices=shards))
    out = io.StringIO()
    res = jrun(cfg, printer=JPrinter(out=out), stepper=rec)
    return out.getvalue(), rec, res, rec.state_pytree()


def _port_run(kw, shards, telemetry="off", **extra):
    cfg = TConfig(**kw, backend="sharded", telemetry=telemetry,
                  exchange_pipeline="off", **extra).validate()
    rec = Recording(TStepper(cfg, n_devices=shards, device="cpu"))
    out = io.StringIO()
    res = trun(cfg, printer=TPrinter(out=out), stepper=rec)
    return out.getvalue(), rec, res, rec.state_pytree()


@pytest.fixture(scope="module")
def reference():
    """The JAX package's run of each case, made on first use."""
    runs = {}

    def get(name, telemetry="off"):
        if (name, telemetry) not in runs:
            if name == "overflow":
                with tight_caps(jex):
                    runs[name, telemetry] = _ref_run(*OVERFLOW, telemetry)
                return runs[name, telemetry]
            kw, shards = ((PS_CHURN, 8) if name == "pushsum_churn_s8"
                          else CASES[name])
            runs[name, telemetry] = _ref_run(kw, shards, telemetry)
        return runs[name, telemetry]

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
def test_sharded_fault_twin(reference, name, gate):
    text, ref, res, leaves = reference(name)
    kw, shards = CASES[name]
    out, rec, got, tree = _port_run(kw, shards, phase2_kernel=gate)
    assert len(ref.rows) > 3 and rec.rows == ref.rows
    last = ref.rows[-1]
    assert last["scen_crashed"] > 0 or last["part_dropped"] > 0
    if kw.get("overlay_heal") == "on":
        assert last["heal_repaired"] > 0
    assert _twin_lines(out) == _twin_lines(text)
    assert (got.converged, got.coverage_ms) == (res.converged,
                                                res.coverage_ms)
    _assert_same_leaves(leaves, tree)


@pytest.mark.parametrize("name", ("churn_heal_s8", "pushsum_churn_s8"))
def test_sharded_fault_run_to_target_twin(reference, name):
    """-telemetry on: the run-to-target loop (no in-flight exit under
    healing) and the replayed history give the JAX package's transcript,
    Stats and final leaves."""
    text, _, res, leaves = reference(name, "on")
    kw, shards = ((PS_CHURN, 8) if name == "pushsum_churn_s8"
                  else CASES[name])
    out, _, got, tree = _port_run(kw, shards, "on")
    assert "covered" in text and _twin_lines(out) == _twin_lines(text)
    assert got.stats.to_dict() == res.stats.to_dict()
    _assert_same_leaves(leaves, tree)


@pytest.mark.parametrize("gate", ("auto", "xla"))
def test_sharded_exchange_overflow_twin(reference, gate):
    """The churn timeline with healing on 8 shards with every route buffer
    cut far below its load, in both packages: the exchange drops entries
    from the emission batches and from the heal's re-sends, and the port
    counts and drops the same ones (Stats every window, transcript,
    leaves)."""
    text, ref, res, leaves = reference("overflow")
    heal_drops = []
    make_heal = event_sharded.make_sharded_event_heal

    def counting_heal(cfg, mesh):
        heal = make_heal(cfg, mesh)

        def heal_fn(states, base_key):
            before = int(states[0].exchange_overflow)
            heal(states, base_key)
            heal_drops.append(int(states[0].exchange_overflow) - before)
            return states

        return heal_fn

    with tight_caps(tex), mock.patch.object(
            event_sharded, "make_sharded_event_heal", counting_heal):
        out, rec, got, tree = _port_run(*OVERFLOW, phase2_kernel=gate)
    total = ref.rows[-1]["exchange_overflow"]
    assert ref.rows[-1]["heal_repaired"] > 0
    # Both the emission and the heal's re-sends overflowed.
    assert 0 < sum(heal_drops) < total
    assert rec.rows == ref.rows
    assert _twin_lines(out) == _twin_lines(text)
    assert (got.converged, got.coverage_ms) == (res.converged,
                                                res.coverage_ms)
    _assert_same_leaves(leaves, tree)


def _crash_schedule(shards, windows):
    """Each window's (scen_crashed, scen_recovered) and the final crashed
    bits and crash clock over the global node axis, of the port's run of
    the JAX package's invariance scenario on `shards` shards."""
    scen = ('{"groups": 4, "downtime": 80, "events": ['
            '{"type": "churn", "start": 0, "end": 120, "rate": 1.5},'
            '{"type": "crash", "at": 40, "frac": 0.5, "group": 2}]}')
    cfg = TConfig(n=4000, graph="kout", fanout=6, seed=3, crashrate=0.0,
                  coverage_target=0.99, max_rounds=260, scenario=scen,
                  backend="sharded", telemetry="off").validate()
    st = TStepper(cfg, n_devices=shards, device="cpu")
    st.init()
    st.seed()
    rows = []
    for _ in range(windows):
        s = st.gossip_window()
        rows.append((s.scen_crashed, s.scen_recovered))
    n_local = cfg.n // shards
    crashed = np.concatenate([(x.flags[:n_local] & event.CRASHED).numpy()
                              for x in st.state])
    down = np.concatenate([x.down_since.numpy() for x in st.state])
    return rows, crashed, down


def test_scenario_draws_are_shard_count_invariant():
    """The port's twin of the JAX package's test of the same name: S = 1
    and S = 8 crash and recover the same nodes at the same ticks (the
    delay and drop draws, shard-folded, diverge by design)."""
    rows1, crashed1, down1 = _crash_schedule(1, 16)
    rows8, crashed8, down8 = _crash_schedule(8, 16)
    assert rows1 == rows8 and rows1[-1][0] > 0 and rows1[-1][1] > 0
    assert np.array_equal(crashed1, crashed8) and crashed1.any()
    assert np.array_equal(down1, down8)


def _pushsum_rows(stepper, windows):
    stepper.init()
    stepper.seed()
    return [stepper.gossip_window().to_dict() for _ in range(windows)]


def test_pushsum_churn_heal_is_shard_count_invariant(reference):
    """Sharded PushSum under the churn timeline with healing: S = 8 equals
    the single-device run window for window and in its masses (the JAX
    package's test_sharded_matches_single_device_under_churn), and equals
    the JAX package's S = 8 run."""
    text, ref, res, leaves = reference("pushsum_churn_s8")
    out, rec, got, tree = _port_run(PS_CHURN, 8)
    assert rec.rows == ref.rows and ref.rows[-1]["scen_crashed"] > 0
    assert _twin_lines(out) == _twin_lines(text)
    _assert_same_leaves(leaves, tree)
    cfg = TConfig(**PS_CHURN, backend="jax", telemetry="off").validate()
    single = TorchStepper(cfg, device="cpu")
    want = _pushsum_rows(single, len(ref.rows))
    assert rec.rows == want
    mass = np.concatenate([x.mass.numpy() for x in rec.inner.state])
    assert np.array_equal(mass, single.state.mass.numpy())
    assert pushsum.conserved_totals(single.state, cfg) == [
        sum(c) for c in zip(*(pushsum.conserved_totals(x, cfg)
                              for x in rec.inner.state))]
