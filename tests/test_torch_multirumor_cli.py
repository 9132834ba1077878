"""Multi-rumor traffic on the event engine end to end on the CPU: the
port's transcript must be byte-identical to a live run of the JAX package
(its ``run_simulation`` in this process, what ``python -m
gossip_simulator_tpu`` prints), with equal ``Stats`` and the serving
report (``RunResult.report``) equal to the JAX package's
``_multi_rumor_report`` dict, for oneshot R = 16 and R = 40 (two words),
stream traffic under each ``-arrivals`` process (one slow enough that the
ring empties between injections), both ``-telemetry`` settings, the
default and the xla gates, ``-graph overlay`` and the churn, partition
and heal timeline.  Then a JAX state taken mid-stream carries into the
port, and both continue to identical leaves."""

import io

import numpy as np
import pytest

from gossip_simulator_tpu import config as jcfg
from gossip_simulator_tpu import driver as jdriver
from gossip_simulator_tpu.backends.jax_backend import JaxStepper
from gossip_simulator_tpu.utils.metrics import ProgressPrinter as JaxPrinter
from gossip_simulator_tpu_torch import config as tcfg
from gossip_simulator_tpu_torch import run_simulation as torch_run
from gossip_simulator_tpu_torch.backends import TorchStepper
from gossip_simulator_tpu_torch.utils import rng as trng
from gossip_simulator_tpu_torch.utils.metrics import \
    ProgressPrinter as TorchPrinter
from test_torch_rng import match_jax_threefry


@pytest.fixture(autouse=True, scope="module")
def threefry_layout():
    """Draw in the counter layout this process's jax uses."""
    old = trng.partitionable()
    match_jax_threefry()
    yield
    trng.set_partitionable(old)


# bench.py's CHURN_SCENARIO (the reference's acceptance timeline).
CHURN = ('{"groups": 2, "downtime": 60, "events": ['
         '{"type": "churn", "start": 0, "end": 150, "rate": 2.0},'
         '{"type": "crash", "at": 30, "frac": 0.3, "group": 1},'
         '{"type": "partition", "start": 20, "end": 60}]}')
# bench.py's multirumor rows' flags at a CPU size.
KOUT = ["-graph", "kout", "-n", "3000", "-fanout", "6", "-seed", "4",
        "-crashrate", "0", "-coverage-target", "0.95"]
STREAM = KOUT + ["-rumors", "8", "-traffic", "stream", "-stream-rate", "50"]
XLA = ["-phase2-kernel", "xla", "-deliver-kernel", "xla"]
TWINS = {
    "r16": KOUT + ["-rumors", "16"],
    "r16_telemetry_off": KOUT + ["-rumors", "16", "-telemetry", "off"],
    "r16_xla": KOUT + ["-rumors", "16"] + XLA,
    "r16_p2_xla": KOUT + ["-rumors", "16", "-phase2-kernel", "xla"],
    "r16_crash": KOUT + ["-rumors", "16", "-crashrate", "0.01"],
    "r40": KOUT + ["-rumors", "40"],
    "r40_xla_telemetry_off": KOUT + ["-rumors", "40", "-telemetry",
                                     "off"] + XLA,
    "stream_fixed": STREAM,
    "stream_fixed_telemetry_off": STREAM + ["-telemetry", "off"],
    "stream_fixed_xla": STREAM + XLA,
    "stream_poisson": STREAM + ["-arrivals", "poisson"],
    "stream_burst": STREAM + ["-arrivals", "burst"],
    "stream_diurnal": STREAM + ["-arrivals", "diurnal"],
    "stream_diurnal_telemetry_off": STREAM + ["-arrivals", "diurnal",
                                              "-telemetry", "off"],
    # One rumor every 200 ms: the ring empties between injections.
    "stream_slow": KOUT + ["-rumors", "4", "-traffic", "stream",
                           "-stream-rate", "5"],
    "stream_slow_telemetry_off": KOUT + ["-rumors", "4", "-traffic",
                                         "stream", "-stream-rate", "5",
                                         "-telemetry", "off"],
    "overlay_r8": ["-n", "2000", "-fanout", "6", "-seed", "1", "-rumors",
                   "8", "-crashrate", "0", "-coverage-target", "0.9"],
    # The ring engine's -rumors run (slice 4) reports as well.
    "ring_r16": KOUT + ["-engine", "ring", "-rumors", "16"],
    "churn_heal_r16": ["-graph", "kout", "-n", "2000", "-fanout", "6",
                       "-seed", "3", "-crashrate", "0", "-coverage-target",
                       "0.99", "-max-rounds", "600", "-rumors", "16",
                       "-scenario", CHURN, "-overlay-heal", "on"],
}


def _jax(argv):
    cfg = jcfg.parse_args(list(argv))
    out = io.StringIO()
    st = JaxStepper(cfg)
    res = jdriver.run_simulation(
        cfg, printer=JaxPrinter(enabled=cfg.progress, out=out), stepper=st)
    report = jdriver._multi_rumor_report(cfg, st, res.stats, res.coverage_ms)
    return out.getvalue(), res, report


def _port(argv):
    cfg, _ = tcfg.parse_cli(list(argv))
    out = io.StringIO()
    st = TorchStepper(cfg, device="cpu")
    res = torch_run(cfg, printer=TorchPrinter(cfg.progress, out=out),
                    stepper=st, device="cpu")
    return out.getvalue(), res, st, cfg


@pytest.mark.parametrize("name", sorted(TWINS))
def test_multirumor_cli_twin(name):
    argv = TWINS[name]
    jout, jres, jreport = _jax(argv)
    tout, tres, st, cfg = _port(argv)
    assert tout == jout
    assert tout.count("\n") > 10
    assert jres.stats.to_dict() == tres.stats.to_dict()
    assert (jres.converged, jres.coverage_ms) == (tres.converged,
                                                 tres.coverage_ms)
    assert tres.report == jreport
    s = tres.stats
    assert s.rumors == cfg.rumors
    if tres.converged:
        assert s.rumors_done == cfg.rumors
    if name == "stream_slow":
        # Injections 200 ms apart: under the default -telemetry on (the
        # JAX package's device loop) the run does not end between them.
        assert tres.coverage_ms > cfg.last_inject_tick and tres.converged
    if name == "stream_slow_telemetry_off":
        # The JAX package's windowed loop ends on the first empty ring,
        # between two injections; the port's -telemetry off follows it.
        assert s.exhausted and tres.coverage_ms < cfg.last_inject_tick
    if name.startswith("churn"):
        assert s.heal_repaired > 0 and s.scen_crashed >= 0.2 * cfg.n
        assert s.part_dropped > 0


@pytest.mark.parametrize("traffic", (
    ["-rumors", "40"],
    ["-rumors", "16", "-traffic", "stream", "-stream-rate", "40",
     "-arrivals", "poisson"]), ids=("oneshot_r40", "stream_poisson"))
def test_mid_stream_state_continues(traffic):
    """A JaxStepper state taken mid-run (rumor words in the ring, rumors
    still to inject under stream traffic) carries into the port; both run
    on to identical Stats each window and identical leaves."""
    argv = KOUT + traffic
    jc = jcfg.parse_args(list(argv))
    tc, _ = tcfg.parse_cli(list(argv))
    js = JaxStepper(jc)
    js.init()
    assert js.overlay_window()[2]
    js.seed()
    for _ in range(4):
        js.gossip_window()
    tree = js.state_pytree()
    assert np.asarray(tree["mail_words"]).dtype == np.uint32
    assert np.shape(tree["rumor_words"]) == (tc.n, tc.rumor_word_count)
    assert np.asarray(tree["rumor_words"]).any()
    ts = TorchStepper(tc, device="cpu")
    ts.init()
    ts.load_state_pytree(tree)
    for _ in range(5):
        assert js.gossip_window().to_dict() == ts.gossip_window().to_dict()
    jtree, ttree = js.state_pytree(), ts.state_pytree()
    assert set(jtree) == set(ttree)
    for key in jtree:
        assert np.asarray(jtree[key]).dtype == np.asarray(ttree[key]).dtype, \
            key
        assert np.array_equal(jtree[key], ttree[key]), key
