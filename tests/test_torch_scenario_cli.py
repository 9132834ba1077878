"""Fault scenarios and overlay healing end to end on the CPU: the port's
transcript must be byte-identical to a live run of the JAX package (its
``run_simulation`` in this process, what ``python -m gossip_simulator_tpu``
prints), with equal ``Stats`` (``scen_crashed``, ``scen_recovered``,
``part_dropped`` and ``heal_repaired`` included), for the event engine
under bench.py's churn timeline with healing on and off under both
``-telemetry`` settings, a partition-only timeline under both
``-phase2-kernel`` gates, the ring engine with healing, and PushSum under
churn and a partition (whose Sigma x and Sigma w, parked mass of crashed
nodes included, end exactly where they began).  Then a JAX state taken
mid-scenario carries into the port on each of the three engines, and
both continue to identical leaves."""

import io

import numpy as np
import pytest

from gossip_simulator_tpu import config as jcfg
from gossip_simulator_tpu.backends.jax_backend import JaxStepper
from gossip_simulator_tpu.driver import run_simulation as jax_run
from gossip_simulator_tpu.utils.metrics import ProgressPrinter as JaxPrinter
from gossip_simulator_tpu_torch import config as tcfg
from gossip_simulator_tpu_torch import run_simulation as torch_run
from gossip_simulator_tpu_torch.backends import TorchStepper
from gossip_simulator_tpu_torch.models import pushsum as tpushsum
from gossip_simulator_tpu_torch.utils.metrics import \
    ProgressPrinter as TorchPrinter
from gossip_simulator_tpu_torch.utils import rng as trng
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
PARTITION = ('{"groups": 3, "events": [{"type": "partition", "start": 10, '
             '"end": 80, "group": 1}]}')
KOUT = ["-graph", "kout", "-n", "3000", "-fanout", "6", "-seed", "0"]
HEAL = ["-crashrate", "0", "-scenario", CHURN, "-coverage-target", "0.99",
        "-max-rounds", "2000"]
PUSHSUM = ["-model", "pushsum", "-graph", "kout", "-n", "2000", "-fanout",
           "6", "-seed", "0", "-droprate", "0", "-crashrate", "0",
           "-scenario", CHURN]
TWINS = {
    "event_heal": KOUT + HEAL + ["-overlay-heal", "on"],
    "event_noheal": KOUT + HEAL,
    "event_heal_telemetry_off": KOUT + HEAL + ["-overlay-heal", "on",
                                               "-telemetry", "off"],
    "event_noheal_telemetry_off": KOUT + HEAL + ["-telemetry", "off"],
    "partition_pallas": KOUT + ["-crashrate", "0", "-scenario", PARTITION,
                                "-phase2-kernel", "pallas"],
    "partition_xla": KOUT + ["-crashrate", "0", "-scenario", PARTITION,
                             "-phase2-kernel", "xla"],
    "ring_heal": ["-engine", "ring", "-graph", "kout", "-n", "2000",
                  "-fanout", "6", "-seed", "0", "-scenario", CHURN,
                  "-overlay-heal", "on", "-coverage-target", "0.95"],
    "pushsum_heal": PUSHSUM + ["-overlay-heal", "on"],
}


def _argv(name):
    argv = TWINS[name]
    # The JAX package's pallas gates do not run on this host (ROADMAP C):
    # its xla chain is the same function.
    jargv = [("xla" if a == "pallas" else a) for a in argv]
    return jargv, argv


def _jax(argv):
    cfg = jcfg.parse_args(list(argv))
    out = io.StringIO()
    res = jax_run(cfg, printer=JaxPrinter(enabled=cfg.progress, out=out))
    return out.getvalue(), res


def _port(argv):
    cfg, _ = tcfg.parse_cli(list(argv))
    out = io.StringIO()
    st = TorchStepper(cfg, device="cpu")
    res = torch_run(cfg, printer=TorchPrinter(cfg.progress, out=out),
                    stepper=st, device="cpu")
    return out.getvalue(), res, st, cfg


def _notes_aside(text):
    return [x for x in text.splitlines() if not x.startswith("(phase2")]


@pytest.mark.parametrize("name", sorted(TWINS))
def test_scenario_cli_twin(name):
    jargv, argv = _argv(name)
    jout, jres = _jax(jargv)
    tout, tres, st, cfg = _port(argv)
    if jargv == argv:
        assert tout == jout
    else:
        assert _notes_aside(tout) == _notes_aside(jout)
    assert tout.count("\n") > 10
    assert "(scenario: " in tout
    assert jres.stats.to_dict() == tres.stats.to_dict()
    assert (jres.converged, jres.coverage_ms) == (tres.converged,
                                                 tres.coverage_ms)
    s = tres.stats
    if "-overlay-heal" in argv and cfg.model != "pushsum":
        assert s.heal_repaired > 0 and s.scen_crashed >= 0.2 * cfg.n
    if name.startswith("event_noheal"):
        # The reference's acceptance pair: without healing the wave dies
        # short of the target.
        assert not tres.converged and s.heal_repaired == 0
    if name.startswith("partition"):
        assert s.part_dropped > 0
    if cfg.model == "pushsum":
        assert s.scen_crashed > 0 and s.part_dropped > 0
        fresh = TorchStepper(cfg, device="cpu")
        fresh.init()
        assert tpushsum.conserved_totals(st.state, cfg) == \
            tpushsum.conserved_totals(fresh.state, cfg)


HANDOVER = {
    "event": KOUT + HEAL + ["-overlay-heal", "on"],
    "ring": TWINS["ring_heal"],
    "pushsum": PUSHSUM + ["-overlay-heal", "on"],
}


@pytest.mark.parametrize("engine", sorted(HANDOVER))
def test_mid_scenario_state_continues(engine):
    """A JaxStepper state taken mid-scenario (crashes, reboot markers,
    healed friends and partitions in flight) carries into the port; both
    run on to identical Stats each window and identical leaves."""
    argv = HANDOVER[engine]
    jc = jcfg.parse_args(list(argv))
    tc, _ = tcfg.parse_cli(list(argv))
    js = JaxStepper(jc)
    js.init()
    assert js.overlay_window()[2]
    js.seed()
    for _ in range(5):
        js.gossip_window()
    tree = js.state_pytree()
    assert np.shape(tree["down_since"]) == (tc.n,)
    assert (np.asarray(tree["down_since"]) >= 0).any()
    ts = TorchStepper(tc, device="cpu")
    ts.init()
    ts.load_state_pytree(tree)
    for _ in range(4):
        assert js.gossip_window().to_dict() == ts.gossip_window().to_dict()
    jtree, ttree = js.state_pytree(), ts.state_pytree()
    assert set(jtree) == set(ttree)
    for key in jtree:
        assert np.asarray(jtree[key]).dtype == np.asarray(ttree[key]).dtype, \
            key
        assert np.array_equal(jtree[key], ttree[key]), key
