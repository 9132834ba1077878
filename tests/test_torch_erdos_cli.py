"""Static-graph generation end to end: the port's CLI transcript must be
byte-identical to a live ``python -m gossip_simulator_tpu`` run (stdout
only; the JAX package prints its -pallas fallback warning on stderr) for
``-graph erdos`` under the event engine (SI, SIR, and SIR at lam = 12,
whose 38 lanes a sender cross the old 32-lane limit of fused_emit and
whose degrees come from the rejection branch), the ring engine
(``-time-mode rounds``, ``-engine ring``), ``-model pushsum -graph
erdos``, and ``-graph kout -pallas`` (the kout_pallas stream is
graphs.kout's own).  Both packages get the same argv, ``-telemetry off``
included: the windowed loop is the port's.

``-graph erdos -pallas`` draws its own graph (the erdos_pallas stream;
the JAX package falls back to graphs.erdos off a TPU), so that twin
injects the port's table into both steppers and holds every window's
Stats equal."""

import contextlib
import io
import unittest.mock

import jax.numpy as jnp
import pytest

from gossip_simulator_tpu import config as jcfg
from gossip_simulator_tpu.backends.jax_backend import JaxStepper
from gossip_simulator_tpu.models import graphs as jgraphs
from gossip_simulator_tpu_torch import config as tcfg
from gossip_simulator_tpu_torch.backends import TorchStepper
from gossip_simulator_tpu_torch.cli import main as torch_main
from gossip_simulator_tpu_torch.ops import graph as tgraph
from gossip_simulator_tpu_torch.utils import rng as trng
from test_torch_rng import match_jax_threefry
from torch_reference import jax_cli


@pytest.fixture(autouse=True, scope="module")
def threefry_layout():
    """Draw in the counter layout this process's jax uses."""
    old = trng.partitionable()
    match_jax_threefry()
    yield
    trng.set_partitionable(old)


ERDOS = ["-graph", "erdos", "-n", "2000", "-telemetry", "off"]
TWINS = {
    "erdos_si": ERDOS + ["-fanout", "8", "-seed", "1"],
    "erdos_sir": ERDOS + ["-fanout", "6", "-seed", "2", "-protocol", "sir",
                          "-removal-rate", "0.2"],
    "erdos_lam12_sir": ["-graph", "erdos", "-n", "3000", "-er-p", "0.004",
                        "-seed", "1", "-protocol", "sir", "-telemetry",
                        "off"],
    "erdos_rounds": ERDOS + ["-fanout", "6", "-seed", "3", "-time-mode",
                             "rounds"],
    "erdos_ring": ERDOS + ["-fanout", "6", "-seed", "1", "-engine", "ring"],
    "pushsum_erdos": ERDOS + ["-model", "pushsum", "-fanout", "8",
                              "-droprate", "0", "-crashrate", "0", "-seed",
                              "1", "-coverage-target", "0.95"],
    "kout_pallas": ["-graph", "kout", "-n", "2000", "-fanout", "6", "-seed",
                    "1", "-pallas", "-telemetry", "off"],
}


@pytest.fixture(scope="module")
def jax_transcripts():
    return {name: jax_cli(argv) for name, argv in TWINS.items()}


def _port_cli(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = torch_main([*argv, "-device", "cpu"])
    return rc, out.getvalue()


@pytest.mark.parametrize("name", sorted(TWINS))
def test_cli_twin_byte_identical(name, jax_transcripts):
    jrc, jout, jerr = jax_transcripts[name]
    assert jrc == 0, jerr
    rc, out = _port_cli(TWINS[name])
    assert rc == jrc
    assert out.count("\n") > 8
    assert out == jout


def test_kout_pallas_warns_like_the_reference(jax_transcripts):
    """Past fanout 128 -pallas falls back to the fold_in generator with
    the JAX package's warning; below it the port takes the kernel (the
    JAX package, off a TPU, always warns)."""
    assert "-pallas requested" in jax_transcripts["kout_pallas"][2]
    cfg, _ = tcfg.parse_cli(["-graph", "kout", "-n", "300", "-fanout",
                             "129", "-pallas"])
    with pytest.warns(UserWarning, match="Pallas kout generator is "
                                         "unavailable"):
        TorchStepper(cfg, device="cpu").init()


@pytest.mark.parametrize("argv", (
    ["-fanout", "8", "-seed", "5"],
    ["-er-p", "0.03", "-seed", "6", "-protocol", "sir"]),
    ids=("lam8_si", "lam60_sir"))
def test_erdos_pallas_injected_table_twin(argv):
    """The port's erdos_pallas table (cap 29, or 111 at lam = 60) goes into
    both steppers through their init_state; every window's Stats must be
    equal until both have converged."""
    argv = ["-graph", "erdos", "-n", "2000", "-pallas", "-telemetry", "off",
            "-quiet"] + argv
    tc, _ = tcfg.parse_cli(argv)
    jc = jcfg.parse_args(argv)
    lam = tc.er_p_resolved * tc.n
    friends, deg = tgraph.erdos_pallas(
        tc.n, lam, 0, tc.n, trng.tick_key(trng.base_key(tc.seed), 0,
                                          trng.OP_GRAPH))
    table = (jnp.asarray(friends.numpy()), jnp.asarray(deg.numpy()))
    with unittest.mock.patch.object(jgraphs, "generate",
                                    lambda *a, **k: table):
        js = JaxStepper(jc)
        js.init()
    ts = TorchStepper(tc, device="cpu")
    ts.init()
    for s in (js, ts):
        assert s.overlay_window()[2]
        s.seed()
    assert (ts.state.friends == friends).all()
    target = int(tc.coverage_target * tc.n)
    for _ in range(40):
        jstats, tstats = js.gossip_window(), ts.gossip_window()
        assert jstats.to_dict() == tstats.to_dict()
        if tstats.total_received >= target:
            break
    assert tstats.total_received >= target
