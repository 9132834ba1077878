"""The default run end to end: the port's CLI transcript must be
byte-identical to a live ``python -m gossip_simulator_tpu`` run (stdout
only) -- the tick-faithful overlay, then the event engine on its friends
table -- and the final Stats equal.

The JAX package's own kernel gates cannot run on hosts where its
interpret-mode probes fail (ROADMAP §C), so the port's ``-phase1-kernel
pallas -deliver-kernel pallas`` run is held to the reference's xla
transcript, the gate note aside; the reference pins its two gates
bit-identical."""

import contextlib
import io

import pytest

from gossip_simulator_tpu import config as jcfg
from gossip_simulator_tpu.driver import run_simulation as jax_run
from gossip_simulator_tpu.utils.metrics import ProgressPrinter as JaxPrinter
from gossip_simulator_tpu_torch import config as tcfg
from gossip_simulator_tpu_torch import run_simulation as torch_run
from gossip_simulator_tpu_torch.cli import main as torch_main
from gossip_simulator_tpu_torch.utils import rng as trng
from gossip_simulator_tpu_torch.utils.metrics import \
    ProgressPrinter as TorchPrinter
from test_torch_rng import match_jax_threefry
from torch_reference import jax_cli


@pytest.fixture(autouse=True, scope="module")
def threefry_layout():
    """Draw in the counter layout this process's jax uses."""
    old = trng.partitionable()
    match_jax_threefry()
    yield
    trng.set_partitionable(old)


# test_golden.py::test_overlay_ticks_byte_exact's flags; fanout 6; and the
# reference's defaults (n = 50,000, fanout 5) with a reachable target: at
# fanout 5 and drop 0.1 the default 0.99 is never reached.
N1000 = ["-n", "1000", "-fanout", "5", "-seed", "9", "-coverage-target", "0.9"]
XLA_GATES = ["-phase1-kernel", "xla", "-deliver-kernel", "xla"]
TWINS = {
    "n1000_seed9": N1000,
    "n2000_fanout6": ["-n", "2000", "-fanout", "6"],
    "defaults": ["-coverage-target", "0.9"],
    "n1000_quiet": N1000 + ["-quiet"],
    "n1000_xla_gates": N1000 + XLA_GATES,
    # B = 2-tick windows, dw = 11 ring slots.
    "n2000_delaylow2": ["-n", "2000", "-delaylow", "2",
                        "-coverage-target", "0.9"],
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
    assert "=== Constructing Overlay ===" in out
    assert out.count("\n") > 10
    assert out == jout
    if "-quiet" not in TWINS[name]:
        assert "makeup" in out  # phase-1 window lines are compared


@pytest.mark.parametrize("gates", (
    ["-phase1-kernel", "pallas"], ["-deliver-kernel", "pallas"],
    ["-phase1-kernel", "pallas", "-deliver-kernel", "pallas"],
    ["-phase1-kernel", "auto", "-deliver-kernel", "xla"]))
def test_cli_twin_kernel_gates(gates, jax_transcripts):
    """Every gate setting of the port gives the reference's xla
    transcript; only the explicit-request note names what ran."""
    _, jout, _ = jax_transcripts["n1000_xla_gates"]
    rc, out = _port_cli(N1000 + gates)
    assert rc == 0
    note = "(phase1-kernel: xla (requested xla))"
    assert note in jout
    gate = dict(zip(gates[::2], gates[1::2])).get("-phase1-kernel", "auto")
    want = jout.replace(note + "\n", "") if gate == "auto" else \
        jout.replace(note, f"(phase1-kernel: {gate} (requested {gate}))")
    assert out == want


@pytest.mark.parametrize("extra", (
    [], ["-protocol", "sir", "-removal-rate", "0.3", "-droprate", "0.3"],
    ["-crashrate", "0"]))
def test_final_stats_equal(extra):
    """In process, both packages: the final Stats, convergence and both
    phases' clocks."""
    argv = ["-n", "1500", "-fanout", "6", "-seed", "5", "-quiet",
            "-coverage-target", "0.95"] + extra
    jres = jax_run(jcfg.parse_args(argv), printer=JaxPrinter(
        enabled=False, out=io.StringIO()))
    tc, _ = tcfg.parse_cli(argv)
    tres = torch_run(tc, printer=TorchPrinter(False, out=io.StringIO()),
                     device="cpu")
    assert jres.stats.to_dict() == tres.stats.to_dict()
    assert (jres.converged, jres.coverage_ms, jres.stabilize_ms,
            jres.overlay_windows) == (tres.converged, tres.coverage_ms,
                                      tres.stabilize_ms,
                                      tres.overlay_windows)
    assert tres.stabilize_ms > 0
