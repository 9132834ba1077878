"""The ring engine end to end: the port's CLI transcript must be
byte-identical to a live ``python -m gossip_simulator_tpu`` run (stdout
only) for ``-engine ring`` (SI, ``-compact off``, SIR), ``-time-mode
rounds`` (on a static graph and on the rounds overlay), ``-protocol
pushpull`` (compacted and dense) and ``-engine ring -rumors 16``.

The JAX package's kernel gates cannot run on hosts where its
interpret-mode probes fail (ROADMAP §C), and it pins them bit-identical
to its xla gates, so the port's multi-rumor runs under the default gates
(fused_deposit_both), ``-phase2-kernel xla`` (fused_deposit_add and
fused_deposit_rows) and all-xla are held to the reference's transcripts
of the same flags, which run its xla chains.

Both packages run their windowed loops (``-telemetry off``), which print
the worst rumor's coverage under ``-rumors``; the default (``-telemetry
on``) transcripts, which print total_received / n there, are twinned in
test_torch_telemetry_cli.py."""

import contextlib
import io

import pytest

from gossip_simulator_tpu_torch.cli import main as torch_main
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


# test_golden.py::test_ring_engine_byte_exact's flags, at n = 2000.
KOUT = ["-graph", "kout", "-n", "2000", "-fanout", "6", "-seed", "4"]
RING = KOUT + ["-engine", "ring"]
PUSHPULL = ["-protocol", "pushpull", "-graph", "kout", "-n", "3000",
            "-fanout", "11", "-seed", "2"]
RUMORS = RING + ["-rumors", "16", "-crashrate", "0", "-coverage-target",
                 "0.95"]
TWINS = {
    "ring": RING,
    "ring_compact_off": RING + ["-compact", "off"],
    "ring_sir": RING + ["-protocol", "sir", "-removal-rate", "0.2"],
    "rounds_kout": KOUT + ["-time-mode", "rounds"],
    "rounds_overlay": ["-time-mode", "rounds", "-n", "3000", "-seed", "9",
                       "-coverage-target", "0.9"],
    "pushpull": PUSHPULL,
    "pushpull_compact_off": PUSHPULL + ["-compact", "off"],
    "rumors16": RUMORS,
    "rumors16_p2_xla": RUMORS + ["-phase2-kernel", "xla"],
}


def _jax_cli(argv):
    """The reference's windowed loop: -telemetry off."""
    return jax_cli([*argv, "-telemetry", "off"])


@pytest.fixture(scope="module")
def jax_transcripts():
    return {name: _jax_cli(argv) for name, argv in TWINS.items()}


def _port_cli(argv):
    """The port's windowed loop: -telemetry off."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = torch_main([*argv, "-telemetry", "off", "-device", "cpu"])
    return rc, out.getvalue()


@pytest.mark.parametrize("name", sorted(TWINS))
def test_cli_twin_byte_identical(name, jax_transcripts):
    jrc, jout, jerr = jax_transcripts[name]
    assert jrc == 0, jerr
    rc, out = _port_cli(TWINS[name])
    assert rc == jrc
    assert out.count("\n") > 8
    assert out == jout


def test_rumors_all_xla_gates(jax_transcripts):
    """`-deliver-kernel xla -phase2-kernel xla` (the unfused chains) gives
    the reference's transcript of the same flags: the deliver gate prints
    no note in either package."""
    _, jout, _ = jax_transcripts["rumors16_p2_xla"]
    rc, out = _port_cli(RUMORS + ["-deliver-kernel", "xla",
                                  "-phase2-kernel", "xla"])
    assert rc == 0
    assert out == jout


def test_rounds_quiet_matches_reference(jax_transcripts):
    argv = TWINS["rounds_kout"] + ["-quiet"]
    jrc, jq, _ = _jax_cli(argv)
    rc, out = _port_cli(argv)
    assert rc == jrc == 0
    assert out == jq
    assert "% covered" in jax_transcripts["rounds_kout"][1]
    assert "% covered" not in out
