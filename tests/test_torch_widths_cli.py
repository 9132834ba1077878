"""Kernel widths past the port's old fixed limits (ROADMAP C1), end to
end on the CPU: the port's CLI transcript must be byte-identical to a
live ``python -m gossip_simulator_tpu`` run for an overlay of 21 friend
columns (``-fanout 20``: fused_negotiate's register row holds 16), a mail
ring of 40 window slots (``-delaylow 1 -delayhigh 40``: fused_emit and
fused_ring_append took 32) and 33 lanes a sender (``-fanout 32 -protocol
sir``: fused_emit's kept-lane mask was one 32-bit word).  The kernels
themselves are held to their plain versions at these widths on the card
(tests/test_torch_card.py, chip_smoke.py); a ring past the kernels' slot
limit is refused when the Config is parsed."""

import contextlib
import io

import pytest

from gossip_simulator_tpu_torch import config as tcfg
from gossip_simulator_tpu_torch.cli import main as torch_main
from gossip_simulator_tpu_torch.models import event as tevent
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


KOUT = ["-graph", "kout", "-n", "2000", "-seed", "1", "-telemetry", "off"]
TWINS = {
    "default_fanout20": ["-n", "3000", "-fanout", "20", "-seed", "1",
                         "-coverage-target", "0.9", "-telemetry", "off"],
    "kout_delay1_40": KOUT + ["-fanout", "6", "-delaylow", "1",
                              "-delayhigh", "40"],
    "kout_fanout32_sir": KOUT + ["-fanout", "32", "-protocol", "sir"],
}
# What each twin crosses: (config property, value, old kernel limit).
WIDTHS = {"default_fanout20": ("max_degree", 21, 16),
          "kout_delay1_40": ("ring_windows", 40, 32),
          "kout_fanout32_sir": ("kw", 33, 32)}


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
    cfg, _ = tcfg.parse_cli(TWINS[name])
    prop, width, old = WIDTHS[name]
    got = {"max_degree": cfg.max_degree,
           "ring_windows": tevent.ring_windows(cfg),
           # kout's table is fanout wide, plus SIR's trigger lane.
           "kw": cfg.fanout + (cfg.protocol == "sir")}[prop]
    assert got == width > old
    jrc, jout, jerr = jax_transcripts[name]
    assert jrc == 0, jerr
    rc, out = _port_cli(TWINS[name])
    assert rc == jrc
    assert out.count("\n") > 8
    assert out == jout


def test_ring_past_the_slot_limit_is_refused_at_parse():
    argv = ["-graph", "kout", "-n", "100", "-delaylow", "1", "-delayhigh",
            str(tcfg.RING_SLOTS_MAX + 2)]
    with pytest.raises(tcfg.NotYetPorted,
                       match=r"window slots.*not yet ported \(ROADMAP C1\)"):
        tcfg.parse_cli(argv)
    # The ring engine keeps no such ring.
    tcfg.parse_cli(argv + ["-engine", "ring"])
