"""Kernel widths past the port's old fixed limits (ROADMAP C1), end to
end on the CPU: the port's CLI transcript must be byte-identical to a
live ``python -m gossip_simulator_tpu`` run for an overlay of 21 friend
columns (``-fanout 20``: fused_negotiate's register row holds 16), a mail
ring of 40 window slots (``-delaylow 1 -delayhigh 40``: fused_emit and
fused_ring_append took 32) and 33 lanes a sender (``-fanout 32 -protocol
sir``: fused_emit's kept-lane mask was one 32-bit word), and a mail ring
of 1201 window slots (``-delaylow 10 -delayhigh 12000``: past the 1024
that the single-pass appends keep in shared memory; the plain versions'
sorted per-slot ranks here, the kernels' global form on the card).  The
kernels themselves are held to their plain versions at these widths on
the card (tests/test_torch_card.py, chip_smoke.py)."""

import contextlib
import io

import pytest

from gossip_simulator_tpu_torch import config as tcfg
from gossip_simulator_tpu_torch.cli import main as torch_main
from gossip_simulator_tpu_torch.models import event as tevent
from gossip_simulator_tpu_torch.ops import deliver
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
    # 9.3 % covered when -max-rounds stops it at 10 simulated s.
    "kout_delay10_12000": ["-graph", "kout", "-n", "1000", "-fanout", "8",
                           "-seed", "3", "-telemetry", "off", "-delaylow",
                           "10", "-delayhigh", "12000", "-max-rounds",
                           "10000"],
}
# What each twin crosses: (config property, value, old kernel limit).
WIDTHS = {"default_fanout20": ("max_degree", 21, 16),
          "kout_delay1_40": ("ring_windows", 40, 32),
          "kout_fanout32_sir": ("kw", 33, 32),
          "kout_delay10_12000": ("ring_windows", 1201, 1024)}


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
    assert jrc == (2 if "-max-rounds" in TWINS[name] else 0), jerr
    rc, out = _port_cli(TWINS[name])
    assert rc == jrc
    assert out.count("\n") > 8
    assert out == jout


def test_ring_past_the_old_slot_limit_parses():
    """Rings deeper than the 1024 slots the appends keep in shared memory
    parse on every engine that keeps one (C1 repaired): the event engine,
    PushSum and the tick-faithful overlay; the ring engine keeps none."""
    deep = ["-delaylow", "1", "-delayhigh", "2000"]
    for argv in (["-graph", "kout"], ["-graph", "kout", "-model", "pushsum",
                                      "-droprate", "0", "-crashrate", "0"],
                 ["-overlay-mode", "ticks"], ["-graph", "kout", "-engine",
                                              "ring"]):
        cfg, _ = tcfg.parse_cli(["-n", "100", *argv, *deep])
        assert cfg.ring_windows == 2000 > deliver.RING_SLOTS_MAX
