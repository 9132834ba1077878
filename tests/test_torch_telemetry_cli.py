"""The default run's phase-2 transcript (``-telemetry on``): the JAX
package runs its device loop and replays the recorded windows
(``driver.py`` fast path, ``telemetry.replay_gossip``), and the port's
stdout must be byte-identical to it, both packages at their defaults.

Two cases differ from the windowed loop (``-telemetry off``), which the
other twin files pin: a seed whose broadcast dies at once prints no
window line and ends at 0 ms, and under ``-rumors`` each window prints
total_received / n, not the worst rumor's coverage.  The default kout,
overlay and PushSum runs and a SIR wave that dies out mid-run show that
nothing else moved."""

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


TWINS = {
    # The seed's only friend edge is dropped or leads nowhere new: nothing
    # is in flight after the seed.
    "dies_at_once": ["-graph", "kout", "-n", "2000", "-fanout", "1",
                     "-seed", "2", "-coverage-target", "0.5"],
    "ring_rumors16": ["-engine", "ring", "-graph", "kout", "-n", "2000",
                      "-fanout", "6", "-seed", "4", "-rumors", "16",
                      "-crashrate", "0", "-coverage-target", "0.95"],
    # SIR whose wave dies out mid-run: exit 2, "exhausted".
    "sir_dies_out": ["-graph", "kout", "-n", "2000", "-fanout", "2",
                     "-seed", "3", "-protocol", "sir", "-removal-rate",
                     "0.6", "-droprate", "0.3"],
    "kout": ["-graph", "kout", "-n", "2000", "-fanout", "6", "-seed", "1"],
    "overlay": ["-n", "2000", "-seed", "1", "-coverage-target", "0.9"],
    "pushsum": ["-model", "pushsum", "-graph", "kout", "-n", "2000",
                "-fanout", "6", "-droprate", "0", "-crashrate", "0",
                "-seed", "1"],
}


@pytest.mark.parametrize("name", sorted(TWINS))
def test_default_telemetry_transcript_byte_identical(name):
    jrc, jout, jerr = jax_cli(TWINS[name])
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = torch_main([*TWINS[name], "-device", "cpu"])
    assert rc == jrc, jerr
    assert out.getvalue() == jout
    if name == "dies_at_once":
        assert "% covered" not in jout and "after 0ms" in jout
