"""PushSum end to end: the port's CLI transcript must be byte-identical to
a live ``python -m gossip_simulator_tpu -model pushsum`` run (stdout
only) at n = 2000, for two seeds and ``-pushsum-dim`` 1, 2 and 8, and the
port's ``report()`` must equal the reference's ``pushsum.report``, which
the reference writes only to its JSONL result record (``-log-jsonl``).

Both packages run their windowed loops (``-telemetry off``); the default
transcript is twinned in test_torch_telemetry_cli.py.  The reference's
kernel gates cannot run on hosts where its interpret-mode
probes fail (ROADMAP §C) and it pins them bit-identical to its xla gates,
so the port's runs under the default gates (fused_drain_sum and the wide
fused_ring_append), ``-phase2-kernel xla`` (the chunked drain through
fused_deposit_rows) and all-xla are held to the reference's transcript,
which runs its xla chains; the gates' note lines are set aside."""

import contextlib
import io
import json

import pytest

from gossip_simulator_tpu_torch import TorchStepper, run_simulation
from gossip_simulator_tpu_torch.cli import main as torch_main
from gossip_simulator_tpu_torch.config import parse_cli
from gossip_simulator_tpu_torch.utils import rng as trng
from gossip_simulator_tpu_torch.utils.metrics import ProgressPrinter
from test_torch_rng import match_jax_threefry
from torch_reference import jax_cli


@pytest.fixture(autouse=True, scope="module")
def threefry_layout():
    """Draw in the counter layout this process's jax uses."""
    old = trng.partitionable()
    match_jax_threefry()
    yield
    trng.set_partitionable(old)


BASE = ["-model", "pushsum", "-graph", "kout", "-n", "2000", "-fanout", "6",
        "-droprate", "0", "-crashrate", "0"]
TWINS = {
    "seed1": BASE + ["-seed", "1"],
    "seed2_dim1": BASE + ["-seed", "2", "-pushsum-dim", "1"],
    "seed1_dim8": BASE + ["-seed", "1", "-pushsum-dim", "8"],
    # A tighter eps and target: relerr_ppb and eps_ticks move.
    "seed2_eps": BASE + ["-seed", "2", "-pushsum-eps", "1e-4",
                         "-coverage-target", "0.9"],
}
GATES = {"default": [], "p2_xla": ["-phase2-kernel", "xla"],
         "all_xla": ["-phase2-kernel", "xla", "-deliver-kernel", "xla"]}
REPORT = ("converged_eps", "eps_ticks", "relerr_ppb")


def _jax_cli(argv, jsonl):
    rc, out, err = jax_cli([*argv, "-telemetry", "off", "-log-jsonl",
                            str(jsonl)])
    report = None
    if rc == 0:
        for line in open(jsonl):
            rec = json.loads(line)
            if "converged_eps" in rec:
                report = {k: rec[k] for k in REPORT}
    return rc, out, err, report


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pushsum_jsonl")
    return {name: _jax_cli(argv, tmp / f"{name}.jsonl")
            for name, argv in TWINS.items()}


def _notes_out(text: str) -> str:
    return "".join(x for x in text.splitlines(True)
                   if not x.startswith("(phase"))


@pytest.mark.parametrize("name", sorted(TWINS))
def test_cli_twin_byte_identical(name, jax_runs):
    jrc, jout, jerr, _ = jax_runs[name]
    assert jrc == 0, jerr
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = torch_main([*TWINS[name], "-telemetry", "off", "-device",
                         "cpu"])
    assert rc == jrc
    assert out.getvalue().count("\n") > 8
    assert out.getvalue() == jout


@pytest.mark.parametrize("gate", sorted(GATES))
@pytest.mark.parametrize("name", ("seed1_dim8", "seed2_eps"))
def test_every_gate_gives_the_reference_run_and_report(name, gate, jax_runs):
    _, jout, jerr, jreport = jax_runs[name]
    assert jreport is not None, jerr
    cfg, _ = parse_cli(TWINS[name] + GATES[gate] + ["-telemetry", "off"])
    buf = io.StringIO()
    res = run_simulation(cfg, printer=ProgressPrinter(out=buf),
                         stepper=TorchStepper(cfg, device="cpu"))
    assert _notes_out(buf.getvalue()) == jout
    assert res.report == jreport
    assert res.stats.mailbox_dropped == 0


def test_si_runs_carry_no_report():
    cfg, _ = parse_cli(["-graph", "kout", "-n", "500", "-fanout", "6"])
    res = run_simulation(cfg, printer=ProgressPrinter(out=io.StringIO()),
                         stepper=TorchStepper(cfg, device="cpu"))
    assert res.report is None
