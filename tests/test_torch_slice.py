"""The slice end to end: the port's CLI transcript must be byte-identical
to a live ``python -m gossip_simulator_tpu`` run (stdout only; the JAX CLI
prints its gate fallback on stderr), and the final Stats equal, for static
graphs through the event engine, SI and SIR, both phase-2 kernel gates.

The port runs in process through its CLI entry point on the CPU; so does
the JAX package's (``torch_reference.jax_cli``), each run once."""

import contextlib
import io

import pytest

from gossip_simulator_tpu import config as jcfg
from gossip_simulator_tpu.driver import run_simulation as jax_run
from gossip_simulator_tpu.utils.metrics import ProgressPrinter as JaxPrinter
from gossip_simulator_tpu_torch import config as tcfg
from gossip_simulator_tpu_torch import run_simulation as torch_run
from gossip_simulator_tpu_torch.cli import main as torch_main
from gossip_simulator_tpu_torch.utils.metrics import \
    ProgressPrinter as TorchPrinter
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
KOUT = ["-graph", "kout", "-n", "2000", "-fanout", "6"]
# A fault timeline (bench.py's churn scenario) and a partition-only one.
CHURN = ('{"groups": 2, "downtime": 60, "events": ['
         '{"type": "churn", "start": 0, "end": 150, "rate": 2.0},'
         '{"type": "crash", "at": 30, "frac": 0.3, "group": 1},'
         '{"type": "partition", "start": 20, "end": 60}]}')
PARTITION = ('{"groups": 2, "events": [{"type": "partition", "start": 10, '
             '"end": 40}]}')
TWINS = {
    "kout_seed1": KOUT + ["-seed", "1"],
    "kout_seed3": KOUT + ["-seed", "3"],
    "kout_crash0": KOUT + ["-seed", "1", "-crashrate", "0"],
    "sir": KOUT + ["-seed", "2", "-protocol", "sir", "-removal-rate", "0.3",
                   "-droprate", "0.3"],
    "ring": ["-graph", "ring", "-n", "2000", "-fanout", "6", "-seed", "1"],
    "xla": KOUT + ["-seed", "1", "-phase2-kernel", "xla"],
    "n20000_quiet": ["-graph", "kout", "-n", "20000", "-fanout", "6",
                     "-seed", "1", "-quiet"],
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
    assert out.count("\n") > 10
    assert out == jout


def test_cli_twin_phase2_pallas(jax_transcripts):
    """`-phase2-kernel pallas` (the fused_emit path, its plain version on
    the CPU) must give the xla transcript with the gate note naming pallas.
    The JAX package pins its own pallas and xla paths bit-identical; its
    pallas gate cannot run on hosts where its interpret-mode capability
    probe fails, so the live twin here is its xla run."""
    _, jout, _ = jax_transcripts["xla"]
    rc, out = _port_cli(KOUT + ["-seed", "1", "-phase2-kernel", "pallas"])
    assert rc == 0
    note = "(phase2-kernel: xla (requested xla))"
    assert note in jout
    assert out == jout.replace(
        note, "(phase2-kernel: pallas (requested pallas))")


def test_cli_quiet_matches_reference(jax_transcripts):
    _, jout, _ = jax_transcripts["kout_seed1"]
    _, jq, _ = jax_cli(TWINS["kout_seed1"] + ["-quiet"])
    rc, out = _port_cli(TWINS["kout_seed1"] + ["-quiet"])
    assert rc == 0
    assert out == jq
    assert "% covered" in jout and "% covered" not in out


@pytest.mark.parametrize("extra", (
    [], ["-protocol", "sir", "-removal-rate", "0.3", "-droprate", "0.3"],
    ["-crashrate", "0"]))
def test_final_stats_equal(extra):
    argv = KOUT + ["-seed", "5", "-quiet"] + extra
    jres = jax_run(jcfg.parse_args(argv), printer=JaxPrinter(
        enabled=False, out=io.StringIO()))
    tc, _ = tcfg.parse_cli(argv)
    tres = torch_run(tc, printer=TorchPrinter(False, out=io.StringIO()),
                     device="cpu")
    assert jres.stats.to_dict() == tres.stats.to_dict()
    assert (jres.converged, jres.coverage_ms, jres.stabilize_ms) == \
        (tres.converged, tres.coverage_ms, tres.stabilize_ms)


def test_sir_dieout_exit_status():
    """A wave that dies before the target exits 2 and names the reason,
    like the JAX package."""
    argv = ["-graph", "kout", "-n", "2000", "-fanout", "2", "-seed", "1",
            "-protocol", "sir", "-removal-rate", "0.5", "-droprate", "0.3"]
    jrc, jout, _ = jax_cli(argv)
    rc, out = _port_cli(argv)
    assert rc == jrc == 2
    assert "exhausted: no messages in flight" in out
    assert out == jout


@pytest.mark.parametrize("flags,item", (
    # Multi-rumor traffic runs on the event engine's sharded backend too
    # (A13.2), on the overlay graph as well (A13.4); across processes it
    # does not.
    (["-traffic", "stream", "-backend", "sharded", "-distributed"], "A13"),
    (["-n", "300000000"], "A18"),
    # Fault scenarios and healing run on the sharded backend (A13.1), with
    # the overlay graph and the ring engine too (A13.4); across processes
    # they do not.
    (["-overlay-mode", "rounds", "-overlay-heal", "on", "-backend",
      "sharded", "-distributed"], "A13"),
    (["-overlay-mode", "ticks", "-n", "40000000"], "A17"),
    (["-n", "100000000", "-mailbox-cap", "16", "-overlay-mode", "ticks"],
     "A17"),
    (["-graph", "erdos", "-backend", "sharded", "-scenario", CHURN,
      "-engine", "ring", "-distributed"], "A13"),
    (["-graph", "overlay", "-backend", "sharded", "-overlay-heal", "on",
      "-distributed"], "A13"),
    (["-graph", "kout", "-rumors", "4", "-overlay-heal", "on", "-backend",
      "sharded", "-distributed"], "A13"),
    (["-graph", "kout", "-serve"], "A14"),
    (["-graph", "kout", "-supervise"], "A14"),
    # -backend sharded runs every engine and graph on one card (A13.1-
    # A13.5); across processes it does not.
    (["-graph", "overlay", "-backend", "sharded", "-distributed"], "A13"),
    (["-graph", "kout", "-distributed"], "A13"),
    (["-graph", "kout", "-backend", "native"], "A16"),
    # Checkpoints run (slice 16, A7); the worker pool does not.
    (["-graph", "kout", "-workers", "4"], "A14"),
    (["-graph", "kout", "-tuning-table", "off"], "A15"),
    (["-graph", "kout", "-backend", "sharded", "-pallas", "-scenario",
      CHURN, "-overlay-heal", "on", "-time-mode", "rounds",
      "-distributed"], "A13"),
    (["-graph", "kout", "-engine", "ring", "-backend", "sharded",
      "-distributed"], "A13"),
    # The reference flags the port parses without running them (C2).
    (["-graph", "kout", "-traffic", "stream", "-arrivals", "poisson",
      "-backend", "sharded", "-serve"], "A14"),
    (["-graph", "kout", "-serve-high", "0.9"], "A14"),
    (["-graph", "kout", "-serve-low", "0.2"], "A14"),
    (["-graph", "kout", "-serve-window", "4"], "A14"),
    (["-graph", "kout", "-serve-min-shards", "2"], "A14"),
    (["-graph", "kout", "-serve-max-shards", "4"], "A14"),
    (["-graph", "kout", "-serve-force", "2@3"], "A14"),
    (["-graph", "kout", "-serve-max-defer", "100"], "A14"),
    (["-graph", "kout", "-ckpt-keep", "2", "-serve"], "A14"),
    (["-graph", "kout", "-coordinator", "localhost:1234"], "A13"),
    (["-graph", "kout", "-num-processes", "2"], "A13"),
    (["-graph", "kout", "-process-id", "0"], "A13"),
    (["-graph", "kout", "-workers", "3"], "A14"),
    (["-graph", "kout", "-heartbeat-dir", "h"], "A14"),
    (["-graph", "kout", "-heartbeat-timeout-ms", "100"], "A14"),
    (["-graph", "kout", "-chaos", "kill-worker@0"], "A14"),
    (["-graph", "kout", "-recover-max-stale", "3"], "A14"),
    (["-graph", "kout", "-run-id", "r1", "-heartbeat-timeout-ms", "50"],
     "A14"),
    (["-graph", "kout", "-init-timeout", "5"], "A14"),
))
def test_unported_flags_are_named(flags, item):
    with pytest.raises(tcfg.NotYetPorted,
                       match=rf"not yet ported \(ROADMAP {item}\)"):
        tcfg.parse_cli(["-n", "100"] + flags)  # a later -n wins


def test_every_reference_flag_parses():
    """Each option string of the JAX package's parser is the port's too
    (C2), with the same destination and default."""
    ref = {o: a for a in jcfg._build_parser()._actions
           for o in a.option_strings}
    port = {o: a for a in tcfg._build_parser()._actions
            for o in a.option_strings}
    assert set(ref) <= set(port)
    for opt, a in ref.items():
        assert (port[opt].dest, port[opt].default) == (a.dest, a.default), opt


@pytest.mark.parametrize("flags", (
    ["-run-dir", "x"], ["-trace", "t.json"], ["-log-jsonl", "l.jsonl"],
    ["-telemetry-summary"], ["-profile"], ["-profile-dir", "p"],
    ["-xprof", "x"]))
def test_recording_flags_are_ported(flags):
    """The seven recording flags validate (slice 15) and resolve as the
    JAX package's do: a -run-dir run logs and traces into its dir."""
    cfg, _ = tcfg.parse_cli(["-graph", "kout", "-n", "300", *flags])
    jc = jcfg.parse_args(["-graph", "kout", "-n", "300", *flags])
    assert (cfg.log_jsonl_resolved, cfg.trace_resolved) == (
        jc.log_jsonl_resolved, jc.trace_resolved)
    assert cfg.telemetry_enabled and not cfg.telemetry_spatial_enabled


# Slice 18 ports the spatial panels (A13.3) and the pipelined exchange
# (A13.5): each of these ran into NotYetPorted before it.
SPATIAL_AND_PIPELINE = (
    ["-graph", "kout", "-model", "pushsum", "-droprate", "0", "-crashrate",
     "0", "-backend", "sharded", "-scenario", CHURN, "-telemetry-spatial",
     "on"],
    ["-graph", "kout", "-rumors", "4", "-backend", "sharded",
     "-exchange-pipeline", "double"],
    ["-graph", "kout", "-backend", "sharded", "-scenario", PARTITION,
     "-telemetry-spatial", "on"],
    ["-graph", "kout", "-run-dir", "x", "-telemetry-spatial", "on"],
    ["-graph", "kout", "-trace", "t.json", "-telemetry-spatial", "on"],
    ["-graph", "kout", "-log-jsonl", "l.jsonl", "-telemetry-spatial", "on"],
    ["-graph", "kout", "-pallas", "-backend", "sharded",
     "-exchange-pipeline", "double"],
    ["-graph", "kout", "-exchange-pipeline", "double"],
    ["-graph", "kout", "-telemetry-spatial", "on"],
    ["-graph", "kout", "-telemetry-summary", "-telemetry-spatial", "on"],
    ["-graph", "kout", "-backend", "sharded", "-overlay-heal", "on",
     "-heal-detect-ms", "50", "-telemetry-spatial", "on"],
    ["-graph", "kout", "-traffic", "stream", "-stream-rate", "200",
     "-backend", "sharded", "-exchange-pipeline", "double"],
    ["-graph", "kout", "-profile", "-telemetry-spatial", "on"],
    ["-graph", "kout", "-profile-dir", "p", "-telemetry-spatial", "on"],
    ["-graph", "kout", "-xprof", "x", "-telemetry-spatial", "on"],
    ["-graph", "kout", "-delaylow", "1", "-delayhigh", "2000", "-backend",
     "sharded", "-scenario", CHURN, "-exchange-pipeline", "double"],
    # From the sharded backend's, PushSum's and the ring engine's files.
    ["-backend", "sharded", "-graph", "kout", "-n", "800",
     "-exchange-pipeline", "double"],
    ["-model", "pushsum", "-graph", "kout", "-n", "100", "-droprate", "0",
     "-crashrate", "0", "-backend", "sharded", "-exchange-pipeline",
     "double"],
    ["-graph", "kout", "-rumors", "4", "-backend", "sharded",
     "-exchange-pipeline", "double", "-n", "100"],
)


@pytest.mark.parametrize("flags", SPATIAL_AND_PIPELINE)
def test_spatial_and_pipeline_flags_are_ported(flags):
    """-telemetry-spatial on and -exchange-pipeline double validate and
    resolve as the JAX package's parser resolves them; auto stays off
    (one process holds every shard)."""
    cfg, _ = tcfg.parse_cli(["-n", "400", *flags])
    jc = jcfg.parse_args(["-n", "400", *flags])
    assert cfg.telemetry_spatial_enabled == jc.telemetry_spatial_enabled
    assert cfg.exchange_pipeline == jc.exchange_pipeline
    assert cfg.exchange_pipeline_resolved == (
        jc.exchange_pipeline_resolved if cfg.exchange_pipeline != "auto"
        else "off")
    assert cfg.telemetry_spatial_enabled == ("-telemetry-spatial" in flags)


@pytest.mark.parametrize("flags", (
    ["-checkpoint-every", "1"], ["-checkpoint-dir", "d"],
    ["-checkpoint-every", "3", "-checkpoint-dir", "d"],
    ["-resume", "-checkpoint-dir", "d"], ["-ckpt-keep", "2"],
    ["-run-id", "r1"]))
def test_checkpoint_flags_are_ported(flags):
    """The five checkpoint flags validate (slice 16) and resolve as the
    JAX package's do: snapshots are written only with both
    -checkpoint-every and -checkpoint-dir."""
    cfg, _ = tcfg.parse_cli(["-graph", "kout", "-n", "300", *flags])
    jc = jcfg.parse_args(["-graph", "kout", "-n", "300", *flags])
    for f in ("checkpoint_every", "checkpoint_dir", "resume", "ckpt_keep",
              "run_id", "checkpointing_enabled"):
        assert getattr(cfg, f) == getattr(jc, f), f


@pytest.mark.parametrize("flags", (["-resume"], ["-ckpt-keep", "-1"],
                                   ["-resume", "-backend", "native",
                                    "-checkpoint-dir", "d"]))
def test_checkpoint_flags_refused_alike(flags):
    argv = ["-graph", "kout", "-n", "300", *flags]
    with pytest.raises(ValueError) as want:
        jcfg.parse_args(argv)
    with pytest.raises(ValueError) as got:
        tcfg.parse_cli(argv)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("flags", (["-telemetry", "off"], ["-telemetry", "on"],
                                   ["-er-p", "0.01", "-graph", "erdos"]))
def test_ported_reference_flags_run(flags):
    """-telemetry off selects the windowed loop, on the run-to-target
    paths with the device history; -er-p sets the erdos graph's mean
    degree."""
    cfg, _ = tcfg.parse_cli(["-graph", "kout", "-n", "300", *flags])
    assert cfg.er_p_resolved * cfg.n == (3.0 if "-er-p" in flags else
                                         cfg.fanout)
