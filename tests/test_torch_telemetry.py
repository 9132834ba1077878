"""The port's device-recorded telemetry against the JAX package's.

* gossip_probe / overlay_probe: a JaxStepper state taken mid-run, carried
  into the port through numpy, gives the reference probe's row, recorded
  into a History and fetched back in one read;
* the history a run-to-target run records equals the reference's
  (``telem.gossip_snapshot()["cols"]``, and the overlay's) row for row;
* the run-to-target path and the windowed loop give the same stdout under
  ``-telemetry on``, the same Stats and the same trajectory fingerprint,
  with the bases "telemetry" and "windows" (the port's copy of
  test_flightrec.test_fingerprint_path_independent).

Exact equality throughout."""

import io
import json

import numpy as np
import pytest
import torch

from gossip_simulator_tpu import config as jcfg
from gossip_simulator_tpu.backends.jax_backend import JaxStepper
from gossip_simulator_tpu.driver import run_simulation as jrun
from gossip_simulator_tpu.utils import telemetry as jtelem
from gossip_simulator_tpu.utils.metrics import ProgressPrinter as JPrinter
from gossip_simulator_tpu_torch import config as tcfg
from gossip_simulator_tpu_torch.backends import TorchStepper
from gossip_simulator_tpu_torch.driver import run_simulation as trun
from gossip_simulator_tpu_torch.utils import rng as trng
from gossip_simulator_tpu_torch.utils import telemetry as ttelem
from gossip_simulator_tpu_torch.utils.metrics import \
    ProgressPrinter as TPrinter
from test_torch_rng import match_jax_threefry

KOUT = dict(graph="kout", n=2000, fanout=6, seed=1)
# Static-graph engines, each probed and run to target.
GOSSIP = {
    "event_si": KOUT,
    "event_sir": dict(KOUT, fanout=3, seed=3, protocol="sir",
                      removal_rate=0.3, droprate=0.3),
    "ring_sir": dict(KOUT, engine="ring", protocol="sir",
                     removal_rate=0.2),
    "pushsum": dict(KOUT, model="pushsum", droprate=0.0, crashrate=0.0),
    "rumors16": dict(KOUT, n=3000, seed=4, rumors=16, crashrate=0.0,
                     coverage_target=0.95),
}
OVERLAY = {
    "ticks": dict(n=2000, seed=1, coverage_target=0.9),
    "rounds": dict(n=3000, fanout=5, seed=9, overlay_mode="rounds",
                   coverage_target=0.9),
}
RUNS = dict(GOSSIP, **{f"overlay_{k}": v for k, v in OVERLAY.items()})


@pytest.fixture(autouse=True, scope="module")
def threefry_layout():
    """Draw in the counter layout this process's jax uses."""
    old = trng.partitionable()
    match_jax_threefry()
    yield
    trng.set_partitionable(old)


def _row(probe) -> np.ndarray:
    """The reference probe's row as its History.record stores it."""
    return np.asarray([np.asarray(v).astype(np.int32) for v in probe])


def _port_row(probe) -> np.ndarray:
    """The port's probe recorded into a History and fetched back."""
    hist = ttelem.empty_history(3, len(probe), "cpu")
    ttelem.record(hist, probe)
    got = ttelem.fetch_history(hist)
    assert (got["count"], got["recorded"], got["truncated"]) == (1, 1, False)
    return got["cols"][0]


def _probe_kw(cfg, st) -> dict:
    if cfg.model == "pushsum":
        return dict(relerr=st.relerr_ppb)
    return dict(rumors=cfg.rumors if cfg.multi_rumor else 0)


@pytest.mark.parametrize("case", sorted(GOSSIP))
def test_gossip_probe_matches_reference(case):
    kw = dict(GOSSIP[case], progress=False, telemetry="off")
    jc, tc = jcfg.Config(**kw).validate(), tcfg.Config(**kw).validate()
    js = JaxStepper(jc)
    js.init()
    js.overlay_window()
    js.seed()
    for _ in range(4):
        js.gossip_window()
    sir = jc.protocol == "sir"
    want = _row(jtelem.gossip_probe(js.state, sir,
                                    **_probe_kw(jc, js.state)))
    ts = TorchStepper(tc, device="cpu")
    ts.init()
    ts.load_state_pytree(js.state_pytree())
    got = _port_row(ttelem.gossip_probe(ts.state, sir,
                                        **_probe_kw(tc, ts.state)))
    assert got.tolist() == want.tolist()
    assert want[jtelem.GCOL["tick"]] >= 40 and want[jtelem.GCOL["msg_lo"]]


def test_msg_words_split_a_large_total():
    """A total past 2**32 travels as its (hi, lo) words, high word
    first, as the reference's bitcast of its uint32 pair."""
    v = (5 << 32) + 0x89ABCDEF
    hi, lo = ttelem._msg_words(torch.tensor(v, dtype=torch.int64))
    cols = np.zeros((1, len(ttelem.GOSSIP_COLS)), np.int32)
    cols[0, ttelem.GCOL["msg_hi"]] = int(hi)
    cols[0, ttelem.GCOL["msg_lo"]] = int(lo)
    assert int(hi) == 5 and int(ttelem._msg64_col(cols)[0]) == v


@pytest.mark.parametrize("mode", sorted(OVERLAY))
def test_overlay_probe_matches_reference(mode):
    kw = dict(OVERLAY[mode], progress=False)
    jc, tc = jcfg.Config(**kw).validate(), tcfg.Config(**kw).validate()
    js = JaxStepper(jc)
    js.init()
    for _ in range(3):
        assert not js.overlay_window()[2]
    want = _row(jtelem.overlay_probe(js.ostate))
    ts = TorchStepper(tc, device="cpu")
    ts.init()
    ts.load_overlay_state_pytree(js.overlay_state_pytree())
    got = _port_row(ttelem.overlay_probe(ts.ostate))
    assert got.tolist() == want.tolist()


@pytest.fixture(scope="module")
def reference():
    """The JAX package's run-to-target run of each case (telemetry on,
    an observing printer), made on first use: (stdout, stepper,
    RunResult)."""
    runs = {}

    def get(name):
        if name not in runs:
            cfg = jcfg.Config(**RUNS[name]).validate()
            js = JaxStepper(cfg)
            out = io.StringIO()
            res = jrun(cfg, printer=JPrinter(out=out), stepper=js)
            runs[name] = (out.getvalue(), js, res)
        return runs[name]

    return get


def _port_run(kw, **extra):
    cfg = tcfg.Config(**dict(kw, **extra)).validate()
    ts = TorchStepper(cfg, device="cpu")
    out = io.StringIO()
    res = trun(cfg, printer=TPrinter(out=out), stepper=ts)
    return out.getvalue(), ts, res


def _same_history(want, got):
    assert got is not None and want is not None
    for key in ("count", "recorded", "truncated"):
        assert got[key] == want[key], key
    n = want["count"]
    assert np.array_equal(got["cols"][:n], np.asarray(want["cols"])[:n])


@pytest.mark.parametrize("name", sorted(RUNS))
def test_history_matches_reference(reference, name):
    jout, js, jres = reference(name)
    out, ts, res = _port_run(RUNS[name])
    assert out == jout
    assert res.stats.to_dict() == jres.stats.to_dict()
    _same_history(js._telem.gossip_snapshot(), ts._telem.gossip_snapshot())
    assert ts._telem.gossip_snapshot()["count"] == res.gossip_windows > 0
    if name.startswith("overlay_"):
        want, got = js._telem.overlay_snapshot(), ts._telem.overlay_snapshot()
        _same_history(want, got)
        assert got["count"] == res.overlay_windows > 1
    else:
        assert ts._telem.overlay_snapshot() is None


@pytest.mark.parametrize("name", ("event_sir", "overlay_rounds", "pushsum",
                                  "rumors16"))
def test_fast_path_equals_windowed_loop(tmp_path, name):
    runs = {}
    for telemetry in ("on", "off"):
        rdir = tmp_path / telemetry
        runs[telemetry] = _port_run(RUNS[name], telemetry=telemetry,
                                    run_dir=str(rdir))
        runs[telemetry] += (json.load(open(rdir / "result.json")),)
    (out_on, _, res_on, doc_on), (out_off, _, res_off, doc_off) = (
        runs["on"], runs["off"])
    assert res_on.stats.to_dict() == res_off.stats.to_dict()
    assert (res_on.gossip_windows, res_on.overlay_windows) == (
        res_off.gossip_windows, res_off.overlay_windows)
    assert doc_on["fingerprint"] == doc_off["fingerprint"]
    assert doc_on["fingerprint_windows"] == doc_off["fingerprint_windows"]
    assert (doc_on["fingerprint_basis"], doc_off["fingerprint_basis"]) == (
        "telemetry", "windows")
    if name != "rumors16":
        # Under -rumors the windowed loop prints the worst rumor's
        # coverage a window, the replay total_received / n (as the JAX
        # package's two loops do).
        assert out_on == out_off


@pytest.mark.parametrize("name", ("overlay_ticks", "overlay_rounds",
                                  "rumors16"))
def test_bounded_calls_resume_where_they_stopped(reference, monkeypatch,
                                                 name):
    """Bounded calls a few windows long (the budgets the full sizes get)
    carry the state and the history from call to call: the same stdout,
    Stats and histories as the reference's one-call run, and the trace
    names the later calls."""
    from gossip_simulator_tpu_torch.models import (epidemic, overlay,
                                                   overlay_ticks)
    from gossip_simulator_tpu_torch.utils import trace as ttrace

    monkeypatch.setattr(epidemic, "run_call_budget", lambda cfg: 20)
    for mod in (overlay, overlay_ticks):
        monkeypatch.setattr(mod, "run_call_budget", lambda cfg: 3)
    jout, js, jres = reference(name)
    tracer = ttrace.Tracer()
    with ttrace.activated(tracer):
        out, ts, res = _port_run(RUNS[name])
    assert out == jout
    assert res.stats.to_dict() == jres.stats.to_dict()
    _same_history(js._telem.gossip_snapshot(), ts._telem.gossip_snapshot())
    names = {e["name"] for e in tracer.events}
    assert "phase2.bounded_call" in names
    if name.startswith("overlay_"):
        _same_history(js._telem.overlay_snapshot(),
                      ts._telem.overlay_snapshot())
        assert "phase1.bounded_call" in names
    assert set(ts._telem.phases) == {"init_s", "compile_s", "execute_s",
                                     "fetch_s"}


@pytest.mark.parametrize("dead_skip", ("on", "off"))
def test_split_round_host_rows_match_reference(monkeypatch, dead_skip):
    """The split round (its band lowered in both packages) runs phase 1 as
    a host loop that records its rows on the host: the same overlay
    history, stdout and Stats as the reference's."""
    from gossip_simulator_tpu.models import overlay as jov
    from gossip_simulator_tpu_torch.models import overlay as tov

    for mod in (jov, tov):
        monkeypatch.setattr(mod, "SPLIT_ROUND_MIN_ROWS", 0)
    kw = dict(RUNS["overlay_rounds"], overlay_dead_skip=dead_skip)
    jc = jcfg.Config(**kw).validate()
    js = JaxStepper(jc)
    jbuf = io.StringIO()
    jres = jrun(jc, printer=JPrinter(out=jbuf), stepper=js)
    out, ts, res = _port_run(kw)
    assert tov.use_split_round(ts.cfg) and ts._osplit
    assert out == jbuf.getvalue()
    assert res.stats.to_dict() == jres.stats.to_dict()
    _same_history(js._telem.overlay_snapshot(), ts._telem.overlay_snapshot())
    _same_history(js._telem.gossip_snapshot(), ts._telem.gossip_snapshot())
