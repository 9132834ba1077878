"""Shared by the sharded overlay and ring-engine twins
(``test_torch_sharded_{ring,ring_graphs,ring_rounds,overlay,
overlay_rounds}.py``): one ``run_simulation`` of a Config on either
package's ``ShardedStepper(cfg, n_devices=S)`` (the port's shards on the
CPU, the JAX package's on its fake 8-device mesh), recording each
window's Stats, each overlay window's (makeups, breakups, quiesced) and
the phase-1 state after OSNAP windows; and the checks that hold the
port's run to the reference's.  The test files make each reference run
once, through ``reference_fixture``."""

import io

import numpy as np
import pytest

from gossip_simulator_tpu.backends.sharded import ShardedStepper as JStepper
from gossip_simulator_tpu.config import Config as JConfig
from gossip_simulator_tpu.driver import run_simulation as jrun
from gossip_simulator_tpu.utils.metrics import ProgressPrinter as JPrinter
from gossip_simulator_tpu_torch.backends import ShardedStepper as TStepper
from gossip_simulator_tpu_torch.config import Config as TConfig
from gossip_simulator_tpu_torch.driver import run_simulation as trun
from gossip_simulator_tpu_torch.utils.metrics import \
    ProgressPrinter as TPrinter
from gossip_simulator_tpu_torch.utils.telemetry import GCOL
from test_torch_sharded_twins import (Recording, _assert_same_leaves,
                                      _twin_lines)

OSNAP = 2  # overlay windows run before the phase-1 state is recorded


class OverlayRecording(Recording):
    """Recording that also keeps each overlay window's (makeups, breakups,
    quiesced) and the phase-1 state after window OSNAP."""

    def __init__(self, stepper):
        super().__init__(stepper)
        self.overlay = []
        self.osnap = None

    def overlay_window(self):
        out = self.inner.overlay_window()
        self.overlay.append(tuple(int(x) for x in out))
        if len(self.overlay) == OSNAP:
            self.osnap = self.inner.overlay_state_pytree()
        return out


def run(package, kw, shards, telemetry, pipe="off"):
    """(transcript, recording, RunResult) of `kw` on `package`'s sharded
    stepper of `shards` shards."""
    ref = package == "ref"
    cfg = (JConfig if ref else TConfig)(
        **kw, backend="sharded", telemetry=telemetry,
        exchange_pipeline=pipe).validate()
    stepper = (JStepper(cfg, n_devices=shards) if ref
               else TStepper(cfg, n_devices=shards, device="cpu"))
    rec = OverlayRecording(stepper)
    out = io.StringIO()
    res = (jrun if ref else trun)(
        cfg, printer=(JPrinter if ref else TPrinter)(out=out), stepper=rec)
    return out.getvalue(), rec, res


def reference_fixture(cases):
    """A module fixture: the reference's run of each case (kw, shards,
    telemetry[, pipe]) of `cases`, made on first use."""
    @pytest.fixture(scope="module")
    def reference():
        runs = {}

        def get(name):
            if name not in runs:
                runs[name] = run("ref", *cases[name])
            return runs[name]

        return get

    return reference


def check_twin(want, got, telemetry, pipe="off") -> None:
    """The port's run `got` is the reference's `want`: the overlay's
    windows and phase-1 state, the per-window Stats (the windowed loop's,
    under -telemetry off), the transcript (note lines aside), the result,
    the final leaves, and under -telemetry on the histories (with
    exchange_inflight_hwm 2 under -exchange-pipeline double)."""
    (text, ref, res), (got_text, rec, out) = want, got
    assert rec.overlay == ref.overlay
    if ref.osnap is not None:
        _assert_same_leaves(ref.osnap, rec.osnap)
    assert rec.rows == ref.rows
    if telemetry == "off":
        assert len(ref.rows) > 3
    assert _twin_lines(got_text) == _twin_lines(text)
    assert (out.converged, out.stabilize_ms, out.coverage_ms,
            out.overlay_windows) == (res.converged, res.stabilize_ms,
                                     res.coverage_ms, res.overlay_windows)
    assert out.stats.to_dict() == res.stats.to_dict()
    _assert_same_leaves(ref.state_pytree(), rec.state_pytree())
    if telemetry == "on":
        tel, jtel = rec.inner._telem, ref.inner._telem
        for phase in ("overlay", "gossip"):
            hist = getattr(tel, f"{phase}_snapshot")()
            jhist = getattr(jtel, f"{phase}_snapshot")()
            assert (hist is None) == (jhist is None)
            if hist is None:
                continue
            assert hist["count"] == jhist["count"] > 0
            cols = hist["cols"][:hist["count"]]
            assert np.array_equal(cols, np.asarray(jhist["cols"])[
                :jhist["count"]])
            if phase == "gossip" and pipe == "double":
                assert (cols[:, GCOL["exchange_inflight_hwm"]] == 2).all()
