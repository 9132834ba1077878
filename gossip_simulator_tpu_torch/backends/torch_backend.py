"""Single-device PyTorch backend.

Phase 1 (``-graph overlay``): one ``overlay_window()`` runs one 10 ms poll
window of the tick-faithful overlay, or one round of the rounds overlay
(whose clock is estimated as rounds x the mean delay), and reads its
makeups, breakups and quiescence back in one host read; at quiescence the
friends table is handed to the phase-2 engine.  Static graphs quiesce at
once.  Phase 2 runs the event engine (``models/event.py``) or the ring
engine (``models/epidemic.py``: ``-time-mode rounds``, ``-engine ring``,
``-compact``, ``-protocol pushpull``), as ``Config.engine_resolved``
picks, or PushSum (``models/pushsum.py``, ``-model pushsum``); one
``gossip_window()`` runs 10 simulated ms (one round in rounds mode), and
with ``-overlay-heal on`` one healing pass after it (the engine's
``make_window_fn``), and reads the counters back once, the fault
counters into ``Stats``.

The run-to-target paths, which the driver takes unless a printer
observes every window without telemetry: ``overlay_run_to_quiescence``
(bounded calls of the overlay's run loop; the split round's host loop
at memory scale) and ``run_to_target`` (``base.run_bounded_to_target``
over the engine's ``make_run_to_coverage_fn``).  Under ``-telemetry
on`` (``Config.telemetry_enabled``) they record one row a window into
the ``TelemetrySession``'s device histories (``_telem``), which the
driver fetches once and replays through the printer.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from gossip_simulator_tpu_torch.backends.base import (Stepper, WINDOW_MS,
                                                     run_bounded_to_target)
from gossip_simulator_tpu_torch.config import Config
from gossip_simulator_tpu_torch.models import (epidemic, event, graphs,
                                               overlay, overlay_ticks,
                                               pushsum)
from gossip_simulator_tpu_torch.models.state import in_flight
from gossip_simulator_tpu_torch.utils import interop
from gossip_simulator_tpu_torch.utils import rng as _rng
from gossip_simulator_tpu_torch.utils import trace as _trace
from gossip_simulator_tpu_torch.utils.metrics import Stats
from gossip_simulator_tpu_torch.utils.telemetry import TelemetrySession


class DeviceUnavailable(RuntimeError):
    """The requested device does not exist on this host."""


def resolve_device(device) -> torch.device:
    """torch.device for `device` ("cuda", "cuda:N" or "cpu").  A missing
    card raises, naming it; nothing falls back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise DeviceUnavailable(
                f"device {device!r} requested but no CUDA device is "
                "available (torch.cuda.is_available() is False); pass "
                "-device cpu (device='cpu') to run on the CPU")
        if dev.index is not None and dev.index >= torch.cuda.device_count():
            raise DeviceUnavailable(
                f"device {device!r} requested but only "
                f"{torch.cuda.device_count()} CUDA device(s) exist")
    elif dev.type != "cpu":
        raise DeviceUnavailable(f"device {device!r} is not supported "
                                "(use cuda or cpu)")
    return dev


class TorchStepper(Stepper):
    name = "torch"

    def __init__(self, cfg: Config, device="cuda"):
        super().__init__(cfg)
        self.device = resolve_device(device)

    def init(self) -> None:
        cfg = self.cfg
        dev = self.device
        self.key = _rng.base_key(cfg.seed, dev)
        if cfg.model == "pushsum":
            self._engine = pushsum
        else:
            self._engine = (event if cfg.engine_resolved == "event"
                            else epidemic)
        self._seed_fn = self._engine.make_seed_fn(cfg)
        window = 1 if cfg.effective_time_mode == "rounds" else WINDOW_MS
        self._window_fn = self._engine.make_window_fn(cfg, window)
        self._run_fn = self._engine.make_run_to_coverage_fn(cfg)
        self._telem = (TelemetrySession(cfg, dev) if cfg.telemetry_enabled
                       else None)
        self._mailbox_dropped = 0
        self._seeded = False
        self.exhausted = False
        self._phase1_ms = 0.0
        self._stabilize_ms = 0.0
        self._overlay_rounds = 0
        self._mean_delay = ((cfg.delaylow + cfg.delayhigh) / 2.0
                            if cfg.effective_time_mode == "ticks" else 1.0)
        self.ostate = None
        if cfg.graph == "overlay":
            self._setup_overlay()
            self.ostate = self._omod.init_state(cfg, self.key)
            self.state = None
            self._overlay_done = False
        else:
            friends, cnt = graphs.generate(cfg, graphs.graph_key(cfg, dev))
            self.state = self._engine.init_state(cfg, friends, cnt)
            self._overlay_done = True

    # --- phase 1 ---------------------------------------------------------------
    def _setup_overlay(self) -> None:
        """The phase-1 engine: the tick-faithful poll, or the rounds
        engine's round (the split round from SPLIT_ROUND_MIN_ROWS)."""
        cfg = self.cfg
        self._faithful = cfg.overlay_mode_resolved == "ticks"
        self._osplit = False
        if self._faithful:
            self._omod = overlay_ticks
            self._oround = overlay_ticks.make_poll_fn(cfg)
        else:
            self._omod = overlay
            self._osplit = overlay.use_split_round(cfg)
            self._oround = (overlay.make_split_round_fn(cfg)
                            if self._osplit else overlay.make_round_fn(cfg))
        self._orun = None

    def _round(self, box, base_key):
        """One poll window (tick-faithful, in place) or one round (rounds
        engine) on the state popped from `box`; returns the new state."""
        if self._faithful:
            return self._oround(box.pop(), base_key)
        return self._oround(box, base_key)

    def _advance_overlay(self) -> None:
        """One window or round of overlay construction, the state handed
        over in a popped box: no frame here keeps the old state's buffers
        alive through the round."""
        box = [self.ostate]
        self.ostate = None
        self.ostate = self._round(box, self.key)
        self._overlay_rounds += 1

    def overlay_window(self) -> tuple[int, int, bool]:
        """One 10 ms poll window (tick-faithful) or one round (rounds
        engine) of overlay construction; (makeups, breakups, quiesced) in
        one host read.  A static graph is built at init and quiesced at
        once."""
        if self._overlay_done:
            return 0, 0, True
        self._advance_overlay()
        st = self.ostate
        # The split round reports quiescence from its write-time counts.
        q = getattr(self._oround, "last_quiesced", None)
        if q is None:
            mk, bk, q = torch.stack([
                st.win_makeups, st.win_breakups,
                self._omod.quiesced(st).to(torch.int32)]).tolist()
        else:
            mk, bk = torch.stack([st.win_makeups, st.win_breakups]).tolist()
        q = bool(q)
        # True simulated ms from the tick clock in faithful mode; the
        # rounds engine estimates rounds x mean delay.
        self._phase1_ms = (float(st.tick) if self._faithful
                           else self._overlay_rounds * self._mean_delay)
        if q:
            self._finish_overlay()
        return mk, bk, q

    def overlay_run_to_quiescence(self, max_windows: int
                                  ) -> tuple[int, bool]:
        """Phase 1's run-to-quiescence path: bounded calls of the overlay's
        run loop (``overlay.make_bounded_run`` on this stepper's window or
        round, ``run_call_budget`` windows a call), recording one row a
        window into the telemetry history; the split round (memory scale)
        runs its host loop instead, its row recorded from the counters it
        reads back every round anyway.  The trajectory is the windowed
        loop's.  Returns (windows run, quiesced)."""
        if self._overlay_done:
            return 0, True
        telem = self._telem
        if self._osplit:
            return self._split_run_to_quiescence(max_windows)
        if self._orun is None:
            self._orun = overlay.make_bounded_run(self._round,
                                                  self._omod.quiesced)
        budget = self._omod.run_call_budget(self.cfg)
        hist = telem.begin_overlay(max_windows) if telem is not None else None
        q = False
        calls = 0
        while True:
            lim = min(budget, max_windows - self._overlay_rounds)
            if lim <= 0:
                break
            t0 = time.perf_counter()
            with _trace.span("phase1.compile+run" if calls == 0
                             else "phase1.bounded_call",
                             cat="device") as sp:
                self.ostate, polls, q, hist = self._orun(
                    [self.ostate], self.key, lim, hist)
                if sp is not None:
                    sp.update(windows=int(polls))
            calls += 1
            if telem is not None:
                telem.tally_overlay_call(time.perf_counter() - t0)
            self._overlay_rounds += polls
            self._phase1_ms = (float(self.ostate.tick) if self._faithful
                               else self._overlay_rounds * self._mean_delay)
            if q:
                break
        if hist is not None:
            telem.end_overlay(hist)
        if q:
            self._finish_overlay()
        return self._overlay_rounds, q

    def _split_run_to_quiescence(self, max_windows: int) -> tuple[int, bool]:
        """The split round's host loop: a round, then its quiescence (from
        the round's write-time counts, else one read) and, with
        telemetry, its row read back and kept on the host."""
        telem = self._telem
        q = False
        while self._overlay_rounds < max_windows:
            t0 = time.perf_counter()
            with _trace.span("phase1.split_round", cat="device"):
                self._advance_overlay()
            self._phase1_ms = self._overlay_rounds * self._mean_delay
            st = self.ostate
            q = getattr(self._oround, "last_quiesced", None)
            if telem is not None:
                mk, bk, dr = torch.stack([
                    st.win_makeups, st.win_breakups,
                    st.mailbox_dropped]).tolist()
                telem.overlay_host_row([self._overlay_rounds, mk, bk, dr])
                telem.tally_overlay_call(time.perf_counter() - t0)
            if q is None:
                q = bool(self._omod.quiesced(st))
            if q:
                break
        if q:
            self._finish_overlay()
        return self._overlay_rounds, bool(q)

    @property
    def overlay_clock_scale(self) -> float:
        """Simulated ms per recorded overlay clock unit: the tick-faithful
        engine records ticks, the rounds engine rounds of mean delay."""
        return 1.0 if getattr(self, "_faithful", True) else self._mean_delay

    def _finish_overlay(self) -> None:
        """Freeze the phase-1 clock, carry its drop count into the Stats,
        and hand the friends table to the phase-2 engine."""
        self._overlay_done = True
        self._stabilize_ms = self._phase1_ms
        self._mailbox_dropped = int(self.ostate.mailbox_dropped)
        self.state = self._engine.init_state(self.cfg, self.ostate.friends,
                                             self.ostate.friend_cnt)
        self.ostate = None  # free the ring and the phase-1 buffers

    def overlay_state_pytree(self):
        """Mid-construction phase-1 state as the JAX package's numpy dict
        (None once the overlay is done)."""
        if self._overlay_done:
            return None
        return interop.overlay_state_to_numpy(self.ostate)

    def load_overlay_state_pytree(self, tree, windows=None) -> None:
        """Continue construction from a JAX-package (or port) phase-1
        state dict, validated by ``checkpoint.prepare_overlay_restore_tree``
        (the same geometry, spill buffers re-padded).  `windows` is the
        overlay windows already run, which set the rounds engine's
        estimated clock (default: the state's round)."""
        from gossip_simulator_tpu_torch.utils.checkpoint import \
            prepare_overlay_restore_tree

        tree = prepare_overlay_restore_tree(tree, self.cfg, n_shards=1)
        self._setup_overlay()  # a fresh round fn: no carried row counts
        self.ostate = interop.overlay_state_from_numpy(tree, self.device)
        self.state = None
        self._overlay_done = False
        if windows is not None:
            self._overlay_rounds = int(windows)
        elif not self._faithful:
            self._overlay_rounds = self.ostate.round
        self._phase1_ms = (float(self.ostate.tick) if self._faithful
                           else self._overlay_rounds * self._mean_delay)

    def seed(self) -> None:
        self._seeded = True
        self._seed_fn(self.state, self.key)

    def gossip_window(self) -> Stats:
        self._window_fn(self.state, self.key)
        stats, live = self.stats_and_inflight()
        # Push-pull draws fresh peers every round: nothing is ever "in
        # flight", and its wave never dies in the ring.  Healing can revive
        # an empty ring (a pending dead-friend detection re-sends from an
        # infected healer), so heal-on runs never report exhaustion.  As in
        # the JAX package's windowed loop (-telemetry off), a stream whose
        # ring empties between two injections is exhausted here; its
        # run-to-target loop's rule (an empty ring is not exhaustion up to
        # the last injection's tick) is base.run_bounded_to_target's.
        self.exhausted = (not live and self.cfg.protocol != "pushpull"
                          and not self.cfg.overlay_heal_resolved)
        stats.exhausted = self.exhausted
        return stats

    def run_to_target(self) -> Stats:
        """Phase 2's run-to-target path (base.run_bounded_to_target)."""
        return run_bounded_to_target(self)

    @property
    def tick(self) -> int:
        return self.state.tick

    def progress(self) -> tuple[int, int, bool]:
        """(tick, the loop's received count -- the worst rumor's under
        -rumors --, a message in flight) in one host read."""
        st, r = self.state, self.cfg.rumors
        recv = (st.rumor_recv[:r].min() if self.cfg.multi_rumor
                else st.total_received)
        recv, live = torch.stack([recv.to(torch.int64),
                                  in_flight(st).to(torch.int64)]).tolist()
        return st.tick, recv, bool(live)

    def reset_state(self) -> None:
        """Rebuild phase-2 state from scratch on a static graph (same seed,
        same trajectory) and drop the phase-2 history."""
        cfg = self.cfg
        if cfg.graph == "overlay":
            raise ValueError("reset_state requires a static graph")
        self.state = None
        friends, cnt = graphs.generate(cfg, graphs.graph_key(cfg,
                                                             self.device))
        self.state = self._engine.init_state(cfg, friends, cnt)
        self.exhausted = False
        if self._telem is not None:
            self._telem.reset_gossip()

    def stats_and_inflight(self) -> tuple[Stats, bool]:
        """All progress-window scalars in ONE device-to-host read."""
        cfg, st = self.cfg, self.state
        zero = torch.zeros((), dtype=torch.int64, device=self.device)
        removed = event.removed_count(st) if cfg.protocol == "sir" else zero
        r = cfg.rumors
        rmin, rdone = zero - 1, zero
        if cfg.multi_rumor:
            rmin = st.rumor_recv[:r].min()
            rdone = (st.rumor_done[:r] >= 0).sum()
        vals = torch.stack([
            st.total_message, st.total_received, st.total_crashed,
            removed, getattr(st, "mail_dropped", zero).to(torch.int64),
            in_flight(st).to(torch.int64), st.scen_crashed,
            st.scen_recovered, st.part_dropped, st.heal_repaired,
            rmin.to(torch.int64), rdone.to(torch.int64)]).tolist()
        (tm, tr, tc, trm, dropped, live, sc, sr, pd, hr, rmin, rdone) = vals
        return Stats(
            n=cfg.n, round=st.tick, total_received=tr,
            total_message=tm, total_crashed=tc, total_removed=trm,
            mailbox_dropped=self._mailbox_dropped + dropped,
            scen_crashed=sc, scen_recovered=sr, part_dropped=pd,
            heal_repaired=hr, exhausted=self.exhausted, rumors=r,
            rumor_min_recv=rmin, rumors_done=rdone), bool(live)

    def stats(self) -> Stats:
        return self.stats_and_inflight()[0]

    def sim_time_ms(self) -> float:
        if not self._overlay_done:
            return self._phase1_ms
        if not self._seeded:
            # Between quiescence and the broadcast: phase-1 elapsed time
            # (0 for a static graph).
            return self._stabilize_ms
        return float(self.state.tick)

    def state_pytree(self):
        """Phase-2 state as the JAX package's numpy dict (copies), with
        ``mail_geom`` (slot_cap, drain_chunk) on the event engine and
        PushSum; None before there is a phase-2 state."""
        if self.state is None:
            return None
        if self._engine is event:
            tree = interop.state_to_numpy(self.state)
        elif self._engine is pushsum:
            tree = interop.pushsum_state_to_numpy(self.state)
        else:
            tree = interop.sim_state_to_numpy(self.state)
        tree["host_mailbox_dropped"] = np.int64(self._mailbox_dropped)
        return tree

    def load_state_pytree(self, tree) -> None:
        """Continue from a JAX-package (or port) phase-2 state dict,
        validated and coerced by ``checkpoint.prepare_restore_tree``: a
        ring of another slot geometry is repacked, one of S shards
        re-bucketed onto this one."""
        from gossip_simulator_tpu_torch.utils.checkpoint import \
            prepare_restore_tree

        cfg = self.cfg
        tree = prepare_restore_tree(tree, cfg, n_shards=1)
        self._mailbox_dropped = int(tree.pop("host_mailbox_dropped", 0))
        if self._engine is epidemic:
            self.state = interop.sim_state_from_numpy(tree, self.device)
        else:
            # PushSum sizes its own slots: its module is the geometry
            # authority for its state, as in the JAX package.
            geo = pushsum if self._engine is pushsum else event
            tree["mail_geom"] = np.asarray(
                [geo.slot_cap(cfg, cfg.n), geo.drain_chunk(cfg, cfg.n)],
                np.int64)
            load = (interop.pushsum_state_from_numpy
                    if geo is pushsum else interop.state_from_numpy)
            self.state = load(tree, self.device)
        self.ostate = None
        self._overlay_done = True
        self._seeded = True
