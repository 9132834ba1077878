"""Mesh-sharded backend: S shards of the node axis on one device.

``TorchStepper``'s surface over the sharded engines: the state is a list
of per-shard states run in lockstep (``parallel/mesh.py``), built per
shard from birth.  Phase 1 (``-graph overlay``) runs the sharded
tick-faithful overlay (``parallel/overlay_ticks_sharded.py``) or the
sharded rounds overlay (``parallel/sharded_step.py``), as
``Config.overlay_mode_resolved`` picks; at quiescence each shard's
friends table seeds its phase-2 state.  Phase 2 runs the event engine
(``parallel/event_sharded.py``), the ring engine
(``parallel/sharded_step.py``: ``-engine ring``, ``-time-mode rounds``,
``-compact``, ``-protocol pushpull``) or PushSum
(``parallel/pushsum_sharded.py``); static graphs are generated per shard
(each shard its own row block).  One ``gossip_window()`` runs 10
simulated ms (one round in rounds mode) on every shard and reads the
counters back once.

``n_devices=None`` gives one shard per device the stepper uses, so S = 1
on one card or on ``-device cpu`` (the JAX package on one chip does the
same); a caller asks for S > 1 shards on the one device by passing
``n_devices``, as the JAX package's tests and bench pass it to their
``ShardedStepper``.  Fault scenarios and healing run on every engine but
push-pull, the rumor axis on the event engine.  ``run_to_target`` and
``overlay_run_to_quiescence`` are the run-to-target paths
(``base.run_bounded_to_target`` over the engine's
``make_run_to_coverage_fn``; ``overlay.make_bounded_run`` over the
sharded poll or round), recording a telemetry row a window under
``-telemetry on``.  A phase-2 snapshot of any shard count restores onto
S shards (``load_state_pytree``); a phase-1 snapshot restores onto the
shard count that wrote it.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from gossip_simulator_tpu_torch.backends.base import (Stepper, WINDOW_MS,
                                                     run_bounded_to_target)
from gossip_simulator_tpu_torch.backends.torch_backend import resolve_device
from gossip_simulator_tpu_torch.config import Config
from gossip_simulator_tpu_torch.models import (epidemic, event, overlay,
                                               overlay_ticks, pushsum)
from gossip_simulator_tpu_torch.models.state import in_flight
from gossip_simulator_tpu_torch.parallel import (event_sharded,
                                                 overlay_ticks_sharded,
                                                 pushsum_sharded,
                                                 sharded_step)
from gossip_simulator_tpu_torch.parallel.mesh import node_mesh, shard_size
from gossip_simulator_tpu_torch.utils import interop
from gossip_simulator_tpu_torch.utils import rng as _rng
from gossip_simulator_tpu_torch.utils import trace as _trace
from gossip_simulator_tpu_torch.utils.metrics import Stats
from gossip_simulator_tpu_torch.utils.telemetry import TelemetrySession


class ShardedStepper(Stepper):
    name = "sharded"

    def __init__(self, cfg: Config, n_devices: int | None = None,
                 device="cuda"):
        super().__init__(cfg)
        self.device = resolve_device(device)
        self.mesh = node_mesh(n_devices, self.device)
        self.n_local = shard_size(cfg.n, self.mesh)  # validate early

    def init(self) -> None:
        cfg = self.cfg
        self.key = _rng.base_key(cfg.seed, self.device)
        if cfg.model == "pushsum":
            engine, init_fn = (pushsum_sharded,
                               pushsum_sharded.make_sharded_pushsum_init)
        elif cfg.engine_resolved == "event":
            engine, init_fn = (event_sharded,
                               event_sharded.make_sharded_event_init)
        else:
            engine, init_fn = sharded_step, sharded_step.make_sharded_init
        self._engine = engine
        window = 1 if cfg.effective_time_mode == "rounds" else WINDOW_MS
        self._window_fn = engine.make_window_fn(cfg, self.mesh, window)
        self._seed_fn = engine.make_seed_fn(cfg, self.mesh)
        self._run_fn = engine.make_run_to_coverage_fn(cfg, self.mesh)
        self._telem = (TelemetrySession(cfg, self.device,
                                        n_shards=self.mesh.n_shards)
                       if cfg.telemetry_enabled else None)
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
            self.ostate = self._oinit()
            self.state = None
            self._overlay_done = False
        else:
            self.state = init_fn(cfg, self.mesh)()
            self._overlay_done = True

    # --- phase 1 ---------------------------------------------------------------
    def _setup_overlay(self) -> None:
        """The sharded phase-1 engine: the tick-faithful poll, or the
        rounds engine's round (which has no split round: it warns when a
        shard's rows reach that band)."""
        cfg, mesh = self.cfg, self.mesh
        self._faithful = cfg.overlay_mode_resolved == "ticks"
        if self._faithful:
            self._omod = overlay_ticks
            self._oround = overlay_ticks_sharded.make_poll_fn(cfg, mesh)
            init = overlay_ticks_sharded.make_sharded_init(cfg, mesh)
            self._oinit = lambda: init(self.key)
        else:
            self._omod = overlay
            self._oround = sharded_step.make_sharded_overlay_round(cfg, mesh)
            self._oinit = sharded_step.make_sharded_overlay_init(cfg, mesh)
        self._orun = None

    def _round(self, box, base_key):
        """One poll window or round of every shard on the list popped from
        `box`; returns the new list."""
        if self._faithful:
            return self._oround(box.pop(), base_key)
        return self._oround(box, base_key)

    def _all_quiesced(self, states) -> torch.Tensor:
        """0-d bool: the overlay's quiescence over every shard (the window
        counters are equal on every shard; the rings and emission rows
        are each shard's own)."""
        return torch.stack([self._omod.quiesced(st) for st in states]).all()

    def overlay_window(self) -> tuple[int, int, bool]:
        """One 10 ms poll window (tick-faithful) or one round (rounds
        engine) of every shard; (makeups, breakups, quiesced) in one host
        read.  A static graph is built at init and quiesced at once."""
        if self._overlay_done:
            return 0, 0, True
        box = [self.ostate]
        self.ostate = None
        self.ostate = self._round(box, self.key)
        self._overlay_rounds += 1
        st = self.ostate[0]
        mk, bk, q = torch.stack([
            st.win_makeups, st.win_breakups,
            self._all_quiesced(self.ostate).to(torch.int32)]).tolist()
        self._phase1_ms = (float(st.tick) if self._faithful
                           else self._overlay_rounds * self._mean_delay)
        if q:
            self._finish_overlay()
        return mk, bk, bool(q)

    def overlay_run_to_quiescence(self, max_windows: int
                                  ) -> tuple[int, bool]:
        """Phase 1's run-to-quiescence path: bounded calls of
        ``overlay.make_bounded_run`` on the sharded window or round
        (``run_call_budget`` scaled by the shard count), a telemetry row a
        window.  Returns (windows run, quiesced)."""
        if self._overlay_done:
            return 0, True
        telem = self._telem
        if self._orun is None:
            self._orun = overlay.make_bounded_run(self._round,
                                                  self._all_quiesced)
        budget = self._omod.run_call_budget(self.cfg,
                                            shards=self.mesh.n_shards)
        hist = telem.begin_overlay(max_windows) if telem is not None else None
        q = False
        calls = 0
        while True:
            lim = min(budget, max_windows - self._overlay_rounds)
            if lim <= 0:
                break
            t0 = time.perf_counter()
            with _trace.span("phase1.compile+run" if calls == 0
                             else "phase1.sharded_call",
                             cat="device") as sp:
                self.ostate, polls, q, hist = self._orun(
                    [self.ostate], self.key, lim, hist)
                if sp is not None:
                    sp.update(windows=int(polls),
                              shards=self.mesh.n_shards)
            calls += 1
            if telem is not None:
                telem.tally_overlay_call(time.perf_counter() - t0)
            self._overlay_rounds += polls
            self._phase1_ms = (float(self.ostate[0].tick) if self._faithful
                               else self._overlay_rounds * self._mean_delay)
            if q:
                break
        if hist is not None:
            telem.end_overlay(hist)
        if q:
            self._finish_overlay()
        return self._overlay_rounds, q

    @property
    def overlay_clock_scale(self) -> float:
        """Simulated ms per recorded overlay clock unit: ticks on the
        tick-faithful overlay, rounds of mean delay on the rounds one (1
        for a static graph)."""
        return 1.0 if getattr(self, "_faithful", True) else self._mean_delay

    def _finish_overlay(self) -> None:
        """Freeze the phase-1 clock, carry its drop count into the Stats,
        and hand each shard's friends table to its phase-2 state."""
        cfg, s = self.cfg, self.mesh.n_shards
        self._overlay_done = True
        self._stabilize_ms = self._phase1_ms
        self._mailbox_dropped = int(self.ostate[0].mailbox_dropped)
        init = (event.init_state if self._engine is event_sharded
                else epidemic.init_state)
        self.state = [init(cfg, st.friends, st.friend_cnt, n_shards=s)
                      for st in self.ostate]
        self.ostate = None

    def overlay_state_pytree(self):
        """Mid-construction phase-1 state as the JAX package's global
        sharded dict (None once the overlay is done): node-axis leaves
        concatenated shard by shard; the tick-faithful overlay's packed
        rings as S rings side by side and ``ring_cnt`` as (S, dw), so it
        restores onto the same shard count only."""
        if self._overlay_done:
            return None
        return interop.sharded_overlay_state_to_numpy(self.ostate)

    def load_overlay_state_pytree(self, tree, windows=None) -> None:
        """Continue construction from a JAX-package (or port) sharded
        phase-1 dict of this stepper's shard count, validated by
        ``checkpoint.prepare_overlay_restore_tree``."""
        from gossip_simulator_tpu_torch.utils.checkpoint import \
            prepare_overlay_restore_tree

        tree = prepare_overlay_restore_tree(tree, self.cfg,
                                            n_shards=self.mesh.n_shards)
        self._setup_overlay()
        self.ostate = interop.sharded_overlay_state_from_numpy(
            tree, self.mesh.n_shards, self.device)
        self.state = None
        self._overlay_done = False
        st = self.ostate[0]
        if windows is not None:
            self._overlay_rounds = int(windows)
        elif not self._faithful:
            self._overlay_rounds = st.round
        self._phase1_ms = (float(st.tick) if self._faithful
                           else self._overlay_rounds * self._mean_delay)

    # --- phase 2 ---------------------------------------------------------------
    def seed(self) -> None:
        self._seeded = True
        self._seed_fn(self.state, self.key)

    def gossip_window(self) -> Stats:
        with _trace.span("phase2.sharded_window", cat="device",
                         shards=self.mesh.n_shards):
            self._window_fn(self.state, self.key)
        stats, live = self.stats_and_inflight()
        # Push-pull has nothing in flight; healing can revive an empty
        # ring: neither reports exhaustion (TorchStepper's rule).
        self.exhausted = (not live and self.cfg.protocol != "pushpull"
                          and not self.cfg.overlay_heal_resolved)
        stats.exhausted = self.exhausted
        return stats

    def stats_and_inflight(self) -> tuple[Stats, bool]:
        """All progress-window scalars in ONE device-to-host read: the
        replicated counters (the fault counters and the per-rumor counts
        too) from shard 0, removed and in-flight over every shard."""
        cfg, st = self.cfg, self.state[0]
        zero = torch.zeros((), dtype=torch.int64, device=self.device)
        removed = (sum(event.removed_count(x) for x in self.state)
                   if cfg.protocol == "sir" else zero)
        live = torch.stack([in_flight(x) for x in self.state]).any()
        r = cfg.rumors
        rmin, rdone = zero - 1, zero
        if cfg.multi_rumor:
            rmin = st.rumor_recv[:r].min()
            rdone = (st.rumor_done[:r] >= 0).sum()
        vals = torch.stack([
            st.total_message, st.total_received, st.total_crashed,
            removed, getattr(st, "mail_dropped", zero).to(torch.int64),
            st.exchange_overflow, live.to(torch.int64), st.scen_crashed,
            st.scen_recovered, st.part_dropped, st.heal_repaired,
            rmin.to(torch.int64), rdone.to(torch.int64)]).tolist()
        (tm, tr, tc, trm, dropped, xo, live, sc, sr, pd, hr, rmin,
         rdone) = vals
        return Stats(
            n=cfg.n, round=st.tick, total_received=tr, total_message=tm,
            total_crashed=tc, total_removed=trm,
            mailbox_dropped=self._mailbox_dropped + dropped,
            exchange_overflow=xo, scen_crashed=sc, scen_recovered=sr,
            part_dropped=pd, heal_repaired=hr, exhausted=self.exhausted,
            rumors=r, rumor_min_recv=rmin, rumors_done=rdone), bool(live)

    def run_to_target(self) -> Stats:
        """The run-to-target path (base.run_bounded_to_target)."""
        return run_bounded_to_target(self)

    @property
    def tick(self) -> int:
        return self.state[0].tick

    def progress(self) -> tuple[int, int, bool]:
        """(tick, the loop's received count -- the worst rumor's under
        -rumors --, a message in flight on any shard) in one host read."""
        st, r = self.state[0], self.cfg.rumors
        recv = (st.rumor_recv[:r].min() if self.cfg.multi_rumor
                else st.total_received)
        live = torch.stack([in_flight(x) for x in self.state]).any()
        recv, live = torch.stack([recv.to(torch.int64),
                                  live.to(torch.int64)]).tolist()
        return st.tick, recv, bool(live)

    def stats(self) -> Stats:
        return self.stats_and_inflight()[0]

    def sim_time_ms(self) -> float:
        if not self._overlay_done:
            return self._phase1_ms
        if not self._seeded:
            # Between quiescence and the broadcast: phase-1 elapsed time
            # (0 for a static graph).
            return self._stabilize_ms
        return float(self.state[0].tick)

    def _geom(self) -> tuple[int, int, int]:
        geo = pushsum if self.cfg.model == "pushsum" else event
        return (geo.slot_cap(self.cfg, self.n_local),
                geo.drain_chunk(self.cfg, self.n_local), self.mesh.n_shards)

    def state_pytree(self):
        """The JAX package's global sharded state dict: node-axis leaves
        and rings concatenated shard by shard (the ring engine's
        ``pending`` along its node axis), per-shard counts as (S, dw)
        rows, and on the event engine and PushSum ``mail_geom`` =
        (slot_cap, drain_chunk, S) per shard.  None before there is a
        phase-2 state."""
        if self.state is None:
            return None
        to_numpy = {pushsum_sharded: interop.sharded_pushsum_state_to_numpy,
                    event_sharded: interop.sharded_state_to_numpy,
                    sharded_step: interop.sharded_sim_state_to_numpy}
        tree = to_numpy[self._engine](self.state)
        tree["host_mailbox_dropped"] = np.int64(self._mailbox_dropped)
        return tree

    def load_state_pytree(self, tree) -> None:
        """Continue from a JAX-package (or port) phase-2 state dict of any
        shard count, validated and coerced by
        ``checkpoint.prepare_restore_tree``: the event and PushSum rings
        are re-bucketed onto this stepper's S shards, or repacked shard by
        shard to this config's slot geometry; the ring engine's state has
        no shard layout of its own and splits onto any S."""
        from gossip_simulator_tpu_torch.utils.checkpoint import \
            prepare_restore_tree

        s = self.mesh.n_shards
        tree = prepare_restore_tree(tree, self.cfg, n_shards=s)
        self._mailbox_dropped = int(tree.pop("host_mailbox_dropped", 0))
        if self._engine is sharded_step:
            self.state = interop.sharded_sim_state_from_numpy(tree, s,
                                                              self.device)
        else:
            tree["mail_geom"] = np.asarray(self._geom(), np.int64)
            from_numpy = (interop.sharded_pushsum_state_from_numpy
                          if self._engine is pushsum_sharded
                          else interop.sharded_state_from_numpy)
            self.state = from_numpy(tree, s, self.device)
        self.ostate = None
        self._overlay_done = True
        self._seeded = True
