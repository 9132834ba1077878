"""Mesh-sharded backend: S shards of the node axis on one device.

``TorchStepper``'s surface over the sharded engines
(``parallel/event_sharded.py``, ``parallel/pushsum_sharded.py``): the
state is a list of per-shard states run in lockstep (``parallel/mesh.py``),
built per shard from birth (each shard generates its own row block of the
graph).  One ``gossip_window()`` runs 10 simulated ms on every shard and
reads the counters back once.

``n_devices=None`` gives one shard per device the stepper uses, so S = 1
on one card or on ``-device cpu`` (the JAX package on one chip does the
same); a caller asks for S > 1 shards on the one device by passing
``n_devices``, as the JAX package's tests and bench pass it to their
``ShardedStepper``.  Static graphs only: the sharded overlay and ring
engines are not yet ported (ROADMAP A13).  Fault scenarios and healing
run on both engines, the rumor axis on the event engine.
``run_to_target`` is the run-to-target path
(``base.run_bounded_to_target`` over the engine's
``make_run_to_coverage_fn``), recording a telemetry row a window under
``-telemetry on``.  A snapshot of any shard count restores onto S shards
(``load_state_pytree``); with no phase 1, there is no phase-1 snapshot.
"""

from __future__ import annotations

import numpy as np
import torch

from gossip_simulator_tpu_torch.backends.base import (Stepper, WINDOW_MS,
                                                     run_bounded_to_target)
from gossip_simulator_tpu_torch.backends.torch_backend import resolve_device
from gossip_simulator_tpu_torch.config import Config
from gossip_simulator_tpu_torch.models import event, pushsum
from gossip_simulator_tpu_torch.models.state import in_flight
from gossip_simulator_tpu_torch.parallel import event_sharded, pushsum_sharded
from gossip_simulator_tpu_torch.parallel.mesh import node_mesh, shard_size
from gossip_simulator_tpu_torch.utils import interop
from gossip_simulator_tpu_torch.utils import rng as _rng
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
        engine = pushsum_sharded if cfg.model == "pushsum" else event_sharded
        self._window_fn = engine.make_window_fn(cfg, self.mesh, WINDOW_MS)
        self._seed_fn = engine.make_seed_fn(cfg, self.mesh)
        self._run_fn = engine.make_run_to_coverage_fn(cfg, self.mesh)
        self._telem = (TelemetrySession(cfg, self.device,
                                        n_shards=self.mesh.n_shards)
                       if cfg.telemetry_enabled else None)
        init_fn = (pushsum_sharded.make_sharded_pushsum_init
                   if cfg.model == "pushsum"
                   else event_sharded.make_sharded_event_init)
        self.state = init_fn(cfg, self.mesh)()
        self._mailbox_dropped = 0
        self._seeded = False
        self.exhausted = False

    def overlay_window(self) -> tuple[int, int, bool]:
        """Static graphs are built at init: quiesced at once."""
        return 0, 0, True

    def overlay_run_to_quiescence(self, max_windows: int
                                  ) -> tuple[int, bool]:
        """Static graphs are built at init: quiesced without a window."""
        return 0, True

    overlay_clock_scale = 1.0

    def seed(self) -> None:
        self._seeded = True
        self._seed_fn(self.state, self.key)

    def gossip_window(self) -> Stats:
        self._window_fn(self.state, self.key)
        stats, live = self.stats_and_inflight()
        # Healing can revive an empty ring: heal-on runs never report
        # exhaustion (TorchStepper.gossip_window's rule).
        self.exhausted = not live and not self.cfg.overlay_heal_resolved
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
            removed, st.mail_dropped.to(torch.int64), st.exchange_overflow,
            live.to(torch.int64), st.scen_crashed, st.scen_recovered,
            st.part_dropped, st.heal_repaired, rmin.to(torch.int64),
            rdone.to(torch.int64)]).tolist()
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
        # A static graph: 0 ms of phase 1 until the broadcast starts.
        return float(self.state[0].tick) if self._seeded else 0.0

    def _geom(self) -> tuple[int, int, int]:
        geo = pushsum if self.cfg.model == "pushsum" else event
        return (geo.slot_cap(self.cfg, self.n_local),
                geo.drain_chunk(self.cfg, self.n_local), self.mesh.n_shards)

    def state_pytree(self):
        """The JAX package's global sharded state dict: node-axis leaves
        and rings concatenated shard by shard, per-shard counts as (S, dw)
        rows, ``mail_geom`` = (slot_cap, drain_chunk, S) per shard."""
        to_numpy = (interop.sharded_pushsum_state_to_numpy
                    if self.cfg.model == "pushsum"
                    else interop.sharded_state_to_numpy)
        tree = to_numpy(self.state)
        tree["host_mailbox_dropped"] = np.int64(self._mailbox_dropped)
        return tree

    def load_state_pytree(self, tree) -> None:
        """Continue from a JAX-package (or port) phase-2 state dict of any
        shard count, validated and coerced by
        ``checkpoint.prepare_restore_tree``: the rings are re-bucketed
        onto this stepper's S shards, or repacked shard by shard to this
        config's slot geometry."""
        from gossip_simulator_tpu_torch.utils.checkpoint import \
            prepare_restore_tree

        tree = prepare_restore_tree(tree, self.cfg,
                                    n_shards=self.mesh.n_shards)
        self._mailbox_dropped = int(tree.pop("host_mailbox_dropped", 0))
        tree["mail_geom"] = np.asarray(self._geom(), np.int64)
        from_numpy = (interop.sharded_pushsum_state_from_numpy
                      if self.cfg.model == "pushsum"
                      else interop.sharded_state_from_numpy)
        self.state = from_numpy(tree, self.mesh.n_shards, self.device)
        self._seeded = True
