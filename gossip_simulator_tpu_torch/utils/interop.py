"""Carry simulation state between the JAX package and the port.

The counterpart of carrying weights: ``JaxStepper.state_pytree()`` returns
the event engine's state as a dict of numpy arrays (the JAX package's leaf
names and dtypes, plus ``mail_geom`` and ``host_mailbox_dropped``).
``state_from_numpy`` turns such a dict into the port's ``EventState`` on a
device; ``state_to_numpy`` turns one back, with the same names, dtypes and
``mail_geom``, so a state can cross in either direction and continue.
The multi-rumor leaves cross at either shape; the uint32 rumor words
cross as the port's int32 view of the same bits (``rumor_words`` gains
or loses the port's trash row at n).
The friends table crosses at its own width: max_degree columns on kout,
ring and the overlay, ``config.er_cap(lam)`` columns ``-1``-padded past
each row's degree on erdos.

The ring engine's ``SimState`` crosses the same way through
``sim_state_from_numpy`` and ``sim_state_to_numpy``: bool masks, the
uint32 ``[hi, lo]`` total (one int64 in the port) and the uint32 rumor
words (int64 lanes in the port).

PushSum's ``PushSumState`` crosses through ``pushsum_state_from_numpy``
and ``pushsum_state_to_numpy``: the event engine's ring leaves plus the
mass columns, the wide mass ring and the convergence scalars, with the
ring geometry in ``mail_geom``.

The sharded backend's state, a list of per-shard states, crosses as the
JAX package's global sharded leaves (``ShardedStepper.state_pytree()``
there) through ``sharded_state_from_numpy``/``sharded_state_to_numpy``
and the PushSum pair: node-axis leaves and rings concatenated shard by
shard (the crash clock and the rumor words too where they are full
size, replicated where they are 1-element placeholders),
``mail_cnt``/``sup_cnt`` as ``(S, dw)`` and ``exch_counts`` as
``(S, S + 2)`` under spatial panels (``(S, 1)`` otherwise), replicated
scalars once, and ``mail_geom`` = (slot_cap, drain_chunk, S) of one
shard.

Phase 1 likewise: ``JaxStepper.overlay_state_pytree()`` returns the
phase-1 engine's leaves (all int32): the tick-faithful overlay's
``OverlayTickState`` or the rounds overlay's ``OverlayState``;
``overlay_state_from_numpy`` and ``overlay_state_to_numpy`` convert
either, telling them apart by their leaves.
"""

from __future__ import annotations

import numpy as np
import torch

from gossip_simulator_tpu_torch.models.event import EventState
from gossip_simulator_tpu_torch.models.overlay_ticks import OverlayTickState
from gossip_simulator_tpu_torch.models.pushsum import PushSumState
from gossip_simulator_tpu_torch.models.state import (OverlayState, SimState,
                                                     msg64_pair, msg64_value)

# Scalar leaves the JAX package keeps as int32[] (the port: int64[]).
_COUNTERS = ("total_received", "total_crashed", "mail_dropped",
             "exchange_overflow", "scen_crashed", "scen_recovered",
             "part_dropped", "heal_repaired")
# Array leaves with one dtype on both sides.  Some cross at either
# shape: the exchange counters exch_counts ((1, S + 2) a shard under
# spatial panels, (1, 1) otherwise), the crash clock down_since (int32[n]
# under Config.faults_enabled, int32[1] otherwise) and the multi-rumor
# leaves (full size under Config.multi_rumor, 1-element placeholders
# otherwise).
_ARRAYS = {"friends": np.int32, "friend_cnt": np.int32,
           "mail_ids": np.int32, "mail_cnt": np.int32, "sup_cnt": np.int32,
           "down_since": np.int32, "rumor_recv": np.int32,
           "rumor_done": np.int32, "exch_counts": np.int32}


def state_from_numpy(tree: dict, device) -> EventState:
    """The port's EventState from a JAX-package state dict."""
    if "mail_geom" not in tree:
        raise ValueError("state tree has no mail_geom: cannot tell the "
                         "ring's slot capacity")
    dev = torch.device(device)

    def arr(name):
        a = np.ascontiguousarray(np.asarray(tree[name], _ARRAYS[name]))
        return torch.from_numpy(a.copy()).to(dev)

    def words(name):
        a = np.ascontiguousarray(np.asarray(tree[name], np.uint32))
        return torch.from_numpy(a.view(np.int32).copy()).to(dev)

    flags = np.asarray(tree["flags"], np.uint8)
    geom = np.asarray(tree["mail_geom"], np.int64)
    rumor_words = words("rumor_words")
    if rumor_words.shape[0] == flags.shape[0]:  # full size: the trash row
        rumor_words = torch.cat([rumor_words, torch.zeros_like(
            rumor_words[:1])])
    return EventState(
        flags=torch.from_numpy(np.append(flags, np.uint8(0))).to(dev),
        tick=int(np.asarray(tree["tick"])),
        total_message=torch.tensor(msg64_value(tree["total_message"]),
                                   dtype=torch.int64, device=dev),
        geom=(int(geom[0]), int(geom[1])),
        mail_words=words("mail_words"), rumor_words=rumor_words,
        **{k: arr(k) for k in _ARRAYS},
        **{k: torch.tensor(int(np.asarray(tree[k])), dtype=torch.int64,
                           device=dev) for k in _COUNTERS})


def state_to_numpy(st: EventState) -> dict:
    """A JAX-package state dict (names, dtypes, mail_geom) from the
    port's EventState."""
    n = st.friends.shape[0]
    tree = {"flags": st.flags[:n].cpu().numpy().copy()}
    for k, dt in _ARRAYS.items():
        tree[k] = getattr(st, k).cpu().numpy().astype(dt, copy=True)
    rumor_words = st.rumor_words
    if rumor_words.shape[0] == n + 1:
        rumor_words = rumor_words[:n]
    for k, t in (("mail_words", st.mail_words),
                 ("rumor_words", rumor_words)):
        tree[k] = t.cpu().numpy().view(np.uint32).copy()
    tree["tick"] = np.asarray(st.tick, np.int32)
    tree["total_message"] = msg64_pair(int(st.total_message))
    for k in _COUNTERS:
        tree[k] = np.asarray(int(getattr(st, k)), np.int32)
    tree["mail_geom"] = np.asarray(st.geom, np.int64)
    return tree


# SimState: leaves by dtype (the counters as in EventState).
_SIM_BOOL = ("received", "crashed", "removed", "rebroadcast")
_SIM_I32 = ("friends", "friend_cnt", "pending", "down_since",
            "pending_rumors", "rumor_recv", "rumor_done", "exch_counts")
_SIM_COUNTERS = ("total_received", "total_crashed", "exchange_overflow",
                 "scen_crashed", "scen_recovered", "part_dropped",
                 "heal_repaired")


def sim_state_from_numpy(tree: dict, device) -> SimState:
    """The port's SimState from a JAX-package ring-engine state dict."""
    dev = torch.device(device)

    def t(name, dtype):
        return torch.from_numpy(np.array(tree[name], dtype)).to(dev)

    return SimState(
        tick=int(np.asarray(tree["tick"])),
        total_message=torch.tensor(msg64_value(tree["total_message"]),
                                   dtype=torch.int64, device=dev),
        rumor_words=t("rumor_words", np.int64),
        **{k: t(k, np.bool_) for k in _SIM_BOOL},
        **{k: t(k, np.int32) for k in _SIM_I32},
        **{k: torch.tensor(int(np.asarray(tree[k])), dtype=torch.int64,
                           device=dev) for k in _SIM_COUNTERS})


def sim_state_to_numpy(st: SimState) -> dict:
    """A JAX-package ring-engine state dict (names, dtypes) from the
    port's SimState."""
    tree = {k: getattr(st, k).cpu().numpy().astype(np.bool_, copy=True)
            for k in _SIM_BOOL}
    for k in _SIM_I32:
        tree[k] = getattr(st, k).cpu().numpy().astype(np.int32, copy=True)
    tree["rumor_words"] = st.rumor_words.cpu().numpy().astype(np.uint32)
    tree["tick"] = np.asarray(st.tick, np.int32)
    tree["total_message"] = msg64_pair(int(st.total_message))
    for k in _SIM_COUNTERS:
        tree[k] = np.asarray(int(getattr(st, k)), np.int32)
    return tree


# PushSumState: array leaves by dtype, int32[] counters in the JAX package
# (int64[] in the port, but mail_dropped, the ring append's int32).
_PS_ARRAYS = {"flags": np.uint8, "friends": np.int32,
              "friend_cnt": np.int32, "mass": np.int32,
              "mail_ids": np.int32, "mail_mass": np.int32,
              "mail_cnt": np.int32, "sup_cnt": np.int32,
              "down_since": np.int32, "exch_counts": np.int32}
_PS_COUNTERS = ("total_received", "total_crashed", "exchange_overflow",
                "scen_crashed", "scen_recovered", "part_dropped",
                "heal_repaired", "relerr_ppb", "eps_tick")


def pushsum_state_from_numpy(tree: dict, device) -> PushSumState:
    """The port's PushSumState from a JAX-package PushSum state dict."""
    if "mail_geom" not in tree:
        raise ValueError("state tree has no mail_geom: cannot tell the "
                         "ring's slot capacity")
    dev = torch.device(device)

    def arr(name):
        return torch.from_numpy(np.array(tree[name], _PS_ARRAYS[name])).to(
            dev)

    geom = np.asarray(tree["mail_geom"], np.int64)
    return PushSumState(
        tick=int(np.asarray(tree["tick"])),
        total_message=torch.tensor(msg64_value(tree["total_message"]),
                                   dtype=torch.int64, device=dev),
        mail_dropped=torch.tensor(int(np.asarray(tree["mail_dropped"])),
                                  dtype=torch.int32, device=dev),
        geom=(int(geom[0]), int(geom[1])),
        **{k: arr(k) for k in _PS_ARRAYS},
        **{k: torch.tensor(int(np.asarray(tree[k])), dtype=torch.int64,
                           device=dev) for k in _PS_COUNTERS})


def pushsum_state_to_numpy(st: PushSumState) -> dict:
    """A JAX-package PushSum state dict (names, dtypes, mail_geom) from
    the port's PushSumState."""
    tree = {k: getattr(st, k).cpu().numpy().astype(dt, copy=True)
            for k, dt in _PS_ARRAYS.items()}
    tree["tick"] = np.asarray(st.tick, np.int32)
    tree["total_message"] = msg64_pair(int(st.total_message))
    for k in _PS_COUNTERS + ("mail_dropped",):
        tree[k] = np.asarray(int(getattr(st, k)), np.int32)
    tree["mail_geom"] = np.asarray(st.geom, np.int64)
    return tree


# OverlayTickState / OverlayState: array leaves and int32[] counters (the
# clock, tick or round, is a host int in the port).
_OVERLAY_COUNTERS = ("makeups", "breakups", "win_makeups", "win_breakups",
                     "mailbox_dropped")
_TICKS_ARRAYS = ("friends", "friend_cnt", "ring_dst", "ring_pay", "ring_cnt",
                 "spill")
_ROUNDS_ARRAYS = ("friends", "friend_cnt", "mk_dst", "bk_dst", "boot_dst",
                  "mk_spill", "bk_spill")


def overlay_state_from_numpy(tree: dict, device):
    """The port's OverlayTickState (a tree with ``tick``: the tick-faithful
    engine's node-major band) or OverlayState (a tree with ``round``: the
    rounds engine) from a JAX-package phase-1 state dict."""
    dev = torch.device(device)

    def t(name):
        # np.array copies and keeps 0-d counters 0-d (ascontiguousarray
        # would make them 1-d).
        return torch.from_numpy(np.array(tree[name], np.int32)).to(dev)

    if "round" in tree:
        return OverlayState(
            round=int(np.asarray(tree["round"])),
            **{k: t(k) for k in _ROUNDS_ARRAYS + _OVERLAY_COUNTERS})
    spill = np.asarray(tree["spill"])
    if spill.shape != (2, 1):
        raise ValueError(
            f"leaf spill has shape {spill.shape}: the spilling slot-major "
            "band is not yet ported (ROADMAP A17)")
    return OverlayTickState(
        tick=int(np.asarray(tree["tick"])),
        **{k: t(k) for k in _TICKS_ARRAYS + _OVERLAY_COUNTERS})


def overlay_state_to_numpy(st) -> dict:
    """A JAX-package phase-1 state dict (names, int32 dtypes) from the
    port's OverlayTickState or OverlayState."""
    rounds = isinstance(st, OverlayState)
    arrays = _ROUNDS_ARRAYS if rounds else _TICKS_ARRAYS
    tree = {k: getattr(st, k).cpu().numpy().astype(np.int32, copy=True)
            for k in arrays + _OVERLAY_COUNTERS}
    clock = "round" if rounds else "tick"
    tree[clock] = np.asarray(getattr(st, clock), np.int32)
    return tree


# Sharded leaves: split into S equal row blocks, or one row per shard;
# every other leaf is replicated.
_SHARD_BLOCKS = ("flags", "friends", "friend_cnt", "mass", "mail_ids",
                 "mail_mass")
_SHARD_ROWS = ("mail_cnt", "sup_cnt", "exch_counts")
# Leaves split into row blocks at full size, and replicated as the JAX
# package's 1-element placeholders: the crash clock (full under
# Config.faults_enabled) and the rumor words (full under
# Config.multi_rumor), each with the leaf whose rows it matches.
_SHARD_IF_FULL = {"down_since": "flags", "rumor_words": "flags",
                  "mail_words": "mail_ids"}


def _blocked(tree: dict, k: str) -> bool:
    """Whether leaf k of a (global or one shard's) tree is split by rows."""
    if k in _SHARD_BLOCKS:
        return True
    like = _SHARD_IF_FULL.get(k)
    return like is not None and (np.shape(tree[k])[0]
                                 == np.shape(tree[like])[0])


def _split_shards(tree: dict, n_shards: int) -> list[dict]:
    geom = np.asarray(tree["mail_geom"], np.int64)
    if geom.shape != (3,) or int(geom[2]) != n_shards:
        raise ValueError(f"mail_geom {geom.tolist()} is not a sharded "
                         f"state of {n_shards} shards")
    trees = []
    for i in range(n_shards):
        t = {"mail_geom": geom[:2]}
        for k, v in tree.items():
            a = np.asarray(v)
            if _blocked(tree, k):
                rows = a.shape[0] // n_shards
                t[k] = a[i * rows:(i + 1) * rows]
            elif k in _SHARD_ROWS:
                t[k] = a[i:i + 1]
            elif k != "mail_geom":
                t[k] = a
        trees.append(t)
    return trees


def _join_shards(trees: list[dict]) -> dict:
    tree = dict(trees[0])
    for k in trees[0]:
        if _blocked(trees[0], k) or k in _SHARD_ROWS:
            tree[k] = np.concatenate([t[k] for t in trees])
    tree["mail_geom"] = np.append(trees[0]["mail_geom"],
                                  np.int64(len(trees)))
    return tree


def sharded_state_from_numpy(tree: dict, n_shards: int, device) -> list:
    """The port's per-shard EventStates from a JAX-package sharded state
    dict of `n_shards` shards."""
    return [state_from_numpy(t, device) for t in _split_shards(tree,
                                                               n_shards)]


def sharded_state_to_numpy(states: list) -> dict:
    """A JAX-package sharded state dict from the port's per-shard
    EventStates."""
    return _join_shards([state_to_numpy(st) for st in states])


def sharded_pushsum_state_from_numpy(tree: dict, n_shards: int,
                                     device) -> list:
    """The port's per-shard PushSumStates from a JAX-package sharded
    PushSum state dict of `n_shards` shards."""
    return [pushsum_state_from_numpy(t, device)
            for t in _split_shards(tree, n_shards)]


def sharded_pushsum_state_to_numpy(states: list) -> dict:
    """A JAX-package sharded PushSum state dict from the port's per-shard
    PushSumStates."""
    return _join_shards([pushsum_state_to_numpy(st) for st in states])


# The sharded ring engine's SimState: node leaves split into row blocks,
# the delay rings (d, n) and the SIR schedule into column blocks; the
# crash clock and rumor words where they are full size (else replicated
# placeholders, as the rumor leaves always are at S > 1).
_SIM_NODE = ("received", "crashed", "removed", "friends", "friend_cnt")
_SIM_COLS = ("pending", "rebroadcast")


def _split_sim(tree: dict, n_shards: int) -> list[dict]:
    n = int(np.shape(tree["received"])[0])
    nl = n // n_shards
    trees = []
    for i in range(n_shards):
        t = {}
        for k, v in tree.items():
            a = np.asarray(v)
            if k in _SIM_NODE or (k in ("down_since", "rumor_words")
                                  and a.shape[0] == n):
                t[k] = a[i * nl:(i + 1) * nl]
            elif k in _SIM_COLS:
                t[k] = a[:, i * nl:(i + 1) * nl]
            elif k == "exch_counts":
                t[k] = a[i:i + 1]
            else:
                t[k] = a
        trees.append(t)
    return trees


def _join_sim(trees: list[dict]) -> dict:
    tree = dict(trees[0])
    nl = int(np.shape(trees[0]["received"])[0])
    for k in trees[0]:
        a = np.asarray(trees[0][k])
        if k in _SIM_NODE or k == "exch_counts" or (
                k in ("down_since", "rumor_words") and a.shape[0] == nl):
            tree[k] = np.concatenate([t[k] for t in trees])
        elif k in _SIM_COLS:
            tree[k] = np.concatenate([t[k] for t in trees], axis=1)
    return tree


def sharded_sim_state_from_numpy(tree: dict, n_shards: int, device) -> list:
    """The port's per-shard SimStates from a ring-engine state dict (the
    JAX package's global sharded leaves, or a one-device state: the ring
    engine's layout does not depend on S)."""
    return [sim_state_from_numpy(t, device)
            for t in _split_sim(tree, n_shards)]


def sharded_sim_state_to_numpy(states: list) -> dict:
    """A JAX-package sharded ring-engine state dict from the port's
    per-shard SimStates."""
    return _join_sim([sim_state_to_numpy(st) for st in states])


# The sharded overlays: row blocks (the rounds overlay's emission rows
# (cap, n) in column blocks), the tick-faithful overlay's packed rings
# as S rings side by side with ring_cnt (S, dw), every other leaf (the
# counters, the spill buffers) replicated.
_OV_ROWS = ("friends", "friend_cnt", "boot_dst", "ring_dst", "ring_pay",
            "ring_cnt")
_OV_COLS = ("mk_dst", "bk_dst")


def sharded_overlay_state_from_numpy(tree: dict, n_shards: int,
                                     device) -> list:
    """The port's per-shard overlay states from a JAX-package sharded
    phase-1 dict of `n_shards` shards."""
    trees = []
    for i in range(n_shards):
        t = {}
        for k, v in tree.items():
            a = np.asarray(v)
            if k in _OV_ROWS:
                rows = a.shape[0] // n_shards
                t[k] = a[i * rows:(i + 1) * rows]
            elif k in _OV_COLS:
                cols = a.shape[1] // n_shards
                t[k] = a[:, i * cols:(i + 1) * cols]
            else:
                t[k] = a
        trees.append(t)
    return [overlay_state_from_numpy(t, device) for t in trees]


def sharded_overlay_state_to_numpy(states: list) -> dict:
    """A JAX-package sharded phase-1 dict from the port's per-shard
    overlay states."""
    trees = [overlay_state_to_numpy(st) for st in states]
    tree = dict(trees[0])
    for k in tree:
        if k in _OV_ROWS:
            tree[k] = np.concatenate([t[k] for t in trees])
        elif k in _OV_COLS:
            tree[k] = np.concatenate([t[k] for t in trees], axis=1)
    return tree
