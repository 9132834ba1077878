"""The ring engine: one array program per simulated tick (or round).

The port of the JAX package's ``models/epidemic.py`` (the sharded
backend runs the same physics a shard at a time and routes each wave,
``parallel/sharded_step.py``):

    drain ring slot -> count deliveries -> crash draw -> infect
    (idempotent) -> gather friends of the new senders -> drop mask ->
    scatter-add future arrivals into the delay ring.

Messages sit in a ``pending[d, n]`` ring of arrival COUNTS, so duplicate
deliveries are counted like the reference's TotalMessage while infection
stays an idempotent OR.  In ticks mode one tick is one simulated ms and
every broadcast draws one shared delay in [delaylow, delayhigh); in
rounds mode (``-time-mode rounds``, and push-pull) every hop takes one
round (ring depth 2).  SIR adds a re-broadcast schedule; ``-rumors R``
(SI, ticks) adds per-rumor arrival counts ``pending_rumors[d, n, R]`` and
a packed rumor-word ladder.  ``-protocol pushpull`` runs the synchronous
anti-entropy round instead of the tick.

Random draws reproduce the JAX package's streams bit for bit
(``utils/rng.py``); every draw of a row is keyed by (tick, op, row), so
the compacted deposit (only the senders' rows) and the dense one (all
rows) draw the same values.  The one float in the trajectory, the crash
probability ``1 - (1 - p)^c`` of a node that receives c messages in a
tick, comes from a table computed once per run on the host (``crash_table``)
so the card and the CPU give the same bits: the C library's float32
``powf``, the call XLA's CPU code makes for the JAX package's float32
``power``, so every entry equals the reference's.

Where the JAX package threads the state through donated jitted functions,
the port updates it in place; the JAX package's ``fori_loop`` over a
data-dependent count of sender chunks is a Python loop over the senders'
row ids, read to the host once per tick.  The deposits go through
``ops/deliver.py`` (``fused_deposit_add``, ``fused_deposit_rows``) and
``ops/megakernel.py`` (``fused_deposit_both``) under the kernel gates.
Fault scenarios (``scenario.py``) apply at each tick's start
(``apply_fault_window``: crash, churn and recovery on ``crashed``, the
crash clock in ``down_since``), the partition mask drops the wave's
edges at their send tick (``part_dropped``), and with ``-overlay-heal
on`` a healing pass (``make_heal_fn``) deposits the re-sends and rejoin
pulls after each window.  ``make_run_to_coverage_fn`` is the
run-to-target loop (poll windows, tested before each).
"""

from __future__ import annotations

import ctypes
import ctypes.util
import math

import numpy as np
import torch

from gossip_simulator_tpu_torch import scenario as _scen
from gossip_simulator_tpu_torch.config import Config
from gossip_simulator_tpu_torch.models.state import (SimState, in_flight,
                                                     init_exch_counts)
from gossip_simulator_tpu_torch.ops import deliver, megakernel
from gossip_simulator_tpu_torch.utils import rng as _rng

I32 = torch.int32
I64 = torch.int64
# Reserved "tick" for the one-off seed draws (fold_in takes a uint32).
SEED_TICK = 0x7FFFFFFF
# Longest crash-probability table.  A node's arrivals in one tick or round
# number at most the peers that send to it (its in-degree, or the peers
# that drew it in a push-pull round), far below this; a count past the
# table's end takes its last entry, exactly 1.0f at crash rates above
# ~1.7e-5.
CRASH_TABLE_MAX = 1 << 20


def p_eff(cfg, p: float) -> float:
    """Reference's 1%-resolution truncation under compat
    (simulator.go:172,180)."""
    return int(p * 100) / 100.0 if cfg.compat_reference else p


def ring_depth(cfg: Config) -> int:
    """Delay ring slots: delays are clamped to [1, delayhigh), so
    `delayhigh` slots suffice; rounds mode needs only {this, next}."""
    return cfg.delayhigh if cfg.effective_time_mode == "ticks" else 2


def _libm_powf():
    """The C library's float32 ``powf``, typed for ctypes."""
    fn = ctypes.CDLL(ctypes.util.find_library("m")).powf
    fn.argtypes = [ctypes.c_float, ctypes.c_float]
    fn.restype = ctypes.c_float
    return fn


def crash_table(crash_p: float) -> np.ndarray:
    """float32 ``pc[c] = 1 - (1 - p)^c`` for c = 0, 1, ..., ending at the
    first count where it reaches 1.0f (or at CRASH_TABLE_MAX).  The JAX
    package computes ``1.0 - jnp.power(1.0 - p, c)`` in float32, and XLA's
    CPU code lowers that ``power`` to a call of the C library's ``powf``
    (its LLVM IR holds ``llvm.pow.f32``, its object file an undefined
    ``powf``); torch's and numpy's float32 powers differ from it at some
    counts.  So the table calls the same ``powf`` on the float32 base and
    each count as float32, then subtracts in float32; computed once on the
    host, it gives the CPU and the card the same bits."""
    powf = _libm_powf()
    base = float(np.float32(1.0 - crash_p))
    parts = []
    for lo in range(0, CRASH_TABLE_MAX, 4096):
        pw = [powf(base, float(c)) for c in range(lo, lo + 4096)]
        parts.append(np.float32(1.0) - np.asarray(pw, dtype=np.float32))
        one = np.flatnonzero(parts[-1] == np.float32(1.0))
        if one.size:
            parts[-1] = parts[-1][:one[0] + 1]
            break
    return np.concatenate(parts)


class CrashDraw:
    """The reception-crash probability of every node from its count of
    arrivals this tick, through ``crash_table`` (moved to the run's
    device on first use); counts past the table take its last entry."""

    def __init__(self, crash_p: float):
        self.crash_p = crash_p
        self._table = crash_table(crash_p) if crash_p > 0.0 else None
        self._dev = {}

    def pc(self, counted: torch.Tensor) -> torch.Tensor:
        dev = counted.device
        t = self._dev.get(dev)
        if t is None:
            t = self._dev[dev] = torch.from_numpy(self._table).to(dev)
        return t[torch.clamp(counted, 0, t.shape[0] - 1).long()]

    def draw(self, key: torch.Tensor, counted: torch.Tensor,
             u: torch.Tensor | None = None) -> torch.Tensor:
        """Nodes that crash: uniform < pc, among those that received (`u`:
        the uniform draw of `key`, when it was made beforehand)."""
        if u is None:
            u = _rng.uniform(key, (counted.shape[0],))
        return (u < self.pc(counted)) & (counted > 0)


def init_rumor_leaves(cfg: Config, n: int, device=None):
    """(pending_rumors, rumor_words, rumor_recv, rumor_done): full size
    under Config.multi_rumor, 1-element placeholders otherwise.  The rumor
    words are uint32 bit patterns in int64 lanes."""
    if not cfg.multi_rumor:
        return (torch.zeros((1, 1, 1), dtype=I32, device=device),
                torch.zeros((1, 1), dtype=I64, device=device),
                torch.zeros((1,), dtype=I32, device=device),
                torch.full((1,), -1, dtype=I32, device=device))
    w = cfg.rumor_word_count
    return (torch.zeros((ring_depth(cfg), n, cfg.rumors), dtype=I32,
                        device=device),
            torch.zeros((n, w), dtype=I64, device=device),
            torch.zeros((w * 32,), dtype=I32, device=device),
            torch.full((w * 32,), -1, dtype=I32, device=device))


def unpack_rumor_bits(words: torch.Tensor, r: int) -> torch.Tensor:
    """(n, W) word ladder -> bool (n, r) per-rumor bits."""
    n, w = words.shape
    shifts = torch.arange(32, dtype=words.dtype, device=words.device)
    bits = ((words[:, :, None] >> shifts) & 1).to(torch.bool)
    return bits.reshape(n, w * 32)[:, :r]


def pack_rumor_bits(bits: torch.Tensor, w: int) -> torch.Tensor:
    """bool (n, r) per-rumor bits -> (n, W) word ladder (int64 lanes)."""
    n, r = bits.shape
    padded = torch.zeros((n, w * 32), dtype=I64, device=bits.device)
    padded[:, :r] = bits.to(I64)
    shifts = torch.arange(32, dtype=I64, device=bits.device)
    return (padded.reshape(n, w, 32) << shifts).sum(dim=2)


def init_state(cfg: Config, friends: torch.Tensor,
               friend_cnt: torch.Tensor, n_shards: int = 1) -> SimState:
    """The state of `friends`' rows: the whole node axis, or one shard's
    row block (the crash clock covers its rows; ``exch_counts`` is laid
    out for `n_shards` shards)."""
    n = friends.shape[0]
    dev = friends.device
    d = ring_depth(cfg)
    d_rb = d if cfg.protocol == "sir" else 1

    def z():
        return torch.zeros((), dtype=I64, device=dev)

    pending_rumors, rumor_words, rumor_recv, rumor_done = init_rumor_leaves(
        cfg, n, dev)
    return SimState(
        received=torch.zeros((n,), dtype=torch.bool, device=dev),
        crashed=torch.zeros((n,), dtype=torch.bool, device=dev),
        removed=torch.zeros((n,), dtype=torch.bool, device=dev),
        friends=friends, friend_cnt=friend_cnt,
        pending=torch.zeros((d, n), dtype=I32, device=dev),
        rebroadcast=torch.zeros((d_rb, n), dtype=torch.bool, device=dev),
        tick=0, total_message=z(), total_received=z(), total_crashed=z(),
        exchange_overflow=z(),
        down_since=_scen.init_down_since(cfg.faults_enabled, n, dev),
        scen_crashed=z(), scen_recovered=z(), part_dropped=z(),
        heal_repaired=z(), pending_rumors=pending_rumors,
        rumor_words=rumor_words, rumor_recv=rumor_recv,
        rumor_done=rumor_done,
        exch_counts=init_exch_counts(cfg, n_shards, dev))


def row_slot(cfg: Config, delay_key, tick: int,
             rows: torch.Tensor) -> torch.Tensor:
    """Delay-ring slot of each row's broadcast this tick: row r's shared
    per-broadcast delay depends only on (delay_key, r)."""
    d = ring_depth(cfg)
    if cfg.effective_time_mode == "rounds":
        return torch.full(rows.shape, (tick + 1) % d, dtype=I32,
                          device=rows.device)
    delay = _rng.row_uniform_delay(delay_key, cfg.delaylow, cfg.delayhigh,
                                   rows)
    return ((tick + delay) % d).to(I32)


def tick_keys(base_key: torch.Tensor, tick: int,
              shard: int | None = None) -> dict:
    """Per-tick op keys; `shard` folds the shard index in first (the
    sharded backend's decorrelated per-shard streams)."""
    if shard is not None:
        base_key = _rng.fold_in(base_key, shard)
    return {"crash": _rng.tick_key(base_key, tick, _rng.OP_CRASH),
            "delay": _rng.tick_key(base_key, tick, _rng.OP_DELAY),
            "drop": _rng.tick_key(base_key, tick, _rng.OP_DROP),
            "remove": _rng.tick_key(base_key, tick, _rng.OP_REMOVE)}


def tick_core(cfg: Config, st: SimState, keys: dict, crash: CrashDraw,
              drawn: dict | None = None):
    """The node-local physics of one tick, in place: drain the ring slot,
    count, crash draw, infect, SIR removal and re-broadcast scheduling,
    the multi-rumor bits, the totals, tick + 1.  Returns ``(senders,
    dslot, newbits)``: the rows broadcasting this tick, their ring slots
    (None on the compacted SI path, which draws slots per gathered row)
    and, under multi-rumor, each row's new rumor bits (else None).
    `drawn` holds draws of `keys` made beforehand (the sharded tick draws
    every shard's at once): "crash" (the uniform), "remove" (the SIR
    removal mask), "dslot" (the rows' ring slots)."""
    drawn = drawn or {}
    sir = cfg.protocol == "sir"
    multi = cfg.multi_rumor
    d = ring_depth(cfg)
    n = st.received.shape[0]
    dev = st.received.device
    ids = torch.arange(n, dtype=I32, device=dev)

    slot = st.tick % d
    counted = torch.where(st.crashed, 0, st.pending[slot])  # black holes
    st.pending[slot] = 0
    st.total_message += counted.sum(dtype=I64)
    has = counted > 0
    if crash.crash_p > 0.0:
        new_crash = crash.draw(keys["crash"], counted, drawn.get("crash"))
        st.crashed |= new_crash
        st.total_crashed += new_crash.sum(dtype=I64)
        if cfg.faults_enabled:
            # Reception crashes stamp the crash clock too: every crash is
            # subject to the reboot timeline and the healer's detection.
            st.down_since = torch.where(new_crash, torch.tensor(
                st.tick, dtype=I32, device=dev), st.down_since)
    newly = has & ~st.crashed & ~st.received
    st.received |= newly
    st.total_received += newly.sum(dtype=I64)

    newbits = None
    if multi:
        arr_r = st.pending_rumors[slot]  # (n, R) per-rumor arrival counts
        rbits = unpack_rumor_bits(st.rumor_words, cfg.rumors)
        newbits = (arr_r > 0) & ~st.crashed[:, None] & ~rbits
        st.pending_rumors[slot] = 0
        st.rumor_words |= pack_rumor_bits(newbits, cfg.rumor_word_count)
        st.rumor_recv[:cfg.rumors] += newbits.sum(dim=0, dtype=I32)

    # Dense per-row slots only where something consumes them for all n
    # rows (SIR's schedule, the dense deposit, the multi-rumor deposit).
    dslot = drawn.get("dslot")
    if dslot is None and (sir or multi or not cfg.compact_resolved):
        dslot = row_slot(cfg, keys["delay"], st.tick, ids)

    if sir:
        due = st.rebroadcast[slot] & ~st.crashed & ~st.removed
        st.rebroadcast[slot] = False
        senders = newly | due
        removal = drawn.get("remove")
        if removal is None:
            removal = _rng.bernoulli_masked(
                keys["remove"], p_eff(cfg, cfg.removal_rate), (n,))
        removal = removal & senders
        st.removed |= removal
        cell = (dslot.long(), ids.long())
        st.rebroadcast[cell] = st.rebroadcast[cell] | (senders & ~removal)
    else:
        senders = newbits.any(dim=1) if multi else newly
    st.tick += 1
    return senders, dslot, newbits


def edges_from_senders(cfg: Config, friends, friend_cnt, senders, dslot,
                       drop_key, rows, tick: int, gid0: int = 0):
    """This tick's outgoing wave from the given rows as flat (dst, slot,
    valid) lanes, row-major (k lanes a row), and the count of edges the
    scenario's partition mask dropped at send tick `tick` (int64 0-d; 0
    without partitions).  `friends`, `friend_cnt`, `senders` and `dslot`
    are the rows' own; `rows` their (local) ids, which key the per-link
    drop draw, and `gid0 + rows` their global ids, which the partition
    mask reads (`gid0`: the global id of a shard's row 0)."""
    k = friends.shape[1]
    drop = _rng.row_bernoulli(drop_key, p_eff(cfg, cfg.droprate), rows, k)
    cols = torch.arange(k, dtype=I32, device=friends.device)
    edge = ((cols[None, :] < friend_cnt[:, None]) & senders[:, None]
            & ~drop & (friends >= 0))
    scen = cfg.scenario_resolved
    blk = torch.zeros((), dtype=I64, device=friends.device)
    if scen.has_partitions:
        blocked = _scen.partition_blocked(scen, cfg.n, tick,
                                          (gid0 + rows)[:, None],
                                          friends) & edge
        blk = blocked.sum(dtype=I64)
        edge = edge & ~blocked
    dst = torch.where(edge, friends, -1).reshape(-1)
    slots = dslot[:, None].expand(-1, k).reshape(-1)
    return dst, slots, edge.reshape(-1), blk


def compact_chunk_cap(cfg: Config, n_local: int) -> int:
    """Sender rows per compacted deposit chunk: -compact-chunk, else all
    rows in rounds mode and n/128 (at least 4096) in ticks mode."""
    if cfg.compact_chunk > 0:
        return min(n_local, cfg.compact_chunk)
    if cfg.effective_time_mode == "rounds":
        return n_local
    return min(n_local, max(4096, n_local // 128))


def row_batches(mask: torch.Tensor, cap: int) -> list:
    """The ascending row ids of `mask`'s True rows in batches of <= cap
    (one host read)."""
    idx = torch.nonzero(mask).flatten().to(I32)
    return [idx[lo:lo + cap] for lo in range(0, idx.shape[0], cap)]


def compact_gather(cfg: Config, friends, friend_cnt, dslot, delay_key,
                   drop_key, tick: int, idx: torch.Tensor, gid0: int = 0):
    """The edge lanes (dst, slot, valid) of the sender rows `idx`, with
    drop masks and delay slots drawn for just those rows (the same values
    as the dense path's draws for them; `gid0` as in
    edges_from_senders).  The JAX package pads each chunk to its cap with
    fill rows whose lanes are all invalid; they add nothing, so the port
    leaves them out."""
    slot = (dslot[idx.long()] if dslot is not None
            else row_slot(cfg, delay_key, tick, idx))
    ones = torch.ones(idx.shape, dtype=torch.bool, device=idx.device)
    return edges_from_senders(cfg, friends[idx.long()],
                              friend_cnt[idx.long()], ones, slot, drop_key,
                              idx, tick, gid0=gid0)


def deposit_local(pending, dst, slots, valid, kernel: str = "xla"):
    """Scatter-add one arrival per valid lane into the ring, in place:
    ``pallas`` is the fused_deposit_add kernel, which takes the mask itself
    (its plain version on the CPU), ``xla`` the unfused chain (the plain
    version's ops: invalid lanes moved to dst = n, out of range)."""
    if kernel == "pallas":
        return deliver.fused_deposit_add(pending, slots, dst, valid)
    d = torch.where(valid, dst, pending.shape[1])  # out of range: no add
    return deliver.deposit_add_plain(pending, slots, d)


def deposit_rumors(pending_rumors, dst, slots, valid, newbits,
                   kernel: str = "xla"):
    """Each valid lane adds its sender's new rumor bits (row i // k of
    `newbits`) at its (slot, dst) cell, in place: ``pallas`` is the
    fused_deposit_rows kernel, ``xla`` the unfused chain."""
    k = dst.shape[0] // newbits.shape[0]
    vals = newbits.to(I32).repeat_interleave(k, dim=0)
    d = torch.where(valid, dst, pending_rumors.shape[1])
    if kernel == "pallas":
        return deliver.fused_deposit_rows(pending_rumors, slots, d, vals)
    return deliver.deposit_rows_plain(pending_rumors, slots, d, vals)


def deposit_compact(cfg: Config, st: SimState, senders, dslot, delay_key,
                    drop_key, tick: int):
    """Compacted deposit: only the sender rows reach the draws, gathers
    and deposits, in chunks of compact_chunk_cap rows.  Returns the
    partition-blocked edge count (int64 0-d)."""
    cap = compact_chunk_cap(cfg, senders.shape[0])
    kern = cfg.deliver_kernel_resolved
    blk = torch.zeros((), dtype=I64, device=senders.device)
    for idx in row_batches(senders, cap):
        dst, slots, valid, b = compact_gather(
            cfg, st.friends, st.friend_cnt, dslot, delay_key, drop_key,
            tick, idx)
        deposit_local(st.pending, dst, slots, valid, kernel=kern)
        blk = blk + b
    return blk


def make_tick_fn(cfg: Config):
    """Single-device per-tick transition for SI / SIR push gossip, one
    rumor or R."""
    multi = cfg.multi_rumor
    dkern = cfg.deliver_kernel_resolved
    p2 = cfg.phase2_kernel_resolved if multi else "xla"
    target = int(math.ceil(cfg.coverage_target * cfg.n))
    crash = CrashDraw(p_eff(cfg, cfg.crashrate))

    scen = cfg.scenario_resolved

    def tick_fn(st: SimState, base_key: torch.Tensor) -> SimState:
        tick = st.tick
        dsc, dsr = apply_fault_window(
            cfg, st, torch.arange(st.received.shape[0], dtype=I32,
                                  device=st.received.device), base_key)
        keys = tick_keys(base_key, tick)
        senders, dslot, newbits = tick_core(cfg, st, keys, crash)
        if multi:
            # Always dense: the compacted gather carries no rumor payload.
            n = senders.shape[0]
            rows = torch.arange(n, dtype=I32, device=senders.device)
            dst, slots, valid, blk = edges_from_senders(
                cfg, st.friends, st.friend_cnt, senders, dslot, keys["drop"],
                rows, tick)
            if p2 == "pallas":
                megakernel.fused_deposit_both(st.pending, st.pending_rumors,
                                              dst, slots, valid, newbits)
            else:
                deposit_local(st.pending, dst, slots, valid, kernel=dkern)
                deposit_rumors(st.pending_rumors, dst, slots, valid,
                               newbits, kernel=dkern)
            hit = (st.rumor_recv >= target) & (st.rumor_done < 0)
            st.rumor_done = torch.where(hit, st.tick, st.rumor_done)
        elif cfg.compact_resolved:
            blk = deposit_compact(cfg, st, senders, dslot, keys["delay"],
                                  keys["drop"], tick)
        else:
            n = senders.shape[0]
            rows = torch.arange(n, dtype=I32, device=senders.device)
            dst, slots, valid, blk = edges_from_senders(
                cfg, st.friends, st.friend_cnt, senders, dslot, keys["drop"],
                rows, tick)
            deposit_local(st.pending, dst, slots, valid, kernel=dkern)
        if scen.active:
            st.scen_crashed += dsc
            st.scen_recovered += dsr
            st.part_dropped += blk
        return st

    return tick_fn


def make_seed_fn(cfg: Config):
    """The initial broadcast (simulator.go:240-241), keyed at SEED_TICK,
    through the unfused deposit (as in the JAX package: the seed never
    takes the kernel).  Unless compat_reference (SI), the seed itself is
    marked received.  Only the seed rows' draws and edges are computed:
    every other row's lanes are invalid in the JAX package's dense form.

    Multi-rumor (oneshot): all R sources draw from the OP_INJECT stream
    keyed by rumor index, their bits are set at once, and every source
    broadcasts in one deposit."""
    if cfg.multi_rumor:
        r_total, w = cfg.rumors, cfg.rumor_word_count

        def seed_multi(st: SimState, base_key: torch.Tensor) -> SimState:
            n = st.received.shape[0]
            dev = st.received.device
            rr = torch.arange(r_total, dtype=I64, device=dev)
            ik = _rng.fold_in(base_key, _rng.OP_INJECT)
            srcs = _rng.randint(_rng.fold_in(ik, rr), (), 0, n)
            words = torch.arange(w, dtype=I64, device=dev)
            masks = torch.where((rr[:, None] // 32) == words[None, :],
                                (1 << (rr % 32))[:, None], 0)
            # Distinct bits never collide: the sum of colliding source
            # rows is their OR.
            delta = torch.zeros((n, w), dtype=I64, device=dev)
            delta.index_add_(0, srcs.long(), masks)
            is_src = (delta != 0).any(dim=1)
            st.received |= is_src
            st.total_received += is_src.sum(dtype=I64)
            st.rumor_recv[:r_total] += 1
            rows = torch.nonzero(is_src).flatten().to(I32)
            kd = _rng.tick_key(base_key, SEED_TICK, _rng.OP_DELAY)
            kp = _rng.tick_key(base_key, SEED_TICK, _rng.OP_DROP)
            dslot = row_slot(cfg, kd, st.tick, rows)
            ones = torch.ones(rows.shape, dtype=torch.bool, device=dev)
            dst, slots, valid, blk = edges_from_senders(
                cfg, st.friends[rows.long()], st.friend_cnt[rows.long()],
                ones, dslot, kp, rows, st.tick)
            st.part_dropped += blk
            deposit_local(st.pending, dst, slots, valid)
            deposit_rumors(st.pending_rumors, dst, slots, valid,
                           unpack_rumor_bits(delta[rows.long()], r_total))
            st.rumor_words |= delta
            return st

        return seed_multi

    def seed_fn(st: SimState, base_key: torch.Tensor) -> SimState:
        n = st.received.shape[0]
        dev = st.received.device
        ks = _rng.tick_key(base_key, SEED_TICK, _rng.OP_SEED_NODE)
        kd = _rng.tick_key(base_key, SEED_TICK, _rng.OP_DELAY)
        kp = _rng.tick_key(base_key, SEED_TICK, _rng.OP_DROP)
        sender = int(_rng.randint(ks, (), 0, n))
        if cfg.protocol != "si" or not cfg.compat_reference:
            # The seed-never-received quirk is an SI compat surface only.
            st.received[sender] = True
            st.total_received += 1
        if cfg.protocol == "pushpull":
            return st
        rows = torch.tensor([sender], dtype=I32, device=dev)
        dslot = row_slot(cfg, kd, st.tick, rows)
        dst, slots, valid, blk = edges_from_senders(
            cfg, st.friends[sender:sender + 1],
            st.friend_cnt[sender:sender + 1],
            torch.ones((1,), dtype=torch.bool, device=dev), dslot, kp, rows,
            st.tick)
        st.part_dropped += blk
        deposit_local(st.pending, dst, slots, valid)
        if cfg.protocol == "sir":
            # The seed is a sender like any other: its removal draw
            # decides whether it keeps re-broadcasting.
            kr = _rng.tick_key(base_key, SEED_TICK, _rng.OP_REMOVE)
            keep = ~_rng.bernoulli_masked(kr, p_eff(cfg, cfg.removal_rate),
                                          ())
            cell = (dslot.long(), rows.long())
            st.rebroadcast[cell] = st.rebroadcast[cell] | keep
        return st

    return seed_fn


def packed_peer_state(received, crashed) -> torch.Tensor:
    """uint8[n]: 0 susceptible, 1 infected, 2/3 crashed -- one gather
    answers both "live?" (< 2) and "live and infected?" (== 1)."""
    return received.to(torch.uint8) + crashed.to(torch.uint8) * 2


def pushpull_chunk_cap(cfg: Config, n_local: int) -> int:
    """Rows per gathered batch of the push-pull round: -compact-chunk,
    else n/8 (at least 4096)."""
    if cfg.compact_chunk > 0:
        return min(n_local, cfg.compact_chunk)
    return min(n_local, max(4096, n_local // 8))


def make_pushpull_fn(cfg: Config):
    """One synchronous push-pull anti-entropy round over uniform random
    peers (BASELINE.json config 3).  Push receptions are counted and can
    crash the receiver; pull responses from live peers are counted;
    infection crosses any surviving contact.  Peer and drop draws are
    row-keyed, so the compacted round (push over the infected live rows,
    pull over the susceptible ones, in batches) draws exactly the dense
    round's values.  The compaction gate is ``-compact`` not off, as in
    the JAX package (not Config.compact_resolved)."""
    drop_p = p_eff(cfg, cfg.droprate)
    crash = CrashDraw(p_eff(cfg, cfg.crashrate))
    f = cfg.fanout
    compact = cfg.compact != "off"

    def batches(mask):
        """(row ids, their mask) batches: the mask's rows when compacting,
        else every row at once."""
        n = mask.shape[0]
        if compact:
            return [(idx, None)
                    for idx in row_batches(mask, pushpull_chunk_cap(cfg, n))]
        return [(torch.arange(n, dtype=I32, device=mask.device), mask)]

    def round_fn(st: SimState, base_key: torch.Tensor) -> SimState:
        n = st.received.shape[0]
        dev = st.received.device
        k1 = _rng.tick_key(base_key, st.tick, _rng.OP_BOOTSTRAP)
        k2 = _rng.tick_key(base_key, st.tick, _rng.OP_PULL)
        kd1 = _rng.tick_key(base_key, st.tick, _rng.OP_DROP)
        kd2 = _rng.tick_key(base_key, st.tick, _rng.OP_DELAY)
        kc = _rng.tick_key(base_key, st.tick, _rng.OP_CRASH)

        live = ~st.crashed
        inf = st.received & live
        sus = ~st.received & live
        packed = packed_peer_state(st.received, st.crashed)

        # Push: infected -> f random peers; index n is the trash cell.
        arriving = torch.zeros((n + 1,), dtype=I32, device=dev)
        for rows, mask in batches(inf):
            peers = _rng.row_randint(k1, n, rows, f)
            edge = ~_rng.row_bernoulli(kd1, drop_p, rows, f)
            if mask is not None:
                edge &= mask[:, None]
            dst = torch.where(edge, peers, n).reshape(-1)
            arriving.index_add_(0, dst, torch.ones_like(dst))
        counted = torch.where(live, arriving[:n], 0)
        st.total_message += counted.sum(dtype=I64)
        new_crash = torch.zeros_like(live)
        if crash.crash_p > 0.0:
            new_crash = crash.draw(kc, counted)
        crashed = st.crashed | new_crash
        st.total_crashed += new_crash.sum(dtype=I64)
        newly_push = (counted > 0) & ~crashed & ~st.received

        # Pull: surviving susceptible <- f random peers' pre-round state.
        # A requester crashed by this round's push does not pull.
        pull_hit = torch.zeros((n,), dtype=torch.bool, device=dev)
        msgs = torch.zeros((), dtype=I64, device=dev)
        for rows, mask in batches(sus & ~new_crash):
            peers = _rng.row_randint(k2, n, rows, f)
            req = ~_rng.row_bernoulli(kd2, drop_p, rows, f)
            if mask is not None:
                req &= mask[:, None]
            pstate = packed[peers.long()]
            pull_hit[rows.long()] = (req & (pstate == 1)).any(dim=1)
            msgs += (req & (pstate < 2)).sum(dtype=I64)
        st.total_message += msgs

        newly = (newly_push | pull_hit) & ~crashed & ~st.received
        st.received |= newly
        st.crashed = crashed
        st.total_received += newly.sum(dtype=I64)
        st.tick += 1
        return st

    return round_fn


def make_step_fn(cfg: Config):
    if cfg.protocol == "pushpull":
        return make_pushpull_fn(cfg)
    return make_tick_fn(cfg)


def apply_fault_window(cfg: Config, st: SimState, ids_global, base_key,
                       nticks: int = 1):
    """The scenario's crash, churn and recovery over the window [st.tick,
    st.tick + nticks) (``scenario.fault_window``; the ring engine steps a
    tick at a time), on ``crashed`` and ``down_since`` in place.  Returns
    (d_crash, d_recover), int64 0-d, or (0, 0) without fault events."""
    scen = cfg.scenario_resolved
    if not scen.has_faults:
        return 0, 0
    new_crash, recover, st.down_since, dc, drc = _scen.fault_window(
        scen, cfg.n, st.tick, nticks, ids_global, st.crashed, st.down_since,
        base_key)
    st.crashed = (st.crashed & ~recover) | new_crash
    return dc, drc


def make_heal_fn(cfg: Config):
    """The ring engine's overlay healing (None when -overlay-heal is off),
    in place, once per poll window: condemn dead friends
    (scenario.detect_dead), replace them through the phase-1 makeup draw,
    and deposit the infected healers' re-sends and the rejoin pulls'
    responses into the delay ring like any broadcast
    (scenario.heal_and_wave): two deposits of n * k lanes into one slot a
    row, through the deposit gate (integer adds commute, so the kernel
    gives the JAX package's unfused deposit's counts)."""
    if not cfg.overlay_heal_resolved:
        return None
    detect = cfg.heal_detect_ms
    d = ring_depth(cfg)
    dkern = cfg.deliver_kernel_resolved

    def heal_fn(st: SimState, base_key: torch.Tensor) -> SimState:
        n, k = st.friends.shape
        dev = st.friends.device
        ids = torch.arange(n, dtype=I32, device=dev)
        detected = _scen.detect_dead(st.crashed, st.down_since, st.tick,
                                     detect)
        healer_ok = ~st.crashed
        sender_inf = st.received & ~st.crashed & ~st.removed
        bits = _scen.heal_peer_bits(detected, sender_inf)
        friends, resend, pull, delay, clear, rep, blk = _scen.heal_and_wave(
            cfg, st.friends, st.friend_cnt, bits, healer_ok, sender_inf,
            _scen.rejoined_mask(st.down_since), ids, st.tick, base_key)
        if cfg.effective_time_mode == "rounds":
            dslot = torch.full((n,), (st.tick + 1) % d, dtype=I32,
                               device=dev)
        else:
            dslot = ((st.tick + delay) % d).to(I32)
        slots = dslot[:, None].expand(n, k).reshape(-1)
        deposit_local(st.pending, torch.where(resend, friends, -1)
                      .reshape(-1), slots, resend.reshape(-1), kernel=dkern)
        # Rejoin pull responses deliver to the puller's own row.
        deposit_local(st.pending, ids[:, None].expand(n, k).reshape(-1),
                      slots, pull.reshape(-1), kernel=dkern)
        st.friends = friends
        st.down_since = torch.where(clear, -1, st.down_since)
        st.heal_repaired += rep
        st.part_dropped += blk
        return st

    return heal_fn


def make_window_fn(cfg: Config, window: int):
    """`window` consecutive steps (one progress window), then (-overlay-heal
    on) one healing pass, the cadence and tick keys of the JAX package's
    device loop."""
    step = make_step_fn(cfg)
    heal = make_heal_fn(cfg)

    def window_fn(st: SimState, base_key: torch.Tensor) -> SimState:
        for _ in range(window):
            step(st, base_key)
        if heal is not None:
            heal(st, base_key)
        return st

    return window_fn


def run_call_budget(cfg: Config) -> int:
    """Ticks per bounded call of the run-to-target loop (the JAX package's
    budget, which kept one device call under its runtime's watchdog):
    push-pull by lanes (n * 2 fanout peer draws a round), the rest by
    3.3e9 / n, both capped at 1024.  The trajectory does not depend on
    it: keys are by tick."""
    if cfg.protocol == "pushpull":
        return max(1, min(cfg.max_rounds, 1024,
                          int(1.5e9 // max(1, 2 * cfg.fanout * cfg.n))))
    return max(64, min(cfg.max_rounds, 1024, int(3.3e9 // max(cfg.n, 1))))


def make_run_to_coverage_fn(cfg: Config):
    """The JAX package's run-to-target while_loop as a host loop of poll
    windows (one round in rounds mode, 10 ticks in ticks mode): before
    each window, the target count (the worst rumor's under -rumors), the
    tick below max_rounds and below `until`, and a message in flight (not
    under push-pull, which draws fresh peers every round, nor under
    -overlay-heal on); then the window and its heal, and with a History
    one gossip_probe row (with its panel rows under -telemetry-spatial
    on).  One host read a window for the test.  run_fn(st, key, target,
    until, hist) -> (st, hist)."""
    from gossip_simulator_tpu_torch.utils import telemetry as telem

    window = make_window_fn(
        cfg, 1 if cfg.effective_time_mode == "rounds" else 10)
    max_steps = cfg.max_rounds
    check_in_flight = (cfg.protocol != "pushpull"
                       and not cfg.overlay_heal_resolved)
    multi = cfg.multi_rumor
    rumors = cfg.rumors
    sir = cfg.protocol == "sir"
    spatial = telem.spatial_spec(cfg)

    def live(st: SimState, target_count: int, until: int) -> bool:
        if st.tick >= max_steps or st.tick >= until:
            return False
        recv = st.rumor_recv[:rumors].min() if multi else st.total_received
        if not check_in_flight:
            return int(recv) < target_count
        recv, alive = torch.stack([recv.to(torch.int64),
                                   in_flight(st).to(torch.int64)]).tolist()
        return recv < target_count and bool(alive)

    def run_fn(st: SimState, base_key, target_count: int, until: int,
               hist=None):
        while live(st, target_count, until):
            window(st, base_key)
            if hist is not None:
                telem.record_window(hist, telem.gossip_probe(
                    st, sir, rumors=rumors if multi else 0), [st], spatial)
        return st, hist

    return run_fn
