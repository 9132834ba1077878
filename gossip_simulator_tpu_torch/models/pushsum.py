"""PushSum numeric gossip: mass averaging as a second model family.

The port of the JAX package's ``models/pushsum.py`` (single device).  Each
node carries a value vector x (length
``-pushsum-dim``) and a PushSum weight w (init 1).  Every window a node
keeps about half its (x, w) mass and pushes the other half, split evenly
over its friend edges, through the event engine's mail ring; delivery is
a scatter-ADD.  x_i / w_i converges to the network mean of the initial
values.

Mass is 64-bit fixed point (FRAC_BITS fractional bits) held as LIMBS
16-bit limbs in int32 columns, so every add is an integer add: the sums
commute, Sigma x and Sigma w are conserved exactly, and the drain may add
in any order (the CUDA kernels use atomics).  Limbs are normalized (< 2^16)
between windows.

The convergence metric is float32, computed from the limbs exactly as the
JAX package computes it.  Its four-limb sum is written as three adds, left
to right, in separate torch operations: a reduction kernel may add in
another order, and a tree order gives other bits on about a quarter of the
rows (the RECEIVED bit, ``relerr_ppb`` and ``eps_tick`` follow from it).

The mail ring is the event engine's layout (B-tick windows, dw slots, the
packed ``dst * B + tick_off`` entry) with a wide companion ring of mass
rows, ``mail_mass[L, C]``, at the same flat positions; PushSum sizes its
own slot capacity for the emission volume (dropped mail would destroy
mass).  The JAX package's ``fori_loop`` over a data-dependent chunk count
(the ``-phase2-kernel xla`` drain) is a Python loop here: one host read of
the slot's entry count a window step.  Under ``-phase2-kernel
auto|pallas`` the whole slot drains in one ``fused_drain_sum`` launch,
which reads the count on the card.  The state is updated in place.

Fault scenarios (``scenario.py``) apply at each window step's start on
the flags' crashed bit (``event.apply_fault_window_flags``): a crashed
node neither emits nor converges, but mail keeps landing in its row
(parked mass), which it pushes back out once it reboots, so Sigma x and
Sigma w stay exact.  The partition mask takes blocked edges out of the
sender's divisor, so their share never leaves it.  ``-overlay-heal on``
only consumes the reboot markers (``make_heal_fn``).

uint32 hashing runs in int64 lanes masked to 32 bits (as ``utils/rng.py``
does); the exact true means come from the numpy twin of the hash.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from gossip_simulator_tpu_torch import scenario as _scen
from gossip_simulator_tpu_torch.config import Config
from gossip_simulator_tpu_torch.models import event
from gossip_simulator_tpu_torch.models.state import in_flight, init_exch_counts
from gossip_simulator_tpu_torch.ops import mailbox, megakernel
from gossip_simulator_tpu_torch.utils import rng as _rng

I32 = torch.int32
I64 = torch.int64
F32 = torch.float32
M32 = 0xFFFFFFFF

LIMBS = 4  # 16-bit limbs per fixed-point scalar: 64-bit range
LIMB_BITS = 16
LIMB_MASK = (1 << LIMB_BITS) - 1
FRAC_BITS = 24  # weight 1.0 == 2**24
VALUE_BITS = 20  # init values are 20-bit hashes (integer part)
STARVE_BITS = 10  # weight < 2^-10: the node is cut off from the mix


@dataclasses.dataclass
class PushSumState:
    """Numeric-gossip phase-2 state.  Leaf names follow the JAX package's
    ``PushSumState``; ``utils/interop.py`` converts to and from its numpy
    form.  ``tick`` is a host int; the totals and counters are int64 0-d
    tensors, except ``mail_dropped`` (int32, the ring append's counter).
    ``down_since`` is the crash clock (int32[n] under
    Config.faults_enabled, a 1-element placeholder otherwise);
    ``exch_counts`` the exchange's counters (``init_exch_counts``)."""

    flags: torch.Tensor  # uint8[n]  CRASHED bit; RECEIVED mirrors converged
    friends: torch.Tensor  # int32[n, k]
    friend_cnt: torch.Tensor  # int32[n]
    mass: torch.Tensor  # int32[n, C]  C = (dim+1)*LIMBS, weight block last
    mail_ids: torch.Tensor  # int32[ring] packed dst*B + tick-offset
    mail_mass: torch.Tensor  # int32[ring, C] mass companion rows
    mail_cnt: torch.Tensor  # int32[1, dw]
    sup_cnt: torch.Tensor  # int32[1, dw] always 0 (in_flight duck-compat)
    tick: int
    total_message: torch.Tensor  # int64[]
    total_received: torch.Tensor  # int64[]  count of converged nodes
    total_crashed: torch.Tensor  # int64[]  always 0 (crashrate rejected)
    mail_dropped: torch.Tensor  # int32[]  must stay 0 (mass loss otherwise)
    exchange_overflow: torch.Tensor  # int64[]  (always 0 on one device)
    down_since: torch.Tensor  # int32[n | 1]  crash tick, -1 = live/unknown
    scen_crashed: torch.Tensor  # int64[]
    scen_recovered: torch.Tensor  # int64[]
    part_dropped: torch.Tensor  # int64[]
    heal_repaired: torch.Tensor  # int64[]  always 0 (heal rewires nothing)
    relerr_ppb: torch.Tensor  # int64[]  last window's live max rel-err, ppb
    eps_tick: torch.Tensor  # int64[]  first tick with eps-band count >= target
    exch_counts: torch.Tensor  # int32[1, S + 2 | 1]  (init_exch_counts)
    # (slot_cap, drain_chunk) the ring was sized with.
    geom: tuple = (0, 0)


# --- geometry ----------------------------------------------------------------
# The event engine's window cadence and slot layout; only the per-slot
# capacity differs (sized for the emission volume, not the SI one).

batch_ticks = event.batch_ticks
ring_windows = event.ring_windows


def mass_cols(cfg: Config) -> int:
    """int32 columns per node: dim value blocks + 1 weight block."""
    return (cfg.pushsum_dim + 1) * LIMBS


def _src_windows(cfg: Config) -> int:
    """How many distinct emission windows can land in one ring slot: the
    delay span [max(1, delaylow), delayhigh) mapped to window indices."""
    b = batch_ticks(cfg)
    dlow = max(1, cfg.delaylow)
    return max(1, (cfg.delayhigh - 1) // b - dlow // b + 1)


def slot_cap(cfg: Config, n_local: int | None = None) -> int:
    """Per-slot mail capacity: the zero-loss bound n*k*src_windows,
    clamped to 2*n*k and to int32 flat addressing of the ring."""
    n = int(n_local) if n_local is not None else cfg.n
    k = cfg.graph_width
    dw = ring_windows(cfg, n_local)
    if cfg.event_slot_cap > 0:
        cap = int(cfg.event_slot_cap)
    else:
        worst = n * k * _src_windows(cfg)
        cap = max(4096, min(worst, 2 * n * k))
    lim = (2**31 - 1 - event._chunk_want(cfg, n_local)) // max(dw, 1)
    return max(256, min(cap, lim))


def drain_chunk(cfg: Config, n_local: int | None = None) -> int:
    return min(slot_cap(cfg, n_local), event._chunk_want(cfg, n_local))


def ring_tail(cfg: Config, n_local: int | None = None) -> int:
    """Slack past the last slot: covers the drain's last chunk and the
    append trash cell at flat index dw*cap."""
    return drain_chunk(cfg, n_local)


def ring_len(cfg: Config, n_local: int | None = None) -> int:
    return (ring_windows(cfg, n_local) * slot_cap(cfg, n_local)
            + ring_tail(cfg, n_local))


# --- fixed-point limb arithmetic ---------------------------------------------


def _shift_up(x: torch.Tensor) -> torch.Tensor:
    """Limb i takes limb i-1's value (limb 0 takes 0)."""
    return torch.cat([torch.zeros_like(x[..., :1]), x[..., :-1]], dim=-1)


def _normalize(m3: torch.Tensor) -> torch.Tensor:
    """Carry sweep on (..., LIMBS) int32 limbs: LIMBS passes bring any
    post-deposit accumulation back below 2^16 a limb."""
    for _ in range(LIMBS):
        m3 = (m3 & LIMB_MASK) + _shift_up(m3 >> LIMB_BITS)
    return m3


def _halve(m3: torch.Tensor):
    """floor(v/2) on normalized limbs; returns (half, odd) with half +
    half + odd == v (odd is the dropped low bit, shape (...,))."""
    up = torch.cat([m3[..., 1:] & 1, torch.zeros_like(m3[..., :1])], dim=-1)
    return (m3 >> 1) | (up << (LIMB_BITS - 1)), m3[..., 0] & 1


def _div_rows(m3: torch.Tensor, m: torch.Tensor):
    """Long division of normalized limbs (n, G, LIMBS) by the per-row
    divisor m (n,), high limb first: (quotient limbs, remainder (n, G))
    with q*m + r == v exactly (m <= 32767)."""
    mm = m[:, None]
    r = torch.zeros(m3.shape[:-1], dtype=I32, device=m3.device)
    qs = []
    for i in range(LIMBS - 1, -1, -1):
        cur = r * (LIMB_MASK + 1) + m3[..., i]
        q = torch.div(cur, mm, rounding_mode="floor")
        r = cur - q * mm
        qs.append(q)
    qs.reverse()
    return torch.stack(qs, dim=-1), r


_SCALE = tuple(float(2.0 ** (LIMB_BITS * i - FRAC_BITS))
               for i in range(LIMBS))


def _to_float(m3: torch.Tensor) -> torch.Tensor:
    """float32 value of (..., LIMBS) limbs: each limb times its power of
    two (exact), then ((t0 + t1) + t2) + t3, left to right, one add at a
    time -- the JAX package's reduction order, on any device."""
    f = m3.to(F32)
    out = f[..., 0] * _SCALE[0]
    for i in range(1, LIMBS):
        out = out + f[..., i] * _SCALE[i]
    return out


# --- init values -------------------------------------------------------------
# Per-(seed, gid, dim) 20-bit hash values, twice with identical uint32
# wraparound: torch (int64 lanes masked to 32 bits) for the device init,
# numpy for the exact true means.


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """uint32 x * c mod 2^32 for x in [0, 2^32), without int64 overflow:
    the constant's two 16-bit halves multiply separately."""
    lo = x * (c & LIMB_MASK)
    hi = ((x * (c >> LIMB_BITS)) & LIMB_MASK) << LIMB_BITS
    return (lo + hi) & M32


def _mix32(x: torch.Tensor) -> torch.Tensor:
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def _mix32_np(x):
    x = x.astype(np.uint32).copy()
    x ^= x >> np.uint32(16)
    x = x * np.uint32(0x7FEB352D)
    x ^= x >> np.uint32(15)
    x = x * np.uint32(0x846CA68B)
    x ^= x >> np.uint32(16)
    return x


def _values_q_host(seed: int, n: int, dim: int) -> np.ndarray:
    """(n, dim) int64 of 20-bit init values q (fixed-point x = q * 2^24)."""
    gid = np.arange(n, dtype=np.uint32)[:, None]
    d = np.arange(dim, dtype=np.uint32)[None, :]
    with np.errstate(over="ignore"):
        h = _mix32_np(np.uint32(seed & M32)
                      ^ (gid * np.uint32(0x9E3779B9)))
        h = _mix32_np(h ^ ((d + np.uint32(1)) * np.uint32(0x85EBCA6B)))
    return (h >> np.uint32(32 - VALUE_BITS)).astype(np.int64)


def _values_q(seed: int, gid: torch.Tensor, dim: int) -> torch.Tensor:
    """(rows, dim) int32 of the same q values for global ids `gid`."""
    g = gid.to(I64)[:, None] & M32
    d = torch.arange(dim, dtype=I64, device=gid.device)[None, :]
    h = _mix32((seed & M32) ^ _mul32(g, 0x9E3779B9))
    h = _mix32(h ^ _mul32(d + 1, 0x85EBCA6B))
    return (h >> (32 - VALUE_BITS)).to(I32)


@functools.lru_cache(maxsize=None)
def _true_means(n: int, dim: int, seed: int) -> tuple:
    sums = _values_q_host(seed, n, dim).sum(axis=0)  # exact int64
    return tuple(float(s) / float(n) for s in sums)


def true_means(cfg: Config) -> tuple:
    """Exact network means of the init values (integer q units)."""
    return _true_means(cfg.n, cfg.pushsum_dim, cfg.seed)


def eps_target(cfg: Config) -> int:
    """Eps-band node count at which eps_tick stamps."""
    return int(np.ceil(cfg.coverage_target * cfg.n))


def init_mass(cfg: Config, gid0: int, rows: int, device=None) -> torch.Tensor:
    """(rows, C) int32 initial mass for global ids [gid0, gid0+rows):
    value blocks q*2^24, weight block 1.0 = 2^24."""
    gid = gid0 + torch.arange(rows, dtype=I32, device=device)
    q = _values_q(cfg.seed, gid, cfg.pushsum_dim)  # (rows, D)
    z = torch.zeros_like(q)
    # q * 2^24 in 16-bit limbs: bits 24..43 -> limb1's high byte + limb2.
    vl = torch.stack([z, (q & 0xFF) << 8, (q >> 8) & LIMB_MASK, z], dim=-1)
    wl = torch.zeros((rows, 1, LIMBS), dtype=I32, device=device)
    wl[:, :, 1] = 1 << (FRAC_BITS - LIMB_BITS)
    return torch.cat([vl, wl], dim=1).reshape(rows, mass_cols(cfg))


# --- state -------------------------------------------------------------------


def init_state(cfg: Config, friends: torch.Tensor, friend_cnt: torch.Tensor,
               gid0: int = 0, n_shards: int = 1) -> PushSumState:
    """State of rows [gid0, gid0 + n) (a shard's slice of `n_shards`
    under the sharded backend: its masses are the global ids' hashes)."""
    n = friends.shape[0]
    dev = friends.device
    dw = ring_windows(cfg, n)
    length = ring_len(cfg, n)

    def z():
        return torch.zeros((), dtype=I64, device=dev)

    return PushSumState(
        flags=torch.zeros(n, dtype=torch.uint8, device=dev),
        friends=friends, friend_cnt=friend_cnt,
        mass=init_mass(cfg, gid0, n, dev),
        mail_ids=torch.zeros(length, dtype=I32, device=dev),
        mail_mass=torch.zeros((length, mass_cols(cfg)), dtype=I32,
                              device=dev),
        mail_cnt=torch.zeros((1, dw), dtype=I32, device=dev),
        sup_cnt=torch.zeros((1, dw), dtype=I32, device=dev),
        tick=0, total_message=z(), total_received=z(), total_crashed=z(),
        mail_dropped=torch.zeros((), dtype=I32, device=dev),
        exchange_overflow=z(),
        down_since=_scen.init_down_since(cfg.faults_enabled, n, dev),
        scen_crashed=z(), scen_recovered=z(), part_dropped=z(),
        heal_repaired=z(),
        relerr_ppb=torch.full((), 2_000_000_000, dtype=I64, device=dev),
        eps_tick=torch.full((), -1, dtype=I64, device=dev),
        exch_counts=init_exch_counts(cfg, n_shards, dev),
        geom=(slot_cap(cfg, n), drain_chunk(cfg, n)),
    )


# --- the window step's cores -------------------------------------------------


def _mean_consts(cfg: Config) -> tuple[np.ndarray, np.ndarray]:
    """float32 true means and the reciprocals of max(|mean|, 1e-6), both
    computed on the host in float32, so every device gets the same
    bits."""
    tm = np.asarray(true_means(cfg), np.float32)
    means = np.maximum(np.abs(tm), np.float32(1e-6))
    return tm, np.float32(1.0) / means


def metric_rel(cfg: Config, m3: torch.Tensor, crashed: torch.Tensor):
    """Per-node float32 relative error vs the true mean, max over dims,
    clamped to 2.0; crashed rows report 0.  Returns ``(rel, rep)``:
    ``rel`` decides the converged count; ``rep`` zeroes the weight-starved
    rows (weight < 2^-STARVE_BITS), for the live max."""
    dim = cfg.pushsum_dim
    dev = m3.device
    vals = _to_float(m3[:, :dim, :])  # (n, D)
    w_raw = _to_float(m3[:, dim, :])
    f = functools.partial(torch.tensor, dtype=F32, device=dev)
    w = torch.maximum(w_raw, f(2.0 ** -FRAC_BITS))
    tm, inv_means = _mean_consts(cfg)
    est = vals / w[:, None]
    # The JAX package's jitted step divides by the compile-time constant
    # means as a multiply by their float32 reciprocal (XLA's constant
    # folding); a true division gives other bits on ~5 % of the rows.
    rel = ((est - f(tm)[None, :]).abs() * f(inv_means)[None, :]).amax(dim=1)
    rel = torch.where(crashed, f(0.0), torch.minimum(rel, f(2.0)))
    rep = torch.where(w_raw < f(2.0 ** -STARVE_BITS), f(0.0), rel)
    return rel, rep


def emit_shares(cfg: Config, m3, crashed, friends, friend_cnt, tick: int,
                gids, base_key):
    """The PushSum emission: halve, split over the eligible edges, return
    the lanes to append.  An eligible edge is in range, not padding, from
    a live sender and not partition-blocked at send tick `tick`;
    ineligible lanes are out of the divisor, so their share never leaves
    the sender.  Crashed destinations still receive (parked mass).
    Returns (new_m3, share_lanes (n*k, C), dst
    (n*k,), wslot (n*k,), off (n*k,), lane_valid (n*k,), blocked_count);
    one delay per sender, (tick, id)-keyed off the base key."""
    n, k = friends.shape
    dev = friends.device
    b = batch_ticks(cfg)
    dw = ring_windows(cfg)
    in_range = (torch.arange(k, dtype=I32, device=dev)[None, :]
                < friend_cnt[:, None])
    edge = in_range & (friends >= 0) & ~crashed[:, None]
    scen = cfg.scenario_resolved
    blk = torch.zeros((), dtype=I64, device=dev)
    if scen.has_partitions:
        blocked = _scen.partition_blocked(scen, cfg.n, tick, gids[:, None],
                                          friends) & edge
        blk = blocked.sum(dtype=I64)
        edge = edge & ~blocked
    mdeg = edge.sum(dim=1, dtype=I32)
    emit = ~crashed & (mdeg > 0)
    half, odd = _halve(m3)
    share, rem = _div_rows(half, torch.clamp_min(mdeg, 1))
    # kept = ceil(v/2) + division remainder: v == kept + mdeg*share.
    kept = half.clone()
    kept[..., 0] += odd + rem
    new_m3 = torch.where(emit[:, None, None], kept, m3)
    c = m3.shape[1] * LIMBS
    share = torch.where(emit[:, None, None], share, torch.zeros_like(share))
    share_lanes = share.reshape(n, 1, c).expand(n, k, c).reshape(n * k, c)
    tk = _rng.tick_key(base_key, tick, _rng.OP_PUSHSUM)
    delay = _rng.row_uniform_delay(tk, cfg.delaylow, cfg.delayhigh, gids)
    arrive = tick + delay
    wslot = ((arrive // b) % dw)[:, None].expand(n, k).reshape(-1)
    off = (arrive % b)[:, None].expand(n, k).reshape(-1)
    lane_valid = (edge & emit[:, None]).reshape(-1)
    dst = torch.where(edge, friends, torch.zeros_like(friends)).reshape(-1)
    return new_m3, share_lanes, dst, wslot, off, lane_valid, blk


def make_window_step_fn(cfg: Config, n_local: int | None = None):
    """One B-tick window, in place: scenario faults -> drain this window's
    slot with the SUM combine -> normalize -> convergence metric ->
    emission."""
    b = batch_ticks(cfg)
    dw = ring_windows(cfg)
    cap = slot_cap(cfg, n_local)
    ccap = drain_chunk(cfg, n_local)
    dim = cfg.pushsum_dim
    ncol = mass_cols(cfg)
    tgt = eps_target(cfg)
    dkern = cfg.deliver_kernel_resolved
    p2 = cfg.phase2_kernel_resolved

    def drain(st: PushSumState, slot: int) -> None:
        if p2 == "pallas":
            # The whole slot in one pass; integer adds commute, so this
            # equals any chunking bit for bit.
            megakernel.fused_drain_sum(st.mass, st.mail_ids, st.mail_mass,
                                       st.mail_cnt, slot, cap=cap, b=b)
            return
        m = int(st.mail_cnt[0, slot])  # host read: the chunk count
        lane = torch.arange(ccap, dtype=I32, device=st.mass.device)
        for j in range((m + ccap - 1) // ccap):
            off0 = slot * cap + j * ccap
            ent = st.mail_ids[off0:off0 + ccap]
            rows = st.mail_mass[off0:off0 + ccap]
            ok = j * ccap + lane < m
            mailbox.deposit_sum(st.mass,
                                torch.div(ent, b, rounding_mode="floor"),
                                rows, ok, kernel=dkern)

    def step_fn(st: PushSumState, base_key: torch.Tensor) -> PushSumState:
        n = st.friends.shape[0]
        dev = st.mass.device
        gids = torch.arange(n, dtype=I32, device=dev)
        slot = (st.tick // b) % dw
        dsc, dsr = event.apply_fault_window_flags(cfg, st, gids, base_key, b)
        drain(st, slot)
        m3 = _normalize(st.mass.view(n, dim + 1, LIMBS))
        crashed = (st.flags & event.CRASHED) > 0
        rel, rep = metric_rel(cfg, m3, crashed)
        conv = rel <= torch.tensor(cfg.pushsum_eps, dtype=F32, device=dev)
        # RECEIVED mirrors "currently within eps".
        st.flags = torch.where(conv, st.flags | event.RECEIVED,
                               st.flags & (0xFF ^ event.RECEIVED))
        recv = conv.sum()
        new_tick = st.tick + b
        st.eps_tick = torch.where((st.eps_tick < 0) & (recv >= tgt),
                                  torch.full_like(st.eps_tick, new_tick),
                                  st.eps_tick)
        new_m3, share, dst, wslot, off, lane_valid, blk = emit_shares(
            cfg, m3, crashed, st.friends, st.friend_cnt, st.tick, gids,
            base_key)
        mailbox.ring_append((st.mail_ids, st.mail_mass), st.mail_cnt,
                            st.mail_dropped, (dst * b + off, share), wslot,
                            lane_valid, dw, cap, kernel=dkern)
        st.mail_cnt[0, slot] = 0
        st.mass = new_m3.reshape(n, ncol)
        st.tick = new_tick
        st.total_message += lane_valid.sum()
        st.total_received = recv
        st.scen_crashed += dsc
        st.scen_recovered += dsr
        st.part_dropped += blk
        st.relerr_ppb = (rep.max() * torch.tensor(1e9, dtype=F32, device=dev)
                         ).to(I32).to(I64)
        return st

    return step_fn


def make_seed_fn(cfg: Config):
    """No-op: every node's mass exists from init; the first window step
    starts the exchange."""

    def seed_fn(st: PushSumState, base_key: torch.Tensor) -> PushSumState:
        return st

    return seed_fn


def make_heal_fn(cfg: Config):
    """Reboot-marker clearing only (None when -overlay-heal is off).  The
    SI heal's repair, re-send and pull are all inert for PushSum, as in
    the JAX package: repairing edges away from a node that is down for a
    while would strand it when it reboots (nobody pushes to it), and
    re-sends or pulls would emit extra mass.  Parked mass and the
    unchanged topology are the averaging model's own healing; what
    remains is consuming the markers, so detection clocks restart
    cleanly across repeated reboots."""
    if not cfg.overlay_heal_resolved:
        return None

    def heal_fn(st: PushSumState, base_key: torch.Tensor) -> PushSumState:
        st.down_since = torch.where(_scen.rejoined_mask(st.down_since), -1,
                                    st.down_since)
        return st

    return heal_fn


def make_window_fn(cfg: Config, window: int):
    """Advance ~`window` simulated ms: ceil(window / B) window steps, then
    (-overlay-heal on) the healing pass."""
    step = make_window_step_fn(cfg)
    heal = make_heal_fn(cfg)
    steps = max(1, -(-window // batch_ticks(cfg)))

    def window_fn(st: PushSumState, base_key: torch.Tensor) -> PushSumState:
        for _ in range(steps):
            step(st, base_key)
        if heal is not None:
            heal(st, base_key)
        return st

    return window_fn


def make_run_to_coverage_fn(cfg: Config):
    """event.make_run_to_coverage_fn's loop for PushSum: total_received
    counts the converged-or-crashed nodes, and the in-flight term holds
    only past the first batch (the ring is empty before the first
    emission); each row carries the relerr_ppb column, and so do the
    spatial panels' shard rows."""
    from gossip_simulator_tpu_torch.utils import telemetry as telem

    window = make_window_fn(cfg, 10)
    spatial = telem.spatial_spec(cfg)
    max_steps = cfg.max_rounds
    check_in_flight = not cfg.overlay_heal_resolved
    b = batch_ticks(cfg)

    def live(st: PushSumState, target_count: int, until: int) -> bool:
        if st.tick >= max_steps or st.tick >= until:
            return False
        if not check_in_flight or st.tick < b:
            return int(st.total_received) < target_count
        recv, alive = torch.stack([st.total_received,
                                   in_flight(st).to(torch.int64)]).tolist()
        return recv < target_count and bool(alive)

    def run_fn(st: PushSumState, base_key, target_count: int, until: int,
               hist=None):
        while live(st, target_count, until):
            window(st, base_key)
            if hist is not None:
                telem.record_window(hist, telem.gossip_probe(
                    st, False, relerr=st.relerr_ppb), [st], spatial,
                    relerr=st.relerr_ppb)
        return st, hist

    return run_fn


def report(stepper) -> dict:
    """The PushSum result payload: whether the live max relative error
    reached eps, the tick it first did, and the last window's max error in
    ppb (the JAX package writes it to its JSONL result record)."""
    st = stepper.state
    if isinstance(st, list):
        st = st[0]  # the sharded stepper's shards replicate these scalars
    rp, et = (int(v) for v in torch.stack(
        [st.relerr_ppb, st.eps_tick]).tolist())
    return {"converged_eps": et >= 0, "eps_ticks": et, "relerr_ppb": rp}


def conserved_totals(st: PushSumState, cfg: Config) -> list:
    """Sigma of each fixed-point scalar block (dim values, then the
    weight) over the node masses and the live ring rows, as Python ints:
    each limb column summed in int64, the columns combined exactly."""
    dw = st.mail_cnt.shape[1]
    cap = st.geom[0]
    cols = st.mass.to(I64).sum(dim=0)
    for s, m in enumerate(st.mail_cnt[0].tolist()):
        if s < dw and m:
            cols = cols + st.mail_mass[s * cap:s * cap + m].to(I64).sum(dim=0)
    cols = cols.tolist()
    return [sum(cols[blk * LIMBS + i] << (LIMB_BITS * i)
                for i in range(LIMBS))
            for blk in range(cfg.pushsum_dim + 1)]
