"""Event-list epidemic engine: cost O(arrivals), not O(n x ticks).

The port of the JAX package's ``models/event.py``, SI and SIR, and SI
with a rumor axis (``-rumors R``, ``-traffic stream``).  Messages
themselves are stored, batched by delivery time:

* A WINDOW is B = min(10, delaylow) ticks.  Every network delay is
  >= delaylow >= B, so a message delivered inside a window cannot cause
  another delivery in the same window, and the whole window drains as
  one chunked batch.
* Mail ring: a flat ``mail_ids[dw * cap + ring_tail]``; window slot s
  occupies ``[s*cap, (s+1)*cap)``, ``mail_cnt[0, s]`` counts its entries.
  An entry is PACKED as ``dst * B + tick_off``; SIR re-broadcast triggers
  are ``trigger_base + id * B + tick_off`` and sort after all data.  The
  tail holds per-lane trash cells, so every scatter has unique, in-bounds
  indices.
* Draining sorts each chunk by (id, crash-fired-first, tick_off): a
  node's entries form one run whose first element says whether a crash
  draw fired and, if not, the earliest delivery tick.
* ``flags`` packs received (bit0), crashed (bit1) and removed (bit2, SIR)
  per node, plus one trash cell at index n that absorbs the writes of
  lanes that update nothing (the JAX package drops out-of-range scatters;
  torch raises on them).

Random draws reproduce the JAX package's streams bit for bit
(``utils/rng.py``), so a run here gives the JAX package's trajectory.

Multi-rumor traffic (``Config.multi_rumor``): every ring entry carries
W = ceil(R/32) words of rumor bits in ``mail_words``, a ring of the id
ring's length, at the same flat position; ``rumor_words`` holds each
node's bits.  Words are carried as the int32 view of the JAX package's
uint32 bit patterns (AND, OR and NOT commute with the view; no word is
shifted, compared or sorted).  The window step injects each rumor due in
its window as a self-addressed entry (``injection_batch``) before it
reads the slot count, so a source counts as infected when its entry
drains; the drain folds each node-run's words with a segmented OR
(``segmented_or``, by bit lanes), and the node's NEW bits update
``rumor_words``, the per-rumor counts and the payload it forwards.

Fault scenarios (``scenario.py``): crash, churn and recovery apply at
each window step's start on the flags' crashed bit
(``apply_fault_window_flags``), after which the drain black-holes
deliveries to crashed nodes even at crash rate 0; the partition mask
filters every append at its send tick, before the duplicate filter
(counted in ``part_dropped``); with ``-overlay-heal on`` a healing pass
(``make_heal_fn``) runs after each poll window's steps.

Where the JAX package threads the state through donated jitted functions,
this port updates the ring, its counts and the flags IN PLACE (the ring
is the largest tensor of the run; a copy per append batch would double
its traffic).  The JAX package's ``fori_loop`` over a data-dependent
chunk count is a Python loop here: each window step reads the slot's
entry count to the host once, and each chunk reads its new-sender count
once, for the narrow-tail batch schedule.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from gossip_simulator_tpu_torch import arrivals as _arrivals
from gossip_simulator_tpu_torch import config as _config
from gossip_simulator_tpu_torch import scenario as _scen
from gossip_simulator_tpu_torch.config import Config
from gossip_simulator_tpu_torch.models import epidemic
from gossip_simulator_tpu_torch.models.state import in_flight, init_exch_counts
from gossip_simulator_tpu_torch.ops import deliver, mailbox, megakernel
from gossip_simulator_tpu_torch.utils import rng as _rng

I32 = torch.int32
I64 = torch.int64

RECEIVED = 1
CRASHED = 2
REMOVED = 4  # SIR: stopped re-broadcasting (still counts coverage)


@dataclasses.dataclass
class EventState:
    """SI/SIR epidemic state with packed message lists.  Leaf names follow
    the JAX package's EventState; ``utils/interop.py`` converts to and from
    its numpy form.  Counters are int64 0-d tensors on the run's device,
    ``tick`` a host int."""

    flags: torch.Tensor  # uint8[n + 1]: bit0 recv, bit1 crashed, bit2 removed; [n] = trash
    friends: torch.Tensor  # int32[n, k]
    friend_cnt: torch.Tensor  # int32[n]
    mail_ids: torch.Tensor  # int32[dw * cap + ring_tail]
    mail_cnt: torch.Tensor  # int32[1, dw]
    # Deferred total_message credits from duplicate suppression, bucketed
    # by arrival window slot; credited when that window drains.
    sup_cnt: torch.Tensor  # int32[1, dw]
    tick: int
    total_message: torch.Tensor  # int64[]
    total_received: torch.Tensor  # int64[]
    total_crashed: torch.Tensor  # int64[]
    mail_dropped: torch.Tensor  # int64[]  slot-capacity overflow (counted)
    exchange_overflow: torch.Tensor  # int64[]  (always 0 on one device)
    # Scenario leaves: the crash clock (int32[n] under Config.faults_enabled,
    # a 1-element placeholder otherwise) and the fault counters.
    down_since: torch.Tensor  # int32[n | 1]  crash tick, -1 = live/unknown
    scen_crashed: torch.Tensor  # int64[]
    scen_recovered: torch.Tensor  # int64[]
    part_dropped: torch.Tensor  # int64[]
    heal_repaired: torch.Tensor  # int64[]
    # Multi-rumor leaves (init_rumor_leaves): full size under
    # Config.multi_rumor, the JAX package's 1-element placeholders
    # otherwise.  Words are the int32 view of its uint32 bits; rumor_words
    # has one trash row at n, like flags.
    mail_words: torch.Tensor  # int32[dw * cap + ring_tail, W | 1x1]
    rumor_words: torch.Tensor  # int32[n + 1, W | 1x1]
    rumor_recv: torch.Tensor  # int32[W * 32 | 1]  infected count a rumor
    rumor_done: torch.Tensor  # int32[W * 32 | 1]  tick the target was hit
    exch_counts: torch.Tensor  # int32[1, S + 2 | 1]  (init_exch_counts)
    # (slot_cap, drain_chunk) the ring was sized with.
    geom: tuple = (0, 0)


# --- sizing ----------------------------------------------------------------


def batch_ticks(cfg: Config, n_local: int | None = None) -> int:
    """Window size B at n_local rows (cfg.n by default):
    ``config.batch_ticks_for``."""
    return _config.batch_ticks_for(cfg, cfg.n if n_local is None
                                   else n_local)


def trigger_base(n: int, b: int) -> int:
    """SIR triggers pack as trigger_base + id*b + off: after every data
    entry and after the data padding sentinel n*b."""
    return (n + 1) * b


def ring_windows(cfg: Config, n_local: int | None = None) -> int:
    """Window-slot ring depth at n_local rows (``cfg.ring_windows`` at full
    n): max arrival offset in windows, plus current."""
    if n_local is None:
        return cfg.ring_windows
    return _config.ring_windows_for(cfg, n_local)


def slot_cap(cfg: Config, n_local: int | None = None) -> int:
    """Packed entries per window slot: 1.5x the mean in-flight volume of
    one window (overflow is counted, never silent), bounded by the SI
    message total, by the JAX package's ~3 GB ring budget (kept so the
    port sizes its ring, hence its trajectory, identically) and by int32
    flat addressing of the whole ring including its tail."""
    n = n_local if n_local is not None else cfg.n
    b = batch_ticks(cfg, n_local)
    dw = ring_windows(cfg, n_local)
    sir = cfg.protocol == "sir"
    deg = cfg.mean_degree + (1 if sir else 0)
    headroom = _config.EVENT_SLOT_HEADROOM
    cap = cfg.event_slot_cap if cfg.event_slot_cap > 0 else max(
        4096, int(math.ceil(headroom * n * deg * b
                            / max(cfg.delay_span, 1))))
    if not sir:
        cap = min(cap, n * cfg.graph_width + cfg.graph_width)
    if cfg.event_slot_cap <= 0:
        hbm = (3 * 2**30 if not (cfg.dup_suppress_resolved and not sir)
               else 3 * 2**29)
        cap = min(cap, hbm // (4 * max(dw, 1)))
    cw = _chunk_want(cfg, n_local)
    scap = sender_compaction_cap(cfg, cw)
    width = scap if scap else cw
    tail_ub = max(cw, width * (cfg.graph_width + (1 if sir else 0)))
    lim = (2**31 - 1 - tail_ub) // max(dw, 1)
    if lim <= 0:
        raise ValueError(
            f"-event-chunk {cfg.event_chunk} implies a ring tail of "
            f"{tail_ub} lanes, past int32 flat addressing; lower it")
    return min(cap, lim)


def ring_tail(cfg: Config, n_local: int | None = None) -> int:
    """Slack past the last slot: unique trash lanes for one full append
    batch, and >= drain_chunk so the last drain slice never runs off."""
    ccap = drain_chunk(cfg, n_local)
    scap = sender_compaction_cap(cfg, ccap)
    width = scap if scap else ccap
    lanes = width * (cfg.graph_width + (1 if cfg.protocol == "sir" else 0))
    return max(ccap, lanes)


def drain_chunk(cfg: Config, n_local: int | None = None) -> int:
    """Drain chunk size: clamp(n/128 * r^3, 131k, hi) with r =
    mean_degree/4, rounded up to a power of two (see _chunk_want)."""
    return min(slot_cap(cfg, n_local), _chunk_want(cfg, n_local))


def _chunk_want(cfg: Config, n_local: int | None = None) -> int:
    """drain_chunk before its slot_cap clamp (>= 256)."""
    n = n_local if n_local is not None else cfg.n
    if cfg.event_chunk > 0:
        want = cfg.event_chunk
    else:
        r = max(1.0, cfg.mean_degree / 4.0)
        hi = (_config.EVENT_DRAIN_CHUNK_HI if r >= 1.5
              else _config.EVENT_DRAIN_CHUNK_HI_LOWDEG)
        if cfg.dup_suppress_resolved and r >= 1.5:
            hi = _config.EVENT_DRAIN_CHUNK_HI_SUPPRESS
        floor = _config.EVENT_DRAIN_CHUNK_FLOOR
        want = min(hi, max(floor, int(n // 128 * r ** 3)))
        want = 1 << (want - 1).bit_length()
    return max(256, want)


def sender_compaction_cap(cfg: Config, ccap: int) -> int:
    """Sender-compaction batch width (0 = dense append): ccap/4 at mean
    degree >= 5, ccap/2 at >= 3 (the typical new-sender fraction of a
    chunk), dense below."""
    if cfg.mean_degree >= 5.0:
        return ccap // 4
    if cfg.mean_degree >= 3.0:
        return ccap // 2
    return 0


def narrow_tail_cap(scap: int) -> int:
    """Width of the narrow tail batches (0 = no narrow path): scap/8 when
    that is at least 1024 lanes."""
    if scap <= 0:
        return 0
    ns = scap // 8
    return ns if ns >= 1024 else 0


def narrow_tail_trips(count: int, scap: int, nscap: int) -> tuple[int, int]:
    """(full-width batches, narrow batches) covering `count` senders: a
    remainder that fits 1-2 narrow batches runs narrow, a larger one keeps
    one more full-width batch."""
    rem = count % scap
    tail = rem <= 2 * nscap
    nfull = count // scap + (0 if tail else 1)
    nnarrow = (rem + nscap - 1) // nscap if tail else 0
    return nfull, nnarrow


def batch_schedule(count: int, scap: int) -> list[tuple[int, int]]:
    """(width, first sender rank) of every append batch for `count`
    senders: full scap-wide batches, then the narrow tail."""
    nscap = narrow_tail_cap(scap)
    if nscap:
        nfull, nnarrow = narrow_tail_trips(count, scap, nscap)
    else:
        nfull, nnarrow = (count + scap - 1) // scap, 0
    out = [(scap, jb * scap) for jb in range(nfull)]
    out += [(nscap, nfull * scap + jb * nscap) for jb in range(nnarrow)]
    return out


# --- state -----------------------------------------------------------------


def init_rumor_leaves(cfg: Config, n: int, device,
                      ring_len: int | None = None):
    """(mail_words, rumor_words, rumor_recv, rumor_done): full size under
    Config.multi_rumor (words int32, rumor_words with its trash row),
    1-element placeholders otherwise."""
    if not cfg.multi_rumor:
        return (torch.zeros((1, 1), dtype=I32, device=device),
                torch.zeros((1, 1), dtype=I32, device=device),
                torch.zeros((1,), dtype=I32, device=device),
                torch.full((1,), -1, dtype=I32, device=device))
    w = cfg.rumor_word_count
    if ring_len is None:
        ring_len = ring_windows(cfg) * slot_cap(cfg, n) + ring_tail(cfg, n)
    return (torch.zeros((ring_len, w), dtype=I32, device=device),
            torch.zeros((n + 1, w), dtype=I32, device=device),
            torch.zeros((w * 32,), dtype=I32, device=device),
            torch.full((w * 32,), -1, dtype=I32, device=device))


def injection_lanes(cfg: Config) -> int:
    """Injection lanes a B-tick window: all R for oneshot (only window 0's
    lanes are valid), else the most rumors whose schedule tick can land in
    one window (with an arrival table, the largest count of rumors in one
    b-aligned bucket)."""
    if not cfg.multi_rumor:
        return 0
    if cfg.traffic != "stream":
        return cfg.rumors
    b = batch_ticks(cfg)
    table = _arrivals.table_or_none(cfg)
    if table is not None:
        counts = np.unique(np.asarray(table, np.int64) // b,
                           return_counts=True)[1]
        return int(counts.max()) if len(counts) else 1
    return min(cfg.rumors, (b * cfg.stream_rate + 999) // 1000 + 1)


def injection_batch(cfg: Config, tick: int, base_key, b: int, dw: int):
    """The rumors whose schedule tick lands in the window [tick, tick + b)
    as self-addressed entries (dst = the source row, delivered at the
    rumor's tick), so they enter through the ring and the drain like every
    relayed message.  Rumor r's tick is 0 (oneshot), r * 1000 //
    stream_rate (stream, fixed), or its arrival table's.  Source draws are
    keyed by the rumor index alone (OP_INJECT), so the schedule is the
    same at any shard count (injection_shard keeps a shard's lanes).  The
    schedule is host arithmetic (the window's tick is a host int).  Returns (payload,
    words, wslot, valid) of injection_lanes(cfg) lanes on the key's
    device; words int32[lanes, W] with the lane's rumor bit."""
    m = injection_lanes(cfg)
    r_total = cfg.rumors
    w = cfg.rumor_word_count
    stream = cfg.traffic == "stream"
    table = _arrivals.table_or_none(cfg) if stream else None
    lanes = np.arange(m, dtype=np.int64)
    if table is not None:
        tab = np.asarray(table, np.int64)
        rr = int(np.searchsorted(tab, tick, side="left")) + lanes
        t_r = tab[np.minimum(rr, r_total - 1)]
    elif stream:
        rate = cfg.stream_rate
        # The clamp keeps tick * rate in int32 in the JAX package; past
        # last_inject_tick every lane is invalid anyway.
        tickc = min(tick, cfg.last_inject_tick + 1)
        rr = (tickc * rate + 999) // 1000 + lanes
        t_r = rr * 1000 // rate
    else:
        rr = lanes
        t_r = np.zeros(m, np.int64)
    valid = (rr < r_total) & (t_r >= tick) & (t_r < tick + b)
    dev = base_key.device
    rr_t = torch.from_numpy(rr).to(dev)
    ik = _rng.fold_in(base_key, _rng.OP_INJECT)
    src = _rng.randint(_rng.fold_in(ik, rr_t), (), 0, cfg.n)
    t_t = torch.from_numpy(t_r).to(device=dev, dtype=I32)
    payload = src * b + t_t % b
    wslot = (t_t // b) % dw
    bit = np.where(rr % 32 == 31, -2**31, 1 << (rr % 32))  # int32 view
    words = np.where((rr[:, None] // 32) == np.arange(w)[None, :],
                     bit[:, None], 0).astype(np.int32)
    return (payload, torch.from_numpy(words).to(dev), wslot,
            torch.from_numpy(valid).to(dev))


def injection_shard(batch, b: int, n_local: int, shard: int):
    """The lanes of an injection_batch whose source `shard` (of `n_local`
    rows) owns, their payload rows localized."""
    payload, words, wslot, valid = batch
    src = payload // b
    return ((src % n_local) * b + payload % b, words, wslot,
            valid & (src // n_local == shard))


def stamp_rumor_done(cfg: Config, rumor_recv, rumor_done, tick: int):
    """Rumor r is done at the first window-end tick where its infected
    count reaches ceil(coverage_target * n); in place."""
    target = int(math.ceil(cfg.coverage_target * cfg.n))
    hit = (rumor_recv >= target) & (rumor_done < 0)
    rumor_done.masked_fill_(hit, tick)
    return rumor_done


def init_state(cfg: Config, friends: torch.Tensor,
               friend_cnt: torch.Tensor, n_shards: int = 1) -> EventState:
    """State of `friends`' rows (one shard's of `n_shards`)."""
    n = friends.shape[0]
    dev = friends.device
    dw = ring_windows(cfg)
    mail_words, rumor_words, rumor_recv, rumor_done = init_rumor_leaves(
        cfg, n, dev)

    def z():
        return torch.zeros((), dtype=I64, device=dev)

    return EventState(
        flags=torch.zeros(n + 1, dtype=torch.uint8, device=dev),
        friends=friends, friend_cnt=friend_cnt,
        mail_ids=torch.zeros(dw * slot_cap(cfg, n) + ring_tail(cfg, n),
                             dtype=I32, device=dev),
        mail_cnt=torch.zeros((1, dw), dtype=I32, device=dev),
        sup_cnt=torch.zeros((1, dw), dtype=I32, device=dev),
        tick=0, total_message=z(), total_received=z(), total_crashed=z(),
        mail_dropped=z(), exchange_overflow=z(),
        down_since=_scen.init_down_since(cfg.faults_enabled, n, dev),
        scen_crashed=z(), scen_recovered=z(), part_dropped=z(),
        heal_repaired=z(),
        mail_words=mail_words, rumor_words=rumor_words,
        rumor_recv=rumor_recv, rumor_done=rumor_done,
        exch_counts=init_exch_counts(cfg, n_shards, dev),
        geom=(slot_cap(cfg, n), drain_chunk(cfg, n)),
    )


# --- append ------------------------------------------------------------------


def _sender_keys(base_key, op: int, ticks, rows):
    """Per-sender key fold_in(fold_in(fold_in(base, tick), op), row): the
    stream a sender broadcasting at `tick` draws from."""
    return _rng.fold_in(_rng.tick_key(base_key, ticks, op), rows)


def append_messages(cfg: Config, mail_ids, mail_cnt, dropped, sender_ids,
                    svalid, sticks, friends, base_key, strig=None,
                    flags=None, kernel: str = "xla", phase2: str = "xla",
                    swords=None, mail_words=None):
    """Emit each sender's broadcast (k sends, ONE shared delay drawn at its
    delivery tick -- simulator.go:141-142) into the packed mail ring, in
    place.  Returns (mail_ids, mail_cnt, dropped, sup_adds[dw], blocked):
    `blocked` counts the edges the scenario's partition mask dropped at
    their send tick (before the duplicate filter; 0 without partitions).

    `flags` enables guaranteed-duplicate suppression (crash rate 0 only):
    an edge whose destination already has the received bit never enters
    the ring; its count is returned per arrival window for the caller to
    bank in sup_cnt.  `strig` (SIR) adds the re-broadcast trigger lane.

    Multi-rumor (`swords` int32 (m, W), the senders' new bits, and
    `mail_words` (L, W)): every lane writes its sender's words at the same
    flat cell as its id (0 where the id is 0), and the return gains
    mail_words.

    `phase2` "pallas" emits through ``megakernel.fused_emit``; "xla" runs
    the unfused chain and writes through ``deliver.fused_unique_set``
    (`kernel` "pallas") or ``index_put_`` (`kernel` "xla")."""
    n, k = friends.shape
    dw = ring_windows(cfg)
    cap = (mail_ids.shape[0] - ring_tail(cfg, n)) // dw
    b = batch_ticks(cfg)
    rows = torch.where(svalid, sender_ids, n)
    sidx = torch.where(svalid, sender_ids, 0)
    sf = friends[sidx.long()]
    kt = _rng.fold_in(base_key, sticks)
    dk = _rng.fold_in(_rng.fold_in(kt, _rng.OP_DELAY), rows)
    pk = _rng.fold_in(_rng.fold_in(kt, _rng.OP_DROP), rows)
    delay = torch.clamp_min(
        _rng.randint(dk, (), cfg.delaylow, cfg.delayhigh), 1)
    drop = _rng.bernoulli_masked(pk, epidemic.p_eff(cfg, cfg.droprate), (k,))
    arrive = sticks + delay
    wslot = (arrive // b) % dw
    off = arrive % b
    tb = trigger_base(n, b) if strig is not None else None
    scen = cfg.scenario_resolved
    pmask = None
    if scen.has_partitions:
        # The raw send-time predicate; the emission ANDs it with the edge
        # verdict (both gates).
        pmask = _scen.partition_blocked(scen, cfg.n, sticks[:, None],
                                        rows[:, None], sf)
    emit = dict(dw=dw, cap=cap, b=b, tb=tb, strig=strig,
                sender_ids=sender_ids if strig is not None else None,
                pmask=pmask, flags=flags, received_bit=RECEIVED)
    if phase2 == "pallas":
        out = megakernel.fused_emit(
            mail_ids, mail_cnt, sf, drop, svalid, wslot, off, swords=swords,
            mail_words=mail_words, **emit)
        mail_ids, adds, sup_adds, lost, blocked = out[:5]
    else:
        flat, ivals, adds, sup_adds, lost, blocked, wvals = \
            megakernel.emit_layout(mail_cnt, sf, drop, svalid, wslot, off,
                                   swords=swords, **emit)
        if kernel == "pallas" and swords is not None:
            deliver.fused_unique_set((mail_ids, mail_words), flat,
                                     (ivals, wvals))
        elif kernel == "pallas":
            deliver.fused_unique_set(mail_ids, flat, ivals)
        else:
            mail_ids.index_put_((flat.long(),), ivals)
            if swords is not None:
                mail_words.index_put_((flat.long(),), wvals)
    mail_cnt += adds[None, :]
    # CAVEAT (SIR): an overflowed reservation loses the sender's
    # re-broadcast trigger with its data messages; slot_cap budgets
    # mean_degree+1 per sender so this stays at zero.
    if swords is not None:
        return (mail_ids, mail_cnt, dropped + lost, sup_adds, blocked,
                mail_words)
    return mail_ids, mail_cnt, dropped + lost, sup_adds, blocked


# --- drain -------------------------------------------------------------------

# Pre-drain compaction engages once the received fraction crosses this.
PREDRAIN_MIN_RECV_FRAC = 0.9


def predrain_compact(b: int, n_rows: int, dw: int, cap: int, ccap: int,
                     sir: bool, flags, mail_ids, slot: int, m: int):
    """Filter the due window's slot against the CURRENT flags before the
    chunked drain (crash rate 0 only): a data entry whose destination is
    already received can only add to total_message in this window, so it
    is counted here and compacted away.  Stable compaction in place (chunk
    j writes below (j+1)*ccap, so no later chunk reads a written lane).
    Returns (mail_ids, kept_total, filtered_data) with int64 0-d counts."""
    dev = mail_ids.device
    kept = torch.zeros((), dtype=I64, device=dev)
    fdat = torch.zeros((), dtype=I64, device=dev)
    lane = torch.arange(ccap, dtype=I64, device=dev)
    for j in range((m + ccap - 1) // ccap):
        off0 = j * ccap
        valid = off0 + lane < m
        ent = mail_ids[slot * cap + off0: slot * cap + off0 + ccap]
        is_data = valid & (ent < n_rows * b) if sir else valid
        idx = torch.where(is_data, torch.clamp_max(ent // b, n_rows - 1), 0)
        f = flags[idx.long()]
        drop = is_data & ((f & RECEIVED) > 0)
        keep = valid & ~drop
        rank = kept + torch.cumsum(keep, dim=0) - 1
        tgt = torch.where(keep, slot * cap + rank, dw * cap + lane)
        vals = torch.where(keep, ent, torch.zeros_like(ent))
        mail_ids.index_put_((tgt,), vals)
        kept = kept + keep.sum()
        fdat = fdat + drop.sum()
    return mail_ids, kept, fdat


def segmented_or(key_s, words_s):
    """Each run's OR of `words_s` (int32 (L, W)) over the runs of equal
    `key_s` (sorted, so a run is contiguous), at every lane of the run:
    the words unpacked to W * 32 bit lanes (uint8, a byte of a word at a
    time), each run's ``scatter_reduce`` amax, packed back to int32.  Exact
    and order-free (a max of 0s and 1s), so the first lanes hold the JAX
    package's reversed associative scan's values bit for bit; no host
    read.  Faster on the card than a doubling scan over the run
    (``tests/torch_segor_times.py``, ``PERF.md``)."""
    m, w = words_s.shape
    dev = key_s.device
    newrun = torch.ones(m, dtype=torch.bool, device=dev)
    newrun[1:] = key_s[1:] != key_s[:-1]
    seg = torch.cumsum(newrun, dim=0) - 1
    sh = torch.arange(8, dtype=torch.uint8, device=dev)
    by = words_s.contiguous().view(torch.uint8).reshape(m, 4 * w, 1)
    bits = ((by >> sh) & 1).reshape(m, 32 * w)
    acc = torch.zeros_like(bits).scatter_reduce_(
        0, seg[:, None].expand(m, 32 * w), bits, "amax")
    runs = (acc.reshape(m, 4 * w, 8) << sh).sum(dim=2, dtype=torch.uint8)
    return runs.view(torch.int32)[seg]


def bit_counts(words) -> torch.Tensor:
    """int32[W * 32]: for each bit r (word r // 32, bit r % 32) of the
    int32 (L, W) `words`, the lanes that have it set.  Counted a byte at a
    time (the little-endian bytes of each word), a quarter of the memory
    of 32 int32 lanes a word."""
    lanes, w = words.shape
    by = words.contiguous().view(torch.uint8).reshape(lanes, w * 4, 1)
    sh = torch.arange(8, dtype=torch.uint8, device=words.device)
    bits = (by >> sh) & 1
    return bits.sum(dim=0, dtype=I32).reshape(w * 32)


def drain_chunk_core(crash_p: float, b: int, n_rows: int, flags, packed,
                     evalid, entry_pos, ckey, sir: bool = False,
                     track_crashed: bool = False, down_since=None,
                     win_tick: int = 0, words=None, rumor_words=None):
    """Crash/infect/dedupe one drained chunk of packed entries; updates
    `flags` (and `down_since`) in place.

    Sorts by (id, crash-fired-first, tick_off): a node's entries become one
    contiguous run whose FIRST element answers whether any per-message
    crash draw fired (keyed by mailbox position) and, if not, its earliest
    delivery tick.  SIR triggers sort after all data into their own runs;
    a trigger fires iff the node is infected and neither crashed nor
    removed as of the chunk start.

    `track_crashed` reads the crashed bit even at crash_p == 0: under a
    fault scenario nodes crash outside the reception draw, and deliveries
    to them black-hole.  `down_since` (not None) stamps `win_tick` on the
    nodes a reception crash fells (the crash clock of the reboot and
    detection timeline).

    Multi-rumor (`words` int32 (ccap, W), the entries' payload words, and
    `rumor_words` (n_rows + 1, W), SI only): the words ride the sort; each
    node-run's OR (``segmented_or``) lands on its first lane; a winner is a
    run's first lane that is counted and not crash-fired (received or
    not: first touch wins per rumor), and its NEW bits (run OR minus the
    node's words) update `rumor_words` in place, add to the per-rumor
    counts and become its forwarded payload.  Returns two more values,
    (delta_w int32 (ccap, W), drecv int32[W * 32]), and `senders` becomes
    the winners with new bits.

    Returns (flags, dm, dr, dc, ids_s, toff_s, senders); senders is
    newly-infected for SI, newly | firing for SIR."""
    ccap = packed.shape[0]
    dev = packed.device
    tb = trigger_base(n_rows, b)
    sentinel = tb + n_rows * b if sir else n_rows * b
    packed = torch.where(evalid, packed, sentinel)  # sentinel sorts last
    if words is not None:
        # Stale ring lanes past the count carry old words: zero them.
        words = torch.where(evalid[:, None], words, 0)
    if crash_p > 0.0:
        draw = _rng.bernoulli(_rng.row_keys(ckey, entry_pos), crash_p)
        crash_e = draw & evalid
        if sir:
            crash_e = crash_e & (packed < n_rows * b)  # not on triggers
        sub = (1 - crash_e.to(I32)) * b + packed % b
        # One int64 key id*2b + sub (sub < 2b): the JAX package sorts the
        # same key as uint32; both orders agree on these nonnegative keys.
        comb = (packed.to(I64) // b) * (2 * b) + sub
        comb_s, order = torch.sort(comb, stable=True)
        key1_s = (comb_s // (2 * b) * b).to(I32)
        sub_s = (comb_s % (2 * b)).to(I32)
        toff_s = sub_s % b
        crash_s = sub_s < b
    else:
        packed_s, order = torch.sort(packed, stable=True)
        key1_s = packed_s // b * b
        toff_s = packed_s % b
        crash_s = torch.zeros(ccap, dtype=torch.bool, device=dev)
    is_data = key1_s < n_rows * b
    if sir:
        is_trig = (key1_s >= tb) & (key1_s < sentinel)
        ids_s = torch.where(is_trig, (key1_s - tb) // b, key1_s // b)
        touched = is_data | is_trig
    else:
        ids_s = key1_s // b
        touched = is_data
    # The JAX gather clamps out-of-range rows; clamp explicitly.
    idx = torch.where(touched, ids_s, n_rows).clamp(0, n_rows - 1)
    pre = flags[idx.long()]
    pre_recv = (pre & RECEIVED) > 0
    if crash_p > 0.0 or track_crashed:
        pre_crash = ((pre & CRASHED) > 0) & touched
    else:
        pre_crash = torch.zeros(ccap, dtype=torch.bool, device=dev)
    counted = is_data & ~pre_crash
    dm = counted.sum()
    prev = torch.cat([torch.full((1,), -1, dtype=key1_s.dtype, device=dev),
                      key1_s[:-1]])
    first = (key1_s != prev) & is_data
    newly = first & counted & ~pre_recv & ~crash_s
    dr = newly.sum()
    delta = newly.to(torch.uint8) * RECEIVED
    dc = torch.zeros((), dtype=I64, device=dev)
    if crash_p > 0.0:
        run_crash = first & crash_s & ~pre_crash
        dc = run_crash.sum()
        delta = delta + run_crash.to(torch.uint8) * CRASHED
        if down_since is not None:
            down_since[ids_s[run_crash].long()] = win_tick
    # Winners are unique node ids whose delta bits are not yet set, so a
    # set of pre | delta equals the JAX package's add; lanes that update
    # nothing write 0 to the trash cell flags[n_rows].
    win = delta > 0
    flags.index_put_((torch.where(win, ids_s, n_rows).long(),),
                     torch.where(win, pre | delta, torch.zeros_like(pre)))
    senders = newly
    if sir:
        fire = is_trig & pre_recv & ~pre_crash & ~((pre & REMOVED) > 0)
        senders = newly | fire
    if words is None:
        return flags, dm, dr, dc, ids_s, toff_s, senders
    run_or = segmented_or(key1_s, words[order])
    win = first & counted & ~crash_s  # newly without the ~pre_recv gate
    idxw = torch.where(win, ids_s, n_rows).long()
    old = rumor_words[idxw]
    delta_w = torch.where(win[:, None], run_or & ~old, 0)
    # Winners are unique node ids; the others write 0 to the trash row.
    rumor_words.index_put_((idxw,), torch.where(win[:, None], old | delta_w,
                                                0))
    senders = win & (delta_w != 0).any(dim=1)
    return (flags, dm, dr, dc, ids_s, toff_s, senders, delta_w,
            bit_counts(delta_w))


def sender_batch(senders, srank, scnt: int, spacked, b: int, scap: int,
                 jb: int, lo: int | None = None, sdelta=None):
    """Compacted sender batch `jb`: rows with rank in [lo, lo+scap) land at
    rank-relative positions via one scatter (trash cell at scap, sliced
    off).  Returns (sids, stoff, svalid) of width scap; with `sdelta`
    (int32 (ccap, W), the lanes' new rumor words) a fourth value, each
    compacted sender's word row."""
    if lo is None:
        lo = jb * scap
    dev = senders.device
    pos = srank - lo
    sel = senders & (pos >= 0) & (pos < scap)
    idx = torch.where(sel, pos, scap)
    buf = torch.zeros(scap + 1, dtype=I32, device=dev)
    buf.index_put_((idx.long(),),
                   torch.where(sel, spacked, torch.zeros_like(spacked)))
    buf = buf[:scap]
    sids = buf // b
    stoff = buf - sids * b
    svalid = torch.arange(scap, dtype=I32, device=dev) < (scnt - lo)
    if sdelta is None:
        return sids, stoff, svalid
    bufw = torch.zeros((scap + 1, sdelta.shape[1]), dtype=I32, device=dev)
    bufw.index_put_((idx.long(),), torch.where(sel[:, None], sdelta, 0))
    return sids, stoff, svalid, bufw[:scap]


def _remove_draw(flags, base_key, removal_p, sticks, ids, live, n):
    """SIR removal draw per sender at its send tick (removal after send):
    sets REMOVED in place and returns the trigger mask live & ~removed."""
    if removal_p > 0.0:
        rk = _sender_keys(base_key, _rng.OP_REMOVE, sticks,
                          torch.where(live, ids, n))
        rem = _rng.bernoulli(rk, removal_p) & live
        idx = torch.where(rem, ids, n).long()
        pre = flags[idx.clamp_max(n - 1)]
        flags.index_put_((idx,), torch.where(rem, pre | REMOVED,
                                             torch.zeros_like(pre)))
    else:
        rem = torch.zeros_like(live)
    return live & ~rem


# --- window step -------------------------------------------------------------


def apply_fault_window_flags(cfg: Config, st, ids_global, base_key,
                             nticks: int):
    """The scenario's crash, churn and recovery over the window [st.tick,
    st.tick + nticks) (``scenario.fault_window``) on the crashed bit of
    ``st.flags[:n]``, in place; recovery clears only the crashed bit (a
    recovered node keeps its received and removed history).  Updates
    st.down_since; returns (d_crash, d_recover), int64 0-d, or (0, 0)
    when the scenario has no fault events."""
    scen = cfg.scenario_resolved
    if not scen.has_faults:
        return 0, 0
    n = ids_global.shape[0]
    f = st.flags[:n]
    new_crash, recover, st.down_since, dc, drc = _scen.fault_window(
        scen, cfg.n, st.tick, nticks, ids_global, (f & CRASHED) > 0,
        st.down_since, base_key)
    f = torch.where(recover, f & (0xFF ^ CRASHED), f)
    st.flags[:n] = torch.where(new_crash, f | CRASHED, f)
    return dc, drc


def make_window_step_fn(cfg: Config, n_local: int | None = None):
    """One B-tick window transition, in place: the scenario's faults at the
    window's start, then drain this window's slot in chunks
    (drain_chunk_core) and append the new senders' broadcasts at their
    delivery ticks."""
    b = batch_ticks(cfg)
    dw = ring_windows(cfg)
    ccap = drain_chunk(cfg, n_local)
    tail = ring_tail(cfg, n_local)
    crash_p = epidemic.p_eff(cfg, cfg.crashrate)
    sir = cfg.protocol == "sir"
    removal_p = epidemic.p_eff(cfg, cfg.removal_rate) if sir else 0.0
    scap = sender_compaction_cap(cfg, ccap)
    suppress = cfg.dup_suppress_resolved
    dkern = cfg.deliver_kernel_resolved
    p2 = cfg.phase2_kernel_resolved
    scen = cfg.scenario_resolved
    # The drain honors crashed bits at crash_p 0 once faults can set them;
    # reception crashes stamp the crash clock when it is carried.
    track_crashed = cfg.faults_enabled
    track_down = cfg.faults_enabled and crash_p > 0.0
    # Multi-rumor: the payload words ride beside every entry, and the step
    # injects the window's rumors (the seed is an identity).
    multi = cfg.multi_rumor

    def append(st, base_key, sids, svalid, sticks, strig, sw=None):
        out = append_messages(
            cfg, st.mail_ids, st.mail_cnt, st.mail_dropped, sids, svalid,
            sticks, st.friends, base_key, strig=strig,
            flags=st.flags if suppress else None, kernel=dkern, phase2=p2,
            swords=sw, mail_words=st.mail_words if multi else None)
        st.mail_dropped, sa, blk = out[2:5]
        st.sup_cnt += sa[None, :]
        if scen.has_partitions:
            st.part_dropped += blk

    def inject(st, base_key, cap: int) -> None:
        """The window's injections, appended before the slot count is
        read, so a rumor due this window drains (and its source starts
        forwarding) this window."""
        pay, words, wslot, valid = injection_batch(cfg, st.tick, base_key,
                                                   b, dw)
        dropped = torch.zeros((), dtype=I32, device=st.mail_ids.device)
        mailbox.ring_append((st.mail_ids, st.mail_words), st.mail_cnt,
                            dropped, (pay, words), wslot, valid, dw, cap,
                            kernel=dkern)
        st.mail_dropped += dropped

    def step_fn(st: EventState, base_key: torch.Tensor) -> EventState:
        n = st.friends.shape[0]
        dev = st.mail_ids.device
        w = st.tick // b
        slot = w % dw
        cap = (st.mail_ids.shape[0] - tail) // dw
        if multi:
            inject(st, base_key, cap)
        # One host read per window step: the slot's entry count (and,
        # under suppression, the received count that gates pre-drain).
        m, recv = (int(x) for x in torch.stack(
            [st.mail_cnt[0, slot].to(I64), st.total_received]).tolist())
        dm = st.sup_cnt[0, slot].to(I64)
        dsc, dsr = apply_fault_window_flags(
            cfg, st, torch.arange(n, dtype=I32, device=dev), base_key, b)
        if suppress and recv >= int(PREDRAIN_MIN_RECV_FRAC * n):
            _, kept, fdat = predrain_compact(b, n, dw, cap, ccap, sir,
                                             st.flags, st.mail_ids, slot, m)
            m = int(kept)
            dm = dm + fdat
        ckey = _rng.tick_key(base_key, w, _rng.OP_CRASH)
        dr = torch.zeros((), dtype=I64, device=dev)
        dc = torch.zeros((), dtype=I64, device=dev)
        rrecv = torch.zeros_like(st.rumor_recv) if multi else None
        lane = torch.arange(ccap, dtype=I32, device=dev)
        for j in range((m + ccap - 1) // ccap):
            off0 = j * ccap
            entry_pos = off0 + lane
            evalid = entry_pos < m
            start = slot * cap + off0
            packed = st.mail_ids[start:start + ccap]
            rw = {}
            if multi:
                rw = dict(words=st.mail_words[start:start + ccap],
                          rumor_words=st.rumor_words)
            out = drain_chunk_core(
                crash_p, b, n, st.flags, packed, evalid, entry_pos, ckey,
                sir=sir, track_crashed=track_crashed,
                down_since=st.down_since if track_down else None,
                win_tick=st.tick, **rw)
            _, cdm, cdr, cdc, ids_s, toff_s, senders = out[:7]
            delta_w = None
            if multi:
                delta_w = out[7]
                rrecv += out[8]
            dm, dr, dc = dm + cdm, dr + cdr, dc + cdc
            if scap:
                # Compact senders to <= scap-row batches, then append at
                # reduced width: same (tick, row)-keyed streams, same
                # reservation order, so the same mail layout.
                srank = torch.cumsum(senders, dim=0, dtype=I32) - 1
                scnt = int(senders.sum())  # host read: batch schedule
                spacked = ids_s * b + toff_s
                for width, lo in batch_schedule(scnt, scap):
                    sids, stoff, svalid, *sw = sender_batch(
                        senders, srank, scnt, spacked, b, width, 0, lo=lo,
                        sdelta=delta_w)
                    sticks = w * b + stoff
                    strig = None
                    if sir:
                        strig = _remove_draw(st.flags, base_key, removal_p,
                                             sticks, sids, svalid, n)
                    append(st, base_key, sids, svalid, sticks, strig,
                           sw[0] if sw else None)
                continue
            # Dense append (low-degree configs): senders in ascending-id
            # order, the same reservation order compaction would give.
            sticks = w * b + toff_s
            strig = None
            if sir:
                strig = _remove_draw(st.flags, base_key, removal_p,
                                     sticks, ids_s, senders, n)
            append(st, base_key, torch.where(senders, ids_s, 0), senders,
                   sticks, strig, delta_w)
        # Appends during this drain target later windows only (delay >=
        # B), so the slot accrued nothing new before it is zeroed.  The
        # slot's stale words are never read: later appends rewrite the
        # [0, count) prefix and the drain zeroes the lanes past it.
        st.mail_cnt[0, slot] = 0
        st.sup_cnt[0, slot] = 0
        st.tick += b
        if multi:
            # Stamped at the window's end tick.
            st.rumor_recv += rrecv
            stamp_rumor_done(cfg, st.rumor_recv, st.rumor_done, st.tick)
        st.total_message += dm
        st.total_received += dr
        st.total_crashed += dc
        if scen.has_faults:
            st.scen_crashed += dsc
            st.scen_recovered += dsr
        return st

    return step_fn


def make_seed_fn(cfg: Config):
    """Uniform-random sender's initial broadcast (simulator.go:240-241),
    through a dedicated one-sender append keyed at SEED_TICK so its draws
    do not depend on tick-0 window state.  An identity under the rumor
    axis: the window step injects every source."""

    if cfg.multi_rumor:
        # The window step injects the sources (injection_batch).
        def seed_noop(st: EventState, base_key: torch.Tensor) -> EventState:
            return st

        return seed_noop

    def seed_fn(st: EventState, base_key: torch.Tensor) -> EventState:
        n, k = st.friends.shape
        dev = st.mail_ids.device
        b = batch_ticks(cfg)
        dw = ring_windows(cfg)
        cap = (st.mail_ids.shape[0] - ring_tail(cfg, n)) // dw
        ks = _rng.tick_key(base_key, epidemic.SEED_TICK, _rng.OP_SEED_NODE)
        kd = _rng.tick_key(base_key, epidemic.SEED_TICK, _rng.OP_DELAY)
        kp = _rng.tick_key(base_key, epidemic.SEED_TICK, _rng.OP_DROP)
        sender = int(_rng.randint(ks, (), 0, n))
        if cfg.protocol == "sir" or not cfg.compat_reference:
            # Reference quirk: the seed itself is never marked received;
            # it is counted unless compat is requested.  SIR always marks
            # it (trigger firing requires the received bit).
            st.flags[sender] = RECEIVED
            st.total_received += 1
        sf = st.friends[sender]
        scnt = st.friend_cnt[sender]
        delay = max(int(_rng.randint(_rng.fold_in(kd, sender), (),
                                     cfg.delaylow, cfg.delayhigh)), 1)
        drop = _rng.bernoulli_masked(_rng.fold_in(kp, sender),
                                     epidemic.p_eff(cfg, cfg.droprate), (k,))
        arrive = st.tick + delay
        wslot = (arrive // b) % dw
        edge = (torch.arange(k, device=dev) < scnt) & ~drop & (sf >= 0)
        scen = cfg.scenario_resolved
        if scen.has_partitions:
            blocked = _scen.partition_blocked(scen, cfg.n, st.tick, sender,
                                              sf) & edge
            st.part_dropped += blocked.sum()
            edge = edge & ~blocked
        payload = sf * b + arrive % b
        cols = torch.cumsum(edge, dim=0, dtype=I32) - 1
        ec = edge.sum(dtype=I32)
        if cfg.protocol == "sir":
            kr = _rng.tick_key(base_key, epidemic.SEED_TICK, _rng.OP_REMOVE)
            keep = ~_rng.bernoulli_masked(
                kr, epidemic.p_eff(cfg, cfg.removal_rate), ())
            tb = trigger_base(n, b)
            cols = torch.cat([cols, ec[None]])
            edge = torch.cat([edge, keep[None]])
            payload = torch.cat([payload, torch.tensor(
                [tb + sender * b + arrive % b], dtype=I32, device=dev)])
            ec = ec + keep.to(I32)
        ec = int(ec)
        base = int(st.mail_cnt[0, wslot])
        ok = base + ec <= cap
        lanes = torch.arange(edge.shape[0], dtype=I32, device=dev)
        live = edge if ok else torch.zeros_like(edge)
        flat = torch.where(live, wslot * cap + base + cols, dw * cap + lanes)
        st.mail_ids.index_put_((flat.long(),), torch.where(
            edge, payload, torch.zeros_like(payload)))
        if ok:
            st.mail_cnt[0, wslot] += ec
        else:
            st.mail_dropped += ec
        return st

    return seed_fn


def make_heal_fn(cfg: Config, n_local: int | None = None):
    """The event engine's overlay healing (None when -overlay-heal is
    off), in place: condemn dead friends (scenario.detect_dead), replace
    them through the phase-1 makeup draw, and append the infected healers'
    re-sends and the rejoin pulls' responses into the mail ring at their
    drawn arrival ticks (scenario.heal_and_wave): two ring appends of
    n * k lanes, one slot a row.  Under the rumor axis a re-send carries
    the healer's full rumor words and a pull response the friend's."""
    if not cfg.overlay_heal_resolved:
        return None
    b = batch_ticks(cfg, n_local)
    dw = ring_windows(cfg, n_local)
    tail = ring_tail(cfg, n_local)
    detect = cfg.heal_detect_ms
    dkern = cfg.deliver_kernel_resolved
    multi = cfg.multi_rumor

    def heal_fn(st: EventState, base_key: torch.Tensor) -> EventState:
        n, k = st.friends.shape
        dev = st.mail_ids.device
        ids = torch.arange(n, dtype=I32, device=dev)
        f = st.flags[:n]
        crashed = (f & CRASHED) > 0
        detected = _scen.detect_dead(crashed, st.down_since, st.tick,
                                     detect)
        healer_ok = ~crashed
        sender_inf = ((f & RECEIVED) > 0) & ~crashed & ((f & REMOVED) == 0)
        bits = _scen.heal_peer_bits(detected, sender_inf)
        friends, resend, pull, delay, clear, rep, blk = _scen.heal_and_wave(
            cfg, st.friends, st.friend_cnt, bits, healer_ok, sender_inf,
            _scen.rejoined_mask(st.down_since), ids, st.tick, base_key)
        arrive = st.tick + delay  # per healer row, shared by its lanes
        wslot = ((arrive // b) % dw)[:, None].expand(n, k).reshape(-1)
        off = (arrive % b)[:, None]
        cap = (st.mail_ids.shape[0] - tail) // dw
        dropped = torch.zeros((), dtype=I32, device=dev)
        rings = (st.mail_ids,)
        spay = ((friends * b + off).reshape(-1),)
        # Rejoin pull responses deliver to the puller's own row.
        ppay = (((ids * b)[:, None] + off).expand(n, k).reshape(-1),)
        if multi:
            wc = st.rumor_words.shape[1]
            rings += (st.mail_words,)
            spay += (st.rumor_words[:n, None, :].expand(n, k, wc)
                     .reshape(-1, wc),)
            ppay += (st.rumor_words[torch.where(friends >= 0, friends, 0)
                                    .long()].reshape(-1, wc),)
        mailbox.ring_append(rings, st.mail_cnt, dropped, spay, wslot,
                            resend.reshape(-1), dw, cap, kernel=dkern)
        mailbox.ring_append(rings, st.mail_cnt, dropped, ppay, wslot,
                            pull.reshape(-1), dw, cap, kernel=dkern)
        st.friends = friends
        st.mail_dropped += dropped
        st.down_since = torch.where(clear, -1, st.down_since)
        st.heal_repaired += rep
        st.part_dropped += blk
        return st

    return heal_fn


def make_window_fn(cfg: Config, window: int):
    """Advance ~`window` simulated ms: ceil(window / B) window steps, then
    (-overlay-heal on) one healing pass, the cadence and tick keys of the
    JAX package's device loop."""
    step = make_window_step_fn(cfg)
    heal = make_heal_fn(cfg)
    steps = max(1, -(-window // batch_ticks(cfg)))

    def window_fn(st: EventState, base_key: torch.Tensor) -> EventState:
        for _ in range(steps):
            step(st, base_key)
        if heal is not None:
            heal(st, base_key)
        return st

    return window_fn


def make_run_to_coverage_fn(cfg: Config):
    """The run-to-target loop of the JAX package's device while_loop, as a
    host loop of poll windows: before each window, the target count (the
    worst rumor's under -rumors), the tick below max_rounds and below
    `until`, and a message in flight (not under -overlay-heal on, where
    healing can revive an empty ring; under -rumors also while the tick
    is at most the last injection's); then the window and its heal, and
    with a History one gossip_probe row.  The test reads its two device
    scalars in one host read a window; a window the JAX package's loop
    would not run is never run.  Under -telemetry-spatial on each row
    brings its panel rows (telemetry.record_window).  run_fn(st, key,
    target, until, hist) -> (st, hist)."""
    from gossip_simulator_tpu_torch.utils import telemetry as telem

    window = make_window_fn(cfg, 10)
    spatial = telem.spatial_spec(cfg)
    max_steps = cfg.max_rounds
    check_in_flight = not cfg.overlay_heal_resolved
    multi = cfg.multi_rumor
    rumors = cfg.rumors
    last_inj = cfg.last_inject_tick
    sir = cfg.protocol == "sir"

    def live(st: EventState, target_count: int, until: int) -> bool:
        if st.tick >= max_steps or st.tick >= until:
            return False
        recv = st.rumor_recv[:rumors].min() if multi else st.total_received
        if not check_in_flight:
            return int(recv) < target_count
        recv, alive = torch.stack([recv.to(I64),
                                   in_flight(st).to(I64)]).tolist()
        return recv < target_count and bool(
            alive or (multi and st.tick <= last_inj))

    def run_fn(st: EventState, base_key, target_count: int, until: int,
               hist=None):
        while live(st, target_count, until):
            window(st, base_key)
            if hist is not None:
                telem.record_window(hist, telem.gossip_probe(
                    st, sir, rumors=rumors if multi else 0), [st], spatial)
        return st, hist

    return run_fn


def removed_count(st) -> torch.Tensor:
    """SIR removed-node count, one O(n) reduction per poll; engine-agnostic:
    the event engine's flags bit2, or the ring engine's
    ``SimState.removed``."""
    if hasattr(st, "flags"):
        n = st.friends.shape[0]
        return ((st.flags[:n] & REMOVED) > 0).sum()
    return st.removed.sum()
