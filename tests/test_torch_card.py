"""The CUDA kernels against their plain versions, on the card.

The kernels have no CPU mode, so every test here skips on a host without
a card.  On the machine with the H100 (which has no jax), run

    python -m pytest --noconftest tests/test_torch_card.py -q

(``--noconftest``: the suite's conftest configures jax).  Inputs are made
with numpy from a seed; equality is exact."""

import numpy as np
import pytest
import torch

from gossip_simulator_tpu_torch import config as tcfg
from gossip_simulator_tpu_torch.models import event as tevent
from gossip_simulator_tpu_torch.ops import (deliver, graph, megakernel,
                                            overlay_kernel)
from gossip_simulator_tpu_torch.utils import rng as trng

T = torch.from_numpy


def _emit_inputs(seed, *, m=48, k=6, n=60, dw=3, cap=400, b=10, dup=False,
                 sir=False, dead=0.25, pad=0.1, base_hi=None, pm=None,
                 words=None):
    """Numpy inputs of one fused_emit call (test_torch_ops.py shares them):
    -1 padded friend columns, dead rows, a random ring and base counts;
    with `pm`, a partition mask with that share of its lanes set; with
    `words` = W, int32 (m, W) rumor words of the rows (every bit pattern)
    and a random (L, W) word ring (drawn last, so the other inputs do not
    depend on them)."""
    rng = np.random.default_rng(seed)
    kw = k + (1 if sir else 0)
    ring_len = dw * cap + m * kw + 7
    sf = rng.integers(0, n, (m, k)).astype(np.int32)
    sf[rng.random((m, k)) < pad] = -1
    d = dict(
        ring=rng.integers(0, 1000, ring_len).astype(np.int32),
        cnt=rng.integers(0, base_hi or cap // 2, (1, dw)).astype(np.int32),
        sf=sf, drop=rng.random((m, k)) < 0.2,
        svalid=rng.random(m) >= dead,
        wslot=rng.integers(0, dw, m).astype(np.int32),
        off=rng.integers(0, b, m).astype(np.int32))
    kwargs = dict(dw=dw, cap=cap, b=b)
    if dup:
        d["flags"] = (rng.random(n) < 0.5).astype(np.uint8)
    if sir:
        d["strig"] = d["svalid"] & (rng.random(m) < 0.8)
        d["sids"] = rng.integers(0, n, m).astype(np.int32)
        kwargs["tb"] = (n + 1) * b
    if pm is not None:
        d["pmask"] = rng.random((m, k)) < pm
    if words is not None:
        d["swords"] = rng.integers(-2**31, 2**31, (m, words),
                                   dtype=np.int64).astype(np.int32)
        d["wring"] = rng.integers(-2**31, 2**31, (ring_len, words),
                                  dtype=np.int64).astype(np.int32)
    return d, kwargs


def _emit(d, kw, dev, group=None, sync=True):
    """One fused_emit call (the card's `group` of threads a row, when
    given); its ring and outputs on the CPU (on `dev` without `sync`)."""
    ring = T(d["ring"].copy()).to(dev)
    args = [T(d[x]).to(dev) for x in ("cnt", "sf", "drop", "svalid",
                                      "wslot", "off")]
    opt = dict(strig=T(d["strig"]).to(dev) if "strig" in d else None,
               sender_ids=T(d["sids"]).to(dev) if "sids" in d else None,
               flags=T(d["flags"]).to(dev) if "flags" in d else None,
               pmask=T(d["pmask"]).to(dev) if "pmask" in d else None,
               received_bit=tevent.RECEIVED, **kw)
    if "swords" in d:
        opt.update(swords=T(d["swords"]).to(dev),
                   mail_words=T(d["wring"].copy()).to(dev))
    if group is None:
        out = megakernel.fused_emit(ring, *args, **opt)
    else:
        out = megakernel._launch(ring, *args, group=group,
                                 **dict(opt, tb=opt.get("tb")))
    return [x.cpu() for x in out] if sync else list(out)


def _same_emit(want, got):
    assert torch.equal(want[0], got[0])  # the ring
    assert torch.equal(want[1], got[1]) and torch.equal(want[2], got[2])
    assert int(want[3]) == int(got[3])
    assert int(want[4]) == int(got[4])  # the partition-blocked edges
    assert len(want) == len(got)
    if len(want) > 5:
        assert torch.equal(want[5], got[5])  # the word ring


EMIT_CASES = {
    "si": dict(), "si_dup": dict(dup=True), "sir": dict(sir=True),
    "sir_dup": dict(sir=True, dup=True),
    "overflow": dict(cap=60, base_hi=50), "dead_rows": dict(dead=0.7),
    "dw2": dict(dw=2), "dw3_k5": dict(dw=3, k=5),
    "dw8_m5000": dict(dw=8, m=5000, n=4000, cap=9000),
    "dw20_short_delays": dict(dw=20, m=3000, cap=400),
    # Widths past the old limits (ROADMAP C1): 40 ring slots (-delaylow 1
    # -delayhigh 40), 33 lanes (-fanout 32 SIR), 112 lanes (erdos SIR at
    # lam = 60, cap 111) and the slot limit itself.
    "dw40": dict(dw=40, m=3000, cap=400),
    "kw33_sir": dict(k=32, sir=True, m=2000, n=3000, cap=20_000),
    "kw112_sir": dict(k=111, sir=True, m=1000, n=3000, cap=60_000, pad=0.5),
    "dw40_kw112_dup": dict(dw=40, k=111, sir=True, dup=True, m=1000,
                           n=3000, cap=5000, pad=0.5),
    "dw1024": dict(dw=1024, m=20_000, n=5000, cap=60),
    # The single-pass kernel's tiles (EMIT_TILE = 256 senders a block): one
    # sender either side of a tile, many blocks, none; every row dead; one
    # ring slot; slots that fill in the middle of a block (a long suffix of
    # lost senders).
    "m255": dict(m=255, n=3000, cap=3000),
    "m256_sir": dict(m=256, n=3000, cap=3000, sir=True),
    "m257_dup": dict(m=257, n=3000, cap=3000, dup=True),
    "m65_kw65_sir": dict(m=65, k=64, sir=True, n=3000, cap=9000),
    "m0": dict(m=0),
    "many_blocks_sir_dup": dict(m=150_000, n=200_000, cap=400_000,
                                sir=True, dup=True),
    "all_dead": dict(m=3000, dead=1.0),
    "dw1": dict(dw=1, m=3000, cap=9000),
    "overflow_mid_block": dict(m=4000, cap=5000, base_hi=4000),
    # The scenario's partition mask (0 %, half and every lane blocked), with
    # and without the duplicate filter and the SIR trigger lane.
    "pm0": dict(pm=0.0, m=3000, n=3000, cap=9000),
    "pm50": dict(pm=0.5, m=3000, n=3000, cap=9000),
    "pm100": dict(pm=1.0, m=3000, n=3000, cap=9000),
    "pm50_dup": dict(pm=0.5, dup=True, m=3000, n=3000, cap=9000),
    "pm50_sir_dup": dict(pm=0.5, sir=True, dup=True, m=3000, n=3000,
                         cap=9000),
    "pm100_sir": dict(pm=1.0, sir=True, m=3000, n=3000, cap=9000),
    "pm50_kw112_sir": dict(pm=0.5, k=111, sir=True, m=1000, n=3000,
                           cap=60_000, pad=0.5),
    "pm50_many_blocks": dict(pm=0.5, m=150_000, n=200_000, cap=400_000),
    # Past 1024 ring slots (ROADMAP C1): the global form's tables; 1536
    # with a slot that overflows, 4096 with more tiles than the global
    # form's grid (264 blocks of 256 senders).
    "dw1025": dict(dw=1025, m=20_000, n=5000, cap=60),
    "dw1536_overflow": dict(dw=1536, m=20_000, n=5000, cap=40, base_hi=30),
    "dw1536_pm50_sir_dup": dict(dw=1536, pm=0.5, sir=True, dup=True,
                                m=20_000, n=5000, cap=60),
    "dw4096_blocks": dict(dw=4096, m=100_000, n=50_000, cap=400),
    # Multi-rumor traffic: W = 1, 2 and 32 (R = 1024) words a lane beside
    # the ids, with and without the partition mask, at slots that
    # overflow, past a tile, at wide rows (eight threads a row) and past
    # 1024 ring slots.
    "w1": dict(words=1, m=3000, n=3000, cap=9000),
    "w2": dict(words=2, m=3000, n=3000, cap=9000),
    "w32": dict(words=32, m=3000, n=3000, cap=9000),
    "w1_pm50": dict(words=1, pm=0.5, m=3000, n=3000, cap=9000),
    "w2_pm50_overflow": dict(words=2, pm=0.5, m=4000, cap=5000,
                             base_hi=4000),
    "w32_pm50": dict(words=32, pm=0.5, m=3000, n=3000, cap=9000),
    "w2_m257": dict(words=2, m=257, n=3000, cap=3000),
    "w2_many_blocks": dict(words=2, m=150_000, n=200_000, cap=400_000),
    "w2_kw33": dict(words=2, k=33, m=2000, n=3000, cap=20_000),
    "w32_kw112_pm50": dict(words=32, pm=0.5, k=112, m=1000, n=3000,
                           cap=60_000, pad=0.5),
    "w1_m0": dict(words=1, m=0),
    "w2_dw1536_pm50": dict(words=2, pm=0.5, dw=1536, m=20_000, n=5000,
                           cap=60),
}
# The kernel's two forms (threads a row): each at the widths it would not
# be chosen for as well.
FORM_CASES = ("si", "sir_dup", "overflow_mid_block", "kw33_sir", "kw112_sir",
              "dw40_kw112_dup", "m257_dup", "m65_kw65_sir", "dw1024",
              "pm50_sir_dup", "pm50_kw112_sir", "dw1536_pm50_sir_dup",
              "w2_pm50_overflow", "w32_kw112_pm50", "w2_dw1536_pm50")


def _ring_inputs(seed, *, m=300, dw=3, cap=200, base_hi=None, rings=2,
                 dead=0.2, width=None, base_lo=0):
    """Numpy inputs of one fused_ring_append call (test_torch_overlay.py
    shares them): random rings, base counts in [base_lo, base_hi), slots
    and dead lanes.  With `width` the second ring is wide, (dw*cap + 1,
    width) with (m, width) payload rows (PushSum's mass ring)."""
    rng = np.random.default_rng(seed)
    cols = [() if width is None or i == 0 else (width,)
            for i in range(rings)]
    d = dict(
        rings=[rng.integers(0, 1000, (dw * cap + 1,) + w).astype(np.int32)
               for w in cols],
        cnt=rng.integers(base_lo, base_hi or cap // 2, (1, dw)).astype(
            np.int32),
        pays=[rng.integers(0, 10**6, (m,) + w).astype(np.int32)
              for w in cols],
        wslot=rng.integers(0, dw, m).astype(np.int32),
        valid=rng.random(m) >= dead)
    return d, dict(dw=dw, cap=cap)


def _ring_append(fn, d, kw, dev):
    rings = tuple(T(r.copy()).to(dev) for r in d["rings"])
    cnt = T(d["cnt"].copy()).to(dev)
    dropped = torch.tensor(3, dtype=torch.int32, device=dev)
    fn(rings, cnt, dropped, tuple(T(p).to(dev) for p in d["pays"]),
       T(d["wslot"]).to(dev), T(d["valid"]).to(dev), **kw)
    return [r.cpu() for r in rings] + [cnt.cpu(), dropped.cpu()]


def _recv_inputs(seed, *, sources=4, rcap=300, fill=200, n=500, dw=3,
                 cap=400, b=10, base_hi=None, flags=False, width=None,
                 rumor=False):
    """Numpy inputs of one fused_recv_land call (test_torch_sharded.py
    shares them): a received wire buffer of `sources` buckets of `rcap`
    lanes, the first `fill` of each holding a wire word ``d*(dw*b) + w*b +
    o`` and the rest -1 (with `width`, (lanes, width) word rows, -1 in the
    empty slots), a random ring, base counts and, with `flags`, flags of
    n + 1 rows (the port's trash row last).  With `rumor` the word rows
    are rumor words, any 32 bits as int32: a quarter all ones (-1), a
    quarter bit 31 alone (rumor 31's bit), the rest random."""
    rng = np.random.default_rng(seed)
    m = sources * rcap
    live = np.arange(m) % rcap < fill
    wire = (rng.integers(0, n, m) * (dw * b) + rng.integers(0, dw, m) * b
            + rng.integers(0, b, m))
    length = dw * cap + 5
    d = dict(recv=np.where(live, wire, -1).astype(np.int32),
             ring=rng.integers(0, 1000, length).astype(np.int32),
             cnt=rng.integers(0, base_hi or cap // 2, (1, dw)).astype(
                 np.int32))
    if flags:
        d["flags"] = (rng.random(n + 1) < 0.5).astype(np.uint8)
    if width:
        rows = rng.integers(0, 2**16, (m, width))
        if rumor:
            kind = rng.integers(0, 4, (m, width))
            rows = np.select([kind == 0, kind == 1],
                             [-1, -2**31],
                             rng.integers(-2**31, 2**31, (m, width)))
        d["words"] = np.where(live[:, None], rows, -1).astype(np.int32)
        d["mail_words"] = rng.integers(0, 1000, (length, width)).astype(
            np.int32)
    return d, dict(dw=dw, cap=cap, b=b)


def _recv_land(fn, d, kw, dev):
    ring = T(d["ring"].copy()).to(dev)
    cnt = T(d["cnt"].copy()).to(dev)
    dropped = torch.tensor(3, dtype=torch.int32, device=dev)
    mw = T(d["mail_words"].copy()).to(dev) if "words" in d else None
    out = fn(ring, cnt, dropped, T(d["recv"]).to(dev),
             words=T(d["words"]).to(dev) if "words" in d else None,
             mail_words=mw,
             flags=T(d["flags"]).to(dev) if "flags" in d else None,
             received_bit=tevent.RECEIVED, **kw)
    return [x.cpu() for x in out]


def _drain_inputs(seed, *, n=500, c=12, cap=1000, dw=3, b=10, slot=1,
                  m=None, oob=0.05, neg=0.0, tail=64, rows=None, skip=None):
    """Numpy inputs of one PushSum drain: an (n, c) int32 limb accumulator,
    a ring of dw*cap + tail packed entries dst*b + off with its (L, c) mass
    rows (a third of the values zero), the live counts (m in the drained
    slot); `oob` of the entries decode to rows in [n, n + 50), `neg` of
    them are negative (rows below 0).  With `rows`, every entry's row is
    drawn from that list (before oob); with `skip` = (lo, hi), rows in
    [lo, hi) move to lo - 1."""
    rng = np.random.default_rng(seed)
    length = dw * cap + tail
    dst = rng.integers(0, n, length)
    if rows is not None:
        dst = np.asarray(rows)[rng.integers(0, len(rows), length)]
    if skip is not None:
        dst[(dst >= skip[0]) & (dst < skip[1])] = skip[0] - 1
    far = rng.random(length) < oob
    dst[far] = rng.integers(n, n + 50, int(far.sum()))
    ids = (dst * b + rng.integers(0, b, length)).astype(np.int32)
    below = rng.random(length) < neg
    ids[below] = -rng.integers(1, 10 * b, int(below.sum()))
    mass = rng.integers(0, 2**16, (length, c)).astype(np.int32)
    mass[rng.random((length, c)) < 0.33] = 0
    cnt = rng.integers(0, cap + 1, (1, dw)).astype(np.int32)
    cnt[0, slot] = cap * 7 // 10 if m is None else m
    return dict(acc=rng.integers(0, 2**16, (n, c)).astype(np.int32),
                ids=ids, mass=mass, cnt=cnt), dict(slot=slot, cap=cap, b=b)


def _drain(fn, d, kw, dev):
    """One drain with `fn` (megakernel.fused_drain_sum or
    drain_sum_plain); the accumulator on the CPU."""
    t = lambda x: T(x.copy()).to(dev)  # noqa: E731
    return fn(t(d["acc"]), t(d["ids"]), t(d["mass"]), t(d["cnt"]),
              kw["slot"], cap=kw["cap"], b=kw["b"]).cpu()


def _chunk_inputs(seed, *, m=400, nk=300, cap=4, sentinel=0.15, hot=0,
                  carry_hi=3, one_key=False, hot_carry=None, big=False):
    """Numpy inputs of one fused_chunk_step call: keys in [0, nk] (nk the
    sentinel), a carried count, optionally a hot key (7) past the cap,
    every live lane on it (`one_key`), or its carried count set to
    `hot_carry`.  With `big`, the mailbox (nk*cap + 1 cells) is left to
    ``_chunk_step`` to fill with -1 on the device."""
    rng = np.random.default_rng(seed)
    key = rng.integers(0, nk, m).astype(np.int32)
    if one_key:
        key[:] = 7
    key[rng.random(m) < sentinel] = nk
    if hot:
        key[rng.permutation(m)[:hot]] = 7
    count = rng.integers(0, carry_hi, nk + 1).astype(np.int32)
    if hot_carry is not None:
        count[7] = hot_carry
    mbox = None if big else rng.integers(-1, 50, nk * cap + 1).astype(
        np.int32)
    return dict(key=key, s=rng.integers(0, 10**6, m).astype(np.int32),
                mbox=mbox, count=count), dict(nk=nk, cap=cap)


def _chunk_step(fn, d, kw, rank_major, dev, out_dev="cpu"):
    if d["mbox"] is None:
        mbox = torch.full((kw["nk"] * kw["cap"] + 1,), -1, dtype=torch.int32,
                          device=dev)
    else:
        mbox = T(d["mbox"].copy()).to(dev)
    count = T(d["count"].copy()).to(dev)
    dropped = torch.tensor(5, dtype=torch.int32, device=dev)
    fn(mbox, count, dropped, T(d["key"]).to(dev), T(d["s"]).to(dev),
       rank_major=rank_major, **kw)
    return [mbox.to(out_dev), count.to(out_dev), dropped.to(out_dev)]


def _negotiate_inputs(seed, kind, *, n=700, k=6, fanout=5, fanin=6):
    """Numpy inputs of one fused_negotiate call: -1 padded friend rows of
    counts in [0, k], senders that are (often) friends, pre-drawn
    randomness as the callers draw it."""
    rng = np.random.default_rng(seed)
    cnt = rng.integers(max(fanout - 1, 0), k + 1, n).astype(np.int32)
    friends = rng.integers(0, 50, (n, k)).astype(np.int32)
    friends[np.arange(k)[None, :] >= cnt[:, None]] = -1
    col = rng.integers(0, k, n)
    src = np.where(rng.random(n) < 0.7, friends[np.arange(n), col],
                   rng.integers(0, 50, n)).astype(np.int32)
    src = np.maximum(src, 0)
    has = rng.random(n) < 0.8
    if kind == "makeup":
        draw = (rng.random(n) * np.maximum(cnt, 1)).astype(np.int32)
        limit = fanin
    else:
        draw = rng.integers(0, 50, n).astype(np.int32)
        limit = fanout
    return dict(friends=friends, cnt=cnt, src=src, has=has, draw=draw), \
        dict(kind=kind, limit=limit)


def _negotiate(fn, d, kw, dev):
    fr, cn = T(d["friends"].copy()).to(dev), T(d["cnt"].copy()).to(dev)
    _, _, reply = fn(fr, cn, T(d["src"]).to(dev), T(d["has"]).to(dev),
                     T(d["draw"]).to(dev), **kw)
    return [fr.cpu(), cn.cpu(), reply.cpu()]


def _request_inputs(seed, *, n=700, k=6, fanout=5):
    """Numpy inputs of one fused_request_round call: counts spread over
    0..k, -1 padded friend rows, self-patched peers w."""
    rng = np.random.default_rng(seed)
    cnt = rng.integers(0, k + 1, n).astype(np.int32)
    friends = rng.integers(0, n, (n, k)).astype(np.int32)
    friends[np.arange(k)[None, :] >= cnt[:, None]] = -1
    return dict(friends=friends, cnt=cnt,
                w=rng.integers(0, n, n).astype(np.int32)), fanout


def _request(fn, d, fanout, dev):
    fr, cn = T(d["friends"].copy()).to(dev), T(d["cnt"].copy()).to(dev)
    out = fn(fr, cn, T(d["w"]).to(dev), fanout=fanout)
    return [x.cpu() for x in out]


def _hosted_inputs(seed, r, m, live=0.5):
    """An int32[r, m] emission matrix, about `live` of it >= 0."""
    rng = np.random.default_rng(seed)
    mat = rng.integers(0, 10**6, (r, m)).astype(np.int32)
    mat[rng.random((r, m)) >= live] = -1
    return mat


def _spill_inputs(seed, *, m=400, nk=120, cap=3, scap=2000, scnt=0,
                  sentinel=0.1, carry_hi=3):
    """Numpy inputs of one spill-form chunk step: keys in [0, nk] with a
    carried count that overflows the cap, and a spill buffer holding
    `scnt` earlier pairs (-1 past them, the trash column included)."""
    d, kw = _chunk_inputs(seed, m=m, nk=nk, cap=cap, sentinel=sentinel,
                          carry_hi=carry_hi)
    rng = np.random.default_rng(seed + 1)
    pairs = np.full((2, scap + 1), -1, np.int32)
    pairs[0, :scnt] = rng.integers(0, 10**6, scnt)
    pairs[1, :scnt] = rng.integers(0, nk, scnt)
    d.update(pairs=pairs, scnt=scnt)
    return d, kw


def _spill_step(fn, d, kw, rank_major, dev):
    mbox, count = T(d["mbox"].copy()).to(dev), T(d["count"].copy()).to(dev)
    dropped = torch.tensor(5, dtype=torch.int32, device=dev)
    pairs = T(d["pairs"].copy()).to(dev)
    scnt = torch.tensor(d["scnt"], dtype=torch.int32, device=dev)
    fn(mbox, count, dropped, T(d["key"]).to(dev), T(d["s"]).to(dev),
       rank_major=rank_major, spill=(pairs, scnt), **kw)
    return [mbox.cpu(), count.cpu(), dropped.cpu(), pairs.cpu(), scnt.cpu()]


def _deposit_inputs(seed, *, b=3, n=500, k=4, rows=None, r=5, valid=0.7,
                    vals_hi=4, slots_out=0.0):
    """Numpy inputs of the ring engine's deposits: a (b, n) ring and its
    (b, n, r) rumor ring, m = rows * k lanes (row-major by sender) with
    slots in [0, b) (a `slots_out` share at -1 or b), the invalid lanes at
    dst = n, each sender's new-rumor bits, and an int32 (m, r) value matrix
    for fused_deposit_rows, a third of it zero; `vals_hi` past 2**30 makes
    the adds wrap."""
    rng = np.random.default_rng(seed)
    rows = n if rows is None else rows
    m = rows * k
    ok = rng.random(m) < valid
    dst = rng.integers(0, n, m).astype(np.int32)
    vals = rng.integers(-vals_hi, vals_hi, (m, r)).astype(np.int32)
    vals[rng.random((m, r)) < 0.33] = 0
    slots = rng.integers(0, b, m).astype(np.int32)
    out = rng.random(m) < slots_out
    slots[out] = np.where(rng.random(int(out.sum())) < 0.5, -1, b)
    return dict(
        pending=rng.integers(0, 5, (b, n)).astype(np.int32),
        prum=rng.integers(0, 5, (b, n, r)).astype(np.int32),
        slots=slots,
        dst=dst, valid=ok, dst_n=np.where(ok, dst, n).astype(np.int32),
        newbits=rng.random((rows, r)) < 0.4, vals=vals)


def _deposit(kind, fn, d, dev):
    """One deposit of `kind` (add, rows, both) with `fn`; the updated
    rings on the CPU."""
    t = lambda x: T(np.ascontiguousarray(x)).to(dev)  # noqa: E731
    if kind == "add":
        return [fn(t(d["pending"].copy()), t(d["slots"]),
                   t(d["dst_n"])).cpu()]
    if kind == "rows":
        return [fn(t(d["prum"].copy()), t(d["slots"]), t(d["dst_n"]),
                   t(d["vals"])).cpu()]
    out = fn(t(d["pending"].copy()), t(d["prum"].copy()), t(d["dst"]),
             t(d["slots"]), t(d["valid"]), t(d["newbits"]))
    return [x.cpu() for x in out]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode); "
                    "python3 chip_smoke.py runs them on the H100")
    return torch.device("cuda")


@pytest.mark.parametrize("case", sorted(EMIT_CASES))
@pytest.mark.parametrize("seed", (7, 8))
def test_fused_emit_kernel_matches_plain_on_card(case, seed):
    dev = _card()
    d, kw = _emit_inputs(seed, **EMIT_CASES[case])
    _same_emit(_emit(d, kw, torch.device("cpu")), _emit(d, kw, dev))
    if case == "overflow_mid_block":
        assert int(_emit(d, kw, torch.device("cpu"))[3]) > 0


@pytest.mark.parametrize("group", (1, 8))
@pytest.mark.parametrize("case", FORM_CASES)
def test_fused_emit_every_form_matches_plain_on_card(case, group):
    """A thread a row and eight threads a row: one result."""
    dev = _card()
    d, kw = _emit_inputs(9, **EMIT_CASES[case])
    _same_emit(_emit(d, kw, torch.device("cpu")),
               _emit(d, kw, dev, group=group))


def test_fused_emit_epoch_wrap_matches_plain_on_card(monkeypatch):
    """With APPEND_EPOCH_MAX lowered to 3, every second call wraps: the
    workspace is zeroed and the epoch starts at 1 again, so look-back
    words left by the last cycle (published, wrong counts) are never read
    as the new call's."""
    dev = _card()
    monkeypatch.setattr(deliver, "APPEND_EPOCH_MAX", 3)
    card = torch.device("cuda", torch.cuda.current_device())
    stream = deliver._stream(card.index)
    ws, _ = deliver.workspace(card, stream, deliver.workspace_words(
        20_000, 40, megakernel.EMIT_TILE))
    stale = ((1 << 2 | 2) << 32) | 12345  # epoch 1, flag P, count 12345
    ws.fill_(stale)
    ws[:deliver.APPEND_WS_HEAD] = 0  # the head as every call leaves it
    deliver._WS[card.index, stream][1] = 2
    epochs = []
    for seed in range(5):
        d, kw = _emit_inputs(60 + seed, **EMIT_CASES["dw40"])
        _same_emit(_emit(d, kw, torch.device("cpu")), _emit(d, kw, card))
        epochs.append(deliver._WS[card.index, stream][1])
    assert epochs == [1, 2, 1, 2, 1]


def test_global_form_calls_of_other_depths_match_plain_on_card():
    """Past 1024 slots the appends' tables and sums share the workspace's
    second part: a deep call on a one-block grid, a shallower one whose
    264 blocks' tables cover where the first call's sums lie, then the
    first again (its sums zeroed before it), each against its plain
    version."""
    dev = _card()
    for dw, m, kind in ((4096, 200, "emit"), (1536, 600_000, "ring"),
                        (4096, 200, "emit"), (2048, 300_000, "emit")):
        if kind == "emit":
            d, kw = _emit_inputs(dw + m, m=m, dw=dw, n=3000, cap=5,
                                 sir=True, dup=True, pm=0.3)
            _same_emit(_emit(d, kw, torch.device("cpu")), _emit(d, kw, dev))
        else:
            d, kw = _ring_inputs(dw, m=m, dw=dw, cap=2 * m // dw,
                                 width=12)
            want = _ring_append(deliver.ring_append_plain, d, kw,
                                torch.device("cpu"))
            got = _ring_append(deliver.fused_ring_append, d, kw, dev)
            for w, g in zip(want, got):
                assert torch.equal(w, g)


def test_emit_ring_append_and_recv_land_interleaved_match_plain_on_card():
    """fused_emit, fused_ring_append and fused_recv_land take one
    workspace per stream: calls of all three, interleaved on one stream
    with no synchronise between them, each against its plain version."""
    dev = _card()
    emits = [_emit_inputs(seed, **EMIT_CASES[case]) for seed, case in (
        (71, "many_blocks_sir_dup"), (72, "overflow_mid_block"),
        (73, "dw40_kw112_dup"))]
    rings = [_ring_inputs(seed, m=25_000, cap=10_000,
                          width=12 if seed % 2 else None)
             for seed in (74, 75, 76)]
    recvs = [_recv_inputs(seed, sources=8, rcap=3000, fill=2500, cap=8000)
             for seed in (77, 78, 79)]
    ring_args = [_on_card(d, dev) for d, _ in rings]
    recv_args = [dict(ring=T(d["ring"].copy()).to(dev),
                      cnt=T(d["cnt"].copy()).to(dev),
                      dropped=torch.tensor(3, dtype=torch.int32, device=dev),
                      recv=T(d["recv"]).to(dev)) for d, _ in recvs]
    torch.cuda.synchronize()
    outs = []
    for (de, kwe), (d, kw), a, (dr, kwr), b in zip(emits, rings, ring_args,
                                                   recvs, recv_args):
        outs.append((_emit(de, kwe, dev, sync=False),
                     megakernel.fused_recv_land(b["ring"], b["cnt"],
                                                b["dropped"], b["recv"],
                                                **kwr)))
        deliver.fused_ring_append(*a, **kw)
    torch.cuda.synchronize()
    for (de, kwe), (d, kw), a, (dr, kwr), (emitted, landed) in zip(
            emits, rings, ring_args, recvs, outs):
        _same_emit(_emit(de, kwe, torch.device("cpu")),
                   [x.cpu() for x in emitted])
        _same_as_plain(d, kw, a)
        want = _recv_land(megakernel.recv_land_plain, dr, kwr,
                          torch.device("cpu"))
        for x, y in zip(want, landed):
            assert torch.equal(x, y.cpu())


def test_fused_unique_set_kernel_matches_plain_on_card():
    dev = _card()
    rng = np.random.default_rng(0)
    ring = rng.integers(-50, 50, 5000).astype(np.int32)
    flat = rng.permutation(5000)[:1800].astype(np.int32)
    vals = rng.integers(0, 10**6, 1800).astype(np.int32)
    want = deliver.fused_unique_set(T(ring.copy()), T(flat), T(vals))
    got = deliver.fused_unique_set(T(ring).to(dev), T(flat).to(dev),
                                   T(vals).to(dev))
    assert torch.equal(want, got.cpu())


@pytest.mark.parametrize("m,w", ((0, 1), (1, 1), (1800, 1), (1801, 2),
                                 (786_431, 1), (786_432, 2), (50_000, 32)))
def test_fused_unique_set_word_ring_matches_plain_on_card(m, w):
    """The tuple form: the id ring and the (L, W) word ring at the same
    unique cells in one launch, W = 1, 2 and 32 (R = 1024)."""
    dev = _card()
    rng = np.random.default_rng(m + w)
    size = 2 * m + 8
    ring = rng.integers(-50, 50, size).astype(np.int32)
    wring = rng.integers(-2**31, 2**31, (size, w),
                         dtype=np.int64).astype(np.int32)
    flat = rng.permutation(size)[:m].astype(np.int32)
    vals = rng.integers(0, 10**6, m).astype(np.int32)
    wvals = rng.integers(-2**31, 2**31, (m, w),
                         dtype=np.int64).astype(np.int32)
    want = deliver.fused_unique_set((T(ring.copy()), T(wring.copy())),
                                    T(flat), (T(vals), T(wvals)))
    got = deliver.fused_unique_set(
        (T(ring).to(dev), T(wring).to(dev)), T(flat).to(dev),
        (T(vals).to(dev), T(wvals).to(dev)))
    for x, y in zip(want, got):
        assert torch.equal(x, y.cpu())


@pytest.mark.parametrize("m,flat_off,vals_off", (
    (1, 0, 0), (1799, 0, 0), (786_431, 0, 0), (1800, 1, 1), (1800, 1, 0),
    (1800, 3, 2)))
def test_fused_unique_set_edges_match_plain_on_card(m, flat_off, vals_off):
    """m = 1, m not a multiple of 4, and flat and vals as views that start
    off a 16-byte boundary, alike (the vector path after a scalar head) or
    not (the scalar path)."""
    dev = _card()
    rng = np.random.default_rng(m)
    size = 2 * m + 8
    ring = rng.integers(-50, 50, size).astype(np.int32)
    flat = np.zeros(m + 4, np.int32)
    flat[flat_off:flat_off + m] = rng.permutation(size)[:m]
    vals = rng.integers(0, 10**6, m + 4).astype(np.int32)
    fv = T(flat)[flat_off:flat_off + m]
    vv = T(vals)[vals_off:vals_off + m]
    want = deliver.fused_unique_set(T(ring.copy()), fv, vv)
    got = deliver.fused_unique_set(T(ring).to(dev),
                                   T(flat).to(dev)[flat_off:flat_off + m],
                                   T(vals).to(dev)[vals_off:vals_off + m])
    assert torch.equal(want, got.cpu())


RING_CASES = {
    "two_rings": dict(), "one_ring": dict(rings=1),
    "overflow": dict(cap=60, base_hi=50), "dw8": dict(dw=8, m=3000),
    "dw20_short_delays": dict(dw=20, m=3000, cap=300),
    "wide": dict(m=262_144, cap=200_000, base_hi=100_000),
    # PushSum's mass ring beside the id ring: dim 1, 2 and 8.
    "mass_w8": dict(width=8, m=5000, cap=4000),
    "mass_w12_overflow": dict(width=12, m=3000, cap=900, base_hi=800),
    "mass_w36": dict(width=36, m=70_000, cap=60_000, base_hi=20_000),
    # Past the old 32-slot limit (ROADMAP C1), and the slot limit itself.
    "dw40": dict(dw=40, m=3000, cap=300),
    "dw40_mass_w12": dict(dw=40, width=12, m=5000, cap=200, base_hi=150),
    "dw1024": dict(dw=1024, m=50_000, cap=100),
    # Every lane invalid; every lane past its slot's capacity (a count at
    # or above cap); no lane, one, and one past a 2048-lane block.
    "all_invalid": dict(dead=1.0, width=12),
    "all_overflow": dict(cap=50, base_lo=50, base_hi=60, width=12),
    "m0": dict(m=0), "m0_wide": dict(m=0, width=12),
    "m1": dict(m=1, width=12), "m2049": dict(m=2049, width=12),
    "m2049_all_land": dict(m=2049, dead=0.0, cap=5000, width=8),
    # Past 1024 slots with more tiles than the global form's grid (264
    # blocks of 2048 lanes): blocks take several tiles each.
    "dw1536_tiles_700": dict(dw=1536, m=1_433_600, cap=1000, width=12),
    "dw4096_one_ring": dict(dw=4096, rings=1, m=600_000, cap=150),
}
# The slot counts and row widths the port's rings take: dw 1 (one delay),
# 3 (the default), 40, 512 (slot counts whose shared memory passes 48 KB
# only with the static staging list), the shared form's limit and past it
# (ROADMAP C1: the global form); one column (a 2-D ring of one) and
# PushSum's 8, 12 and 36 limbs.  Slots fill and some overflow.
for _dw in (1, 3, 40, 512, 1024, 1025, 1536, 4096):
    for _w1 in (1, 8, 12, 36):
        RING_CASES[f"dw{_dw}_w{_w1}"] = dict(
            dw=_dw, width=_w1, m=5000, cap=2 * 5000 // _dw + 5)
# The multi-rumor word ring beside the id ring (W = 1, 2, 32 words a
# lane): the injection batch (a few lanes, most of them invalid), the
# heal's n * k lanes, and a stream's ring past 1024 slots.
RING_CASES.update({
    "inject_w1": dict(width=1, m=3, dead=0.5, cap=400_000),
    "inject_w2": dict(width=2, m=16, dead=0.7, cap=400_000),
    "heal_w1": dict(width=1, m=140_000, dead=0.95, cap=400_000),
    "heal_w2": dict(width=2, m=140_000, dead=0.95, cap=400_000),
    "heal_w32": dict(width=32, m=70_000, dead=0.9, cap=40_000),
    "dw1536_inject_w2": dict(dw=1536, width=2, m=16, dead=0.5, cap=50),
})


@pytest.mark.parametrize("case", sorted(RING_CASES))
def test_fused_ring_append_kernel_matches_plain_on_card(case):
    dev = _card()
    d, kw = _ring_inputs(11, **RING_CASES[case])
    want = _ring_append(deliver.ring_append_plain, d, kw, torch.device("cpu"))
    got = _ring_append(deliver.fused_ring_append, d, kw, dev)
    for w, g in zip(want, got):
        assert torch.equal(w, g)


def _on_card(d, dev):
    """fused_ring_append's arguments on the card (rings and counts fresh)."""
    return [tuple(T(r.copy()).to(dev) for r in d["rings"]),
            T(d["cnt"].copy()).to(dev),
            torch.tensor(3, dtype=torch.int32, device=dev),
            tuple(T(p).to(dev) for p in d["pays"]), T(d["wslot"]).to(dev),
            T(d["valid"]).to(dev)]


def _same_as_plain(d, kw, a):
    want = _ring_append(deliver.ring_append_plain, d, kw, torch.device("cpu"))
    got = [r.cpu() for r in a[0]] + [a[1].cpu(), a[2].cpu()]
    for w, g in zip(want, got):
        assert torch.equal(w, g)


def test_fused_ring_append_epoch_wrap_matches_plain_on_card():
    """The call that takes the stream's epoch past APPEND_EPOCH_MAX - 1
    zeroes the workspace and starts at 1: look-back words left by the last
    cycle (here epoch 1, published, a wrong count) are never read as its
    own; the next call (epoch 2) is right too."""
    dev = _card()
    cases = [_ring_inputs(seed, m=20_000, cap=9000, width=12)
             for seed in (31, 32)]
    card = torch.device("cuda", torch.cuda.current_device())
    stream = deliver._stream(card.index)
    words = deliver.workspace_words(20_000, 3)
    ws, _ = deliver.workspace(card, stream, words)
    stale = ((1 << 2 | 2) << 32) | 12345  # epoch 1, flag P, count 12345
    ws.fill_(stale)
    ws[0] = 0  # the counters as every call leaves them
    ws[1:deliver.APPEND_WS_HEAD] = 0
    deliver._WS[card.index, stream][1] = deliver.APPEND_EPOCH_MAX - 1
    for d, kw in cases:
        a = _on_card(d, card)
        deliver.fused_ring_append(*a, **kw)
        _same_as_plain(d, kw, a)
    assert deliver._WS[card.index, stream][1] == 2


@pytest.mark.parametrize("streams", (1, 2))
def test_fused_ring_append_calls_in_flight_match_plain_on_card(streams):
    """Calls enqueued back to back with no synchronise between them, on one
    stream (one workspace: the counters left at 0, a new epoch a call) or
    on two streams (a workspace each), flat and wide, each on its own
    rings, against the plain version call by call."""
    dev = _card()
    cases = [_ring_inputs(seed, m=30_000, cap=12_000,
                          width=12 if seed % 2 else None)
             for seed in (41, 42, 43, 44)]
    cuda = [torch.cuda.current_stream(dev)] + [
        torch.cuda.Stream(dev) for _ in range(streams - 1)]
    args = [_on_card(d, dev) for d, _ in cases]
    torch.cuda.synchronize()
    for k, ((d, kw), a) in enumerate(zip(cases, args)):
        st = cuda[k % streams]
        st.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(st):
            deliver.fused_ring_append(*a, **kw)
    torch.cuda.synchronize()
    for (d, kw), a in zip(cases, args):
        _same_as_plain(d, kw, a)


def test_ring_append_and_recv_land_interleaved_match_plain_on_card():
    """fused_ring_append and fused_recv_land take one workspace per stream:
    calls of both, interleaved on one stream with no synchronise between
    them (epochs 1, 2, 3, ... whichever kernel runs), each against its
    plain version."""
    dev = _card()
    rings = [_ring_inputs(seed, m=25_000, cap=10_000,
                          width=12 if seed % 2 else None)
             for seed in (51, 52, 53)]
    recvs = [_recv_inputs(seed, sources=8, rcap=3000, fill=2500, cap=8000,
                          width=12 if seed % 2 else None)
             for seed in (54, 55, 56)]
    ring_args = [_on_card(d, dev) for d, _ in rings]
    recv_args = []
    for d, _ in recvs:
        recv_args.append(dict(
            ring=T(d["ring"].copy()).to(dev), cnt=T(d["cnt"].copy()).to(dev),
            dropped=torch.tensor(3, dtype=torch.int32, device=dev),
            recv=T(d["recv"]).to(dev),
            words=T(d["words"]).to(dev) if "words" in d else None,
            mail_words=(T(d["mail_words"].copy()).to(dev) if "words" in d
                        else None)))
    torch.cuda.synchronize()
    outs = []
    for (d, kw), a, (dr, kwr), b in zip(rings, ring_args, recvs, recv_args):
        deliver.fused_ring_append(*a, **kw)
        outs.append(megakernel.fused_recv_land(
            b["ring"], b["cnt"], b["dropped"], b["recv"], words=b["words"],
            mail_words=b["mail_words"], **kwr))
    torch.cuda.synchronize()
    for (d, kw), a in zip(rings, ring_args):
        _same_as_plain(d, kw, a)
    for (dr, kwr), out in zip(recvs, outs):
        want = _recv_land(megakernel.recv_land_plain, dr, kwr,
                          torch.device("cpu"))
        for x, y in zip(want, out):
            assert torch.equal(x, y.cpu())


# nk*cap + 1 just under 2**31 at cap 8: 28-bit keys, the flat limit.
FLAT_LIMIT_NK = (2**31 - 2) // 8
CHUNK_CASES = {
    "plain": dict(), "hot_key": dict(hot=60), "no_sentinel": dict(sentinel=0),
    "carried_past_cap": dict(carry_hi=6),
    "wide": dict(m=200_000, nk=400_000, cap=16, hot=5000),
    "one_key": dict(m=2**21, one_key=True),
    "single_lane": dict(m=1, sentinel=0),
    "all_sentinel": dict(sentinel=1.0),
    "hot_carried_past_cap": dict(hot=60, hot_carry=4),
    "nk_1e8": dict(m=300_000, nk=10**8, cap=8, hot=3000, big=True),
    "flat_limit": dict(m=300_000, nk=FLAT_LIMIT_NK, cap=8, hot=3000,
                       big=True),
}


@pytest.mark.parametrize("rank_major", (False, True))
@pytest.mark.parametrize("case", sorted(CHUNK_CASES))
def test_fused_chunk_step_kernel_matches_plain_on_card(case, rank_major):
    """The plain version runs on the CPU, or on the card for the cases
    whose mailbox is gigabytes (nk up to 2.7e8)."""
    dev = _card()
    d, kw = _chunk_inputs(12, **CHUNK_CASES[case])
    ref = dev if d["mbox"] is None else torch.device("cpu")
    want = _chunk_step(deliver.chunk_step_plain, d, kw, rank_major, ref,
                       out_dev=ref)
    got = _chunk_step(deliver.fused_chunk_step, d, kw, rank_major, dev,
                      out_dev=ref)
    for w, g in zip(want, got):
        assert torch.equal(w, g)


@pytest.mark.parametrize("n", (700, 1, 257, 100_003))
@pytest.mark.parametrize("kind", ("makeup", "breakup"))
def test_fused_negotiate_kernel_matches_plain_on_card(kind, n):
    dev = _card()
    d, kw = _negotiate_inputs(13, kind, n=n)
    want = _negotiate(overlay_kernel.negotiate_plain, d, kw,
                      torch.device("cpu"))
    got = _negotiate(overlay_kernel.fused_negotiate, d, kw, dev)
    for w, g in zip(want, got):
        assert torch.equal(w, g)


@pytest.mark.parametrize("k", (17, 20, 200))
@pytest.mark.parametrize("kind", ("makeup", "breakup"))
def test_fused_negotiate_wide_rows_match_plain_on_card(kind, k):
    """Rows wider than the register row (16 columns): -fanout 20's 21,
    and far past it (ROADMAP C1)."""
    dev = _card()
    d, kw = _negotiate_inputs(19, kind, n=5000, k=k, fanout=k - 1, fanin=k)
    want = _negotiate(overlay_kernel.negotiate_plain, d, kw,
                      torch.device("cpu"))
    got = _negotiate(overlay_kernel.fused_negotiate, d, kw, dev)
    for w, g in zip(want, got):
        assert torch.equal(w, g)


@pytest.mark.parametrize("n", (37, 4099, 1_000_003))
def test_fused_request_round_kernel_matches_plain_on_card(n):
    dev = _card()
    d, fanout = _request_inputs(14, n=n)
    want = _request(overlay_kernel.request_round_plain, d, fanout,
                    torch.device("cpu"))
    got = _request(overlay_kernel.fused_request_round, d, fanout, dev)
    for w, g in zip(want, got):
        assert torch.equal(w, g)


@pytest.mark.parametrize("shape,offset", (((1, 37), 0), ((3, 4099), 0),
                                          ((8, 1_000_000), 0),
                                          ((2, 40_000), 1)))
def test_fused_hosted_chunk_kernel_matches_plain_on_card(shape, offset):
    """Aligned rows take the 16-byte loads; `offset` shifts the matrix one
    int32 off that alignment (the scalar loads)."""
    dev = _card()
    mat = _hosted_inputs(15, *shape)
    flat = torch.empty(mat.size + offset, dtype=torch.int32, device=dev)
    flat[offset:] = T(mat.reshape(-1)).to(dev)
    got = overlay_kernel.fused_hosted_chunk(flat[offset:].view(shape))
    assert torch.equal(overlay_kernel.hosted_chunk_plain(T(mat)), got.cpu())


SPILL_CASES = {
    "room": dict(), "fills": dict(scap=9), "carried": dict(scap=40, scnt=30),
    "full_already": dict(scap=12, scnt=12),
    "wide": dict(m=300_000, nk=100_000, cap=2, scap=250_000, scnt=1000),
    "wide_fills": dict(m=300_000, nk=100_000, cap=2, scap=9000),
    # scap is set so that the spill fills on exactly its last overflow lane.
    "fills_on_last": dict(scnt=5, scap="exact"),
    "no_overflow": dict(cap=64),
}


def _overflow(seed, kw_case) -> int:
    """The number of overflowing lanes of a spill case (plain version)."""
    d, kw = _spill_inputs(seed, **dict(kw_case, scap=10**6))
    out = _spill_step(deliver.chunk_step_plain, d, kw, False,
                      torch.device("cpu"))
    return int(out[4]) - d["scnt"]


@pytest.mark.parametrize("rank_major", (False, True))
@pytest.mark.parametrize("case", sorted(SPILL_CASES))
def test_fused_chunk_step_spill_matches_plain_on_card(case, rank_major):
    dev = _card()
    kw_case = dict(SPILL_CASES[case])
    if kw_case.get("scap") == "exact":
        kw_case["scap"] = kw_case.get("scnt", 0) + _overflow(16, kw_case)
    d, kw = _spill_inputs(16, **kw_case)
    want = _spill_step(deliver.chunk_step_plain, d, kw, rank_major,
                       torch.device("cpu"))
    got = _spill_step(deliver.fused_chunk_step, d, kw, rank_major, dev)
    for w, g in zip(want, got):
        assert torch.equal(w, g)


@pytest.mark.parametrize("extra", (
    ["-graph", "overlay", "-fanout", "5", "-coverage-target", "0.9"],
    ["-graph", "overlay", "-overlay-mode", "rounds", "-fanout", "5",
     "-coverage-target", "0.9"],
    ["-graph", "overlay", "-overlay-mode", "rounds", "-fanout", "5",
     "-coverage-target", "0.9", "-mailbox-cap", "8",
     "-overlay-static-boot", "on"],
    ["-graph", "overlay", "-fanout", "5", "-coverage-target", "0.9",
     "-deliver-kernel", "xla", "-phase1-kernel", "xla"],
    # Short delays: dw = 11 ring slots in both engines.
    ["-graph", "overlay", "-fanout", "5", "-coverage-target", "0.9",
     "-delaylow", "2"], ["-delaylow", "2"],
    [], ["-crashrate", "0"],
    ["-protocol", "sir", "-removal-rate", "0.3", "-droprate", "0.3"],
    ["-phase2-kernel", "xla"],
    # The ring engine.
    ["-engine", "ring"], ["-engine", "ring", "-compact", "off"],
    ["-engine", "ring", "-protocol", "sir", "-removal-rate", "0.3"],
    ["-time-mode", "rounds"],
    ["-graph", "overlay", "-time-mode", "rounds", "-fanout", "5",
     "-coverage-target", "0.9"],
    ["-protocol", "pushpull", "-fanout", "11"],
    ["-engine", "ring", "-rumors", "16", "-crashrate", "0",
     "-coverage-target", "0.95"],
    ["-engine", "ring", "-rumors", "33", "-crashrate", "0",
     "-coverage-target", "0.95", "-phase2-kernel", "xla"],
    # PushSum: fused_drain_sum and the wide fused_ring_append; the chunked
    # drain through fused_deposit_rows (-event-chunk: several chunks).
    ["-model", "pushsum", "-droprate", "0", "-crashrate", "0"],
    # Static graph generation: erdos (SI, and SIR at lam = 60: 112 lanes
    # a sender), -pallas (kout_pallas, erdos_pallas), PushSum on erdos.
    ["-graph", "erdos", "-fanout", "8"],
    ["-graph", "erdos", "-er-p", "0.02", "-protocol", "sir"],
    ["-pallas"], ["-graph", "erdos", "-pallas", "-fanout", "8"],
    ["-graph", "erdos", "-pallas", "-er-p", "0.004", "-time-mode",
     "rounds"],
    ["-graph", "erdos", "-model", "pushsum", "-fanout", "8", "-droprate",
     "0", "-crashrate", "0", "-coverage-target", "0.95"],
    # Widths past the old kernel limits (ROADMAP C1).
    ["-graph", "overlay", "-fanout", "20", "-coverage-target", "0.9"],
    ["-delaylow", "1", "-delayhigh", "40"],
    ["-fanout", "32", "-protocol", "sir"],
    ["-model", "pushsum", "-droprate", "0", "-crashrate", "0",
     "-pushsum-dim", "8", "-phase2-kernel", "xla", "-event-chunk", "4096"],
    # Multi-rumor traffic on the event engine: fused_emit's word rows, the
    # word ring of fused_unique_set (-phase2-kernel xla) and of the
    # injection's and the heal's fused_ring_append; R = 40 (W = 2).
    ["-rumors", "16", "-crashrate", "0", "-coverage-target", "0.95"],
    ["-rumors", "40", "-coverage-target", "0.95", "-phase2-kernel", "xla"],
    ["-rumors", "64", "-traffic", "stream", "-stream-rate", "200",
     "-crashrate", "0", "-coverage-target", "0.95"],
    ["-rumors", "16", "-traffic", "stream", "-arrivals", "poisson",
     "-crashrate", "0", "-coverage-target", "0.95", "-telemetry", "off"],
    ["-rumors", "16", "-crashrate", "0", "-coverage-target", "0.99",
     "-max-rounds", "600", "-overlay-heal", "on", "-scenario",
     '{"groups": 2, "downtime": 60, "events": [{"type": "churn", '
     '"start": 0, "end": 150, "rate": 2.0}, {"type": "crash", "at": 30, '
     '"frac": 0.3, "group": 1}, {"type": "partition", "start": 20, '
     '"end": 60}]}']))
def test_run_on_card_matches_cpu(extra):
    """Each ported path on the card against its CPU twin: same transcript,
    same final leaves."""
    import io

    from gossip_simulator_tpu_torch import TorchStepper, run_simulation
    from gossip_simulator_tpu_torch.config import parse_cli
    from gossip_simulator_tpu_torch.utils.metrics import ProgressPrinter

    _card()
    outs, trees = [], []
    for device in ("cpu", "cuda"):
        cfg, _ = parse_cli(["-graph", "kout", "-n", "3000", "-fanout", "6",
                            "-seed", "2", *extra])  # later flags win
        buf = io.StringIO()
        st = TorchStepper(cfg, device=device)
        run_simulation(cfg, printer=ProgressPrinter(out=buf), stepper=st)
        outs.append(buf.getvalue())
        trees.append(st.state_pytree())
    assert outs[0] == outs[1]
    assert set(trees[0]) == set(trees[1])
    for key in trees[0]:
        assert np.array_equal(trees[0][key], trees[1][key]), key


@pytest.mark.parametrize("extra", (
    ["-graph", "overlay", "-fanout", "5", "-coverage-target", "0.9"],
    [], ["-model", "pushsum", "-droprate", "0", "-crashrate", "0"],
    ["-rumors", "16", "-crashrate", "0", "-coverage-target", "0.95"],
    ["-engine", "ring", "-protocol", "sir", "-removal-rate", "0.3"]))
def test_run_dir_on_card_matches_cpu(extra, tmp_path):
    """The run-to-target paths' records on the card against the CPU's:
    the same transcript (the summary's wall lines aside), the same
    telemetry.npz arrays and trajectory fingerprint."""
    import contextlib
    import io
    import json

    from gossip_simulator_tpu_torch.cli import main
    from gossip_simulator_tpu_torch.utils.artifact import load_run

    _card()
    outs, runs = [], []
    for device in ("cpu", "cuda"):
        rdir = tmp_path / device
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            main(["-graph", "kout", "-n", "3000", "-fanout", "6", "-seed",
                  "2", *extra, "-device", device, "-run-dir", str(rdir),
                  "-telemetry-summary"])
        outs.append([x for x in buf.getvalue().splitlines()
                     if not x.startswith(("phases:", "throughput:"))])
        runs.append(load_run(str(rdir)))
        json.load(open(rdir / "trace.json"))
    assert outs[0] == outs[1]
    (cpu, card) = runs
    assert card["result"]["fingerprint"] == cpu["result"]["fingerprint"]
    assert card["result"]["fingerprint_basis"] == "telemetry"
    assert card["env"]["backend_platform"] == "gpu"
    assert sorted(card["telemetry"]) == sorted(cpu["telemetry"])
    for key, arr in cpu["telemetry"].items():
        assert np.array_equal(card["telemetry"][key], arr), key


DEPOSIT_CASES = {
    "small": dict(), "r16": dict(r=16, n=700, k=6),
    "r33_two_words": dict(r=33, n=300, k=5),
    "r1024": dict(r=1024, n=40, k=3, rows=30),
    "wide": dict(b=20, n=100_000, k=6, rows=50_000, r=16),
    "wrap": dict(r=8, vals_hi=2**31 - 1),
    "all_invalid": dict(valid=0.0),
    # The row widths the warp-compacted deposit serves differently: one
    # word a thread (1, 17, 33), 16-byte pieces (12: PushSum's limbs, three
    # threads a lane; 16: four), a warp looping over a row (1024); lanes
    # with slots out of range; every lane out of range; negative values
    # that wrap.
    "r1": dict(r=1, n=700, k=6), "r12": dict(r=12, n=700, k=6),
    "r17": dict(r=17, n=300, k=5),
    "r12_pushsum_chunk": dict(b=1, n=20_000, k=1, rows=30_000, r=12,
                              valid=1.0, vals_hi=2**16),
    "r16_slots_out": dict(r=16, slots_out=0.3),
    "r12_all_out": dict(r=12, valid=0.0, slots_out=1.0),
    "r12_wrap": dict(r=12, vals_hi=2**31 - 1),
    # fused_deposit_both's bit rows: every lane kept (16-byte pieces), 40
    # rumors (two 32-column masks, bytes), a wide batch of one sender a
    # lane.
    "r16_all_kept": dict(r=16, n=700, k=6, valid=1.0),
    "r40": dict(r=40, n=500, k=5),
    "r32_one_lane_a_sender": dict(b=5, n=20_000, k=1, rows=40_000, r=32),
}
DEPOSIT_FNS = {
    "add": (deliver.deposit_add_plain, deliver.fused_deposit_add),
    "rows": (deliver.deposit_rows_plain, deliver.fused_deposit_rows),
    "both": (megakernel.deposit_both_plain, megakernel.fused_deposit_both),
}


@pytest.mark.parametrize("kind", sorted(DEPOSIT_FNS))
@pytest.mark.parametrize("case", sorted(DEPOSIT_CASES))
def test_fused_deposit_kernels_match_plain_on_card(case, kind):
    """fused_deposit_add, fused_deposit_rows and fused_deposit_both; the
    ring's flat offsets past 2**31 are reached by the chip_smoke.py
    parity shapes, not here."""
    dev = _card()
    d = _deposit_inputs(17, **DEPOSIT_CASES[case])
    plain, kernel = DEPOSIT_FNS[kind]
    want = _deposit(kind, plain, d, torch.device("cpu"))
    got = _deposit(kind, kernel, d, dev)
    for w, g in zip(want, got):
        assert torch.equal(w, g)


# fused_deposit_add in each form (the wrapper's crossover forced): (b, n,
# m, layout) with lanes drawn by _deposit_add_inputs; R cells a
# partition.
R_CELLS = 1 << deliver.DEPOSIT_PART_BITS
DEPOSIT_ADD_CASES = {
    "empty": (3, 20_000, 0, "random"),
    "all_out_of_range": (3, 20_000, 5_000, "out"),
    # All lanes in partition 0: its bucket (ceil(m / P) offsets) overflows
    # into the direct adds.
    "one_partition": (3, 20_000, 50_000, "one"),
    # Cells R - 1, R, R + 1, 2R - 1, 2R and the ring's last cells; b * n =
    # 90,000 is not a multiple of R.
    "edges": (3, 30_000, 30_000, "edges"),
    "both_slots": (2, 30_000, 90_000, "random"),
    "rounds_like": (2, 30_000, 180_000, "slot1"),
    "ragged_tail": (5, 9_999, 77_777, "random"),
}


def _deposit_add_inputs(seed, b, n, m, layout):
    """Numpy lanes of one fused_deposit_add call: slots, dst, a valid mask
    (70 % kept), dst_n (the invalid lanes at n) and a random ring."""
    rng = np.random.default_rng(seed)
    slots = rng.integers(0, b, m).astype(np.int32)
    dst = rng.integers(0, n, m).astype(np.int32)
    if layout == "out":
        slots = np.where(rng.random(m) < 0.5, -1, b).astype(np.int32)
    elif layout == "one":
        slots[:] = 0
        dst = rng.integers(0, min(n, R_CELLS), m).astype(np.int32)
    elif layout == "slot1":
        slots[:] = 1
    elif layout == "edges":
        cells = np.array([R_CELLS - 1, R_CELLS, R_CELLS + 1,
                          2 * R_CELLS - 1, 2 * R_CELLS, b * n - 2,
                          b * n - 1, 0], dtype=np.int64)
        pick = cells[rng.integers(0, cells.size, m)]
        slots, dst = (pick // n).astype(np.int32), (pick % n).astype(np.int32)
    valid = rng.random(m) < 0.7
    return dict(pending=rng.integers(0, 5, (b, n)).astype(np.int32),
                slots=slots, dst=dst, valid=valid,
                dst_n=np.where(valid, dst, n).astype(np.int32))


@pytest.mark.parametrize("masked", (False, True), ids=("dst_n", "valid"))
@pytest.mark.parametrize("form", ("direct", "dense"))
@pytest.mark.parametrize("case", sorted(DEPOSIT_ADD_CASES))
def test_fused_deposit_add_forms_match_plain_on_card(case, form, masked,
                                                     monkeypatch):
    """fused_deposit_add in the form forced by the crossover (0 lanes a
    cell: dense; none: direct) against deposit_add_plain, given the mask
    or the dst = n lanes; the dense form's overflow word counts the lanes
    a full bucket sent to the direct adds."""
    dev = _card()
    b, n, m, layout = DEPOSIT_ADD_CASES[case]
    d = _deposit_add_inputs(31, b, n, m, layout)
    monkeypatch.setattr(deliver, "DEPOSIT_DENSE_MIN",
                        0.0 if form == "dense" else float("inf"))
    assert (deliver.deposit_part_bits(m, b * n) > 0) == (form == "dense")
    t = lambda x: T(np.ascontiguousarray(x))  # noqa: E731
    args = ((t(d["dst"]), t(d["valid"])) if masked else (t(d["dst_n"]),
                                                         None))
    want = deliver.deposit_add_plain(t(d["pending"].copy()), t(d["slots"]),
                                     *args)
    dev = torch.device("cuda", torch.cuda.current_device())
    before = deliver.deposit_overflow(dev)
    got = deliver.fused_deposit_add(
        t(d["pending"].copy()).to(dev), t(d["slots"]).to(dev),
        *(None if a is None else a.to(dev) for a in args))
    assert torch.equal(want, got.cpu())
    lost = deliver.deposit_overflow(dev) - before
    if form == "dense" and layout == "one" and m:
        assert lost > 0
    elif form == "dense" and layout == "random":
        assert lost == 0


def test_fused_deposit_add_dense_calls_in_a_row_match_plain_on_card(
        monkeypatch):
    """The dense form's cursors are zeroed by the blocks that drain them:
    calls of other shapes in a row, on one stream and on a second, each
    bit-exact (a cursor left over would misplace the next call's
    lanes)."""
    dev = _card()
    monkeypatch.setattr(deliver, "DEPOSIT_DENSE_MIN", 0.0)
    side = torch.cuda.Stream()
    for i, case in enumerate(("rounds_like", "edges", "both_slots",
                              "one_partition", "ragged_tail",
                              "rounds_like")):
        d = _deposit_add_inputs(40 + i, *DEPOSIT_ADD_CASES[case])
        want = deliver.deposit_add_plain(
            T(d["pending"].copy()), T(d["slots"]), T(d["dst"]),
            T(d["valid"]))
        with torch.cuda.stream(side if i % 2 else
                               torch.cuda.current_stream()):
            got = deliver.fused_deposit_add(
                T(d["pending"].copy()).to(dev), T(d["slots"]).to(dev),
                T(d["dst"]).to(dev), T(d["valid"]).to(dev))
            torch.cuda.synchronize()
        assert torch.equal(want, got.cpu()), case


def test_fused_deposit_rows_unaligned_vals_match_plain_on_card():
    """Value rows that start off a 16-byte boundary (a contiguous view one
    word into its storage) take the word path at w = 12 and 16."""
    dev = _card()
    for r in (12, 16):
        d = _deposit_inputs(23, r=r, n=700, k=6)
        m = d["vals"].shape[0]
        flat = torch.zeros(m * r + 1, dtype=torch.int32, device=dev)
        vals = flat[1:].view(m, r)
        vals.copy_(T(d["vals"]))
        want = _deposit("rows", deliver.deposit_rows_plain, d,
                        torch.device("cpu"))
        got = deliver.fused_deposit_rows(
            T(d["prum"].copy()).to(dev), T(d["slots"]).to(dev),
            T(d["dst_n"]).to(dev), vals)
        assert torch.equal(want[0], got.cpu())


def test_fused_deposit_both_unaligned_bits_match_plain_on_card():
    """Bit rows that start off a 16-byte boundary (a contiguous view one
    byte into its storage) are read a byte at a time."""
    dev = _card()
    d = _deposit_inputs(29, r=16, n=700, k=6)
    rows = d["newbits"].shape[0]
    flat = torch.zeros(rows * 16 + 1, dtype=torch.bool, device=dev)
    bits = flat[1:].view(rows, 16)
    bits.copy_(T(d["newbits"]))
    want = _deposit("both", megakernel.deposit_both_plain, d,
                    torch.device("cpu"))
    t = lambda x: T(np.ascontiguousarray(x)).to(dev)  # noqa: E731
    got = megakernel.fused_deposit_both(
        t(d["pending"].copy()), t(d["prum"].copy()), t(d["dst"]),
        t(d["slots"]), t(d["valid"]), bits)
    for w, g in zip(want, got):
        assert torch.equal(w, g.cpu())


RECV_CASES = {
    "plain": dict(), "dup": dict(flags=True),
    "overflow": dict(cap=60, base_hi=50), "dup_overflow": dict(
        flags=True, cap=150, base_hi=100),
    "all_empty": dict(fill=0), "full": dict(fill=300),
    "pushsum_w12": dict(width=12), "w36_overflow": dict(
        width=36, cap=80, base_hi=60),
    "dw40": dict(dw=40, cap=50), "dw1024": dict(dw=1024, cap=3, n=40,
                                                rcap=2000, fill=1500),
    # Dynamic shared memory under 48 KB, past it with the static list.
    "dw512": dict(dw=512, cap=6, n=40, rcap=2000, fill=1500),
    "wide": dict(sources=8, rcap=25_831, fill=24_576, n=1_250_000,
                 cap=3_750_000, flags=True),
    # PushSum's window: 12 word columns, a tenth of each bucket live.
    "pushsum_sparse": dict(sources=8, rcap=20_000, fill=2_000, width=12,
                           n=50_000, cap=30_000),
    # Every lane lands: the trash cell and its row keep their values.
    "all_land": dict(fill=300, cap=2_000, width=12),
    # 1172 blocks of 2048 lanes: a long look-back chain.
    "blocks_1172": dict(sources=8, rcap=300_000, fill=200_000, n=1_000_000,
                        cap=1_000_000),
    "dw40_words": dict(dw=40, cap=50, width=12, flags=True),
    "dw1024_words": dict(dw=1024, cap=3, n=40, rcap=2000, fill=1500,
                         width=12),
    "dw512_words": dict(dw=512, cap=6, n=40, rcap=2000, fill=1500,
                        width=12),
    # Past 1024 slots (ROADMAP C1): the global form, one tile and many.
    "dw1025": dict(dw=1025, cap=3, n=40, rcap=2000, fill=1500, flags=True),
    "dw1536_words": dict(dw=1536, cap=3, n=40, rcap=2000, fill=1500,
                         width=12),
    "dw4096_blocks": dict(dw=4096, sources=8, rcap=80_000, fill=70_000,
                          n=5000, cap=200, flags=True),
    # The event engine's rumor words (the sharded multi-rumor route): W 1,
    # 2 and 32, all-ones words and rumor 31's bit among them, and an
    # overflow past cap.
    "rumor_w1": dict(width=1, rumor=True),
    "rumor_w2": dict(width=2, rumor=True),
    "rumor_w32": dict(width=32, rumor=True),
    "rumor_w2_overflow": dict(width=2, rumor=True, cap=80, base_hi=60),
}


@pytest.mark.parametrize("case", sorted(RECV_CASES))
def test_fused_recv_land_kernel_matches_plain_on_card(case):
    dev = _card()
    d, kw = _recv_inputs(19, **RECV_CASES[case])
    want = _recv_land(megakernel.recv_land_plain, d, kw, torch.device("cpu"))
    got = _recv_land(megakernel.fused_recv_land, d, kw, dev)
    for w, g in zip(want, got):
        assert torch.equal(w, g)
    if case == "all_land":
        assert int((got[1] - T(d["cnt"])).sum()) == d["recv"].size


@pytest.mark.parametrize("streams", (1, 2))
def test_fused_recv_land_calls_in_flight_match_plain_on_card(streams):
    """Calls enqueued back to back with no synchronise between them, on one
    stream (one workspace: the counters left at 0, a new epoch a call) or
    on two streams (a workspace each), each on its own ring, against the
    plain version call by call."""
    dev = _card()
    cases = [_recv_inputs(seed, sources=8, rcap=3000, fill=2500, cap=8000,
                          width=12 if seed % 2 else None)
             for seed in (21, 22, 23, 24)]
    want = [_recv_land(megakernel.recv_land_plain, d, kw,
                       torch.device("cpu")) for d, kw in cases]
    cuda = [torch.cuda.current_stream(dev)] + [
        torch.cuda.Stream(dev) for _ in range(streams - 1)]
    args = []
    for d, kw in cases:  # inputs on the card before any call
        args.append([T(d["ring"].copy()).to(dev), T(d["cnt"].copy()).to(dev),
                     torch.tensor(3, dtype=torch.int32, device=dev),
                     T(d["recv"]).to(dev)])
        args[-1].append(T(d["words"]).to(dev) if "words" in d else None)
        args[-1].append(T(d["mail_words"].copy()).to(dev) if "words" in d
                        else None)
    torch.cuda.synchronize()
    outs = []
    for k, ((d, kw), a) in enumerate(zip(cases, args)):
        st = cuda[k % streams]
        st.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(st):
            outs.append(megakernel.fused_recv_land(
                *a[:4], words=a[4], mail_words=a[5], **kw))
    torch.cuda.synchronize()
    for w, out in zip(want, outs):
        for x, y in zip(w, out):
            assert torch.equal(x, y.cpu())


@pytest.mark.parametrize("shards", (2, 8))
@pytest.mark.parametrize("extra", (
    [], ["-crashrate", "0"],
    ["-protocol", "sir", "-removal-rate", "0.3", "-droprate", "0.3"],
    ["-graph", "erdos", "-fanout", "8", "-pallas"],
    ["-phase2-kernel", "xla"],
    ["-model", "pushsum", "-droprate", "0", "-crashrate", "0"]))
def test_sharded_run_on_card_matches_cpu(extra, shards):
    """The sharded backend on `shards` shards of the card against its CPU
    twin: same transcript, same final leaves."""
    import io

    from gossip_simulator_tpu_torch import run_simulation
    from gossip_simulator_tpu_torch.backends import ShardedStepper
    from gossip_simulator_tpu_torch.config import parse_cli
    from gossip_simulator_tpu_torch.utils.metrics import ProgressPrinter

    _card()
    outs, trees = [], []
    for device in ("cpu", "cuda"):
        cfg, _ = parse_cli(["-backend", "sharded", "-graph", "kout", "-n",
                            "4000", "-fanout", "6", "-seed", "2", *extra])
        buf = io.StringIO()
        st = ShardedStepper(cfg, n_devices=shards, device=device)
        run_simulation(cfg, printer=ProgressPrinter(out=buf), stepper=st)
        outs.append(buf.getvalue())
        trees.append(st.state_pytree())
    assert outs[0] == outs[1]
    assert set(trees[0]) == set(trees[1])
    for key in trees[0]:
        assert np.array_equal(trees[0][key], trees[1][key]), key


DRAIN_CASES = {
    "small": dict(), "dim1": dict(c=8), "dim8": dict(c=36),
    "out_of_range": dict(oob=0.3, neg=0.2), "empty": dict(m=0),
    "full_slot": dict(m=1000), "slot0": dict(slot=0),
    "wide": dict(n=200_000, cap=1_500_000, m=1_200_000, tail=1024),
    # Past DRAIN_DIRECT_MAX: the partitioned form (977 slices at C = 12,
    # one scatter pass; 2933 at C = 36, two), out-of-range and negative
    # rows among the lanes.
    "partitioned": dict(n=2_000_000, cap=12_000_000, m=12_000_000, dw=1,
                        slot=0, oob=0.05, neg=0.05),
    "partitioned_dim8": dict(n=2_000_000, c=36, cap=12_000_000,
                             m=12_000_000, dw=1, slot=0, oob=0.05, neg=0.05),
    "clamped": dict(m=1_500),
}


@pytest.mark.parametrize("case", sorted(DRAIN_CASES))
def test_fused_drain_sum_kernel_matches_plain_on_card(case):
    """fused_drain_sum against drain_sum_plain; the mass ring's offsets
    past 2**31 are reached by the chip_smoke.py parity shape."""
    dev = _card()
    d, kw = _drain_inputs(18, **DRAIN_CASES[case])
    want = _drain(megakernel.drain_sum_plain, d, kw, torch.device("cpu"))
    got = _drain(megakernel.fused_drain_sum, d, kw, dev)
    assert torch.equal(want, got)


# The partitioned form forced at small n: (rows a partition, inputs).
DRAIN_PART_CASES = {
    "many": (5, dict(n=5_000, cap=20_000, oob=0.1, neg=0.1)),  # 1000 slices
    "one": (500, dict()),  # P = 1
    "empty_partition": (50, dict(skip=(100, 150))),
    "boundary": (50, dict(rows=[0, 49, 50, 99, 100, 449, 450, 499])),
    "ragged": (77, dict(oob=0.2, neg=0.2)),
    "clamped": (40, dict(m=1_500)),
    "empty": (40, dict(m=0)),
    "dim8": (30, dict(c=36)),
    # Past DRAIN_STAGE_MAX partitions: two scatter passes (63 groups).
    "two_pass": (2, dict(n=5_000, cap=20_000, oob=0.1, neg=0.1)),
    "two_pass_sparse": (2, dict(n=5_000, m=300)),
    "two_pass_dim8": (3, dict(n=5_000, c=36, cap=20_000)),
}


@pytest.mark.parametrize("case", sorted(DRAIN_PART_CASES))
def test_fused_drain_sum_partitions_match_plain_on_card(case, monkeypatch):
    """The partitioned drain forced at small n through the launch function
    (no direct kernel, a budget of a few rows), against drain_sum_plain:
    many slices, one, an empty one, rows on either side of a boundary, cnt
    past cap, m = 0, the two-pass scatter."""
    dev = _card()
    part_rows, extra = DRAIN_PART_CASES[case]
    d, kw = _drain_inputs(24, **extra)
    n, c = d["acc"].shape
    monkeypatch.setattr(megakernel, "DRAIN_DIRECT_MAX", 0)
    monkeypatch.setattr(megakernel, "DRAIN_BUDGET", part_rows * c * 4)
    rows = megakernel.drain_part_rows(n, c)
    assert 0 < rows <= part_rows and -(-n // rows) == -(-n // part_rows)
    want = _drain(megakernel.drain_sum_plain, d, kw, torch.device("cpu"))
    t = lambda x: T(x.copy()).to(dev)  # noqa: E731
    got = megakernel._drain_launch(t(d["acc"]), t(d["ids"]), t(d["mass"]),
                                   t(d["cnt"]), kw["slot"], kw["cap"],
                                   kw["b"]).cpu()
    assert torch.equal(want, got)


@pytest.fixture(params=(True, False), ids=("partitionable", "original"))
def layout(request):
    old = trng.partitionable()
    trng.set_partitionable(request.param)
    yield request.param
    trng.set_partitionable(old)


@pytest.mark.parametrize("n,k,row0,rows", ((1000, 5, 0, 1000),
                                           (100_003, 3, 517, 70_001),
                                           (5000, 128, 4000, 1000),
                                           (5000, 300, 17, 2000),
                                           (2**31 - 1, 1, 2**31 - 300,
                                            299)))
def test_kout_pallas_kernel_matches_plain_on_card(layout, n, k, row0, rows):
    dev = _card()
    key = trng.tick_key(trng.base_key(3), 0, trng.OP_GRAPH)
    want = graph.kout_pallas(n, k, row0, rows, key)
    got = graph.kout_pallas(n, k, row0, rows, key.to(dev))
    assert torch.equal(want, got.cpu())


@pytest.mark.parametrize("n,lam,row0,rows", (
    (100_003, 8.0, 517, 70_001), (100_003, 8.0, 0, 255),
    (100_003, 8.0, 5, 256), (100_003, 8.0, 9_000, 257),
    (50_000, 60.0, 777, 9_000), (50_000, 60.0, 1, 71),
    (50_000, 60.0, 3, 72), (50_000, 60.0, 40_000, 73),
    (2**31 - 1, 8.0, 2**31 - 600, 599)))
def test_erdos_pallas_tile_edges_match_plain_on_card(layout, n, lam, row0,
                                                     rows):
    """erdos_pallas at lam 8 (256 rows a tile) and lam 60 (72 rows a
    tile), across tile edges and with row0 > 0, and near n = 2**31."""
    dev = _card()
    key = trng.tick_key(trng.base_key(6), 0, trng.OP_GRAPH)
    wf, wd = graph.erdos_pallas(n, lam, row0, rows, key)
    gf, gd = graph.erdos_pallas(n, lam, row0, rows, key.to(dev))
    assert torch.equal(wd, gd.cpu())
    assert torch.equal(wf, gf.cpu())


@pytest.mark.parametrize("lam", (8.0, 60.0))
def test_erdos_pallas_degree_zero_and_cap_match_plain_on_card(
        layout, lam, monkeypatch):
    """Rows of degree 0, cap - 1 and cap: both sides take the table from
    graph.erdos_cdf, here one that sends u < 0.3 to degree 0 and u > 0.7
    to degree cap."""
    dev = _card()
    cap = tcfg.er_cap(lam)
    table = np.full(cap, 0.3, dtype=np.float32)
    table[-1] = 0.7
    monkeypatch.setattr(graph, "erdos_cdf", lambda lam_, cap_: table)
    graph.erdos_cdf_param.cache_clear()
    try:
        key = trng.tick_key(trng.base_key(8), 0, trng.OP_GRAPH)
        wf, wd = graph.erdos_pallas(30_000, lam, 11, 5_000, key)
        gf, gd = graph.erdos_pallas(30_000, lam, 11, 5_000, key.to(dev))
    finally:
        graph.erdos_cdf_param.cache_clear()
    assert set(np.unique(wd.numpy()).tolist()) == {0, cap - 1, cap}
    assert torch.equal(wd, gd.cpu())
    assert torch.equal(wf, gf.cpu())


@pytest.mark.parametrize("n", (2, 3, 7, 2**16 - 1, 2**16, 2**16 + 1,
                               10_000_000, 2**31 - 1))
def test_erdos_remainder_is_the_remainder_on_card(n):
    """The kernel's multiply-high remainder by an invariant n against %,
    over edge dividends (0, 2**32 - 1, multiples of n and their
    neighbours, powers of two and theirs) and random words."""
    dev = _card()
    rng = np.random.default_rng(n)
    mult = np.arange(0, 2**32, n, dtype=np.uint64)[::max(1, 2**32 // n
                                                         // 4096)]
    pw = np.array([1 << i for i in range(32)], dtype=np.uint64)
    x = np.concatenate([mult, mult + 1, mult - 1, pw, pw - 1, pw + 1,
                        np.array([0, 2**32 - 1], np.uint64),
                        rng.integers(0, 2**32, 1 << 20, dtype=np.uint64)])
    x = x[x < 2**32]
    got = graph.erdos_urem(T(x.astype(np.uint32).view(np.int32)).to(dev),
                           n).cpu().numpy().view(np.uint32)
    assert np.array_equal(got.astype(np.uint64), x % np.uint64(n))


@pytest.mark.parametrize("n,lam,row0,rows", ((1000, 0.5, 0, 1000),
                                             (100_003, 8.0, 517, 70_001),
                                             (20_000, 12.0, 0, 20_000),
                                             (50_000, 60.0, 777, 9000)))
def test_erdos_pallas_kernel_matches_plain_on_card(layout, n, lam, row0,
                                                   rows):
    dev = _card()
    key = trng.tick_key(trng.base_key(4), 0, trng.OP_GRAPH)
    wf, wd = graph.erdos_pallas(n, lam, row0, rows, key)
    gf, gd = graph.erdos_pallas(n, lam, row0, rows, key.to(dev))
    assert torch.equal(wd, gd.cpu())
    assert torch.equal(wf, gf.cpu())
