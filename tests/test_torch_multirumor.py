"""Multi-rumor traffic on the event engine, piece by piece: the port's
helpers (``arrivals.py``, the injection schedule, the rumor leaves, the
drain's word fold, the sender batches and the append with words) and the
plain versions of its kernels' word forms (``fused_emit`` with rumor
words, ``fused_unique_set`` over the id and word rings,
``fused_ring_append`` with the word ring) against the JAX package's, on
inputs made with numpy from a seed, with exact equality.  The Pallas
kernels run in interpret mode through Pallas's generic interpreter (as in
tests/test_torch_ops.py).  The port carries the uint32 words as their
int32 view; both sides are compared as uint32."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gossip_simulator_tpu import arrivals as jarrivals
from gossip_simulator_tpu import config as jcfg
from gossip_simulator_tpu.models import event as jevent
from gossip_simulator_tpu.ops import mailbox as jmailbox
from gossip_simulator_tpu.ops import pallas_deliver as jdeliver
from gossip_simulator_tpu.ops import pallas_megakernel as jmk
from gossip_simulator_tpu.utils import rng as jrng
from gossip_simulator_tpu_torch import arrivals as tarrivals
from gossip_simulator_tpu_torch import config as tcfg
from gossip_simulator_tpu_torch.models import event as tevent
from gossip_simulator_tpu_torch.ops import deliver, mailbox, megakernel
from gossip_simulator_tpu_torch.utils import rng as trng
from test_torch_card import _emit_inputs, _ring_inputs
from test_torch_rng import match_jax_threefry

T = torch.from_numpy


@pytest.fixture(autouse=True, scope="module")
def threefry_layout():
    """Draw in the counter layout this process's jax uses."""
    old = trng.partitionable()
    match_jax_threefry()
    yield
    trng.set_partitionable(old)


@pytest.fixture(autouse=True)
def generic_interpreter(monkeypatch):
    monkeypatch.setattr(jmk, "_interpret_param", bool)
    monkeypatch.setattr(jdeliver, "_interpret_param", bool)


def _u32(x):
    """uint32 numpy view of either side's words."""
    a = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return np.ascontiguousarray(a).view(np.uint32)


def _i32(a):
    """The port's int32 view of uint32 words."""
    return T(np.ascontiguousarray(np.asarray(a, np.uint32)).view(np.int32))


def _cfgs(**kw):
    base = dict(n=3000, fanout=6, graph="kout", seed=4, crashrate=0.0,
                coverage_target=0.95, progress=False)
    base.update(kw)
    return jcfg.Config(**base).validate(), tcfg.Config(**base).validate()


# --- arrivals and the schedule ----------------------------------------------

ARRIVALS = ("fixed", "poisson", "burst", "diurnal")


@pytest.mark.parametrize("kind", ARRIVALS)
@pytest.mark.parametrize("rate,rumors,seed", ((100, 64, 0), (50, 8, 4),
                                              (7, 33, 11), (1000, 1024, 2)))
def test_arrival_tables_match(kind, rate, rumors, seed):
    """The port's copy of arrivals.py gives the JAX package's tables, byte
    for byte, and the same last injection tick."""
    kw = dict(rumors=rumors, traffic="stream", stream_rate=rate,
              arrivals=kind, seed=seed)
    jc, tc = _cfgs(**kw)
    assert jarrivals._table(kind, rate, rumors, seed, None) == \
        tarrivals._table(kind, rate, rumors, seed)
    want, got = jarrivals.arrival_ticks(jc), tarrivals.arrival_ticks(tc)
    assert want.dtype == got.dtype and np.array_equal(want, got)
    assert jarrivals.table_or_none(jc) == tarrivals.table_or_none(tc)
    assert (tarrivals.table_or_none(tc) is None) == (kind == "fixed")
    assert jc.last_inject_tick == tc.last_inject_tick


SCHEDULES = {
    "oneshot_r16": dict(rumors=16),
    "oneshot_r40": dict(rumors=40),
    "stream_r64": dict(rumors=64, traffic="stream", stream_rate=100),
    "stream_r8_fast": dict(rumors=8, traffic="stream", stream_rate=5000),
    "stream_r1": dict(rumors=1, traffic="stream", stream_rate=30),
    "poisson": dict(rumors=40, traffic="stream", stream_rate=300,
                    arrivals="poisson"),
    "burst": dict(rumors=40, traffic="stream", stream_rate=300,
                  arrivals="burst"),
    "diurnal": dict(rumors=40, traffic="stream", stream_rate=300,
                    arrivals="diurnal"),
}


@pytest.mark.parametrize("case", sorted(SCHEDULES))
def test_injection_lanes_and_batches_match(case):
    """injection_lanes, and injection_batch at every window from tick 0
    through the stream's last injection and past it: payload, words, slot
    and validity lane for lane."""
    jc, tc = _cfgs(**SCHEDULES[case])
    assert jevent.injection_lanes(jc) == tevent.injection_lanes(tc)
    b, dw = jevent.batch_ticks(jc), jevent.ring_windows(jc)
    last = jc.last_inject_tick
    ticks = list(range(0, last + 3 * b, b)) + [last + 50 * b, 10**6]
    key = jrng.base_key(jc.seed)
    valid_total = 0
    for tick in ticks:
        want = jevent.injection_batch(jc, jnp.int32(tick), key, b, dw)
        got = tevent.injection_batch(tc, tick, trng.base_key(tc.seed), b, dw)
        for name, w, g in zip(("payload", "words", "wslot", "valid"), want,
                              got):
            if name == "words":
                assert np.array_equal(_u32(w), _u32(g)), (tick, name)
            else:
                assert np.array_equal(np.asarray(w), g.numpy()), (tick, name)
        valid_total += int(got[3].sum())
        if tick > last:
            assert not bool(got[3].any())
    assert valid_total == jc.rumors  # every rumor injected exactly once


def test_stamp_rumor_done_matches():
    jc, tc = _cfgs(rumors=40)
    rng = np.random.default_rng(3)
    target = int(np.ceil(jc.coverage_target * jc.n))
    recv = rng.integers(target - 30, target + 30, 64).astype(np.int32)
    done = np.where(rng.random(64) < 0.3, rng.integers(0, 90, 64),
                    -1).astype(np.int32)
    want = jevent.stamp_rumor_done(jc, jnp.asarray(recv), jnp.asarray(done),
                                   jnp.int32(120))
    got = tevent.stamp_rumor_done(tc, T(recv), T(done.copy()), 120)
    assert np.array_equal(np.asarray(want), got.numpy())
    assert (got.numpy() == 120).any() and (got.numpy() < 0).any()


@pytest.mark.parametrize("rumors", (1, 16, 40, 1024))
def test_init_rumor_leaves_match(rumors):
    """Full size under the rumor axis (the port's rumor_words one trash
    row longer), the 1-element placeholders otherwise."""
    jc, tc = _cfgs(rumors=rumors)
    want = jevent.init_rumor_leaves(jc, jc.n)
    got = tevent.init_rumor_leaves(tc, tc.n, "cpu")
    for i, (w, g) in enumerate(zip(want, got)):
        g = g.numpy()
        if i == 1 and rumors > 1:
            assert not g[-1].any()
            g = g[:-1]
        assert np.shape(w) == g.shape
        if i < 2:
            assert np.asarray(w).dtype == np.uint32 and g.dtype == np.int32
            assert np.array_equal(np.asarray(w), g.view(np.uint32))
        else:
            assert np.array_equal(np.asarray(w), g)


# --- the drain's word fold --------------------------------------------------


@pytest.mark.parametrize("seed", (0, 1, 2))
@pytest.mark.parametrize("width", (1, 3, 8))
def test_segmented_or_is_each_runs_or(seed, width):
    """Every lane of a run holds the whole run's OR (runs of 1 to 70
    lanes, any bit pattern)."""
    rng = np.random.default_rng(seed)
    keys = np.sort(rng.integers(0, 60, 900)).astype(np.int32)
    words = rng.integers(-2**31, 2**31, (900, width),
                         dtype=np.int64).astype(np.int32)
    got = tevent.segmented_or(T(keys), T(words)).numpy()
    starts = np.flatnonzero(np.r_[True, keys[1:] != keys[:-1]])
    for s, e in zip(starts, np.r_[starts[1:], 900]):
        want = np.bitwise_or.reduce(words[s:e])
        assert (got[s:e] == want).all()


def _drain_inputs(seed, n, w, ccap=512, m=400):
    rng = np.random.default_rng(seed)
    b = 10
    packed = (rng.integers(0, n, ccap) * b
              + rng.integers(0, b, ccap)).astype(np.int32)
    words = rng.integers(0, 2**32, (ccap, w), dtype=np.uint64).astype(
        np.uint32)
    # Sparse words, as the ring carries them (a sender's new bits).
    words &= rng.integers(0, 2**32, (ccap, w), dtype=np.uint64).astype(
        np.uint32)
    flags = (rng.random(n) < 0.4).astype(np.uint8)
    flags |= ((rng.random(n) < 0.05) * 2).astype(np.uint8)
    rwords = rng.integers(0, 2**32, (n, w), dtype=np.uint64).astype(
        np.uint32) & rng.integers(0, 2**32, (n, w), dtype=np.uint64).astype(
        np.uint32)
    return b, packed, words, flags, rwords, m


@pytest.mark.parametrize("crash_p,track", ((0.0, False), (0.0, True),
                                           (0.3, False)))
@pytest.mark.parametrize("w", (1, 2))
def test_drain_chunk_core_with_words_matches(crash_p, track, w):
    n, ccap = 300, 512
    b, packed, words, flags, rwords, m = _drain_inputs(5 + w, n, w, ccap)
    pos = np.arange(ccap, dtype=np.int32)
    evalid = pos < m
    ckey = jrng.tick_key(jrng.base_key(3), 7, jrng.OP_CRASH)
    want = jevent.drain_chunk_core(
        crash_p, b, n, jnp.asarray(flags), jnp.asarray(packed),
        jnp.asarray(evalid), jnp.asarray(pos), ckey, track_crashed=track,
        words=jnp.asarray(words), rumor_words=jnp.asarray(rwords))
    tflags = T(np.append(flags, np.uint8(0)))
    trw = torch.cat([_i32(rwords), torch.zeros((1, w), dtype=torch.int32)])
    tkey = trng.tick_key(trng.base_key(3), 7, trng.OP_CRASH)
    got = tevent.drain_chunk_core(
        crash_p, b, n, tflags, T(packed), T(evalid), T(pos), tkey,
        track_crashed=track, words=_i32(words), rumor_words=trw)
    (jflags, jdm, jdr, jdc, jids, jtoff, jsend, _, jrw, jdelta,
     jdrecv) = want
    (_, dm, dr, dc, ids_s, toff_s, senders, delta, drecv) = got
    assert np.array_equal(np.asarray(jflags), tflags[:n].numpy())
    assert (int(jdm), int(jdr), int(jdc)) == (int(dm), int(dr), int(dc))
    assert np.array_equal(np.asarray(jids), ids_s.numpy())
    assert np.array_equal(np.asarray(jtoff), toff_s.numpy())
    assert np.array_equal(np.asarray(jsend), senders.numpy())
    assert np.array_equal(_u32(jrw), _u32(trw[:n]))
    assert not trw[n].any()  # the trash row
    assert np.array_equal(_u32(jdelta), _u32(delta))
    assert np.array_equal(np.asarray(jdrecv), drecv.numpy())
    assert int(drecv.sum()) > 0 and bool(senders.any())


@pytest.mark.parametrize("w", (1, 2))
def test_sender_batch_with_words_matches(w):
    rng = np.random.default_rng(w)
    ccap, scap, b = 600, 128, 10
    senders = rng.random(ccap) < 0.3
    srank = (np.cumsum(senders) - 1).astype(np.int32)
    scnt = int(senders.sum())
    spacked = rng.integers(0, 5000, ccap).astype(np.int32)
    delta = rng.integers(0, 2**32, (ccap, w), dtype=np.uint64).astype(
        np.uint32)
    for lo in (0, 128, scnt - 20):
        want = jevent.sender_batch(
            jnp.asarray(senders), jnp.asarray(srank), jnp.int32(scnt),
            jnp.asarray(spacked), b, scap, 0, lo=lo,
            sdelta=jnp.asarray(delta))
        got = tevent.sender_batch(T(senders), T(srank), scnt, T(spacked), b,
                                  scap, 0, lo=lo, sdelta=_i32(delta))
        for x, y in zip(want[:3], got[:3]):
            assert np.array_equal(np.asarray(x), y.numpy())
        assert np.array_equal(_u32(want[3]), _u32(got[3]))


# --- the append with words, and the kernels' word forms ----------------------

PARTITION = ('{"groups": 2, "events": [{"type": "partition", "start": 0, '
             '"end": 45}]}')


@pytest.mark.parametrize("rumors", (16, 40))
@pytest.mark.parametrize("extra", ({}, {"scenario": PARTITION},
                                   {"event_slot_cap": 40}),
                         ids=("plain", "partition", "overflow"))
@pytest.mark.parametrize("phase2,kernel", (("xla", "xla"),
                                           ("xla", "pallas"),
                                           ("pallas", "xla")))
def test_append_messages_with_words_matches_xla_chain(rumors, extra, phase2,
                                                      kernel):
    """Port append_messages with sender words under all three write
    routes (fused_emit; the chain and fused_unique_set; the chain and
    index_put_) against the JAX package's unfused chain: both rings,
    counts, drops, blocked edges."""
    jc, tc = _cfgs(n=200, seed=5, rumors=rumors, **extra)
    n, k = jc.n, jc.max_degree
    m = min(64, jevent.sender_compaction_cap(jc, jevent.drain_chunk(jc)))
    rng = np.random.default_rng(rumors)
    friends = rng.integers(0, n, (n, k)).astype(np.int32)
    friends[rng.random((n, k)) < 0.1] = -1
    dw = jevent.ring_windows(jc)
    ring_len = dw * jevent.slot_cap(jc) + jevent.ring_tail(jc)
    assert ring_len == dw * tevent.slot_cap(tc) + tevent.ring_tail(tc)
    wc = jc.rumor_word_count
    ring = rng.integers(0, 100, ring_len).astype(np.int32)
    mwords = rng.integers(0, 2**32, (ring_len, wc),
                          dtype=np.uint64).astype(np.uint32)
    lo = 30 if "event_slot_cap" in extra else 0
    cnt = rng.integers(lo, lo + 10, (1, dw)).astype(np.int32)
    sids = rng.permutation(n)[:m].astype(np.int32)
    svalid = rng.random(m) < 0.85
    sticks = (40 + rng.integers(0, 10, m)).astype(np.int32)
    sw = rng.integers(0, 2**32, (m, wc), dtype=np.uint64).astype(np.uint32)
    jout = jevent.append_messages(
        jc, jnp.asarray(ring), jnp.asarray(cnt), jnp.zeros((), jnp.int32),
        jnp.asarray(sids), jnp.asarray(svalid), jnp.asarray(sticks),
        jnp.asarray(friends), jnp.full((n,), k, jnp.int32),
        jrng.base_key(jc.seed), swords=jnp.asarray(sw),
        mail_words=jnp.asarray(mwords), kernel="xla", phase2="xla")
    tw = _i32(mwords).clone()
    tout = tevent.append_messages(
        tc, T(ring.copy()), T(cnt.copy()), torch.zeros((), dtype=torch.int64),
        T(sids), T(svalid), T(sticks), T(friends), trng.base_key(tc.seed),
        kernel=kernel, phase2=phase2, swords=_i32(sw), mail_words=tw)
    assert np.array_equal(np.asarray(jout[0]), tout[0].numpy())
    assert np.array_equal(np.asarray(jout[1]), tout[1].numpy())
    assert int(jout[2]) == int(tout[2])
    assert np.array_equal(np.asarray(jout[3]), tout[3].numpy())
    assert int(jout[4]) == int(tout[4])
    assert np.array_equal(_u32(jout[5]), _u32(tout[5]))
    assert tout[5] is tw  # in place
    if "event_slot_cap" in extra:
        assert int(tout[2]) > 0
    if "scenario" in extra:
        assert int(tout[4]) > 0


EMIT_WORD_CASES = {
    "w1": dict(words=1), "w2": dict(words=2),
    "w1_pm50": dict(words=1, pm=0.5), "w2_pm50": dict(words=2, pm=0.5),
    "w2_overflow": dict(words=2, cap=60, base_hi=50),
    "w32_kw40": dict(words=32, k=40, m=16, pad=0.3),
    "w2_dw1536": dict(words=2, dw=1536, m=64, cap=3),
}


@pytest.mark.parametrize("case", sorted(EMIT_WORD_CASES))
@pytest.mark.parametrize("seed", (0, 1))
def test_fused_emit_words_plain_matches_pallas(case, seed):
    """fused_emit's plain version with rumor words (and the layout's wvals
    under index_put_) against the Pallas kernel in interpret mode: the id
    ring, the word ring and the counts."""
    d, kw = _emit_inputs(seed, **EMIT_WORD_CASES[case])
    sw, wring = d["swords"].view(np.uint32), d["wring"].view(np.uint32)
    want = jmk.fused_emit(
        jnp.asarray(d["ring"]), jnp.asarray(d["cnt"]), jnp.asarray(d["sf"]),
        jnp.asarray(d["drop"]), jnp.asarray(d["svalid"]),
        jnp.asarray(d["wslot"]), jnp.asarray(d["off"]),
        pmask=jnp.asarray(d["pmask"]) if "pmask" in d else None,
        swords=jnp.asarray(sw), mail_words=jnp.asarray(wring),
        received_bit=jevent.RECEIVED, interpret=True, **kw)
    for fn in (megakernel.fused_emit, megakernel.emit_plain):
        got = fn(T(d["ring"].copy()), T(d["cnt"]), T(d["sf"]), T(d["drop"]),
                 T(d["svalid"]), T(d["wslot"]), T(d["off"]),
                 pmask=T(d["pmask"]) if "pmask" in d else None,
                 swords=T(d["swords"]), mail_words=T(d["wring"].copy()),
                 received_bit=tevent.RECEIVED, **kw)
        assert len(got) == 6
        assert np.array_equal(np.asarray(want[0]), got[0].numpy())
        for i in (1, 2):
            assert np.array_equal(np.asarray(want[i]), got[i].numpy())
        assert (int(want[3]), int(want[4])) == (int(got[3]), int(got[4]))
        assert np.array_equal(_u32(want[5]), _u32(got[5]))
    if "overflow" in case:
        assert int(want[3]) > 0


@pytest.mark.parametrize("w", (1, 2, 32))
@pytest.mark.parametrize("seed", (0, 1))
def test_fused_unique_set_word_ring_plain_matches_pallas(w, seed):
    rng = np.random.default_rng(seed)
    ring = rng.integers(-50, 50, 500).astype(np.int32)
    words = rng.integers(0, 2**32, (500, w), dtype=np.uint64).astype(
        np.uint32)
    flat = rng.permutation(500)[:180].astype(np.int32)
    vals = rng.integers(0, 10**6, 180).astype(np.int32)
    wvals = rng.integers(0, 2**32, (180, w), dtype=np.uint64).astype(
        np.uint32)
    want = jdeliver.fused_unique_set(
        (jnp.asarray(ring), jnp.asarray(words)), jnp.asarray(flat),
        (jnp.asarray(vals), jnp.asarray(wvals)), interpret=True)
    got = deliver.fused_unique_set((T(ring.copy()), _i32(words).clone()),
                                   T(flat), (T(vals), _i32(wvals)))
    assert isinstance(got, tuple) and len(got) == 2
    assert np.array_equal(np.asarray(want[0]), got[0].numpy())
    assert np.array_equal(_u32(want[1]), _u32(got[1]))


@pytest.mark.parametrize("m,w,dead", ((3, 1, 0.5), (16, 2, 0.7),
                                      (3000, 2, 0.9), (700, 32, 0.5)))
def test_fused_ring_append_word_ring_plain_matches_pallas(m, w, dead):
    """The injection batch's and the heal's appends: an id ring and a word
    ring of W columns at the same positions, against the Pallas kernel in
    interpret mode and the JAX package's one-hot chain."""
    d, kw = _ring_inputs(31 + m, m=m, width=w, dead=dead, cap=300)
    u = [np.asarray(d["rings"][0]), d["rings"][1].astype(np.uint32)]
    pu = [np.asarray(d["pays"][0]), d["pays"][1].astype(np.uint32)]
    args = (tuple(jnp.asarray(r) for r in u), jnp.asarray(d["cnt"]),
            jnp.int32(3), tuple(jnp.asarray(p) for p in pu),
            jnp.asarray(d["wslot"]), jnp.asarray(d["valid"]), kw["dw"],
            kw["cap"])
    for want in (jdeliver.fused_ring_append(*args, interpret=True),
                 jmailbox.ring_append(*args, kernel="xla")):
        rings = (T(u[0].copy()), _i32(u[1]).clone())
        cnt = T(d["cnt"].copy())
        dropped = torch.tensor(3, dtype=torch.int32)
        mailbox.ring_append(rings, cnt, dropped,
                            (T(pu[0]), _i32(pu[1])), T(d["wslot"]),
                            T(d["valid"]), kw["dw"], kw["cap"],
                            kernel="pallas")
        (jr, jw), jcnt, jdrop = want
        assert np.array_equal(np.asarray(jr), rings[0].numpy())
        assert np.array_equal(_u32(jw), _u32(rings[1]))
        assert np.array_equal(np.asarray(jcnt), cnt.numpy())
        assert int(jdrop) == int(dropped)


# --- flags -------------------------------------------------------------------


@pytest.mark.parametrize("flags", (
    ["-rumors", "16"], ["-rumors", "1024", "-phase2-kernel", "xla"],
    ["-traffic", "stream"], ["-traffic", "stream", "-rumors", "64",
                             "-arrivals", "poisson", "-stream-rate", "300"],
    ["-rumors", "8", "-graph", "overlay"],
    ["-rumors", "16", "-overlay-heal", "on", "-scenario", "{}"]))
def test_rumor_flags_validate_and_need_the_card(flags):
    """The slice's flags parse on the event engine, and without -device
    run on cuda: on a host without a card they raise by name."""
    from gossip_simulator_tpu_torch.backends.torch_backend import (
        DeviceUnavailable, TorchStepper)

    cfg, device = tcfg.parse_cli(["-graph", "kout", "-n", "100"] + flags)
    assert cfg.engine_resolved == "event" and cfg.multi_rumor
    assert device == "cuda" and not cfg.dup_suppress_resolved
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device exists")
    with pytest.raises(DeviceUnavailable, match="no CUDA device"):
        TorchStepper(cfg)


@pytest.mark.parametrize("flags,match", (
    (["-traffic", "stream", "-stream-rate", "0"], "stream_rate must be"),
    (["-traffic", "stream", "-stream-rate", "1000001"],
     "stream_rate must be"),
    (["-rumors", "4", "-dup-suppress", "on", "-crashrate", "0"],
     "unsound with a rumor axis"),
    (["-rumors", "4", "-protocol", "sir"], "protocol=si only"),
    (["-traffic", "stream", "-compat-reference"], "strictly single-rumor"),
    (["-rumors", "4", "-backend", "native"], "require backend=jax"),
    (["-rumors", "4", "-engine", "ring", "-backend", "sharded"],
     "single-device only"),
    (["-traffic", "stream", "-engine", "ring"], "requires the event engine"),
    (["-rumors", "0"], r"rumors must be in \[1, 1024\]")))
def test_rumor_rules_match_the_jax_package(flags, match):
    argv = ["-graph", "kout", "-n", "100"] + flags
    with pytest.raises(ValueError, match=match):
        tcfg.parse_cli(argv)
    with pytest.raises(ValueError, match=match):
        jcfg.parse_args(argv)
