"""The port's kernel modules on the CPU: each plain version against the
JAX package's Pallas kernel in interpret mode and against its unfused XLA
chain, on the same numpy inputs, with exact equality.  Also: the wrappers
take the plain version only for CPU tensors, and refuse what is not
ported.  The kernels themselves run only on the card
(tests/test_torch_card.py).

The Pallas kernels run through Pallas's generic interpreter
(``interpret=True``): on jax 0.9.0 the TPU interpreter that the JAX
package selects (``pltpu.InterpretParams``) fails on these kernels with an
out-of-bounds buffer index, which is also why the JAX package's own
interpret-mode kernel tests skip on such hosts.  The kernel body is the
same either way."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gossip_simulator_tpu import config as jcfg
from gossip_simulator_tpu.models import event as jevent
from gossip_simulator_tpu.ops import pallas_deliver as jdeliver
from gossip_simulator_tpu.ops import pallas_megakernel as jmk
from gossip_simulator_tpu.utils import rng as jrng
from gossip_simulator_tpu_torch import config as tcfg
from gossip_simulator_tpu_torch.models import event as tevent
from gossip_simulator_tpu_torch.ops import (_build, deliver, graph,
                                            megakernel, overlay_kernel)
from gossip_simulator_tpu_torch.utils import rng as trng
from test_torch_card import (DEPOSIT_FNS, _chunk_inputs, _chunk_step,
                             _deposit, _deposit_inputs, _emit_inputs,
                             _hosted_inputs, _negotiate, _negotiate_inputs,
                             _recv_inputs, _request, _request_inputs,
                             _ring_append, _ring_inputs, _spill_inputs,
                             _spill_step)
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


def _jax_emit(d, kw):
    out = jmk.fused_emit(
        jnp.asarray(d["ring"]), jnp.asarray(d["cnt"]), jnp.asarray(d["sf"]),
        jnp.asarray(d["drop"]), jnp.asarray(d["svalid"]),
        jnp.asarray(d["wslot"]), jnp.asarray(d["off"]),
        strig=jnp.asarray(d["strig"]) if "strig" in d else None,
        sender_ids=jnp.asarray(d["sids"]) if "sids" in d else None,
        flags=jnp.asarray(d["flags"]) if "flags" in d else None,
        pmask=jnp.asarray(d["pmask"]) if "pmask" in d else None,
        received_bit=jevent.RECEIVED, interpret=True, **kw)
    ring, adds, sup, lost, blk = out
    return (np.asarray(ring), np.asarray(adds), np.asarray(sup),
            int(lost), int(blk))


def _port_emit(d, kw, fn=megakernel.fused_emit):
    ring = T(d["ring"].copy())
    out = fn(ring, T(d["cnt"]), T(d["sf"]), T(d["drop"]), T(d["svalid"]),
             T(d["wslot"]), T(d["off"]),
             strig=T(d["strig"]) if "strig" in d else None,
             sender_ids=T(d["sids"]) if "sids" in d else None,
             flags=T(d["flags"]) if "flags" in d else None,
             pmask=T(d["pmask"]) if "pmask" in d else None,
             received_bit=tevent.RECEIVED, **kw)
    ring, adds, sup, lost, blk = out
    return ring.numpy(), adds.numpy(), sup.numpy(), int(lost), int(blk)


EMIT_CASES = {
    "si": dict(),
    "si_dup": dict(dup=True),
    "sir": dict(sir=True),
    "sir_dup": dict(sir=True, dup=True),
    "overflow": dict(cap=60, base_hi=50),
    "dead_rows": dict(dead=0.7),
    "dw2": dict(dw=2),
    "dw3_k5": dict(dw=3, k=5),
    # Past the CUDA kernel's old limits (ROADMAP C1): 40 ring slots, 33 and
    # 112 lanes a sender.
    "dw40": dict(dw=40),
    "kw33_sir": dict(k=32, sir=True),
    "kw112_sir_dup": dict(k=111, sir=True, dup=True, pad=0.5, m=16),
    # Where the kernel's branches split (ops/megakernel.py emit_group: a
    # thread a row up to kw 8, eight threads past it; the kept masks up to
    # kw 32), past eight ring slots, and a reservation that straddles cap
    # (test below).
    "kw8": dict(k=8),
    "kw9_sir_dup": dict(k=8, sir=True, dup=True),
    "kw32": dict(k=32, m=24),
    "dw9": dict(dw=9, m=64),
    "straddle": dict(k=8, cap=40, base_hi=30, pad=0.0, dead=0.0),
    # The scenario's partition mask (the Pallas kernel's has_part): a
    # blocked edge is cleared before the duplicate filter and counted.
    "pm50": dict(pm=0.5),
    "pm50_sir_dup": dict(pm=0.5, sir=True, dup=True),
    "pm100_dup": dict(pm=1.0, dup=True),
    "pm50_overflow": dict(pm=0.5, cap=60, base_hi=50),
    # Past 1024 ring slots (ROADMAP C1): the plain version's sorted
    # per-slot prefix.
    "dw1536": dict(dw=1536, m=64, cap=3),
    "dw1536_pm50_sir": dict(dw=1536, m=64, cap=3, pm=0.5, sir=True),
}


@pytest.mark.parametrize("case", sorted(EMIT_CASES))
@pytest.mark.parametrize("seed", (0, 1))
def test_fused_emit_plain_matches_pallas(case, seed):
    d, kw = _emit_inputs(seed, **EMIT_CASES[case])
    want = _jax_emit(d, kw)
    got = _port_emit(d, kw)
    for w, g in zip(want, got):
        assert np.array_equal(np.asarray(w), np.asarray(g))
    if case == "overflow":
        assert want[3] > 0  # the corner is actually exercised
    if case.startswith("pm50"):
        assert want[4] > 0  # edges were blocked
    if case == "straddle":
        # Some sender's reservation starts below cap and ends past it (no
        # padding, no dead row: a row's kept lanes are its undropped ones).
        start, straddles = d["cnt"][0].astype(np.int64), 0
        for s, ec in zip(d["wslot"], (~d["drop"]).sum(axis=1)):
            straddles += start[s] < kw["cap"] < start[s] + ec
            start[s] += ec
        assert want[3] > 0 and straddles
    # The unfused layout + index_put_ (-phase2-kernel xla) is the same
    # function.
    got2 = _port_emit(d, kw, fn=megakernel.emit_plain)
    for w, g in zip(want, got2):
        assert np.array_equal(np.asarray(w), np.asarray(g))


def _cfgs(**kw):
    base = dict(n=200, fanout=6, graph="kout", seed=5, progress=False)
    base.update(kw)
    return jcfg.Config(**base).validate(), tcfg.Config(**base).validate()


PARTITION = ('{"groups": 2, "events": [{"type": "partition", "start": 0, '
             '"end": 45}]}')
APPEND_CASES = {
    "si_crash": dict(),
    "si_suppress": dict(crashrate=0.0),
    "sir": dict(protocol="sir", removal_rate=0.3),
    "overflow": dict(event_slot_cap=40),
    # The send-time partition mask: senders at ticks 40..49, the window
    # [0, 45) blocks the cross-group edges of about half of them.
    "partition_suppress": dict(crashrate=0.0, scenario=PARTITION),
    "partition_sir": dict(protocol="sir", removal_rate=0.3,
                          scenario=PARTITION),
}


@pytest.mark.parametrize("case", sorted(APPEND_CASES))
@pytest.mark.parametrize("phase2,kernel", (("xla", "xla"),
                                           ("xla", "pallas"),
                                           ("pallas", "xla")))
def test_append_messages_matches_xla_chain(case, phase2, kernel):
    """Port append_messages (RNG draws + emission + write) against the JAX
    package's unfused XLA chain on the same state."""
    jc, tc = _cfgs(**APPEND_CASES[case])
    # At most one sender batch: the ring tail holds its trash lanes.
    n, k = jc.n, jc.fanout
    m = min(64, jevent.sender_compaction_cap(jc, jevent.drain_chunk(jc)))
    rng = np.random.default_rng(3)
    friends = rng.integers(0, n, (n, k)).astype(np.int32)
    dw = jevent.ring_windows(jc)
    ring_len = dw * jevent.slot_cap(jc) + jevent.ring_tail(jc)
    assert ring_len == dw * tevent.slot_cap(tc) + tevent.ring_tail(tc)
    ring = rng.integers(0, 100, ring_len).astype(np.int32)
    lo = 30 if case == "overflow" else 0  # near the 40-entry cap
    cnt = rng.integers(lo, lo + 10, (1, dw)).astype(np.int32)
    sids = rng.permutation(n)[:m].astype(np.int32)
    svalid = rng.random(m) < 0.85
    sticks = (40 + rng.integers(0, 10, m)).astype(np.int32)
    flags = (rng.random(n) < 0.4).astype(np.uint8)
    sir = jc.protocol == "sir"
    strig = (svalid & (rng.random(m) < 0.7)) if sir else None
    sup = jc.dup_suppress_resolved
    jout = jevent.append_messages(
        jc, jnp.asarray(ring), jnp.asarray(cnt), jnp.zeros((), jnp.int32),
        jnp.asarray(sids), jnp.asarray(svalid), jnp.asarray(sticks),
        jnp.asarray(friends), jnp.full((n,), k, jnp.int32),
        jrng.base_key(jc.seed),
        strig=None if strig is None else jnp.asarray(strig),
        flags=jnp.asarray(flags) if sup else None, kernel="xla",
        phase2="xla")
    tflags = T(np.append(flags, np.uint8(0)))
    tring, tcnt, tdrop, tsup, tblk = tevent.append_messages(
        tc, T(ring.copy()), T(cnt.copy()), torch.zeros((), dtype=torch.int64),
        T(sids), T(svalid), T(sticks), T(friends), trng.base_key(tc.seed),
        strig=None if strig is None else T(strig),
        flags=tflags if sup else None, kernel=kernel, phase2=phase2)
    assert np.array_equal(np.asarray(jout[0]), tring.numpy())
    assert np.array_equal(np.asarray(jout[1]), tcnt.numpy())
    assert int(jout[2]) == int(tdrop)
    assert np.array_equal(np.asarray(jout[3]), tsup.numpy())
    assert int(jout[4]) == int(tblk)
    if case == "overflow":
        assert int(tdrop) > 0
    if case.startswith("partition"):
        assert int(tblk) > 0


@pytest.mark.parametrize("dw,m,cap", ((1536, 600, 3), (1025, 3000, 2)))
def test_ring_append_plain_matches_pallas_past_1024_slots(dw, m, cap):
    """The ring append's plain version past 1024 window slots (ROADMAP
    C1: its sorted per-slot ranks) against the Pallas kernel in interpret
    mode, slots filling and overflowing."""
    d, kw = _ring_inputs(23, m=m, dw=dw, cap=cap, width=12)
    args = (tuple(jnp.asarray(r) for r in d["rings"]), jnp.asarray(d["cnt"]),
            jnp.int32(3), tuple(jnp.asarray(p) for p in d["pays"]),
            jnp.asarray(d["wslot"]), jnp.asarray(d["valid"]), dw, cap)
    rings, cnt, dropped = jdeliver.fused_ring_append(*args, interpret=True)
    want = [np.asarray(r) for r in rings] + [np.asarray(cnt),
                                             np.asarray(dropped)]
    got = _ring_append(deliver.fused_ring_append, d, kw, torch.device("cpu"))
    for w, g in zip(want, got):
        assert np.array_equal(w, g.numpy())
    assert int(want[-1]) > 3  # some lanes overflowed their slots


@pytest.mark.parametrize("seed", (0, 1, 2))
def test_fused_unique_set_plain_matches_pallas(seed):
    rng = np.random.default_rng(seed)
    ring = rng.integers(-50, 50, 500).astype(np.int32)
    flat = rng.permutation(500)[:180].astype(np.int32)
    vals = rng.integers(0, 10**6, 180).astype(np.int32)
    (want,) = jdeliver.fused_unique_set(
        (jnp.asarray(ring),), jnp.asarray(flat), (jnp.asarray(vals),),
        interpret=True)
    got = deliver.fused_unique_set(T(ring.copy()), T(flat), T(vals))
    assert np.array_equal(np.asarray(want), got.numpy())


def test_cpu_path_never_launches():
    _build.reset_launches()
    d, kw = _emit_inputs(0)
    _port_emit(d, kw)
    deliver.fused_unique_set(torch.zeros(8, dtype=torch.int32),
                             torch.arange(4, dtype=torch.int32),
                             torch.ones(4, dtype=torch.int32))
    d, kw = _ring_inputs(0)
    _ring_append(deliver.fused_ring_append, d, kw, torch.device("cpu"))
    d, kw = _chunk_inputs(0)
    _chunk_step(deliver.fused_chunk_step, d, kw, False, torch.device("cpu"))
    d, kw = _negotiate_inputs(0, "breakup")
    _negotiate(overlay_kernel.fused_negotiate, d, kw, torch.device("cpu"))
    d, kw = _spill_inputs(0)
    _spill_step(deliver.fused_chunk_step, d, kw, True, torch.device("cpu"))
    d, fanout = _request_inputs(0)
    _request(overlay_kernel.fused_request_round, d, fanout,
             torch.device("cpu"))
    overlay_kernel.fused_hosted_chunk(T(_hosted_inputs(0, 2, 50)))
    d = _deposit_inputs(0)
    for kind, (_, wrapper) in DEPOSIT_FNS.items():
        _deposit(kind, wrapper, d, torch.device("cpu"))
    names = _build.KERNELS + _build.FORMS
    assert set(_build.LAUNCHES) == set(names)
    assert _build.LAUNCHES == {name: 0 for name in names}


def test_other_devices_raise_not_fall_back():
    """A tensor that is on neither the CPU nor a card reaches no plain
    version: the wrapper raises."""
    meta = dict(device="meta")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        deliver.fused_unique_set(torch.zeros(8, dtype=torch.int32, **meta),
                                 torch.zeros(4, dtype=torch.int32, **meta),
                                 torch.zeros(4, dtype=torch.int32, **meta))
    m, k = 4, 3
    args = [torch.zeros(64, dtype=torch.int32, **meta),
            torch.zeros((1, 2), dtype=torch.int32, **meta),
            torch.zeros((m, k), dtype=torch.int32, **meta),
            torch.zeros((m, k), dtype=torch.bool, **meta),
            torch.zeros(m, dtype=torch.bool, **meta),
            torch.zeros(m, dtype=torch.int32, **meta),
            torch.zeros(m, dtype=torch.int32, **meta)]
    with pytest.raises(ValueError, match="no kernel for device meta"):
        megakernel.fused_emit(*args, dw=2, cap=10, b=10)
    i32 = lambda *shape: torch.zeros(shape, dtype=torch.int32,  # noqa: E731
                                     **meta)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        deliver.fused_ring_append((i32(31),), i32(1, 3), i32(), (i32(4),),
                                  i32(4), torch.zeros(4, dtype=torch.bool,
                                                      **meta), 3, 10)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        deliver.fused_chunk_step(i32(41), i32(11), i32(), i32(4), i32(4), 10,
                                 4, False)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        deliver.fused_chunk_step(i32(41), i32(11), i32(), i32(4), i32(4), 10,
                                 4, False, spill=(i32(2, 5), i32()))
    with pytest.raises(ValueError, match="no kernel for device meta"):
        overlay_kernel.fused_negotiate(
            i32(4, 6), i32(4), i32(4), torch.zeros(4, dtype=torch.bool,
                                                   **meta), i32(4),
            kind="makeup", limit=6)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        overlay_kernel.fused_request_round(i32(4, 6), i32(4), i32(4),
                                           fanout=5)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        overlay_kernel.fused_hosted_chunk(i32(2, 9))
    with pytest.raises(ValueError, match="no kernel for device meta"):
        deliver.fused_deposit_add(i32(2, 9), i32(4), i32(4))
    with pytest.raises(ValueError, match="no kernel for device meta"):
        deliver.fused_deposit_rows(i32(2, 9, 3), i32(4), i32(4), i32(4, 3))
    with pytest.raises(ValueError, match="no kernel for device meta"):
        megakernel.fused_deposit_both(
            i32(2, 9), i32(2, 9, 3), i32(4), i32(4),
            torch.zeros(4, dtype=torch.bool, **meta),
            torch.zeros((2, 3), dtype=torch.bool, **meta))


def test_cuda_build_needs_the_card_toolchain(monkeypatch):
    """The CUDA route never degrades to the plain version: without nvcc the
    build raises, naming what is missing."""
    monkeypatch.setenv("PATH", "/nonexistent")
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setattr(_build.os.path, "isfile",
                        lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc_path()


def _c_params(path, symbol):
    """ctypes types of the extern "C" entry point `symbol` in `path`."""
    import ctypes
    import re

    src = open(path).read()
    params = re.search(rf"{symbol}\s*\(([^)]*)\)", src).group(1)
    kinds = []
    for p in params.split(","):
        p = p.strip()
        kinds.append(ctypes.c_void_p if "*" in p else
                     ctypes.c_longlong if "long long" in p else
                     ctypes.c_uint32 if "uint32_t" in p else
                     ctypes.c_float if "float" in p else ctypes.c_int)
    return kinds


@pytest.mark.parametrize("name,argtypes", (
    ("fused_emit", megakernel._ARGTYPES),
    ("fused_unique_set", deliver.UNIQUE_ARGTYPES),
    ("fused_ring_append", deliver.RING_ARGTYPES),
    ("fused_chunk_step", deliver.CHUNK_ARGTYPES),
    ("fused_negotiate", overlay_kernel.ARGTYPES),
    ("fused_request_round", overlay_kernel.REQUEST_ARGTYPES),
    ("fused_hosted_chunk", overlay_kernel.HOSTED_ARGTYPES),
    ("fused_deposit_add", deliver.DEPOSIT_ARGTYPES),
    ("fused_deposit_rows", deliver.ROWS_ARGTYPES),
    ("fused_deposit_both", megakernel.BOTH_ARGTYPES),
    ("fused_drain_sum", megakernel.DRAIN_ARGTYPES),
    ("kout_pallas", graph.KOUT_ARGTYPES),
    ("erdos_pallas", graph.ERDOS_ARGTYPES),
    ("fused_recv_land", megakernel.RECV_ARGTYPES),
    ("fused_unique_set:words", deliver.UNIQUE_WORDS_ARGTYPES)))
def test_ctypes_signatures_match_the_sources(name, argtypes):
    """A wrapper whose argtypes miss a parameter would have ctypes pass
    the rest as C ints and cut a pointer; hold each list to its C entry
    point's parameters (a second entry point of a source, `name:entry`,
    is gossip_<name>_<entry>)."""
    src, _, entry = name.partition(":")
    path = _build._target(src)[0]
    symbol = f"gossip_{src}_{entry}" if entry else f"gossip_{src}"
    assert _c_params(path, symbol) == list(argtypes)


@pytest.mark.parametrize("spill", (False, True))
def test_chunk_step_scratch_grows_with_m_not_nk(monkeypatch, spill):
    """fused_chunk_step's scratch is O(m): the wrapper allocates
    chunk_scratch_elems(m, spill) int32 cells and nothing sized by nk (no
    zeroed per-key offsets); the same m at nk = 10**3 and 10**8 takes the
    same bytes.  Driven through the wrapper's launch path on meta tensors,
    its C entry point replaced by a recorder."""
    i32 = lambda *shape: torch.empty(shape, dtype=torch.int32,  # noqa: E731
                                     device="meta")
    cap = 8
    cases = {(nk, m): [i32(nk * cap + 1), i32(nk + 1), i32(), i32(m),
                       i32(m)]
             for nk in (10**3, 10**8) for m in (1000, 5000)}
    spills = (i32(2, 101), i32()) if spill else None
    calls, allocs = [], []
    monkeypatch.setattr(deliver._build, "function",
                        lambda *a: lambda *args: calls.append(args) or 0)
    monkeypatch.setattr(deliver._build, "LAUNCHES", dict(_build.LAUNCHES))
    monkeypatch.setattr(deliver, "_stream", lambda dev: 0)
    for name in ("empty", "zeros", "full"):
        def record(*a, _real=getattr(torch, name), **kw):
            t = _real(*a, **kw)
            allocs.append(t.numel())
            return t
        monkeypatch.setattr(torch, name, record)
    got = {}
    for (nk, m), st in cases.items():
        allocs.clear()
        deliver._chunk_launch(*st, nk, cap, True, spills)
        got[nk, m] = (list(allocs), calls[-1][10])
        assert got[nk, m] == ([deliver.chunk_scratch_elems(m, spill)],
                              deliver.chunk_scratch_elems(m, spill))
    for m in (1000, 5000):
        assert got[10**3, m] == got[10**8, m]
    assert got[10**8, 5000][1] > got[10**8, 1000][1]
    assert max(got[10**8, 5000][0]) < 10**6


def test_chunk_scratch_constants_match_the_source():
    """chunk_scratch_elems sizes the scratch the C entry point lays out
    (it refuses a smaller one): hold its constants to the source's."""
    import re

    src = open(_build._target("fused_chunk_step")[0]).read()
    num = {k: int(v) for k, v in
           re.findall(r"^#define (\w+) (\d+)\b", src, re.M)}
    assert deliver.CHUNK_TILE == num["THREADS"] * num["ITEMS"]
    assert deliver.CHUNK_RADIX_MAX == 1 << num["RADIX_BITS_MAX"]
    assert deliver.CHUNK_PASSES_MAX == num["PASSES_MAX"]
    assert deliver.CHUNK_PASSES_MAX * num["RADIX_BITS_MAX"] >= 31


def test_unique_set_launch_takes_lanes_and_raw_stream(monkeypatch):
    """fused_unique_set's launch path builds and types its C entry point
    once, passes the three pointers, the lane count and the current
    stream's raw handle of the ring's card to it, counts each launch, and
    refuses a ring it cannot write in place."""
    built, calls = [], []

    def function(*a):
        built.append(a)
        return lambda *args: calls.append(args) or 0

    monkeypatch.setattr(deliver._build, "function", function)
    monkeypatch.setattr(deliver._build, "LAUNCHES", dict(_build.LAUNCHES))
    monkeypatch.setattr(deliver, "_stream", lambda index: 77 + index)
    ring, flat, vals = (torch.empty(n, dtype=torch.int32, device="meta")
                        for n in (64, 9, 9))
    deliver._unique_fn.cache_clear()
    try:
        for _ in range(3):
            assert deliver._launch(ring, flat, vals) is ring
    finally:
        deliver._unique_fn.cache_clear()
    assert built == [(deliver.NAME, "gossip_fused_unique_set",
                      deliver.UNIQUE_ARGTYPES)]
    assert len(calls) == 3 and calls[0][3:] == (9, 76)
    assert deliver._build.LAUNCHES[deliver.NAME] == 3
    with pytest.raises(ValueError, match="ring must be contiguous"):
        deliver._launch(ring[::2], flat, vals)


def _source_defines(name):
    """The integer #defines of csrc/<name>.cu (or of the header csrc/<name>
    when it names one), products of two integers (``(220 * 1024)``) and
    shifts (``(1 << 30)``) evaluated."""
    import os
    import re

    path = (os.path.join(_build.CSRC, name) if name.endswith(".cuh")
            else _build._target(name)[0])
    src = open(path).read()
    out = {}
    for key, a, op, b in re.findall(
            r"^#define (\w+) \(?(\d+)(?: (\*|<<) (\d+)\))?", src, re.M):
        out[key] = (int(a) * int(b) if op == "*" else
                    int(a) << int(b) if op == "<<" else int(a))
    return out


def test_drain_and_recv_constants_match_the_sources():
    """The wrappers size the scratch, workspace and partitions the C entry
    points lay out (they refuse a smaller one): hold the constants."""
    import os

    d = _source_defines("fused_drain_sum")
    assert megakernel.DRAIN_PART_MAX == d["PART_MAX"]
    assert megakernel.DRAIN_STAGE_MAX == d["STAGE_MAX"]
    assert megakernel.DRAIN_COARSE == d["COARSE"]
    assert megakernel.DRAIN_TILE_MAX == d["TILE_SMEM_MAX"]
    assert -(-megakernel.DRAIN_PART_MAX // megakernel.DRAIN_COARSE) \
        <= megakernel.DRAIN_STAGE_MAX
    r = _source_defines("lookback.cuh")
    assert deliver.APPEND_TILE == r["THREADS"] * r["ITEMS"]
    # The head: the counters' word, then 2 * DW_LIMIT + 2 int32 sums.
    assert deliver.APPEND_WS_HEAD == r["DW_LIMIT"] + 2
    assert "#define WS_HEAD (DW_LIMIT + 2)" in open(
        os.path.join(_build.CSRC, "lookback.cuh")).read()
    assert deliver.APPEND_EPOCH_MAX == r["EPOCH_MAX"]
    # The global form's grid and the tables' warps a block.
    assert deliver.APPEND_GLOBAL_GRID == r["GLOBAL_GRID"]
    assert deliver.APPEND_WARPS == r["THREADS"] // 32
    assert r["DW_LIMIT"] == deliver.RING_SLOTS_MAX
    e = _source_defines("fused_emit")
    assert megakernel.EMIT_TILE == r["THREADS"] * e["EMIT_ITEMS"]
    # The three single-pass appends take the shared header's layout, and
    # define none of their own.
    for name in ("fused_recv_land", "fused_ring_append", "fused_emit"):
        src = open(_build._target(name)[0]).read()
        assert '#include "lookback.cuh"' in src
        assert not set(_source_defines(name)) & set(r), name
    # Both deposits of rows list their lanes through one header.
    for name in ("fused_deposit_rows", "fused_deposit_both"):
        src = open(_build._target(name)[0]).read()
        assert '#include "lanes.cuh"' in src and "listing::lanes(" in src


def test_dynamic_shared_memory_goes_through_one_allow_smem():
    """A launch gets 48 KB of shared memory less its kernel's static shared
    memory unless the attribute is set: the kernels that take dynamic
    shared memory past that set it through csrc/smem.cuh's allow_smem
    (lookback.cuh includes it) and keep no copy of their own."""
    import os

    with open(os.path.join(_build.CSRC, "smem.cuh")) as f:
        assert "cudaFuncAttributeMaxDynamicSharedMemorySize" in f.read()
    with open(os.path.join(_build.CSRC, "lookback.cuh")) as f:
        hdr = f.read()
    assert '#include "smem.cuh"' in hdr and "cudaFuncSetAttribute" not in hdr
    for name in ("fused_drain_sum", "fused_recv_land", "fused_ring_append",
                 "fused_emit", "fused_deposit_add", "erdos_pallas"):
        with open(_build._target(name)[0]) as f:
            src = f.read()
        assert "allow_smem((const void*)" in src, name
        assert "cudaFuncSetAttribute" not in src, name


def test_block_scans_go_through_one_scan_header():
    """The block-wide exclusive sum is csrc/scan.cuh's block_excl, templated
    on the block's threads: the kernels that scan across a block include it
    and keep no scan of their own."""
    import os

    with open(os.path.join(_build.CSRC, "scan.cuh")) as f:
        assert "__shfl_up_sync" in f.read()
    for name in ("fused_chunk_step", "fused_drain_sum", "fused_deposit_add",
                 "erdos_pallas"):
        with open(_build._target(name)[0]) as f:
            src = f.read()
        assert '#include "scan.cuh"' in src, name
        assert "scan::block_excl<" in src, name
        assert "__device__ int block_excl" not in src, name
        assert "block_exclusive" not in src, name


def test_deposit_and_erdos_constants_match_the_sources():
    """fused_deposit_add's partition limit and offset width, and the erdos
    kernel's lane tile, held to the C sources."""
    d = _source_defines("fused_deposit_add")
    assert deliver.DEPOSIT_PART_MAX == d["PART_MAX"]
    assert deliver.DEPOSIT_PART_BITS <= d["BITS_MAX"] == 16
    # A partition's tile fits the card's shared memory (227 KB a block).
    assert 4 << deliver.DEPOSIT_PART_BITS <= 227 << 10
    e = _source_defines("erdos_pallas")
    assert graph.LANES == e["CAP_MAX"]


def test_erdos_urem_signature_matches_the_source():
    path = _build._target("erdos_pallas")[0]
    assert _c_params(path, "gossip_erdos_urem") == graph.UREM_ARGTYPES


@pytest.mark.parametrize("cells", (1, 1 << 15, 2 * 10**7, 6 * 10**7,
                                   2 * 10**8, (1 << 15) * 8192,
                                   (1 << 15) * 8192 + 1))
def test_deposit_form_follows_the_lanes_a_cell(cells, monkeypatch):
    """deposit_part_bits: the direct form (0) below DEPOSIT_DENSE_MIN lanes
    a ring cell, else DEPOSIT_PART_BITS while the partitions number at
    most DEPOSIT_PART_MAX, and the direct form again past that; the
    shapes alone decide."""
    lim = deliver.DEPOSIT_DENSE_MIN
    bits = deliver.DEPOSIT_PART_BITS
    below = max(0, int(lim * cells) - 1)
    assert deliver.deposit_part_bits(below, cells) == 0
    m = int(lim * cells) + 1
    fits = -(-cells // (1 << bits)) <= deliver.DEPOSIT_PART_MAX
    assert deliver.deposit_part_bits(m, cells) == (bits if fits else 0)
    monkeypatch.setattr(deliver, "DEPOSIT_DENSE_MIN", 1e9)
    assert deliver.deposit_part_bits(m, cells) == 0
    assert deliver.deposit_part_bits(0, 0) == 0


def test_deposit_takes_its_measured_form_at_the_full_runs_shapes():
    """With the wrapper's own crossover: the rounds-mode deposit of
    ring_rounds10m (6e7 lanes over 2 x 1e7 cells) takes the dense form;
    ring_kout10m's compacted chunk (468,750 lanes over 20 x 1e7) and
    rumors1m's dense deposit (6e6 lanes over 20 x 1e6) the direct one."""
    assert deliver.deposit_part_bits(6 * 10**7, 2 * 10**7) == 15
    assert deliver.deposit_part_bits(468_750, 2 * 10**8) == 0
    assert deliver.deposit_part_bits(6 * 10**6, 2 * 10**7) == 0


@pytest.mark.parametrize("m", (1, 15, 16, 17, 1000, 6 * 10**7))
@pytest.mark.parametrize("parts", (1, 3, 611, 6104, 8192))
def test_deposit_buckets_take_about_two_bytes_a_lane(m, parts):
    """Each bucket holds ceil(m / P) offsets rounded up to 16 (32-byte
    aligned starts): all buckets together at most m + 16 P offsets, and
    every lane fits when the lanes spread evenly."""
    bcap = deliver.deposit_bucket_cap(m, parts)
    assert bcap % 16 == 0 and bcap >= 16
    assert bcap * parts >= m
    assert bcap * parts < m + 16 * parts + parts


def test_deposit_launch_picks_its_form_and_keeps_a_workspace(monkeypatch):
    """fused_deposit_add's launch path: the direct form passes no
    workspace, allocates nothing and counts one launch of the kernel; the
    dense form passes its partition bits, the (card, stream) workspace --
    cursors and the overflow word zeroed once, buckets grown to P * bcap
    offsets and then kept -- and counts the dense form too; `valid` goes
    through as a pointer or null.  CPU tensors, the C entry point replaced
    by a recorder."""
    calls, allocs = [], []
    monkeypatch.setattr(deliver, "_add_fn",
                        lambda: lambda *a: calls.append(a) or 0)
    monkeypatch.setattr(deliver._build, "LAUNCHES", dict(_build.LAUNCHES))
    monkeypatch.setattr(deliver, "_DEP_WS", {})
    monkeypatch.setattr(deliver, "_stream", lambda index: 5)
    for name in ("empty", "zeros", "full"):
        def record(*a, _real=getattr(torch, name), **kw):
            t = _real(*a, **kw)
            allocs.append(t.numel())
            return t
        monkeypatch.setattr(torch, name, record)
    b, n = 2, 40_000
    i32 = dict(dtype=torch.int32)
    pending = torch.zeros((b, n), **i32)
    few = torch.zeros(100, **i32)
    allocs.clear()
    deliver._add_launch(pending, few, few, None)
    a = calls[-1]
    assert allocs == [] and a[3] is None and a[7:11] == (0, None, None, 0)
    assert a[4:7] == (100, b, n) and a[11] == 5
    many = torch.zeros(3 * b * n, **i32)
    valid = torch.ones(3 * b * n, dtype=torch.bool)
    allocs.clear()
    deliver._add_launch(pending, many, many, valid)
    a = calls[-1]
    parts = -(-(b * n) // (1 << 15))
    bcap = deliver.deposit_bucket_cap(3 * b * n, parts)
    ws, bucket = deliver._DEP_WS[None, 5]
    assert a[3] == valid.data_ptr() and a[7] == 15 and a[10] == bcap
    assert a[8] == ws.data_ptr() and a[9] == bucket.data_ptr()
    assert ws.numel() == deliver.DEPOSIT_PART_MAX + 1
    assert int(ws.abs().sum()) == 0 and bucket.dtype == torch.int16
    assert bucket.numel() >= parts * bcap
    assert allocs == [deliver.DEPOSIT_PART_MAX + 1, bucket.numel()]
    allocs.clear()
    deliver._add_launch(pending, many, many, valid)
    assert allocs == [] and calls[-1][8:10] == (ws.data_ptr(),
                                               bucket.data_ptr())
    assert deliver._build.LAUNCHES[deliver.DEPOSIT] == 3
    assert deliver._build.LAUNCHES[deliver.DEPOSIT_DENSE] == 2


@pytest.mark.parametrize("c", (8, 12, 36))
@pytest.mark.parametrize("budget", (48, 5_000, 96 << 10, 192 << 10,
                                    220 << 10, 256 << 10))
def test_drain_partitions_cover_the_rows_within_the_budget(c, budget):
    """drain_part_rows cuts [0, n) into ceil(n / R) slices of R rows (the
    last ragged), each of at most `budget` bytes while that takes at most
    DRAIN_PART_MAX slices, and never past the DRAIN_TILE_MAX tile; the
    direct kernel (0) while the whole accumulator is within direct_max, and
    where even DRAIN_PART_MAX slices (or the budget's own) outgrow the
    tile."""
    tile = megakernel.DRAIN_TILE_MAX
    for n in (1, 7, 1_000, 1_250_000, 10_000_000, 100_000_000):
        assert megakernel.drain_part_rows(n, c, budget, n * c * 4) == 0
        rows = megakernel.drain_part_rows(n, c, budget, 0)
        want = max(1, budget // (4 * c))
        if rows == 0:
            assert want * c * 4 > tile or -(
                -n // megakernel.DRAIN_PART_MAX) * c * 4 > tile
            continue
        parts = -(-n // rows)
        assert 1 <= parts <= megakernel.DRAIN_PART_MAX
        assert (parts - 1) * rows < n <= parts * rows
        assert rows * c * 4 <= tile
        if -(-n // want) <= megakernel.DRAIN_PART_MAX:
            assert rows <= want
        # Even slices: none is more than a row longer than n / parts.
        assert rows <= n / parts + 1


def test_drain_takes_the_tile_form_at_pushsums_shapes():
    """With the wrapper's own budgets: the tile form at pushsum10m's
    accumulator (10^7 x 12, 2048-row slices) and at pushsum10m_sharded's
    per-shard one (1.25e6 x 12) and from 24 MiB on (measured faster
    there); the direct kernel up to 12 MiB (measured faster), for the
    small accumulators of the tests, and where the tile cannot reach
    (10^8 x 12)."""
    assert megakernel.drain_part_rows(10_000_000, 12) == 2048
    assert megakernel.drain_part_rows(1_250_000, 12) > 0
    assert megakernel.drain_part_rows(1 << 19, 12) > 0  # 24 MiB
    assert megakernel.drain_part_rows(174_763, 36) > 0  # 24 MiB
    assert megakernel.drain_part_rows(1 << 18, 12) == 0  # 12 MiB
    assert megakernel.drain_part_rows(87_381, 36) == 0  # 12 MiB
    assert megakernel.drain_part_rows(500, 12) == 0
    assert megakernel.drain_part_rows(100_000_000, 12) == 0


def test_drain_scratch_grows_with_cap_not_n(monkeypatch):
    """fused_drain_sum's scratch is O(cap): the launch path allocates
    drain_scratch_elems(cap, n, R) int32 cells, passes that count, and
    nothing sized by n (no zeroed per-row cells): at one cap it stays
    within 4 * cap + a few DRAIN_PART_MAX-sized arrays from n = 1e4 to
    3e7 (one scatter pass, two, and slices grown to stay within
    DRAIN_PART_MAX); it doubles with
    cap.  Driven through the launch path on meta tensors, the partitioned
    form forced (DRAIN_DIRECT_MAX 0), its C entry point replaced by a
    recorder."""
    calls, allocs = [], []
    monkeypatch.setattr(megakernel._build, "function",
                        lambda *a: lambda *args: calls.append(args) or 0)
    monkeypatch.setattr(megakernel._build, "LAUNCHES",
                        dict(_build.LAUNCHES))
    monkeypatch.setattr(deliver, "_stream", lambda index: 0)
    for name in ("empty", "zeros", "full"):
        def record(*a, _real=getattr(torch, name), **kw):
            t = _real(*a, **kw)
            allocs.append(t.numel())
            return t
        monkeypatch.setattr(torch, name, record)
    direct = megakernel.DRAIN_DIRECT_MAX
    monkeypatch.setattr(megakernel, "DRAIN_DIRECT_MAX", 0)
    meta = dict(dtype=torch.int32, device="meta")
    c, dw, b = 12, 3, 10
    ns = (10**4, 10**6, 3 * 10**7)
    got = {}
    for cap in (1_000, 2_000):
        ids = torch.empty(dw * cap + 1, **meta)
        mass = torch.empty((dw * cap + 1, c), **meta)
        cnt = torch.empty((1, dw), **meta)
        for n in ns:
            acc = torch.empty((n, c), **meta)
            allocs.clear()
            megakernel._drain_launch(acc, ids, mass, cnt, 1, cap, b)
            rows = megakernel.drain_part_rows(n, c)
            want = megakernel.drain_scratch_elems(cap, n, rows)
            assert rows > 0 and allocs == [want] and calls[-1][9:12] == (
                rows, calls[-1][10], want)
            got[cap, n] = want
    # At 3e7 rows the slices grow past the budget to stay within
    # DRAIN_PART_MAX.
    assert megakernel.drain_part_rows(ns[-1], c) * c * 4 \
        > megakernel.DRAIN_BUDGET
    fixed = 3 * megakernel.DRAIN_PART_MAX + 2 * megakernel.DRAIN_COARSE + 3
    for cap in (1_000, 2_000):
        for n in ns:
            assert 2 * cap < got[cap, n] <= 4 * cap + fixed
    assert got[2_000, ns[-1]] - got[1_000, ns[-1]] == 4 * 1_000
    # The direct kernel takes no scratch: a small accumulator under the
    # wrapper's own DRAIN_DIRECT_MAX, and one past the tile's reach.
    monkeypatch.setattr(megakernel, "DRAIN_DIRECT_MAX", direct)
    ring = (torch.empty(dw * 1_000 + 1, **meta),
            torch.empty((dw * 1_000 + 1, c), **meta),
            torch.empty((1, dw), **meta))
    for n in (10, 10**8):
        acc = torch.empty((n, c), **meta)
        allocs.clear()
        megakernel._drain_launch(acc, *ring, 1, 1_000, b)
        assert allocs == [] and calls[-1][9:12] == (0, None, 0)


def test_recv_launch_keeps_a_workspace_per_stream(monkeypatch):
    """fused_recv_land's launch path keeps one zeroed int64 workspace per
    (card, stream) of workspace_words(m, dw) words or more, grows it
    when a call needs more, passes the raw stream and a new epoch each
    call (1, 2, ... on each stream; from 1 again in a grown workspace,
    which is new and zeroed), and when the epoch reaches
    APPEND_EPOCH_MAX zeroes the workspace and starts again at 1 (no old
    look-back word can read as the new call's); sup comes from
    torch.empty.  CPU tensors, the C entry point replaced by a recorder,
    the stream handle set by the test."""
    calls, built = [], []

    def entry(*args):
        calls.append(args)
        return 0

    monkeypatch.setattr(megakernel, "_recv_fn",
                        lambda: built.append(1) or entry)
    monkeypatch.setattr(megakernel._build, "LAUNCHES",
                        dict(_build.LAUNCHES))
    monkeypatch.setattr(deliver, "_WS", {})
    stream = [11]
    monkeypatch.setattr(deliver, "_stream", lambda index: stream[0])
    d, kw = _recv_inputs(5)
    ring, cnt = T(d["ring"].copy()), T(d["cnt"].copy())
    dropped = torch.tensor(0, dtype=torch.int32)

    def launch(m):
        recv = torch.full((m,), -1, dtype=torch.int32)
        megakernel._recv_launch(ring, cnt, dropped, recv, kw["dw"],
                                kw["cap"], kw["b"], None, None, None, 1)
        a = calls[-1]
        return a[14], a[15], a[16], a[19]  # ws, ws_words, epoch, stream

    ws, words, epoch, st = launch(1200)
    assert (epoch, st) == (1, 11)
    table = deliver._WS
    key = (torch.device("cpu").index, 11)
    assert words == table[key][0].numel() >= deliver.workspace_words(
        1200, kw["dw"])
    assert ws == table[key][0].data_ptr()
    assert table[key][0].dtype == torch.int64
    assert int(table[key][0].abs().sum()) == 0
    assert [launch(1200)[2] for _ in range(3)] == [2, 3, 4]
    assert launch(1200)[0] == ws  # kept, not reallocated
    stream[0] = 12  # another stream: its own workspace, its own epochs
    ws2, _, e2, st2 = launch(1200)
    assert (e2, st2) == (1, 12) and ws2 != ws
    stream[0] = 11
    big = deliver.APPEND_TILE * 40
    _, words_big, e3, _ = launch(big)  # grown: a new zeroed workspace
    assert words_big >= deliver.workspace_words(big, kw["dw"])
    assert e3 == 1
    table[key][0].fill_(7)  # stale look-back words
    table[key][1] = deliver.APPEND_EPOCH_MAX - 1
    _, _, e4, _ = launch(big)
    assert e4 == 1 and int(table[key][0].abs().sum()) == 0
    assert launch(big)[2] == 2
    assert megakernel._build.LAUNCHES[megakernel.RECV] == 9
    assert len(built) == 9  # the typed entry point, held by _recv_fn


@pytest.mark.parametrize("m,dw,blocks", (
    (0, 3, 1), (1, 3, 1), (2048, 3, 1), (2049, 3, 2), (262_144, 3, 128),
    (60_000_000, 3, 29_297), (50_000, 1024, 25)))
def test_append_workspace_words_cover_the_look_back(m, dw, blocks):
    """A single-pass append of m lanes runs ceil(m / APPEND_TILE) blocks
    (one for m = 0) and takes the head and a look-back word per (block,
    slot): at the overlay's batch, 128 blocks; at PushSum's window,
    29,297."""
    assert deliver.workspace_words(m, dw) == (deliver.APPEND_WS_HEAD
                                              + blocks * dw)


def test_ring_launch_shares_the_workspace_and_allocates_nothing(
        monkeypatch):
    """fused_ring_append's launch path is one C call a call with no
    per-call allocation: it takes the (card, stream) workspace that
    fused_recv_land uses too, a new epoch each call whichever of the two
    kernels made the last one, passes the companion ring's columns (1 flat
    or absent, W wide) and counts one launch; at APPEND_EPOCH_MAX the
    epoch starts again at 1 on a zeroed workspace.  CPU tensors, both C
    entry points replaced by recorders."""
    calls = []

    def entry(kind):
        def fn(*args):
            calls.append((kind, args))
            return 0
        return fn

    monkeypatch.setattr(deliver, "_ring_fn", lambda: entry("ring"))
    monkeypatch.setattr(megakernel, "_recv_fn", lambda: entry("recv"))
    monkeypatch.setattr(deliver._build, "LAUNCHES", dict(_build.LAUNCHES))
    monkeypatch.setattr(deliver, "_WS", {})
    monkeypatch.setattr(deliver, "_stream", lambda index: 5)
    allocs = []
    for name in ("empty", "zeros", "full", "zeros_like", "empty_like"):
        def record(*a, _real=getattr(torch, name), _name=name, **kw):
            allocs.append(_name)
            return _real(*a, **kw)
        monkeypatch.setattr(torch, name, record)

    def ring_call(width, m=300):
        d, kw = _ring_inputs(3, m=m, width=width)
        rings = tuple(T(r.copy()) for r in d["rings"])
        deliver._ring_launch(rings, T(d["cnt"].copy()),
                             torch.tensor(0, dtype=torch.int32),
                             tuple(T(p) for p in d["pays"]), T(d["wslot"]),
                             T(d["valid"]), kw["dw"], kw["cap"])
        return calls[-1][1]

    a = ring_call(None)  # the first call makes the workspace
    assert allocs == ["zeros"]
    allocs.clear()
    assert a[10] == 1 and a[14] == 1 and a[17] == 5
    ws = deliver._WS[None, 5][0]
    assert (a[12], a[13]) == (ws.data_ptr(), ws.numel())
    assert ws.numel() >= deliver.workspace_words(300, 3)
    assert ring_call(12)[10] == 12 and calls[-1][1][14] == 2
    d, kw = _recv_inputs(5)
    recv = torch.full((600,), -1, dtype=torch.int32)
    allocs.clear()
    megakernel._recv_launch(T(d["ring"].copy()), T(d["cnt"].copy()),
                            torch.tensor(0, dtype=torch.int32), recv,
                            kw["dw"], kw["cap"], kw["b"], None, None, None, 1)
    assert calls[-1][0] == "recv" and calls[-1][1][14] == ws.data_ptr()
    assert calls[-1][1][16] == 3  # the recv call took the next epoch
    assert allocs == ["empty"]  # recv's sup, nothing of the ring's
    allocs.clear()
    assert ring_call(None)[14] == 4 and allocs == []
    deliver._WS[None, 5][1] = deliver.APPEND_EPOCH_MAX - 1
    ws.fill_(7)
    a = ring_call(None)
    assert a[14] == 1 and int(ws.abs().sum()) == 0
    assert deliver._build.LAUNCHES[deliver.RING] == 4
    assert [k for k, _ in calls] == ["ring", "ring", "recv", "ring", "ring"]


@pytest.mark.parametrize("m,dw,blocks", (
    (0, 3, 1), (256, 3, 1), (257, 3, 2), (131_072, 3, 512),
    (65_536, 40, 256)))
def test_emit_workspace_words_cover_the_look_back(m, dw, blocks):
    """fused_emit runs ceil(m / EMIT_TILE) blocks of senders (one for m =
    0) on the appends' workspace: 512 at the main path's batch."""
    assert deliver.workspace_words(m, dw, megakernel.EMIT_TILE) == (
        deliver.APPEND_WS_HEAD + blocks * dw)


def test_emit_launch_shares_the_workspace_and_allocates_its_outputs_only(
        monkeypatch):
    """fused_emit's launch path is one C call a call on the (card, stream)
    workspace that the ring appends use (a new epoch each call, whichever
    kernel made the last one), sized for EMIT_TILE senders a block; its
    only allocation is the torch.empty of its 2 * dw + 2 outputs, which
    it returns as views (adds, sup, lost, blocked); the group of threads
    a row follows kw.  CPU tensors, the C entry points replaced by
    recorders."""
    calls = []

    def entry(kind):
        def fn(*args):
            calls.append((kind, args))
            return 0
        return fn

    monkeypatch.setattr(megakernel, "_emit_fn", lambda: entry("emit"))
    monkeypatch.setattr(deliver, "_ring_fn", lambda: entry("ring"))
    monkeypatch.setattr(deliver._build, "LAUNCHES", dict(_build.LAUNCHES))
    monkeypatch.setattr(deliver, "_WS", {})
    monkeypatch.setattr(deliver, "_stream", lambda index: 9)
    allocs = []
    for name in ("empty", "zeros", "full", "zeros_like", "empty_like"):
        def record(*a, _real=getattr(torch, name), _name=name, **kw):
            allocs.append((_name, a))
            return _real(*a, **kw)
        monkeypatch.setattr(torch, name, record)

    def emit_call(**case):
        d, kw = _emit_inputs(4, **case)
        args = [T(d["ring"].copy()), T(d["cnt"]), T(d["sf"]),
                T(d["drop"]), T(d["svalid"]), T(d["wslot"]), T(d["off"])]
        out = megakernel._launch(
            *args, strig=T(d["strig"]) if "strig" in d else None,
            sender_ids=T(d["sids"]) if "sids" in d else None, flags=None,
            received_bit=1, tb=kw.pop("tb", None), **kw)
        return out, calls[-1][1]

    (_, adds, sup, lost, blk), a = emit_call(m=600)  # makes the workspace
    assert [x[0] for x in allocs] == ["zeros", "empty"]
    assert allocs[1][1] == (8,)  # the outputs: 2 * dw + 2
    ws = deliver._WS[None, 9][0]
    assert ws.numel() >= deliver.workspace_words(600, 3,
                                                 megakernel.EMIT_TILE)
    assert (a[23], a[24], a[25], a[28]) == (ws.data_ptr(), ws.numel(), 1, 9)
    assert (a[26], a[27]) == (None, 0)  # the shared form: no second part
    assert a[22] == adds.data_ptr() and a[21] == 1  # group: kw 6
    assert a[11] is None  # no partition mask
    assert (a[12], a[13], a[20]) == (None, None, 0)  # no rumor words
    assert (adds.shape, sup.shape, lost.shape, blk.shape) == (
        (3,), (3,), (), ())
    assert sup.data_ptr() == adds.data_ptr() + 12
    allocs.clear()
    a = emit_call(k=37, sir=True, m=100)[1]
    assert a[21] == 8 and a[25] == 2 and len(allocs) == 1
    d, kw = _ring_inputs(3, m=300)
    deliver._ring_launch(tuple(T(r.copy()) for r in d["rings"]),
                         T(d["cnt"].copy()), torch.tensor(0, dtype=torch.int32),
                         tuple(T(p) for p in d["pays"]), T(d["wslot"]),
                         T(d["valid"]), kw["dw"], kw["cap"])
    assert calls[-1][1][14] == 3  # the ring append took the next epoch
    assert emit_call(m=0)[1][25] == 4
    assert deliver._build.LAUNCHES[megakernel.NAME] == 3
    assert [k for k, _ in calls] == ["emit", "emit", "ring", "emit"]


def test_global_form_takes_the_second_part_with_its_sums_zeroed(
        monkeypatch):
    """Past RING_SLOTS_MAX slots the three appends pass the workspace's
    second part (aux_ints cells: the sums, then a table set for each block
    of a grid of at most APPEND_GLOBAL_GRID), its sums zeroed before each
    call (another depth's or grid's tables may lie there); the shared
    form passes none.  CPU tensors, the C entry points replaced by
    recorders."""
    calls = []

    def entry(*args):
        calls.append(args)
        return 0

    monkeypatch.setattr(megakernel, "_emit_fn", lambda: entry)
    monkeypatch.setattr(deliver, "_ring_fn", lambda: entry)
    monkeypatch.setattr(deliver._build, "LAUNCHES", dict(_build.LAUNCHES))
    monkeypatch.setattr(deliver, "_WS", {})
    monkeypatch.setattr(deliver, "_AUX", {})
    monkeypatch.setattr(deliver, "_stream", lambda index: 4)
    d, kw = _emit_inputs(5, dw=1536, m=300, cap=5)
    args = [T(d["ring"].copy()), T(d["cnt"]), T(d["sf"]), T(d["drop"]),
            T(d["svalid"]), T(d["wslot"]), T(d["off"])]
    megakernel._launch(*args, strig=None, sender_ids=None, flags=None,
                       received_bit=1, **dict(kw, tb=None))
    aux = deliver._AUX[None, 4]
    want = deliver.aux_ints(300, 1536, megakernel.EMIT_TILE)
    assert want == (2 * 1536 + 2 + 3) // 4 * 4 + 2 * 18 * 1536  # 2 tiles
    assert (calls[-1][26], calls[-1][27]) == (aux.data_ptr(), aux.numel())
    assert aux.numel() >= want
    aux.fill_(7)  # tables left by a call
    d, kw = _ring_inputs(3, m=5000, dw=2000, cap=9)
    deliver._ring_launch(tuple(T(r.copy()) for r in d["rings"]),
                         T(d["cnt"].copy()),
                         torch.tensor(0, dtype=torch.int32),
                         tuple(T(p) for p in d["pays"]), T(d["wslot"]),
                         T(d["valid"]), 2000, 9)
    aux = deliver._AUX[None, 4]
    assert int(aux[:2 * 2000 + 2].abs().sum()) == 0
    assert (calls[-1][15], calls[-1][16]) == (aux.data_ptr(), aux.numel())
    assert aux.numel() >= deliver.aux_ints(5000, 2000)
    d, kw = _ring_inputs(3, m=300)
    deliver._ring_launch(tuple(T(r.copy()) for r in d["rings"]),
                         T(d["cnt"].copy()),
                         torch.tensor(0, dtype=torch.int32),
                         tuple(T(p) for p in d["pays"]), T(d["wslot"]),
                         T(d["valid"]), kw["dw"], kw["cap"])
    assert (calls[-1][15], calls[-1][16]) == (None, 0)  # the shared form
    assert deliver.aux_ints(10**8, 4096) == (
        (2 * 4096 + 2 + 3) // 4 * 4 + deliver.APPEND_GLOBAL_GRID * 18 * 4096)


def test_emit_group_follows_the_row_width():
    """A thread serves a row of up to eight lanes (the main path's 6 and
    7), eight threads a wider one."""
    assert [megakernel.emit_group(kw) for kw in (1, 6, 7, 8, 9, 33, 38, 112)] \
        == [1, 1, 1, 1, 8, 8, 8, 8]


def test_unported_inputs_raise():
    d, kw = _emit_inputs(0)
    args = [T(d["ring"].copy()), T(d["cnt"]), T(d["sf"]), T(d["drop"]),
            T(d["svalid"]), T(d["wslot"]), T(d["off"])]
    # The partition mask is ported (ROADMAP A10); one of the wrong shape
    # is refused.
    with pytest.raises(ValueError, match="pmask must be"):
        megakernel._emit_check(*args, kw["dw"], kw["cap"], None, None, None,
                               pmask=torch.zeros((47, 6), dtype=torch.bool))
    # Rumor words are ported (ROADMAP A11); words without their ring, of
    # the wrong type or shape, or beside the SIR trigger lane are refused.
    with pytest.raises(ValueError, match="go together"):
        megakernel.fused_emit(*args, swords=torch.zeros((48, 1)), **kw)
    ring_w = torch.zeros((args[0].shape[0], 1), dtype=torch.int32)
    with pytest.raises(ValueError, match="swords must be int32"):
        megakernel.fused_emit(*args, swords=torch.zeros((48, 1)),
                              mail_words=ring_w, **kw)
    with pytest.raises(ValueError, match="mail_words must be int32"):
        megakernel.fused_emit(*args, swords=torch.zeros(
            (48, 2), dtype=torch.int32), mail_words=ring_w, **kw)
    with pytest.raises(ValueError, match="SI only"):
        megakernel.fused_emit(
            *args, swords=torch.zeros((48, 1), dtype=torch.int32),
            mail_words=ring_w, strig=torch.ones(48, dtype=torch.bool),
            sender_ids=torch.zeros(48, dtype=torch.int32), tb=610, **kw)
    with pytest.raises(ValueError, match="the word ring must be int32"):
        deliver.fused_unique_set(
            (torch.zeros(8, dtype=torch.int32),
             torch.zeros((8, 2), dtype=torch.int32)),
            torch.arange(4, dtype=torch.int32),
            (torch.ones(4, dtype=torch.int32),
             torch.ones((4, 1), dtype=torch.int32)))
    # The wide companion ring is ported (PushSum's mass ring); the id ring
    # stays flat.
    z = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="the id ring must be flat"):
        deliver.fused_ring_append((torch.zeros((4, 2), dtype=torch.int32), z),
                                  torch.zeros((1, 1), dtype=torch.int32),
                                  z[0], (z, z), z, z > 0, 1, 3)


def test_direct_emit_callers_pass_every_parameter(monkeypatch):
    """chip_smoke.py's host split of a fused_emit call (emit_host) calls
    the C entry point itself: it passes one value for each parameter of
    the source's signature.  CPU tensors, the entry point replaced by a
    recorder."""
    import chip_smoke

    calls = []

    def entry(*args):
        calls.append(args)
        return 0

    monkeypatch.setattr(megakernel, "_emit_fn", lambda: entry)
    monkeypatch.setattr(deliver, "_WS", {})
    monkeypatch.setattr(deliver, "_stream", lambda index: 9)
    monkeypatch.setattr(chip_smoke, "host_split",
                        lambda label, parts: parts["ctypes call"]())
    d, kw = _emit_inputs(2, m=40)
    args = [T(d[x]) for x in ("cnt", "sf", "drop", "svalid", "wslot", "off")]
    chip_smoke.emit_host("si", T(d["ring"].copy()), args, kw)
    assert [len(a) for a in calls] == [len(megakernel._ARGTYPES)]
