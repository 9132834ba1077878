"""Static-graph generation in the port against the JAX package's.

* ``rng.split(key, 3)`` and ``rng.poisson`` against ``jax.random`` on
  vmapped per-row keys, in both counter layouts: bit-exact in both of
  the sampler's branches (tests/torch_poisson_parting.py counts 0 parting
  rows at 1e6 rows).
* The port's XLA float32 ``log``, ``log1p`` and ``lgamma`` against jax's
  on a sample (tests/torch_xla_log_check.py checks ``log`` on every
  positive finite float32): bit-exact.
* ``graphs.erdos`` and ``kout_pallas``'s plain version against the JAX
  package's ``graphs.erdos`` and ``graphs.kout`` at row0 = 0 and at an
  unaligned row0: bit-exact.
* The ``bits -> table`` halves of ``kout_pallas`` and ``erdos_pallas``
  against the JAX package's own ``_kout_kernel`` and ``_erdos_kernel``
  bodies, run through Pallas's generic interpreter with the TPU PRNG
  calls patched to an in-kernel integer hash of the cell's position and
  block (and, unpatched, against the interpreter's all-zero stub):
  bit-exact.
* ``-pallas`` routing and its fallback, row blocks of ``erdos_pallas``
  against a full generation, its degree and peer distributions, and JAX
  state on ``-1``-padded erdos tables continuing in the port to
  identical leaves."""

import unittest.mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from gossip_simulator_tpu import config as jcfg
from gossip_simulator_tpu.backends.jax_backend import JaxStepper
from gossip_simulator_tpu.models import graphs as jgraphs
from gossip_simulator_tpu.ops import pallas_graph as jpg
from gossip_simulator_tpu_torch import config as tcfg
from gossip_simulator_tpu_torch.backends import TorchStepper
from gossip_simulator_tpu_torch.models import graphs as tgraphs
from gossip_simulator_tpu_torch.ops import _build
from gossip_simulator_tpu_torch.ops import graph as tgraph
from gossip_simulator_tpu_torch.utils import rng as trng
from test_torch_rng import match_jax_threefry

LAMS = (0.0, 1.0, 5.0, 8.0, 9.99, 10.0, 12.0, 20.0, 60.0)
POISSON_ROWS = 20_000


@pytest.fixture(params=(True, False), ids=("partitionable", "original"))
def layout(request):
    """Both sides in the given counter layout."""
    old_jax, old_port = (jax.config.jax_threefry_partitionable,
                         trng.partitionable())
    jax.config.update("jax_threefry_partitionable", request.param)
    trng.set_partitionable(request.param)
    try:
        yield request.param
    finally:
        jax.config.update("jax_threefry_partitionable", old_jax)
        trng.set_partitionable(old_port)


@pytest.fixture
def own_layout():
    """The port in the counter layout this process's jax draws in."""
    old = trng.partitionable()
    yield match_jax_threefry()
    trng.set_partitionable(old)


def _row_keys(rows, row0=0, seed=0):
    """graphs.erdos's per-row keys on both sides: (jax, port)."""
    jk = jgraphs._row_keys(jgraphs.graph_key(jcfg.Config(seed=seed)), row0,
                           rows)
    tk = trng.row_keys(trng.tick_key(trng.base_key(seed), 0, trng.OP_GRAPH),
                       row0 + torch.arange(rows, dtype=torch.int32))
    assert np.array_equal(np.asarray(jk).astype(np.int64), tk.numpy())
    return jk, tk


def _jax_poisson(keys, lam):
    return np.asarray(jax.vmap(
        lambda k: jax.random.poisson(jax.random.split(k)[0], lam, ()))(keys))


def test_split3_matches_jax(layout):
    jk, tk = _row_keys(64, seed=5)
    want = np.asarray(jax.vmap(lambda k: jax.random.split(k, 3))(jk))
    got = torch.stack(trng.split(tk, 3), dim=1).numpy()
    assert np.array_equal(want.astype(np.int64), got)
    two = np.asarray(jax.vmap(jax.random.split)(jk)).astype(np.int64)
    assert np.array_equal(two, torch.stack(trng.split(tk), dim=1).numpy())


@pytest.mark.parametrize("lam", LAMS)
def test_poisson_matches_jax(layout, lam):
    jk, tk = _row_keys(POISSON_ROWS)
    want = _jax_poisson(jk, lam)
    got = trng.poisson(trng.split(tk)[0], lam).numpy()
    assert got.dtype == np.int32
    assert int((want != got).sum()) == 0
    if lam > 0:
        assert abs(got.mean() - lam) < 5 * np.sqrt(lam / POISSON_ROWS)


@pytest.mark.parametrize("fn", ("log", "log1p", "lgamma"))
def test_xla_transcendentals_match_jax(fn):
    """A sample of tests/torch_xla_log_check.py: random float32 bit
    patterns (log), every float32 near the branch points, and the Poisson
    sampler's ranges (log1p, lgamma)."""
    rng = np.random.default_rng(7)
    if fn == "log":
        x = np.concatenate([
            rng.integers(0, 0x7F800001, 1 << 20, dtype=np.uint32),
            np.arange(0x3F3504F0 - 2048, 0x3F3504F0 + 2048, dtype=np.uint32),
            np.array([0, 1, 0x007FFFFF, 0x00800000, 0x7F7FFFFF, 0x7F800000,
                      0x3F800000, 0x80000000, 0x80000001, 0x80800000,
                      0xFF800000, 0x7FC00000, 0xFFC00001],
                     dtype=np.uint32)]).view(
            np.float32)
        want, got = jnp.log(x), trng.xla_log(torch.from_numpy(x))
    elif fn == "log1p":
        x = np.concatenate([rng.uniform(-0.99, 100.0, 1 << 18),
                            rng.uniform(-0.42, 0.42, 1 << 18)]).astype(
            np.float32)
        want, got = jnp.log1p(x), trng.xla_log1p(torch.from_numpy(x))
    else:
        x = np.concatenate([np.arange(1, 1 << 16, dtype=np.float32),
                            rng.uniform(0.5, 1e5, 1 << 18).astype(
                                np.float32), np.float32([np.inf])])
        want, got = jax.lax.lgamma(x), trng.xla_lgamma(torch.from_numpy(x))
    want = np.asarray(want).view(np.uint32)
    assert np.array_equal(want, got.numpy().view(np.uint32))


@pytest.mark.parametrize("lam", (8.0, 12.0))
def test_poisson_row_is_independent_of_its_batch(lam):
    """A finished row's carry freezes: its draw is the same whatever rows
    share its batch."""
    _, a = _row_keys(4000)
    _, b = _row_keys(3500, row0=2500)
    da = trng.poisson(trng.split(a)[0], lam)
    db = trng.poisson(trng.split(b)[0], lam)
    assert torch.equal(da[2500:], db[:1500])


ERDOS = {"lam8": dict(fanout=8, seed=3), "lam12": dict(er_p=0.004, seed=1),
         "lam60": dict(er_p=0.02, seed=2)}


@pytest.mark.parametrize("row0,rows", ((0, None), (517, 1000)))
@pytest.mark.parametrize("case", sorted(ERDOS))
def test_erdos_matches_reference(own_layout, case, row0, rows):
    kw = dict(n=3000, graph="erdos", **ERDOS[case])
    jc, tc = jcfg.Config(**kw).validate(), tcfg.Config(**kw).validate()
    jf, jd = jgraphs.erdos(jc, jgraphs.graph_key(jc), row0, rows)
    tf, td = tgraphs.erdos(tc, tgraphs.graph_key(tc), row0, rows)
    assert tf.shape[1] == tc.graph_width == jc.graph_width
    assert np.array_equal(np.asarray(jf), tf.numpy())
    assert np.array_equal(np.asarray(jd), td.numpy())


@pytest.mark.parametrize("k", (7, 200))
@pytest.mark.parametrize("row0,rows", ((0, 3000), (517, 1000)))
def test_kout_pallas_plain_is_graphs_kout(layout, row0, rows, k):
    """kout_pallas is the fold_in generator at any fanout (past the JAX
    kernel's 128 lanes too), and the port's graphs.kout."""
    kw = dict(n=3000, graph="kout", fanout=k, seed=6)
    jc, tc = jcfg.Config(**kw).validate(), tcfg.Config(**kw).validate()
    want, _ = jgraphs.kout(jc, jgraphs.graph_key(jc), row0, rows)
    got = tgraph.kout_pallas(3000, k, row0, rows, tgraphs.graph_key(tc))
    assert np.array_equal(np.asarray(want), got.numpy())
    mine, cnt = tgraphs.kout(tc, tgraphs.graph_key(tc), row0, rows)
    assert torch.equal(mine, got) and bool((cnt == k).all())


# --- the TPU kernels' bits -> table arithmetic -------------------------------


def _hash_bits(shape):
    """In-kernel stand-in for pltpu.prng_random_bits: an integer hash of
    the cell's position and the grid block."""
    r = jax.lax.broadcasted_iota(jnp.uint32, shape, 0)
    c = jax.lax.broadcasted_iota(jnp.uint32, shape, 1)
    b = pl.program_id(0).astype(jnp.uint32)
    h = (r * jnp.uint32(0x9E3779B1) + c * jnp.uint32(0x85EBCA77)
         + b * jnp.uint32(0xC2B2AE3D))
    h = h ^ (h >> 15)
    h = h * jnp.uint32(0x2C1B3C6D)
    return jax.lax.bitcast_convert_type(h ^ (h >> 12), jnp.int32)


def _hash_bits_np(words, rows, br):
    """The same bits as (rows, words) uint32 in int64: row r of the output
    is lane r % br of grid block r // br."""
    r = np.arange(rows, dtype=np.uint64)
    w = np.arange(words, dtype=np.uint64)[None, :]
    m = np.uint64(0xFFFFFFFF)
    h = (w * np.uint64(0x9E3779B1) + (r % br)[:, None] * np.uint64(0x85EBCA77)
         + (r // br)[:, None] * np.uint64(0xC2B2AE3D)) & m
    h ^= h >> np.uint64(15)
    h = (h * np.uint64(0x2C1B3C6D)) & m
    return torch.from_numpy((h ^ (h >> np.uint64(12))).astype(np.int64))


@pytest.fixture
def hashed_prng():
    """The reference kernels' TPU PRNG path (their interpret argument
    False) under the generic interpreter, drawing _hash_bits."""
    with unittest.mock.patch.object(jpg, "_interpret_param", lambda _: True), \
            unittest.mock.patch.object(pltpu, "prng_seed",
                                       lambda *a: None), \
            unittest.mock.patch.object(pltpu, "prng_random_bits",
                                       _hash_bits):
        yield


BR = 256


@pytest.mark.parametrize("row0", (0, 37))
def test_kout_table_is_the_tpu_kernel(hashed_prng, row0):
    n, k, rows = 1000, 5, 700
    want = np.asarray(jpg._kout_pallas_jit(n, k, row0, rows, BR, 3, False))
    got = tgraph.kout_table(_hash_bits_np(k, rows, BR), n, row0)
    assert np.array_equal(want, got.numpy())


@pytest.mark.parametrize("row0", (0, 37))
@pytest.mark.parametrize("lam", (8.0, 60.0))
def test_erdos_table_is_the_tpu_kernel(hashed_prng, lam, row0):
    n, rows = 1000, 700
    cap = tcfg.er_cap(lam)
    wf, wd = jpg._erdos_pallas_jit(n, lam, row0, rows, BR, 3, False)
    gf, gd = tgraph.erdos_table(_hash_bits_np(cap + 1, rows, BR), n, lam,
                                row0)
    assert np.array_equal(np.asarray(wd), gd.numpy())
    assert np.array_equal(np.asarray(wf), gf.numpy())
    assert 0.5 * lam < gd.float().mean() < 1.5 * lam


def test_tables_match_the_zero_stub(monkeypatch):
    """The interpreter's own all-zero stub: everyone befriends node 0
    (node 0 befriends node 1), and every degree is 0."""
    monkeypatch.setattr(jpg, "_interpret_param", bool)
    kout = np.asarray(jpg._kout_pallas_jit(300, 4, 0, 300, BR, 1, True))
    zeros = torch.zeros((300, 4), dtype=torch.int64)
    assert np.array_equal(kout, tgraph.kout_table(zeros, 300, 0).numpy())
    cap = tcfg.er_cap(8.0)
    wf, wd = jpg._erdos_pallas_jit(300, 8.0, 0, 300, BR, 1, True)
    gf, gd = tgraph.erdos_table(torch.zeros((300, cap + 1),
                                            dtype=torch.int64), 300, 8.0, 0)
    assert np.array_equal(np.asarray(wf), gf.numpy())
    assert np.array_equal(np.asarray(wd), gd.numpy())
    assert int(gd.max()) == 0


# --- -pallas routing, row blocks, distributions ---------------------------


def test_pallas_routing_and_fallback(own_layout):
    """-pallas takes erdos_pallas inside the JAX package's limits (0 < lam
    <= 60 and cap <= 128) and warns and falls back to the fold_in
    generator outside them; kout is kout_pallas with or without it, and
    warns as the JAX package does past fanout 128; nothing launches on
    the CPU."""
    _build.reset_launches()
    for kw, kernel in ((dict(graph="kout", fanout=6), True),
                       (dict(graph="kout", fanout=129), False),
                       (dict(graph="erdos", fanout=8), True),
                       (dict(graph="erdos", er_p=0.05), False)):
        plain = tcfg.Config(n=2000, seed=4, **kw).validate()
        cfg = tcfg.Config(n=2000, seed=4, pallas=True, **kw).validate()
        key = tgraphs.graph_key(cfg)
        if kernel:
            got = tgraphs.generate(cfg, key)
        else:
            with pytest.warns(UserWarning, match="-pallas requested"):
                got = tgraphs.generate(cfg, key)
        want = tgraphs.generate(plain, key)
        if kw["graph"] == "erdos" and kernel:
            want = tgraph.erdos_plain(2000, 8.0, 0, 2000, key)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert not any(_build.LAUNCHES.values())


def test_erdos_launch_reads_no_key_and_passes_the_table(monkeypatch):
    """erdos_pallas's launch path makes no device-to-host read: the key
    goes to the kernel as a device pointer (here a meta tensor, which has
    no values to read), the cdf table as erdos_cdf's float32 values, and
    the stream through deliver._stream; one count a call.  The C entry
    point is replaced by a recorder."""
    import ctypes

    from gossip_simulator_tpu_torch.ops import deliver

    calls = []
    monkeypatch.setattr(tgraph, "_erdos_fn",
                        lambda: lambda *a: calls.append(a) or 0)
    monkeypatch.setattr(tgraph._build, "LAUNCHES", dict(_build.LAUNCHES))
    monkeypatch.setattr(deliver, "_stream", lambda index: 9)
    key = torch.empty(2, dtype=torch.int64, device="meta")
    for lam in (8.0, 60.0):
        f, d = tgraph._launch_erdos(1000, lam, 17, 300, key)
        cap = tcfg.er_cap(lam)
        assert f.shape == (300, cap) and d.shape == (300,)
        a = calls[-1]
        assert a[2] == key.data_ptr() and a[4:8] == (1000, cap, 17, 300)
        table = np.ctypeslib.as_array(
            ctypes.cast(a[3], ctypes.POINTER(ctypes.c_float)), (cap,))
        assert np.array_equal(table, tgraph.erdos_cdf(lam, cap))
        assert a[9] == 9
    assert tgraph._build.LAUNCHES[tgraph.ERDOS] == 2


def _magic_urem(x: np.ndarray, d: int) -> np.ndarray:
    """csrc/erdos_pallas.cu's remainder by an invariant d in [2, 2**31)
    (Granlund-Montgomery, round-up magic) in uint64 numpy arithmetic."""
    ell = (d - 1).bit_length()
    magic = ((((1 << ell) - d) << 32) // d) + 1
    assert magic < 2**32
    x = x.astype(np.uint64)
    t = (x * np.uint64(magic)) >> np.uint64(32)
    q = (t + ((x - t) >> np.uint64(1))) >> np.uint64(ell - 1)
    return x - q * np.uint64(d)


@pytest.mark.parametrize("d", (2, 3, 7, 10, 2**16 - 1, 2**16, 2**16 + 1,
                               1_000_000, 10_000_000, 100_000_000,
                               2**30 + 1, 2**31 - 1))
def test_invariant_division_is_the_remainder(d):
    """The kernel's multiply-high remainder equals x % d at the edge
    dividends (0, 2**32 - 1, multiples of d and their neighbours, powers
    of two and theirs) and on random words (tests/test_torch_card.py runs
    the kernel's own on the card)."""
    rng = np.random.default_rng(d)
    mult = np.arange(0, 2**32, d, dtype=np.uint64)[::max(1, 2**32 // d
                                                         // 4096)]
    pw = np.array([1 << i for i in range(32)], dtype=np.uint64)
    x = np.concatenate([mult, mult + 1, mult - 1, pw, pw - 1, pw + 1,
                        np.array([0, 2**32 - 1, 2**32 - d], np.uint64),
                        rng.integers(0, 2**32, 200_000, dtype=np.uint64)])
    x = x[(x < 2**32)].astype(np.uint64)
    assert np.array_equal(_magic_urem(x, d), x % np.uint64(d))


def test_erdos_pallas_rows_match_full_generation(own_layout):
    key = tgraphs.graph_key(tcfg.Config(seed=2))
    full, fdeg = tgraph.erdos_pallas(5000, 12.0, 0, 5000, key)
    for row0, rows in ((0, 700), (700, 1300), (4999, 1)):
        part, pdeg = tgraph.erdos_pallas(5000, 12.0, row0, rows, key)
        assert torch.equal(full[row0:row0 + rows], part)
        assert torch.equal(fdeg[row0:row0 + rows], pdeg)


@pytest.mark.parametrize("lam", (8.0, 60.0))
def test_erdos_pallas_distribution(own_layout, lam):
    """tests/test_graphs.py::test_erdos_degree_distribution's checks, and
    peers spread uniformly over [0, n) with no self loops."""
    n = 20_000
    f, deg = tgraph.erdos_pallas(n, lam, 0, n,
                                 tgraphs.graph_key(tcfg.Config(seed=0)))
    d = deg.double()
    assert abs(float(d.mean()) - lam) < 4 * np.sqrt(lam / n)
    assert abs(float(d.var()) - lam) < 0.1 * lam
    slot = torch.arange(f.shape[1])[None, :]
    live = slot < deg[:, None]
    assert bool((f[live] >= 0).all()) and bool((f[~live] == -1).all())
    assert not bool((f == torch.arange(n)[:, None]).any())
    counts = torch.bincount(f[live].long() * 10 // n, minlength=10).double()
    assert float((counts / counts.mean() - 1).abs().max()) < 0.05


# --- JAX state on an erdos table continues in the port --------------------

HANDOVER = {"event": dict(fanout=8),
            "event_sir": dict(er_p=0.004, protocol="sir"),
            "ring": dict(fanout=8, engine="ring"),
            "pushsum": dict(fanout=8, model="pushsum", droprate=0.0,
                            crashrate=0.0)}


@pytest.mark.parametrize("case", sorted(HANDOVER))
def test_erdos_state_handover(own_layout, case):
    """A JaxStepper state on a cap-wide -1-padded friends table, taken
    after 3 windows, continues in the port: 3 more windows with equal
    Stats and identical leaves."""
    kw = dict(n=3000, graph="erdos", seed=4, progress=False, **HANDOVER[case])
    jc, tc = jcfg.Config(**kw).validate(), tcfg.Config(**kw).validate()
    js = JaxStepper(jc)
    js.init()
    assert js.overlay_window()[2]
    js.seed()
    for _ in range(3):
        js.gossip_window()
    tree = js.state_pytree()
    assert np.shape(tree["friends"]) == (3000, jc.graph_width)
    ts = TorchStepper(tc, device="cpu")
    ts.init()
    ts.load_state_pytree(tree)
    for _ in range(3):
        assert js.gossip_window().to_dict() == ts.gossip_window().to_dict()
    jt, tt = js.state_pytree(), ts.state_pytree()
    assert set(jt) == set(tt)
    for key in jt:
        assert np.asarray(jt[key]).dtype == np.asarray(tt[key]).dtype, key
        assert np.array_equal(jt[key], tt[key]), key
