"""The port's counter-based RNG against ``jax.random`` (threefry2x32):
keys, per-row keys and every sampler the simulator draws from must agree
bit for bit, in both of jax's counter layouts (``jax_threefry_
partitionable`` True, the default since jax 0.5, and False).

``match_jax_threefry`` aligns the port with whatever layout this
process's jax draws in; the other JAX-twin test files use it.

Under pytest-xdist (six workers to a host of eight cores) each worker
that imports this module keeps one torch intra-op thread: six OpenMP
pools of eight spinning threads on eight cores ran a torch loop that
takes 3 s alone in 655 s each (with one thread: 9 s each)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gossip_simulator_tpu.utils import rng as jrng
from gossip_simulator_tpu_torch.utils import rng as trng

SEEDS = (0, 1, 7, 123_456, 2**31 - 1)
SPANS = ((0, 2), (0, 50_000), (0, 100_000), (0, 2**31 - 1), (10, 20),
         (-5, 5))
PROBS = (0.001, 0.1, 0.5)
ROWS = np.arange(0, 5000, 3, dtype=np.int32)

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)


def match_jax_threefry() -> bool:
    """Set the port's counter layout to the one this process's jax draws
    in (probed, not read from config), and return it."""
    want = np.asarray(jax.random.randint(jax.random.PRNGKey(0), (5,), 0,
                                         1000, dtype=jnp.int32))
    for flag in (True, False):
        trng.set_partitionable(flag)
        if np.array_equal(want, trng.randint(trng.PRNGKey(0), (5,), 0,
                                             1000).numpy()):
            return flag
    raise AssertionError("jax's threefry layout matches neither of the "
                         "port's")


@pytest.fixture(autouse=True, params=(True, False),
                ids=("partitionable", "original"))
def threefry_layout(request):
    """Run every test here under both layouts, on both sides."""
    old_jax, old_port = jax.config.jax_threefry_partitionable, \
        trng.partitionable()
    jax.config.update("jax_threefry_partitionable", request.param)
    trng.set_partitionable(request.param)
    try:
        yield request.param
    finally:
        jax.config.update("jax_threefry_partitionable", old_jax)
        trng.set_partitionable(old_port)


def _j(key) -> np.ndarray:
    return np.asarray(key).astype(np.int64)


def _jrows(key):
    return jax.vmap(lambda r: jax.random.fold_in(key, r))(ROWS)


def _trows(key):
    return trng.row_keys(key, torch.from_numpy(ROWS))


@pytest.mark.parametrize("seed", SEEDS)
def test_base_key(seed):
    assert np.array_equal(_j(jrng.base_key(seed)),
                          trng.base_key(seed).numpy())


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("tick", (0, 1, 37, 0x7FFFFFFF))
@pytest.mark.parametrize("op", (jrng.OP_CRASH, jrng.OP_DELAY, jrng.OP_GRAPH,
                                jrng.OP_REMOVE))
def test_tick_key(seed, tick, op):
    assert trng.OP_CRASH == jrng.OP_CRASH and trng.OP_REMOVE == jrng.OP_REMOVE
    want = _j(jrng.tick_key(jrng.base_key(seed), tick, op))
    got = trng.tick_key(trng.base_key(seed), tick, op).numpy()
    assert np.array_equal(want, got)


@pytest.mark.parametrize("seed", SEEDS)
def test_fold_in_and_row_keys(seed):
    jk, tk = jrng.base_key(seed), trng.base_key(seed)
    for data in (0, 5, 2**31 - 1, 2**32 - 1):
        assert np.array_equal(_j(jax.random.fold_in(jk, data)),
                              trng.fold_in(tk, data).numpy())
    assert np.array_equal(_j(jrng.row_keys(jk, jnp.asarray(ROWS))),
                          _trows(tk).numpy())
    # Per-lane ticks: the vmapped tick_key the event engine batches.
    ticks = (ROWS % 97).astype(np.int32)
    want = jax.vmap(lambda t: jrng.tick_key(jk, t, jrng.OP_DROP))(ticks)
    got = trng.tick_key(tk, torch.from_numpy(ticks), trng.OP_DROP)
    assert np.array_equal(_j(want), got.numpy())


def test_split():
    jk, tk = jrng.base_key(3), trng.base_key(3)
    want = jax.random.split(jk)
    got = trng.split(tk)
    assert np.array_equal(_j(want[0]), got[0].numpy())
    assert np.array_equal(_j(want[1]), got[1].numpy())


@pytest.mark.parametrize("seed", (0, 11))
@pytest.mark.parametrize("span", SPANS)
def test_randint(seed, span):
    lo, hi = span
    jk, tk = jrng.base_key(seed), trng.base_key(seed)
    want = jax.random.randint(jk, (257,), lo, hi, dtype=jnp.int32)
    assert np.array_equal(np.asarray(want),
                          trng.randint(tk, (257,), lo, hi).numpy())
    # Row-keyed scalar draws (the delay draw) and row-keyed (k,) draws
    # (the kout table).
    want = jax.vmap(lambda kk: jax.random.randint(
        kk, (), lo, hi, dtype=jnp.int32))(_jrows(jk))
    assert np.array_equal(np.asarray(want),
                          trng.randint(_trows(tk), (), lo, hi).numpy())
    want = jax.vmap(lambda kk: jax.random.randint(
        kk, (6,), lo, hi, dtype=jnp.int32))(_jrows(jk))
    assert np.array_equal(np.asarray(want),
                          trng.randint(_trows(tk), (6,), lo, hi).numpy())


@pytest.mark.parametrize("seed", (0, 5, 99))
@pytest.mark.parametrize("p", PROBS)
def test_bernoulli(seed, p):
    jk, tk = jrng.base_key(seed), trng.base_key(seed)
    assert np.array_equal(np.asarray(jax.random.bernoulli(jk, p, (4096,))),
                          trng.bernoulli(tk, p, (4096,)).numpy())
    want = jax.vmap(lambda kk: jax.random.bernoulli(kk, p))(_jrows(jk))
    assert np.array_equal(np.asarray(want),
                          trng.bernoulli(_trows(tk), p).numpy())
    want = jax.vmap(lambda kk: jax.random.bernoulli(kk, p, (6,)))(_jrows(jk))
    assert np.array_equal(np.asarray(want),
                          trng.bernoulli(_trows(tk), p, (6,)).numpy())


@pytest.mark.parametrize("p", (0.0, 1.0, 0.3))
def test_bernoulli_masked(p):
    jk, tk = jrng.base_key(4), trng.base_key(4)
    assert np.array_equal(np.asarray(jrng.bernoulli(jk, p, (6,))),
                          trng.bernoulli_masked(tk, p, (6,)).numpy())


@pytest.mark.parametrize("seed", (0, 42))
def test_uniform(seed):
    jk, tk = jrng.base_key(seed), trng.base_key(seed)
    want = np.asarray(jax.random.uniform(jk, (2048,)))
    got = trng.uniform(tk, (2048,)).numpy()
    assert want.dtype == got.dtype == np.float32
    assert np.array_equal(want, got)
    want = np.asarray(jax.vmap(lambda kk: jax.random.uniform(kk))(
        _jrows(jk)))
    assert np.array_equal(want, trng.uniform(_trows(tk)).numpy())


def test_match_jax_threefry(threefry_layout):
    assert match_jax_threefry() is threefry_layout


@pytest.mark.parametrize("seed", (0, 11))
@pytest.mark.parametrize("hi", (17, 100_000, 2**31 - 1))
def test_randint_tensor_maxval(seed, hi):
    """Per-element bounds (the overlay's eviction draw randint(kk, (n,),
    0, max(cnt, 1))): span and multiplier per element; bounds <= minval
    give minval."""
    rng = np.random.default_rng(seed)
    m = len(ROWS)
    maxval = rng.integers(-3, hi, m).astype(np.int32)
    jk, tk = jrng.base_key(seed), trng.base_key(seed)
    for lo in (0, 2):
        want = jax.random.randint(jk, (m,), lo, jnp.asarray(maxval),
                                  dtype=jnp.int32)
        got = trng.randint(tk, (m,), lo, torch.from_numpy(maxval))
        assert np.array_equal(np.asarray(want), got.numpy())
    # The row-keyed form: one key per row, one bound per row.
    want = jax.vmap(lambda kk, mv: jax.random.randint(
        kk, (), 0, mv, dtype=jnp.int32))(_jrows(jk), jnp.asarray(maxval))
    got = trng.randint(_trows(tk), (), 0, torch.from_numpy(maxval))
    assert np.array_equal(np.asarray(want), got.numpy())


@pytest.mark.parametrize("seed", (0, 5))
def test_row_helpers(seed):
    jk, tk = jrng.base_key(seed), trng.base_key(seed)
    rows = ROWS.astype(np.int32)
    assert np.array_equal(
        np.asarray(jrng.row_randint(jk, 10_000, jnp.asarray(rows), 5)),
        trng.row_randint(tk, 10_000, torch.from_numpy(rows), 5).numpy())
    for lo, hi in ((10, 20), (0, 3)):
        assert np.array_equal(
            np.asarray(jrng.row_uniform_delay(jk, lo, hi, jnp.asarray(rows))),
            trng.row_uniform_delay(tk, lo, hi, torch.from_numpy(rows))
            .numpy())


@pytest.mark.parametrize("p", (0.0, 0.1, 0.5, 1.0))
@pytest.mark.parametrize("seed", (0, 5))
def test_row_bernoulli(seed, p):
    jk, tk = jrng.base_key(seed), trng.base_key(seed)
    rows = ROWS.astype(np.int32)
    want = jrng.row_bernoulli(jk, p, jnp.asarray(rows), 7)
    got = trng.row_bernoulli(tk, p, torch.from_numpy(rows), 7)
    assert got.dtype == torch.bool
    assert np.array_equal(np.asarray(want), got.numpy())


@pytest.mark.parametrize("n", (3, 50, 10_000))
def test_randint_excluding(n):
    rng = np.random.default_rng(n)
    a = rng.integers(0, n, 400).astype(np.int32)
    b = rng.integers(0, n, 400).astype(np.int32)
    jk, tk = jrng.base_key(8), trng.base_key(8)
    want = jrng.randint_excluding(jk, n, (400,), jnp.asarray(a),
                                  jnp.asarray(b))
    got = trng.randint_excluding(tk, n, (400,), torch.from_numpy(a),
                                 torch.from_numpy(b))
    assert np.array_equal(np.asarray(want), got.numpy())
    assert not (got.numpy() == a).any() and not (got.numpy() == b).any()
