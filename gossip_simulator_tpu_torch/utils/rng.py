"""Counter-based randomness, bit-exact to the JAX package's streams.

The JAX package derives every draw from ``(seed, tick, op, row)`` through
``jax.random`` on the threefry2x32 generator.  This module reimplements
that generator and the handful of samplers the simulator uses, so a run
here reproduces the JAX package's trajectories bit for bit:

* ``threefry2x32`` -- the 20-round Threefry-2x32 block function;
* keys -- ``PRNGKey``/``base_key``, ``fold_in`` (threefry of the key over
  the counter ``(0, data)``), ``split``;
* bits -- ``random_bits``;
* samplers -- ``randint``, ``uniform``, ``bernoulli`` and ``poisson``
  follow ``jax.random``'s algorithms exactly (``poisson`` with XLA's own
  float32 ``log`` and ``lgamma``: ``xla_log``, ``xla_log1p``,
  ``xla_lgamma``).

jax lays out ``split`` and ``random_bits`` counters in one of two ways,
chosen by its ``jax_threefry_partitionable`` setting (True by default
since jax 0.5): partitionable -- counters ``(hi, lo)`` of the 64-bit iota,
bits = the XOR of the two output words -- or the original layout -- the
32-bit iota cut in two halves fed as the two input words, outputs
concatenated.  ``fold_in`` is the same in both.  The port follows the
same setting: partitionable unless the environment variable
``JAX_THREEFRY_PARTITIONABLE`` (jax's own) is false, or
``set_partitionable`` says otherwise.

torch has no usable uint32 arithmetic, so every 32-bit word lives in an
int64 lane and is masked back to 32 bits after each add, multiply and
shift.  A key is an int64 tensor whose last axis holds the two words; a
batch of per-lane keys has shape ``(m, 2)``.
"""

from __future__ import annotations

import functools
import math
import os

import numpy as np
import torch

# Op tags (the JAX package's utils/rng.py values; draws for different
# purposes stay independent within a tick).
OP_CRASH = 1
OP_DROP = 2
OP_DELAY = 3
OP_BOOTSTRAP = 4
OP_EVICT = 5
OP_REPLACE = 6
OP_SEED_NODE = 7
OP_GRAPH = 8
OP_PULL = 9
OP_REMOVE = 10
OP_DELAY_BK = 11
OP_INJECT = 15
OP_PUSHSUM = 16

M32 = 0xFFFFFFFF
_I64 = torch.int64
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))

_PARTITIONABLE = os.environ.get("JAX_THREEFRY_PARTITIONABLE",
                                "1").lower() not in ("0", "false", "no", "off")


def set_partitionable(flag: bool) -> None:
    """Select jax's counter layout for split and random_bits (see the
    module docstring); process-wide, like jax's own setting."""
    global _PARTITIONABLE
    _PARTITIONABLE = bool(flag)


def partitionable() -> bool:
    return _PARTITIONABLE


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & M32) | (x >> (32 - r))


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32 (20 rounds) on int64 lanes holding uint32 words.
    Arguments broadcast against each other; returns the two output
    words."""
    k0 = torch.as_tensor(k0, dtype=_I64)
    k1 = torch.as_tensor(k1, dtype=_I64, device=k0.device)
    x0 = torch.as_tensor(x0, dtype=_I64, device=k0.device)
    x1 = torch.as_tensor(x1, dtype=_I64, device=k0.device)
    k2 = k0 ^ k1 ^ 0x1BD11BDA
    ks = (k0, k1, k2)
    x0 = (x0 + k0) & M32
    x1 = (x1 + k1) & M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & M32
    return x0, x1


def PRNGKey(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)``: the words ``[seed >> 32, seed & M32]``
    of the (int32) seed -- the high word is 0 for 32-bit seeds."""
    return torch.tensor([0, int(seed) & M32], dtype=_I64, device=device)


def base_key(seed: int, device=None) -> torch.Tensor:
    return PRNGKey(seed, device)


def _data(data, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(data, dtype=_I64, device=like.device) & M32


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``: threefry of `key` over the counter
    ``(0, uint32(data))``.  `data` may be a tensor of per-lane values
    (the vmapped form); the result broadcasts key and data."""
    d = _data(data, key)
    y0, y1 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(d), d)
    return torch.stack(torch.broadcast_tensors(y0, y1), dim=-1)


def split(key: torch.Tensor, num: int = 2):
    """``jax.random.split(key, num)`` as a tuple of `num` keys.
    Partitionable: key i is the threefry of `key` over the counter (0, i),
    i.e. ``fold_in(key, i)``.  Original layout: one threefry over the
    32-bit iota 0..2*num-1 cut in halves (counters (i, num + i)), the two
    output words concatenated and cut into consecutive pairs -- so for
    num = 3, key 1 is (first output of counter 2, second output of
    counter 0)."""
    if partitionable():
        return tuple(fold_in(key, i) for i in range(num))
    cnt = torch.arange(2 * num, dtype=_I64, device=key.device)
    y0, y1 = threefry2x32(key[..., 0, None], key[..., 1, None], cnt[:num],
                          cnt[num:])
    words = torch.cat([y0, y1], dim=-1)
    return tuple(words[..., 2 * i:2 * i + 2] for i in range(num))


def tick_key(key: torch.Tensor, tick, op: int) -> torch.Tensor:
    """Key for operation `op` at round/tick `tick`."""
    return fold_in(fold_in(key, tick), op)


def row_keys(key: torch.Tensor, rows) -> torch.Tensor:
    """One derived key per row id (the vmapped ``fold_in``)."""
    return fold_in(key, rows)


def random_bits(key: torch.Tensor, shape=()) -> torch.Tensor:
    """``jax.random.bits``: 32 random bits of shape ``key.shape[:-1] +
    shape`` (int64 lanes), in the selected counter layout."""
    shape = tuple(shape)
    size = 1
    for s in shape:
        size *= s
    lead = key.shape[:-1]
    if not partitionable():
        # The 32-bit iota (zero-padded to even length) in two halves as
        # the two input words; outputs concatenated, cut back to size.
        half = (size + 1) // 2
        cnt = torch.arange(2 * half, dtype=_I64, device=key.device)
        cnt[size:] = 0
        y0, y1 = threefry2x32(key[..., 0, None], key[..., 1, None],
                              cnt[:half], cnt[half:])
        bits = torch.cat([y0, y1], dim=-1)[..., :size]
        return bits.reshape(lead + shape)
    lo = torch.arange(size, dtype=_I64, device=key.device).reshape(shape)
    k0 = key[..., 0].reshape(lead + (1,) * len(shape))
    k1 = key[..., 1].reshape(lead + (1,) * len(shape))
    y0, y1 = threefry2x32(k0, k1, lo >> 32, lo & M32)
    return y0 ^ y1


def randint(key: torch.Tensor, shape, minval: int, maxval) -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval, dtype=int32)``.

    Two 32-bit draws are folded modulo the span with a multiplier
    ``2**32 % span`` computed in wrapping uint32 arithmetic, exactly as
    jax does: for spans above 2**16 the squared multiplier wraps (to 0 at
    span 100,000), so every multiply and add is masked to 32 bits.

    `maxval` may be an int32 tensor of per-element bounds broadcast
    against the draw (the overlay's eviction draw ``randint(kk, (n,), 0,
    max(cnt, 1))``): jax then computes the span and the multiplier per
    element, and so does this."""
    i32max = 2**31 - 1
    if isinstance(maxval, torch.Tensor):
        return _randint_per_element(key, shape, int(minval), maxval)
    out_of_range = maxval > i32max
    lo_v = max(min(int(minval), i32max), -2**31)
    hi_v = max(min(int(maxval), i32max), -2**31)
    span = (hi_v - lo_v) & M32
    if hi_v <= lo_v:
        span = 1
    elif out_of_range:
        span = (span + 1) & M32
    if span == 0:
        raise ValueError("randint span of 2**32 is not supported")
    mult = (2**16) % span
    mult = ((mult * mult) & M32) % span
    return _fold_span(key, shape, lo_v, span, mult)


def _randint_per_element(key, shape, lo_v: int, maxval: torch.Tensor):
    """randint with int32 tensor bounds: span = uint32(max - min), 1 where
    max <= min (an int32 maxval is never out of range)."""
    hi = maxval.to(_I64)
    span = torch.where(hi <= lo_v, torch.ones_like(hi), (hi - lo_v) & M32)
    mult = (2**16) % span
    mult = ((mult * mult) & M32) % span
    return _fold_span(key, shape, lo_v, span, mult)


def _fold_span(key, shape, lo_v: int, span, mult) -> torch.Tensor:
    """jax's fold of two 32-bit draws into [lo, lo + span)."""
    k1, k2 = split(key)
    higher = random_bits(k1, shape)
    lower = random_bits(k2, shape)
    off = (((higher % span) * mult) & M32) + (lower % span)
    off = (off & M32) % span
    out = (lo_v + off) & M32
    out = torch.where(out >= 2**31, out - 2**32, out)
    return out.to(torch.int32)


def uniform(key: torch.Tensor, shape=()) -> torch.Tensor:
    """``jax.random.uniform(key, shape)`` in float32 on [0, 1): the top
    23 bits become the mantissa of a float in [1, 2), minus 1."""
    bits = random_bits(key, shape)
    fbits = ((bits >> 9) | 0x3F800000).to(torch.int32)
    return torch.clamp_min(fbits.view(torch.float32) - 1.0, 0.0)


def bernoulli(key: torch.Tensor, p: float, shape=()) -> torch.Tensor:
    """``jax.random.bernoulli(key, p, shape)``: uniform < float32(p).  The
    JAX package's helper short-circuits p <= 0 and p >= 1 to constant
    masks; callers do the same."""
    pt = torch.tensor(p, dtype=torch.float32, device=key.device)
    return uniform(key, shape) < pt


def bernoulli_masked(key: torch.Tensor, p: float, shape=()) -> torch.Tensor:
    """The JAX package's ``rng.bernoulli`` helper: constant masks at p <= 0
    and p >= 1, else a Bernoulli draw."""
    out = key.shape[:-1] + tuple(shape)
    if p <= 0.0:
        return torch.zeros(out, dtype=torch.bool, device=key.device)
    if p >= 1.0:
        return torch.ones(out, dtype=torch.bool, device=key.device)
    return bernoulli(key, p, shape)


@functools.lru_cache(maxsize=4)
def _log_uniform_table(device: str) -> torch.Tensor:
    """XLA's float32 log (``xla_log``) of every value a float32 ``uniform``
    takes (j * 2**-23, j < 2**23; -inf at 0), built on the host, so both
    devices gather the same bits."""
    j = torch.arange(1 << 23, dtype=torch.float32) * 2.0**-23
    return xla_log(j).to(device)


def _fma32(a, b, c) -> torch.Tensor:
    """float32 a*b + c rounded once, as the FMAs XLA's CPU code contracts
    its multiply-adds into.  The float64 product of two float32s is
    exact; the float64 sum is rounded to odd (TwoSum's error term moves
    an inexact even result one float64 ulp towards the exact sum), so
    its cast to float32 rounds as one FMA does."""
    a, b, c = (x.double() if torch.is_tensor(x)
               else torch.tensor(x, dtype=torch.float64) for x in (a, b, c))
    p = a * b
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    even = (s.view(torch.int64) & 1) == 0
    s = torch.where((err != 0) & even, torch.nextafter(s, s + err), s)
    return s.float()


def _f32(v: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32, device=like.device)


def _hex64(h: int) -> float:
    """A constant as LLVM prints it (the raw float64 bits)."""
    return float(np.array([h], dtype=np.uint64).view(np.float64)[0])


# Cephes' log polynomial, as XLA's CPU code emits it (Eigen's plog).
_LOG_P = (7.0376836292E-2, -1.1514610310E-1, 1.1676998740E-1,
          -1.2420140846E-1, 1.4249322787E-1, -1.6668057665E-1,
          2.0000714765E-1, -2.4999993993E-1, 3.3333331174E-1)
# XLA's log1p: x + (-x^2/2 + x^3 * B(x) / A(x)) below |x| < sqrt(2) - 1.
_LOG1P_A = tuple(_hex64(h) for h in (
    0x402E2035A0000000, 0x4054C30B60000000, 0x406BB865A0000000,
    0x4073519460000000, 0x406B0DB140000000, 0x404E0F3040000000))
_LOG1P_B = tuple(_hex64(h) for h in (
    0x3F07BC0960000000, 0x3FDFE818A0000000, 0x401A509F40000000,
    0x403DE97380000000, 0x404E798EC0000000, 0x404C8E75A0000000,
    0x40340A2020000000))
_LOG1P_SMALL = _hex64(0x3FDA8279A0000000)
# CHLO's Lanczos expansion of lgamma (g = 7), float32 constants.
_LGAMMA_C = (676.520386, -1259.13916, 771.323425, -176.615036, 12.5073433,
             -0.138571098, 9.98436917e-06, 1.50563267e-07)


def xla_log(x: torch.Tensor) -> torch.Tensor:
    """XLA's CPU float32 ``log``, bit for bit: Cephes' polynomial with
    the multiply-adds XLA's code contracts into FMAs, and subnormal
    inputs flushed to zero (-inf, of either sign), as XLA runs.  Equal to ``jnp.log`` on
    every float32 (``tests/torch_xla_log_check.py`` checks all 2**32)."""
    xb = x.view(torch.int32)
    tiny = xb < 0x00800000  # zero, subnormal or negative
    xc = torch.where(tiny, 0x00800000, xb)
    e = ((xc >> 23) - 127).float() + 1.0
    xm = ((xc & 0x807FFFFF) | 0x3F000000).view(torch.float32)
    low = xm < _f32(0.70710677, x)
    xx = (xm - 1.0) + torch.where(low, xm, _f32(0.0, x))
    e = e - low.float()
    x2 = xx * xx
    x3 = x2 * xx
    p = [_f32(v, x) for v in _LOG_P]
    y = _fma32(_fma32(xx, p[0], p[1]), xx, p[2])
    y1 = _fma32(_fma32(xx, p[3], p[4]), xx, p[5])
    y2 = _fma32(_fma32(xx, p[6], p[7]), xx, p[8])
    y = _fma32(_fma32(y, x3, y1), x3, y2)
    y = _fma32(y, x3, _f32(-2.12194440e-4, x) * e)
    r = _fma32(_f32(-0.5, x), x2, xx) + y
    r = _fma32(_f32(0.693359375, x), e, r)
    mag = xb & 0x7FFFFFFF
    r = torch.where(tiny, _f32(-math.inf, x), r)  # +-0 and subnormals
    # XLA's NaN is all ones (its mask or-ed into the result).
    nan = torch.full((), -1, dtype=torch.int32,
                     device=x.device).view(torch.float32)
    r = torch.where(((xb < 0) & (mag >= 0x00800000)) | (mag > 0x7F800000),
                    nan, r)
    return torch.where(xb == 0x7F800000, _f32(math.inf, x), r)


def xla_log1p(x: torch.Tensor) -> torch.Tensor:
    """XLA's CPU float32 ``log1p``: a rational approximation for |x| <
    sqrt(2) - 1, ``xla_log(1 + x)`` elsewhere."""
    pa = torch.ones_like(x)
    for c in _LOG1P_A:
        pa = _fma32(pa, x, _f32(c, x))
    pb = torch.full_like(x, float(np.float32(_LOG1P_B[0])))
    for c in _LOG1P_B[1:]:
        pb = _fma32(pb, x, _f32(c, x))
    x2 = x * x
    small = x + _fma32(x2, _f32(-0.5, x), (x * x2) * (pb / pa))
    return torch.where(x.abs() < _f32(_LOG1P_SMALL, x), small,
                       xla_log(x + 1.0))


def xla_lgamma(x: torch.Tensor) -> torch.Tensor:
    """XLA's CPU float32 ``lgamma`` for x >= 0.5 and +inf (the Poisson
    sampler's k + 1; its reflection branch for x < 0.5 is not ported):
    CHLO's Lanczos expansion in its operation order."""
    z = x - 1.0
    s = _f32(_LGAMMA_C[0], x) / (z + 1.0) + 1.0
    for i, c in enumerate(_LGAMMA_C[1:], start=2):
        s = s + _f32(c, x) / (z + float(i))
    log_t = xla_log1p(z * _f32(0.13333334, x)) + _f32(2.01490307, x)
    a = (z + 0.5) - (z + 7.5) / log_t
    r = _fma32(a, log_t, _f32(0.918938518, x)) + xla_log(s)
    return torch.where(x == math.inf, _f32(math.inf, x), r)


def _poisson_knuth(keys: torch.Tensor, lam32: torch.Tensor) -> torch.Tensor:
    """jax's ``_poisson_knuth`` per row: split, count, add log(u) until the
    log-product falls to -lam; a finished row's carry freezes, as under
    jax's batched while_loop."""
    m = keys.shape[0]
    tab = _log_uniform_table(str(keys.device))
    k = torch.zeros(m, dtype=torch.int32, device=keys.device)
    lp = torch.zeros(m, dtype=torch.float32, device=keys.device)
    act = lp > -lam32
    while bool(act.any()):
        nxt, sub = split(keys)
        lu = tab[random_bits(sub) >> 9]
        k = torch.where(act, k + 1, k)
        lp = torch.where(act, lp + lu, lp)
        keys = torch.where(act[:, None], nxt, keys)
        act = lp > -lam32
    return k - 1


def _poisson_rejection(keys: torch.Tensor, lam: float) -> torch.Tensor:
    """jax's ``_poisson_rejection`` (Hörmann's transformed rejection) per
    row, until the row accepts."""
    f32 = functools.partial(torch.tensor, dtype=torch.float32,
                            device=keys.device)
    lam32 = float(np.float32(lam))
    lam_t = f32(lam32)
    log_lam = xla_log(lam_t)
    b = _fma32(f32(2.53), f32(math.sqrt(lam32)), f32(0.931))
    a = _fma32(f32(0.02483), b, f32(-0.059))
    inv_alpha = f32(1.1239) + f32(1.1328) / (b - f32(3.4))
    v_r = f32(0.9277) - f32(3.6224) / (b - f32(2.0))
    m = keys.shape[0]
    k_out = torch.full((m,), -1.0, dtype=torch.float32, device=keys.device)
    acc = torch.zeros(m, dtype=torch.bool, device=keys.device)
    while not bool(acc.all()):
        act = ~acc
        nxt, s0, s1 = split(keys, 3)
        u = uniform(s0) - f32(0.5)
        v = uniform(s1)
        us = f32(0.5) - u.abs()
        k = torch.floor(_fma32((f32(2.0) * a) / us + b, u, lam_t)
                        + f32(0.43))
        s = xla_log(v * inv_alpha / (a / (us * us) + b))
        t = _fma32(k, log_lam, -lam_t) - xla_lgamma(k + 1.0)
        accept = (((us >= f32(0.07)) & (v <= v_r))
                  | (~((k < 0) | ((us < f32(0.013)) & (v > us)))
                     & (s <= t)))
        k_out = torch.where(act & accept, k, k_out)
        acc = acc | accept
        keys = torch.where(act[:, None], nxt, keys)
    return k_out.to(torch.int32)


def poisson(keys: torch.Tensor, lam: float) -> torch.Tensor:
    """``jax.random.poisson(key, lam, ())`` vmapped over per-row keys
    ``(m, 2)``: int32[m].  Knuth's method below lam = 10, Hörmann's
    transformed rejection at and above it, 0 at lam = 0, in float32 at
    ``float32(lam)``, as jax's ``_poisson``.  Each row loops until its own
    predicate ends, so a row's draw does not depend on its batch.

    The float32 transcendentals are XLA's own (``xla_log``,
    ``xla_lgamma``), with the multiply-adds XLA's CPU code contracts
    rounded once, in IEEE float32/float64 torch operations that give the
    same bits on the CPU and the card: Knuth's ``log(u)`` is a gather from
    a host table of ``xla_log`` over every float32 uniform, and the
    rejection branch computes ``xla_log`` and ``xla_lgamma`` on the
    device.  No row parts from jax over 10**6 rows at lam 1 to 60 in
    either counter layout (``tests/torch_poisson_parting.py``)."""
    lam32 = float(np.float32(lam))
    if lam32 == 0.0:
        return torch.zeros(keys.shape[0], dtype=torch.int32,
                           device=keys.device)
    if lam32 < 10.0:
        return _poisson_knuth(keys, torch.tensor(
            lam32, dtype=torch.float32, device=keys.device))
    return _poisson_rejection(keys, lam32)


def row_randint(key: torch.Tensor, n: int, rows, k: int) -> torch.Tensor:
    """Uniform [0, n) int32 of shape (len(rows), k), one key per row id
    (the JAX package's vmapped ``row_randint``)."""
    return randint(row_keys(key, rows), (k,), 0, n)


def row_bernoulli(key: torch.Tensor, p: float, rows, k: int) -> torch.Tensor:
    """Bernoulli(p) mask of shape (len(rows), k), one key per row id (the
    JAX package's vmapped ``row_bernoulli``; constant masks at p <= 0 and
    p >= 1, with no draw)."""
    if p <= 0.0 or p >= 1.0:
        return torch.full((rows.shape[0], k), p >= 1.0, dtype=torch.bool,
                          device=key.device)
    return bernoulli(row_keys(key, rows), p, (k,))


def row_uniform_delay(key: torch.Tensor, low: int, high: int,
                      rows) -> torch.Tensor:
    """Row-keyed integer delay in [low, high) ticks, clamped to >= 1 (a
    message never lands in the window slot already drained)."""
    return torch.clamp_min(randint(row_keys(key, rows), (), low, high), 1)


def randint_excluding(key: torch.Tensor, n: int, shape,
                      *exclude) -> torch.Tensor:
    """Uniform draw from [0, n), then stepped off each excluded value
    (per-element tensors) by ``(r + 1) % n``, len(exclude) + 1 passes over
    all of them, in the JAX package's order."""
    r = randint(key, shape, 0, n)
    for _ in range(len(exclude) + 1):
        for e in exclude:
            r = torch.where(r == e, (r + 1) % n, r)
    return r
