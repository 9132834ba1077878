"""The static-graph generator kernels: the port's counterparts of the JAX
package's ``ops/pallas_graph.py``.

* ``kout_pallas(n, k, row0, rows, key)`` -> int32[rows, k]: each row picks
  k uniform peers with the ``(id + 1) % n`` self patch.  It is
  ``models/graphs.kout``'s generator at every fanout, with or without
  ``-pallas``.
* ``erdos_pallas(n, lam, row0, rows, key)`` -> (int32[rows, cap] -1-padded
  past the degree, int32[rows] degrees): out-degree ~ Poisson(lam) by the
  TPU kernel's float32 inverse-CDF recurrence, cap = ``config.er_cap(lam)``
  peer picks with the self patch.

The TPU kernels draw from the TPU's hardware PRNG, which exists only on a
TPU.  Here both draw from counter-based threefry streams keyed by the
GLOBAL row id, so any row range is the same rows of a full generation and
no row0 alignment is needed:

* kout's stream is the JAX package's fold_in generator
  (``models/graphs.kout``): per row ``fold_in(key, row)``, split, two
  ``random_bits`` words per column and jax's ``randint`` fold of them into
  [0, n).  The port's kout table, with or without ``-pallas``, is
  therefore bit-exact to the JAX package's default one.
* erdos's stream is ``random_bits(fold_in(fold_in(key, ER_STREAM), row),
  (cap + 1,))``, ER_STREAM being the JAX kernel's stream tag: word 0 gives
  the Poisson uniform ``(bits >> 8) * 2**-24``, words 1.. the peers
  ``bits % n``.  It is a graph of its own (the JAX package's CPU run
  falls back to ``graphs.erdos``, another stream).

Each plain version is a bit source (``kout_bits``, ``erdos_bits``) and the
TPU kernel's ``bits -> table`` arithmetic (``kout_table``,
``erdos_table``), so tests can feed both halves bits of their own.  On
the card each wrapper launches its CUDA kernel (``csrc/kout_pallas.cu``,
``csrc/erdos_pallas.cu``); on the CPU it takes the plain version.  Both
counter layouts of ``utils/rng.py`` are followed.
"""

from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from gossip_simulator_tpu_torch.config import er_cap
from gossip_simulator_tpu_torch.ops import _build, deliver
from gossip_simulator_tpu_torch.utils import rng as _rng

KOUT = "kout_pallas"
ERDOS = "erdos_pallas"
LANES = 128  # the JAX kernels' lane tile: -pallas's fanout and cap limits
LAM_MAX = 60.0  # the float32 pmf recurrence's limit (exp(-lam) normal)
ER_STREAM = 0x4552D14D  # the JAX kernel's stream tag
I32 = torch.int32
# The C entry points' parameter types (csrc/<name>.cu).
KOUT_ARGTYPES = ([ctypes.c_void_p] + [ctypes.c_int] * 4
                 + [ctypes.c_uint32] * 3 + [ctypes.c_int, ctypes.c_void_p])
ERDOS_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
                  + [ctypes.c_void_p])
UREM_ARGTYPES = ([ctypes.c_void_p] * 2 + [ctypes.c_longlong, ctypes.c_int,
                                          ctypes.c_void_p])


def _gids(row0: int, rows: int, device) -> torch.Tensor:
    return row0 + torch.arange(rows, dtype=I32, device=device)


def self_patch(peers: torch.Tensor, gids: torch.Tensor, n: int):
    """The reference's self-collision patch, (id+1)%N (simulator.go:98-100),
    of (rows, k) peers against the rows' global ids."""
    return torch.where(peers == gids[:, None], (peers + 1) % n, peers)


def randint_mult(n: int) -> int:
    """jax's ``randint`` multiplier for the span n: 2**32 % n in wrapping
    uint32 arithmetic."""
    mult = (2**16) % n
    return ((mult * mult) & _rng.M32) % n


# --- kout_pallas -------------------------------------------------------------


def kout_bits(n: int, k: int, row0: int, rows: int,
              key: torch.Tensor) -> torch.Tensor:
    """The bit source: the fold_in generator's draws as uint32 words in int64
    lanes, (rows, k), each already folded into [0, n)."""
    keys = _rng.row_keys(key, _gids(row0, rows, key.device))
    return _rng.randint(keys, (k,), 0, n).to(torch.int64)


def kout_table(bits: torch.Tensor, n: int, row0: int) -> torch.Tensor:
    """The TPU kernel's arithmetic (``_kout_kernel``): peers = bits mod n,
    then the self patch against the global row id.  int32 (rows, k)."""
    peers = (bits % n).to(I32)
    return self_patch(peers, _gids(row0, bits.shape[0], bits.device), n)


def kout_plain(n: int, k: int, row0: int, rows: int, key: torch.Tensor):
    return kout_table(kout_bits(n, k, row0, rows, key), n, row0)


def _key_words(key: torch.Tensor) -> tuple[int, int]:
    k0, k1 = key.reshape(2).tolist()
    return int(k0), int(k1)


def _launch_kout(n, k, row0, rows, key):
    dev = key.device
    out = torch.empty((rows, k), dtype=I32, device=dev)
    if rows == 0:
        return out
    fn = _build.function(KOUT, "gossip_kout_pallas", KOUT_ARGTYPES)
    k0, k1 = _key_words(key)
    _build.count_launch(KOUT)
    rc = fn(out.data_ptr(), n, k, row0, rows, k0, k1, randint_mult(n),
            int(_rng.partitionable()), deliver._stream(dev.index))
    _build.check(rc, KOUT)
    return out


def _check(name: str, n: int, row0: int, rows: int, key: torch.Tensor):
    if not 2 <= n < 2**31:
        raise ValueError(f"{name}: n must be in [2, 2**31), got {n}")
    if row0 < 0 or rows < 0 or row0 + rows > n:
        raise ValueError(f"{name}: rows [{row0}, {row0 + rows}) outside "
                         f"[0, {n})")
    if key.dtype != torch.int64 or key.numel() != 2:
        raise ValueError(f"{name}: key must be an int64 pair, got "
                         f"{key.dtype} {tuple(key.shape)}")


def kout_pallas(n: int, k: int, row0: int, rows: int, key: torch.Tensor):
    """friends int32[rows, k] of global rows [row0, row0 + rows): each row
    picks k uniform peers != self, bit-exact to the JAX package's
    ``graphs.kout`` with the same graph key."""
    _check(KOUT, n, row0, rows, key)
    if k < 1:
        raise ValueError(f"{KOUT}: k must be >= 1, got {k}")
    if key.device.type == "cpu":
        return kout_plain(n, k, row0, rows, key)
    if key.device.type == "cuda":
        return _launch_kout(n, k, row0, rows, key)
    raise ValueError(f"{KOUT}: no kernel for device {key.device}")


# --- erdos_pallas ------------------------------------------------------------


def erdos_row_key(key: torch.Tensor) -> torch.Tensor:
    """The stream's key: the graph key folded with ER_STREAM."""
    return _rng.fold_in(key, ER_STREAM)


def erdos_bits(n: int, lam: float, row0: int, rows: int,
               key: torch.Tensor) -> torch.Tensor:
    """The bit source: ``random_bits(fold_in(erdos_row_key(key), row),
    (cap + 1,))`` per global row, uint32 words in int64 lanes."""
    keys = _rng.row_keys(erdos_row_key(key), _gids(row0, rows, key.device))
    return _rng.random_bits(keys, (er_cap(lam) + 1,))


def erdos_pmf0(lam: float) -> float:
    """float32(exp(-lam)), the recurrence's first pmf."""
    return float(np.float32(math.exp(-lam)))


def erdos_cdf(lam: float, cap: int) -> np.ndarray:
    """cdf_j, j < cap, of the TPU kernel's float32 recurrence cdf += pmf,
    pmf *= lam / (j + 1), in that order from pmf = float32(exp(-lam)).
    It depends on lam alone, so every row compares with one table; numpy
    rounds each float32 operation once, as the kernel's do."""
    lam32, pmf, cdf = np.float32(lam), np.float32(erdos_pmf0(lam)), \
        np.float32(0.0)
    out = np.empty(cap, dtype=np.float32)
    for j in range(cap):
        cdf = np.float32(cdf + pmf)
        out[j] = cdf
        pmf = np.float32(pmf * np.float32(lam32 / np.float32(j + 1)))
    return out


def erdos_table(bits: torch.Tensor, n: int, lam: float, row0: int):
    """The TPU kernel's arithmetic (``_erdos_kernel`` and its wrapper):
    word 0 -> u = (bits >> 8) * 2**-24; degree = #{j < cap : u > cdf_j}
    (``erdos_cdf``); words 1.. -> peers bits mod n with the self patch, -1
    at and past the degree.  Returns (friends int32[rows, cap], deg
    int32[rows])."""
    rows, cap = bits.shape[0], bits.shape[1] - 1
    dev = bits.device
    u = (bits[:, 0] >> 8).to(torch.float32) * (2.0**-24)
    cdf = torch.from_numpy(erdos_cdf(lam, cap)).to(dev)
    deg = torch.clamp_max((u[:, None] > cdf[None, :]).sum(1, dtype=I32),
                          cap)
    peers = self_patch((bits[:, 1:] % n).to(I32), _gids(row0, rows, dev), n)
    slot = torch.arange(cap, dtype=I32, device=dev)[None, :]
    return torch.where(slot < deg[:, None], peers, -1), deg


def erdos_plain(n: int, lam: float, row0: int, rows: int, key: torch.Tensor):
    return erdos_table(erdos_bits(n, lam, row0, rows, key), n, lam, row0)


@functools.lru_cache(maxsize=16)
def erdos_cdf_param(lam: float, cap: int):
    """``erdos_cdf(lam, cap)`` as the C float array the launch copies into
    its parameters, built once per (lam, cap)."""
    return (ctypes.c_float * cap)(*erdos_cdf(lam, cap).tolist())


@functools.cache
def _erdos_fn():
    """erdos_pallas's typed C entry point, held once it is built."""
    return _build.function(ERDOS, "gossip_erdos_pallas", ERDOS_ARGTYPES)


def _launch_erdos(n, lam, row0, rows, key):
    dev = key.device
    cap = er_cap(lam)
    friends = torch.empty((rows, cap), dtype=I32, device=dev)
    deg = torch.empty(rows, dtype=I32, device=dev)
    if rows == 0:
        return friends, deg
    # The kernel reads the key's two words on the card (no host read) and
    # folds in ER_STREAM.
    key = key.reshape(2)
    if not key.is_contiguous():
        key = key.contiguous()
    fn = _erdos_fn()
    _build.count_launch(ERDOS)
    rc = fn(friends.data_ptr(), deg.data_ptr(), key.data_ptr(),
            erdos_cdf_param(lam, cap), n, cap, row0, rows,
            int(_rng.partitionable()), deliver._stream(dev.index))
    if rc:
        _build.check(rc, ERDOS)
    return friends, deg


def erdos_urem(x: torch.Tensor, n: int) -> torch.Tensor:
    """x % n of uint32 words (int32 storage, on the card) by the remainder
    erdos_pallas takes: a multiply-high with a magic number fixed for n
    (for the tests; no launch count)."""
    x = x.contiguous()
    out = torch.empty_like(x)
    fn = _build.function(ERDOS, "gossip_erdos_urem", UREM_ARGTYPES)
    rc = fn(x.data_ptr(), out.data_ptr(), x.numel(), n,
            deliver._stream(x.device.index))
    _build.check(rc, ERDOS)
    return out


def erdos_pallas(n: int, lam: float, row0: int, rows: int,
                 key: torch.Tensor):
    """Sparse directed Erdős–Rényi rows [row0, row0 + rows): (friends
    int32[rows, cap] -1-padded, deg int32[rows]).  Requires 0 < lam <=
    60 and cap <= 128, as the JAX kernel does."""
    _check(ERDOS, n, row0, rows, key)
    if not 0.0 < lam <= LAM_MAX or er_cap(lam) > LANES:
        raise ValueError(f"{ERDOS}: needs 0 < lam <= {LAM_MAX:g} and cap "
                         f"<= {LANES}, got lam {lam} (cap {er_cap(lam)})")
    if key.device.type == "cpu":
        return erdos_plain(n, lam, row0, rows, key)
    if key.device.type == "cuda":
        return _launch_erdos(n, lam, row0, rows, key)
    raise ValueError(f"{ERDOS}: no kernel for device {key.device}")
