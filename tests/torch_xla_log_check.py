"""Check the port's float32 ``xla_log`` (utils/rng.py) against ``jnp.log``
on every positive finite float32, and the Poisson sampler's ``xla_log1p``
and ``xla_lgamma`` on their ranges (ROADMAP C5).

    JAX_PLATFORMS=cpu python tests/torch_xla_log_check.py [--chunk-log2 24]

Walks the bit patterns 0 .. 0x7F7FFFFF in chunks and prints the count of
results whose bits differ (0 expected), then the log1p and lgamma
counts.  Tier 1 holds a sample of the same comparison
(tests/test_torch_graphs.py)."""

import argparse
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from gossip_simulator_tpu_torch.utils import rng as trng  # noqa: E402

LAST = 0x7F7FFFFF  # the largest finite float32


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--chunk-log2", type=int, default=24)
    args = ap.parse_args()
    step = 1 << args.chunk_log2
    jlog = jax.jit(jnp.log)
    bad = 0
    for lo in range(0, LAST + 1, step):
        bits = np.arange(lo, min(lo + step, LAST + 1), dtype=np.uint32)
        x = bits.view(np.float32)
        want = np.asarray(jlog(x)).view(np.uint32)
        got = trng.xla_log(torch.from_numpy(x)).numpy().view(np.uint32)
        bad += int((want != got).sum())
    print(f"log: {bad} of {LAST + 1} positive finite float32 differ",
          flush=True)
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.uniform(-0.99, 1e3, 1 << 22),
                        rng.uniform(-1e-3, 1e-3, 1 << 20)]).astype(np.float32)
    d = np.asarray(jax.jit(jnp.log1p)(x)) != trng.xla_log1p(
        torch.from_numpy(x)).numpy()
    print(f"log1p: {int(d.sum())} of {x.size} sampled differ", flush=True)
    x = np.concatenate([np.arange(1, 1 << 20, dtype=np.float32),
                        rng.uniform(0.5, 1e6, 1 << 22).astype(np.float32)])
    d = np.asarray(jax.jit(jax.lax.lgamma)(x)) != trng.xla_lgamma(
        torch.from_numpy(x)).numpy()
    print(f"lgamma: {int(d.sum())} of {x.size} on [0.5, 1e6) differ")
    return 0


if __name__ == "__main__":
    sys.exit(main())
