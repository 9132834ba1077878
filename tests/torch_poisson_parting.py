"""Measure how many of graphs.erdos's Poisson degree draws part from the
JAX package's, over the per-row keys of a graph key (ROADMAP C5).

    JAX_PLATFORMS=cpu python tests/torch_poisson_parting.py [--rows N]
        [--seed S] [--lams 10,12,20,60]

Run it once as is (jax's default, partitionable counter layout) and once
with JAX_THREEFRY_PARTITIONABLE=0 (the original layout).  Prints one line
per lam: the rows whose utils/rng.poisson draw differs from
jax.random.poisson on the same keys (0 at every lam measured since the
port computes XLA's float32 log and lgamma).  tests/test_torch_graphs.py
holds the port to 0 at 2e4 rows."""

import argparse
import os
import sys

import jax
import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from gossip_simulator_tpu import config as jcfg  # noqa: E402
from gossip_simulator_tpu.models import graphs as jgraphs  # noqa: E402
from gossip_simulator_tpu_torch.utils import rng as trng  # noqa: E402


def parted(rows: int, seed: int, lam: float) -> int:
    jk = jgraphs._row_keys(jgraphs.graph_key(jcfg.Config(seed=seed)), 0,
                           rows)
    tk = trng.row_keys(trng.tick_key(trng.base_key(seed), 0, trng.OP_GRAPH),
                       torch.arange(rows, dtype=torch.int32))
    want = np.asarray(jax.vmap(
        lambda k: jax.random.poisson(jax.random.split(k)[0], lam, ()))(jk))
    return int((want != trng.poisson(trng.split(tk)[0], lam).numpy()).sum())


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=1_000_000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--lams", default="10,12,20,60")
    args = ap.parse_args()
    layout = bool(jax.config.jax_threefry_partitionable)
    trng.set_partitionable(layout)
    for lam in (float(x) for x in args.lams.split(",")):
        print(f"lam {lam:g}, partitionable={layout}: "
              f"{parted(args.rows, args.seed, lam)} of {args.rows} rows "
              "part", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
