"""Wall seconds of sharded_10m on the card: the sharded backend on 8
shards laid out on one card (``ShardedStepper(cfg, n_devices=8)``) under
sharded_10m's flags (kout, fanout 3, crash rate 0.001, to 90 %,
``-pallas``, n = 10^7), alone on the card.  It goes through the
package's public calls only (parse_cli, ShardedStepper, run_simulation),
so the same script reads a parent tree too: copy it into that tree's
tests/ and run it there and here in turns (parent, this, this, parent)
in one call of the card, e.g.

    python3 tests/torch_sharded_walls.py --label this

or, in one tree, the spatial panels off and on in turns (off, on, on,
off), ``--spatial`` adding ``-telemetry-spatial on`` (the history's
panels and the route's traffic counters).  An untimed run at n = 10^6
first builds the kernels and warms the allocator; the timed runs then
print their wall seconds, windows, total_message and launches of fused_recv_land, beside the card's name
and power limit."""

import argparse
import io
import os
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

SHARDS = 8


def argv(n: int) -> list:
    return ["-backend", "sharded", "-graph", "kout", "-n", str(n),
            "-fanout", "3", "-crashrate", "0.001", "-coverage-target",
            "0.90", "-pallas", "-seed", "0"]


def run(n: int, extra=()):
    """(wall s, RunResult, fused_recv_land launches) of one run at n."""
    from gossip_simulator_tpu_torch import run_simulation
    from gossip_simulator_tpu_torch.backends import ShardedStepper
    from gossip_simulator_tpu_torch.config import parse_cli
    from gossip_simulator_tpu_torch.ops import _build
    from gossip_simulator_tpu_torch.utils.metrics import ProgressPrinter

    cfg, _ = parse_cli(argv(n) + list(extra))
    stepper = ShardedStepper(cfg, n_devices=SHARDS, device="cuda")
    _build.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with ProgressPrinter(cfg.progress, out=io.StringIO()) as pr:
        res = run_simulation(cfg, printer=pr, stepper=stepper)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0, res,
            _build.LAUNCHES["fused_recv_land"])


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--label", default="this")
    ap.add_argument("--n", type=int, default=10_000_000)
    ap.add_argument("--reps", type=int, default=1)
    ap.add_argument("--spatial", action="store_true",
                    help="record the spatial panels (-telemetry-spatial on)")
    args = ap.parse_args()
    extra = ["-telemetry-spatial", "on"] if args.spatial else []
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    run(1_000_000, extra)
    for rep in range(args.reps):
        wall, res, recv = run(args.n, extra)
        print(f"{args.label} sharded n={args.n} S={SHARDS} spatial "
              f"{'on' if args.spatial else 'off'} rep {rep}: wall "
              f"{wall:.3f} s, {res.gossip_windows} windows, total_message "
              f"{res.stats.total_message}, fused_recv_land x {recv}; {card}",
              flush=True)


if __name__ == "__main__":
    main()
