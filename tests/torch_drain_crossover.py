"""Time fused_drain_sum's two forms, the direct kernel and the tile form,
against the accumulator's size: where the tile form starts to win is the
wrapper's DRAIN_DIRECT_MAX (ops/megakernel.py).

    python tests/torch_drain_crossover.py [--mib 1.5,3,6,12,24,48,96]
        [--cols 12,36] [--fanout 6] [--reps 25] [--seed 0]

Needs a CUDA card.  For each column count C and accumulator size, the
drain of one slot of fanout * n live lanes (rows drawn uniformly from [0,
n), PushSum's traffic) into an (n, C) int32 accumulator, each form forced
through the wrapper's constants; the two results are held bit-exact to
each other.  Prints the card's name and power limit, then one line per
size: the call's median ms (CUDA events around the call alone, 25 calls,
the accumulator restored between them) in each form, and the faster."""

import argparse
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from gossip_simulator_tpu_torch.ops import megakernel  # noqa: E402


def median_ms(call, restore, reps: int) -> float:
    """Median of `reps` CUDA-event timings of call(), restore() before
    each (outside the events)."""
    times = []
    for _ in range(reps):
        restore()
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        call()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return sorted(times)[len(times) // 2]


def one_size(c: int, mib: float, fanout: int, reps: int,
             gen: torch.Generator) -> tuple:
    """(n, direct ms, tile ms) for an accumulator of `mib` MiB, C = c."""
    dev = torch.device("cuda", 0)
    i32 = dict(dtype=torch.int32, device=dev)
    n = max(1, int(mib * (1 << 20)) // (4 * c))
    m, b = fanout * n, 10
    ids = (torch.randint(0, n, (m,), generator=gen, **i32) * b
           + torch.randint(0, b, (m,), generator=gen, **i32))
    mass = torch.randint(0, 1 << 16, (m, c), generator=gen, **i32)
    cnt = torch.full((1, 1), m, **i32)
    acc0 = torch.randint(0, 1 << 16, (n, c), generator=gen, **i32)
    acc = acc0.clone()
    out, ms = {}, {}
    for form, direct_max in (("direct", 1 << 62), ("tile", 0)):
        megakernel.DRAIN_DIRECT_MAX = direct_max
        want = 0 if form == "direct" else 1
        if (megakernel.drain_part_rows(n, c) > 0) != want:
            raise SystemExit(f"C {c}, {mib} MiB: no {form} form here")

        def call():
            megakernel.fused_drain_sum(acc, ids, mass, cnt, 0, cap=m, b=b)

        acc.copy_(acc0)
        call()
        out[form] = acc.clone()
        ms[form] = median_ms(call, lambda: acc.copy_(acc0), reps)
    if not torch.equal(out["direct"], out["tile"]):
        raise SystemExit(f"C {c}, {mib} MiB: the two forms differ")
    return n, ms["direct"], ms["tile"]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mib", default="1.5,3,6,12,24,48,96")
    ap.add_argument("--cols", default="12,36")
    ap.add_argument("--fanout", type=int, default=6)
    ap.add_argument("--reps", type=int, default=25)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_drain_crossover: needs a CUDA card", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    print(f"card: {smi.stdout.strip()}", flush=True)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(args.seed)
    keep = megakernel.DRAIN_DIRECT_MAX
    try:
        for c in map(int, args.cols.split(",")):
            for mib in map(float, args.mib.split(",")):
                n, d, t = one_size(c, mib, args.fanout, args.reps, gen)
                print(f"drain C {c} acc {mib} MiB (n {n}, "
                      f"{args.fanout * n} lanes): direct {d:.4f} ms, tile "
                      f"{t:.4f} ms: {'direct' if d <= t else 'tile'} "
                      f"faster", flush=True)
                torch.cuda.empty_cache()
    finally:
        megakernel.DRAIN_DIRECT_MAX = keep
    return 0


if __name__ == "__main__":
    sys.exit(main())
