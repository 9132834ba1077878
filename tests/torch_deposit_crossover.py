"""Time fused_deposit_add's two forms, the direct pass of global atomics
and the dense form that adds by ring partitions in shared memory, against
the lanes a ring cell: where the dense form starts to win is the wrapper's
DEPOSIT_DENSE_MIN (ops/deliver.py).

    python tests/torch_deposit_crossover.py [--ratios 0.003,...,6]
        [--layouts slot,rows] [--reps 25] [--seed 0]

Needs a CUDA card.  Two lane layouts over a 2e7-cell ring, spanning the
full-size runs' deposits (lanes a cell: ring_kout10m's chunk 0.0023,
rumors1m_p2_xla's deposit 0.3, ring_rounds10m's rounds deposit 3):

* slot -- b = 2, n = 1e7, every lane into slot 1 at a random destination,
  35 % of them valid (the rounds-mode deposit);
* rows -- b = 20, n = 1e6, six lanes a sender row sharing the row's random
  slot, a fifth of the rows sending, 90 % of their lanes kept (the
  multi-rumor deposit).

For each layout and ratio, m = ratio * b * n lanes; each form is forced
through the wrapper's constant and called with the mask (as
models/epidemic.deposit_local calls it), the two results held bit-exact to
each other.  Prints the card's name and power limit, then one line a
point: the call's median ms (CUDA events around the call alone) in each
form, and the faster; last, the smallest ratio from which the dense form
is faster at every larger ratio of every layout."""

import argparse
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from gossip_simulator_tpu_torch.ops import deliver  # noqa: E402


def median_ms(call, reps: int) -> float:
    """Median of `reps` CUDA-event timings of call() after one warm-up."""
    call()
    times = []
    for _ in range(reps):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        call()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return sorted(times)[len(times) // 2]


def lanes(layout: str, m: int, gen: torch.Generator):
    """(b, n, slots, dst, valid) of m lanes in `layout`."""
    dev = torch.device("cuda", 0)
    ri = lambda lo, hi, shape: torch.randint(  # noqa: E731
        lo, hi, shape, generator=gen, device=dev, dtype=torch.int32)
    if layout == "slot":
        b, n = 2, 10_000_000
        slots = torch.ones(m, dtype=torch.int32, device=dev)
        valid = torch.rand(m, generator=gen, device=dev) < 0.35
    else:
        b, n, k = 20, 1_000_000, 6
        rows = -(-m // k)
        slots = ri(0, b, (rows,)).repeat_interleave(k)[:m].contiguous()
        sending = (torch.rand(rows, generator=gen, device=dev) < 0.2
                   ).repeat_interleave(k)[:m]
        valid = sending & (torch.rand(m, generator=gen, device=dev) < 0.9)
    return b, n, slots, ri(0, n, (m,)), valid


def one_point(layout: str, ratio: float, reps: int,
              gen: torch.Generator) -> tuple:
    """(m, direct ms, dense ms) at `ratio` lanes a cell."""
    b, n, slots, dst, valid = lanes(layout, 1, gen)
    m = max(1, int(ratio * b * n))
    b, n, slots, dst, valid = lanes(layout, m, gen)
    pend = torch.zeros((b, n), dtype=torch.int32, device="cuda")
    out, ms = {}, {}
    for form, lim in (("direct", float("inf")), ("dense", 0.0)):
        deliver.DEPOSIT_DENSE_MIN = lim
        if (deliver.deposit_part_bits(m, b * n) > 0) != (form == "dense"):
            raise SystemExit(f"{layout} {ratio}: no {form} form here")
        pend.zero_()
        deliver.fused_deposit_add(pend, slots, dst, valid)
        out[form] = pend.clone()
        ms[form] = median_ms(
            lambda: deliver.fused_deposit_add(pend, slots, dst, valid),
            reps)
    if not torch.equal(out["direct"], out["dense"]):
        raise SystemExit(f"{layout} {ratio}: the two forms differ")
    return m, ms["direct"], ms["dense"]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ratios",
                    default="0.003,0.01,0.03,0.1,0.3,0.5,0.75,1,1.5,2,3,6")
    ap.add_argument("--layouts", default="slot,rows")
    ap.add_argument("--reps", type=int, default=25)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_deposit_crossover: needs a CUDA card", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    print(f"card: {smi.stdout.strip()}", flush=True)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(args.seed)
    keep = deliver.DEPOSIT_DENSE_MIN
    ratios = sorted(map(float, args.ratios.split(",")))
    dense_from = 0.0
    try:
        for layout in args.layouts.split(","):
            for ratio in ratios:
                m, d, s = one_point(layout, ratio, args.reps, gen)
                faster = "dense" if s < d else "direct"
                if faster == "direct":
                    dense_from = max(dense_from, ratio * 1.0000001)
                print(f"deposit {layout} {ratio:g} lanes a cell ({m} "
                      f"lanes): direct {d:.4f} ms, dense {s:.4f} ms: "
                      f"{faster} faster", flush=True)
                torch.cuda.empty_cache()
    finally:
        deliver.DEPOSIT_DENSE_MIN = keep
    above = [r for r in ratios if r >= dense_from]
    print(f"dense faster at every ratio from {above[0] if above else 'none'}"
          f" (DEPOSIT_DENSE_MIN is {keep:g})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
