"""Time fused_deposit_add and erdos_pallas at the full-size paths' shapes,
with calls that every tree of the port since slice 6 takes, so that two
trees are compared on one card.

    python tests/torch_deposit_erdos_times.py [--reps 25] [--seed 0]

Needs a CUDA card.  It runs the package (and the chip_smoke.py timing
helpers) beside its own directory, so a copy placed in another tree (an
unpacked `git archive` of an earlier commit) times that tree.  Shapes:

* fused_deposit_add at ring_rounds10m's rounds deposit (b 2, n 1e7, 6e7
  lanes, all into slot 1, 35 % valid), at ring_kout10m's compacted ticks
  chunk (b 20, n 1e7, 78,125 sender rows x 6, 90 % kept) and at
  rumors1m_p2_xla's deposit (b 20, n 1e6, 6e6 lanes, a fifth of the rows
  sending, 90 % of their lanes kept): the kernel called on the dst = n
  lanes, and the whole deposit as the ring engine makes it
  (models/epidemic.deposit_local with the pallas gate: the caller's mask
  pass and the kernel in a tree whose kernel takes no mask, the kernel
  alone in one that does);
* erdos_pallas at sir_10m_erdos's 1e7 rows, lam 8, and at 1e6 rows, lam 60.

Prints the card's name and power limit, then a line a case: the call's
median ms (CUDA events around the call, host enqueue in), the device ms a
call (torch.profiler, every kernel the call launches) with its launches,
and the host's enqueue us on an idle card."""

import argparse
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from gossip_simulator_tpu_torch.config import Config  # noqa: E402
from gossip_simulator_tpu_torch.models import epidemic, graphs  # noqa: E402
from gossip_simulator_tpu_torch.ops import deliver, graph  # noqa: E402


def line(label: str, fn, reps: int, host: bool = True) -> None:
    t = cs.time_ms(fn, reps)
    split, launches = cs._profile_split(fn, cs.DEVICE_REPS)
    dev = (f"{sum(split.values()):.4f} ms in "
           f"{launches / cs.DEVICE_REPS:g} launches (" + ", ".join(
               f"{k} {v:.4f}" for k, v in sorted(
                   split.items(), key=lambda kv: -kv[1])) + ")"
           if split else "not measured")
    enq = f"; enqueue {cs.host_us(fn, 100):.2f} us" if host else ""
    print(f"times {label}: call {t:.4f} ms; device {dev}{enq}", flush=True)


def deposit_cases(dev, gen, reps: int) -> None:
    ri = lambda lo, hi, shape: torch.randint(  # noqa: E731
        lo, hi, shape, generator=gen, device=dev, dtype=torch.int32)
    for name, b, n, rows, per_row, keep, sending in (
            ("rounds", 2, 10_000_000, 10_000_000, False, 0.35, 1.0),
            ("chunk", 20, 10_000_000, 78_125, True, 0.9, 1.0),
            ("rumors", 20, 1_000_000, 1_000_000, True, 0.9, 0.2)):
        m = rows * 6
        slots = (ri(0, b, (rows,)).repeat_interleave(6) if per_row
                 else torch.ones(m, dtype=torch.int32, device=dev))
        dst = ri(0, n, (m,))
        valid = torch.rand(m, generator=gen, device=dev) < keep
        if sending < 1.0:
            valid &= (torch.rand(rows, generator=gen, device=dev)
                      < sending).repeat_interleave(6)
        dst_n = torch.where(valid, dst, n).to(torch.int32)
        pend = torch.zeros((b, n), dtype=torch.int32, device=dev)
        line(f"fused_deposit_add[{name}] kernel",
             lambda: deliver.fused_deposit_add(  # noqa: B023
                 pend, slots, dst_n), reps)  # noqa: B023
        line(f"fused_deposit_add[{name}] deposit_local",
             lambda: epidemic.deposit_local(  # noqa: B023
                 pend, dst, slots, valid, kernel="pallas"), reps)  # noqa
        del slots, dst, valid, dst_n, pend
        torch.cuda.empty_cache()


def erdos_cases(dev, reps: int) -> None:
    key = graphs.graph_key(Config(seed=0), dev)
    for name, n, lam in (("lam8", 10_000_000, 8.0),
                         ("lam60", 1_000_000, 60.0)):
        line(f"erdos_pallas[{name}]",
             lambda: graph.erdos_pallas(n, lam, 0, n, key),  # noqa: B023
             reps, host=False)
        torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=25)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_deposit_erdos_times: needs a CUDA card",
              file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(f"card: {smi}", flush=True)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    deposit_cases(dev, gen, args.reps)
    erdos_cases(dev, args.reps)
    return 0


if __name__ == "__main__":
    sys.exit(main())
