"""The event engine's word fold on the card: two exact ways to get each
node-run's OR of its entries' rumor words in a sorted drain chunk with
plain PyTorch (it has no scatter OR), timed at the multi-rumor runs'
chunk sizes; models/event.py keeps the faster:

* bits -- ``models/event.segmented_or``: each lane's words unpacked to
  W * 32 bit lanes (uint8), each run's ``scatter_reduce`` amax, packed
  again (no host read);
* scan -- a doubling suffix scan, lane i taking lane i + d's words while
  i + d lies in its run, over ceil(log2(longest run)) passes after one
  host read of that length.

Chunks: 131,072 entries (n = 10^6, multirumor1m_r16's drain chunk) and
1,048,576 (n = 5 * 10^7), W = 1 and 2, keys drawn as a window's sorted
destinations (about two entries a row), words sparse random.  Each
prints CUDA-event ms (median of 25, the host read included) beside the
card's name and power limit, and checks that both give every run's
first lane the same OR.  Run from the repo root on the card:

    python3 tests/torch_segor_times.py
"""

import os
import statistics
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from gossip_simulator_tpu_torch.models import event  # noqa: E402

REPS = 25


def seg_or_scan(key_s, words_s, live):
    """Each run's OR, at the run's first lane, for the runs of the `live`
    lanes: the doubling suffix scan."""
    m = key_s.shape[0]
    idx = torch.arange(m, dtype=torch.int32, device=key_s.device)
    newrun = torch.ones(m, dtype=torch.bool, device=key_s.device)
    newrun[1:] = key_s[1:] != key_s[:-1]
    start = torch.cummax(torch.where(newrun, idx, 0), dim=0).values
    longest = int(torch.where(live, idx - start, 0).max()) + 1
    v = words_s
    d = 1
    while d < longest:
        same = torch.zeros(m, dtype=torch.bool, device=key_s.device)
        same[:m - d] = key_s[d:] == key_s[:m - d]
        nxt = torch.zeros_like(v)
        nxt[:m - d] = v[d:]
        v = v | torch.where(same[:, None], nxt, 0)
        d *= 2
    return v


def time_ms(fn) -> float:
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(REPS):
        a = torch.cuda.Event(enable_timing=True)
        z = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        z.record()
        z.synchronize()
        out.append(a.elapsed_time(z))
    return statistics.median(out)


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_segor_times: needs a CUDA card", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    for n, ccap in ((1_000_000, 131_072), (50_000_000, 1_048_576)):
        # A peak window's entries land on about ccap / 2 distinct rows.
        rows = ccap // 2
        keys = torch.sort(torch.randint(0, rows, (ccap,), generator=gen,
                                        device=dev) * (n // rows)).values
        keys = keys.to(torch.int32)
        live = torch.ones(ccap, dtype=torch.bool, device=dev)
        first = torch.ones(ccap, dtype=torch.bool, device=dev)
        first[1:] = keys[1:] != keys[:-1]
        for w in (1, 2):
            words = (torch.randint(-2**31, 2**31, (ccap, w), generator=gen,
                                   device=dev, dtype=torch.int64)
                     & torch.randint(-2**31, 2**31, (ccap, w), generator=gen,
                                     device=dev, dtype=torch.int64)
                     ).to(torch.int32)
            a = seg_or_scan(keys, words, live)
            b = event.segmented_or(keys, words)
            if not torch.equal(a[first], b[first]):
                print(f"FAIL: the two folds differ (n {n}, W {w})")
                return 1
            t_scan = time_ms(lambda: seg_or_scan(keys, words, live))
            t_bits = time_ms(lambda: event.segmented_or(keys, words))
            print(f"segor n={n} ccap={ccap} W={w}: scan {t_scan:.4f} ms, "
                  f"bits {t_bits:.4f} ms ({smi})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
