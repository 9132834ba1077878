"""Where one call of fused_ring_append, fused_emit, fused_deposit_rows and
fused_deposit_both spends its host time, at the full-size paths' shapes:
one torch.profiler session (CPU and CUDA activities) a case.

    python tests/torch_host_trace.py [--calls 3] [--seed 0]

Needs a CUDA card.  It runs the package beside its own directory, so a
copy placed in another tree (an unpacked `git archive` of an earlier
commit) traces that tree's wrappers.  Cases: fused_ring_append at the 10M
default run's emission chunk into its two rings (main, and a small cap
that overflows) and at pushsum10m's window (6e7 lanes into the id ring and
the 12-limb mass ring); fused_emit at the kout 10M run's batch (131,072
senders, 6 friends, 3 ring slots; SI, and SIR with the duplicate filter);
fused_deposit_rows at the multi-rumor 1M run's deposit (6e6 lanes x 16, a
fifth of the rows sending) and at PushSum's drain chunk (524,288 lanes x
12); fused_deposit_both at the multi-rumor deposit; fused_deposit_add as
the ring engine calls it (models/epidemic.deposit_local, pallas gate) at
ring_kout10m's compacted chunk (468,750 lanes over 20 x 1e7) and at
ring_rounds10m's rounds deposit (6e7 lanes over 2 x 1e7).  Prints the
card's name and power limit, then a line a case: the enqueue (the host clock around the wrapper call,
the profiler's own costs in), the CUDA runtime calls inside the call's
range (count and host us by name), its aten ops (self host us, the six
largest) and the caching allocator's counters around the call (device
allocations and frees, synchronisations of all streams, retries,
requests), each a call, the state restored before each call outside the
range.  The profiler links no kernel launched through ctypes to the range:
the device time is chip_smoke.py's "device" line of the case."""

import argparse
import os
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from gossip_simulator_tpu_torch.config import Config, parse_cli  # noqa: E402
from gossip_simulator_tpu_torch.models import epidemic, event  # noqa: E402
from gossip_simulator_tpu_torch.models import overlay_ticks as ot  # noqa: E402
from gossip_simulator_tpu_torch.models import pushsum as ps  # noqa: E402
from gossip_simulator_tpu_torch.ops import deliver, megakernel  # noqa: E402

ALLOC_STATS = ("num_device_alloc", "num_device_free", "num_sync_all_streams",
               "num_alloc_retries", "allocation.all.allocated")
PUSHSUM_ARGV = ["-model", "pushsum", "-graph", "kout", "-fanout", "6",
                "-droprate", "0", "-crashrate", "0", "-n", "10000000"]


def _descendants(evt):
    for c in evt.cpu_children:
        yield c
        yield from _descendants(c)


def host_trace(label: str, fn, setup, calls: int) -> None:
    """One profiler session of a warm-up call and `calls` calls of fn(),
    each in its own record_function range, setup() before each outside
    it; prints the case's line."""
    from torch.profiler import ProfilerActivity, profile, record_function

    enq, alloc = 0.0, dict.fromkeys(ALLOC_STATS, 0)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(calls + 1):
            setup()
            torch.cuda.synchronize()
            before = torch.cuda.memory_stats()
            with record_function(f"host_trace_{i}"):
                t0 = time.perf_counter()
                fn()
                dt = time.perf_counter() - t0
            after = torch.cuda.memory_stats()
            torch.cuda.synchronize()
            if i:
                enq += dt
                for k in ALLOC_STATS:
                    alloc[k] += after.get(k, 0) - before.get(k, 0)
    api, ops = {}, {}
    for e in prof.events():
        if not e.name.startswith("host_trace_") or e.name == "host_trace_0":
            continue
        for d in _descendants(e):
            if d.name.startswith("cuda"):
                c, us = api.get(d.name, (0, 0.0))
                api[d.name] = (c + 1, us + d.cpu_time_total)
            elif d.name.startswith("aten::"):
                ops[d.name] = ops.get(d.name, 0.0) + d.self_cpu_time_total
    runtime = ", ".join(
        f"{k} {c / calls:g}x {us / calls:.2f} us"
        for k, (c, us) in sorted(api.items(), key=lambda kv: -kv[1][1]))
    aten = ", ".join(f"{k} {us / calls:.2f} us" for k, us in sorted(
        ops.items(), key=lambda kv: -kv[1])[:6])
    print(f"host trace {label}: enqueue {1e6 * enq / calls:.2f} us a call "
          f"under the profiler; runtime {runtime or 'none seen'}; aten "
          f"{aten or 'none'}; allocator " + ", ".join(
              f"{k} {v / calls:g}" for k, v in alloc.items()), flush=True)


def ring_cases(dev, gen, calls: int) -> None:
    ri = lambda lo, hi, shape: torch.randint(  # noqa: E731
        lo, hi, shape, generator=gen, device=dev, dtype=torch.int32)
    cfg = Config(n=10_000_000).validate()
    dw, cap, m = ot.ring_windows(cfg), ot.slot_cap(cfg), ot.emit_chunk(cfg)
    for name, ccap, base_hi in (("main", cap, cap // 2),
                                ("overflow", 150_000, 100_000)):
        rings = [ri(0, 2**30, (dw * ccap + 1,)) for _ in range(2)]
        cnt0 = ri(0, base_hi, (1, dw))
        cnt, dropped = cnt0.clone(), torch.zeros((), dtype=torch.int32,
                                                 device=dev)
        pays = (ri(0, cfg.n, (m,)), ri(0, 2**30, (m,)))
        wslot = ri(0, dw, (m,))
        valid = torch.rand(m, generator=gen, device=dev) < 0.9
        host_trace(
            f"fused_ring_append[{name}]",
            lambda: deliver.fused_ring_append(  # noqa: B023
                rings, cnt, dropped, pays, wslot, valid, dw, ccap),  # noqa: B023
            lambda: (cnt.copy_(cnt0), dropped.zero_()), calls)  # noqa: B023
        del rings, pays
    cfg, _ = parse_cli(PUSHSUM_ARGV)
    n, m, c, b = cfg.n, cfg.n * cfg.fanout, ps.mass_cols(cfg), \
        ps.batch_ticks(cfg)
    dw, cap, length = ps.ring_windows(cfg), ps.slot_cap(cfg), ps.ring_len(cfg)
    rings = [ri(0, 1, (length,)), ri(0, 1, (length, c))]
    cnt, dropped = ri(0, 1, (1, dw)), ri(0, 1, ())
    pays = (ri(0, n * b, (m,)), ri(0, 2**16, (m, c)))
    wslot, valid = ri(1, 2, (m,)), torch.ones(m, dtype=torch.bool,
                                              device=dev)
    host_trace("fused_ring_append[wide]",
               lambda: deliver.fused_ring_append(
                   rings, cnt, dropped, pays, wslot, valid, dw, cap),
               lambda: (cnt.zero_(), dropped.zero_()), calls)
    del rings, pays
    torch.cuda.empty_cache()


def emit_cases(dev, gen, calls: int) -> None:
    ri = lambda lo, hi, shape: torch.randint(  # noqa: E731
        lo, hi, shape, generator=gen, device=dev, dtype=torch.int32)
    cfg = Config(n=10_000_000, fanout=6, graph="kout").validate()
    n, k, b = cfg.n, cfg.fanout, event.batch_ticks(cfg)
    dw, cap = event.ring_windows(cfg), event.slot_cap(cfg)
    m = event.sender_compaction_cap(cfg, event.drain_chunk(cfg))
    ring = torch.zeros(dw * cap + event.ring_tail(cfg), dtype=torch.int32,
                       device=dev)
    svalid = torch.arange(m, device=dev) < m - m // 10
    args = (ri(0, cap // 2, (1, dw)), ri(0, n, (m, k)),
            torch.rand((m, k), generator=gen, device=dev) < 0.1, svalid,
            ri(0, dw, (m,)), ri(0, b, (m,)))
    sir = dict(tb=(n + 1) * b, strig=svalid, sender_ids=ri(0, n, (m,)),
               flags=(torch.rand(n + 1, generator=gen, device=dev) < 0.5
                      ).to(torch.uint8))
    for name, kw in (("si", {}), ("sir_dup", sir)):
        host_trace(f"fused_emit[{name}]",
                   lambda: megakernel.fused_emit(  # noqa: B023
                       ring, *args, dw=dw, cap=cap, b=b, **kw),  # noqa: B023
                   lambda: None, calls)
    del ring
    torch.cuda.empty_cache()


def deposit_cases(dev, gen, calls: int) -> None:
    ri = lambda lo, hi, shape: torch.randint(  # noqa: E731
        lo, hi, shape, generator=gen, device=dev, dtype=torch.int32)
    b, n, r, k = 20, 1_000_000, 16, 6
    m = n * k
    slots = ri(0, b, (n,)).repeat_interleave(k)
    sending = (torch.rand(n, generator=gen, device=dev) < 0.2
               ).repeat_interleave(k)
    dst = torch.where(sending, ri(0, n, (m,)), n).to(torch.int32)
    vals = (torch.rand((n, r), generator=gen, device=dev) < 0.25).to(
        torch.int32).repeat_interleave(k, dim=0)
    pend = ri(0, 4, (b, n, r))
    host_trace("fused_deposit_rows",
               lambda: deliver.fused_deposit_rows(pend, slots, dst, vals),
               lambda: None, calls)
    count = ri(0, 4, (b, n))
    newbits = vals[::k] != 0
    host_trace("fused_deposit_both",
               lambda: megakernel.fused_deposit_both(
                   count, pend, dst, slots, sending, newbits),
               lambda: None, calls)
    del pend, count
    for name, b, n, rows, per_row, keep in (
            ("chunk", 20, 10_000_000, 78_125, True, 0.9),
            ("rounds", 2, 10_000_000, 10_000_000, False, 0.35)):
        m = rows * k
        slots = (ri(0, b, (rows,)).repeat_interleave(k) if per_row
                 else torch.ones(m, dtype=torch.int32, device=dev))
        dst = ri(0, n, (m,))
        valid = torch.rand(m, generator=gen, device=dev) < keep
        pend = ri(0, 4, (b, n))
        host_trace(f"fused_deposit_add[{name}]",
                   lambda: epidemic.deposit_local(  # noqa: B023
                       pend, dst, slots, valid, kernel="pallas"),  # noqa
                   lambda: None, calls)
        del slots, dst, valid, pend
    cfg, _ = parse_cli(PUSHSUM_ARGV)
    n, c, m = cfg.n, ps.mass_cols(cfg), ps.drain_chunk(cfg)
    slots, dst = ri(0, 1, (m,)), ri(0, n, (m,))
    vals = ri(0, 2**16, (m, c))
    acc0 = ri(0, 2**16, (1, n, c))
    acc = acc0.clone()
    host_trace("fused_deposit_rows[pushsum]",
               lambda: deliver.fused_deposit_rows(acc, slots, dst, vals),
               lambda: acc.copy_(acc0), calls)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--calls", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(f"card: {smi}", flush=True)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    ring_cases(dev, gen, args.calls)
    emit_cases(dev, gen, args.calls)
    deposit_cases(dev, gen, args.calls)
    return 0


if __name__ == "__main__":
    sys.exit(main())
