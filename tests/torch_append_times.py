"""Device and call times of the three single-pass appends at the main
paths' shapes, on the card: fused_ring_append at the overlay's chunk
(262,144 lanes, two flat rings, dw 3), fused_emit at the kout run's
sender batch (131,072 senders, 6 lanes, dw 3) and fused_recv_land at
sharded_10m's batch (8 x 25,831 lanes, dw 3), through the wrappers'
public calls only, so the same script reads a parent tree too: copy it
into that tree's tests/ and run it there and here in turns (parent,
this, this, parent) in one call of the card, e.g.

    python3 tests/torch_append_times.py --label this

Each case prints its device ms per call (torch.profiler, the state
restored before each call and the restore's own kernels taken off) and
its call ms (CUDA events, median of 25), beside the card's name and
power limit."""

import argparse
import os
import statistics
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke as cs  # noqa: E402

CALLS = 20  # profiled calls a case


def device_ms(fn, setup) -> float:
    """Device ms per call of fn() (setup() before each, its own kernels
    taken off)."""
    split, _ = cs._profile_split(lambda: (setup(), fn()), CALLS)
    own, _ = cs._profile_split(setup, CALLS)
    return sum(split.values()) - sum(own.values())


def cases(dev, gen):
    """(name, call, restore) of each case, inputs made from `gen`."""
    from gossip_simulator_tpu_torch.config import Config
    from gossip_simulator_tpu_torch.models import overlay_ticks as ot
    from gossip_simulator_tpu_torch.ops import deliver, megakernel

    i32 = dict(dtype=torch.int32, device=dev)
    cfg = Config(n=cs.FULL_N).validate()
    dw, cap, m = ot.ring_windows(cfg), ot.slot_cap(cfg), ot.emit_chunk(cfg)
    rings = [torch.randint(0, 2**30, (dw * cap + 1,), generator=gen, **i32)
             for _ in range(2)]
    cnt0 = torch.randint(0, cap // 2, (1, dw), generator=gen, **i32)
    cnt, dropped = cnt0.clone(), torch.zeros((), **i32)
    pays = (torch.randint(0, cfg.n, (m,), generator=gen, **i32),
            torch.randint(0, 2**30, (m,), generator=gen, **i32))
    wslot = torch.randint(0, dw, (m,), generator=gen, **i32)
    valid = torch.rand(m, generator=gen, device=dev) < 0.9
    yield ("fused_ring_append[main]",
           lambda: deliver.fused_ring_append(rings, cnt, dropped, pays,
                                             wslot, valid, dw, cap),
           lambda: (cnt.copy_(cnt0), dropped.zero_()))
    kcfg = Config(n=cs.FULL_N, fanout=6, graph="kout").validate()
    n, k, b, edw, ecap, em, ring_len = cs.emit_shapes(kcfg, 6)
    case, kw = cs.emit_case(gen, dev, n, em, k, edw, ecap, b, ring_len,
                            dup=False, sir=False, base_hi=ecap // 2)
    ring = case.pop("mail_ids")
    args = [case[x] for x in ("mail_cnt", "sf", "drop", "svalid", "wslot",
                              "off")]
    yield ("fused_emit[si]",
           lambda: megakernel.fused_emit(ring, *args, **kw), lambda: None)
    ev = cs.recv_shapes(cs.sharded_argv(cs.SHARDED_N), cs.SHARDS)
    recv, _ = cs._wire(gen, dev, cs.SHARDS, ev["rcap"], ev["fill"],
                       ev["n_local"], ev["dw"], ev["b"])
    rring = torch.zeros(ev["length"], **i32)
    rcnt0 = torch.randint(ev["cap"] // 4, ev["cap"] // 2, (1, ev["dw"]),
                          generator=gen, **i32)
    rcnt, rdrop = rcnt0.clone(), torch.zeros((), **i32)
    yield ("fused_recv_land[event]",
           lambda: megakernel.fused_recv_land(rring, rcnt, rdrop, recv,
                                              dw=ev["dw"], cap=ev["cap"],
                                              b=ev["b"]),
           lambda: (rcnt.copy_(rcnt0), rdrop.zero_()))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--label", default="this",
                    help="the tree's name on every printed line")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_append_times: needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    print(f"card: {cs.smi_line()}", flush=True)
    for name, call, restore in cases(dev, gen):
        for _ in range(3):  # warm-up: builds, workspaces
            restore()
            call()
        torch.cuda.synchronize()
        dms = [device_ms(call, restore) for _ in range(3)]
        call_ms = cs.time_ms(call, cs.REPS, restore)
        print(f"times {args.label} {name}: device "
              f"{statistics.median(dms):.5f} ms per call (runs "
              f"{', '.join(f'{x:.5f}' for x in dms)}), call "
              f"{call_ms:.4f} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
