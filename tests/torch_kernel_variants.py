"""Build variants of the port's kernels, profiled on the card: a kernel's
source is built again (under a temporary directory) with -D overrides of
its swept constants, or cut short at each of its ``// STAGE n`` marks, and
each copy is profiled at a full-size path's shape.

    python3 tests/torch_kernel_variants.py [--only deposit,erdos,emit]
                                           [--calls 5]

Needs a CUDA card and nvcc; run it from the repository root.  Lines:

- ``sweep fused_deposit_add[rounds] <variant> bits B``: the dense form at
  ring_rounds10m's rounds deposit (6e7 lanes, 35 % valid, all into one
  slot of a 2 x 1e7 ring), device ms per call (torch.profiler) in all and
  by kernel, at partitions of 2^14 and 2^15 cells, for listing blocks of
  LIST_THREADS threads reading ROUNDS four-lane groups each, at
  LIST_MIN_BLOCKS blocks an SM (the register budget), and APPLY_THREADS;
  ``equal`` holds the result to deposit_add_plain.
- ``stages fused_deposit_add[rounds] part_list``: the listing pass cut
  short after each stage (1 the loads and keys, 2 the per-partition
  counts, 3 their scan, 4 the staging, 5 the bucket claims, 6 the runs out:
  the whole pass), cumulative, so the differences between neighbours are
  the stages' times; the first two keep the keys live through a sink that
  never stores.
- ``sweep erdos_pallas[lam L] <variant>``: at 1e7 rows lam 8 and 1e6 rows
  lam 60, blocks an SM the register budget keeps room for (MIN_BLOCKS) and
  the output tile (TILE_BYTES); ``equal`` holds the result to the
  package's own build.
- ``stages fused_emit[case], G a row``: fused_emit cut short after each
  stage (1 the launch and the ticket, 2 the masks and counts, 3 the
  weighted ranks, 4 the look-back, 5 the starts and verdicts, 6 the ring
  stores, 7 the last block's settlement: the whole kernel) at the main
  path's shape (si) and kw 112, 1 and 8 threads a sender row.  A
  cut-short copy leaves the ticket counter set, so each call starts on a
  zeroed workspace head (its own small kernel, not counted)."""

import argparse
import ctypes
import os
import re
import shutil
import subprocess
import sys
import tempfile

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402
from gossip_simulator_tpu_torch.config import Config, er_cap  # noqa: E402
from gossip_simulator_tpu_torch.models import graphs  # noqa: E402
from gossip_simulator_tpu_torch.ops import (  # noqa: E402
    _build, deliver, graph, megakernel)

# name: -D flags (the shipped build first).
DEPOSIT_SWEEP = {
    "512x4 m2 (shipped)": [],
    "512x4 m1": ["-DLIST_MIN_BLOCKS=1"],
    "512x6 m1": ["-DROUNDS=6", "-DLIST_MIN_BLOCKS=1"],
    "512x8 m1": ["-DROUNDS=8", "-DLIST_MIN_BLOCKS=1"],
    "1024x2 m1": ["-DLIST_THREADS=1024", "-DROUNDS=2",
                  "-DLIST_MIN_BLOCKS=1"],
    "1024x4 m1": ["-DLIST_THREADS=1024", "-DLIST_MIN_BLOCKS=1"],
    "256x2 m6": ["-DLIST_THREADS=256", "-DROUNDS=2", "-DLIST_MIN_BLOCKS=6"],
    "256x4 m3": ["-DLIST_THREADS=256", "-DLIST_MIN_BLOCKS=3"],
    "256x8 m2": ["-DLIST_THREADS=256", "-DROUNDS=8"],
    "128x8 m4": ["-DLIST_THREADS=128", "-DROUNDS=8", "-DLIST_MIN_BLOCKS=4"],
    "apply 256": ["-DAPPLY_THREADS=256"],
}
ERDOS_SWEEP = {
    "minb6 (shipped)": [],
    "minb1": ["-DMIN_BLOCKS=1"],
    "minb4": ["-DMIN_BLOCKS=4"],
    "minb8": ["-DMIN_BLOCKS=8"],
    "tile16k minb6": ["-DTILE_BYTES=16384"],
}
# What a cut-short listing pass keeps live at its first two stages.
SINK = ("{ int a = 0; for (int r = 0; r < LIST_ITEMS; ++r) a += key[r]%s; "
        "if (a == 0x7fffffff) cursor[PART_MAX] = a; return; }")
DEPOSIT_CUTS = {1: SINK % "", 2: SINK % " + rank[r]"}
STAGE = re.compile(r"^( *)// STAGE (\d+)$", re.M)


def build_all(name: str, entry: str, argtypes, variants: dict, tmp: str,
              cuts: dict | None = None) -> dict:
    """{variant: C entry point} of csrc/<name>.cu, built in parallel; with
    `cuts` ({stage: statement}, "return;" by default), a copy of the source
    that runs the statement at its STAGE n mark when STOP == n, each
    variant's flags then naming its STOP."""
    src_dir = os.path.join(tmp, name)
    if not os.path.isdir(src_dir):
        shutil.copytree(_build.CSRC, src_dir)
    path = os.path.join(src_dir, f"{name}.cu")
    if cuts is not None:
        with open(path) as f:
            src = f.read()
        if not STAGE.search(src):
            raise SystemExit(f"csrc/{name}.cu has no STAGE mark")
        src = STAGE.sub(lambda mt: (
            f"{mt[1]}if (STOP == {mt[2]}) "
            f"{cuts.get(int(mt[2]), 'return;')}\n{mt[0]}"), src)
        path = os.path.join(src_dir, f"{name}_stages.cu")
        with open(path, "w") as f:
            f.write(src)
    procs = {}
    for i, (var, flags) in enumerate(variants.items()):
        so = os.path.join(tmp, f"{name}-{cuts is not None}-{i}.so")
        procs[var] = (so, subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, *flags, "-o", so, path],
            stderr=subprocess.PIPE, text=True))
    fns = {}
    for var, (so, p) in procs.items():
        _, err = p.communicate()
        if p.returncode:
            raise SystemExit(f"nvcc {name} {var}: {err}")
        fn = getattr(ctypes.CDLL(so), entry)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        fns[var] = fn
    return fns


def checked(rc: int) -> None:
    if rc:
        raise RuntimeError(f"cudaError_t {rc}")


def deposit(dev, tmp: str, calls: int) -> None:
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    b, n = 2, cs.RING_N
    m = n * 6
    slots = torch.ones(m, dtype=torch.int32, device=dev)
    dst = torch.randint(0, n, (m,), generator=gen, device=dev,
                        dtype=torch.int32)
    valid = torch.rand(m, generator=gen, device=dev) < 0.35
    want = deliver.deposit_add_plain(
        torch.zeros((b, n), dtype=torch.int32, device=dev), slots, dst,
        valid)
    pend = torch.zeros((b, n), dtype=torch.int32, device=dev)
    stream = deliver._stream(dev.index)
    args = deliver.DEPOSIT_ARGTYPES
    sweep = build_all("fused_deposit_add", "gossip_fused_deposit_add", args,
                      DEPOSIT_SWEEP, tmp)
    stages = build_all("fused_deposit_add", "gossip_fused_deposit_add", args,
                       {s: [f"-DSTOP={s}"] for s in range(1, 7)}, tmp,
                       DEPOSIT_CUTS)

    def caller(fn, bits, ws, bucket, bcap):
        return lambda: checked(fn(
            pend.data_ptr(), slots.data_ptr(), dst.data_ptr(),
            valid.data_ptr(), m, b, n, bits, ws.data_ptr(), bucket.data_ptr(),
            bcap, stream))

    for bits in (14, 15):
        parts = (b * n + (1 << bits) - 1) >> bits
        bcap = deliver.deposit_bucket_cap(m, parts)
        ws, bucket = deliver.deposit_workspace(dev, stream, parts * bcap)
        for var, fn in sweep.items():
            call = caller(fn, bits, ws, bucket, bcap)
            pend.zero_()
            call()
            same = torch.equal(pend, want)
            split, _ = cs._profile_split(call, calls)
            print(f"sweep fused_deposit_add[rounds] {var} bits {bits}: "
                  f"{sum(split.values()):.4f} ms ("
                  + ", ".join(f"{k} {v:.4f}" for k, v in split.items())
                  + f"); equal {same}", flush=True)
    bits = deliver.deposit_part_bits(m, b * n)
    parts = (b * n + (1 << bits) - 1) >> bits
    bcap = deliver.deposit_bucket_cap(m, parts)
    ws, bucket = deliver.deposit_workspace(dev, stream, parts * bcap)
    bucket.zero_()  # a cut-short copy leaves offsets unwritten
    line, apply_ms = [], 0.0
    for stop, fn in stages.items():
        call = caller(fn, bits, ws, bucket, bcap)
        call()
        split, _ = cs._profile_split(call, calls)
        line.append(f"{stop} {split.get('part_list', 0.0):.4f}")
        apply_ms = split.get("part_apply", 0.0)
    print(f"stages fused_deposit_add[rounds] bits {bits} part_list: "
          + ", ".join(line) + f" ms; part_apply {apply_ms:.4f} ms",
          flush=True)


def erdos(dev, tmp: str, calls: int) -> None:
    fns = build_all("erdos_pallas", "gossip_erdos_pallas",
                    graph.ERDOS_ARGTYPES, ERDOS_SWEEP, tmp)
    key = graphs.graph_key(Config(seed=0), dev)
    stream = deliver._stream(dev.index)
    part = int(graph._rng.partitionable())
    for n, lam in ((10_000_000, 8.0), (1_000_000, 60.0)):
        want = graph.erdos_pallas(n, lam, 0, n, key)
        cap = er_cap(lam)
        cdf = graph.erdos_cdf_param(lam, cap)
        f = torch.empty((n, cap), dtype=torch.int32, device=dev)
        d = torch.empty(n, dtype=torch.int32, device=dev)
        for var, fn in fns.items():
            def call():
                checked(fn(f.data_ptr(), d.data_ptr(), key.data_ptr(), cdf,
                           n, cap, 0, n, part, stream))
            f.fill_(7)
            call()
            same = torch.equal(f, want[0]) and torch.equal(d, want[1])
            split, _ = cs._profile_split(call, calls)
            print(f"sweep erdos_pallas[lam {lam:g}, {n} rows] {var}: "
                  f"{sum(split.values()):.4f} ms; equal {same}", flush=True)
        del f, d, want
        torch.cuda.empty_cache()


def emit(dev, tmp: str, calls: int) -> None:
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    cfg = Config(n=cs.FULL_N, fanout=6, graph="kout").validate()
    n, k, b, dw, cap, m, ring_len = cs.emit_shapes(cfg, 6)
    cases = {
        "si": cs.emit_case(gen, dev, n, m, k, dw, cap, b, ring_len,
                           dup=False, sir=False, base_hi=cap // 2),
        "kw112": cs.emit_case(gen, dev, n, m, 111, 3, 3_000_000, 10,
                              3 * 3_000_000 + m * 112, dup=False, sir=True,
                              base_hi=1_500_000, cnt_lo=30)}
    ws = torch.zeros(1 << 20, dtype=torch.int64, device=dev)
    out = torch.empty(2 * deliver.RING_SLOTS_MAX + 2, dtype=torch.int32,
                      device=dev)
    stream = deliver._stream(dev.index)
    epoch = [0]
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    fns = build_all("fused_emit", "gossip_fused_emit", megakernel._ARGTYPES,
                    {s: [f"-DSTOP={s}"] for s in range(1, 8)}, tmp, {})
    for name, (case, kw) in cases.items():
        a = [case[x] for x in ("mail_ids", "mail_cnt", "sf", "drop",
                               "svalid", "wslot", "off")]
        rows, cols = a[2].shape
        for group in (1, 8):
            line = []
            for stop, fn in fns.items():
                def call():
                    ws[:deliver.APPEND_WS_HEAD].zero_()
                    epoch[0] += 1
                    checked(fn(*(t.data_ptr() for t in a),
                               ptr(kw.get("flags")), 1,
                               ptr(kw.get("strig")),
                               ptr(kw.get("sender_ids")), None, None,
                               None, kw.get("tb") or 0, rows, cols,
                               kw["dw"], kw["cap"], kw["b"], 0, group,
                               out.data_ptr(),
                               ws.data_ptr(), ws.numel(), epoch[0], None, 0,
                               stream))
                call()
                split, _ = cs._profile_split(call, calls)
                line.append(f"{stop} {split.get('emit', 0.0):.4f}")
            print(f"stages fused_emit[{name}], {group} a row: "
                  + ", ".join(line) + " ms", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", default="deposit,erdos,emit")
    ap.add_argument("--calls", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_kernel_variants: needs a CUDA card", file=sys.stderr)
        return 1
    print(f"card: {cs.smi_line()}", flush=True)
    dev = torch.device("cuda", 0)
    with tempfile.TemporaryDirectory() as tmp:
        for part in args.only.split(","):
            {"deposit": deposit, "erdos": erdos, "emit": emit}[part](
                dev, tmp, args.calls)
    return 0


if __name__ == "__main__":
    sys.exit(main())
