"""Where one fused_emit call spends its device time, stage by stage: the
kernel is built again (under a temporary directory) with a return after
each stage, and each cut-short copy is profiled at the parity shapes.

    python3 tests/torch_emit_stages.py [--calls 5]

Needs a CUDA card and nvcc; run it from the repository root.  Stages, in
the order of csrc/fused_emit.cu: 1 the launch and the ticket, 2 the masks
and counts, 3 the weighted ranks, 4 the look-back, 5 the starts and
verdicts, 6 the ring stores, 7 the last block's settlement (the whole
kernel).  A line a case and form: the device ms per call (torch.profiler)
of each cut-short copy, so the differences between neighbours are the
stages' times.  A cut-short copy leaves the ticket counter set, so each
call starts on a zeroed workspace head (its own small kernel, not
counted)."""

import argparse
import ctypes
import os
import shutil
import subprocess
import sys
import tempfile

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402
from gossip_simulator_tpu_torch.config import Config  # noqa: E402
from gossip_simulator_tpu_torch.ops import _build, deliver, megakernel  # noqa: E402

# (stage, the source line the return goes before)
CUTS = ((1, "  // Masks and counts: G threads a row"),
        (2, "  // Weighted ranks, a thread a row"),
        (3, "  lookback::look_back(ws, blk, dw, epoch, sl);"),
        (4, "  // Starts and verdicts:"),
        (5, "  // Ring stores: a kept lane of an okr row"),
        (6, "  // The last block to finish:"))


def build(stop: int, tmp: str):
    """The kernel's C entry point, cut short after stage `stop` (7: whole)."""
    d = os.path.join(tmp, f"stop{stop}")
    os.makedirs(d)
    for f in os.listdir(_build.CSRC):
        shutil.copy(os.path.join(_build.CSRC, f), d)
    path = os.path.join(d, "fused_emit.cu")
    src = open(path).read()
    for sid, line in CUTS:
        if line not in src:
            raise SystemExit(f"csrc/fused_emit.cu has no line {line!r}")
        src = src.replace(line, f"  if (STOP == {sid}) return;\n{line}", 1)
    open(path, "w").write(src)
    so = os.path.join(d, "lib.so")
    subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, f"-DSTOP={stop}",
                    "-o", so, path], check=True)
    fn = ctypes.CDLL(so).gossip_fused_emit
    fn.argtypes = megakernel._ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--calls", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    print(f"card: {cs.smi_line()}", flush=True)
    dev = torch.device("cuda", 0)
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
    out = torch.empty(2 * deliver.RING_SLOTS_MAX + 1, dtype=torch.int32,
                      device=dev)
    stream = deliver._stream(dev.index)
    epoch = [0]
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    with tempfile.TemporaryDirectory() as tmp:
        fns = {stop: build(stop, tmp) for stop in range(1, 8)}
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
                        rc = fn(*(t.data_ptr() for t in a),
                                ptr(kw.get("flags")), 1,
                                ptr(kw.get("strig")),
                                ptr(kw.get("sender_ids")),
                                kw.get("tb") or 0, rows, cols, kw["dw"],
                                kw["cap"], kw["b"], group, out.data_ptr(),
                                ws.data_ptr(), ws.numel(), epoch[0], stream)
                        if rc:
                            raise RuntimeError(f"cudaError_t {rc}")
                    call()
                    split, _ = cs._profile_split(call, args.calls)
                    line.append(f"{stop} {split.get('emit', 0.0):.4f}")
                print(f"stages fused_emit[{name}], {group} a row: "
                      + ", ".join(line) + " ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
