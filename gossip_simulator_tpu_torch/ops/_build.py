"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` is a plain C interface compiled on its own with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o _build/lib<name>-<hash>.so csrc/<name>.cu

at first use, into the package's git-ignored ``_build/`` directory, and
loaded with ctypes.  The file name carries a hash of the source, the
shared headers (``csrc/*.cuh``) and the flags, so an edited source
rebuilds and a stale library is never loaded.
Nothing here runs at import: a CPU-only host never needs ``nvcc``.

The launch counters live here too: every wrapper adds one to its kernel's
count where it launches it, and nowhere else, so a run can show that its
path went through the kernels.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(os.path.dirname(_HERE), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")
KERNELS = ("fused_emit", "fused_unique_set", "fused_ring_append",
           "fused_chunk_step", "fused_negotiate", "fused_request_round",
           "fused_hosted_chunk", "fused_deposit_add", "fused_deposit_rows",
           "fused_deposit_both", "fused_drain_sum", "kout_pallas",
           "erdos_pallas", "fused_recv_land")
# Counts of one form of a kernel, beside the kernel's own count.
FORMS = ("fused_chunk_step:spill", "fused_deposit_add:dense",
         "fused_emit:pmask", "fused_emit:words", "fused_unique_set:words")

LAUNCHES: dict[str, int] = {name: 0 for name in KERNELS + FORMS}
_LIBS: dict[str, ctypes.CDLL] = {}
_FUNCS: dict = {}
_LOCK = threading.Lock()


def count_launch(name: str) -> None:
    LAUNCHES[name] += 1


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def nvcc_path() -> str:
    """The CUDA compiler, or a RuntimeError naming what is missing."""
    cands = [shutil.which("nvcc")]
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if root:
            cands.append(os.path.join(root, "bin", "nvcc"))
    for c in cands:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (PATH, CUDA_HOME, /usr/local/cuda): the CUDA "
        "kernels of gossip_simulator_tpu_torch are built on the machine "
        "with the card; run on the CPU with -device cpu")


def _target(name: str) -> tuple[str, str]:
    src = os.path.join(CSRC, f"{name}.cu")
    with open(src, "rb") as f:
        h = hashlib.sha256(f.read())
    for hdr in sorted(x for x in os.listdir(CSRC) if x.endswith(".cuh")):
        with open(os.path.join(CSRC, hdr), "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return src, os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def _start(name: str):
    """Start nvcc for `name` unless its library is already built; returns
    (process or None, temporary output, final output)."""
    src, out = _target(name)
    if os.path.exists(out):
        return None, None, out
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    proc = subprocess.Popen(
        [nvcc_path(), *NVCC_FLAGS, "-o", tmp, src],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, proc, tmp: str, out: str) -> None:
    if proc is None:
        return
    log, _ = proc.communicate()
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)


def build_all(names=KERNELS) -> None:
    """Compile every kernel source in parallel (one nvcc each, all started
    together) and wait for all of them."""
    with _LOCK:
        jobs = [(name, *_start(name)) for name in names]
        for job in jobs:
            _finish(*job)


def library(name: str) -> ctypes.CDLL:
    """The loaded shared library of kernel `name`, built on first use."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    with _LOCK:
        job = _start(name)
        _finish(name, *job)
        lib = ctypes.CDLL(job[2])
        _LIBS[name] = lib
    return lib


def function(name: str, symbol: str, argtypes):
    """The C entry point `symbol` of kernel `name`, typed once (argtypes
    given, cudaError_t result).  Each wrapper's argtypes are held to its C
    source's parameters by tests/test_torch_ops.py."""
    key = f"{name}:{symbol}"
    fn = _FUNCS.get(key)
    if fn is None:
        fn = getattr(library(name), symbol)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _FUNCS[key] = fn
    return fn


def check(rc: int, name: str) -> None:
    """Raise on a nonzero cudaError_t returned by a launch."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t "
                           f"{rc}")
