"""Build and bind the hand-written CUDA kernels of `llamavk_tpu_torch/csrc/`.

Each `csrc/<name>.cu` compiles with nvcc, for Hopper (`sm_90a`), into its own
shared library with a plain C interface, bound with ctypes (every pointer and
the stream as `c_void_p`). Building with PyTorch's headers
(`torch.utils.cpp_extension.load`) takes minutes per source; a plain C
interface takes seconds, and the sources build in parallel (`build_all`).

Libraries land in `build/llamavk_tpu_torch/` at the repository root, named by
a hash of the source and the flags, so an unchanged source is not rebuilt.
Nothing is built at import: the first kernel launch, or `build_all`, builds.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "llamavk_tpu_torch"
# --split-compile=0 spreads one source's device-code optimisation over every
# core (flash_attn.cu's 32 kernels built in 19 s alone, 10 s split, on the
# card's 8-core host)
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v", "--split-compile=0",
]
SOURCES = ("q4_matmul", "q4_matmul_i8", "flash_attn", "flash_decode", "probe_q4_unpack",
           "probe_q4_i8", "probe_prefill_direct")

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()
# CUDA kernels launched by replays of captured CUDA graphs, by library: a
# replay calls no C launcher, so a library's own counter (one per `<<<>>>`
# its launchers ran) misses them; `runtime/graphs.py` adds each replay's
# share here, and each module's `cuda_launches()` adds it to its counter
replayed: collections.Counter = collections.Counter()


def nvcc_path() -> str:
    """nvcc from the CUDA toolkit PyTorch found (CUDA_HOME), else PATH."""
    from torch.utils.cpp_extension import CUDA_HOME

    cand = os.path.join(CUDA_HOME, "bin", "nvcc") if CUDA_HOME else None
    if cand and os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return found


def _lib_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    common = b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    h = hashlib.sha256(src + common + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{h}.so"


def _start(name: str) -> tuple[subprocess.Popen, Path, Path] | None:
    """Start nvcc for `name` unless its library is built; returns the process,
    the temporary output and the final path."""
    out = _lib_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    log = open(out.with_suffix(".log"), "w")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT)
    log.close()
    return proc, tmp, out


def _finish(name: str, job) -> None:
    if job is None:
        return
    proc, tmp, out = job
    rc = proc.wait()
    if rc != 0:
        log = out.with_suffix(".log").read_text()
        raise RuntimeError(f"nvcc failed for {name}.cu (exit {rc}):\n{log[-4000:]}")
    os.replace(tmp, out)  # atomic: a concurrent builder sees all or nothing


def build_all() -> dict[str, str]:
    """Build every source, one nvcc each, all started together. Returns the
    compiler's resource report (-Xptxas -v) per source."""
    with _lock:
        jobs = {name: _start(name) for name in SOURCES}
        for name, job in jobs.items():
            _finish(name, job)
    return {
        name: _lib_path(name).with_suffix(".log").read_text()
        if _lib_path(name).with_suffix(".log").exists() else ""
        for name in SOURCES
    }


def load(name: str) -> ctypes.CDLL:
    """The built library for `csrc/<name>.cu`, building it on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            _finish(name, _start(name))
            lib = ctypes.CDLL(str(_lib_path(name)))
            _libs[name] = lib
        return lib


def refuse_while_capturing(device, what: str) -> None:
    """Raise where per-device state (`what`) would be made or grown while
    the device's current stream captures a CUDA graph: allocated there, it
    would come from the graph's private pool, its zeroing would not run
    until a replay, and eager launches would share it. A step run once
    uncaptured before the capture makes it."""
    if torch.device(device).type == "cuda" and torch.cuda.is_current_stream_capturing():
        raise RuntimeError(f"{what} must exist before a CUDA graph capture: run the step "
                           "once uncaptured first")


def check(rc: int, what: str) -> None:
    """Raise when a C launcher returned a non-zero cudaGetLastError()."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")
