"""What the Hopper probes share: the device switch, the timer and the bound,
the TPU probes' activation order, and seeded weights.

A probe runs on the card by default and refuses to start without CUDA;
`--device cpu` runs the plain versions on small shapes and prints no times.
Times are CUDA-event medians of 20 launches, with a 100 MB write between
launches so every launch finds its operands in device memory (2x the 50 MB
L2), as `chip_smoke.py` times the kernels.
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import statistics
import sys

import torch

from ..ops import _build

QK = 32
# published peaks of one H100 SXM (NVIDIA's data sheet, dense, at 700 W)
HBM_BYTES_PER_S = 3.35e12
BF16_OP_PER_S = 989e12
INT8_OP_PER_S = 1979e12
# the shapes (K, N) of the TPU probes' matmuls (7B's w13 gate, w2, wqkv)
PROBE_SHAPES = [(4096, 11008), (11008, 4096), (4096, 12288)]
# the plain versions' shapes on the CPU
CPU_SHAPES = [(256, 256)]


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def parser(doc: str) -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=doc.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cuda (the kernels, timed) or cpu (the plain versions, small shapes)")
    ap.add_argument("--reps", type=int, default=20, help="timed launches per variant")
    return ap


def device_of(args) -> torch.device:
    """The probe's device; without CUDA only `--device cpu` runs."""
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("this probe times CUDA kernels and needs an NVIDIA GPU; "
                         "--device cpu runs the plain versions")
    return torch.device(args.device)


class Timer:
    """Median device time (ms) of a call over `reps` launches: CUDA events
    around each launch, and a write of 2x the L2 cache (100 MB) between
    launches so every call finds its inputs in device memory, as the main
    path does (each layer's weights and cache rows are read once per step).
    A spin of ~1 ms on the device before the first event keeps the device
    busy while the host enqueues the call, so the time is the device's, not
    the host's launch latency. `chip_smoke.py` times every kernel with it.

    `clean=True` empties the L2 by reading the 100 MB instead: the call
    still finds its inputs in device memory, but the lines it evicts are
    clean, as on the main path (the weights of the layers before), where
    the write leaves up to 50 MB of dirty lines that the call's reads must
    first write back."""

    SPIN_CYCLES = 2_000_000  # ~1 ms at the H100's 1.98 GHz boost clock

    def __init__(self, reps: int = 20, clean: bool = False):
        self.reps = reps
        self.clean = clean
        self.flush = torch.ones(100 * 2**20, dtype=torch.uint8, device="cuda")
        self.sink = torch.empty((), dtype=torch.int64, device="cuda")

    def __call__(self, fn, reps: int | None = None) -> float:
        fn()  # warm-up
        times = []
        for _ in range(reps or self.reps):
            if self.clean:
                torch.sum(self.flush, dim=0, out=self.sink)
            else:
                self.flush.zero_()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(self.SPIN_CYCLES)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        return statistics.median(times)


def bound(n_bytes: float, n_ops: float, peak: float = BF16_OP_PER_S) -> tuple[float, str]:
    """The least time on the card (ms) and what sets it: bytes over the
    memory rate, or operations over `peak`."""
    tb = n_bytes / HBM_BYTES_PER_S * 1e3
    tf = n_ops / peak * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def probe_order(x: torch.Tensor) -> torch.Tensor:
    """x [..., K] in original k order -> the TPU probes' activation order,
    which the ilv byte rows pair with: column m*G + g holds k = g*32 + m and
    column K/2 + m*G + g holds k = g*32 + m + 16 (the low and high nibbles
    of byte row m*G + g)."""
    k = x.shape[-1]
    g = k // QK
    xg = x.reshape(*x.shape[:-1], g, 2, QK // 2)  # [.., g, half, m]
    return xg.movedim(-3, -1).reshape(*x.shape[:-1], k)  # [.., half, m, g]


def random_q4(gen: torch.Generator, k: int, n: int, scale_dtype=torch.float32,
              layers: int | None = None, device="cuda"):
    """Seeded random ilv bytes [(L,) K/2, N] and scales [(L,) G, N] (drawn
    in [0.005, 0.02], then cast)."""
    lead = () if layers is None else (layers,)
    packed = torch.randint(-128, 128, (*lead, k // 2, n), dtype=torch.int8, device=device,
                           generator=gen)
    scales = torch.empty((*lead, k // QK, n), device=device).uniform_(0.005, 0.02, generator=gen)
    return packed, scales.to(scale_dtype)


def random_x(gen: torch.Generator, m: int, k: int, device="cuda") -> torch.Tensor:
    return torch.randn((m, k), device=device, generator=gen).to(torch.bfloat16)


def k1_limit(x: torch.Tensor, w: torch.Tensor) -> float:
    """K1's limit of a bf16-weight product against its plain version: both
    sum the same exact f32 products in different orders, each sum within
    (K - 1) 2^-24 sum_k |x_k w_kn| of the exact one; twice that, at the
    largest column."""
    k = x.shape[-1]
    return 2 * k * 2.0**-24 * float((x.float().abs() @ w.abs()).max())


@functools.cache
def lib(name: str, sigs: tuple) -> ctypes.CDLL:
    """`csrc/<name>.cu`'s library with (function, argument codes) bound:
    `p` a pointer or the stream, `i` an int, `f` a float; every function
    returns cudaGetLastError() as an int."""
    codes = {"p": ctypes.c_void_p, "i": ctypes.c_int, "f": ctypes.c_float}
    out = _build.load(name)
    for fn, args in sigs:
        getattr(out, fn).argtypes = [codes[c] for c in args]
        getattr(out, fn).restype = ctypes.c_int
    return out


def stream(t: torch.Tensor):
    return torch.cuda.current_stream(t.device).cuda_stream


def require_cuda(what: str, *tensors: torch.Tensor) -> None:
    """Every tensor on one CUDA device, contiguous and 16-byte aligned."""
    dev = tensors[0].device
    for t in tensors:
        if not t.is_cuda or t.device != dev:
            raise ValueError(f"{what}: every operand must be a CUDA tensor on one device")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{what}: operands must be contiguous and 16-byte aligned")


@functools.cache
def sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def ksplit(g: int, n: int, cols: int, index: int, gps_max: int) -> int:
    """K split of a column-blocked kernel: two blocks per SM, at least 16
    groups a split, and at most `gps_max` groups a split."""
    want = -(-2 * sm_count(index) // -(-n // cols))
    want = max(1, min(want, g // 16))
    return max(want, -(-g // gps_max))


def fmt_row(name: str, row: dict) -> str:
    """One variant's part of a printed line: its time and rate, or (CPU) ok."""
    if row.get("ms") is None:
        return f"{name} {'ok' if row['ok'] else 'MISMATCH'}"
    return f"{name} {row['ms'] * 1e3:7.1f}us {row['n_bytes'] / row['ms'] / 1e6:5.0f}GB/s"


def measure(kernel: str, variant: str, shape: str, run, plain, *, timer: Timer | None,
            n_bytes: float, n_ops: float, peak: float = BF16_OP_PER_S, limit=0.0,
            production=None, library=None, checks: dict | None = None) -> dict:
    """One variant at one shape: `run()` (the wrapper: the kernel on the
    card, the plain version on the CPU) against `plain()`, within `limit`
    (a number, or a tensor of one per element; 0: equal), and the named
    boolean `checks`; with a timer, the times of
    the kernel, the plain version, the production kernel (`production()`,
    the probe's baseline) and one PyTorch call (`library()`), and the
    bound. Returns the row `chip_smoke.py` reports."""
    got, want = run(), plain()
    diff = (got.float() - want.float()).abs()
    err = float(diff.max())
    if isinstance(limit, torch.Tensor):  # a limit per element
        ratio = float(torch.where(limit > 0, diff / limit.clamp_min(1e-30),
                                  (diff > 0).float() * 1e30).max())
        limit = float(limit.max())
    else:
        ratio = err / limit if limit else (0.0 if err == 0 else 1e30)
    ok = ratio <= 1.0
    row = {"kernel": kernel, "variant": variant, "shape": shape, "main_path": True,
           "max_abs_err": err, "limit": limit, "err_over_limit": ratio,
           "n_bytes": n_bytes, "ms": None, "plain_ms": None, "production_ms": None,
           "library_ms": None, "bound_ms": None, "bound_by": None}
    for name, passed in (checks or {}).items():
        row[name] = bool(passed)
        ok = ok and bool(passed)
    row["ok"] = ok
    if timer is not None:
        row["ms"] = timer(run)
        row["plain_ms"] = timer(plain, reps=3)
        row["bound_ms"], row["bound_by"] = bound(n_bytes, n_ops, peak)
        if production is not None:
            row["production_ms"] = timer(production)
        if library is not None:
            row["library_ms"] = timer(library)
    return row


def shape_line(head: str, rows: list[dict], production: str | None = None) -> str:
    """One printed line a shape: each variant's time and rate, then the
    production kernel's time."""
    parts = [head] + [fmt_row(r["variant"], r) for r in rows]
    prod = next((r["production_ms"] for r in rows if r.get("production_ms")), None)
    if production and prod is not None:
        parts.append(f"({production} {prod * 1e3:.1f}us)")
    return "  ".join(parts)
