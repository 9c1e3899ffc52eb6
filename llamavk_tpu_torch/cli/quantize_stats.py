"""Quantization error statistics (twin of `llamavk_tpu/cli/quantize_stats.py`,
examples/quantize-stats, quantize-stats.cpp:136-341).

Round-trips every 2-D weight tensor of an f16/f32 model through the Q4_0 or
Q4_1 codec and reports per-layer and total RMSE, max error, and the error
quantiles, with regex include/exclude layer filters: the NumPy codec against
the scalar definition of the format, and each weight round-tripped through
the port's packed layout and `dequantize_qweight` on the device: the card by
default (a bare --device, the JAX CLI's flag, names it too), or the CPU with
--device cpu.

    python -m llamavk_tpu_torch.cli.quantize_stats -m model-f32.bin -t 2
    python -m llamavk_tpu_torch.cli.quantize_stats -m model-f32.bin --device cpu
"""

from __future__ import annotations

import argparse
import re
import sys

import numpy as np
import torch

from ..device import resolve
from ..formats.ggml_io import CheckpointReader
from ..formats.q4 import (
    GGML_FTYPE_Q4_0,
    dequantize_q4_0,
    dequantize_q4_1,
    quantize_q4_0,
    quantize_q4_1,
)
from ..formats.repack import repack_q4_0, repack_q4_1
from ..ops.qweight import dequantize_qweight, qweight_from_packed


def error_stats(x: np.ndarray, y: np.ndarray) -> dict:
    err = np.abs(x - y).reshape(-1)
    return {
        "rmse": float(np.sqrt(np.mean((x - y) ** 2))),
        "maxerr": float(err.max()),
        "p95": float(np.quantile(err, 0.95)),
        "median": float(np.quantile(err, 0.5)),
    }


def run_stats(
    path: str,
    ftype: int = GGML_FTYPE_Q4_0,
    include: list[str] | None = None,
    exclude: list[str] | None = None,
    per_layer: bool = True,
    device: str | None = "cuda",
    out=None,
) -> dict:
    """Per-tensor and total statistics, printed to `out` (default stdout).
    `device` ("cuda" or "cpu") round-trips through the packed layout on that
    device; None skips the round trip (the codec against its definition
    only)."""
    out = out or sys.stdout
    if device is not None:
        device = resolve(device)
    r = CheckpointReader(path)
    total_sq = total_n = 0.0
    total_max = 0.0
    results = {}
    for name, t in r.tensors.items():
        if len(t.ne) != 2 or not name.endswith("weight"):
            continue
        # regex search, matching the reference's layer_included
        # (quantize-stats.cpp:70-80: exclude wins, include defaults all)
        if exclude and any(re.search(p, name) for p in exclude):
            continue
        if include and not any(re.search(p, name) for p in include):
            continue
        x = r.load_f32(name)
        if ftype == GGML_FTYPE_Q4_0:
            d, q = quantize_q4_0(x)
            y = dequantize_q4_0(d, q).reshape(x.shape)
        else:
            d, m, q = quantize_q4_1(x)
            y = dequantize_q4_1(d, m, q).reshape(x.shape)
        if device is not None:
            # round-trip through the device packed layout and its dequant
            pk = repack_q4_0(d, q) if ftype == GGML_FTYPE_Q4_0 else repack_q4_1(d, m, q)
            qw = qweight_from_packed(pk, scale_dtype=torch.float32, device=device)
            y = dequantize_qweight(qw).cpu().numpy().T.reshape(x.shape)
        st = error_stats(x, y)
        results[name] = st
        total_sq += float(np.sum((x - y) ** 2))
        total_n += x.size
        total_max = max(total_max, st["maxerr"])
        if per_layer:
            print(
                f"{name:>48}  rmse {st['rmse']:.6f}  max {st['maxerr']:.6f}"
                f"  p95 {st['p95']:.6f}",
                file=out,
            )
    overall = {"rmse": float(np.sqrt(total_sq / max(total_n, 1))), "maxerr": total_max}
    print(f"{'TOTAL':>48}  rmse {overall['rmse']:.6f}  max {overall['maxerr']:.6f}", file=out)
    results["__total__"] = overall
    return results


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("-m", "--model", required=True)
    ap.add_argument("-t", "--type", type=int, default=2, help="2=q4_0, 3=q4_1")
    ap.add_argument("-l", "--include-layer", action="append", default=None)
    ap.add_argument("-L", "--exclude-layer", action="append", default=None)
    ap.add_argument("--device", nargs="?", const="cuda", default="cuda",
                    choices=["cuda", "cpu"],
                    help="the device of the packed-layout round trip (default cuda; a bare "
                    "--device, the JAX CLI's flag, also means cuda)")
    return ap


def main(argv=None):
    args = build_argparser().parse_args(argv)
    run_stats(args.model, args.type, args.include_layer, args.exclude_layer,
              device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
