"""K1's GEMM (M >= 2) timed over every mode, the five 7B matmul shapes and a
list of M, one JSON line a row on stdout.

It times whatever `llamavk_tpu_torch` the interpreter imports, through the
public `ops.q4_matmul.q4_matmul_cuda`, so the same script run from two
checkouts times two versions of the kernel on one card, in one call:

    python -m llamavk_tpu_torch.tools.bench_gemm --out new.jsonl

Each row: the mode (layout, scale plane, dot, multiply), the shape, M, and
the median device time in ms (`tools/_common.Timer`: L2 flushed, the host's
enqueue hidden). Weights are random bytes and scales from a seed, x random
bf16. Without CUDA it refuses to start.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from ..ops import q4_matmul as q4
from ._common import Timer

SHAPES = {"wqkv": (4096, 12288), "wo": (4096, 4096), "w13": (4096, 22016),
          "w2": (11008, 4096), "output": (4096, 32000)}
MS = (2, 4, 8, 16, 32, 64, 353, 512, 1024)
# (layout, f32 scales, dot mode, multiply type): every numeric mode of K1
MODES = [(layout, f32s, dot, mul) for layout in ("ilv", "lin") for f32s in (False, True)
         for dot, mul in (("bf16", "f32"), ("f32", "f32"), ("bf16", "bf16"))
         if not (mul == "bf16" and not f32s)]


def mode_name(layout: str, f32s: bool, dot: str, mul: str) -> str:
    return " ".join(filter(None, [layout, "f32 scales" if f32s else "bf16 scales",
                                  "dot f32" if dot == "f32" else "",
                                  "mul bf16" if mul == "bf16" else ""]))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ms", default=",".join(map(str, MS)), help="comma-separated M values")
    ap.add_argument("--reps", type=int, default=10, help="timed launches a row")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", help="also append the rows to this file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_gemm times CUDA kernels and needs an NVIDIA GPU")
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    timer = Timer(args.reps)
    out = open(args.out, "a") if args.out else None
    for name, (k, n) in SHAPES.items():
        packed = torch.randint(-128, 128, (k // 2, n), dtype=torch.int8, device="cuda",
                               generator=gen)
        s32 = torch.empty((k // 32, n), device="cuda").uniform_(0.005, 0.02, generator=gen)
        for m in map(int, args.ms.split(",")):
            x = torch.randn((m, k), device="cuda", generator=gen).to(torch.bfloat16)
            for layout, f32s, dot, mul in MODES:
                scales = s32 if f32s else s32.to(torch.bfloat16)
                mul_t = torch.bfloat16 if mul == "bf16" else torch.float32
                ms = timer(lambda: q4.q4_matmul_cuda(x, packed, scales, layout, dot, mul_t))
                row = {"mode": mode_name(layout, f32s, dot, mul), "shape": name, "m": m,
                       "ms": ms}
                print(json.dumps(row), flush=True)
                if out:
                    out.write(json.dumps(row) + "\n")
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
