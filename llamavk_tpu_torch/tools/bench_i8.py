"""K5 (the int8 dot, `LLAMAVK_Q4_DOT=i8`) timed over its modes, the five 7B
matmul shapes and M = 1 ... 64, one JSON line a row on stdout.

It times whatever `llamavk_tpu_torch` the interpreter imports, through the
public `ops.q4_matmul.q4_matmul_i8_cuda` (the activation quantization, the
group dot and the split sum), so the same script run from two checkouts
times two versions of the kernel on one card, in one call:

    python -m llamavk_tpu_torch.tools.bench_i8 --out runs.jsonl --tag change

Each row: the tag (which tree ran), the scale plane (bf16, or f32 as
`perplexity --f32` loads it), the shape, M, whether the route takes K5
there (`i8_route`: w2 past 16 rows takes K1, but the kernel is timed all
the same), and the median device time in ms (`tools/_common.Timer`: L2
flushed, the host's enqueue hidden). Weights are random bytes and scales
from a seed, x random bf16. Without CUDA it refuses to start.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from ..ops import q4_matmul as q4
from ..ops.qweight import QWeight
from ._common import Timer
from .bench_gemm import SHAPES

MS = (1, 2, 4, 8, 16, 32, 64)
MODES = ("bf16 scales", "f32 scales")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ms", default=",".join(map(str, MS)), help="comma-separated M values")
    ap.add_argument("--reps", type=int, default=10, help="timed launches a row")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", help="also append the rows to this file")
    ap.add_argument("--tag", default="", help="a name for the tree timed, written in each row")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_i8 times CUDA kernels and needs an NVIDIA GPU")
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    timer = Timer(args.reps)
    out = open(args.out, "a") if args.out else None
    for name, (k, n) in SHAPES.items():
        packed = torch.randint(-128, 128, (k // 2, n), dtype=torch.int8, device="cuda",
                               generator=gen)
        s32 = torch.empty((k // 32, n), device="cuda").uniform_(0.005, 0.02, generator=gen)
        planes = {"bf16 scales": s32.to(torch.bfloat16), "f32 scales": s32}
        for m in map(int, args.ms.split(",")):
            x = torch.randn((m, k), device="cuda", generator=gen).to(torch.bfloat16)
            for mode in MODES:
                scales = planes[mode]
                ms = timer(lambda: q4.q4_matmul_i8_cuda(x, packed, scales))
                row = {"tree": args.tag, "mode": mode, "shape": name, "m": m,
                       "k5_route": q4.i8_route("i8", m, k, n, QWeight(packed=packed,
                                                                     scales=scales)),
                       "ms": ms}
                print(json.dumps(row), flush=True)
                if out:
                    out.write(json.dumps(row) + "\n")
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
