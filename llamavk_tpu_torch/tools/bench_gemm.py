"""K1's GEMM (M >= 2) timed over every mode, the five 7B matmul shapes and a
list of M, one JSON line a row on stdout.

It times whatever `llamavk_tpu_torch` the interpreter imports, through the
public `ops.q4_matmul.q4_matmul_cuda`, so the same script run from two
checkouts times two versions of the kernel on one card, in one call:

    python -m llamavk_tpu_torch.tools.bench_gemm --out new.jsonl
    python -m llamavk_tpu_torch.tools.bench_gemm --ms 1 --tp2 --tag parent --out x.jsonl
    python -m llamavk_tpu_torch.tools.bench_gemm --ms 1 --modes 0 --clean --floors

Each row: the mode (layout, scale plane, dot, multiply), the shape, M, and
the median device time in ms (`tools/_common.Timer`: L2 flushed, the host's
enqueue hidden), and `--tag`'s value as "tree" where given. `--tp2` adds,
in the default mode, one tp = 2 rank's shapes (`SHAPES_TP2`) and wo / w2
packed in 2 chunks (mode "... 2 chunks"). `--modes` takes indices into
`MODES` (0 is the default mode). `--clean` times with the L2 emptied by
reading, not writing (`Timer(clean=True)`). `--floors` first times, per
shape and under the same timer, two plain PyTorch calls: a one-element
fill (what the timer gives the least launch) and a float sum over the
packed bytes (a streaming read of the weight plane), with its GB/s.
Weights are random bytes and scales from a seed, x random bf16. Without
CUDA it refuses to start.
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
# the local shapes of the same matmuls on one rank of tp = 2: column-parallel
# N halved, row-parallel K halved
SHAPES_TP2 = {"wqkv/tp2": (4096, 6144), "wo/tp2": (2048, 4096), "w13/tp2": (4096, 11008),
              "w2/tp2": (5504, 4096), "output/tp2": (4096, 16000)}
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
    ap.add_argument("--tp2", action="store_true",
                    help="also the tp = 2 rank's shapes and wo / w2 in 2 chunks, default mode")
    ap.add_argument("--tag", help="a name of the tree timed, written into each row")
    ap.add_argument("--modes", help="comma-separated indices into MODES (default: all)")
    ap.add_argument("--clean", action="store_true",
                    help="empty the L2 by reading between launches, not by writing")
    ap.add_argument("--floors", action="store_true",
                    help="also time a one-element fill and a sum over the packed bytes")
    ap.add_argument("--out", help="also append the rows to this file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_gemm times CUDA kernels and needs an NVIDIA GPU")
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    timer = Timer(args.reps, clean=args.clean)
    out = open(args.out, "a") if args.out else None
    tag = ({"tree": args.tag} if args.tag else {}) | ({"flush": "read"} if args.clean else {})

    def emit(row: dict) -> None:
        print(json.dumps(tag | row), flush=True)
        if out:
            out.write(json.dumps(tag | row) + "\n")

    default = [("ilv", False, "bf16", "f32")]
    picked = [MODES[int(i)] for i in args.modes.split(",")] if args.modes else MODES
    # (shape name, (K, N), modes, chunks)
    cases = [(name, kn, picked, 1) for name, kn in SHAPES.items()]
    if args.tp2:
        cases += [(name, kn, default, 1) for name, kn in SHAPES_TP2.items()]
        cases += [(name, SHAPES[name], default, 2) for name in ("wo", "w2")]
    for name, (k, n), modes, chunks in cases:
        packed = torch.randint(-128, 128, (k // 2, n), dtype=torch.int8, device="cuda",
                               generator=gen)
        s32 = torch.empty((k // 32, n), device="cuda").uniform_(0.005, 0.02, generator=gen)
        if args.floors and chunks == 1 and name in SHAPES:
            one = torch.empty(1, device="cuda")
            emit({"floor": "fill_one", "shape": name, "ms": timer(one.zero_)})
            ms = timer(packed.view(torch.float32).sum)
            emit({"floor": "sum_packed", "shape": name, "ms": ms,
                  "gb_per_s": packed.numel() / ms / 1e6})
        for m in map(int, args.ms.split(",")):
            x = torch.randn((m, k), device="cuda", generator=gen).to(torch.bfloat16)
            for layout, f32s, dot, mul in modes:
                scales = s32 if f32s else s32.to(torch.bfloat16)
                mul_t = torch.bfloat16 if mul == "bf16" else torch.float32
                ms = timer(lambda: q4.q4_matmul_cuda(x, packed, scales, layout, dot, mul_t,
                                                     chunks))
                mode = mode_name(layout, f32s, dot, mul) + (f" {chunks} chunks" if chunks > 1
                                                            else "")
                emit({"mode": mode, "shape": name, "m": m, "ms": ms})
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
