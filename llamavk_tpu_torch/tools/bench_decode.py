"""Decode attention (T = 1) timed over its main-path shapes: K2 (the fused
update, `ops.flash_attn.flash_attention_update`) and K4 (the batched decode,
`ops.flash_decode.flash_decode_update`), one JSON line a row on stdout.

It times whatever `llamavk_tpu_torch` the interpreter imports, through the
public wrappers (a K2 call is its every launch: the row write and the
attention), so the same script run from two checkouts times two versions
of the kernels on one card, in one call:

    python -m llamavk_tpu_torch.tools.bench_decode --out runs.jsonl --tag change

Rows, at LLaMA-7B's width (H 32, D 128, a 512-row cache, block_k 256):
K2 at B = 1 and n_past 37, 160, 300, 480, 511 over bf16, int8 and f32
caches, and over a 512-row bf16 history ring (32 pinned rows) at logical
n_past 700, after its wrap; K4 at B = 8 and 32 over bf16 and int8 caches
(n_past seeded in [0, 511]) and over an int8 page pool of 128-row pages
(B = 32). Each row: the tag, the kernel, the shape and the median device
time in ms (`tools/_common.Timer`: L2 flushed, the host's enqueue hidden);
with `--check`, also the largest error over its limit against the plain
version (2^-6 of attention(q, k, |v|), 2^-12 over an f32 cache). Caches are
seeded N(0, 1) values (int8: those quantized). Without CUDA it refuses to
start.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from ..ops import flash_attn as fa
from ..ops import flash_decode as fd
from ..ops.kv_quant import quantize_rows
from ._common import Timer

H, D, S, BK, PS = 32, 128, 512, 256, 128
K2_NPAST = (37, 160, 300, 480, 511)
RING_NPAST, RING_KEEP = 700, 32


def _cache(gen, shape, kind: str) -> list:
    """Two cache planes of `shape` (and the int8 scales [L, B', S', H])."""
    dtype = torch.float32 if kind == "f32" else torch.bfloat16
    planes = [torch.empty(shape, dtype=dtype, device="cuda").normal_(generator=gen)
              for _ in range(2)]
    if kind != "int8":
        return planes
    qs = [quantize_rows(x) for x in planes]
    return [q for q, _ in qs] + [s.transpose(2, 3).contiguous() for _, s in qs]


def _sc(planes) -> dict:
    return dict(k_scale=planes[2], v_scale=planes[3]) if len(planes) == 4 else {}


def _ring_plane(n_logical: int) -> torch.Tensor:
    """The [S, 1] position plane an engine leaves after n_logical positions."""
    from ..models.llama import ring_phys

    pos = torch.full((S, 1), -1, dtype=torch.int32)
    for p in range(n_logical):
        pos[ring_phys(p, RING_KEEP, S)] = p
    return pos.cuda()


def cases(gen, gen_cpu):
    """(kernel, shape, call, plain call, check operands) of every row."""
    def qkv(b):
        return [torch.randn((b, 1, H, D), device="cuda", generator=gen).to(torch.bfloat16)
                for _ in range(3)]

    for kind in ("bf16", "int8", "f32"):
        planes = _cache(gen, (2, 1, H, S, D), kind)
        for n_past in K2_NPAST:
            q, kn, vn = qkv(1)
            yield (f"K2 {kind}", f"B=1 n_past={n_past}",
                   lambda q=q, kn=kn, vn=vn, n=n_past, p=planes: fa.flash_attention_update(
                       q, kn, vn, p[0], p[1], n, 1, block_k=BK, **_sc(p)),
                   lambda q=q, kn=kn, vn=vn, n=n_past, p=planes: fa.flash_attention_update_ref(
                       q, kn, vn, p[0], p[1], n, 1, block_k=BK, **_sc(p)),
                   dict(q=q, planes=planes, n_past=n_past))
    planes = _cache(gen, (2, 1, H, S, D), "bf16")
    pos = _ring_plane(RING_NPAST + 1)
    from ..models.llama import ring_phys

    rkw = dict(kv_pos=pos, write_row=ring_phys(RING_NPAST, RING_KEEP, S), ring_bounded=True)
    q, kn, vn = qkv(1)
    yield ("K2 ring bf16", f"B=1 n_past={RING_NPAST} keep={RING_KEEP}",
           lambda: fa.flash_attention_update(q, kn, vn, planes[0], planes[1], RING_NPAST, 1,
                                             block_k=BK, **rkw),
           lambda: fa.flash_attention_update_ref(q, kn, vn, planes[0], planes[1], RING_NPAST, 1,
                                                 block_k=BK, **rkw),
           dict(q=q, planes=planes, n_past=RING_NPAST, kv_pos=pos))
    for b, kind, paged in ((8, "bf16", False), (8, "int8", False), (32, "bf16", False),
                           (32, "int8", False), (32, "int8", True)):
        npl = torch.randint(0, S, (b,), generator=gen_cpu).tolist()
        npast = torch.tensor(npl, dtype=torch.int32, device="cuda")
        kw = {}
        if paged:
            n_pages = b * (S // PS) + 1
            planes = _cache(gen, (2, n_pages, H, PS, D), kind)
            pages = torch.randperm(n_pages - 1, generator=gen_cpu)[: b * (S // PS)] + 1
            kw["page_table"] = pages.reshape(b, S // PS).to(torch.int32).cuda()
        else:
            planes = _cache(gen, (2, b, H, S, D), kind)
        q, kn, vn = qkv(b)
        yield (f"K4 {kind}" + (" paged" if paged else ""),
               f"B={b} n_past={min(npl)}..{max(npl)}" + (f" PS={PS}" if paged else ""),
               lambda q=q, kn=kn, vn=vn, p=planes, n=npast, kw=kw: fd.flash_decode_update(
                   q, kn, vn, p[0], p[1], n, 1, block_k=BK, **_sc(p), **kw),
               lambda q=q, kn=kn, vn=vn, p=planes, n=npast, kw=kw: fd.flash_decode_update_ref(
                   q, kn, vn, p[0], p[1], n, 1, block_k=BK, **_sc(p), **kw),
               dict(q=q, planes=planes, n_past=npast, **kw))


def _check(got, want, c: dict) -> float:
    """The largest ratio of an element's error to its limit."""
    p = c["planes"]
    rel = 2.0**-12 if p[0].dtype == torch.float32 else 2.0**-6
    mode = {k: c[k] for k in ("kv_pos", "page_table") if k in c}
    lim = rel * fa.flash_attention_ref(c["q"], p[0], p[1].abs(), c["n_past"], layer_idx=1,
                                       **_sc(p), **mode)
    return float(((got - want).abs() / lim.clamp_min(1e-30)).max())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=20, help="timed launches a row")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", help="also append the rows to this file")
    ap.add_argument("--tag", default="", help="a name for the tree timed, written in each row")
    ap.add_argument("--check", action="store_true",
                    help="also hold each row against its plain version")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_decode times CUDA kernels and needs an NVIDIA GPU")
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    gen_cpu = torch.Generator().manual_seed(args.seed)
    timer = Timer(args.reps)
    out = open(args.out, "a") if args.out else None
    bad = 0
    for kernel, shape, run, plain, c in cases(gen, gen_cpu):
        row = {"tree": args.tag, "kernel": kernel, "shape": shape}
        if args.check:
            # plain first, on copies: the kernel's write must land on the
            # rows the plain version writes
            saved = [x.clone() for x in c["planes"]]
            want = plain()[0]
            after = [x.clone() for x in c["planes"]]
            for x, y in zip(c["planes"], saved):
                x.copy_(y)
            got = run()[0]
            torch.cuda.synchronize()
            row["err_over_limit"] = _check(got, want, c)
            row["cache_bytes_equal"] = all(torch.equal(x, y) for x, y in zip(c["planes"], after))
            bad += not (row["err_over_limit"] <= 1.0 and row["cache_bytes_equal"])
        row["ms"] = timer(run)
        print(json.dumps(row), flush=True)
        if out:
            out.write(json.dumps(row) + "\n")
    if out:
        out.close()
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
