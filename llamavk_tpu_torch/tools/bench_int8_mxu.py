"""P2 on Hopper: does a per-block int8 tensor-core dot beat K1, and K5?

The port of `tools/bench_int8_mxu.py` (its kernels `kernel_current` :46 and
`kernel_i8_batched` :66). With activations quantized per 32-block,

    y[b, n] = sum_g s[g, n] * sx[g, b] * D[g, b, n]
    D[g, b, n] = sum_j xq[g, b, j] * q[g*32 + j, n]     (int8 x int4, exact)

so each weight needs only its nibble extracted, and one k32 step of the int8
`mma.sync` (m16n8k32) is exactly one Q4 block (`csrc/probe_q4_i8.cu`).

    python -m llamavk_tpu_torch.tools.bench_int8_mxu            # the card
    python -m llamavk_tpu_torch.tools.bench_int8_mxu --device cpu

Variants at B = 8 and the TPU probe's three (K, N), f32 scales, one line
each on stderr:

  current  K1 (`ops.q4_matmul.q4_matmul_cuda`, its GEMM at M = 8) on the
           ilv bytes: `kernel_current`, the production baseline
  i8       the group dot on the int8 tensor cores, gm-order bytes
  bf16     the same structure on the bf16 tensor cores (m16n8k16)

and K5 (`q4_matmul_i8_cuda`, which since this probe runs the group dot on
the int8 tensor cores too) on the ilv bytes beside them. xq and sx
are K5's quantization of the same x (`ops.q4_matmul.quantize_act_blocks`).
`--device cpu` runs the plain versions at K = N = 256.
"""

from __future__ import annotations

import torch

from ..ops import _build
from ..ops import q4_matmul as q4
from . import _common
from ._common import QK

B = 8  # the instruction's n side: every row of the batch
launches = {"i8": 0, "bf16": 0}

_SIGS = (("probe_group_dot_launch", "ppppppiiiip"),
         ("probe_i8dot2d_launch", "ppppiiiip"))


def _lib():
    return _common.lib("probe_q4_i8", _SIGS)


def gm_order(packed: torch.Tensor) -> torch.Tensor:
    """The ilv bytes [K/2, N] (row m*G + g) in the probe's gm order [G*16,
    N] (row g*16 + m): the same bytes, each group's 16 rows together."""
    half, n = packed.shape
    g = 2 * half // QK
    return packed.reshape(QK // 2, g, n).transpose(0, 1).reshape(half, n).contiguous()


def group_weights(p_gm: torch.Tensor) -> torch.Tensor:
    """The signed nibbles [G, 32, N] of gm-order bytes: j < 16 the low nibble
    of row g*16 + j, j >= 16 the high nibble of row g*16 + j - 16."""
    half, n = p_gm.shape
    p = p_gm.to(torch.int32).reshape(-1, QK // 2, n)
    return torch.cat([(p << 28) >> 28, p >> 4], dim=1)


def quantized_x(x: torch.Tensor):
    """K5's per-block int8 activations of x bf16 [B, K]: xq [G, B, 32] and
    sx [G, B] (`quantize_act_blocks` in the probe's layout)."""
    xq, sx = q4.quantize_act_blocks(x)
    return xq.permute(1, 2, 0).contiguous(), sx.contiguous()


def group_dot_ref(xq, p_gm, s, sx) -> torch.Tensor:
    """Plain version of `group_dot`: D exact (in float64, which holds every
    such sum), y = sum_g (f32(D) * s) * sx in f32."""
    d = torch.einsum("gbj,gjn->gbn", xq.to(torch.float64),
                     group_weights(p_gm).to(torch.float64)).to(torch.float32)
    return (d * s[:, None, :] * sx[:, :, None]).sum(dim=0)


def group_dot(xq, p_gm, s, sx, dot: str = "i8") -> torch.Tensor:
    """The group dot: xq int8 [G, 8, 32], p_gm int8 [G*16, N], s f32 [G, N],
    sx f32 [G, 8] -> f32 [8, N]; `dot` "i8" (int8 mma) or "bf16". CUDA
    tensors launch the kernel, CPU tensors take `group_dot_ref`."""
    if not xq.is_cuda:
        return group_dot_ref(xq, p_gm, s, sx)
    g, b, j = xq.shape
    n = p_gm.shape[-1]
    if (b, j) != (B, QK) or p_gm.shape != (g * 16, n) or s.shape != (g, n) or sx.shape != (g, B):
        raise ValueError(f"probe group dot: xq {tuple(xq.shape)} p {tuple(p_gm.shape)} "
                         f"s {tuple(s.shape)} sx {tuple(sx.shape)} (8 rows, N % 16)")
    if (xq.dtype, p_gm.dtype, s.dtype, sx.dtype) != (torch.int8,) * 2 + (torch.float32,) * 2 \
            or n % 16 or dot not in launches:
        raise ValueError("probe group dot: int8 xq and p, f32 s and sx, N % 16 == 0, "
                         "dot i8 or bf16")
    _common.require_cuda("probe group dot", xq, p_gm, s, sx)
    dev = xq.device.index if xq.device.index is not None else torch.cuda.current_device()
    ks = _common.ksplit(g, n, 128, dev, g)
    out = torch.empty((B, n), dtype=torch.float32, device=xq.device)
    partial = torch.empty((ks, B, n), dtype=torch.float32, device=xq.device) if ks > 1 else out
    rc = _lib().probe_group_dot_launch(xq.data_ptr(), p_gm.data_ptr(), s.data_ptr(),
                                       sx.data_ptr(), out.data_ptr(), partial.data_ptr(), g, n,
                                       ks, int(dot == "bf16"), _common.stream(xq))
    _build.check(rc, f"probe_group_dot_launch ({dot})")
    launches[dot] += 1
    return out


def int_mm_call(a: torch.Tensor, b: torch.Tensor):
    """One PyTorch call of the exact int8 product a @ b (int32): `(call,
    label)`. torch._int_mm refuses fewer than 17 rows, so a's rows are then
    zero-padded to 32 (outside the timed call) and the label says so."""
    try:
        torch._int_mm(a, b)
        return (lambda: torch._int_mm(a, b)), "torch._int_mm"
    except RuntimeError:
        pad = torch.zeros((32, a.shape[1]), dtype=a.dtype, device=a.device)
        pad[: a.shape[0]] = a
        return (lambda: torch._int_mm(pad, b)), "torch._int_mm (rows zero-padded to 32)"


def library_exact(call, a: torch.Tensor, b: torch.Tensor) -> bool:
    """Whether `call()`'s first rows equal the exact product a @ b."""
    got = call()[: a.shape[0]]
    return torch.equal(got.double(), a.double() @ b.double())


def run(device, reps: int = 20) -> list[dict]:
    """The i8 and bf16 group dots at each shape against the plain version
    (random scales: within G 2^-24 sum_g |D s sx| per element, the f32 sum
    order's bound; unit scales: equal, since D is exact on both sides), with
    K1's and K5's times on the same weights (the card only)."""
    cuda = device.type == "cuda"
    timer = _common.Timer(reps) if cuda else None
    gen = torch.Generator(device=device).manual_seed(0)
    rows = []
    for k, n in _common.PROBE_SHAPES if cuda else _common.CPU_SHAPES:
        g = k // QK
        x = _common.random_x(gen, B, k, device)
        packed, s = _common.random_q4(gen, k, n, torch.float32, device=device)
        p_gm = gm_order(packed)
        xq, sx = quantized_x(x)
        d = torch.einsum("gbj,gjn->gbn", xq.double(), group_weights(p_gm).double())
        limit = (g * 2.0**-24 * (d * s.double()[:, None, :] * sx.double()[:, :, None]).abs()
                 .sum(0)).float()
        del d
        ones_s, ones_sx = torch.ones_like(s), torch.ones_like(sx)
        libs = {"i8": (None, None), "bf16": (None, None)}
        lib_exact = {}
        if cuda:  # the same integer product in one PyTorch call, checked exact
            w8 = group_weights(p_gm).reshape(k, n).to(torch.int8)
            xq2 = xq.permute(1, 0, 2).reshape(B, k).contiguous()
            # f32 operands converted outside the timed call; every partial
            # sum is an integer below 127 * 8 * K < 2^24, so it is exact
            w_f32, xq_f32 = w8.float(), xq2.float()
            libs = {"i8": int_mm_call(xq2, w8),
                    "bf16": ((lambda: torch.matmul(xq_f32, w_f32)), "torch.matmul f32, TF32 off")}
            lib_exact = {dot: library_exact(call, xq2, w8) for dot, (call, _) in libs.items()}
        n_bytes = k // 2 * n + g * n * 4 + g * B * (QK + 4) + B * n * 4
        shape = f"B={B} K={k} N={n}"
        line = []
        for dot in ("i8", "bf16"):
            exact = torch.equal(group_dot(xq, p_gm, ones_s, ones_sx, dot),
                                group_dot_ref(xq, p_gm, ones_s, ones_sx))
            row = _common.measure(
                f"probe_p2_{dot}", dot, shape, lambda dot=dot: group_dot(xq, p_gm, s, sx, dot),
                lambda: group_dot_ref(xq, p_gm, s, sx), timer=timer, n_bytes=n_bytes,
                n_ops=2.0 * B * k * n,
                peak=_common.INT8_OP_PER_S if dot == "i8" else _common.BF16_OP_PER_S,
                limit=limit,
                production=(lambda: q4.q4_matmul_cuda(x, packed, s)) if cuda else None,
                library=libs[dot][0], checks={"unit_scales_exact": exact})
            row["library"] = libs[dot][1]
            if cuda:
                row["library_exact"] = lib_exact[dot]
            if cuda:
                row["k5_ms"] = timer(lambda: q4.q4_matmul_i8_cuda(x, packed, s))
            line.append(row)
        head = f"B={B} K={k:5d} N={n:5d}"
        if cuda:
            head += f"  current {line[0]['production_ms'] * 1e3:7.1f}us"
            tail = f"  (K5 {line[0]['k5_ms'] * 1e3:.1f}us)"
        else:
            tail = ""
        _common.log(_common.shape_line(head, line) + tail)
        rows += line
    return rows


def main(argv=None) -> list[dict]:
    args = _common.parser(__doc__).parse_args(argv)
    return run(_common.device_of(args), args.reps)


if __name__ == "__main__":
    main()
