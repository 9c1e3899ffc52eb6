"""Fused 4-bit dequantize + matmul (twin of `llamavk_tpu/ops/q4_matmul.py`).

computes  y[b, n] = sum_k x[b, k] * W[k, n]   with W given by a QWeight.

Two routes, chosen as the JAX package chooses them (`dot_mode`, default
the environment variable `LLAMAVK_Q4_DOT`, read at import as q4_matmul.py:464
there reads it):

* K1, the bf16 dot (`bf16`, the default, and `i4`, which on the TPU is an
  int4-bitcast unpack of the same bytes with the same numerics as the shift
  unpack, q4_matmul.py:648-651 there, so here it is the same kernel). On a
  CUDA tensor `q4_matmul` launches the kernel of `csrc/q4_matmul.cu` (it
  replaces `_kernel_q4`, q4_matmul.py:96 there); on a CPU tensor it computes
  the plain version, `q4_matmul_ref`: x cast to bf16, w = bf16(f32(q) *
  f32(scale)), products summed in f32, out f32 then `out_dtype`. A Q4_1
  weight's bias term is added outside the kernel as a plain group-sum product
  (as q4_matmul.py:790-794 does). The scale plane (and a Q4_1 bias plane)
  is bf16, or f32 as `perplexity --f32` loads it (q4_matmul.py:120 there
  reads it in its own type): w = bf16(f32(q) * s) with s exact; the bias
  term casts the bias to bf16 as there.
* K5, the int8 dot (`i8`), where `i8_route` says so (Q4_0, ilv, b <= 64, the
  JAX package's tile fit): activations quantized per 32-block to int8
  (`quantize_act_blocks`), an exact int32 dot per group against the int4
  weights, both scales folded in after. A CUDA tensor launches the kernel of
  `csrc/q4_matmul_i8.cu` (it replaces `_kernel_q4_i8`, q4_matmul.py:226
  there); a CPU tensor takes `q4_matmul_i8_ref`. Elsewhere `i8` takes K1.
  K5's kernel takes bf16 scales only: an f32-scale weight on the K5 route
  raises NotImplementedError on a CUDA tensor (ROADMAP.md queue 2).

The K1 modes `LLAMAVK_Q4_DOT=f32` and `LLAMAVK_Q4_MUL=bf16` change the JAX
package's numerics and are not ported yet (ROADMAP.md queue 2): a call
under them raises NotImplementedError, as does any other mode.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import os

import torch

from ..formats.q4 import QK
from ..formats.repack import LAYOUT_ILV
from . import _build
from .kv_quant import INV_127
from .qweight import QWeight, dequantize_qweight

# launches of the CUDA kernels: K1's decode GEMV (M = 1) and tiled GEMM (every
# M > 1), with bf16 or f32 (`_f32`) scale planes, and K5 (`i8`), one per
# q4_matmul call on a CUDA tensor
launches = {"gemv": 0, "gemm": 0, "gemv_f32": 0, "gemm_f32": 0, "i8": 0}
# launches by shape (M, K, N), so a caller can check every shape a run
# reached: K1's in `shapes` (f32 scales: `shapes_f32`), K5's in `shapes_i8`
shapes: collections.Counter = collections.Counter()
shapes_f32: collections.Counter = collections.Counter()
shapes_i8: collections.Counter = collections.Counter()

# the JAX package's switches (q4_matmul.py:450-464 there), read at import
ENV_DOT = os.environ.get("LLAMAVK_Q4_DOT", "bf16")
ENV_MUL = os.environ.get("LLAMAVK_Q4_MUL", "f32")
DOT_MODES = ("bf16", "i4", "i8")
# K5's batch cap (_I8_MAX_B there) and the TPU's VMEM budget that the JAX
# route gate fits K5's tile into (_VMEM_BUDGET there)
I8_MAX_B = 64
VMEM_BUDGET = 10 * 1024 * 1024


def resolve_dot_mode(mode: str | None = None) -> str:
    """The dot mode of a call: `mode`, else LLAMAVK_Q4_DOT; raises
    NotImplementedError on a mode or a LLAMAVK_Q4_MUL the port lacks."""
    mode = mode or ENV_DOT
    if ENV_MUL == "bf16":
        raise NotImplementedError(
            "LLAMAVK_Q4_MUL=bf16 (K1's bf16 scale multiply) is not ported yet "
            "(ROADMAP.md queue 2)")
    if mode not in DOT_MODES:
        raise NotImplementedError(
            f"q4_matmul dot mode {mode!r} is not ported yet (ROADMAP.md queue 2); "
            f"the port runs {', '.join(DOT_MODES)}")
    return mode


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def _i8_vmem_need(bn: int, half: int, gc: int, bp: int) -> int:
    """K5's working set on the TPU (q4_matmul.py:472-478 there)."""
    return half * bn + 2 * half * bn + gc * bp * bn * 8 + gc * bn * 4 + bp * bn * 4


def fit_bn_i8(bn: int, half: int, gc: int, bp: int) -> int:
    """`_fit_bn_i8` of the JAX package (q4_matmul.py:481): halve the N tile
    until K5's TPU working set fits the VMEM budget; 0 when even 128 does
    not. A TPU budget, kept as it is because it decides which numerics the
    JAX package computes, so the port takes the same route."""
    while bn > 128 and _i8_vmem_need(bn, half, gc, bp) > VMEM_BUDGET:
        bn //= 2
    return 0 if _i8_vmem_need(bn, half, gc, bp) > VMEM_BUDGET else bn


def i8_route(mode: str, b: int, k: int, n: int, qw: QWeight) -> bool:
    """True where the JAX package takes K5 (q4_matmul.py:649-666 there): mode
    `i8`, a Q4_0 (no bias) ilv weight, b <= 64 flattened rows, and the tile
    fit at b rounded up to 8 rows. 7B: every K = 4096 matrix up to b = 64,
    `w2` (K = 11008) up to b = 16."""
    chunks = qw.chunks
    return (
        mode == "i8" and qw.bias is None and qw.layout == LAYOUT_ILV and b <= I8_MAX_B
        and fit_bn_i8(min(512, _round_up(n, 128)), (k // chunks) // 2, (k // QK) // chunks,
                      _round_up(max(b, 8), 8)) > 0
    )


def _group_sums(x: torch.Tensor, k: int) -> torch.Tensor:
    """Per-quantization-block sums of x (original k order) → [..., G]."""
    return x.reshape(*x.shape[:-1], k // QK, QK).sum(dim=-1)


def _bias_term(xf: torch.Tensor, qw: QWeight) -> torch.Tensor:
    """Q4_1 affine term: sum_k x_k * bias[group(k), n] as a bf16 group-sum
    product with f32 sums."""
    xg = _group_sums(xf.to(torch.float32), qw.k).to(torch.bfloat16)
    return xg.to(torch.float32) @ qw.bias.to(torch.bfloat16).to(torch.float32)


def q4_matmul_ref(
    x: torch.Tensor, qw: QWeight, out_dtype=torch.float32, layer_idx: int | None = None
) -> torch.Tensor:
    """Plain version of `q4_matmul` on any device: dequantize with the bf16
    weight cast (bf16(f32(q) * f32(s)), for bf16 and f32 scales alike),
    then a bf16 product summed in f32."""
    if layer_idx is not None:
        qw = qw.layer(layer_idx)
    lead = x.shape[:-1]
    xf = x.reshape(-1, qw.k).to(torch.bfloat16)
    w = dequantize_qweight(
        QWeight(packed=qw.packed, scales=qw.scales, layout=qw.layout, chunks=qw.chunks)
    ).to(torch.bfloat16)
    y = xf.to(torch.float32) @ w.to(torch.float32)
    if qw.bias is not None:
        y = y + _bias_term(xf, qw)
    return y.to(out_dtype).reshape(*lead, qw.n)


@functools.cache
def _lib():
    lib = _build.load("q4_matmul")
    p = ctypes.c_void_p
    lib.q4_matmul_launch.argtypes = [p, p, p, p, p, ctypes.c_int, ctypes.c_int,
                                     ctypes.c_int, ctypes.c_int, ctypes.c_int, p]
    lib.q4_matmul_launch.restype = ctypes.c_int
    return lib


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _ksplit(m: int, k: int, n: int, index: int) -> int:
    """Decode (M = 1) K split: enough blocks for two per SM, at least 16
    groups per split, and an x slice that fits the kernel's 40 KB stage."""
    if m != 1:
        return 1
    g = k // QK
    nblk = -(-n // 128)
    want = -(-2 * _sm_count(index) // nblk)
    want = max(1, min(want, g // 16))
    gps_max = 40960 // (QK * 2)
    return max(want, -(-g // gps_max))


def q4_matmul_cuda(xf: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """Launch the K1 kernel: xf bf16 [M, K], packed int8 [K/2, N] (ilv, one
    chunk), scales bf16 or f32 [G, N] → f32 [M, N]."""
    m, k = xf.shape
    half, n = packed.shape
    if not (xf.is_cuda and packed.is_cuda and scales.is_cuda):
        raise ValueError("q4_matmul_cuda: every operand must be a CUDA tensor")
    if (xf.dtype != torch.bfloat16 or packed.dtype != torch.int8
            or scales.dtype not in (torch.bfloat16, torch.float32)):
        raise ValueError(
            f"q4_matmul_cuda: want bf16/int8/bf16 or f32, got {xf.dtype}/{packed.dtype}/"
            f"{scales.dtype}"
        )
    f32s = scales.dtype == torch.float32
    if 2 * half != k or k % QK or n % 8 or scales.shape != (k // QK, n):
        raise ValueError(
            f"q4_matmul_cuda: shapes x {tuple(xf.shape)} packed {tuple(packed.shape)} "
            f"scales {tuple(scales.shape)} (need K % 32 == 0, N % 8 == 0)"
        )
    for t in (xf, packed, scales):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("q4_matmul_cuda: operands must be contiguous and 16-byte aligned")
    dev = xf.device.index if xf.device.index is not None else torch.cuda.current_device()
    out = torch.empty((m, n), dtype=torch.float32, device=xf.device)
    ksplit = _ksplit(m, k, n, dev)
    partial = (
        torch.empty((ksplit, n), dtype=torch.float32, device=xf.device)
        if ksplit > 1 else out
    )
    rc = _lib().q4_matmul_launch(
        xf.data_ptr(), packed.data_ptr(), scales.data_ptr(), out.data_ptr(),
        partial.data_ptr(), m, k, n, ksplit, int(f32s),
        torch.cuda.current_stream(xf.device).cuda_stream,
    )
    _build.check(rc, "q4_matmul_launch")
    launches[("gemv" if m == 1 else "gemm") + ("_f32" if f32s else "")] += 1
    (shapes_f32 if f32s else shapes)[(m, k, n)] += 1
    return out


def quantize_act_blocks(xf: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-32-block symmetric int8 activation quantization
    (q4_matmul.py:207-223 there): xf [B, K] -> xq int8 [QK, G, B] and sx f32
    [G, B] with x[b, g*QK + m] ~= xq[m, g, b] * sx[g, b]. sx = amax * f32(1/127)
    (1 for an all-zero block), as XLA compiles `amax / 127.0` inside the jitted
    q4_matmul; `xb / sx` is a true division and the rounding half to even,
    clipped to +-127, so both equal `jax.jit(quantize_act_blocks)` bit for
    bit."""
    b, k = xf.shape
    xb = xf.to(torch.float32).reshape(b, k // QK, QK)
    amax = xb.abs().amax(dim=-1)  # [B, G]
    sx = torch.where(amax > 0, amax * INV_127.to(xf.device), torch.ones_like(amax))
    xq = torch.clamp(torch.round(xb / sx[..., None]), -127, 127).to(torch.int8)
    return xq.permute(2, 1, 0), sx.T


def _nibbles(packed: torch.Tensor, g: int) -> torch.Tensor:
    """The signed nibbles of an ilv plane [K/2, N] as [QK, G, N]: element m of
    group g is the low nibble of byte row m*G + g for m < 16, the high nibble
    of row (m - 16)*G + g above (q4_matmul.py:246-250 there)."""
    p = packed.to(torch.int32).reshape(QK // 2, g, packed.shape[-1])
    return torch.cat([(p << 28) >> 28, p >> 4], dim=0)


def _check_i8_weight(qw: QWeight) -> None:
    if qw.bias is not None or qw.layout != LAYOUT_ILV or qw.chunks != 1:
        raise NotImplementedError(
            f"the int8 dot takes a Q4_0 ilv weight with one chunk (bias={qw.bias is not None}, "
            f"layout={qw.layout}, chunks={qw.chunks}); chunks > 1 come with tensor parallelism")


def q4_matmul_i8_ref(
    x: torch.Tensor, qw: QWeight, out_dtype=torch.float32, layer_idx: int | None = None
) -> torch.Tensor:
    """Plain version of K5 on any device (q4_matmul.py:226-261 there): x cast
    to bf16 and quantized per 32-block; d[g, b, n], the int32 sum of 32
    int8 x int4 products, computed exactly (in float64, which holds every such
    sum, so no TF32 setting can touch it); y = sum_g (f32(d) * sx[g, b]) *
    s[g, n], multiplied in that order and summed in f32; f32 then
    `out_dtype`."""
    if layer_idx is not None:
        qw = qw.layer(layer_idx)
    _check_i8_weight(qw)
    lead = x.shape[:-1]
    xq, sx = quantize_act_blocks(x.reshape(-1, qw.k).to(torch.bfloat16))
    d = torch.einsum("mgb,mgn->gbn", xq.to(torch.float64),
                     _nibbles(qw.packed, qw.g).to(torch.float64)).to(torch.float32)
    y = (d * sx[:, :, None] * qw.scales.to(torch.float32)[:, None, :]).sum(dim=0)
    return y.to(out_dtype).reshape(*lead, qw.n)


@functools.cache
def _lib_i8():
    lib = _build.load("q4_matmul_i8")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.q4_i8_quantize_launch.argtypes = [p, p, p, i, i, p]
    lib.q4_i8_quantize_launch.restype = ctypes.c_int
    lib.q4_i8_matmul_launch.argtypes = [p, p, p, p, p, p, i, i, i, i, p]
    lib.q4_i8_matmul_launch.restype = ctypes.c_int
    return lib


# K5 splits K into enough blocks for two per SM of a 132-SM card, at least 16
# groups each. The split is a function of (K, N) alone, so an output row's
# float order never depends on M (nor on the card).
_I8_BLOCKS = 264


def ksplit_i8(k: int, n: int) -> int:
    g = k // QK
    want = -(-_I8_BLOCKS // -(-n // 128))
    return max(1, min(want, g // 16))


def _quantize_cuda(xf: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """K5's first launch: xf bf16 [M, K] -> xq int8 [M, K], sx f32 [M, G]."""
    m, k = xf.shape
    xq = torch.empty((m, k), dtype=torch.int8, device=xf.device)
    sx = torch.empty((m, k // QK), dtype=torch.float32, device=xf.device)
    rc = _lib_i8().q4_i8_quantize_launch(xf.data_ptr(), xq.data_ptr(), sx.data_ptr(), m, k,
                                         torch.cuda.current_stream(xf.device).cuda_stream)
    _build.check(rc, "q4_i8_quantize_launch")
    return xq, sx


def quantize_act_blocks_cuda(xf: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """K5's activation quantization on the card, in `quantize_act_blocks`'
    layout (xq [QK, G, M], sx [G, M]), for holding it against the plain one."""
    _check_i8_x(xf)
    xq, sx = _quantize_cuda(xf)
    return xq.reshape(xf.shape[0], -1, QK).permute(2, 1, 0), sx.T


def _check_i8_x(xf: torch.Tensor) -> None:
    if not xf.is_cuda or xf.dtype != torch.bfloat16 or xf.dim() != 2 or xf.shape[1] % QK:
        raise ValueError(f"K5: x must be CUDA bf16 [M, K] with K % {QK} == 0")
    if not xf.is_contiguous() or xf.data_ptr() % 16:
        raise ValueError("K5: x must be contiguous and 16-byte aligned")


def q4_matmul_i8_cuda(xf: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """Launch K5: xf bf16 [M, K] (M <= 64), packed int8 [K/2, N] (ilv, one
    chunk, Q4_0), scales bf16 [G, N] → f32 [M, N]. Two launches: the
    activation quantization, then the group dot (plus an in-order sum of the
    K split's partials)."""
    _check_i8_x(xf)
    m, k = xf.shape
    half, n = packed.shape
    if not (packed.is_cuda and scales.is_cuda and packed.device == xf.device == scales.device):
        raise ValueError("q4_matmul_i8_cuda: every operand must be a CUDA tensor on one device")
    if packed.dtype != torch.int8 or scales.dtype != torch.bfloat16:
        raise ValueError(f"q4_matmul_i8_cuda: want int8/bf16 weight planes, got "
                         f"{packed.dtype}/{scales.dtype}")
    if not 1 <= m <= I8_MAX_B or 2 * half != k or n % 8 or scales.shape != (k // QK, n):
        raise ValueError(
            f"q4_matmul_i8_cuda: shapes x {tuple(xf.shape)} packed {tuple(packed.shape)} "
            f"scales {tuple(scales.shape)} (need M <= {I8_MAX_B}, N % 8 == 0)")
    for t in (packed, scales):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("q4_matmul_i8_cuda: weights must be contiguous and 16-byte aligned")
    xq, sx = _quantize_cuda(xf)
    out = torch.empty((m, n), dtype=torch.float32, device=xf.device)
    ksplit = ksplit_i8(k, n)
    partial = (torch.empty((ksplit, m, n), dtype=torch.float32, device=xf.device)
               if ksplit > 1 else out)
    rc = _lib_i8().q4_i8_matmul_launch(
        xq.data_ptr(), sx.data_ptr(), packed.data_ptr(), scales.data_ptr(), out.data_ptr(),
        partial.data_ptr(), m, k, n, ksplit, torch.cuda.current_stream(xf.device).cuda_stream,
    )
    _build.check(rc, "q4_i8_matmul_launch")
    launches["i8"] += 1
    shapes_i8[(m, k, n)] += 1
    return out


def q4_matmul(
    x: torch.Tensor,
    qw: QWeight,
    out_dtype=torch.bfloat16,
    layer_idx: int | None = None,
    dot_mode: str | None = None,
    plain: bool = False,
) -> torch.Tensor:
    """y = x @ W for a packed QWeight. x: [..., K] (any leading dims).

    layer_idx: qw is STACKED ([L, K/2, N] / [L, G, N]) and layer `layer_idx`
    is used through views of the stacked planes (no copy). dot_mode: "bf16",
    "i4" or "i8" (default LLAMAVK_Q4_DOT); `i8_route` picks K5 or K1. A CUDA x
    launches the route's kernel; a CPU x, or `plain`, takes its plain
    version."""
    mode = resolve_dot_mode(dot_mode)
    if layer_idx is not None:
        qw = qw.layer(layer_idx)
    lead = x.shape[:-1]
    if i8_route(mode, x.numel() // qw.k, qw.k, qw.n, qw):
        if plain or not x.is_cuda:
            return q4_matmul_i8_ref(x, qw, out_dtype)
        _check_i8_weight(qw)
        if qw.scales.dtype != torch.bfloat16:
            raise NotImplementedError(
                "the int8 dot's kernel (K5) takes bf16 scales; f32 scales are not ported yet "
                "(ROADMAP.md queue 2)")
        xf = x.reshape(-1, qw.k).to(torch.bfloat16).contiguous()
        return q4_matmul_i8_cuda(xf, qw.packed, qw.scales).to(out_dtype).reshape(*lead, qw.n)
    if plain or not x.is_cuda:
        return q4_matmul_ref(x, qw, out_dtype)
    if qw.layout != LAYOUT_ILV or qw.chunks != 1:
        raise NotImplementedError(
            f"q4_matmul: the CUDA kernel takes the ilv layout with one chunk "
            f"(got layout={qw.layout}, chunks={qw.chunks})"
        )
    xf = x.reshape(-1, qw.k).to(torch.bfloat16).contiguous()
    y = q4_matmul_cuda(xf, qw.packed, qw.scales)
    if qw.bias is not None:
        y = y + _bias_term(xf, qw)
    return y.to(out_dtype).reshape(*lead, qw.n)
