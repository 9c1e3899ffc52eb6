"""Fused 4-bit dequantize + matmul (twin of `llamavk_tpu/ops/q4_matmul.py`).

computes  y[b, n] = sum_k x[b, k] * W[k, n]   with W given by a QWeight.

Two routes, chosen as the JAX package chooses them (`dot_mode`, default
the environment variable `LLAMAVK_Q4_DOT`, read at import as q4_matmul.py:464
there reads it):

* K1 (`bf16`, the default; `i4`, which on the TPU is an int4-bitcast
  unpack of the same bytes with the same numerics as the shift unpack,
  q4_matmul.py:648-651 there, so here it is the same kernel; and `f32`). On
  a CUDA tensor `q4_matmul` launches the kernel of `csrc/q4_matmul.cu` (the
  GEMV at M = 1, one launch a call with its K split merged inside; the GEMM
  of `csrc/q4_gemm.cuh` above; they replace `_kernel_q4`, q4_matmul.py:96
  there), for the ilv and the lin layout; on
  a CPU tensor it computes the plain version, `q4_matmul_ref`: x cast to
  bf16, w = f32(q) * f32(scale) rounded to bf16 (the `f32` dot keeps
  it f32), products summed in f32, out f32 then `out_dtype`. `mul_dtype`
  bf16 (LLAMAVK_Q4_MUL=bf16) does the nibble-scale multiply in bf16: the
  scale is rounded to bf16 and w = bf16(f32(q) * s) under either dot
  (q4_matmul.py:121, :180-181, :192-193 there). A Q4_1 weight's bias term is
  added outside the kernel as a plain group-sum product (as
  q4_matmul.py:790-794 does). The scale plane (and a Q4_1 bias plane) is
  bf16, or f32 as `perplexity --f32` loads it (q4_matmul.py:120 there reads
  it in its own type); the bias term casts the bias to bf16 as there.
* K5, the int8 dot (`i8`), where `i8_route` says so (Q4_0, ilv, b <= 64, the
  JAX package's tile fit): activations quantized per 32-block to int8
  (`quantize_act_blocks`), an exact int32 dot per group against the int4
  weights, both scales folded in after. A CUDA tensor launches the kernel of
  `csrc/q4_matmul_i8.cu` (`mma.sync` m16n8k32 on the int8 tensor cores, one
  Q4_0 group an MMA; it replaces `_kernel_q4_i8`, q4_matmul.py:226 there); a
  CPU tensor takes `q4_matmul_i8_ref`. Elsewhere `i8` takes K1.
  K5 reads the scale plane in its own type, bf16 or f32.

A weight packed in `chunks` > 1 contiguous K slices (the tensor-parallel
row-split packing of `wo`/`w2`, `formats/repack.py`) runs one launch per
chunk on the chunk's slice of x, packed rows and scale rows, and the partial
products are summed in f32 in chunk order (q4_matmul.py:714-728 stacked,
:776-789 flat, :522 for K5 there); the plain versions loop over the chunks
in the same way. A chunk's x slice is copied to a contiguous [M, K/chunks]
tensor first (no copy at M = 1): the kernels take x as a dense row-major
pointer, and the copy is M * K * 2 bytes beside the weight's K * N / 2.

The dot mode of a call is its `dot_mode` argument, else LLAMAVK_Q4_DOT. The
JAX `_kernel_q4` reads the environment's mode for its dot type whatever the
call's argument (q4_matmul.py:117 there); the port honours the argument
(ROADMAP.md queue 3). An unknown mode raises NotImplementedError.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import itertools
import os

import torch

from ..formats.q4 import QK
from ..formats.repack import LAYOUT_ILV, LAYOUT_LIN
from . import _build
from .kv_quant import INV_127
from .qweight import QWeight, dequantize_qweight


def launch_key(m: int, lin: bool = False, f32_scales: bool = False, round_scales: bool = False,
               w_f32: bool = False, chunked: bool = False) -> str:
    """The launch counter of a K1 launch: `gemv` (M = 1) or `gemm`, then
    `_lin` for the lin layout, `_f32` for an f32 scale plane, `_mulbf16`
    where LLAMAVK_Q4_MUL=bf16 rounds an f32 scale plane (a bf16 plane takes
    the default kernel), `_dotf32` for the f32 dot's weights and `_chunks`
    for a launch on one chunk of a weight packed in several."""
    return (("gemv" if m == 1 else "gemm") + ("_lin" if lin else "")
            + ("_f32" if f32_scales else "") + ("_mulbf16" if round_scales else "")
            + ("_dotf32" if w_f32 else "") + ("_chunks" if chunked else ""))


def i8_key(f32_scales: bool = False, chunked: bool = False) -> str:
    """The launch counter of a K5 launch: `i8`, `_f32` over f32 scales,
    `_chunks` on one chunk of a weight packed in several."""
    return "i8" + ("_f32" if f32_scales else "") + ("_chunks" if chunked else "")


# launches of the CUDA kernels, one per chunk of a q4_matmul call on a CUDA
# tensor: K1's decode GEMV (M = 1) and tiled GEMM (every M > 1) by mode
# (`launch_key`), and K5 with bf16 (`i8`) or f32 (`i8_f32`) scales
launches = {
    launch_key(m, lin, f32s, rs, wf, ch): 0
    for m, lin, f32s, rs, wf, ch in itertools.product((1, 2), (False, True), (False, True),
                                                       (False, True), (False, True),
                                                       (False, True))
    if not (rs and (wf or not f32s))
}
launches.update({i8_key(f32s, ch): 0 for f32s in (False, True) for ch in (False, True)})
# launches by shape (M, K, N), so a caller can check every shape a run
# reached: K1's default ilv kernel in `shapes` (f32 scales: `shapes_f32`),
# K5's with bf16 scales in `shapes_i8`; every other mode in `shapes_modes`,
# keyed (launch key, M, K, N). A chunked weight's launches count under its
# whole K, one per chunk
shapes: collections.Counter = collections.Counter()
shapes_f32: collections.Counter = collections.Counter()
shapes_i8: collections.Counter = collections.Counter()
shapes_modes: collections.Counter = collections.Counter()

# the JAX package's switches (q4_matmul.py:450-464 there), read at import
ENV_DOT = os.environ.get("LLAMAVK_Q4_DOT", "bf16")
ENV_MUL = os.environ.get("LLAMAVK_Q4_MUL", "f32")
DOT_MODES = ("bf16", "i4", "i8", "f32")
# K5's batch cap (_I8_MAX_B there) and the TPU's VMEM budget that the JAX
# route gate fits K5's tile into (_VMEM_BUDGET there)
I8_MAX_B = 64
VMEM_BUDGET = 10 * 1024 * 1024


def resolve_dot_mode(mode: str | None = None) -> str:
    """The dot mode of a call: `mode`, else LLAMAVK_Q4_DOT; raises
    NotImplementedError on a mode the JAX package does not have."""
    mode = mode or ENV_DOT
    if mode not in DOT_MODES:
        raise NotImplementedError(
            f"q4_matmul dot mode {mode!r}: the port runs {', '.join(DOT_MODES)}")
    return mode


def resolve_mul_dtype(mul_dtype: torch.dtype | None = None) -> torch.dtype:
    """The nibble-scale multiply's type of a call: `mul_dtype`, else bf16
    under LLAMAVK_Q4_MUL=bf16 and f32 for any other value, as
    q4_matmul.py:451-453 there reads it."""
    if mul_dtype is None:
        return torch.bfloat16 if ENV_MUL == "bf16" else torch.float32
    if mul_dtype not in (torch.float32, torch.bfloat16):
        raise NotImplementedError(f"q4_matmul mul_dtype {mul_dtype}: float32 or bfloat16")
    return mul_dtype


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


def mode_weight(qw: QWeight, dot_mode: str = "bf16",
                mul_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """K1's dense weight [K, N] in f32 as a mode feeds it to the dot (any
    layout): w = f32(q) * s, s rounded to bf16 first under the bf16 multiply,
    and w rounded to bf16 unless the dot is f32 and the multiply f32."""
    s = qw.scales.to(torch.bfloat16) if mul_dtype == torch.bfloat16 else qw.scales
    w = dequantize_qweight(QWeight(packed=qw.packed, scales=s, layout=qw.layout,
                                   chunks=qw.chunks))
    if dot_mode == "f32" and mul_dtype == torch.float32:
        return w
    return w.to(torch.bfloat16).to(torch.float32)


def _chunk_sum(xf: torch.Tensor, qw: QWeight, part) -> torch.Tensor:
    """sum_c part(x chunk c, weight chunk c) in f32, in chunk order: the
    chunk loop of q4_matmul.py:714-728, :776-789 and :522 there."""
    kc = qw.k // qw.chunks
    y = None
    for c in range(qw.chunks):
        yc = part(xf[:, c * kc : (c + 1) * kc], qw.chunk(c))
        y = yc if y is None else y + yc
    return y


def q4_matmul_ref(
    x: torch.Tensor, qw: QWeight, out_dtype=torch.float32, layer_idx: int | None = None,
    dot_mode: str | None = None, mul_dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """Plain version of K1 on any device, in the call's dot mode and multiply
    type (defaults as `q4_matmul`): x cast to bf16, the weight of
    `mode_weight`, products summed in f32, chunk by chunk for a chunked
    weight."""
    mode = resolve_dot_mode(dot_mode)
    mul = resolve_mul_dtype(mul_dtype)
    if layer_idx is not None:
        qw = qw.layer(layer_idx)
    lead = x.shape[:-1]
    xf = x.reshape(-1, qw.k).to(torch.bfloat16)
    y = _chunk_sum(xf, qw, lambda xc, wc: xc.to(torch.float32) @ mode_weight(wc, mode, mul))
    if qw.bias is not None:
        y = y + _bias_term(xf, qw)
    return y.to(out_dtype).reshape(*lead, qw.n)


@functools.cache
def _lib():
    lib = _build.load("q4_matmul")
    p = ctypes.c_void_p
    lib.q4_matmul_launch.argtypes = [p, p, p, p, p, p, ctypes.c_int, ctypes.c_int,
                                     ctypes.c_int, ctypes.c_int, ctypes.c_int, p]
    lib.q4_matmul_launch.restype = ctypes.c_int
    lib.q4_launch_count.argtypes = []
    lib.q4_launch_count.restype = ctypes.c_long
    return lib


def cuda_launches() -> int:
    """The CUDA kernels `csrc/q4_matmul.cu` has launched in this process
    (the GEMV, the GEMM and the GEMM's split sums), where `launches` counts
    wrapper calls: the difference over one call is that call's kernel
    launches (one for a GEMV call). Kernels that CUDA graph replays
    launched count too (`_build.replayed`)."""
    return _lib().q4_launch_count() + _build.replayed["q4_matmul"]


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


# the decode GEMV's block (csrc/q4_matmul.cu, namespace gemv): 128 output
# columns and 4 warps, 4 blocks resident an SM (128 registers a thread),
# at most 256 units (32 k each) a split
GEMV_BN = 128
GEMV_WARPS = 4
GEMV_BLOCKS_PER_SM = 4
GEMV_MAX_UPS = 256


def gemv_ksplit(k: int, n: int, sms: int) -> int:
    """Decode (M = 1) K split into ranges of whole 32-k units: the most
    splits whose blocks (one per 128-column tile and split) all fit on the
    card at once (4 an SM), so every block starts at once and the card has
    no last partial wave; at least a unit per warp, at most 256 units a
    split (the kernel's x stage). A function of (K, N) and the SM count
    alone."""
    units = k // QK
    tiles = -(-n // GEMV_BN)
    split = max(1, min(GEMV_BLOCKS_PER_SM * sms // tiles, units // GEMV_WARPS))
    return max(split, -(-units // GEMV_MAX_UPS))


def gemv_splits(k: int, n: int, sms: int) -> int:
    """The K ranges the GEMV's launch makes of `gemv_ksplit` (whole units,
    all but the last of one size)."""
    units = k // QK
    ups = -(-units // gemv_ksplit(k, n, sms))
    return -(-units // ups)


# the GEMV's arrival counters, one zeroed int32 tensor per device, one per
# 128-column tile, grown when a call needs more (never while a CUDA graph
# captures); the last block of a tile sets its counter back to 0 (the
# launches of a device share them in stream order)
_gemv_counters: dict[str, torch.Tensor] = {}


def gemv_counters(device: torch.device, n: int) -> torch.Tensor:
    """The device's GEMV counters, at least one per 128-column tile of N."""
    tiles = -(-n // GEMV_BN)
    cnt = _gemv_counters.get(str(device))
    if cnt is None or cnt.numel() < tiles:
        _build.refuse_while_capturing(device, "the GEMV's counters")
        cnt = torch.zeros(max(tiles, 1024), dtype=torch.int32, device=device)
        _gemv_counters[str(device)] = cnt
    return cnt


# the GEMM's route threshold and its routes' block columns and token tile
# (csrc/q4_gemm.cuh: SMALL_M, `Small`, `Large`)
GEMM_SMALL_M = 64
GEMM_SMALL_BN = 256
GEMM_LARGE_BN = 128
GEMM_LARGE_TILE_M = 128


def gemm_ksplit(m: int, k: int, n: int, sms: int) -> int:
    """The GEMM's (M >= 2) K split into ranges of whole 32-k units (16
    packed rows), at least 16 units each. M <= 64: enough 256-column blocks
    for two per SM, from (K, N) and the SM count alone, so an output row's
    float order does not depend on M. Above, the 128 x 128 tiles fill the
    card at large M; K is split only while the grid has fewer blocks than
    SMs."""
    units = k // QK
    if m <= GEMM_SMALL_M:
        nblk = -(-n // GEMM_SMALL_BN)
    else:
        nblk = -(-n // GEMM_LARGE_BN) * -(-m // GEMM_LARGE_TILE_M)
        if nblk >= sms:
            return 1
    return max(1, min(-(-2 * sms // nblk), units // 16))


def scratch_shape(m: int, k: int, n: int, sms: int) -> tuple[int, ...] | None:
    """The partial sums' scratch of a K1 launch on a card of `sms` SMs:
    [splits, N] for the GEMV (its K ranges, merged inside its launch),
    [splits, M, N] for the GEMM, None for one split (the kernel writes the
    output)."""
    split = gemv_splits(k, n, sms) if m == 1 else gemm_ksplit(m, k, n, sms)
    if split == 1:
        return None
    return (split, n) if m == 1 else (split, m, n)


# mode bits of q4_matmul_launch (csrc/q4_matmul.cu)
_SCALE_F32, _LIN, _ROUND_SCALE, _W_F32 = 1, 2, 4, 8


def q4_matmul_cuda(xf: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor,
                   layout: str = LAYOUT_ILV, dot_mode: str = "bf16",
                   mul_dtype: torch.dtype = torch.float32, chunks: int = 1) -> torch.Tensor:
    """Launch the K1 kernel: xf bf16 [M, K], packed int8 [K/2, N] (ilv or
    lin, packed in `chunks` K slices: one launch each), scales bf16 or f32
    [G, N] → f32 [M, N], in the numerics of `dot_mode` ("f32" keeps w in
    f32; any other is the bf16 dot) and `mul_dtype`."""
    if chunks > 1:
        qw = QWeight(packed=packed, scales=scales, layout=layout, chunks=chunks)
        return _chunk_sum(xf, qw, lambda xc, wc: _q4_launch(
            xc.contiguous(), wc.packed, wc.scales, layout, dot_mode, mul_dtype, qw.k))
    return _q4_launch(xf, packed, scales, layout, dot_mode, mul_dtype)


def _q4_launch(xf, packed, scales, layout, dot_mode, mul_dtype, chunked_k: int = 0):
    """One K1 launch on one chunk; `chunked_k` the whole weight's K when the
    chunk is one of several (its launch key then ends in `_chunks`)."""
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
    lin = layout == LAYOUT_LIN
    if layout not in (LAYOUT_ILV, LAYOUT_LIN):
        raise NotImplementedError(f"q4_matmul_cuda: layout {layout!r} (the port runs ilv and lin)")
    if 2 * half != k or k % (64 if lin else QK) or n % 8 or scales.shape != (k // QK, n):
        raise ValueError(
            f"q4_matmul_cuda: shapes x {tuple(xf.shape)} packed {tuple(packed.shape)} "
            f"scales {tuple(scales.shape)} (need K % 32 == 0, lin K % 64 == 0, N % 8 == 0)"
        )
    round_s = f32s and mul_dtype == torch.bfloat16
    w_f32 = dot_mode == "f32" and mul_dtype == torch.float32
    bits = (_SCALE_F32 * f32s) | (_LIN * lin) | (_ROUND_SCALE * round_s) | (_W_F32 * w_f32)
    for t in (xf, packed, scales):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("q4_matmul_cuda: operands must be contiguous and 16-byte aligned")
    dev = xf.device.index if xf.device.index is not None else torch.cuda.current_device()
    sms = _sm_count(dev)
    out = torch.empty((m, n), dtype=torch.float32, device=xf.device)
    scratch = scratch_shape(m, k, n, sms)
    ksplit = gemv_ksplit(k, n, sms) if m == 1 else 1 if scratch is None else scratch[0]
    partial = out if scratch is None else torch.empty(scratch, dtype=torch.float32,
                                                      device=xf.device)
    counters = gemv_counters(xf.device, n).data_ptr() if m == 1 and scratch else None
    rc = _lib().q4_matmul_launch(
        xf.data_ptr(), packed.data_ptr(), scales.data_ptr(), out.data_ptr(),
        partial.data_ptr(), counters, m, k, n, ksplit, bits,
        torch.cuda.current_stream(xf.device).cuda_stream,
    )
    _build.check(rc, "q4_matmul_launch")
    key = launch_key(m, lin, f32s, round_s, w_f32, chunked_k > 0)
    launches[key] += 1
    if chunked_k:
        shapes_modes[(key, m, chunked_k, n)] += 1
    elif bits & ~_SCALE_F32:
        shapes_modes[(key, m, k, n)] += 1
    else:
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
    if qw.bias is not None or qw.layout != LAYOUT_ILV:
        raise NotImplementedError(
            f"the int8 dot takes a Q4_0 ilv weight (bias={qw.bias is not None}, "
            f"layout={qw.layout})")


def q4_matmul_i8_ref(
    x: torch.Tensor, qw: QWeight, out_dtype=torch.float32, layer_idx: int | None = None
) -> torch.Tensor:
    """Plain version of K5 on any device (q4_matmul.py:226-261 there): x cast
    to bf16 and quantized per 32-block; d[g, b, n], the int32 sum of 32
    int8 x int4 products, computed exactly (in float64, which holds every such
    sum, so no TF32 setting can touch it); y = sum_g (f32(d) * sx[g, b]) *
    s[g, n], multiplied in that order and summed in f32, chunk by chunk for a
    chunked weight; f32 then `out_dtype`."""
    if layer_idx is not None:
        qw = qw.layer(layer_idx)
    _check_i8_weight(qw)
    lead = x.shape[:-1]

    def part(xc, wc):
        xq, sx = quantize_act_blocks(xc)
        d = torch.einsum("mgb,mgn->gbn", xq.to(torch.float64),
                         _nibbles(wc.packed, wc.g).to(torch.float64)).to(torch.float32)
        return (d * sx[:, :, None] * wc.scales.to(torch.float32)[:, None, :]).sum(dim=0)

    y = _chunk_sum(x.reshape(-1, qw.k).to(torch.bfloat16), qw, part)
    return y.to(out_dtype).reshape(*lead, qw.n)


@functools.cache
def _lib_i8():
    lib = _build.load("q4_matmul_i8")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.q4_i8_quantize_launch.argtypes = [p, p, p, i, i, p]
    lib.q4_i8_quantize_launch.restype = ctypes.c_int
    lib.q4_i8_matmul_launch.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, p]
    lib.q4_i8_matmul_launch.restype = ctypes.c_int
    return lib


# K5's token tile variants (csrc/q4_matmul_i8.cu: the kernel's NT template
# argument, 8 token rows a tile)
I8_TILES = (1, 2, 4, 8)
# K5 splits K so that 256-column blocks number about two per SM of a 132-SM
# card (the nearest whole split), at least 16 groups each. The split is a
# function of (K, N) alone, so an output row's float order never depends on
# M (nor on the card).
_I8_BLOCKS = 264
_I8_SPLIT_BN = 256


def ksplit_i8(k: int, n: int) -> int:
    g = k // QK
    nblk = -(-n // _I8_SPLIT_BN)
    return max(1, min((2 * _I8_BLOCKS + nblk) // (2 * nblk), g // 16))


def i8_splits(k: int, n: int) -> int:
    """The K ranges K5's launch makes of `ksplit_i8` (whole groups each)."""
    g = k // QK
    gps = -(-g // ksplit_i8(k, n))
    return -(-g // gps)


def i8_token_tiles(m: int) -> int:
    """K5's kernel variant for M rows: the fewest n8 token tiles (1, 2, 4 or
    8) that hold them. Every variant folds an output's groups in the same
    order, so the choice moves no bit of a row."""
    if not 1 <= m <= I8_MAX_B:
        raise ValueError(f"K5 takes 1 to {I8_MAX_B} rows, not {m}")
    return next(t for t in I8_TILES if m <= 8 * t)


def i8_scratch_shape(m: int, k: int, n: int) -> tuple[int, int, int] | None:
    """The split partials' scratch of a K5 launch, [splits, M, N], or None for
    one split (the kernel writes the output)."""
    splits = i8_splits(k, n)
    return None if splits == 1 else (splits, m, n)


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


def q4_matmul_i8_cuda(xf: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor,
                      chunks: int = 1) -> torch.Tensor:
    """Launch K5: xf bf16 [M, K] (M <= 64), packed int8 [K/2, N] (ilv, Q4_0,
    packed in `chunks` K slices: one pair of launches each), scales bf16 or
    f32 [G, N] → f32 [M, N]. Two launches per chunk: the activation
    quantization (per 32-block, so a chunk's slice quantizes as the whole x
    does), then the group dot on the int8 tensor cores in the variant of
    `i8_token_tiles(M)` (plus an in-order sum of the K split's partials)."""
    if chunks > 1:
        qw = QWeight(packed=packed, scales=scales, chunks=chunks)
        return _chunk_sum(xf, qw, lambda xc, wc: _i8_launch(xc.contiguous(), wc.packed,
                                                            wc.scales, qw.k))
    return _i8_launch(xf, packed, scales)


def _i8_launch(xf, packed, scales, chunked_k: int = 0) -> torch.Tensor:
    """K5's launches on one chunk (`chunked_k` as `_q4_launch`'s)."""
    _check_i8_x(xf)
    m, k = xf.shape
    half, n = packed.shape
    if not (packed.is_cuda and scales.is_cuda and packed.device == xf.device == scales.device):
        raise ValueError("q4_matmul_i8_cuda: every operand must be a CUDA tensor on one device")
    if packed.dtype != torch.int8 or scales.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"q4_matmul_i8_cuda: want int8/bf16 or f32 weight planes, got "
                         f"{packed.dtype}/{scales.dtype}")
    f32s = scales.dtype == torch.float32
    if not 1 <= m <= I8_MAX_B or 2 * half != k or n % 8 or scales.shape != (k // QK, n):
        raise ValueError(
            f"q4_matmul_i8_cuda: shapes x {tuple(xf.shape)} packed {tuple(packed.shape)} "
            f"scales {tuple(scales.shape)} (need M <= {I8_MAX_B}, N % 8 == 0)")
    for t in (packed, scales):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("q4_matmul_i8_cuda: weights must be contiguous and 16-byte aligned")
    xq, sx = _quantize_cuda(xf)
    out = torch.empty((m, n), dtype=torch.float32, device=xf.device)
    scratch = i8_scratch_shape(m, k, n)
    partial = out if scratch is None else torch.empty(scratch, dtype=torch.float32,
                                                      device=xf.device)
    rc = _lib_i8().q4_i8_matmul_launch(
        xq.data_ptr(), sx.data_ptr(), packed.data_ptr(), scales.data_ptr(), out.data_ptr(),
        partial.data_ptr(), m, k, n, ksplit_i8(k, n), i8_token_tiles(m), int(f32s),
        torch.cuda.current_stream(xf.device).cuda_stream,
    )
    _build.check(rc, "q4_i8_matmul_launch")
    key = i8_key(f32s, chunked_k > 0)
    launches[key] += 1
    if f32s or chunked_k:
        shapes_modes[(key, m, chunked_k or k, n)] += 1
    else:
        shapes_i8[(m, k, n)] += 1
    return out


def q4_matmul(
    x: torch.Tensor,
    qw: QWeight,
    out_dtype=torch.bfloat16,
    layer_idx: int | None = None,
    dot_mode: str | None = None,
    plain: bool = False,
    mul_dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """y = x @ W for a packed QWeight. x: [..., K] (any leading dims).

    layer_idx: qw is STACKED ([L, K/2, N] / [L, G, N]) and layer `layer_idx`
    is used through views of the stacked planes (no copy). dot_mode: "bf16",
    "i4", "i8" or "f32" (default LLAMAVK_Q4_DOT); `i8_route` picks K5 or K1.
    mul_dtype: K1's nibble-scale multiply, torch.float32 or torch.bfloat16
    (default LLAMAVK_Q4_MUL). A CUDA x launches the route's kernel; a CPU x,
    or `plain`, takes its plain version."""
    mode = resolve_dot_mode(dot_mode)
    mul = resolve_mul_dtype(mul_dtype)
    if layer_idx is not None:
        qw = qw.layer(layer_idx)
    lead = x.shape[:-1]
    if i8_route(mode, x.numel() // qw.k, qw.k, qw.n, qw):
        if plain or not x.is_cuda:
            return q4_matmul_i8_ref(x, qw, out_dtype)
        _check_i8_weight(qw)
        xf = x.reshape(-1, qw.k).to(torch.bfloat16).contiguous()
        y = q4_matmul_i8_cuda(xf, qw.packed, qw.scales, qw.chunks)
        return y.to(out_dtype).reshape(*lead, qw.n)
    if plain or not x.is_cuda:
        return q4_matmul_ref(x, qw, out_dtype, dot_mode=mode, mul_dtype=mul)
    xf = x.reshape(-1, qw.k).to(torch.bfloat16).contiguous()
    y = q4_matmul_cuda(xf, qw.packed, qw.scales, qw.layout, mode, mul, qw.chunks)
    if qw.bias is not None:
        y = y + _bias_term(xf, qw)
    return y.to(out_dtype).reshape(*lead, qw.n)
