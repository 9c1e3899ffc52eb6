"""Fused 4-bit dequantize + matmul (twin of `llamavk_tpu/ops/q4_matmul.py`).

computes  y[b, n] = sum_k x[b, k] * W[k, n]   with W given by a QWeight.

On a CUDA tensor `q4_matmul` launches the hand-written Hopper kernel of
`csrc/q4_matmul.cu` (it replaces the TPU kernel `_kernel_q4`, q4_matmul.py:96
there; the source's header says what bounds it and how it is laid out). On a
CPU tensor it computes the plain version, `q4_matmul_ref`, which has the
kernel's numerics: x cast to bf16, w = bf16(f32(q) * f32(scale)), products
summed in f32, out f32 then `out_dtype`. A Q4_1 weight's bias term is added
outside the kernel as a plain group-sum product (as q4_matmul.py:790-794 does).
"""

from __future__ import annotations

import collections
import ctypes
import functools

import torch

from ..formats.q4 import QK
from ..formats.repack import LAYOUT_ILV
from . import _build
from .qweight import QWeight, dequantize_qweight

# launches of the CUDA kernels: the decode GEMV (M = 1) and the tiled GEMM
# (every M > 1), one per q4_matmul call on a CUDA tensor
launches = {"gemv": 0, "gemm": 0}
# launches by shape (M, K, N), so a caller can check every shape a run reached
shapes: collections.Counter = collections.Counter()


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
    weight cast, then a bf16 product summed in f32."""
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
                                     ctypes.c_int, ctypes.c_int, p]
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
    chunk), scales bf16 [G, N] → f32 [M, N]."""
    m, k = xf.shape
    half, n = packed.shape
    if not (xf.is_cuda and packed.is_cuda and scales.is_cuda):
        raise ValueError("q4_matmul_cuda: every operand must be a CUDA tensor")
    if xf.dtype != torch.bfloat16 or packed.dtype != torch.int8 or scales.dtype != torch.bfloat16:
        raise ValueError(
            f"q4_matmul_cuda: want bf16/int8/bf16, got {xf.dtype}/{packed.dtype}/{scales.dtype}"
        )
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
        partial.data_ptr(), m, k, n, ksplit, torch.cuda.current_stream(xf.device).cuda_stream,
    )
    _build.check(rc, "q4_matmul_launch")
    launches["gemv" if m == 1 else "gemm"] += 1
    shapes[(m, k, n)] += 1
    return out


def q4_matmul(
    x: torch.Tensor,
    qw: QWeight,
    out_dtype=torch.bfloat16,
    layer_idx: int | None = None,
) -> torch.Tensor:
    """y = x @ W for a packed QWeight. x: [..., K] (any leading dims).

    layer_idx: qw is STACKED ([L, K/2, N] / [L, G, N]) and layer `layer_idx`
    is used through views of the stacked planes (no copy). A CUDA x launches
    the kernel; a CPU x takes the plain version."""
    if not x.is_cuda:
        return q4_matmul_ref(x, qw, out_dtype, layer_idx)
    if layer_idx is not None:
        qw = qw.layer(layer_idx)
    if qw.layout != LAYOUT_ILV or qw.chunks != 1:
        raise NotImplementedError(
            f"q4_matmul: the CUDA kernel takes the ilv layout with one chunk "
            f"(got layout={qw.layout}, chunks={qw.chunks})"
        )
    lead = x.shape[:-1]
    xf = x.reshape(-1, qw.k).to(torch.bfloat16).contiguous()
    y = q4_matmul_cuda(xf, qw.packed, qw.scales)
    if qw.bias is not None:
        y = y + _bias_term(xf, qw)
    return y.to(out_dtype).reshape(*lead, qw.n)
