"""The unpack probes' kernel (`csrc/probe_q4_unpack.cu`) and its plain
versions, shared by P1 (`bench_unpack_trick`), P3 (`bench_unpack2`) and P4
(`bench_i4_stacked`).

A variant is an unpack over a storage, with the multiply type:

  shift / trick / i8shift   the ilv byte plane [(L,) K/2, N] (K1's bytes)
  int4                      the int4 plane [(L,) G, 4, N] int32 words
                            (`repack_int4`)
  bitcast4                  the int4 plane's kernel on the byte plane's
                            bytes as they lie (`bitcast_view`)

Every one computes y = x @ W with W[k, n] = bf16(f32(q) * s) (s rounded to
bf16 first under the bf16 multiply), x bf16 [M, K] in original k order,
products summed in f32, out f32 [M, N]. `gemv` launches the kernel for CUDA
tensors (M = 1..8) and takes the plain version for CPU tensors; `stacked`
planes carry a leading layer dim and a device int32 index selects the layer,
read by the kernel. The plain weights are exact: the card's are checked bit
for bit against them (`dequant`).
"""

from __future__ import annotations

import torch

from ..ops import _build
from ..ops.q4_matmul import _nibbles
from . import _common
from ._common import QK

# the kernel's unpack codes and flag bits (probe_unpack_launch)
SHIFT, TRICK, I8SHIFT, PLANE = 0, 1, 2, 3
_F32S, _MULB, _STACKED = 1, 2, 4
BYTE_UNPACKS = {"shift": SHIFT, "trick": TRICK, "i8shift": I8SHIFT}

# launches of the kernels, one per wrapper call on CUDA tensors, by probe
# and variant as the probes print them
launches = {name: 0 for name in (
    "p1_current", "p1_trick", "p3_cur", "p3_i8shift", "p3_i8shift16", "p3_int4", "p3_int4f32",
    "p3_bitcast4", "p3_bitcast4f32", "p3_perm", "p4_prod", "p4_i4st", "p4_i4st_bf16")}

_SIGS = (("probe_unpack_launch", "ppppppiiiiiip"), ("probe_dequant_launch", "pppiiiip"),
         ("probe_perm_launch", "ppiip"))


def _lib():
    return _common.lib("probe_q4_unpack", _SIGS)


def byte_weights(packed: torch.Tensor, scales: torch.Tensor, mul_bf16: bool = False):
    """The byte plane's weights [K, N] f32 (bf16 values) in k order: the
    nibbles of `ops.q4_matmul._nibbles`, times the scale in f32 (rounded to
    bf16 first under the bf16 multiply), rounded to bf16."""
    g, n = scales.shape
    s = scales.to(torch.bfloat16) if mul_bf16 else scales
    q = _nibbles(packed, g).to(torch.float32)  # [32, G, N], element m of group g
    w = q * s.to(torch.float32)[None]
    return w.to(torch.bfloat16).to(torch.float32).permute(1, 0, 2).reshape(g * QK, n)


def plane_nibbles(plane: torch.Tensor) -> torch.Tensor:
    """The int4 plane [G, 4, N] int32 words -> signed nibbles [K, N] int32:
    nibble j of word (g, j4, n) is k = g*32 + 8*j4 + j."""
    g, _, n = plane.shape
    shifts = 4 * torch.arange(8, device=plane.device, dtype=torch.int32)
    q = (plane[:, :, None, :] >> shifts[None, None, :, None]) & 15  # [G, 4, 8, N]
    q = torch.where(q >= 8, q - 16, q)
    return q.reshape(g * QK, n)


def plane_weights(plane: torch.Tensor, scales: torch.Tensor, mul_bf16: bool = False):
    """The int4 plane's weights [K, N] f32 (bf16 values), as `byte_weights`."""
    s = scales.to(torch.bfloat16) if mul_bf16 else scales
    q = plane_nibbles(plane).to(torch.float32)
    w = q * torch.repeat_interleave(s.to(torch.float32), QK, dim=0)
    return w.to(torch.bfloat16).to(torch.float32)


def repack_int4(packed: torch.Tensor) -> torch.Tensor:
    """The ilv byte plane [(L,) K/2, N] -> the int4 plane [(L,) G, 4, N]
    int32 words of the same weights (module docstring of the kernel): one
    word holds 8 consecutive k of one column, so it takes one scale and
    unpacks in nibble pairs (j, j + 4) by one shift and one mask."""
    if packed.dim() == 3:
        return torch.stack([repack_int4(p) for p in packed])
    half, n = packed.shape
    g = 2 * half // QK
    q = _nibbles(packed, g).permute(1, 0, 2).reshape(g, 4, 8, n) & 15  # [G, j4, j, N]
    return _pack_words(q, 4 * torch.arange(8, device=packed.device))


def _pack_words(q: torch.Tensor, shifts: torch.Tensor) -> torch.Tensor:
    """Nibbles [G, 4, 8, N] (0..15) -> int32 words [G, 4, N], nibble j at
    bits 4j (the top nibble carries the sign bit of the int32)."""
    words = (q.to(torch.int64) << shifts.to(torch.int64)[None, None, :, None]).sum(dim=2)
    words = torch.where(words >= 2**31, words - 2**32, words)
    return words.to(torch.int32)


def bitcast_view(packed: torch.Tensor) -> torch.Tensor:
    """The byte plane's bytes as they lie, read as int4-plane words [(L,)
    G, 4, N] (little-endian 32-bit words): BITCAST4's weights."""
    *lead, half, n = packed.shape
    g = 2 * half // QK
    return packed.contiguous().view(torch.int32).reshape(*lead, g, 4, n)


def bitcast_perm(k: int, n: int) -> torch.Tensor:
    """Where BITCAST4 finds weight (k, n): [K, N, 3] int64 of (byte row,
    column, 0 for the low nibble or 1 for the high one) of the byte plane
    [K/2, N]. Word (g, j4, c) of the view is bytes 4w..4w+3 of the plane,
    w = (g*4 + j4)*N + c, and nibble j of it is byte 4w + j//2's low (j
    even) or high (j odd) nibble."""
    kk = torch.arange(k)[:, None]
    cc = torch.arange(n)[None, :]
    g, r = kk // QK, kk % QK
    j4, j = r // 8, r % 8
    off = 4 * ((g * 4 + j4) * n + cc) + j // 2
    return torch.stack(torch.broadcast_tensors(off // n, off % n, j % 2), dim=-1)


def pack_bytes(q: torch.Tensor) -> torch.Tensor:
    """Signed nibbles [K, N] in k order -> the ilv byte plane [K/2, N]
    holding them (byte row m*G + g: k = g*32 + m low, + 16 high)."""
    k, n = q.shape
    g = k // QK
    qq = q.to(torch.int32).reshape(g, 2, QK // 2, n)  # [g, half, m, n]
    lo, hi = qq[:, 0].transpose(0, 1), qq[:, 1].transpose(0, 1)  # [m, g, n]
    byte = (lo & 15) | ((hi & 15) << 4)
    byte = torch.where(byte >= 128, byte - 256, byte)
    return byte.reshape(g * QK // 2, n).to(torch.int8)


def weights(plane: torch.Tensor, scales: torch.Tensor, storage: str,
            mul_bf16: bool) -> torch.Tensor:
    """The plain weights of a storage ("bytes", "plane" or "bitcast")."""
    if storage == "bytes":
        return byte_weights(plane, scales, mul_bf16)
    if storage == "bitcast":
        plane = bitcast_view(plane)
    return plane_weights(plane, scales, mul_bf16)


def gemv_ref(x, plane, scales, storage: str, mul_bf16: bool = False, layer=None):
    """Plain version of `gemv`: x cast to bf16, products of the weights in
    f32 (layer `layer` of a stack)."""
    if layer is not None:
        plane, scales = plane[layer], scales[layer]
    return x.to(torch.bfloat16).to(torch.float32) @ weights(plane, scales, storage, mul_bf16)


def gemv(name: str, x: torch.Tensor, plane: torch.Tensor, scales: torch.Tensor,
         storage: str, unpack: str = "shift", mul_bf16: bool = False,
         idx: torch.Tensor | None = None) -> torch.Tensor:
    """y = x @ W for the variant `name` (its key in `launches`): `storage`
    "bytes" (unpack shift, trick or i8shift), "plane" or "bitcast". A
    stacked plane takes `idx`, a one-element int32 tensor on the plane's
    device that names the layer (the kernel reads it on the card). CUDA
    tensors launch the kernel, CPU tensors take `gemv_ref`."""
    stacked = idx is not None
    if not x.is_cuda:
        return gemv_ref(x, plane, scales, storage, mul_bf16, int(idx[0]) if stacked else None)
    m, k = x.shape
    n = plane.shape[-1]
    g = k // QK
    if storage == "bytes":
        want = (g * QK // 2, n)
        code = BYTE_UNPACKS[unpack]
    else:
        want = (g, 4, n)
        code = PLANE
        if storage == "bitcast":
            plane = bitcast_view(plane)
    lead = tuple(plane.shape[:-len(want)])
    if (x.dtype != torch.bfloat16 or plane.shape[-len(want):] != want
            or scales.shape[-2:] != (g, n) or lead != tuple(scales.shape[:-2])
            or len(lead) != int(stacked) or not 1 <= m <= 8 or k % QK or n % 4):
        raise ValueError(f"probe {name}: x {tuple(x.shape)} plane {tuple(plane.shape)} scales "
                         f"{tuple(scales.shape)} (M 1..8, K % 32, N % 4, a layer dim with idx)")
    _common.require_cuda(f"probe {name}", x, plane, scales)
    if stacked and (idx.dtype != torch.int32 or idx.device != x.device or idx.numel() != 1):
        raise ValueError(f"probe {name}: the layer index is one int32 on the card")
    flags = (_F32S * (scales.dtype == torch.float32) | _MULB * mul_bf16
             | _STACKED * stacked)
    dev = x.device.index if x.device.index is not None else torch.cuda.current_device()
    ks = _common.ksplit(g, n, 128, dev, 40960 // (m * QK * 2))
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    partial = torch.empty((ks, m, n), dtype=torch.float32, device=x.device) if ks > 1 else out
    rc = _lib().probe_unpack_launch(
        x.data_ptr(), plane.data_ptr(), scales.data_ptr(), idx.data_ptr() if stacked else None,
        out.data_ptr(), partial.data_ptr(), m, k, n, ks, code, flags, _common.stream(x))
    _build.check(rc, f"probe_unpack_launch ({name})")
    launches[name] += 1
    return out


def dequant(plane: torch.Tensor, scales: torch.Tensor, storage: str, unpack: str = "shift",
            mul_bf16: bool = False) -> torch.Tensor:
    """The weights bf16 [K, N] that `gemv`'s kernel multiplies, written by
    the kernel's own unpack (a check, not a probe: no launch is counted);
    CPU tensors give the plain weights."""
    if not plane.is_cuda:
        return weights(plane, scales, storage, mul_bf16).to(torch.bfloat16)
    g, n = scales.shape
    code = BYTE_UNPACKS[unpack] if storage == "bytes" else PLANE
    if storage == "bitcast":
        plane = bitcast_view(plane)
    _common.require_cuda("probe dequant", plane, scales)
    w = torch.empty((g * QK, n), dtype=torch.bfloat16, device=plane.device)
    flags = _F32S * (scales.dtype == torch.float32) | _MULB * mul_bf16
    rc = _lib().probe_dequant_launch(plane.data_ptr(), scales.data_ptr(), w.data_ptr(), g * QK,
                                     n, code, flags, _common.stream(plane))
    _build.check(rc, "probe_dequant_launch")
    return w


def perm_ref(p: torch.Tensor) -> torch.Tensor:
    """Plain version of `perm`: bytes [S, L] read as the int4 plane of 2S
    rows, f32 [2S, L] of the signed nibble taken for each (k, n)."""
    return plane_nibbles(bitcast_view(p)).to(torch.float32)


def perm(p: torch.Tensor) -> torch.Tensor:
    """P3's permutation probe on the card (S % 16 == 0), `perm_ref` on the
    CPU."""
    if not p.is_cuda:
        return perm_ref(p)
    s, l = p.shape
    if p.dtype != torch.int8 or s % 16:
        raise ValueError(f"probe perm: int8 [S, L] with S % 16 == 0, got {p.dtype} {tuple(p.shape)}")
    _common.require_cuda("probe perm", p)
    out = torch.empty((2 * s, l), dtype=torch.float32, device=p.device)
    rc = _lib().probe_perm_launch(p.data_ptr(), out.data_ptr(), s, l, _common.stream(p))
    _build.check(rc, "probe_perm_launch")
    launches["p3_perm"] += 1
    return out
