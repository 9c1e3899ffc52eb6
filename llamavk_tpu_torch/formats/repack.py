"""Device-side packed layout for Q4 weights (the TPU analog of Q4_0_SWZ).

The reference's Vulkan engine repacks disk Q4_0 blocks into a GPU-preferred
layout with scales and nibbles in separate planes and a swizzled block order
(`vulkan/llama-vk.cpp:887-904`, `vulkan/llama-vk.hlsl:1484-1589`). The TPU
analog defined here:

  A weight W used as ``y = x @ W`` with W of shape [K, N] (K = input/contraction
  dim — ggml's ne[0] "row" dim; N = output channels) becomes:

    packed : int8  [K//2, N]  — two signed 4-bit weights per byte
    scales : f32→bf16 [G, N]  — per-(32-wide K block, output channel), G = K//32
    bias   : optional [G, N]  — Q4_1 only: value = q4*d + bias with bias = m + 8d

  Two layouts for the K axis:

  * ``ilv`` (interleaved): storage row r holds original k = (r % G)*32 + (r // G).
    Consequence: the scale for every storage row r is ``scales[r % G]`` — so the
    in-kernel scale broadcast is a *tile* (concat of G-row copies, cheap
    ``pltpu.repeat``), never an element-wise repeat. Activations entering the
    kernel must be reordered to match: ``x.reshape(G, 32).T.reshape(-1)`` — a
    small static transpose XLA handles natively (see ``to_ilv``).

  * ``lin`` (linear): storage row r = original k. Scale for row r is
    ``scales[r // 32]`` — requires an element-wise ``jnp.repeat`` in-kernel.

  On top of either layout, nibbles are split-half packed: storage rows
  [0, K/2) live in the low nibble and rows [K/2, K) in the high nibble of
  ``packed``, so the kernel unpacks with two arithmetic shifts and no
  interleaving. Dequantized values are bit-identical to the disk format
  (same q, same scale per element — only summation order changes).

4.0 bits/weight for nibbles + 16/32 bits per 32 weights of scale — denser than
the reference's 36 B / 64 weights (4.5 bits/weight) device format.

Copy of `llamavk_tpu/formats/repack.py` (pure NumPy): the port keeps its own so
that it imports nothing from the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .q4 import QK

LAYOUT_ILV = "ilv"
# device-only storage form: a jnp.int4 plane [K_stor, N] (ilv row order with
# the per-chunk group count padded to a multiple of 128 — Mosaic int4 slices
# need 128-row alignment). Produced by ops.qweight.qweight_to_i4; never
# written to checkpoints.
LAYOUT_I4 = "i4st"
LAYOUT_LIN = "lin"


def ilv_perm(k: int, qk: int = QK) -> np.ndarray:
    """perm[r] = original index stored at interleaved row r."""
    g = k // qk
    r = np.arange(k)
    return (r % g) * qk + r // g


def ilv_inv_perm(k: int, qk: int = QK) -> np.ndarray:
    """inv[orig] = interleaved row where original index orig is stored."""
    p = ilv_perm(k, qk)
    inv = np.empty_like(p)
    inv[p] = np.arange(k)
    return inv


@dataclass
class PackedQ4:
    """Host-side (NumPy) packed q4 weight; device arrays are built from this."""

    packed: np.ndarray  # int8 [K//2, N]
    scales: np.ndarray  # f32  [G, N]
    bias: np.ndarray | None  # f32 [G, N] or None (Q4_0)
    k: int
    n: int
    layout: str = LAYOUT_ILV
    chunks: int = 1  # number of independently-packed contiguous K slices

    @property
    def g(self) -> int:
        return self.k // QK


def _split_half_pack(qs: np.ndarray) -> np.ndarray:
    """[K, N] signed int8 in [-8, 7] → [K//2, N] bytes (lo = first half rows)."""
    k = qs.shape[0]
    lo = qs[: k // 2]
    hi = qs[k // 2 :]
    return ((lo & 0xF) | (hi << 4)).astype(np.int8)


def _split_half_unpack(packed: np.ndarray) -> np.ndarray:
    """Inverse of _split_half_pack → [K, N] signed int8."""
    p = packed.astype(np.int32)
    lo = (p << 28) >> 28
    hi = p >> 4
    return np.concatenate([lo, hi], axis=0).astype(np.int8)


def pack_q4(
    qs_signed: np.ndarray,
    scales: np.ndarray,
    bias: np.ndarray | None = None,
    layout: str = LAYOUT_ILV,
    chunks: int = 1,
) -> PackedQ4:
    """Pack signed nibbles [K, N] (blocks of 32 along K) + scales [G, N].

    `chunks` > 1 packs each of the `chunks` contiguous K-slices independently
    (its own interleave + split-half), so the packed rows/scales shard cleanly
    along dim 0 into `chunks` tensor-parallel pieces — the packing analog of
    the checkpoint's row-split table (llama_internal.h:37-41). The scales
    array keeps the original global group order either way.
    """
    k, n = qs_signed.shape
    g = k // QK
    assert scales.shape == (g, n), (scales.shape, g, n)
    kc = k // chunks
    assert kc % (2 * QK) == 0, (k, chunks)
    parts = []
    for c in range(chunks):
        qc = qs_signed[c * kc : (c + 1) * kc]
        if layout == LAYOUT_ILV:
            qc = qc[ilv_perm(kc)]
        parts.append(_split_half_pack(qc.astype(np.int8)))
    return PackedQ4(
        packed=np.concatenate(parts, axis=0),
        scales=np.asarray(scales, np.float32),
        bias=None if bias is None else np.asarray(bias, np.float32),
        k=k,
        n=n,
        layout=layout,
        chunks=chunks,
    )


def unpack_q4(p: PackedQ4) -> np.ndarray:
    """Dequantize a PackedQ4 back to f32 [K, N] in original k order (test aid)."""
    kc = p.k // p.chunks
    gc = kc // QK
    outs = []
    for c in range(p.chunks):
        qs = _split_half_unpack(p.packed[c * kc // 2 : (c + 1) * kc // 2]).astype(
            np.float32
        )  # [Kc, N] storage order within the chunk
        rows = np.arange(kc)
        if p.layout == LAYOUT_ILV:
            scale_rows = c * gc + rows % gc
        else:
            scale_rows = c * gc + rows // QK
        w = qs * p.scales[scale_rows]
        if p.bias is not None:
            w = w + p.bias[scale_rows]
        if p.layout == LAYOUT_ILV:
            out = np.empty_like(w)
            out[ilv_perm(kc)] = w
            w = out
        outs.append(w)
    return np.concatenate(outs, axis=0)


def repack_q4_0(
    d: np.ndarray, q: np.ndarray, layout: str = LAYOUT_ILV, chunks: int = 1
) -> PackedQ4:
    """From checkpoint blocks (d [N, G], q [N, G, QK] raw nibbles) to device layout.

    Checkpoint tensors are stored per output row (ggml row-major, row = one
    output channel's K weights); the device layout is K-major ([K, N]).
    """
    n, g, qk = q.shape
    assert qk == QK
    qs = (q.astype(np.int16) - 8).astype(np.int8).reshape(n, g * qk).T  # [K, N]
    scales = np.asarray(d, np.float32).T  # [G, N]
    return pack_q4(qs, scales, None, layout, chunks)


def repack_q4_1(
    d: np.ndarray, m: np.ndarray, q: np.ndarray, layout: str = LAYOUT_ILV, chunks: int = 1
) -> PackedQ4:
    """Q4_1: value = q*d + m = (q-8)*d + (m + 8*d) → signed nibbles + bias plane."""
    n, g, qk = q.shape
    assert qk == QK
    qs = (q.astype(np.int16) - 8).astype(np.int8).reshape(n, g * qk).T
    scales = np.asarray(d, np.float32).T
    bias = (np.asarray(m, np.float32) + 8.0 * np.asarray(d, np.float32)).T
    return pack_q4(qs, scales, bias, layout, chunks)


def repack_dense(w: np.ndarray) -> np.ndarray:
    """Dense (f16/f32) weight [N, K] from checkpoint → [K, N] f32 for device."""
    return np.ascontiguousarray(np.asarray(w, np.float32).T)


def _interleave_cols(arrs: list[np.ndarray], tp: int) -> np.ndarray:
    """Concatenate along the last axis, interleaving per-tp-shard segments:
    result columns = [a0_s0 | a1_s0 | ... | a0_s1 | a1_s1 | ...] so that a
    'tp'-way shard of the result holds each source's matching shard."""
    if tp == 1:
        return np.concatenate(arrs, axis=-1)
    segs = []
    for s in range(tp):
        for a in arrs:
            n = a.shape[-1]
            assert n % tp == 0, (n, tp)
            seg = n // tp
            segs.append(a[..., s * seg : (s + 1) * seg])
    return np.concatenate(segs, axis=-1)


def fuse_packed(parts: list[PackedQ4], tp: int = 1) -> PackedQ4:
    """Fuse column-parallel weights (e.g. wq|wk|wv or w1|w3) into one packed
    matmul along N — one Pallas dispatch instead of several."""
    p0 = parts[0]
    assert all(p.k == p0.k and p.layout == p0.layout and p.chunks == p0.chunks
               for p in parts)
    has_bias = any(p.bias is not None for p in parts)
    if has_bias:
        assert all(p.bias is not None for p in parts), "cannot fuse q4_0 with q4_1"
    return PackedQ4(
        packed=_interleave_cols([p.packed for p in parts], tp),
        scales=_interleave_cols([p.scales for p in parts], tp),
        bias=_interleave_cols([p.bias for p in parts], tp) if has_bias else None,
        k=p0.k,
        n=sum(p.n for p in parts),
        layout=p0.layout,
        chunks=p0.chunks,
    )
