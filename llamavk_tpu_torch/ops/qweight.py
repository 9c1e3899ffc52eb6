"""QWeight — the on-device packed 4-bit weight (torch twin of
`llamavk_tpu/ops/qweight.py`).

Nibbles stay packed two per int8 with the split-half scheme of
`formats/repack.py`; scales (and the optional Q4_1 bias) are separate
`[G, N]` planes. The GPU keeps the ilv byte plane as it is: weights carry
across from the JAX package by a plain copy, and the CUDA matmul reads the
interleaved rows directly (`ops/q4_matmul.py`). The TPU-only int4-plane
storage (`LAYOUT_I4` and its group padding) exists for Mosaic alignment rules
and has no counterpart here.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..formats.q4 import QK
from ..formats.repack import LAYOUT_ILV, PackedQ4, ilv_perm


@dataclass
class QWeight:
    packed: torch.Tensor  # int8 [(L,) K//2, N]
    scales: torch.Tensor  # bf16 [(L,) G, N]
    bias: torch.Tensor | None = None  # [(L,) G, N] (Q4_1) or None
    layout: str = LAYOUT_ILV
    chunks: int = 1

    @property
    def k(self) -> int:
        return 2 * self.packed.shape[-2]

    @property
    def n(self) -> int:
        return self.packed.shape[-1]

    @property
    def g(self) -> int:
        return self.scales.shape[-2]

    def layer(self, l: int) -> "QWeight":
        """Layer `l` of a stacked weight, as views (no copy)."""
        return QWeight(
            packed=self.packed[l],
            scales=self.scales[l],
            bias=None if self.bias is None else self.bias[l],
            layout=self.layout,
            chunks=self.chunks,
        )

    def chunk(self, c: int) -> "QWeight":
        """K chunk `c` of a weight packed in `chunks` slices, as a one-chunk
        weight of views: its packed rows, scale rows and bias rows."""
        half, gc = self.packed.shape[-2] // self.chunks, self.g // self.chunks
        return QWeight(
            packed=self.packed[..., c * half : (c + 1) * half, :],
            scales=self.scales[..., c * gc : (c + 1) * gc, :],
            bias=None if self.bias is None else self.bias[..., c * gc : (c + 1) * gc, :],
            layout=self.layout,
        )


def qweight_from_packed(
    p: PackedQ4, scale_dtype=torch.bfloat16, device="cuda"
) -> QWeight:
    def put(a, dtype=None):
        t = torch.from_numpy(np.ascontiguousarray(a))
        return t.to(device=device, dtype=dtype or t.dtype)

    return QWeight(
        packed=put(p.packed),
        scales=put(p.scales, scale_dtype),
        bias=None if p.bias is None else put(p.bias, scale_dtype),
        layout=p.layout,
        chunks=p.chunks,
    )


def dequantize_qweight(qw: QWeight, dtype=torch.float32) -> torch.Tensor:
    """Dense [K, N] matrix in original k order (ilv or lin layout, any
    chunk count) — `dequantize_qweight` of the JAX package (qweight.py:162)."""
    k, g = qw.k, qw.g
    kc = k // qw.chunks
    gc = g // qw.chunks
    dev = qw.packed.device
    outs = []
    for c in range(qw.chunks):
        p = qw.packed[c * kc // 2 : (c + 1) * kc // 2].to(torch.int32)
        lo = (p << 28) >> 28
        hi = p >> 4
        qs = torch.cat([lo, hi], dim=0).to(torch.float32)  # chunk storage order
        rows = torch.arange(kc, device=dev)
        if qw.layout == LAYOUT_ILV:
            scale_rows = c * gc + rows % gc
        else:
            scale_rows = c * gc + rows // QK
        w = qs * qw.scales.to(torch.float32)[scale_rows]
        if qw.bias is not None:
            w = w + qw.bias.to(torch.float32)[scale_rows]
        if qw.layout == LAYOUT_ILV:
            w = w[torch.from_numpy(np.argsort(ilv_perm(kc))).to(dev)]
        outs.append(w)
    return torch.cat(outs, dim=0).to(dtype)
