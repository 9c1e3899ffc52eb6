"""Per-row int8 KV-cache quantization (twin of `llamavk_tpu/ops/kv_quant.py`).

Symmetric absmax over the head_dim axis, one f32 scale per cached row (per
layer, batch, position, head):

  scale = max|x| * f32(1/127) (1 for an all-zero row),   q = round(x / scale) in [-127, 127]

The JAX package writes `max|x| / 127.0`, and XLA compiles that division by a
constant as a multiplication by its f32 reciprocal in every jitted program
(its kernels, its model and its engines; only an op-by-op call of
`quantize_rows` divides, and then a scale can differ by one ulp). The port
computes what the jitted programs compute. `x / scale` stays a true
division, as it does under XLA, and `torch.round` rounds half to even, as
`jnp.round` does, so the int8 bytes and the scales equal the JAX package's
bit for bit.

Layouts: data int8 [L, B, H, S, D] (the bf16 cache's layout), scales f32
[L, B, S, H]. The JAX package pads the scale planes' head axis to 128 lanes
for the TPU's DMA alignment; the port keeps H.
"""

from __future__ import annotations

import torch

INV_127 = torch.tensor(1.0 / 127.0, dtype=torch.float32)  # the f32 reciprocal XLA folds in


def quantize_rows(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x [..., D] -> (q int8 [..., D], scale f32 [...])."""
    xf = x.to(torch.float32)
    amax = xf.abs().amax(dim=-1)
    scale = torch.where(amax > 0, amax * INV_127, torch.ones_like(amax))
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127).to(torch.int8)
    return q, scale


def dequantize_rows(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """(q int8 [..., D], scale f32 [...]) -> f32 [..., D]."""
    return q.to(torch.float32) * scale[..., None].to(torch.float32)
