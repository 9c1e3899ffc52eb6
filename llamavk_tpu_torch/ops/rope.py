"""Rotary position embedding, adjacent-pair convention (twin of
`llamavk_tpu/ops/rope.py`).

Matches `ggml_compute_forward_rope_f32` mode 0: for pair index i0 (stepping
by 2 over the head dim), theta_i = 10000^(-i0/d), and (x0, x1) at positions
(i0, i0+1) rotate by angle p * theta_i, p the absolute token position. K is
rotated before it is cached, so cached K needs no re-rotation.

The pairwise form is the only one: the JAX package measured a
"lane-friendly" swap-pairs reformulation slower and, worse, flipping a q4_0
greedy near-tie against the compiled C reference (rope.py:9-22 there), so
the port keeps this exact graph shape for every path.
"""

from __future__ import annotations

import functools

import torch


@functools.cache
def _inv_freq(head_dim: int, theta_base: float, device: torch.device) -> torch.Tensor:
    """theta_base^(-i0/d) for the pair indices, computed on the CPU and kept
    on `device` (made once, so no decode step copies it from the host: a
    CUDA graph's capture refuses that copy)."""
    i0 = torch.arange(0, head_dim, 2, dtype=torch.float32)
    return torch.pow(torch.tensor(theta_base, dtype=torch.float32), -i0 / head_dim).to(device)


def rope_cos_sin(positions: torch.Tensor, head_dim: int, theta_base: float = 10000.0):
    """cos/sin tables for given positions. positions: [...] int → [..., d/2] f32."""
    ang = positions.to(torch.float32)[..., None] * _inv_freq(head_dim, theta_base,
                                                             positions.device)
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x: [..., T, H, D]; cos/sin: [..., T, D/2] broadcast over the head axis."""
    xf = x.to(torch.float32)
    x0 = xf[..., 0::2]
    x1 = xf[..., 1::2]
    c = cos[..., None, :]
    s = sin[..., None, :]
    y0 = x0 * c - x1 * s
    y1 = x0 * s + x1 * c
    y = torch.stack([y0, y1], dim=-1).reshape(x.shape)
    return y.to(x.dtype)
