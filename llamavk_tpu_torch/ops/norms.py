"""RMSNorm, plain torch (twin of `llamavk_tpu/ops/norms.py`).

Math matches `ggml_compute_forward_rms_norm_f32` (eps = 1e-6) followed by the
elementwise weight multiply, computed in f32 and cast back to x's dtype.
"""

from __future__ import annotations

import torch

RMS_NORM_EPS = 1e-6


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = RMS_NORM_EPS) -> torch.Tensor:
    xf = x.to(torch.float32)
    mean_sq = torch.mean(xf * xf, dim=-1, keepdim=True)
    normed = xf * torch.rsqrt(mean_sq + eps)
    return (normed * weight.to(torch.float32)).to(x.dtype)
