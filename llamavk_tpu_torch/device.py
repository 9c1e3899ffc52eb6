"""Device selection shared by the port's entry points.

Every entry point takes a `device` and defaults to "cuda"; when CUDA is
missing it raises instead of running elsewhere, unless the caller asked for
the CPU (as the tests do).
"""

from __future__ import annotations

import torch


def resolve(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: pass device='cpu' to run the plain "
            "PyTorch versions of the kernels on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r} (cuda or cpu)")
    return dev
