"""Capability report of the port (twin of `system_info` in
`llamavk_tpu/utils/trace.py`). The JAX module's profiler regions and counters
are not ported yet (ROADMAP.md queue 1)."""

from __future__ import annotations


def system_info() -> str:
    """Capability one-liner (llama_print_system_info / ggml_cpu_has_* analog):
    the torch and CUDA versions, the platform (cuda when a card is visible,
    else cpu), the device count and name, and the NumPy version."""
    import numpy as np
    import torch

    cuda = torch.cuda.is_available()
    parts = [
        f"torch = {torch.__version__}",
        f"cuda = {torch.version.cuda or 0}",
        f"platform = {'cuda' if cuda else 'cpu'}",
    ]
    if cuda:
        parts.append(f"devices = {torch.cuda.device_count()} x {torch.cuda.get_device_name(0)}")
    else:
        parts.append("devices = 1 x cpu")
    parts.append(f"numpy = {np.__version__}")
    return " | ".join(parts)
