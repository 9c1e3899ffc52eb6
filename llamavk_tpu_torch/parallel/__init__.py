"""Tensor, pipeline and data parallelism over `torch.distributed` (twin of
`llamavk_tpu/parallel/`): one process per rank, the body of a JAX
`shard_map` as ordinary per-rank code.

The names below load on first use: `models/llama.py` imports `comm` from
here, and `sharding`/`tp` import the model in turn.
"""

import importlib

_NAMES = {
    "Mesh": "mesh", "make_mesh": "mesh", "KIND_SPLIT": "sharding", "shard_cache": "sharding",
    "shard_params": "sharding", "make_sharded_forward": "tp",
}

__all__ = sorted(_NAMES)


def __getattr__(name: str):
    if name in _NAMES:
        return getattr(importlib.import_module(f".{_NAMES[name]}", __name__), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
