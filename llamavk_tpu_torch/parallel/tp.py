"""The sharded forward (twin of `llamavk_tpu/parallel/tp.py`).

JAX wraps `llama_forward` in `shard_map` over the mesh and jits it; here
every rank calls the returned function on its own shard, and the
collectives inside `llama_forward` (tp: all-reduce after `wo`/`w2`, the
logits all-gathered; pp: the stage-to-stage sends) and here (dp: the rows
gathered) join the ranks. The dp axis splits the batch rows of `tokens`;
every rank returns the full logits.
"""

from __future__ import annotations

import torch

from ..models.llama import KVCache, LlamaParams, ModelConfig, llama_forward
from . import comm
from .mesh import Mesh


def make_sharded_forward(
    cfg: ModelConfig,
    params: LlamaParams,
    mesh: Mesh,
    logits_all: bool = False,
    pp_microbatch: int = 1,
    quantized_kv: bool = False,
    ring_kv: bool = False,
):
    """Returns fn(params, tokens, cache, n_past) for this rank, the JAX
    signature (tp.py:21-57 there): params and cache are this rank's shards
    (`shard_params`, `shard_cache`), tokens the whole [B, T] batch (B
    divisible by the dp size; this rank runs rows [i·B/dp, (i+1)·B/dp)),
    n_past an int or a [B] vector. fn returns (logits [B, T or 1, n_vocab]
    f32, the updated cache shard, embeddings [B, n_embd]), logits and
    embeddings whole on every rank.

    pp_microbatch > 1 runs that many microbatches through the pp stages
    (`llama_forward`'s schedule); the per-rank batch must divide by it.
    quantized_kv says the cache is int8 (checked against the cache). A ring
    cache under a mesh (`ring_kv`) is not ported yet: NotImplementedError
    (ROADMAP.md queue 1)."""
    del params  # the JAX signature; the params arrive with each call
    if ring_kv:
        raise NotImplementedError("make_sharded_forward: a history ring under a mesh is not "
                                  "ported yet (ROADMAP.md queue 1)")
    tp_axis = mesh.axis("tp") if mesh.shape["tp"] > 1 else None
    pp_axis = mesh.axis("pp") if mesh.shape["pp"] > 1 else None
    dp_axis = mesh.axis("dp")
    dp = mesh.shape["dp"]

    def fn(params: LlamaParams, tokens, cache: KVCache, n_past):
        if cache.quantized != quantized_kv:
            raise ValueError(f"make_sharded_forward(quantized_kv={quantized_kv}) over a "
                             f"{'int8' if cache.quantized else 'bf16'} cache")
        if cache.ring:
            raise NotImplementedError("make_sharded_forward: a ring cache under a mesh is not "
                                      "ported yet (ROADMAP.md queue 1)")
        b = tokens.shape[0]
        if b % dp:
            raise ValueError(f"batch {b} does not split over dp = {dp}")
        rows = slice(dp_axis.index * (b // dp), (dp_axis.index + 1) * (b // dp))
        tok = tokens[rows].to(mesh.device)
        if isinstance(n_past, torch.Tensor) and n_past.dim() == 0:
            n_past = int(n_past)
        if not isinstance(n_past, int):
            n_past = n_past[rows].to(mesh.device)
        logits, cache, emb = llama_forward(
            params, tok, cache, n_past, cfg, logits_all=logits_all, tp_axis=tp_axis,
            pp_axis=pp_axis, pp_microbatch=pp_microbatch if pp_axis is not None else 1,
        )
        return comm.all_gather(logits, dp_axis, dim=0), cache, comm.all_gather(emb, dp_axis, dim=0)

    return fn
