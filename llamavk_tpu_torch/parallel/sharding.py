"""The tensor-parallel split table (twin of
`llamavk_tpu/parallel/sharding.py`), applied to whole params and caches to
cut this rank's shard.

The table is the checkpoint's split table (llama.cpp:276-287) as JAX's
sharding.py:27-40 states it:

  column-parallel (output/N axis over tp): wq, wk, wv, wqkv, w1, w3, w13,
      output
  row-parallel (contraction/K axis over tp, all-reduced after): wo, w2
  replicated: norms, tok_embeddings
  stacked layer tensors ([L, ...]): the layer axis over pp

A packed weight splits its packed, scale and bias planes on the same axis.
Row-parallel weights must be packed in chunks that tp divides
(`params_from_reader(tp=)`), so that a shard is whole chunks; the shard
keeps the global `chunks`, and `llama_forward` divides it by the tp size,
as llama.py:426-431 there does. Fused weights must be packed with their
columns interleaved per shard (`fuse_packed(parts, tp)`).
"""

from __future__ import annotations

from dataclasses import replace

import torch

from ..models.llama import FusedLayerParams, KVCache, LlamaParams, QEmbedding
from ..ops.qweight import QWeight
from .mesh import Mesh

# the axis of a weight [K, N] that tp splits: "col" (N), "row" (K) or None
KIND_SPLIT: dict[str, str | None] = {
    "wq": "col", "wk": "col", "wv": "col", "wqkv": "col",
    "w1": "col", "w3": "col", "w13": "col", "output": "col",
    "wo": "row", "w2": "row",
    "norm": None, "tok_embeddings": None,
}


def _part(t: torch.Tensor, dim: int, n: int, i: int) -> torch.Tensor:
    """Part i of n equal parts of t along dim."""
    if t.shape[dim] % n:
        raise ValueError(f"a tensor of {tuple(t.shape)} does not split {n} ways on dim {dim}")
    size = t.shape[dim] // n
    return t.narrow(dim, i * size, size)


def _put(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    return t.contiguous().to(mesh.device)


def _weight(w, kind: str, stacked: bool, mesh: Mesh):
    """This rank's shard of one weight: the layer axis over pp when stacked,
    then N (col) or K (row) over tp."""
    tp, pp = mesh.shape["tp"], mesh.shape["pp"]
    ti, pi = mesh.axis("tp").index, mesh.axis("pp").index
    split = KIND_SPLIT[kind]

    def cut(t: torch.Tensor) -> torch.Tensor:
        if stacked:
            t = _part(t, 0, pp, pi)
        if split == "col":
            t = _part(t, -1, tp, ti)
        elif split == "row":
            t = _part(t, -2, tp, ti)
        return _put(t, mesh)

    if isinstance(w, QWeight):
        if split == "row" and w.chunks % tp:
            raise ValueError(f"{kind}: packed in {w.chunks} chunks, which tp = {tp} does not "
                             f"divide (load it with tp={tp})")
        return replace(w, packed=cut(w.packed), scales=cut(w.scales),
                       bias=None if w.bias is None else cut(w.bias))
    return cut(w)


def shard_params(params: LlamaParams, mesh: Mesh) -> LlamaParams:
    """This rank's shard of whole params (on any device), on the mesh's
    device: the split table above."""
    pp, pi = mesh.shape["pp"], mesh.axis("pp").index
    lp = params.layers
    kinds = (("wqkv", "wo", "w13", "w2") if isinstance(lp, FusedLayerParams)
             else ("wq", "wk", "wv", "wo", "w1", "w2", "w3"))
    layers = replace(
        lp,
        attn_norm=_put(_part(lp.attn_norm, 0, pp, pi), mesh),
        ffn_norm=_put(_part(lp.ffn_norm, 0, pp, pi), mesh),
        **{kind: _weight(getattr(lp, kind), kind, True, mesh) for kind in kinds},
    )
    emb = params.tok_embeddings
    if isinstance(emb, QEmbedding):
        emb = replace(emb, packed=_put(emb.packed, mesh), scales=_put(emb.scales, mesh),
                      bias=None if emb.bias is None else _put(emb.bias, mesh))
    else:
        emb = _put(emb, mesh)
    return LlamaParams(tok_embeddings=emb, layers=layers, norm=_put(params.norm, mesh),
                       output=_weight(params.output, "output", False, mesh))


def shard_cache(cache: KVCache, mesh: Mesh, batch_axis: str | None = "dp") -> KVCache:
    """This rank's shard of a whole KV cache, on the mesh's device: data
    [L, B, H, S, D] with layers over pp, batch over dp (replicated when
    `batch_axis` is None) and heads over tp; int8 scale planes [L, B, S, H]
    the same, H on their last axis; a ring's position plane [S, B] over dp.
    The port's scale planes keep H (no lane pad), so the JAX package's
    `scale_lane_pad` (each tp shard padded to its own 128-lane tile, a TPU
    DMA rule) has nothing to do here."""
    pp, pi = mesh.shape["pp"], mesh.axis("pp").index
    tp, ti = mesh.shape["tp"], mesh.axis("tp").index
    dp, di = (mesh.shape["dp"], mesh.axis("dp").index) if batch_axis else (1, 0)

    def cut(t: torch.Tensor, head_dim: int) -> torch.Tensor:
        t = _part(_part(t, 0, pp, pi), 1, dp, di)
        return _put(_part(t, head_dim, tp, ti), mesh)

    planes = [cut(cache.k, 2), cut(cache.v, 2)]
    if cache.quantized:
        planes += [cut(cache.k_scale, 3), cut(cache.v_scale, 3)]
    pos = None if cache.pos is None else _put(_part(cache.pos, 1, dp, di), mesh)
    return KVCache(*planes, pos=pos)
