"""LLaMA forward pass in PyTorch (twin of `llamavk_tpu/models/llama.py`).

Mirrors the reference graph:

  x = embed(tokens)
  per layer:  h  = x + wo @ attn(rope(wq·rms(x)·attn_norm), ...)
              x  = h + w2 @ (silu(w1·rms(h)·ffn_norm) * (w3·rms(h)·ffn_norm))
  logits = output @ (rms(x) · norm)

Layer weights are stacked over a leading n_layer dim; a layer's weights are
views of the stacked planes, never copies. K is RoPE'd before caching. The
KV cache `[L, B, H, S, D]` (flat; bf16, int8 with per-row f32 scales, or
f32) is updated IN PLACE: the JAX package threads it through `lax.scan` and
gets the same effect by buffer aliasing. `n_past` may be a per-row vector
(continuous batching). A paged pool `[L, NP, H, PS, D]`
(`init_paged_kv_cache`) is addressed through a block table (`page_table`);
with `page_straddle` its multi-token writes may start anywhere in a page and
run into the next (the speculative verify). Every packed matmul goes through
`q4_matmul`, whose dot mode (LLAMAVK_Q4_DOT) picks K1 or K5.

A history-ring cache (`init_kv_cache(ring=True)`, `ring_keep`) keeps the
logical position of each physical row in `KVCache.pos`: writes land at
`ring_phys(n_past)` and attention masks by position, so generation runs past
n_ctx with no re-evaluation. A shared-prefix pool (`prefix_kv`) holds
prompt prefixes once for every row: row b attends over entry
`prefix_id[b]`'s first `prefix_len[b]` rows, then over its own cache, which
holds only the suffix (its rows are n_past - prefix_len).

Tensor and pipeline parallelism (llama.py:386-389, :421-431, :704-725,
:737-856 there): `llama_forward` sees one rank's shard (`parallel/`), and
its axes are `parallel.comm.Axis` objects where JAX names mesh axes. Under
`tp_axis` the weights are Megatron shards: local heads n_head / tp, the
row-parallel `wo`/`w2` products summed in f32 over the axis (an
all-reduce; packed weights divide their `chunks` by the tp size), and the
vocab-sharded logits all-gathered. Under `pp_axis` stage s holds layers
[s·Ll, (s+1)·Ll) and their cache rows; with `pp_microbatch` M > 1 the batch
splits into M microbatches of b0 rows, each run against the full-batch cache
at cache_batch_offset + m·b0 (the kernels' `batch_offset`), and the final
activations go from the last stage to every stage, as the JAX psum sends
them, for the norm and the logits.

The pp schedule differs from the JAX one on purpose. JAX runs M + P - 1
lockstep waves on every stage, and a stage's idle waves compute with
`commit=False`, because one SPMD program must. A rank here computes a
microbatch only when it holds one: it receives it from the stage before,
runs its layers once, and sends it on. Each microbatch's rows are still
committed exactly once and the logits are the same; no idle wave launches a
kernel (ROADMAP.md queue 3). Under pp a T = 1 step takes the update kernel
(K2), never K4, as the JAX routing does (llama.py:571-573). pp with a page
table, a prefix pool or a ring raises, as llama.py:447, :455 there do for
the first two.

The ggml numerics oracle raises NotImplementedError.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, replace

import torch

from ..formats.ggml_io import Hparams
from ..ops.flash_attn import (
    attention_ref,
    flash_attention,
    flash_attention_ref,
    flash_attention_update,
    flash_attention_update_ref,
    write_rows,
)
from ..ops.flash_decode import flash_decode_update, flash_decode_update_ref
from ..ops.kv_quant import dequantize_rows
from ..ops.norms import rms_norm
from ..ops.q4_matmul import q4_matmul
from ..ops.qweight import QWeight
from ..ops.rope import apply_rope, rope_cos_sin
from ..parallel import comm


@dataclass(frozen=True)
class ModelConfig:
    n_vocab: int
    n_embd: int
    n_layer: int
    n_head: int
    n_rot: int
    n_ff: int
    norm_eps: float = 1e-6
    rope_theta: float = 10000.0

    @property
    def head_dim(self) -> int:
        return self.n_embd // self.n_head

    @classmethod
    def from_hparams(cls, hp: Hparams) -> "ModelConfig":
        return cls(
            n_vocab=hp.n_vocab,
            n_embd=hp.n_embd,
            n_layer=hp.n_layer,
            n_head=hp.n_head,
            n_rot=hp.n_rot,
            n_ff=hp.n_ff,
        )

    # model-size names from n_layer, llama.cpp:773-779
    @property
    def type_name(self) -> str:
        return {32: "7B", 40: "13B", 60: "30B", 80: "65B"}.get(self.n_layer, "custom")


Weight = QWeight | torch.Tensor  # a linear layer's weight: packed q4 or dense [(L,) K, N]


@dataclass
class QEmbedding:
    """Q4-quantized embedding table: per-token-row nibbles + scales.

    packed: int8 [V, K//2] (split-half along the embedding dim, linear order),
    scales: [V, G]; bias: optional [V, G] (Q4_1)."""

    packed: torch.Tensor
    scales: torch.Tensor
    bias: torch.Tensor | None
    k: int = 0


Embedding = QEmbedding | torch.Tensor  # dense [V, K] or quantized


@dataclass
class LayerParams:
    attn_norm: torch.Tensor  # [L, n_embd]
    wq: Weight
    wk: Weight
    wv: Weight
    wo: Weight
    ffn_norm: torch.Tensor  # [L, n_embd]
    w1: Weight  # gate  [n_embd, n_ff]
    w2: Weight  # down  [n_ff, n_embd]
    w3: Weight  # up    [n_embd, n_ff]


@dataclass
class FusedLayerParams:
    """wq/wk/wv concatenated into one [K, 3E] weight and w1/w3 into [K, 2F]:
    two matmul launches fewer per layer."""

    attn_norm: torch.Tensor
    wqkv: Weight  # [n_embd, 3*n_embd]
    wo: Weight
    ffn_norm: torch.Tensor
    w13: Weight  # [n_embd, 2*n_ff] (gate | up)
    w2: Weight


@dataclass
class LlamaParams:
    tok_embeddings: Embedding
    layers: LayerParams | FusedLayerParams  # every tensor has a leading n_layer dim
    norm: torch.Tensor
    output: Weight


@dataclass
class KVCache:
    """Dense per-layer KV slabs [L, B, H, S, D], heads-major, bf16, int8 or
    f32.
    An int8 cache carries one f32 scale per (layer, batch, position, head)
    row in k_scale/v_scale [L, B, S, H] (`ops/kv_quant.py`). A page pool has
    the same fields with pages in place of batch rows: [L, NP, H, PS, D] and
    scales [L, NP, PS, H]. Updated in place by `llama_forward`."""

    k: torch.Tensor
    v: torch.Tensor
    k_scale: torch.Tensor | None = None
    v_scale: torch.Tensor | None = None
    pos: torch.Tensor | None = None  # [S, B] int32 history-ring positions, -1 = empty

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None

    @property
    def ring(self) -> bool:
        return self.pos is not None

    def planes(self) -> list[torch.Tensor]:
        """Every data and scale tensor of the cache: k, v, and the scale
        planes if int8 (not the ring's position plane)."""
        return [self.k, self.v] + ([self.k_scale, self.v_scale] if self.quantized else [])

    def clone(self) -> "KVCache":
        return KVCache(*(p.clone() for p in self.planes()),
                       pos=None if self.pos is None else self.pos.clone())


def init_kv_cache(
    cfg: ModelConfig, batch: int, max_len: int, dtype=torch.bfloat16, device="cuda",
    ring: bool = False, n_head_local: int | None = None,
) -> KVCache:
    """A zeroed bf16, int8 or f32 cache. The JAX package pads an int8
    cache's scale planes to 128 head lanes (llama.py:161-168 there), a TPU
    DMA rule; here they keep H. `ring` adds the history ring's position
    plane [max_len, batch], every row empty (-1; llama.py:200-204 there),
    over a cache of any of the three types. `n_head_local` gives a
    tensor-parallel rank's cache its heads (n_head / tp)."""
    if dtype not in (torch.bfloat16, torch.int8, torch.float32):
        raise NotImplementedError(f"KV cache dtype {dtype}: bf16, int8 or f32")
    h = cfg.n_head if n_head_local is None else n_head_local
    shape = (cfg.n_layer, batch, h, max_len, cfg.head_dim)
    planes = [torch.zeros(shape, dtype=dtype, device=device) for _ in range(2)]
    if dtype == torch.int8:
        sshape = (cfg.n_layer, batch, max_len, h)
        planes += [torch.zeros(sshape, dtype=torch.float32, device=device) for _ in range(2)]
    pos = torch.full((max_len, batch), -1, dtype=torch.int32, device=device) if ring else None
    return KVCache(*planes, pos=pos)


def init_paged_kv_cache(
    cfg: ModelConfig, n_pages: int, page_size: int, dtype=torch.bfloat16, device="cuda"
) -> KVCache:
    """A zeroed page pool [L, NP, H, PS, D] (llama.py:200-229 there), bf16,
    f32, or int8 with scale pools [L, NP, PS, H] paged through the same
    tables (H kept, no 128-lane pad, as `init_kv_cache`). The page's rows
    must be a multiple of 8, and of 32 for int8 (the KV block step)."""
    if dtype not in (torch.bfloat16, torch.int8, torch.float32):
        raise NotImplementedError(f"KV pool dtype {dtype}: bf16, int8 or f32")
    step = 32 if dtype == torch.int8 else 8
    if page_size % step:
        raise ValueError(f"page_size {page_size} must be a multiple of {step} for {dtype}")
    return init_kv_cache(cfg, n_pages, page_size, dtype, device)


def ring_phys(pos, n_keep: int, s: int):
    """Logical position -> physical ring row (llama.py:232-239 there): the
    first fill is the identity; past the end, rows [n_keep, s) recycle and
    the first n_keep rows stay pinned. `pos` is an int or an int tensor."""
    span = max(s - n_keep, 1)
    if isinstance(pos, int):
        return pos if pos < s else n_keep + (pos - n_keep) % span
    return torch.where(pos < s, pos, n_keep + torch.remainder(pos - n_keep, span))


def _linear(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Dense weight [K, N]: product in f32 of x cast to w's dtype, back to x's."""
    xw = x.to(w.dtype).to(torch.float32)
    return (xw @ w.to(torch.float32)).to(x.dtype)


def embed_tokens(emb: Embedding, tokens: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    """tokens [B, T] → activations [B, T, n_embd]."""
    if isinstance(emb, QEmbedding):
        p = emb.packed[tokens].to(torch.int32)  # [B, T, K//2]
        lo = (p << 28) >> 28
        hi = p >> 4
        qs = torch.cat([lo, hi], dim=-1).to(torch.float32)  # [B, T, K]
        s = torch.repeat_interleave(emb.scales[tokens].to(torch.float32), 32, dim=-1)
        # linear layout: element order after concat is [0..K/2) ++ [K/2..K)
        x = qs * s
        if emb.bias is not None:
            x = x + torch.repeat_interleave(emb.bias[tokens].to(torch.float32), 32, dim=-1)
        return x.to(dtype)
    return emb[tokens].to(dtype)


def _attention(q, k_cache, v_cache, n_past, k_scale=None, v_scale=None,
               kv_pos=None) -> torch.Tensor:
    """Causal attention of T new queries against the updated cache layer
    [B, H, S, D]: the einsum numerics oracle (llama.py:266 there). An int8
    layer is dequantized to f32 with its [B, S, H] scales first; a ring
    masks by its position plane [S, B]."""
    if k_scale is not None:
        k_cache = dequantize_rows(k_cache, k_scale.transpose(1, 2))
        v_cache = dequantize_rows(v_cache, v_scale.transpose(1, 2))
    return attention_ref(q, k_cache, v_cache, n_past, kv_pos=kv_pos)


def llama_forward(
    params: LlamaParams,
    tokens: torch.Tensor,  # [B, T] int
    cache: KVCache,
    n_past,  # int, or an int32 [B] tensor of per-row positions
    cfg: ModelConfig,
    logits_all: bool = False,
    dtype=torch.bfloat16,
    attn_impl: str = "auto",
    last_idx=None,
    kv_block: int | None = None,
    use_ref: bool = False,
    ring_keep: int = 0,
    prefix_kv=None,
    prefix_id=None,
    prefix_len=None,
    page_table=None,
    page_straddle: bool = False,
    tp_axis: comm.Axis | None = None,
    pp_axis: comm.Axis | None = None,
    pp_microbatch: int = 1,
    cache_batch_offset: int | None = None,
    ggml_rounding=None,
) -> tuple[torch.Tensor, KVCache, torch.Tensor]:
    """Evaluate T new tokens. Returns (logits, cache, embeddings); the cache
    is the one passed in, updated in place.

    logits: [B, T, n_vocab] f32 if logits_all else [B, 1, n_vocab] (the last
    position, or `last_idx` when the caller bucket-padded T: an int, or a [B]
    vector of per-row positions for a batched admission prefill).
    embeddings: [B, n_embd] f32 — final-norm activations of that position.

    attn_impl: "auto"/"flash" = the fused attention kernels, with the
    dispatch of llama.py:571-687 there: the batched decode kernel when
    T == 1 and B > 1; else the update kernel when T % min(256, T) == 0; else
    a plain row write (int8: quantized) and the read kernel. "einsum" = the
    dense oracle.
    kv_block pins the attention's KV block (default 512 for T >= 256, else
    256, as llama.py:499 there). use_ref runs the plain versions of every
    kernel on any device, each matmul on the plain version of the route its
    dot mode takes: the kernel-vs-plain comparison on the card.

    page_table (int32 [B, MAXLB] on the cache's device): the cache is a page
    pool and row b's logical block j lives in page page_table[b, j]
    (llama.py:440-448, 553-630 there). Flash only, and only on the fused
    routes: K4 when T == 1 and B > 1, else K2 with its query block capped at
    the page (every write block from a page-aligned n_past then lies in one
    page); another T raises ValueError. page_straddle lifts the one-page rule
    of K2's writes (llama.py:603-626 there): the speculative verify writes T
    rows at any n_past, with n_past + T <= MAXLB * PS.

    A ring cache (`cache.pos`) writes T rows at ring_phys(n_past, ring_keep)
    (the caller keeps them from crossing the ring's end) after storing their
    logical positions in the plane, once per forward; RoPE and the
    attention's query positions stay logical (llama.py:464-487 there).
    prefix_kv (pool k, v [L, NP, H, Sp, D] bf16) with prefix_id/prefix_len
    ([B] int32) puts row b's first prefix_len[b] positions in pool entry
    prefix_id[b]: n_past is a [B] vector of logical positions, the cache
    holds rows n_past - prefix_len (llama.py:450-462 there). Both take the
    fused kernels K2/K3 only, never K4 (llama.py:559-574 there); the plain
    write plus K3 for T with T % min(256, T) != 0.

    tp_axis / pp_axis / pp_microbatch: the parallel arms (module
    docstring); the params and cache are this rank's shards
    (`parallel.sharding`). cache_batch_offset: the cache row of batch row 0
    (the microbatches' offset, as llama.py:343-345 there); None, the
    default, takes a cache of exactly the batch's rows. The pipeline passes
    an offset for every microbatch (its batch slice), 0 included.
    """
    if ggml_rounding:
        raise NotImplementedError("llama_forward: ggml_rounding is not ported yet")
    if attn_impl not in ("auto", "flash", "einsum"):
        raise ValueError(f"attn_impl {attn_impl!r}")

    b, t = tokens.shape
    d = cfg.head_dim
    dev = tokens.device
    matmul = functools.partial(q4_matmul, plain=use_ref)
    attn_update = flash_attention_update_ref if use_ref else flash_attention_update
    attn_read = flash_attention_ref if use_ref else flash_attention
    attn_decode = flash_decode_update_ref if use_ref else flash_decode_update

    def linear(xx, w, l):
        """Layer l of a stacked weight (a packed one gives bf16, a dense one
        x's dtype, as in the JAX package)."""
        if isinstance(w, QWeight):
            return matmul(xx, w, torch.bfloat16, layer_idx=l)
        return _linear(xx, w[l])

    tp = tp_axis.size if tp_axis is not None else 1

    def row_linear(xx, w, l):
        """A row-parallel weight (wo, w2): under tp, this shard's partial
        product in f32 (its chunks / tp chunks, llama.py:426-431 there),
        summed over the axis, then x's dtype."""
        if tp == 1:
            return linear(xx, w, l)
        if isinstance(w, QWeight):
            w = replace(w, chunks=max(1, w.chunks // tp))
            part = matmul(xx, w, torch.float32, layer_idx=l)
        else:
            part = xx.to(w.dtype).to(torch.float32) @ w[l].to(torch.float32)
        return comm.all_reduce(part, tp_axis).to(xx.dtype)

    if isinstance(n_past, torch.Tensor) and n_past.dim() == 0:
        n_past = int(n_past)
    if isinstance(n_past, int):
        positions = torch.arange(n_past, n_past + t, device=dev)
    else:
        n_past = n_past.to(device=dev, dtype=torch.int32)
        positions = n_past[:, None].to(torch.int64) + torch.arange(t, device=dev)
    cos, sin = rope_cos_sin(positions, cfg.n_rot, cfg.rope_theta)  # [(B,) T, D/2]

    paged = page_table is not None
    ring = cache.ring
    prefix = prefix_kv is not None
    pp = pp_axis is not None
    if paged and (ring or prefix):
        raise ValueError("paged KV: non-ring pools, no prefix pool")
    if pp and (paged or prefix or ring):
        raise ValueError("pipeline stages take a flat cache: no page table, prefix pool or "
                         "ring (llama.py:447, :455 there)")
    mode = {}  # the ring or prefix operands of K2/K3
    local_past = n_past  # cache rows: n_past - prefix_len under a prefix
    if prefix:
        if ring:
            raise ValueError("shared-prefix: non-ring slot caches only")
        if isinstance(n_past, int):
            raise ValueError("shared-prefix requires per-row n_past")
        pid = torch.as_tensor(prefix_id, device=dev).to(torch.int32).expand(b).contiguous()
        plen = torch.as_tensor(prefix_len, device=dev).to(torch.int32).expand(b).contiguous()
        local_past = (n_past - plen).contiguous()
        mode = dict(prefix_k=prefix_kv[0], prefix_v=prefix_kv[1], prefix_id=pid, prefix_len=plen)
    wrow = local_past
    if ring:
        # the physical write rows and the position plane, once per forward:
        # every layer's kernels read the updated plane (llama.py:464-487 there)
        s_ctx = cache.k.shape[3]
        wrow = ring_phys(n_past, ring_keep, s_ctx)
        if isinstance(n_past, int):
            cache.pos[wrow : wrow + t] = positions.to(torch.int32)[:, None]
        else:
            rows = wrow.to(torch.int64)[:, None] + torch.arange(t, device=dev)  # [B, T]
            cache.pos[rows, torch.arange(b, device=dev)[:, None]] = positions.to(torch.int32)
            wrow = wrow.to(torch.int32).contiguous()

    x = embed_tokens(params.tok_embeddings, tokens, dtype=dtype)  # [B, T, E]
    lp = params.layers
    fused = isinstance(lp, FusedLayerParams)
    bk = kv_block or (512 if t >= 256 else 256)
    impl = "flash" if attn_impl == "auto" else attn_impl
    if paged and (impl != "flash" or t % min(256, t)):
        raise ValueError(f"paged KV requires the fused flash path (impl={impl}, t={t})")
    if prefix and impl != "flash":
        raise ValueError(f"shared-prefix attention requires the flash path (impl={impl})")
    upd_mode = read_mode = mode
    if ring:
        upd_mode = dict(kv_pos=cache.pos, write_row=wrow, ring_bounded=True)
        read_mode = dict(kv_pos=cache.pos)
    # paged K2: the query block capped at the page (llama.py:602-608 there)
    pkw = dict(page_table=page_table, block_t=min(256, cache.k.shape[3]),
               page_straddle=page_straddle) if paged else {}

    def layers(x, npast, lpast, wrow, cos, sin, boff: int | None):
        """This rank's layers over x [bq, T, E], whose rows sit at cache rows
        [boff, boff + bq) (the whole cache when boff is None): n_past
        `npast` (cache rows `lpast`, write rows `wrow`) and their RoPE
        tables."""
        bq = x.shape[0]
        boff_kw = {} if boff is None else dict(batch_offset=boff)
        planes = [cache.k, cache.v, cache.k_scale, cache.v_scale]
        if boff_kw:  # the plain write and the einsum read take the rows' views
            planes = [None if p is None else p[:, boff : boff + bq] for p in planes]
        for l in range(cache.k.shape[0]):
            # --- attention block (llama.cpp:976-1070)
            xa = rms_norm(x, lp.attn_norm[l], cfg.norm_eps)
            if fused:
                qkv = linear(xa, lp.wqkv, l)
                e = qkv.shape[-1] // 3  # local heads under tp
                q = qkv[..., :e].reshape(bq, t, -1, d)
                k = qkv[..., e : 2 * e].reshape(bq, t, -1, d)
                v = qkv[..., 2 * e :].reshape(bq, t, -1, d)
            else:
                q = linear(xa, lp.wq, l).reshape(bq, t, -1, d)
                k = linear(xa, lp.wk, l).reshape(bq, t, -1, d)
                v = linear(xa, lp.wv, l).reshape(bq, t, -1, d)
            q = apply_rope(q, cos, sin)
            k = apply_rope(k, cos, sin)  # RoPE'd K is what gets cached
            if impl == "flash" and t == 1 and bq > 1 and not (ring or prefix or pp):
                attn = attn_decode(q, k, v, cache.k, cache.v, npast, l, block_k=bk,
                                   k_scale=cache.k_scale, v_scale=cache.v_scale,
                                   page_table=page_table, **boff_kw)[0]
            elif impl == "flash" and t % min(256, t) == 0:
                attn = attn_update(q, k, v, cache.k, cache.v, lpast, l, block_k=bk,
                                   k_scale=cache.k_scale, v_scale=cache.v_scale, **pkw,
                                   **upd_mode, **boff_kw)[0]
            else:
                write_rows(k, v, planes[0], planes[1], wrow, l, planes[2], planes[3])
                if impl == "flash":
                    attn = attn_read(q, cache.k, cache.v, lpast, layer_idx=l, block_k=bk,
                                     k_scale=cache.k_scale, v_scale=cache.v_scale, **read_mode,
                                     **boff_kw)
                else:
                    ks, vs = ((planes[2][l], planes[3][l]) if cache.quantized
                              else (None, None))
                    attn = _attention(q, planes[0][l], planes[1][l], npast, ks, vs, cache.pos)
            attn = attn.reshape(bq, t, -1).to(dtype)
            x = x + row_linear(attn, lp.wo, l)
            # --- FFN block (llama.cpp:1073-1101)
            xf = rms_norm(x, lp.ffn_norm[l], cfg.norm_eps)
            if fused:
                gu = linear(xf, lp.w13, l)
                f = gu.shape[-1] // 2
                gate, up = gu[..., :f], gu[..., f:]
            else:
                gate = linear(xf, lp.w1, l)
                up = linear(xf, lp.w3, l)
            act = (
                torch.nn.functional.silu(gate.to(torch.float32)) * up.to(torch.float32)
            ).to(dtype)
            x = x + row_linear(act, lp.w2, l)
        return x

    if not pp:
        x = layers(x, n_past, local_past, wrow, cos, sin, cache_batch_offset)
    else:
        x = _pipeline(x, pp_axis, pp_microbatch, n_past, cos, sin, cache_batch_offset, layers)

    xn = rms_norm(x, params.norm, cfg.norm_eps)
    if last_idx is None or isinstance(last_idx, int):
        li = t - 1 if last_idx is None else last_idx
        last = xn[:, li : li + 1, :]
    else:  # per-row positions
        last = xn[torch.arange(b, device=dev), last_idx.to(dev).long()][:, None, :]
    embeddings = last[:, 0, :].to(torch.float32)
    if not logits_all:
        xn = last
    if isinstance(params.output, QWeight):
        logits = matmul(xn, params.output, torch.float32)
    else:  # a dense output weight multiplies in f32, as llama.py:849-853 there
        logits = xn.to(torch.float32) @ params.output.to(torch.float32)
    # vocab-sharded logits -> the full logits on every rank (llama.py:856)
    logits = comm.all_gather(logits, tp_axis, dim=-1)
    return logits, cache, embeddings


def _pipeline(x, axis: comm.Axis, n_micro: int, n_past, cos, sin, boff: int | None, layers):
    """The pipeline stages' schedule (module docstring): stage s runs each
    of the M microbatches once, as it arrives from stage s - 1 (stage 0
    takes rows [m·b0, (m+1)·b0) of x), at cache rows boff + m·b0 (boff
    None counts as 0; every microbatch passes its offset), and sends
    it to stage s + 1; the last stage's outputs go to every stage. Returns
    the full [B, T, E] activations."""
    b = x.shape[0]
    m_count = max(1, n_micro)
    if b % m_count:
        raise ValueError(f"batch {b} does not split into {m_count} microbatches")
    b0 = b // m_count
    stage, last = axis.index, axis.size - 1
    vector = not isinstance(n_past, int)
    outs = []
    for m in range(m_count):
        rows = slice(m * b0, (m + 1) * b0)
        xm = x[rows] if stage == 0 else comm.recv(x[rows], axis, stage - 1)
        npm = n_past[rows].contiguous() if vector else n_past
        cm, sm = (cos[rows], sin[rows]) if vector else (cos, sin)
        xm = layers(xm, npm, npm, npm, cm, sm, (boff or 0) + m * b0)
        if stage < last:
            comm.send(xm, axis, stage + 1)
        else:
            outs.append(xm)
    x = torch.cat(outs) if stage == last else torch.empty_like(x)
    return comm.broadcast(x, axis, last)
