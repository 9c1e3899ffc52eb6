"""Attention over the bf16 KV cache (twin of `llamavk_tpu/ops/flash_attn.py`,
bf16 flat-cache mode).

q: [B, T, H, D] (new queries), cache: STACKED [L, B, H, S, D] bf16, n_past: int
or [B] int32 tensor. Outputs are [B, T, H, D] f32.

* `flash_attention_update` writes T new K/V rows at [n_past, n_past + T) of
  layer `layer_idx` IN PLACE (the JAX kernel got the same effect through
  buffer aliasing), then attends. On CUDA tensors it launches
  `attn_update_launch` of `csrc/flash_attn.cu` (replaces `_update_kernel`).
* `flash_attention` attends over a cache that already holds the rows. On
  CUDA tensors it launches `attn_read_launch` (replaces `_read_kernel` /
  `_attend`).

On CPU tensors both compute their plain version (`*_ref`): the same cache
write, then the dense masked softmax of `attention_ref` over q scaled and
rounded to bf16 as the kernels round it. The kernels use the online softmax
over KV blocks of `block_k` rows; `_fit_block_k` picks that block exactly as
the JAX package does, so pinning `block_k` pins the accumulation order.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from . import _build

# launches of the CUDA kernels (one per wrapper call on CUDA tensors)
launches = {"update": 0, "read": 0}


def _fit_block_k(block_k: int, s: int, step: int = 8) -> int:
    """Largest KV block <= block_k that divides s (8-row steps), as
    flash_attn.py:76 of the JAX package."""
    bk = min(block_k, s)
    while bk > step and s % bk:
        bk -= step
    if s % bk:
        raise ValueError(f"KV cache length {s} must be a multiple of {step}")
    return bk


def attention_ref(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, n_past, scale: float | None = None
) -> torch.Tensor:
    """Dense scores over the whole cache (parity oracle, flash_attn.py:99).
    q [B, T, H, D]; k, v [B, H, S, D]; returns f32 [B, T, H, D]. Scores are
    scaled by `scale`, 1/sqrt(D) unless given."""
    b, t, h, d = q.shape
    s = k.shape[2]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    qf = q.to(k.dtype).to(torch.float32)
    scores = torch.einsum("bthd,bhsd->bhts", qf, k.to(torch.float32)) * scale
    jpos = torch.arange(s, device=q.device)
    npast_b = torch.as_tensor(n_past, device=q.device).to(torch.int64).expand(b)
    tpos = npast_b[:, None] + torch.arange(t, device=q.device)[None, :]
    mask = jpos[None, None, :] <= tpos[:, :, None]  # [B, T, S]
    scores = scores.masked_fill(~mask[:, None], float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum(
        "bhts,bhsd->bthd", probs.to(v.dtype).to(torch.float32), v.to(torch.float32)
    )


def write_rows(k_new, v_new, k, v, n_past, layer_idx: int) -> None:
    """cache[layer_idx, b, :, n_past[b] + t] = bf16(new[b, t]) (in place)."""
    b, t = k_new.shape[:2]
    kn = k_new.transpose(1, 2).to(k.dtype)  # [B, H, T, D]
    vn = v_new.transpose(1, 2).to(v.dtype)
    if isinstance(n_past, int):
        k[layer_idx, :, :, n_past : n_past + t] = kn
        v[layer_idx, :, :, n_past : n_past + t] = vn
        return
    for bi, p in enumerate(n_past.tolist()):
        k[layer_idx, bi, :, p : p + t] = kn[bi]
        v[layer_idx, bi, :, p : p + t] = vn[bi]


def flash_attention_ref(q, k, v, n_past, layer_idx: int = 0, block_k: int = 256):
    """Plain version of `flash_attention`: dense attention over layer
    `layer_idx` of the stacked cache, with the kernel's scores: q scaled by
    1/sqrt(D) in f32 and rounded to the cache dtype before the QK product
    (flash_attn.py:545 there)."""
    del block_k  # the dense softmax has no KV blocks
    qs = (q.to(torch.float32) * (1.0 / math.sqrt(q.shape[-1]))).to(k.dtype)
    return attention_ref(qs, k[layer_idx], v[layer_idx], n_past, scale=1.0)


def flash_attention_update_ref(
    q, k_new, v_new, k, v, n_past, layer_idx: int, block_t: int = 256, block_k: int = 256
):
    """Plain version of `flash_attention_update`: the cache write, then the
    dense attention. Returns (out, k, v), k/v updated in place."""
    t = q.shape[1]
    bt = min(block_t, t)
    if t % bt:
        raise ValueError(f"flash_attention_update needs T % block_t == 0 (T={t}, bt={bt})")
    write_rows(k_new, v_new, k, v, n_past, layer_idx)
    return flash_attention_ref(q, k, v, n_past, layer_idx, block_k), k, v


@functools.cache
def _lib():
    lib = _build.load("flash_attn")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.attn_read_launch.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i, f, p]
    lib.attn_read_launch.restype = ctypes.c_int
    lib.attn_update_launch.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, i, i, f, p]
    lib.attn_update_launch.restype = ctypes.c_int
    return lib


def _check_cuda(q, k, v, n_past, layer_idx, tensors=()):
    """Validate kernel operands; returns (npast_ptr, npast_scalar)."""
    b, t, h, d = q.shape
    if k.dim() != 5 or k.shape != v.shape or k.shape[1:3] != (b, h) or k.shape[4] != d:
        raise ValueError(f"attention: cache {tuple(k.shape)} does not fit q {tuple(q.shape)}")
    if d not in (64, 128):
        raise ValueError(f"attention kernel: head_dim must be 64 or 128, got {d}")
    if not 0 <= layer_idx < k.shape[0]:
        raise ValueError(f"attention: layer {layer_idx} out of range")
    for x in (q, k, v, *tensors):
        if not x.is_cuda:
            raise ValueError("attention kernel: every operand must be a CUDA tensor")
        if x.dtype != torch.bfloat16:
            raise ValueError(f"attention kernel: operands must be bf16, got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError("attention kernel: operands must be contiguous")
    s = k.shape[3]
    if isinstance(n_past, int):
        if not 0 <= n_past <= s - t:
            raise ValueError(f"attention: n_past {n_past} + T {t} exceeds the cache ({s})")
        return None, n_past
    if n_past.shape != (b,) or n_past.dtype != torch.int32 or n_past.device != q.device:
        raise ValueError("attention kernel: vector n_past must be int32 [B] on q's device")
    return n_past.data_ptr(), 0


def flash_attention(
    q: torch.Tensor,  # [B, T, H, D]
    k: torch.Tensor,  # STACKED cache [L, B, H, S, D]
    v: torch.Tensor,
    n_past,  # int or [B] int32
    layer_idx: int = 0,
    block_k: int = 256,
) -> torch.Tensor:
    """Causal attention of T queries over layer `layer_idx` of a cache that
    already holds their rows (K3). Returns f32 [B, T, H, D]."""
    if not q.is_cuda:
        return flash_attention_ref(q, k, v, n_past, layer_idx, block_k)
    npv, nps = _check_cuda(q, k, v, n_past, layer_idx)
    b, t, h, d = q.shape
    s = k.shape[3]
    bk = _fit_block_k(block_k, s)
    out = torch.empty((b, t, h, d), dtype=torch.float32, device=q.device)
    rc = _lib().attn_read_launch(
        q.data_ptr(), k[layer_idx].data_ptr(), v[layer_idx].data_ptr(), out.data_ptr(),
        npv, nps, b, t, h, s, d, bk, 1.0 / math.sqrt(d),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(rc, "attn_read_launch")
    launches["read"] += 1
    return out


def flash_attention_update(
    q: torch.Tensor,  # [B, T, H, D]
    k_new: torch.Tensor,  # [B, T, H, D] (RoPE'd K rows to cache)
    v_new: torch.Tensor,  # [B, T, H, D]
    k: torch.Tensor,  # STACKED cache [L, B, H, S, D], updated in place
    v: torch.Tensor,
    n_past,  # int or [B] int32
    layer_idx: int,
    block_t: int = 256,
    block_k: int = 256,
):
    """Writes the T new K/V rows at [n_past[b], n_past[b] + T) of layer
    `layer_idx` IN PLACE, then attends (K2). Returns (out [B, T, H, D] f32,
    k, v). Requires T % min(block_t, T) == 0, as the JAX kernel does."""
    if not q.is_cuda:
        return flash_attention_update_ref(q, k_new, v_new, k, v, n_past, layer_idx,
                                          block_t, block_k)
    t = q.shape[1]
    bt = min(block_t, t)
    if t % bt:
        raise ValueError(f"flash_attention_update needs T % block_t == 0 (T={t}, bt={bt})")
    kn = k_new.to(k.dtype).contiguous()  # the cast flash_attn.py:1101-1103 makes
    vn = v_new.to(v.dtype).contiguous()
    if kn.shape != q.shape or vn.shape != q.shape:
        raise ValueError("flash_attention_update: k_new/v_new must match q's shape")
    npv, nps = _check_cuda(q, k, v, n_past, layer_idx, (kn, vn))
    b, t, h, d = q.shape
    s = k.shape[3]
    bk = _fit_block_k(block_k, s)
    out = torch.empty((b, t, h, d), dtype=torch.float32, device=q.device)
    rc = _lib().attn_update_launch(
        q.data_ptr(), kn.data_ptr(), vn.data_ptr(), k[layer_idx].data_ptr(),
        v[layer_idx].data_ptr(), out.data_ptr(), npv, nps, b, t, h, s, d, bk,
        1.0 / math.sqrt(d), torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(rc, "attn_update_launch")
    launches["update"] += 1
    return out, k, v
