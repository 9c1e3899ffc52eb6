"""Attention over the KV cache (twin of `llamavk_tpu/ops/flash_attn.py`, flat
and page-table modes, bf16 and int8).

q: [B, T, H, D] (new queries), cache: STACKED [L, B, H, S, D] bf16 or int8,
n_past: int or [B] int32 tensor. An int8 cache comes with f32 scale planes
k_scale/v_scale [L, B, S, H] (`ops/kv_quant.py`). Outputs are [B, T, H, D] f32.

With `page_table` (int32 [B, MAXLB]) the cache is a PAGE POOL
[L, NP, H, PS, D] (int8 scales [L, NP, PS, H]) and logical row j of batch
row b lives at page `page_table[b, j // PS]`, row `j % PS`
(`runtime/paged.py`). The KV block is fitted to the page (it divides PS), so
a paged call and a flat one with `block_k = PS` sum in the same order. Paged
writes keep each block of `block_t` rows inside one page, as the JAX
kernel's callers do, unless `page_straddle` is set: the speculative verify
writes T rows at any n_past, and rows past a page's end go to the next
logical page of the table (flash_attn.py:197-215 there; the CUDA write looks
up every row's page anyway, so the mode changes the checks, not the kernel).

* `flash_attention_update` writes T new K/V rows at [n_past, n_past + T) of
  layer `layer_idx` IN PLACE (int8: quantized, with their scale rows; the JAX
  kernel got the same effect through buffer aliasing), then attends. On CUDA
  tensors it launches `attn_update_launch` of `csrc/flash_attn.cu` (replaces
  `_update_kernel`).
* `flash_attention` attends over a cache that already holds the rows. On
  CUDA tensors it launches `attn_read_launch` (replaces `_read_kernel` /
  `_attend`).

On CPU tensors both compute their plain version (`*_ref`): the same cache
write (paged: straight into the pool through the table), then the dense
masked softmax of `attend_ref` (paged: over the logical view gathered
through the table, `gather_pages`) with the kernels'
rounding points (q scaled and rounded to bf16; int8 scores times the key
scale; probabilities times the value scale, rounded to bf16). The kernels
use the online softmax over KV blocks of `block_k` rows; `_fit_block_k` picks
that block exactly as the JAX package does, so pinning `block_k` pins the
accumulation order.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import math

import torch

from . import _build
from .kv_quant import quantize_rows

# launches of the CUDA kernels (one per wrapper call on CUDA tensors), by
# path, cache mode and cache type; the update path's page_straddle mode on its
# own
launches = {f"{path}{mode}{kind}": 0 for path, mode in (
    ("update", ""), ("update", "_paged"), ("update", "_paged_straddle"), ("read", ""),
    ("read", "_paged")) for kind in ("", "_i8")}
# launches by shape (path, B, T, H, S, D, block_k, int8, n_past: the int, or
# None for a per-row vector, MAXLB: the page table's width, or None for a
# flat cache, page_straddle; S is a page's rows when paged), so a caller can
# check every shape a run reached
shapes: collections.Counter = collections.Counter()


def launch_name(path: str, quant: bool, paged: bool, straddle: bool = False) -> str:
    """The `launches` key of one call: update/read/decode, paged (and
    straddling), int8."""
    return (path + ("_paged" if paged else "") + ("_straddle" if straddle else "")
            + ("_i8" if quant else ""))


def _fit_block_k(block_k: int, s: int, step: int = 8) -> int:
    """Largest KV block <= block_k that divides s (in steps of 8 rows, 32 for
    an int8 cache), as flash_attn.py:76 of the JAX package. For a page pool
    s is the page's rows, so a KV block never crosses a page."""
    bk = min(block_k, s)
    while bk > step and s % bk:
        bk -= step
    if s % bk:
        raise ValueError(f"KV cache length {s} must be a multiple of {step}")
    return bk


def kv_step(cache_dtype: torch.dtype) -> int:
    """The KV block step of a cache type: 32 rows for int8, else 8."""
    return 32 if cache_dtype == torch.int8 else 8


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
    scores = scores.masked_fill(~visible_mask(n_past, b, t, s, q.device)[:, None], float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum(
        "bhts,bhsd->bthd", probs.to(v.dtype).to(torch.float32), v.to(torch.float32)
    )


def _npast_rows(n_past, b: int, device) -> torch.Tensor:
    """n_past as an int64 [B] vector."""
    return torch.as_tensor(n_past, device=device).to(torch.int64).expand(b)


def visible_mask(n_past, b: int, t: int, s: int, device) -> torch.Tensor:
    """[B, T, S] bool: column j is visible to query t of row b iff
    j <= n_past[b] + t."""
    jpos = torch.arange(s, device=device)
    tpos = _npast_rows(n_past, b, device)[:, None] + torch.arange(t, device=device)[None, :]
    return jpos[None, None, :] <= tpos[:, :, None]


def attend_ref(q, k_l, v_l, visible, k_scale_l=None, v_scale_l=None) -> torch.Tensor:
    """Dense attention with the kernels' rounding points. q [B, T, H, D];
    k_l/v_l one cache layer [B, H, S, D] (bf16 or int8); visible [B, T, S];
    k_scale_l/v_scale_l that layer's [B, S, H] scale planes for int8. q is
    scaled by 1/sqrt(D) in f32 and rounded to bf16 before the QK product
    (flash_attn.py:545 there); an int8 score is multiplied by its key's
    scale; the probabilities are multiplied by the value scales and rounded
    to bf16 before the PV product. Returns f32 [B, T, H, D]."""
    d = q.shape[-1]
    qs = (q.to(torch.float32) * (1.0 / math.sqrt(d))).to(torch.bfloat16).to(torch.float32)
    scores = torch.einsum("bthd,bhsd->bhts", qs, k_l.to(torch.float32))
    if k_scale_l is not None:
        scores = scores * k_scale_l.transpose(1, 2)[:, :, None, :]
    probs = torch.softmax(scores.masked_fill(~visible[:, None], float("-inf")), dim=-1)
    if v_scale_l is not None:
        probs = probs * v_scale_l.transpose(1, 2)[:, :, None, :]
    return torch.einsum(
        "bhts,bhsd->bthd", probs.to(torch.bfloat16).to(torch.float32), v_l.to(torch.float32)
    )


def gather_pages(plane_l: torch.Tensor, page_table: torch.Tensor) -> torch.Tensor:
    """The logical view of one pool layer through the table [B, MAXLB]:
    data [NP, H, PS, D] -> [B, H, MAXLB * PS, D], scales [NP, PS, H] ->
    [B, MAXLB * PS, H] (a copy; rows of shared pages appear in every row
    that maps them)."""
    b, maxlb = page_table.shape
    g = plane_l[page_table.to(torch.int64)]  # [B, MAXLB, H, PS, D] or [B, MAXLB, PS, H]
    if plane_l.dim() == 4:
        _, h, ps, d = plane_l.shape
        return g.permute(0, 2, 1, 3, 4).reshape(b, h, maxlb * ps, d)
    return g.reshape(b, maxlb * plane_l.shape[1], plane_l.shape[2])


def write_rows(k_new, v_new, k, v, n_past, layer_idx: int, k_scale=None, v_scale=None,
               page_table=None) -> None:
    """cache[layer_idx, b, :, n_past[b] + t] = new[b, t] (in place): bf16
    rows for a bf16 cache; for an int8 cache the rows of bf16(new) quantized
    by `quantize_rows`, and their scales into k_scale/v_scale. With a page
    table, logical row j of batch row b goes to page `page_table[b, j // PS]`,
    row `j % PS`, of the pool."""
    b, t = k_new.shape[:2]
    quant = k.dtype == torch.int8
    if quant:
        kn, ks = quantize_rows(k_new.to(torch.bfloat16))  # [B, T, H, D], [B, T, H]
        vn, vs = quantize_rows(v_new.to(torch.bfloat16))
    else:
        kn, vn = k_new.to(k.dtype), v_new.to(v.dtype)
    if page_table is not None:
        ps = k.shape[3]
        pos = _npast_rows(n_past, b, k.device)[:, None] + torch.arange(t, device=k.device)
        pages = page_table.to(torch.int64).gather(1, pos // ps)  # [B, T]
        rows = pos % ps
        # advanced indices around a slice: the indexed view is [B, T, H, D]
        k[layer_idx][pages, :, rows] = kn
        v[layer_idx][pages, :, rows] = vn
        if quant:
            k_scale[layer_idx][pages, rows] = ks
            v_scale[layer_idx][pages, rows] = vs
        return
    starts = [n_past] * b if isinstance(n_past, int) else n_past.tolist()
    for bi, p in enumerate(starts):
        k[layer_idx, bi, :, p : p + t] = kn[bi].transpose(0, 1)
        v[layer_idx, bi, :, p : p + t] = vn[bi].transpose(0, 1)
        if quant:
            k_scale[layer_idx, bi, p : p + t] = ks[bi]
            v_scale[layer_idx, bi, p : p + t] = vs[bi]


def _layer_scales(k_scale, v_scale, layer_idx):
    """(k_scale, v_scale) of one layer, or (None, None) for a bf16 cache."""
    if k_scale is None:
        return None, None
    return k_scale[layer_idx], v_scale[layer_idx]


def flash_attention_ref(q, k, v, n_past, layer_idx: int = 0, block_k: int = 256,
                        k_scale=None, v_scale=None, page_table=None):
    """Plain version of `flash_attention`: dense attention over layer
    `layer_idx` of the stacked cache, or over the logical view of the pool
    gathered through `page_table` (`attend_ref`)."""
    del block_k  # the dense softmax has no KV blocks
    b, t = q.shape[:2]
    planes = [k[layer_idx], v[layer_idx], *_layer_scales(k_scale, v_scale, layer_idx)]
    if page_table is not None:
        planes = [None if p is None else gather_pages(p, page_table) for p in planes]
    visible = visible_mask(n_past, b, t, planes[0].shape[2], q.device)
    return attend_ref(q, *planes[:2], visible, *planes[2:])


def check_paged_write(n_past: int, t: int, block_t: int, page_rows: int) -> None:
    """The paged write invariant of the JAX kernel (flash_attn.py:1029-1033
    there): every block of `block_t` rows written from a host-int n_past lies
    in one page. The engine's power-of-two chunks from page-aligned starts
    keep it; the speculative verify's writes that cross pages set
    `page_straddle` instead."""
    for start in range(n_past, n_past + t, block_t):
        if start // page_rows != (start + block_t - 1) // page_rows:
            raise ValueError(f"paged write rows [{start}, {start + block_t}) cross a page of "
                             f"{page_rows} rows")


def flash_attention_update_ref(
    q, k_new, v_new, k, v, n_past, layer_idx: int, block_t: int = 256, block_k: int = 256,
    k_scale=None, v_scale=None, page_table=None, page_straddle: bool = False,
):
    """Plain version of `flash_attention_update`: the cache write, then the
    dense attention. Returns (out, k, v), plus (k_scale, v_scale) for an int8
    cache, every cache plane updated in place."""
    _check_block_t(q.shape[1], block_t, n_past, k.shape[3], page_table, page_straddle)
    write_rows(k_new, v_new, k, v, n_past, layer_idx, k_scale, v_scale, page_table)
    out = flash_attention_ref(q, k, v, n_past, layer_idx, block_k, k_scale, v_scale, page_table)
    return (out, k, v) if k_scale is None else (out, k, v, k_scale, v_scale)


def _check_block_t(t: int, block_t: int, n_past, rows: int, page_table,
                   straddle: bool = False) -> None:
    """T % min(block_t, T) == 0, as the JAX kernel requires; paged, with a
    host-int n_past, `check_paged_write`, or with `straddle` the JAX caller
    invariant n_past + T <= MAXLB * PS (flash_attn.py:1034-1038 there), so
    no row runs past the table. A vector n_past is the caller's to keep in
    bounds (the engines' headroom and submit asserts)."""
    bt = min(block_t, t)
    if t % bt:
        raise ValueError(f"flash_attention_update needs T % block_t == 0 (T={t}, bt={bt})")
    if straddle and page_table is None:
        raise ValueError("page_straddle needs a page table")
    if page_table is not None and isinstance(n_past, int):
        if straddle:
            if not 0 <= n_past <= page_table.shape[1] * rows - t:
                raise ValueError(f"straddling write [{n_past}, {n_past + t}) runs past the "
                                 f"{page_table.shape[1]} pages of the table")
        else:
            check_paged_write(n_past, t, bt, rows)


@functools.cache
def _lib():
    lib = _build.load("flash_attn")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.attn_read_launch.argtypes = [p, p, p, p, p, p, p, i, p, i, i, i, i, i, i, i, f, i, p]
    lib.attn_read_launch.restype = ctypes.c_int
    lib.attn_update_launch.argtypes = [p, p, p, p, p, p, p, p, p, i, p, i, i, i, i, i, i, i, f,
                                       i, p]
    lib.attn_update_launch.restype = ctypes.c_int
    return lib


def check_cuda(q, k, v, n_past, layer_idx, k_scale=None, v_scale=None, tensors=(),
               page_table=None):
    """Validate kernel operands (bf16 q and new rows; a bf16 cache, or an
    int8 cache with f32 scale planes; flat [L, B, H, S, D] with scales
    [L, B, S, H], or a pool [L, NP, H, PS, D] with scales [L, NP, PS, H] and
    an int32 [B, MAXLB] page table). Returns (npast_ptr, npast_scalar, int8
    flag, k_scale_ptr, v_scale_ptr, table_ptr, MAXLB) for layer_idx."""
    b, t, h, d = q.shape
    paged = page_table is not None
    if (k.dim() != 5 or k.shape != v.shape or k.shape[2] != h or k.shape[4] != d
            or not (paged or k.shape[1] == b)):
        raise ValueError(f"attention: cache {tuple(k.shape)} does not fit q {tuple(q.shape)}")
    if d not in (64, 128):
        raise ValueError(f"attention kernel: head_dim must be 64 or 128, got {d}")
    if not 0 <= layer_idx < k.shape[0]:
        raise ValueError(f"attention: layer {layer_idx} out of range")
    if k.dtype not in (torch.bfloat16, torch.int8) or v.dtype != k.dtype:
        raise ValueError(f"attention kernel: cache must be bf16 or int8, got {k.dtype}/{v.dtype}")
    quant = k.dtype == torch.int8
    scales = (k_scale, v_scale) if quant else ()
    if quant:
        want = (k.shape[0], k.shape[1], k.shape[3], h)
        for sc in scales:
            if sc is None or sc.dtype != torch.float32 or tuple(sc.shape) != want:
                raise ValueError(f"attention kernel: an int8 cache needs f32 scales {want}")
    elif k_scale is not None or v_scale is not None:
        raise ValueError("attention kernel: scale planes belong to an int8 cache")
    for x in (q, *tensors):
        if x.dtype != torch.bfloat16:
            raise ValueError(f"attention kernel: q and new rows must be bf16, got {x.dtype}")
    tables = (page_table,) if paged else ()
    if paged and (page_table.dtype != torch.int32 or page_table.dim() != 2
                  or page_table.shape[0] != b):
        raise ValueError(f"attention kernel: the page table must be int32 [{b}, MAXLB]")
    for x in (q, k, v, *scales, *tensors, *tables):
        if not x.is_cuda or x.device != q.device:
            raise ValueError("attention kernel: every operand must be a CUDA tensor on q's device")
        if not x.is_contiguous():
            raise ValueError("attention kernel: operands must be contiguous")
    maxlb = page_table.shape[1] if paged else 0
    cap = maxlb * k.shape[3] if paged else k.shape[3]
    sptr = (k_scale[layer_idx].data_ptr(), v_scale[layer_idx].data_ptr()) if quant else (None, None)
    tptr = (page_table.data_ptr(), maxlb) if paged else (None, 0)
    if isinstance(n_past, int):
        if not 0 <= n_past <= cap - t:
            raise ValueError(f"attention: n_past {n_past} + T {t} exceeds the cache ({cap})")
        return None, n_past, quant, *sptr, *tptr
    if n_past.shape != (b,) or n_past.dtype != torch.int32 or n_past.device != q.device:
        raise ValueError("attention kernel: vector n_past must be int32 [B] on q's device")
    return n_past.data_ptr(), 0, quant, *sptr, *tptr


def flash_attention(
    q: torch.Tensor,  # [B, T, H, D]
    k: torch.Tensor,  # STACKED cache [L, B, H, S, D] or pool [L, NP, H, PS, D], bf16 or int8
    v: torch.Tensor,
    n_past,  # int or [B] int32
    layer_idx: int = 0,
    block_k: int = 256,
    k_scale: torch.Tensor | None = None,  # [L, B, S, H] / [L, NP, PS, H] f32: int8 cache
    v_scale: torch.Tensor | None = None,
    page_table: torch.Tensor | None = None,  # [B, MAXLB] int32: k/v are a page pool
) -> torch.Tensor:
    """Causal attention of T queries over layer `layer_idx` of a cache that
    already holds their rows (K3). Returns f32 [B, T, H, D]."""
    if not q.is_cuda:
        return flash_attention_ref(q, k, v, n_past, layer_idx, block_k, k_scale, v_scale,
                                   page_table)
    npv, nps, quant, ksp, vsp, tab, maxlb = check_cuda(q, k, v, n_past, layer_idx, k_scale,
                                                       v_scale, page_table=page_table)
    b, t, h, d = q.shape
    s = k.shape[3]
    bk = _fit_block_k(block_k, s, kv_step(k.dtype))
    out = torch.empty((b, t, h, d), dtype=torch.float32, device=q.device)
    rc = _lib().attn_read_launch(
        q.data_ptr(), k[layer_idx].data_ptr(), v[layer_idx].data_ptr(), ksp, vsp,
        out.data_ptr(), npv, nps, tab, maxlb, b, t, h, s, d, bk, 1.0 / math.sqrt(d), int(quant),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(rc, "attn_read_launch")
    launches[launch_name("read", quant, tab is not None)] += 1
    shapes[("read", b, t, h, s, d, bk, quant, n_past if npv is None else None,
            maxlb or None, False)] += 1
    return out


def flash_attention_update(
    q: torch.Tensor,  # [B, T, H, D]
    k_new: torch.Tensor,  # [B, T, H, D] (RoPE'd K rows to cache)
    v_new: torch.Tensor,  # [B, T, H, D]
    k: torch.Tensor,  # STACKED cache [L, B, H, S, D] or pool [L, NP, H, PS, D], in place
    v: torch.Tensor,
    n_past,  # int or [B] int32
    layer_idx: int,
    block_t: int = 256,
    block_k: int = 256,
    k_scale: torch.Tensor | None = None,  # [L, B, S, H] / [L, NP, PS, H] f32, in place
    v_scale: torch.Tensor | None = None,
    page_table: torch.Tensor | None = None,  # [B, MAXLB] int32: k/v are a page pool
    page_straddle: bool = False,  # paged writes at any n_past (speculative verify)
):
    """Writes the T new K/V rows at [n_past[b], n_past[b] + T) of layer
    `layer_idx` IN PLACE (int8: the rows of bf16(k_new) quantized, and their
    scales), then attends (K2). Returns (out [B, T, H, D] f32, k, v), plus
    (k_scale, v_scale) for an int8 cache. Requires T % min(block_t, T) == 0,
    as the JAX kernel does, and, paged, that every block of block_t rows
    lies in one page (checked for a host-int n_past; `check_paged_write`),
    unless `page_straddle`: then rows cross into the next logical page, and
    n_past + T <= MAXLB * PS."""
    if not q.is_cuda:
        return flash_attention_update_ref(q, k_new, v_new, k, v, n_past, layer_idx,
                                          block_t, block_k, k_scale, v_scale, page_table,
                                          page_straddle)
    _check_block_t(q.shape[1], block_t, n_past, k.shape[3], page_table, page_straddle)
    # the cast flash_attn.py:1101-1103 makes; an int8 cache quantizes bf16 rows
    kn = k_new.to(torch.bfloat16).contiguous()
    vn = v_new.to(torch.bfloat16).contiguous()
    if kn.shape != q.shape or vn.shape != q.shape:
        raise ValueError("flash_attention_update: k_new/v_new must match q's shape")
    npv, nps, quant, ksp, vsp, tab, maxlb = check_cuda(q, k, v, n_past, layer_idx, k_scale,
                                                       v_scale, (kn, vn), page_table)
    b, t, h, d = q.shape
    s = k.shape[3]
    bk = _fit_block_k(block_k, s, kv_step(k.dtype))
    out = torch.empty((b, t, h, d), dtype=torch.float32, device=q.device)
    rc = _lib().attn_update_launch(
        q.data_ptr(), kn.data_ptr(), vn.data_ptr(), k[layer_idx].data_ptr(),
        v[layer_idx].data_ptr(), ksp, vsp, out.data_ptr(), npv, nps, tab, maxlb, b, t, h, s, d,
        bk, 1.0 / math.sqrt(d), int(quant), torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(rc, "attn_update_launch")
    launches[launch_name("update", quant, tab is not None, page_straddle)] += 1
    shapes[("update", b, t, h, s, d, bk, quant, n_past if npv is None else None,
            maxlb or None, page_straddle)] += 1
    return (out, k, v) if k_scale is None else (out, k, v, k_scale, v_scale)
