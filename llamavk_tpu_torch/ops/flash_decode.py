"""Batched single-token decode attention (twin of
`llamavk_tpu/ops/flash_decode.py`, flat and page-table modes, over bf16,
int8 and f32 caches; f32: q and the new rows f32, no bf16 rounding, as
flash_decode.py:326, :356 there multiply in the cache's type).

`flash_decode_update` inserts each row's new K/V row at n_past[b] of layer
`layer_idx` IN PLACE (int8: quantized, with its scale rows) and attends, for
every batch row of a t == 1 step. On CUDA tensors it launches
`flash_decode_launch` of `csrc/flash_decode.cu`, which replaces the TPU kernel
`_flat_kernel`: one launch per layer for the insert and the attention of
every row, the split-KV decode kernel of `csrc/attn_split.cuh` (the split
route of `ops/flash_attn.py`), each row reading only its rows [0,
n_past[b]], cut into splits of `split_rows(block_k)` rows whose partials
merge in the launch. On CPU tensors it computes the plain version,
`flash_decode_update_ref`, which is the fused update's plain version at
T = 1: the row write, then the dense causal attention. With `page_table`
the cache is a page pool [L, NP, H, PS, D] addressed through the table, as in
`ops/flash_attn.py`. `batch_offset` runs the B rows against batch rows
[batch_offset, batch_offset + B) of a wider flat cache (flash_decode.py:391
there; no path of either package passes it but its tests).

Splits and accumulation order equal the fused update kernel's at T = 1
(`ops/flash_attn.py`) at the same block_k: the CUDA K4 and K2 share their
attention code, and their outputs and caches are bit-equal at T = 1.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import math

import torch

from . import _build
from . import flash_attn as _fa
from .flash_attn import (
    KV_CODES,
    ROUTE_CODES,
    _fit_block_k,
    _query,
    check_cuda,
    flash_attention_update_ref,
    kv_step,
    launch_name,
    pp_mode,
    split_args,
)

# launches of the CUDA kernel (one per wrapper call on CUDA tensors), by
# cache mode and type
launches = {launch_name("decode", kind, paged): 0 for paged in (False, True)
            for kind in ("bf16", "int8", "f32")}
launches.update({launch_name("decode", kind, False, mode="boff"): 0
                 for kind in ("bf16", "int8", "f32")})
# launches by shape (B, H, S, D, block_k, cache type: "bf16", "int8" or
# "f32", MAXLB: the page table's width, or None for a flat cache; S is a
# page's rows when paged), and for a batch slice of a wider cache the mode
# ("boff", B_cache, batch_offset) after them, so a caller can check every
# shape a run reached
shapes: collections.Counter = collections.Counter()


def decode_work_list(n_past: torch.Tensor, b: int, cap: int, bk: int):
    """Flatten per-row ragged block counts into (row_of, blk_of, total)
    (flash_decode.py:50 there).

    Row r owns ceil(min(n_past[r] + 1, cap) / bk) consecutive items (its KV
    blocks in ascending order, the grid kernel's accumulation order).
    Arrays are padded to MAXJ = b * cap / bk with the last row. Nothing at
    run time calls it: the CUDA kernel's (head, row) grid takes the list's
    place. It is kept as the twin of the JAX function, tested against it."""
    maxj = b * (cap // bk)
    nb = -(-torch.clamp(n_past.to(torch.int64) + 1, max=cap) // bk)  # [B] >= 1
    ends = torch.cumsum(nb, 0)
    j = torch.arange(maxj, device=n_past.device)
    row_of = torch.searchsorted(ends, j, right=True).clamp(max=b - 1)
    blk_of = j - (ends - nb)[row_of]
    return row_of.to(torch.int32), blk_of.to(torch.int32), int(ends[-1])


def flash_decode_update_ref(q, k_new, v_new, k, v, n_past, layer_idx: int, block_k: int = 256,
                            k_scale=None, v_scale=None, page_table=None,
                            batch_offset: int | None = None):
    """Plain version of `flash_decode_update`: the plain fused update
    (`flash_attention_update_ref`) at T = 1. Every row a query sees lies in
    one of the blocks its work list assigns, so the causal mask alone
    selects them. Returns (out [B, 1, H, D] f32, k, v), plus (k_scale,
    v_scale) for an int8 cache, every cache plane updated in place."""
    if q.shape[1] != 1:
        raise ValueError("flash_decode_update is the single-token decode path")
    _fit_block_k(block_k, k.shape[3], kv_step(k.dtype))  # the kernel's block must fit
    return flash_attention_update_ref(q, k_new, v_new, k, v, n_past, layer_idx,
                                      block_k=block_k, k_scale=k_scale, v_scale=v_scale,
                                      page_table=page_table, batch_offset=batch_offset)


@functools.cache
def _lib():
    lib = _build.load("flash_decode")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.flash_decode_launch.argtypes = [p, p, p, p, p, p, p, p, p, i, p, i, i, i, i, i, i, f, i,
                                        i, i, p, p, i, p]
    lib.flash_decode_launch.restype = ctypes.c_int
    lib.decode_launch_count.argtypes = []
    lib.decode_launch_count.restype = ctypes.c_long
    return lib


def cuda_launches() -> int:
    """The CUDA kernels `csrc/flash_decode.cu` has launched in this process
    (`flash_attn.cuda_launches` for K4), graph replays' included."""
    return _lib().decode_launch_count() + _build.replayed["flash_decode"]


def flash_decode_update(
    q: torch.Tensor,  # [B, 1, H, D]
    k_new: torch.Tensor,  # [B, 1, H, D]
    v_new: torch.Tensor,
    k: torch.Tensor,  # STACKED cache [L, B, H, S, D] or pool [L, NP, H, PS, D], in place
    v: torch.Tensor,
    n_past,  # int or [B] int32
    layer_idx: int,
    block_k: int = 256,
    k_scale: torch.Tensor | None = None,  # [L, B, S, H] / [L, NP, PS, H] f32, in place
    v_scale: torch.Tensor | None = None,
    page_table: torch.Tensor | None = None,  # [B, MAXLB] int32: k/v are a page pool
    batch_offset: int | None = None,  # first cache row of the B rows (flat)
):
    """Single-token fused cache insert + attention for every batch row (K4).
    Drop-in for `flash_attention_update` at t == 1, with the same
    accumulation order at equal block_k. Returns (out [B, 1, H, D] f32, k,
    v), plus (k_scale, v_scale) for an int8 cache."""
    if not q.is_cuda:
        return flash_decode_update_ref(q, k_new, v_new, k, v, n_past, layer_idx, block_k,
                                       k_scale, v_scale, page_table, batch_offset)
    b, t, h, d = q.shape
    if t != 1:
        raise ValueError("flash_decode_update is the single-token decode path")
    pname, pmode = pp_mode(k, b, batch_offset, 1, page_table)
    q = _query(q, k)
    # the cast flash_decode.py:413-418 makes (bf16, or an f32 cache's type)
    kn, vn = (x.to(q.dtype).contiguous() for x in (k_new, v_new))
    if kn.shape != q.shape or vn.shape != q.shape:
        raise ValueError("flash_decode_update: k_new/v_new must match q's shape")
    npv, nps, kind, ksp, vsp, tab, maxlb = check_cuda(q, k, v, n_past, layer_idx, k_scale,
                                                      v_scale, (kn, vn), page_table,
                                                      pp=pmode is not None)
    s = k.shape[3]
    bk = _fit_block_k(block_k, s, kv_step(k.dtype))
    out = torch.empty((b, 1, h, d), dtype=torch.float32, device=q.device)
    # the split route (attn_route at T = 1; the CUDA-core kernel only where a
    # timing harness patches the route)
    route = _fa.attn_route(1, kind)
    rc = _lib().flash_decode_launch(
        q.data_ptr(), kn.data_ptr(), vn.data_ptr(), k[layer_idx].data_ptr(),
        v[layer_idx].data_ptr(), ksp, vsp, out.data_ptr(), npv, nps, tab, maxlb, b, h, s, d, bk,
        1.0 / math.sqrt(d), KV_CODES[kind], batch_offset or 0, ROUTE_CODES[route],
        *split_args(route, q, s * (maxlb or 1), bk),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(rc, "flash_decode_launch")
    launches[launch_name("decode", kind, tab is not None, mode=pname)] += 1
    shapes[(b, h, s, d, bk, kind, maxlb or None) + ((pmode,) if pmode else ())] += 1
    return (out, k, v) if k_scale is None else (out, k, v, k_scale, v_scale)
