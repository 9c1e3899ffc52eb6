"""Attention over the KV cache (twin of `llamavk_tpu/ops/flash_attn.py`, flat
and page-table modes, bf16 and int8, and the flat and ring f32 modes).

q: [B, T, H, D] (new queries), cache: STACKED [L, B, H, S, D] bf16, int8 or
f32, n_past: int or [B] int32 tensor. An int8 cache comes with f32 scale
planes k_scale/v_scale [L, B, S, H] (`ops/kv_quant.py`). Outputs are
[B, T, H, D] f32.

An f32 cache (the llama.h API's `f16_kv = false`, perplexity's f32 mode)
multiplies in f32 throughout, as the JAX kernels multiply in the cache's
own type (flash_attn.py:749, :798 there): q * scale and the probabilities
are not rounded to bf16, and the new rows are stored as they arrive. It is
flat, a history ring, a page pool, or the slot cache under a bf16 prefix
pool, whose pre-pass rounds q and p to bf16 as over any slot type
(flash_attn.py:697-713 there; the JAX asserts at :877 and :1073 check only
that the pool is bf16).

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

History ring (`kv_pos` [S, B] int32, the logical position held by each
physical row, -1 = empty; flash_attn.py:145-147, :555-563, :763-786 there):
row j is visible to the query at logical position p iff
0 <= kv_pos[j, b] <= p, so n_past is the LOGICAL position, and the update
writes its T rows at physical rows [write_row[b], write_row[b] + T) (the
caller keeps them inside the ring and has already stored their positions in
the plane, which the kernels only read). `ring_bounded` stops the scan where
the flat one stops, exact while kv_pos[r] >= r (rings the engine fills).

Shared-prefix pool (`prefix_k/v` [L, NP, H, Sp, D] bf16, `prefix_id/len`
[B] int32; :643-735 there): before the cache, each row attends over rows
[0, prefix_len[b]) of pool entry prefix_id[b] with no causal mask, and
n_past is the SLOT-LOCAL row (logical position minus prefix_len). The pool
is bf16 over a bf16, int8 or f32 cache; its KV block `pblock_k` is fitted to Sp
on its own (`_fit_block_k(min(block_k, Sp), Sp)`, :880 there). Ring and
prefix exclude each other and a page table, as the JAX asserts do.

* `flash_attention_update` writes T new K/V rows at [n_past, n_past + T) of
  layer `layer_idx` IN PLACE (int8: quantized, with their scale rows; the JAX
  kernel got the same effect through buffer aliasing), then attends. On CUDA
  tensors it launches `attn_update_launch` of `csrc/flash_attn.cu` (replaces
  `_update_kernel`).
* `flash_attention` attends over a cache that already holds the rows. On
  CUDA tensors it launches `attn_read_launch` (replaces `_read_kernel` /
  `_attend`).

Both launch their attention by one of two routes, picked by `attn_route`
from T and the cache type alone (never B or the mode, so the single-stream
and batched engines route a given T alike): the split route
(`csrc/attn_split.cuh`, split-KV attention, the kernel of
`ops/flash_decode.py` too) for T from 1 to 15 (decode steps, lookup and
speculative verify rounds, short chunks) over every cache type, one block a
split serving every query row, the update's row writes fused into its one
launch; the tensor-core route (`csrc/attn_mma.cuh`, `mma.sync`; an f32
cache on three TF32 passes a product) at T >= 16 over every cache type.
Each route has its own launch counters (`_split` or `_tc` in the name); no
call falls back from one to another. The split route cuts each row's
visible rows into splits of `split_rows(block_k)` rows (`split_schedule`),
sizes its grid and workspace by `split_grid`, and merges each query row's
partials in the launch, in ascending split order. The CUDA-core route
(`attend_block` of `csrc/attn_common.cuh`, the design the two replaced) is
taken by no call here; the C interfaces keep it for timing harnesses that
patch `attn_route`.

Pipeline-parallel modes (flash_attn.py:827, :1018-1023, :275-291 there):
`batch_offset` is the first cache row of the call's B rows, so a microbatch
runs against the full-batch flat cache [L, B_cache, H, S, D] (B_cache >=
batch_offset + B) without slicing it; `commit=0` (the update only) writes
no row, leaving every cache byte as it was, and attends over the unchanged
rows, as the JAX kernel's idle pipeline hop does. Both are flat only: a
page table, a ring or a prefix pool with them raises ValueError. The batch
slice is taken only when the caller passes `batch_offset` (the pipeline
passes one for every microbatch, 0 included); without it a flat cache must
hold exactly the call's B rows, or the call raises ValueError.

On CPU tensors both compute their plain version (`*_ref`): the same cache
write (paged: straight into the pool through the table), then the dense
masked softmax of `attend_ref` (paged: over the logical view gathered
through the table, `gather_pages`) with the kernels'
rounding points (q scaled and rounded to bf16; int8 scores times the key
scale; the probabilities exp(s - max), unnormalized, times the value scale,
rounded to bf16, and the PV sum divided by the f32 sum of the unscaled
probabilities at the end; none of these roundings for an f32 cache). The
kernels use the online softmax over KV blocks of `block_k` rows, whose
running max is the row's max once the block that holds it is reached (all
of it for a cache of one block, where the plain version rounds the same
values); `_fit_block_k` picks that block exactly as the JAX package does, so
pinning `block_k` pins the accumulation order.
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
# path, cache mode, route (`_split`: the split route, `_tc`: the tensor-core
# route) and cache type; the update path's page_straddle mode on its own;
# every cache type in every mode, on every route
_MODES = (("update", ""), ("update", "_paged"), ("update", "_paged_straddle"), ("read", ""),
          ("read", "_paged"), ("update", "_ring"), ("read", "_ring"), ("update", "_prefix"),
          ("read", "_prefix"))
launches = {f"{path}{mode}{route}{kind}": 0 for path, mode in _MODES
            for route in ("", "_split", "_tc") for kind in ("", "_i8", "_f32")}
# the pipeline-parallel modes: a batch slice of a wider flat cache (`boff`),
# and the update with commit=0 (`nocommit`), every cache type
launches.update({f"{path}_{mode}{route}{kind}": 0 for path, mode in (
    ("update", "boff"), ("read", "boff"), ("update", "nocommit"))
    for route in ("", "_split", "_tc") for kind in ("", "_i8", "_f32")})
# launches by shape (path, B, T, H, S, D, block_k, cache type: "bf16",
# "int8" or "f32", n_past: the int, or None for a per-row vector, MAXLB: the
# page table's width, or None for a flat cache, page_straddle, mode: None,
# ("ring", ring_bounded), ("prefix", NP, Sp, pblock_k), or ("boff" or
# "nocommit", B_cache, batch_offset); S is a page's rows when paged), so a
# caller can check every shape a run reached
shapes: collections.Counter = collections.Counter()


# the cache types of the kernels, as shape keys name them, and the code the
# C interfaces take (`kv_kind` of csrc/flash_attn.cu and flash_decode.cu)
KV_KINDS = {torch.bfloat16: "bf16", torch.int8: "int8", torch.float32: "f32"}
KV_CODES = {"bf16": 0, "int8": 1, "f32": 2}
# the attention routes of csrc/flash_attn.cu and csrc/flash_decode.cu
# (`route` of their C interfaces)
ROUTE_CODES = {"cuda_core": 0, "tensor_core": 1, "split": 2}
ROUTE_SUFFIX = {"cuda_core": "", "tensor_core": "_tc", "split": "_split"}
TC_MIN_T = 16  # the least T of the tensor-core route, every cache type (attn::mma::MIN_T)
SPLIT_ROWS = 64  # a split's rows where they divide block_k (attn::split::split_rows)
SPLIT_MAX_ROWS = 512  # attn::split::MAX_ROWS
SPLIT_MAX_GRID = 256  # attn::split::MAX_SPLITS


def attn_route(t: int, kind: str) -> str:
    """The route of K2/K3's attention launch (and K4's, at T = 1) for T
    query rows over a cache of type `kind`: "split" (`csrc/attn_split.cuh`)
    for T from 1 to TC_MIN_T - 1, "tensor_core" (`csrc/attn_mma.cuh`; bf16
    products over a bf16 or int8 cache, three TF32 passes a product over an
    f32 one) at T >= TC_MIN_T, over every cache type. It depends on T and
    the cache type alone (today every type takes every route)."""
    del kind  # no route excludes a cache type
    return "tensor_core" if t >= TC_MIN_T else "split"


def launch_name(path: str, kind: str, paged: bool, straddle: bool = False,
                mode: str = "", route: str = "cuda_core") -> str:
    """The `launches` key of one call: update/read/decode, paged (and
    straddling), ring or prefix (`mode`), the split or tensor-core route
    (`_split`, `_tc`), cache type `kind` (bf16, int8, f32)."""
    return (path + ("_paged" if paged else "") + ("_straddle" if straddle else "")
            + (f"_{mode}" if mode else "") + ROUTE_SUFFIX[route]
            + {"bf16": "", "int8": "_i8", "f32": "_f32"}[kind])


def split_rows(block_k: int) -> int:
    """Rows of one split of the split route: 64 where 64 divides block_k,
    else block_k. A function of block_k alone, so a row's splits are the
    same in K2 and K4, flat and paged at block_k = PS (block_k divides the
    page, so no split crosses one), in a ring before its wrap and a flat
    cache, under a prefix of length 0 and without one."""
    return SPLIT_ROWS if block_k % SPLIT_ROWS == 0 else block_k


def split_schedule(limit: int, block_k: int) -> list[tuple[int, int]]:
    """The splits [start, end) of rows [0, limit), in ascending order (the
    order the kernel merges their partials in)."""
    r = split_rows(block_k)
    return [(s, min(s + r, limit)) for s in range(0, limit, r)]


def split_grid(cap: int, block_k: int, pool_rows: int = 0, pool_block_k: int = 0) -> int:
    """The splits of a split-route grid: those of a prefix pool's `pool_rows`
    (by its own block) ahead of those of the `cap` rows a batch row can
    address (S, MAXLB * PS). The kernel refuses any other count."""
    n = len(split_schedule(cap, block_k))
    if pool_rows:
        n += len(split_schedule(pool_rows, pool_block_k))
    return n


# the split route's arrival counters, one zeroed int32 tensor per device,
# grown when a call needs more (never while a CUDA graph captures: the
# captured launches and eager ones share them); each merge sets its counters back to 0 (the
# launches of a device share them in stream order)
_split_counters: dict[str, torch.Tensor] = {}


def split_workspace(q: torch.Tensor, nx: int):
    """(partials, counters) for a split-route launch with queries q [B, T,
    H, D] over `nx` splits: partials [B, H, T, nx, D + 2] f32 (torch.empty),
    the device's counters (at least B * H: one a (b, h) for all T rows).
    Raises past the kernel's limits."""
    b, t, h, d = q.shape
    if nx > SPLIT_MAX_GRID:
        raise ValueError(f"split route: {nx} splits a row, more than {SPLIT_MAX_GRID}")
    if not 1 <= t < TC_MIN_T:
        raise ValueError(f"split route: T = {t} query rows, not 1 to {TC_MIN_T - 1}")
    ws = torch.empty(b * h * t * nx * (d + 2), dtype=torch.float32, device=q.device)
    cnt = _split_counters.get(str(q.device))
    if cnt is None or cnt.numel() < b * h:
        _build.refuse_while_capturing(q.device, "the split route's counters")
        cnt = torch.zeros(max(b * h, 1024), dtype=torch.int32, device=q.device)
        _split_counters[str(q.device)] = cnt
    return ws, cnt


def split_args(route: str, q: torch.Tensor, cap: int, bk: int, mode=None) -> tuple:
    """(workspace pointer, counters pointer, nx) of a launch: nulls off the
    split route; `mode` the shape-key mode, whose ("prefix", NP, Sp,
    pblock_k) adds the pool's splits."""
    if route != "split":
        return None, None, 0
    if split_rows(bk) > SPLIT_MAX_ROWS:
        raise ValueError(f"split route: block_k {bk} makes splits of more than "
                         f"{SPLIT_MAX_ROWS} rows")
    pool = (mode[2], mode[3]) if mode is not None and mode[0] == "prefix" else (0, 0)
    nx = split_grid(cap, bk, *pool)
    ws, cnt = split_workspace(q, nx)
    return ws.data_ptr(), cnt.data_ptr(), nx


def call_launch(path: str, q: torch.Tensor, k: torch.Tensor, paged: bool,
                straddle: bool = False, mode: str = "") -> tuple[str, str]:
    """(route, `launches` key) of a K2 (`path` "update") or K3 ("read")
    call with queries q [B, T, H, D] over the cache k: the route from T and
    the cache type (`attn_route`), whatever B and the mode."""
    kind = KV_KINDS[k.dtype]
    route = attn_route(q.shape[1], kind)
    return route, launch_name(path, kind, paged, straddle, mode, route)


def pp_mode(k: torch.Tensor, b: int, batch_offset: int | None, commit: int = 1,
            page_table=None, ring: bool = False, prefix: bool = False):
    """The pipeline-parallel mode of a call on the cache k with B = b rows,
    as (launch-key mode, shape-key mode): ("nocommit", ("nocommit",
    B_cache, offset)) for commit=0, ("boff", ("boff", B_cache,
    batch_offset)) when the caller passes a `batch_offset` (0 included: a
    pipeline passes one for every microbatch), else ("", None). Raises
    ValueError where the offset rows leave the cache, where the mode meets a
    page table, ring or prefix pool, or where a flat cache without a
    `batch_offset` does not hold exactly the B rows (commit=0 too: without
    an offset it runs on a cache of just the B rows)."""
    if batch_offset is None and page_table is None and k.shape[1] != b:
        raise ValueError(f"attention: cache {tuple(k.shape)} does not fit {b} batch rows "
                         "(pass batch_offset to run on a slice of it)")
    if commit and batch_offset is None:
        return "", None
    if page_table is not None or ring or prefix:
        raise ValueError("batch_offset and commit=0 take a flat cache with no ring or "
                         "prefix pool")
    off = batch_offset or 0
    if not 0 <= off <= k.shape[1] - b:
        raise ValueError(f"batch rows [{off}, {off + b}) leave the cache's {k.shape[1]}")
    name = "boff" if commit else "nocommit"
    return name, (name, k.shape[1], off)


def _rows_of(planes, batch_offset: int, b: int) -> list:
    """The cache planes' views of batch rows [batch_offset, batch_offset + b)
    (None stays None)."""
    return [None if p is None else p[:, batch_offset : batch_offset + b] for p in planes]


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
    """The KV block step of a cache type: 32 rows for int8, else 8 (bf16 and
    f32, as engine.py:137-138 there)."""
    return 32 if cache_dtype == torch.int8 else 8


def attention_ref(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, n_past, scale: float | None = None,
    kv_pos: torch.Tensor | None = None,
) -> torch.Tensor:
    """Dense scores over the whole cache (parity oracle, flash_attn.py:99;
    with a ring's position plane `kv_pos` [S, B], the mask of llama.py:306-309
    there). q [B, T, H, D]; k, v [B, H, S, D]; returns f32 [B, T, H, D].
    Scores are scaled by `scale`, 1/sqrt(D) unless given."""
    b, t, h, d = q.shape
    s = k.shape[2]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    qf = q.to(k.dtype).to(torch.float32)
    scores = torch.einsum("bthd,bhsd->bhts", qf, k.to(torch.float32)) * scale
    visible = (visible_mask(n_past, b, t, s, q.device) if kv_pos is None
               else ring_visible(kv_pos, n_past, b, t))
    scores = scores.masked_fill(~visible[:, None], float("-inf"))
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


def ring_visible(kv_pos: torch.Tensor, n_past, b: int, t: int) -> torch.Tensor:
    """[B, T, S] bool: ring row j is visible to query t of row b iff
    0 <= kv_pos[j, b] <= n_past[b] + t (flash_attn.py:763-778 there; the
    positions compared as integers)."""
    pos = kv_pos.t().to(torch.int64)[:, None, :]  # [B, 1, S]
    tpos = _npast_rows(n_past, b, kv_pos.device)[:, None] + torch.arange(t, device=kv_pos.device)
    return (pos >= 0) & (pos <= tpos[:, :, None])


def prefix_rows(prefix_k, prefix_v, prefix_id, prefix_len, layer_idx: int, t: int):
    """The pool rows each batch row attends before its cache: (k, v) of
    entry prefix_id[b] of layer `layer_idx`, [B, H, Sp, D] bf16, and their
    mask [B, T, Sp] (row j visible iff j < prefix_len[b]: no causal mask,
    every query sits past the prefix)."""
    ids = prefix_id.to(torch.int64)
    pk, pv = prefix_k[layer_idx][ids], prefix_v[layer_idx][ids]
    sp = pk.shape[2]
    vis = torch.arange(sp, device=pk.device)[None, :] < prefix_len.to(pk.device)[:, None].long()
    return pk, pv, vis[:, None, :].expand(-1, t, -1)


def attend_ref(q, k_l, v_l, visible, k_scale_l=None, v_scale_l=None, prefix=None) -> torch.Tensor:
    """Dense attention with the kernels' rounding points. q [B, T, H, D];
    k_l/v_l one cache layer [B, H, S, D] (bf16 or int8); visible [B, T, S];
    k_scale_l/v_scale_l that layer's [B, S, H] scale planes for int8;
    `prefix` (pk, pv, mask) bf16 pool rows [B, H, Sp, D] in the same softmax
    (`prefix_rows`). q is scaled by 1/sqrt(D) in f32 and rounded to bf16
    before the QK product (flash_attn.py:545 there); an int8 score is
    multiplied by its key's scale; the probabilities exp(s - max) are
    multiplied by the value scales (cache rows only) and rounded to bf16
    before the PV product, and the sum is divided by l, the f32 sum of the
    unscaled probabilities, at the end (:783-808 there).
    An f32 cache rounds neither q nor the probabilities (the products are in
    the cache's type there, :749, :798): a product here is exact f32, where
    the kernels' tensor-core route (T >= 16) sums three TF32 passes a
    product (each operand's TF32 hi and lo parts; within the f32 limit,
    2^-12 of attention(q, k, |v|)); the bf16 pool's rows take q and p
    rounded to bf16 over any cache (:697-713). Returns f32 [B, T, H, D]."""
    d = q.shape[-1]
    rnd = torch.float32 if k_l.dtype == torch.float32 else torch.bfloat16
    qf = q.to(torch.float32) * (1.0 / math.sqrt(d))
    qs = qf.to(rnd).to(torch.float32)
    scores = torch.einsum("bthd,bhsd->bhts", qs, k_l.to(torch.float32))
    if k_scale_l is not None:
        scores = scores * k_scale_l.transpose(1, 2)[:, :, None, :]
    scores = scores.masked_fill(~visible[:, None], float("-inf"))
    sp = 0
    if prefix is not None:
        pk, pv, pvis = prefix
        qb = qf.to(torch.bfloat16).to(torch.float32)
        pscores = torch.einsum("bthd,bhsd->bhts", qb, pk.to(torch.float32))
        scores = torch.cat([pscores.masked_fill(~pvis[:, None], float("-inf")), scores], dim=-1)
        sp = pk.shape[2]
    p = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1, keepdim=True)  # [B, H, T, 1], before the value scales
    pp, p = p[..., :sp], p[..., sp:]
    if v_scale_l is not None:
        p = p * v_scale_l.transpose(1, 2)[:, :, None, :]
    out = torch.einsum("bhts,bhsd->bhtd", p.to(rnd).to(torch.float32), v_l.to(torch.float32))
    if prefix is not None:
        out = out + torch.einsum("bhts,bhsd->bhtd", pp.to(torch.bfloat16).to(torch.float32),
                                 pv.to(torch.float32))
    return (out / l).transpose(1, 2)


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
    """cache[layer_idx, b, :, n_past[b] + t] = new[b, t] (in place): the rows
    cast to the cache's type for a bf16 or f32 cache (an f32 cache holds them
    as they arrive); for an int8 cache the rows of bf16(new) quantized
    by `quantize_rows`, and their scales into k_scale/v_scale. With a page
    table, logical row j of batch row b goes to page `page_table[b, j // PS]`,
    row `j % PS`, of the pool. A ring passes its physical write rows as
    `n_past`."""
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
                        k_scale=None, v_scale=None, page_table=None, kv_pos=None,
                        ring_bounded: bool = False, prefix_k=None, prefix_v=None,
                        prefix_id=None, prefix_len=None, batch_offset: int | None = None):
    """Plain version of `flash_attention`: dense attention over layer
    `layer_idx` of the stacked cache (its batch rows from `batch_offset`),
    or over the logical view of the pool gathered through `page_table`, or
    over a ring masked by `kv_pos`, after the rows of a shared prefix
    (`attend_ref`). `ring_bounded` changes nothing here: the kernels' bound
    only skips rows that an engine-filled ring masks anyway."""
    del block_k, ring_bounded  # the dense softmax has no KV blocks and no bound
    _check_modes(page_table, kv_pos, prefix_k)
    b, t = q.shape[:2]
    if pp_mode(k, b, batch_offset, 1, page_table, kv_pos is not None, prefix_k is not None)[1]:
        k, v, k_scale, v_scale = _rows_of([k, v, k_scale, v_scale], batch_offset or 0, b)
    planes = [k[layer_idx], v[layer_idx], *_layer_scales(k_scale, v_scale, layer_idx)]
    if page_table is not None:
        planes = [None if p is None else gather_pages(p, page_table) for p in planes]
    if kv_pos is not None:
        visible = ring_visible(kv_pos, n_past, b, t)
    else:
        visible = visible_mask(n_past, b, t, planes[0].shape[2], q.device)
    prefix = None
    if prefix_k is not None:
        prefix = prefix_rows(prefix_k, prefix_v, prefix_id, prefix_len, layer_idx, t)
    return attend_ref(q, *planes[:2], visible, *planes[2:], prefix=prefix)


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
    k_scale=None, v_scale=None, page_table=None, page_straddle: bool = False, kv_pos=None,
    write_row=None, ring_bounded: bool = False, prefix_k=None, prefix_v=None, prefix_id=None,
    prefix_len=None, commit: int = 1, batch_offset: int | None = None,
):
    """Plain version of `flash_attention_update`: the cache write (a ring's
    at `write_row`; into batch rows from `batch_offset`; none when `commit`
    is 0), then the dense attention. Returns (out, k, v), plus (k_scale,
    v_scale) for an int8 cache, every cache plane updated in place."""
    _check_modes(page_table, kv_pos, prefix_k, write_row, update=True)
    _check_block_t(q.shape[1], block_t, n_past, k.shape[3], page_table, page_straddle)
    b = q.shape[0]
    planes = [k, v, k_scale, v_scale]
    if pp_mode(k, b, batch_offset, commit, page_table, kv_pos is not None,
               prefix_k is not None)[1]:
        planes = _rows_of(planes, batch_offset or 0, b)
    if commit:
        write_rows(k_new, v_new, planes[0], planes[1], n_past if kv_pos is None else write_row,
                   layer_idx, planes[2], planes[3], page_table)
    out = flash_attention_ref(q, *planes[:2], n_past, layer_idx, block_k, *planes[2:],
                              page_table, kv_pos, ring_bounded, prefix_k, prefix_v, prefix_id,
                              prefix_len)
    return (out, k, v) if k_scale is None else (out, k, v, k_scale, v_scale)


def _check_modes(page_table, kv_pos, prefix_k, write_row=None, update: bool = False) -> None:
    """The JAX wrappers' mode asserts (flash_attn.py:857-864, :1045-1051
    there): ring and prefix exclude each other and a page table; a ring's
    update names its physical write rows."""
    if kv_pos is not None and prefix_k is not None:
        raise ValueError("shared-prefix attention: non-ring slot caches only")
    if page_table is not None and (kv_pos is not None or prefix_k is not None):
        raise ValueError("paged KV: non-ring caches, no prefix-pool pre-pass")
    if update and (write_row is None) != (kv_pos is None):
        raise ValueError("a ring update needs both kv_pos and write_row")


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


class _Modes(ctypes.Structure):
    """`AttnModes` of csrc/flash_attn.cu: the ring and prefix operands."""

    _fields_ = [("pos", ctypes.c_void_p), ("ring_bounded", ctypes.c_int),
                ("wrow_vec", ctypes.c_void_p), ("wrow_scalar", ctypes.c_int),
                ("has_wrow", ctypes.c_int), ("pk", ctypes.c_void_p), ("pv", ctypes.c_void_p),
                ("pid", ctypes.c_void_p), ("plen", ctypes.c_void_p), ("sp", ctypes.c_int),
                ("pblock_k", ctypes.c_int)]


@functools.cache
def _lib():
    lib = _build.load("flash_attn")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    modes = ctypes.POINTER(_Modes)
    lib.attn_read_launch.argtypes = [p, p, p, p, p, p, p, i, p, i, i, i, i, i, i, i, f, i, i,
                                     modes, i, p, p, i, p]
    lib.attn_read_launch.restype = ctypes.c_int
    lib.attn_update_launch.argtypes = [p, p, p, p, p, p, p, p, p, i, p, i, i, i, i, i, i, i, f,
                                       i, i, i, modes, i, p, p, i, p]
    lib.attn_update_launch.restype = ctypes.c_int
    lib.attn_launch_count.argtypes = []
    lib.attn_launch_count.restype = ctypes.c_long
    return lib


def cuda_launches() -> int:
    """The CUDA kernels `csrc/flash_attn.cu` has launched in this process
    (every attention kernel and row write), where `launches` counts wrapper
    calls: the difference over one call is that call's kernel launches.
    Kernels that CUDA graph replays launched count too (`_build.replayed`)."""
    return _lib().attn_launch_count() + _build.replayed["flash_attn"]


def _on_device(x, q, what: str, dtype=torch.int32, shape=None) -> None:
    """x must be a contiguous `dtype` CUDA tensor of `shape` on q's device."""
    if (not isinstance(x, torch.Tensor) or x.dtype != dtype or not x.is_cuda
            or x.device != q.device or not x.is_contiguous()
            or (shape is not None and tuple(x.shape) != tuple(shape))):
        raise ValueError(f"attention kernel: {what} must be a contiguous {dtype} CUDA tensor "
                         f"of shape {shape} on q's device")


def _query(q, k) -> torch.Tensor:
    """q as the kernels take it: f32 over an f32 cache (exact for bf16
    activations; the JAX kernel widens q to f32 there), else as given."""
    if k.dtype != torch.float32:
        return q
    return q.to(torch.float32).contiguous()


def check_cuda(q, k, v, n_past, layer_idx, k_scale=None, v_scale=None, tensors=(),
               page_table=None, ring: bool = False, pp: bool = False):
    """Validate kernel operands (q and new rows bf16, f32 for an f32 cache;
    a bf16 cache, an int8 cache with f32 scale planes, or an f32 cache;
    flat [L, B, H, S, D] with scales [L, B, S, H] (with `pp`, a wider flat
    cache that `pp_mode` has checked), or a pool [L, NP, H, PS, D] with
    scales [L, NP, PS, H] and an int32 [B, MAXLB] page table). Returns
    (npast_ptr, npast_scalar, cache type, k_scale_ptr, v_scale_ptr,
    table_ptr, MAXLB) for layer_idx. A ring's n_past is logical and may pass
    the cache's rows."""
    b, t, h, d = q.shape
    paged = page_table is not None
    if (k.dim() != 5 or k.shape != v.shape or k.shape[2] != h or k.shape[4] != d
            or not (paged or pp or k.shape[1] == b)):
        raise ValueError(f"attention: cache {tuple(k.shape)} does not fit q {tuple(q.shape)}")
    if d not in (64, 128):
        raise ValueError(f"attention kernel: head_dim must be 64 or 128, got {d}")
    if not 0 <= layer_idx < k.shape[0]:
        raise ValueError(f"attention: layer {layer_idx} out of range")
    if k.dtype not in KV_KINDS or v.dtype != k.dtype:
        raise ValueError(f"attention kernel: cache must be bf16, int8 or f32, got "
                         f"{k.dtype}/{v.dtype}")
    kind = KV_KINDS[k.dtype]
    quant = kind == "int8"
    qtype = torch.float32 if kind == "f32" else torch.bfloat16
    scales = (k_scale, v_scale) if quant else ()
    if quant:
        want = (k.shape[0], k.shape[1], k.shape[3], h)
        for sc in scales:
            if sc is None or sc.dtype != torch.float32 or tuple(sc.shape) != want:
                raise ValueError(f"attention kernel: an int8 cache needs f32 scales {want}")
    elif k_scale is not None or v_scale is not None:
        raise ValueError("attention kernel: scale planes belong to an int8 cache")
    for x in (q, *tensors):
        if x.dtype != qtype:
            raise ValueError(f"attention kernel: q and new rows must be {qtype} over a {kind} "
                             f"cache, got {x.dtype}")
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
        if not 0 <= n_past <= (n_past if ring else cap - t):
            raise ValueError(f"attention: n_past {n_past} + T {t} exceeds the cache ({cap})")
        return None, n_past, kind, *sptr, *tptr
    if n_past.shape != (b,) or n_past.dtype != torch.int32 or n_past.device != q.device:
        raise ValueError("attention kernel: vector n_past must be int32 [B] on q's device")
    return n_past.data_ptr(), 0, kind, *sptr, *tptr


def _modes(q, k, layer_idx, bk, kv_pos=None, write_row=None, ring_bounded=False,
           prefix_k=None, prefix_v=None, prefix_id=None, prefix_len=None):
    """The `_Modes` of a call on CUDA tensors after checking its ring and
    prefix operands, and its shape-key mode: None, ("ring", bounded) or
    ("prefix", NP, Sp, pblock_k)."""
    b, t, h, d = q.shape
    m = _Modes()
    if kv_pos is not None:
        _on_device(kv_pos, q, "kv_pos", shape=(k.shape[3], b))
        m.pos, m.ring_bounded = kv_pos.data_ptr(), int(ring_bounded)
        if write_row is not None:
            m.has_wrow = 1
            if isinstance(write_row, int):
                if not 0 <= write_row <= k.shape[3] - t:
                    raise ValueError(f"ring write rows [{write_row}, {write_row + t}) leave the "
                                     f"ring of {k.shape[3]} rows")
                m.wrow_scalar = write_row
            else:
                _on_device(write_row, q, "write_row", shape=(b,))
                m.wrow_vec = write_row.data_ptr()
        return m, ("ring", bool(ring_bounded))
    if prefix_k is None:
        return m, None
    if (prefix_k.dim() != 5 or prefix_v is None or prefix_v.shape != prefix_k.shape
            or prefix_k.shape[0] != k.shape[0] or prefix_k.shape[2] != h
            or prefix_k.shape[4] != d):
        raise ValueError(f"attention: prefix pool {tuple(prefix_k.shape)} does not fit the "
                         f"cache {tuple(k.shape)}")
    npool, sp = prefix_k.shape[1], prefix_k.shape[3]
    for x, what in ((prefix_k, "prefix_k"), (prefix_v, "prefix_v")):
        _on_device(x, q, what, torch.bfloat16)
    for x, what in ((prefix_id, "prefix_id"), (prefix_len, "prefix_len")):
        _on_device(x, q, what, shape=(b,))
    pbk = _fit_block_k(min(bk, sp), sp)
    m.pk, m.pv = prefix_k[layer_idx].data_ptr(), prefix_v[layer_idx].data_ptr()
    m.pid, m.plen, m.sp, m.pblock_k = prefix_id.data_ptr(), prefix_len.data_ptr(), sp, pbk
    return m, ("prefix", npool, sp, pbk)


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
    kv_pos: torch.Tensor | None = None,  # [S, B] int32: history-ring positions
    ring_bounded: bool = False,  # ragged bound on rings with kv_pos[r] >= r
    prefix_k: torch.Tensor | None = None,  # [L, NP, H, Sp, D] bf16 shared pool
    prefix_v: torch.Tensor | None = None,
    prefix_id: torch.Tensor | None = None,  # [B] int32 pool entry per row
    prefix_len: torch.Tensor | None = None,  # [B] int32 valid prefix rows
    batch_offset: int | None = None,  # first cache row of the B rows (flat, pipeline stages)
) -> torch.Tensor:
    """Causal attention of T queries over layer `layer_idx` of a cache that
    already holds their rows (K3). Returns f32 [B, T, H, D]."""
    if not q.is_cuda:
        return flash_attention_ref(q, k, v, n_past, layer_idx, block_k, k_scale, v_scale,
                                   page_table, kv_pos, ring_bounded, prefix_k, prefix_v,
                                   prefix_id, prefix_len, batch_offset)
    _check_modes(page_table, kv_pos, prefix_k)
    _, pmode = pp_mode(k, q.shape[0], batch_offset, 1, page_table, kv_pos is not None,
                           prefix_k is not None)
    q = _query(q, k)
    npv, nps, kind, ksp, vsp, tab, maxlb = check_cuda(q, k, v, n_past, layer_idx, k_scale,
                                                      v_scale, page_table=page_table,
                                                      ring=kv_pos is not None,
                                                      pp=pmode is not None)
    b, t, h, d = q.shape
    s = k.shape[3]
    bk = _fit_block_k(block_k, s, kv_step(k.dtype))
    modes, mode = _modes(q, k, layer_idx, bk, kv_pos, None, ring_bounded, prefix_k, prefix_v,
                         prefix_id, prefix_len)
    mode = mode or pmode
    route, key = call_launch("read", q, k, tab is not None, mode=mode and mode[0])
    out = torch.empty((b, t, h, d), dtype=torch.float32, device=q.device)
    split = split_args(route, q, s * (maxlb or 1), bk, mode)
    rc = _lib().attn_read_launch(
        q.data_ptr(), k[layer_idx].data_ptr(), v[layer_idx].data_ptr(), ksp, vsp,
        out.data_ptr(), npv, nps, tab, maxlb, b, t, h, s, d, bk, 1.0 / math.sqrt(d),
        KV_CODES[kind], batch_offset or 0, ctypes.byref(modes), ROUTE_CODES[route], *split,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(rc, "attn_read_launch")
    launches[key] += 1
    shapes[("read", b, t, h, s, d, bk, kind, n_past if npv is None else None,
            maxlb or None, False, mode)] += 1
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
    kv_pos: torch.Tensor | None = None,  # [S, B] int32: history-ring positions
    write_row=None,  # int or [B] int32: the ring's physical write rows
    ring_bounded: bool = False,  # ragged bound on rings with kv_pos[r] >= r
    prefix_k: torch.Tensor | None = None,  # [L, NP, H, Sp, D] bf16 shared pool
    prefix_v: torch.Tensor | None = None,
    prefix_id: torch.Tensor | None = None,  # [B] int32 pool entry per row
    prefix_len: torch.Tensor | None = None,  # [B] int32 valid prefix rows
    commit: int = 1,  # 0: write nothing, attend over the unchanged cache
    batch_offset: int | None = None,  # first cache row of the B rows (flat, pipeline stages)
):
    """Writes the T new K/V rows at [n_past[b], n_past[b] + T) of layer
    `layer_idx` IN PLACE (int8: the rows of bf16(k_new) quantized, and their
    scales; a ring: at [write_row[b], write_row[b] + T); batch row b at cache
    row batch_offset + b; nothing when `commit` is 0), then attends (K2).
    Returns (out [B, T, H, D] f32, k, v), plus (k_scale, v_scale) for an int8
    cache. Requires T % min(block_t, T) == 0, as the JAX kernel does, and,
    paged, that every block of block_t rows lies in one page (checked for a
    host-int n_past; `check_paged_write`), unless `page_straddle`: then rows
    cross into the next logical page, and n_past + T <= MAXLB * PS."""
    if not q.is_cuda:
        return flash_attention_update_ref(q, k_new, v_new, k, v, n_past, layer_idx,
                                          block_t, block_k, k_scale, v_scale, page_table,
                                          page_straddle, kv_pos, write_row, ring_bounded,
                                          prefix_k, prefix_v, prefix_id, prefix_len, commit,
                                          batch_offset)
    _check_modes(page_table, kv_pos, prefix_k, write_row, update=True)
    _check_block_t(q.shape[1], block_t, n_past, k.shape[3], page_table, page_straddle)
    _, pmode = pp_mode(k, q.shape[0], batch_offset, commit, page_table, kv_pos is not None,
                           prefix_k is not None)
    q = _query(q, k)
    # the cast flash_attn.py:1101-1103 makes (to an f32 cache's type; an int8
    # cache quantizes bf16 rows)
    kn, vn = (x.to(q.dtype).contiguous() for x in (k_new, v_new))
    if kn.shape != q.shape or vn.shape != q.shape:
        raise ValueError("flash_attention_update: k_new/v_new must match q's shape")
    npv, nps, kind, ksp, vsp, tab, maxlb = check_cuda(q, k, v, n_past, layer_idx, k_scale,
                                                      v_scale, (kn, vn), page_table,
                                                      ring=kv_pos is not None,
                                                      pp=pmode is not None)
    b, t, h, d = q.shape
    s = k.shape[3]
    bk = _fit_block_k(block_k, s, kv_step(k.dtype))
    modes, mode = _modes(q, k, layer_idx, bk, kv_pos, write_row, ring_bounded, prefix_k,
                         prefix_v, prefix_id, prefix_len)
    mode = mode or pmode
    route, key = call_launch("update", q, k, tab is not None, page_straddle, mode and mode[0])
    out = torch.empty((b, t, h, d), dtype=torch.float32, device=q.device)
    split = split_args(route, q, s * (maxlb or 1), bk, mode)
    rc = _lib().attn_update_launch(
        q.data_ptr(), kn.data_ptr(), vn.data_ptr(), k[layer_idx].data_ptr(),
        v[layer_idx].data_ptr(), ksp, vsp, out.data_ptr(), npv, nps, tab, maxlb, b, t, h, s, d,
        bk, 1.0 / math.sqrt(d), KV_CODES[kind], batch_offset or 0, int(bool(commit)),
        ctypes.byref(modes), ROUTE_CODES[route], *split,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(rc, "attn_update_launch")
    launches[key] += 1
    shapes[("update", b, t, h, s, d, bk, kind, n_past if npv is None else None,
            maxlb or None, page_straddle, mode)] += 1
    return (out, k, v) if k_scale is None else (out, k, v, k_scale, v_scale)
