"""The split route at T from 2 to 15 query rows (`csrc/attn_split.cuh`:
K2 and K3's verify rounds, short chunks) on the CPU, where no kernel runs:
a torch emulation of the kernel's partials and merge for T rows (every query
row's (m, l, acc) per split against the split's own max, a split all masked
for a row skipped for it, the merge in ascending split order) held against
the JAX package's `flash_attention_update` at T = 4 and T = 8 (Pallas in
interpret mode) within the JAX tests' limits, over flat bf16, int8 and f32
caches with a vector n_past whose rows cross a split boundary, an int8 page
pool with a `page_straddle` write crossing a page, a history ring before and
after its wrap, and the shared-prefix pool at prefix lengths 0 and above;
the reduce-scatter's lane bookkeeping; the workspace's shape at T > 1. Each
JAX call compiles anew (2 s, 6 s for int8), so flat bf16 runs at both T and
every other case at one of them."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_paged_attn import _jkw, pool_planes, scrambled_table
from test_torch_split_decode import LAYER, NEG, REL, D, H, L, _bf16, _caches, _jbf16, _t

from llamavk_tpu.models import llama as jm
from llamavk_tpu.ops import flash_attn as jfa
from llamavk_tpu_torch.ops import flash_attn as tfa

torch.set_num_threads(2)


# ------------------------------------------------------------ the emulation


def rows_partial(qs, k, v, vis, ks=None, vs=None, rnd: bool = True):
    """The kernel's partials of one split for T query rows, every head at
    once: qs [T, H, D] scaled (and rounded) queries, k/v [H, n, D] the
    split's rows as f32 values, vis [T, n] bool, ks/vs [n, H] an int8
    cache's scales. m [T, H] is each row's max over the split (-1e30 where
    the split is all masked for it), p = exp(s - m) (0 where masked) counts
    into l before the value scale, and p times the value scale is rounded to
    bf16 (`rnd`) for the PV sum: acc [T, H, D]."""
    s = torch.einsum("thd,hnd->thn", qs, k)
    if ks is not None:
        s = s * ks.t()[None]
    s = torch.where(vis[:, None, :], s, torch.full_like(s, NEG))
    m = s.amax(-1)
    p = torch.where(s <= NEG * 0.5, torch.zeros_like(s), torch.exp(s - m[..., None]))
    l = p.sum(-1)
    if vs is not None:
        p = p * vs.t()[None]
    return m, l, torch.einsum("thn,hnd->thd", _bf16(p, rnd), v)


def merge_rows(parts):
    """The last block's merge, each query row on its own: the partials in
    ascending split order, scaled by exp(m - M) to the row's largest m; a
    split all masked for a row (m = -1e30) is skipped for that row."""
    m = torch.stack([p[0] for p in parts])
    live = m > NEG * 0.5
    big = torch.where(live, m, torch.full_like(m, NEG)).amax(0)
    l_sum = torch.zeros_like(big)
    acc = torch.zeros_like(parts[0][2])
    for (mi, li, ai), lv in zip(parts, live):
        e = torch.exp(mi - big)
        l_sum = torch.where(lv, li * e + l_sum, l_sum)
        acc = torch.where(lv[..., None], ai * e[..., None] + acc, acc)
    return acc / l_sum[..., None]


def segment_rows(q, k, v, vis, block_k: int, ks=None, vs=None, rnd: bool = True):
    """The partials of rows [0, n) of one segment (a row's cache rows, or
    its prefix pool rows) for T query rows, cut by `split_schedule`: q [T,
    H, D] raw, k/v [H, n, D] values, vis [T, n], ks/vs [n, H]."""
    qs = _bf16(q.float() * (1.0 / math.sqrt(q.shape[-1])), rnd)
    parts = []
    for a, b in tfa.split_schedule(k.shape[1], block_k):
        sc = (None, None) if ks is None else (ks[a:b], vs[a:b])
        parts.append(rows_partial(qs, k[:, a:b], v[:, a:b], vis[:, a:b], *sc, rnd=rnd))
    return parts


def causal(n_past: int, t: int, n: int) -> torch.Tensor:
    """[T, n]: row j visible to query row i iff j <= n_past + i."""
    return torch.arange(n)[None, :] <= n_past + torch.arange(t)[:, None]


def _check(got, want, lim):
    assert ((got - want).abs() <= lim).all(), float(((got - want).abs() / lim).max())


def _limit(kind, q, k, v, n_past, scales=(None, None), **mode):
    """REL x the plain attention over |v| on the updated torch planes."""
    if "prefix_v" in mode:
        mode = {**mode, "prefix_v": mode["prefix_v"].abs()}
    rel = REL["bf16"] if "prefix_v" in mode else REL[kind]
    return rel * tfa.flash_attention_ref(q, k, v.abs(), n_past, layer_idx=LAYER,
                                         k_scale=scales[0], v_scale=scales[1], **mode)


def _planes(kind, planes):
    """The updated JAX planes as torch tensors of the cache's type."""
    planes = [_t(x) for x in planes]
    if kind == "bf16":
        planes = [p.to(torch.bfloat16) for p in planes]
    return planes


def _cache_rows(planes, b: int, n: int):
    """Row b's first n cache rows of layer LAYER (flat): k/v [H, n, D] f32
    values, scales [n, H] (or None)."""
    k, v = (p[LAYER, b, :, :n].float() for p in planes[:2])
    if len(planes) == 2:
        return k, v, None, None
    return k, v, planes[2][LAYER, b, :n], planes[3][LAYER, b, :n]


# ------------------------------------------------------------------ flat


FLAT_S, FLAT_BK, FLAT_NPAST = 256, 64, [0, 61, 244]  # row 1's rows cross the split at 64


@pytest.fixture(scope="module", params=[("bf16", 4), ("bf16", 8), ("int8", 4), ("f32", 8)],
                ids=lambda p: f"{p[0]}-T{p[1]}")
def flat_case(request):
    """K2 (JAX flash_attention_update) at T rows, B = 3, a vector n_past."""
    kind, t = request.param
    rng = np.random.default_rng(61 + 3 * ["bf16", "int8", "f32"].index(kind) + t)
    b = len(FLAT_NPAST)
    new = [_jbf16(rng, (b, t, H, D)) for _ in range(3)]
    planes = _caches(rng, kind, (L, b, H, FLAT_S, D))
    kw = dict(k_scale=planes[2], v_scale=planes[3]) if kind == "int8" else {}
    got = jfa.flash_attention_update(*new, planes[0], planes[1],
                                     jnp.asarray(FLAT_NPAST, jnp.int32), jnp.int32(LAYER),
                                     block_k=FLAT_BK, **kw)
    return kind, t, _t(new[0]), _t(got[0]), _planes(kind, got[1:])


def test_flat_rows_match_jax(flat_case):
    """Each batch row's T query rows over rows [0, min(n_past + T, S)), cut
    into 64-row splits; where n_past + T crosses a split, the later split is
    all masked for the query rows before the boundary and adds nothing to
    them."""
    kind, t, q, want, planes = flat_case
    out = []
    for b, np_ in enumerate(FLAT_NPAST):
        n = min(np_ + t, FLAT_S)
        k, v, ks, vs = _cache_rows(planes, b, n)
        parts = segment_rows(q[b], k, v, causal(np_, t, n), FLAT_BK, ks, vs, rnd=kind != "f32")
        assert len(parts) == len(tfa.split_schedule(n, FLAT_BK))
        if np_ == 61:  # query rows 0-2 see up to row 63: split 1 is all masked for them
            assert bool((parts[1][0][: 64 - np_] == NEG).all())
            assert not parts[1][1][: 64 - np_].any() and not parts[1][2][: 64 - np_].any()
            assert bool((parts[1][0][64 - np_ :] > NEG).all())
        out.append(merge_rows(parts))
    got = torch.stack(out)
    npv = torch.tensor(FLAT_NPAST, dtype=torch.int32)
    scales = (planes[2], planes[3]) if kind == "int8" else (None, None)
    _check(got, want, _limit(kind, q.to(torch.bfloat16), *planes[:2], npv, scales))


# --------------------------------------------------------- paged straddle


PAGE_PS, PAGE_MAXLB, PAGE_NPAST = 32, 4, [30, 93]  # both rows' writes cross a page


@pytest.fixture(scope="module")
def straddle_case():
    """K2 int8 at T = 8 over a scrambled page pool (32-row pages, the KV
    block fitted to the page) with `page_straddle`: the T new rows of each
    batch row cross into its next logical page."""
    t = 8
    rng = np.random.default_rng(71 + t)
    b = len(PAGE_NPAST)
    n_pages = b * PAGE_MAXLB + 2
    jplanes, _ = pool_planes(rng, L, n_pages, H, PAGE_PS, D, True)
    table = scrambled_table(rng, n_pages, b, PAGE_MAXLB)
    new = [_jbf16(rng, (b, t, H, D)) for _ in range(3)]
    got = jfa.flash_attention_update(*new, *jplanes[:2], jnp.asarray(PAGE_NPAST, jnp.int32),
                                     jnp.int32(LAYER), block_t=t, block_k=PAGE_PS,
                                     page_straddle=True, **_jkw(jplanes, table))
    pool = [_t(x) for x in got[1:]]
    pool[2:] = [p[..., :H].contiguous() for p in pool[2:]]  # the JAX pool pads its head lanes
    return t, _t(new[0]), _t(got[0]), pool, torch.from_numpy(table)


def test_paged_straddle_rows_match_jax(straddle_case):
    """The splits (one a page at block_k = PS) read the logical view through
    the table; the rows the straddling write put in the next page are
    visible to the query rows at and after them."""
    t, q, want, pool, table = straddle_case
    view = [tfa.gather_pages(p[LAYER], table) for p in pool]  # [B, H, cap, D], [B, cap, H]
    out = []
    for b, np_ in enumerate(PAGE_NPAST):
        assert np_ // PAGE_PS != (np_ + t - 1) // PAGE_PS
        n = np_ + t
        k, v = (x[b, :, :n].float() for x in view[:2])
        parts = segment_rows(q[b], k, v, causal(np_, t, n), PAGE_PS, view[2][b, :n],
                             view[3][b, :n])
        out.append(merge_rows(parts))
    got = torch.stack(out)
    npv = torch.tensor(PAGE_NPAST, dtype=torch.int32)
    lim = REL["int8"] * tfa.flash_attention_ref(q.to(torch.bfloat16), pool[0], pool[1].abs(), npv,
                                                layer_idx=LAYER, k_scale=pool[2],
                                                v_scale=pool[3], page_table=table)
    _check(got, want, lim)


# ------------------------------------------------------------------- ring


RING_S, RING_KEEP, RING_BK = 128, 8, 32


RING_NPAST = [40, 300]  # row 0 before its wrap, row 1 after it


def _ring_plane(n_logical: list[int]) -> np.ndarray:
    """[S, B] positions after n_logical[b] rows went into row b."""
    pos = np.full((RING_S, len(n_logical)), -1, np.int32)
    for b, n in enumerate(n_logical):
        for p in range(n):
            pos[int(jm.ring_phys(jnp.int32(p), RING_KEEP, RING_S)), b] = p
    return pos


@pytest.fixture(scope="module")
def ring_case():
    """K2 bf16 at T = 4 over a 128-row ring (keep 8): row 0 before its wrap
    (n_past 40, the rows where a flat cache has them), row 1 after it
    (n_past 300, the T rows at physical rows 60...), the positions of the new
    rows already in the plane, ring_bounded as llama_forward passes it."""
    t = 4
    rng = np.random.default_rng(81)
    b = len(RING_NPAST)
    new = [_jbf16(rng, (b, t, H, D)) for _ in range(3)]
    planes = _caches(rng, "bf16", (L, b, H, RING_S, D))
    pos = _ring_plane([n + t for n in RING_NPAST])
    wrow = [int(jm.ring_phys(jnp.int32(n), RING_KEEP, RING_S)) for n in RING_NPAST]
    assert wrow[0] == RING_NPAST[0] and wrow[1] + t <= RING_S
    got = jfa.flash_attention_update(*new, planes[0], planes[1],
                                     jnp.asarray(RING_NPAST, jnp.int32), jnp.int32(LAYER),
                                     block_k=RING_BK, kv_pos=jnp.asarray(pos),
                                     write_row=jnp.asarray(wrow, jnp.int32), ring_bounded=True)
    return t, pos, _t(new[0]), _t(got[0]), _planes("bf16", got[1:])


def test_ring_rows_match_jax(ring_case):
    """The ring's bound: rows [0, min(n_past + T, S)), each visible to
    query row i where 0 <= pos <= n_past + i; before the wrap the mask and
    the splits are the flat cache's."""
    t, pos, q, want, planes = ring_case
    out = []
    for b, np_ in enumerate(RING_NPAST):
        n = min(np_ + t, RING_S)
        k, v, _, _ = _cache_rows(planes, b, n)
        p = torch.from_numpy(pos[:n, b]).long()
        vis = (p[None, :] >= 0) & (p[None, :] <= np_ + torch.arange(t)[:, None])
        assert torch.equal(vis, causal(np_, t, n)) == (np_ + t <= RING_S)
        out.append(merge_rows(segment_rows(q[b], k, v, vis, RING_BK)))
    got = torch.stack(out)
    _check(got, want, _limit("bf16", q.to(torch.bfloat16), *planes,
                             torch.tensor(RING_NPAST, dtype=torch.int32),
                             kv_pos=torch.from_numpy(pos)))


# ----------------------------------------------------------------- prefix


PRE_S, PRE_SP, PRE_BK = 64, 64, 32
PRE_NPAST, PRE_LEN, PRE_ID = [10, 29], [0, 45], [1, 2]  # row 1's rows cross a split


@pytest.fixture(scope="module")
def prefix_case():
    """K2 bf16 slots at T = 8 after the bf16 pool's rows: row 0 with no
    prefix, row 1 with 45 rows (two pool splits of 32)."""
    t = 8
    rng = np.random.default_rng(91)
    new = [_jbf16(rng, (2, t, H, D)) for _ in range(3)]
    planes = _caches(rng, "bf16", (L, 2, H, PRE_S, D))
    pool = [_jbf16(rng, (L, 3, H, PRE_SP, D)) for _ in range(2)]
    got = jfa.flash_attention_update(
        *new, planes[0], planes[1], jnp.asarray(PRE_NPAST, jnp.int32), jnp.int32(LAYER),
        block_k=PRE_BK, prefix_k=pool[0], prefix_v=pool[1],
        prefix_id=jnp.asarray(PRE_ID, jnp.int32), prefix_len=jnp.asarray(PRE_LEN, jnp.int32))
    return (t, _t(new[0]), _t(got[0]), _planes("bf16", got[1:]),
            [_t(x).to(torch.bfloat16) for x in pool])


def test_prefix_rows_match_jax(prefix_case):
    """The pool's splits (every pool row visible to every query row, q and p
    rounded to bf16) ahead of the slot splits; at prefix length 0 there are
    none, and the row's partials and output are the flat cache's, bit for
    bit."""
    t, q, want, planes, pool = prefix_case
    pbk = tfa._fit_block_k(min(PRE_BK, PRE_SP), PRE_SP)
    out = []
    for b, (np_, plen, pid) in enumerate(zip(PRE_NPAST, PRE_LEN, PRE_ID)):
        pk, pv = (x[LAYER, pid, :, :plen].float() for x in pool)
        parts = segment_rows(q[b], pk, pv, torch.ones((t, plen), dtype=torch.bool), pbk)
        assert len(parts) == (0, 2)[b]
        n = np_ + t
        k, v, ks, vs = _cache_rows(planes, b, n)
        flat = segment_rows(q[b], k, v, causal(np_, t, n), PRE_BK, ks, vs)
        out.append(merge_rows(parts + flat))
        if plen == 0:
            assert torch.equal(out[-1], merge_rows(flat))
    got = torch.stack(out)
    mode = dict(prefix_k=pool[0], prefix_v=pool[1],
                prefix_id=torch.tensor(PRE_ID, dtype=torch.int32),
                prefix_len=torch.tensor(PRE_LEN, dtype=torch.int32))
    _check(got, want, _limit("bf16", q.to(torch.bfloat16), *planes,
                             torch.tensor(PRE_NPAST, dtype=torch.int32), **mode))


# ------------------------------------------------- the kernel's bookkeeping


@pytest.mark.parametrize("ch", [4, 8, 16, 32])
def test_reduce_scatter_lanes(ch):
    """`reduce_scatter<G = 4, CH>` of attn_split.cuh, step for step on f32:
    after it, lane c of a key row holds the sum over the row's CH lanes of
    query u = c / (CH / 4)'s dots (the value it returns), and every lane of
    the same u holds the same bits, so any may write the score."""
    g = 4
    rng = np.random.default_rng(ch)
    s = rng.standard_normal((ch, g)).astype(np.float32)  # lane c's dots for the 4 query rows
    vals = [list(s[c]) for c in range(ch)]
    u0 = [0] * ch
    k, o = g // 2, ch // 2
    while k >= 1:
        new = []
        for c in range(ch):
            up = bool(c & o)
            got = [vals[c ^ o][u + k] if up else vals[c ^ o][u] for u in range(k)]  # its send
            new.append([np.float32((vals[c][u + k] if up else vals[c][u]) + got[u])
                        for u in range(k)])
            u0[c] += k if up else 0
        vals, k, o = new, k // 2, o // 2
    o = ch // (2 * g)
    while o > 0:
        vals = [[np.float32(vals[c][0] + vals[c ^ o][0])] for c in range(ch)]
        o //= 2
    for c in range(ch):
        u = c // (ch // g)
        assert u0[c] == u
        np.testing.assert_allclose(vals[c][0], s[:, u].sum(dtype=np.float64), rtol=1e-5)
        assert vals[c][0] == vals[u * (ch // g)][0]


@pytest.mark.parametrize("t", [2, 4, 8, 15])
def test_split_workspace_rows(t):
    """The workspace of a launch at T rows holds [B, H, T, nx, D + 2]
    partials (one counter a (b, h) for all T rows); a prefix pool's splits
    come ahead of the cache's; T past the split route is refused."""
    q = torch.zeros((3, t, H, D), dtype=torch.bfloat16)
    nx = tfa.split_grid(256, 64)
    ws, cnt = tfa.split_workspace(q, nx)
    assert ws.numel() == 3 * H * t * nx * (D + 2) and cnt.numel() >= 3 * H
    assert tfa.split_args("split", q, 256, 64, ("prefix", 3, 128, 32))[2] == nx + 4
    assert tfa.split_args("tensor_core", q, 256, 64) == (None, None, 0)
    with pytest.raises(ValueError, match="query rows"):
        tfa.split_workspace(torch.zeros((1, 16, H, D)), nx)
