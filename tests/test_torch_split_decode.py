"""The split route of the decode attention (T = 1, `csrc/attn_split.cuh`:
K2 and K3 at T = 1 and K4) on the CPU, where no kernel runs: the split
schedule (`ops/flash_attn.py::split_schedule`), by which the wrappers size
the kernel's grid and workspace; a torch emulation of the kernel's split
partials and fixed-order merge, held against the JAX package's
`flash_decode_update`, `flash_attention_update` and `flash_attention` at
T = 1 (Pallas in interpret mode) within the JAX tests' limits, over flat
bf16, int8 and f32 caches, a wrapped history ring with empty rows, and the
shared-prefix pool at prefix lengths 0 and above; the merge's rules for an
all-masked split and a single split; and `attn_route`."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llamavk_tpu.models import llama as jm
from llamavk_tpu.ops import flash_attn as jfa
from llamavk_tpu.ops import flash_decode as jfd
from llamavk_tpu.ops.kv_quant import quantize_rows as jquant
from llamavk_tpu_torch.ops import flash_attn as tfa

torch.set_num_threads(2)

NEG = -1e30  # the kernels' masked score
L, LAYER = 2, 1
H, D = 2, 64
# the JAX tests' limit of a kernel against the dense softmax: 2^-6 of
# attention(q, k, |v|) per element (tests/test_torch_flash_decode.py), 2^-12
# over an f32 cache (tests/test_torch_f32kv.py)
REL = {"bf16": 2.0**-6, "int8": 2.0**-6, "f32": 2.0**-12}


# ------------------------------------------------------------ the emulation


def _bf16(x: torch.Tensor, on: bool = True) -> torch.Tensor:
    return x.to(torch.bfloat16).float() if on else x


def split_partial(qs, k, v, vis, ks=None, vs=None, rnd: bool = True):
    """The kernel's partial (m, l, acc) of one split, every head at once: qs
    [H, D] the scaled (and rounded) query, k/v [H, n, D] the split's rows as
    f32 values, vis [n] bool, ks/vs [n, H] an int8 cache's scales. m is the
    split's own max, p = exp(s - m) (0 where masked) counts into l before
    the value scale, and p times the value scale is rounded to bf16 (`rnd`)
    for the PV sum."""
    s = torch.einsum("hd,hnd->hn", qs, k)
    if ks is not None:
        s = s * ks.t()
    s = torch.where(vis[None, :], s, torch.full_like(s, NEG))
    m = s.amax(-1)
    p = torch.where(s <= NEG * 0.5, torch.zeros_like(s), torch.exp(s - m[:, None]))
    l = p.sum(-1)
    if vs is not None:
        p = p * vs.t()
    return m, l, torch.einsum("hn,hnd->hd", _bf16(p, rnd), v)


def merge(parts):
    """The last split's merge: the partials in ascending split order, each
    scaled by exp(m - M) to the largest m; a split whose rows are all masked
    (m = -1e30) is skipped, so it adds exactly nothing."""
    m = torch.stack([p[0] for p in parts])
    live = m > NEG * 0.5
    big = torch.where(live, m, torch.full_like(m, NEG)).amax(0)
    l_sum = torch.zeros_like(big)
    acc = torch.zeros_like(parts[0][2])
    for (mi, li, ai), lv in zip(parts, live):
        e = torch.exp(mi - big)
        l_sum = torch.where(lv, li * e + l_sum, l_sum)
        acc = torch.where(lv[:, None], ai * e[:, None] + acc, acc)
    return acc / l_sum[:, None]


def segment_partials(q, k, v, vis, block_k: int, ks=None, vs=None, rnd: bool = True):
    """The partials of rows [0, n) of one segment (a row's cache rows, or its
    prefix pool rows), cut by `split_schedule`: q [H, D] raw, k/v [H, n, D]
    values, vis [n], ks/vs [n, H]."""
    qs = _bf16(q.float() * (1.0 / math.sqrt(q.shape[-1])), rnd)
    parts = []
    for a, b in tfa.split_schedule(k.shape[1], block_k):
        sc = (None, None) if ks is None else (ks[a:b], vs[a:b])
        parts.append(split_partial(qs, k[:, a:b], v[:, a:b], vis[a:b], *sc, rnd=rnd))
    return parts


def _t(x) -> torch.Tensor:
    """A JAX array as a torch tensor (bf16 through f32)."""
    a = np.asarray(x.astype(jnp.float32) if x.dtype == jnp.bfloat16 else x)
    return torch.from_numpy(a.copy())


def _jbf16(rng, shape):
    return jnp.asarray(rng.standard_normal(shape), jnp.bfloat16)


def _caches(rng, kind: str, shape):
    """JAX cache planes of `kind` (int8: quantized, scales [L, B, S, H])."""
    planes = [_jbf16(rng, shape) for _ in range(2)]
    if kind == "f32":
        return [p.astype(jnp.float32) for p in planes]
    if kind == "bf16":
        return planes
    qs = [jquant(p) for p in planes]
    return [q for q, _ in qs] + [s.transpose(0, 1, 3, 2) for _, s in qs]


def _limit(kind, q, planes, n_past, **mode):
    """REL x the plain attention over |v|, on the updated torch planes."""
    sc = dict(k_scale=planes[2], v_scale=planes[3]) if len(planes) == 4 else {}
    if "prefix_v" in mode:
        mode = {**mode, "prefix_v": mode["prefix_v"].abs()}
    rel = REL["bf16"] if "prefix_v" in mode else REL[kind]
    return rel * tfa.flash_attention_ref(q, planes[0], planes[1].abs(), n_past, layer_idx=LAYER,
                                         **sc, **mode)


def _rows(planes, b: int, n: int):
    """Row b's first n cache rows of layer LAYER: k/v [H, n, D] f32 values,
    scales [n, H] (or None)."""
    k, v = (p[LAYER, b, :, :n].float() for p in planes[:2])
    if len(planes) == 2:
        return k, v, None, None
    return k, v, planes[2][LAYER, b, :n], planes[3][LAYER, b, :n]


# --------------------------------------------------------- the JAX results


FLAT_S, FLAT_BK, FLAT_NPAST = 256, 64, [0, 70, 255]


@pytest.fixture(scope="module", params=["bf16", "int8", "f32"])
def flat_case(request):
    """K4 (JAX flash_decode_update) at B = 3, ragged n_past: 1, 2 and 4
    splits of 64 rows."""
    kind = request.param
    rng = np.random.default_rng(21 + ["bf16", "int8", "f32"].index(kind))
    b = len(FLAT_NPAST)
    new = [_jbf16(rng, (b, 1, H, D)) for _ in range(3)]
    planes = _caches(rng, kind, (L, b, H, FLAT_S, D))
    kw = dict(k_scale=planes[2], v_scale=planes[3]) if kind == "int8" else {}
    got = jfd.flash_decode_update(*new, planes[0], planes[1], jnp.asarray(FLAT_NPAST, jnp.int32),
                                  jnp.int32(LAYER), block_k=FLAT_BK, **kw)
    return kind, _t(new[0]), _t(got[0]), [_t(x) for x in got[1:]]


def test_flat_emulation_matches_jax(flat_case):
    kind, q, want, planes = flat_case
    if kind == "bf16":
        planes = [p.to(torch.bfloat16) for p in planes]
    out = []
    for b, np_ in enumerate(FLAT_NPAST):
        k, v, ks, vs = _rows(planes, b, np_ + 1)
        vis = torch.ones(np_ + 1, dtype=torch.bool)
        parts = segment_partials(q[b, 0], k, v, vis, FLAT_BK, ks, vs, rnd=kind != "f32")
        assert len(parts) == len(tfa.split_schedule(np_ + 1, FLAT_BK))
        out.append(merge(parts))
    got = torch.stack(out)[:, None]
    lim = _limit(kind, q.to(torch.bfloat16), planes, torch.tensor(FLAT_NPAST, dtype=torch.int32))
    assert ((got - want).abs() <= lim).all(), float(((got - want).abs() / lim).max())


RING_S, RING_KEEP, RING_BK, RING_NPAST = 128, 8, 32, 300
RING_HOLES = range(64, 96)  # a whole split of empty rows


def _ring_plane(n_logical: int, holes=()) -> np.ndarray:
    pos = np.full((RING_S, 1), -1, np.int32)
    for p in range(n_logical):
        pos[int(jm.ring_phys(jnp.int32(p), RING_KEEP, RING_S))] = p
    pos[list(holes)] = -1
    return pos


@pytest.fixture(scope="module", params=["bf16", "int8"])
def ring_case(request):
    """K2 over a wrapped 128-row ring (keep 8) at logical n_past 300, rows
    64..95 emptied, ring_bounded as llama_forward passes it."""
    kind = request.param
    rng = np.random.default_rng(31 + (kind == "int8"))
    new = [_jbf16(rng, (1, 1, H, D)) for _ in range(3)]
    planes = _caches(rng, kind, (L, 1, H, RING_S, D))
    pos = _ring_plane(RING_NPAST + 1, RING_HOLES)
    wrow = int(jm.ring_phys(jnp.int32(RING_NPAST), RING_KEEP, RING_S))
    assert wrow not in RING_HOLES
    kw = dict(k_scale=planes[2], v_scale=planes[3]) if kind == "int8" else {}
    got = jfa.flash_attention_update(*new, planes[0], planes[1], jnp.int32(RING_NPAST),
                                     jnp.int32(LAYER), block_k=RING_BK, kv_pos=jnp.asarray(pos),
                                     write_row=jnp.int32(wrow), ring_bounded=True, **kw)
    return kind, pos, _t(new[0]), _t(got[0]), [_t(x) for x in got[1:]]


def test_ring_emulation_matches_jax(ring_case):
    kind, pos, q, want, planes = ring_case
    if kind == "bf16":
        planes = [p.to(torch.bfloat16) for p in planes]
    k, v, ks, vs = _rows(planes, 0, RING_S)
    p = torch.from_numpy(pos[:, 0]).long()
    vis = (p >= 0) & (p <= RING_NPAST)
    parts = segment_partials(q[0, 0], k, v, vis, RING_BK, ks, vs)
    # the emptied rows are one whole split: it adds exactly nothing
    masked = [i for i, (a, b) in enumerate(tfa.split_schedule(RING_S, RING_BK))
              if not vis[a:b].any()]
    assert masked == [2] and bool((parts[2][0] == NEG).all())
    got = merge(parts)[None, None]
    lim = _limit(kind, q.to(torch.bfloat16), planes, RING_NPAST, kv_pos=torch.from_numpy(pos))
    assert ((got - want).abs() <= lim).all(), float(((got - want).abs() / lim).max())


def test_ring_read_empty_rows_matches_jax():
    """K3 over a whole ring (unbounded) where only rows 32..36 hold positions
    0..4: three of the four splits are all masked."""
    rng = np.random.default_rng(41)
    q = _jbf16(rng, (1, 1, H, D))
    k, v = (_jbf16(rng, (L, 1, H, RING_S, D)) for _ in range(2))
    pos = np.full((RING_S, 1), -1, np.int32)
    pos[32:37, 0] = np.arange(5)
    want = _t(jfa.flash_attention(q, k, v, jnp.int32(4), layer_idx=jnp.int32(LAYER),
                                  block_k=RING_BK, kv_pos=jnp.asarray(pos)))
    planes = [_t(x).to(torch.bfloat16) for x in (k, v)]
    kt, vt, _, _ = _rows(planes, 0, RING_S)
    vis = torch.zeros(RING_S, dtype=torch.bool)
    vis[32:37] = True
    parts = segment_partials(_t(q)[0, 0], kt, vt, vis, RING_BK)
    assert [bool((m == NEG).all()) for m, _, _ in parts] == [True, False, True, True]
    got = merge(parts)[None, None]
    lim = _limit("bf16", _t(q).to(torch.bfloat16), planes, 4, kv_pos=torch.from_numpy(pos))
    assert ((got - want).abs() <= lim).all(), float(((got - want).abs() / lim).max())


PRE_S, PRE_SP, PRE_BK = 64, 64, 32
PRE_NPAST, PRE_LEN, PRE_ID = [10, 3], [0, 45], [1, 2]


@pytest.fixture(scope="module", params=["bf16", "int8"])
def prefix_case(request):
    """K2 at T = 1 after the bf16 pool's rows: row 0 with no prefix, row 1
    with 45 rows (two pool splits of 32)."""
    kind = request.param
    rng = np.random.default_rng(51 + (kind == "int8"))
    new = [_jbf16(rng, (2, 1, H, D)) for _ in range(3)]
    planes = _caches(rng, kind, (L, 2, H, PRE_S, D))
    pool = [_jbf16(rng, (L, 3, H, PRE_SP, D)) for _ in range(2)]
    kw = dict(k_scale=planes[2], v_scale=planes[3]) if kind == "int8" else {}
    got = jfa.flash_attention_update(
        *new, planes[0], planes[1], jnp.asarray(PRE_NPAST, jnp.int32), jnp.int32(LAYER),
        block_k=PRE_BK, prefix_k=pool[0], prefix_v=pool[1],
        prefix_id=jnp.asarray(PRE_ID, jnp.int32), prefix_len=jnp.asarray(PRE_LEN, jnp.int32),
        **kw)
    return (kind, _t(new[0]), _t(got[0]), [_t(x) for x in got[1:]],
            [_t(x).to(torch.bfloat16) for x in pool])


def test_prefix_emulation_matches_jax(prefix_case):
    kind, q, want, planes, pool = prefix_case
    if kind == "bf16":
        planes = [p.to(torch.bfloat16) for p in planes]
    pbk = tfa._fit_block_k(min(PRE_BK, PRE_SP), PRE_SP)
    out = []
    for b, (np_, plen, pid) in enumerate(zip(PRE_NPAST, PRE_LEN, PRE_ID)):
        pk, pv = (x[LAYER, pid, :, :plen].float() for x in pool)
        parts = segment_partials(q[b, 0], pk, pv, torch.ones(plen, dtype=torch.bool), pbk)
        assert len(parts) == (0, 2)[b]
        k, v, ks, vs = _rows(planes, b, np_ + 1)
        parts += segment_partials(q[b, 0], k, v, torch.ones(np_ + 1, dtype=torch.bool), PRE_BK,
                                  ks, vs)
        out.append(merge(parts))
    got = torch.stack(out)[:, None]
    mode = dict(prefix_k=pool[0], prefix_v=pool[1],
                prefix_id=torch.tensor(PRE_ID, dtype=torch.int32),
                prefix_len=torch.tensor(PRE_LEN, dtype=torch.int32))
    lim = _limit(kind, q.to(torch.bfloat16), planes, torch.tensor(PRE_NPAST, dtype=torch.int32),
                 **mode)
    assert ((got - want).abs() <= lim).all(), float(((got - want).abs() / lim).max())


# ----------------------------------------------------------- merge rules


def _random_parts(seed: int, n_splits: int, rows: int = 32):
    g = torch.Generator().manual_seed(seed)
    q = torch.randn((H, D), generator=g)
    k, v = (torch.randn((H, n_splits * rows, D), generator=g) for _ in range(2))
    vis = torch.ones(n_splits * rows, dtype=torch.bool)
    return q, segment_partials(q, _bf16(k), _bf16(v), vis, rows)


@pytest.mark.parametrize("where", [0, 1, 3])
def test_all_masked_split_adds_nothing(where):
    """A split whose rows are all masked (empty or future ring rows), put
    anywhere in the order, leaves the merge bit-equal to the merge without
    it."""
    q, parts = _random_parts(where, 3)
    k, v = (torch.randn((H, 32, D)) for _ in range(2))
    masked = split_partial(_bf16(q / 8.0), k, v, torch.zeros(32, dtype=torch.bool))
    assert bool((masked[0] == NEG).all()) and not masked[1].any() and not masked[2].any()
    with_it = parts[:where] + [masked] + parts[where:]
    assert torch.equal(merge(with_it), merge(parts))


def test_single_split_merge_is_its_output():
    """A row with one split: the merge gives acc / l, the split's own
    output, bit for bit (l * 1 + 0 and acc * 1 + 0 are exact)."""
    _, parts = _random_parts(7, 1)
    m, l, acc = parts[0]
    assert torch.equal(merge(parts), acc / l[:, None])


# -------------------------------------------------------------- the schedule


@pytest.mark.parametrize("block_k", [8, 24, 32, 64, 128, 200, 256, 512])
@pytest.mark.parametrize("limit", [1, 37, 64, 65, 480, 512])
def test_split_schedule_covers_rows(limit, block_k):
    """The splits cover [0, limit) exactly, in ascending order, each
    split_rows(block_k) rows long but the last; split_rows depends on
    block_k alone: 64 where 64 divides it, else block_k."""
    r = tfa.split_rows(block_k)
    assert r == (64 if block_k % 64 == 0 else block_k)
    sched = tfa.split_schedule(limit, block_k)
    rows = [j for a, b in sched for j in range(a, b)]
    assert rows == list(range(limit))
    assert all(b - a == r for a, b in sched[:-1]) and 0 < sched[-1][1] - sched[-1][0] <= r
    assert [a for a, _ in sched] == sorted(a for a, _ in sched)


@pytest.mark.parametrize("ps,step", [(8, 8), (16, 8), (32, 32), (128, 8), (128, 32)])
def test_split_schedule_paged_equals_flat(ps, step):
    """At block_k fitted to the page (as the wrappers fit it), no split
    crosses a page, and a paged call's splits and grid (MAXLB x PS rows)
    are a flat call's at block_k = PS."""
    maxlb = 4
    bk = tfa._fit_block_k(256, ps, step)
    flat_bk = tfa._fit_block_k(ps, maxlb * ps, step)
    assert bk == flat_bk == ps
    for limit in range(1, maxlb * ps + 1, 7):
        sched = tfa.split_schedule(limit, bk)
        assert all(a // ps == (b - 1) // ps for a, b in sched)
        assert sched == tfa.split_schedule(limit, flat_bk)
    assert tfa.split_grid(maxlb * ps, bk) == tfa.split_grid(maxlb * ps, flat_bk)


def test_split_grid():
    """The grid: the pool's splits (its own block) ahead of the cache's."""
    assert tfa.split_grid(512, 256) == 8
    assert tfa.split_grid(512, 256, 256, 256) == 12
    assert tfa.split_grid(64, 32, 64, 32) == 4
    assert tfa.split_grid(200, 200) == 1


@pytest.mark.parametrize("kind", ["bf16", "int8", "f32"])
def test_attn_route_split(kind):
    """T from 1 to 15 takes the split route over every cache type, and its
    launch keys carry `_split`; T >= 16 takes the tensor cores, f32
    included."""
    assert tfa.attn_route(1, kind) == "split"
    assert all(tfa.attn_route(t, kind) == "split" for t in range(2, 16))
    assert tfa.attn_route(16, kind) == "tensor_core"
    dtype = {"bf16": torch.bfloat16, "int8": torch.int8, "f32": torch.float32}[kind]
    for path in ("update", "read"):
        for paged, mode in ((False, ""), (True, ""), (False, "ring"), (False, "prefix"),
                            (False, "boff")):
            q = torch.zeros((4, 1, H, D), dtype=torch.bfloat16)
            route, key = tfa.call_launch(path, q, torch.zeros((L, 4, H, 8, D), dtype=dtype),
                                         paged, mode=mode)
            assert route == "split" and "_split" in key and key in tfa.launches
