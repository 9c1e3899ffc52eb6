"""The f32-cache attention of K2/K3 on the tensor cores (`csrc/attn_mma.cuh`,
T >= 16), on the CPU: the kernel cannot run here, so a torch emulation of its
numerics, kept in this file, is held against the JAX kernels (interpret
mode) over an f32 cache in every mode the route takes: flat K2 and K3, an
f32 page pool, the f32 ring before and after a wrap, and a bf16 prefix pool
over f32 slots (prefix_len 0 and > 0). Each operand is split into TF32 hi
and lo parts (`cvt.rna`, done here by integer bit operations), each product
summed as three m16n8k8 passes in the kernel's order (lo*hi, hi*lo, hi*hi),
the PV k-step's 8 keys in the kernel's relabelled order, the online max and
sum stepped once a sub-tile of min(32, block_k) keys. One pass alone must
miss the f32 limit on the same data, so a later change cannot drop the lo
parts unnoticed. Inputs come from seeded NumPy."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llamavk_tpu.ops import flash_attn as jfa
from llamavk_tpu_torch.models.llama import ring_phys
from llamavk_tpu_torch.ops import flash_attn as tfa

torch.set_num_threads(2)

L, LAYER, H, D, S = 2, 1, 2, 64, 64
# the f32 limit of tests/test_torch_f32kv.py: 2^-12 of attention(q, k, |v|)
F32_REL = 2.0**-12
# the share of that limit the three-pass emulation may use (the kernel's
# rows on the card are held to the same share by chip_smoke.py)
TC_MARGIN = 0.05
# a bf16 prefix pool rounds q and p to bf16 over f32 slots too: the bf16
# limit (tests/test_torch_f32kv.py::PREFIX_REL)
PREFIX_REL = 2.0**-6
NEG = -1e30
KS_F32, KS_BF16 = 32, 64  # keys per sub-tile (attn::mma::KS_F32, KS)
# the PV k-step's keys in A-column order: column t is key 2t, t + 4 key 2t + 1
PV_ORDER = [0, 2, 4, 6, 1, 3, 5, 7]


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """f32 x rounded to TF32, to nearest with ties away from zero, as
    `cvt.rna.tf32.f32`: half an ulp of the 10-bit significand added to the
    magnitude's bits, the low 13 bits cleared (finite x)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split_tf32(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo): hi = tf32(x), lo = tf32(x - hi); x - hi is exact in f32."""
    hi = tf32_rna(x)
    return hi, tf32_rna(x - hi)


def _mma_passes(acc: torch.Tensor, a: torch.Tensor, b: torch.Tensor, passes: int) -> torch.Tensor:
    """acc [..., M, N] += a [..., M, 8] @ b [..., 8, N] (one m16n8k8 k-step),
    f32 operands split into TF32 parts: three passes lo*hi, hi*lo, hi*hi in
    that order (`passes` = 1: hi*hi alone), each pass's 8 products (exact in
    f32: 11 x 11 significand bits) added to the f32 accumulator in k order."""
    ah, al = split_tf32(a)
    bh, bl = split_tf32(b)
    order = ((al, bh), (ah, bl), (ah, bh)) if passes == 3 else ((ah, bh),)
    for x, y in order:
        for k in range(8):
            acc = acc + x[..., :, k : k + 1] * y[..., k : k + 1, :]
    return acc


def _sub_tiles(limit: int, bk: int, ks: int) -> list[tuple[int, int]]:
    """The walk's sub-tiles of keys [0, limit): min(ks, bk) rows each, never
    across a KV block of bk rows."""
    sub = min(ks, bk)
    out = []
    for b0 in range(0, limit, bk):
        b1 = min(b0 + bk, limit)
        out += [(j, min(j + sub, b1)) for j in range(b0, b1, sub)]
    return out


def _online(state, s, vis, pv):
    """One sub-tile's online step for scores s [B, H, T, n] (masked keys
    -1e30, p = 0 there): the max over the sub-tile, alpha, l += p sums (one
    rounding, as fmaf), the accumulators times alpha, then `pv(p)` added."""
    m, l, acc = state
    s = torch.where(vis, s, torch.tensor(NEG))
    m_new = torch.maximum(m, s.amax(-1))
    alpha = torch.exp(m - m_new)
    p = torch.where(s <= NEG * 0.5, torch.zeros(()), torch.exp(s - m_new[..., None]))
    l = (l.double() * alpha.double() + p.sum(-1).double()).float()
    return m_new, l, pv(acc * alpha[..., None], p)


def emulate(q, k_l, v_l, visible, bk: int, prefix=None, pbk: int = 0, passes: int = 3):
    """The tensor-core kernel's f32-cache attention: q [B, T, H, D] (f32 or
    bf16), k_l/v_l one f32 layer [B, H, S, D] (a pool's gathered view, a
    ring's physical rows), visible [B, T, S]; `prefix` (pk, pv, mask) bf16
    pool rows [B, H, Sp, D] walked first on the bf16 path (q and p rounded
    to bf16) in sub-tiles of min(64, pbk). Returns f32 [B, T, H, D]."""
    b, t, h, d = q.shape
    qf = (q.float() * (1.0 / math.sqrt(d))).transpose(1, 2)  # [B, H, T, D]
    state = (torch.full((b, h, t), NEG), torch.zeros((b, h, t)), torch.zeros((b, h, t, d)))
    if prefix is not None:
        pk, pv, pvis = prefix
        qb = qf.to(torch.bfloat16).double()
        for j0, j1 in _sub_tiles(pk.shape[2], pbk, KS_BF16):
            s = (qb @ pk[:, :, j0:j1].double().transpose(-1, -2)).float()
            state = _online(state, s, pvis[:, None, :, j0:j1], lambda acc, p, j0=j0, j1=j1: (
                acc.double() + p.to(torch.bfloat16).double() @ pv[:, :, j0:j1].double()).float())
    for j0, j1 in _sub_tiles(k_l.shape[2], bk, KS_F32):
        kt = k_l[:, :, j0:j1].float()
        s = torch.zeros((b, h, t, j1 - j0))
        for ks in range(0, d, 8):  # S = Q K^T, one k-step of 8 dims at a time
            s = _mma_passes(s, qf[..., ks : ks + 8], kt[..., ks : ks + 8].transpose(-1, -2),
                            passes)
        n8 = -(-(j1 - j0) // 8) * 8  # the last k-step's keys past the tile are zeros

        def pv(acc, p, j0=j0, j1=j1, n8=n8):
            p = torch.nn.functional.pad(p, (0, n8 - p.shape[-1]))
            v = torch.nn.functional.pad(v_l[:, :, j0:j1].float(), (0, 0, 0, n8 - (j1 - j0)))
            for kk in range(0, n8, 8):  # O += P V, the k-step's keys relabelled
                keys = [kk + i for i in PV_ORDER]
                acc = _mma_passes(acc, p[..., keys], v[:, :, keys], passes)
            return acc

        state = _online(state, s, visible[:, None, :, j0:j1], pv)
    _, l, acc = state
    return (acc / l[..., None]).transpose(1, 2)


def _f32(rng, shape, std=1.0):
    a = (std * rng.standard_normal(shape)).astype(np.float32)
    return jnp.asarray(a), torch.from_numpy(a.copy())


def _bf16(rng, shape):
    j = jnp.asarray(rng.standard_normal(shape), jnp.bfloat16)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(torch.bfloat16)


def _ring_plane(n_logical: int, s: int, keep: int) -> np.ndarray:
    """[S, 1] positions an engine leaves after n_logical tokens (-1 empty)."""
    pos = np.full((s, 1), -1, np.int32)
    for p in range(n_logical):
        pos[ring_phys(p, keep, s)] = p
    return pos


CASES = ("flat_update", "flat_read", "paged_update", "ring_prefill", "ring_wrapped",
         "prefix_0", "prefix")


def _case(name: str) -> dict:
    """One call through the JAX kernel (interpret mode) over an f32 cache, f32
    queries and rows (the kernel's operands on this route): its output, and
    what the emulation needs: q, the layer's logical K/V view, the visible
    mask, the KV block, the prefix pool rows and the limit's rule."""
    rng = np.random.default_rng(CASES.index(name) + 150)
    paged, ring = name.startswith("paged"), name.startswith("ring")
    prefix = name.startswith("prefix")
    b = 3 if prefix else 2 if paged else 1
    t = {"flat_read": 40, "ring_prefill": 32}.get(name, 16)
    npast = {"flat_update": [13], "flat_read": [20], "paged_update": [8, 16],
             "ring_prefill": [0], "ring_wrapped": [100], "prefix_0": [3, 9, 40],
             "prefix": [3, 9, 40]}[name]
    qj, qt = _f32(rng, (b, t, H, D), std=2.0)
    knj, knt = _f32(rng, (b, t, H, D), std=2.0)
    vnj, vnt = _f32(rng, (b, t, H, D))
    ps, maxlb = 8, S // 8
    n_pages = b * maxlb + 3
    rows = n_pages if paged else b
    kj, kt = _f32(rng, (L, rows, H, ps if paged else S, D))
    vj, vt = _f32(rng, (L, rows, H, ps if paged else S, D))
    npj, npt = jnp.asarray(np.array(npast, np.int32)), torch.tensor(npast, dtype=torch.int32)
    bk = ps if paged else 32
    jkw, tkw, pre = {}, {}, None
    if paged:
        table = (rng.permutation(n_pages - 1)[: b * maxlb] + 1).reshape(b, maxlb)
        table = table.astype(np.int32)
        jkw, tkw = dict(page_table=jnp.asarray(table)), dict(page_table=torch.from_numpy(table))
    if ring:
        keep, n = 8, npast[0]
        wrow = ring_phys(n, keep, S)
        pos = _ring_plane(n + t, S, keep)
        jkw = dict(kv_pos=jnp.asarray(pos), write_row=jnp.int32(wrow), ring_bounded=True)
        tkw = dict(kv_pos=torch.from_numpy(pos), write_row=wrow, ring_bounded=True)
        npj, npt = jnp.int32(n), n
    if prefix:
        sp = 64
        pkj, pkt = _bf16(rng, (L, 3, H, sp, D))
        pvj, pvt = _bf16(rng, (L, 3, H, sp, D))
        pid = np.array([2, 0, 1], np.int32)
        plen = np.array([33, 0, 64] if name == "prefix" else [0, 0, 0], np.int32)
        jkw = dict(prefix_k=pkj, prefix_v=pvj, prefix_id=jnp.asarray(pid),
                   prefix_len=jnp.asarray(plen))
        tkw = dict(prefix_k=pkt, prefix_v=pvt, prefix_id=torch.from_numpy(pid),
                   prefix_len=torch.from_numpy(plen))
        pre = tfa.prefix_rows(pkt, pvt, tkw["prefix_id"], tkw["prefix_len"], LAYER, t)
    if name == "flat_read":
        tfa.write_rows(knt, vnt, kt, vt, npast[0], LAYER)
        kj, vj = jnp.asarray(kt.numpy()), jnp.asarray(vt.numpy())
        want = jfa.flash_attention(qj, kj, vj, npj, block_t=8, block_k=bk,
                                   layer_idx=jnp.int32(LAYER))
    else:
        want, kj, vj = jfa.flash_attention_update(qj, knj, vnj, kj, vj, npj, jnp.int32(LAYER),
                                                  block_t=8, block_k=bk, **jkw)
        tfa.flash_attention_update_ref(qt, knt, vnt, kt, vt, npt, LAYER, block_t=8,
                                       block_k=bk, **tkw)
        np.testing.assert_array_equal(kt.numpy(), np.asarray(kj))  # the rows as they arrive
    kl, vl = kt[LAYER], vt[LAYER]
    if paged:
        kl, vl = (tfa.gather_pages(x, tkw["page_table"]) for x in (kl, vl))
    if ring:
        vis = tfa.ring_visible(tkw["kv_pos"], npt, b, t)
    else:
        vis = tfa.visible_mask(npt, b, t, kl.shape[2], "cpu")
    lim_kw = {k: v for k, v in tkw.items() if k != "write_row"}
    if prefix:
        lim_kw["prefix_v"] = tkw["prefix_v"].abs()
    rel = PREFIX_REL if name == "prefix" else F32_REL
    limit = rel * tfa.flash_attention_ref(qt, kt, vt.abs(), npt, layer_idx=LAYER,
                                          **lim_kw).numpy()
    pbk = tfa._fit_block_k(min(bk, 64), 64) if prefix else 0
    return dict(q=qt, k=kl, v=vl, vis=vis, bk=bk, prefix=pre, pbk=pbk, want=np.asarray(want),
                limit=limit, rel=rel)


@pytest.fixture(scope="module")
def cases() -> dict:
    return {name: _case(name) for name in CASES}


def _ratio(c: dict, passes: int = 3) -> float:
    got = emulate(c["q"], c["k"], c["v"], c["vis"], c["bk"], c["prefix"], c["pbk"],
                  passes=passes)
    return float((np.abs(got.numpy() - c["want"]) / c["limit"]).max())


@pytest.mark.parametrize("name", CASES)
def test_emulation_matches_jax(cases, name):
    """The three-pass emulation within the f32 limit of the JAX kernel, and
    within TC_MARGIN of it, in every mode (the bf16 pool's rows: the bf16
    limit, which their roundings take)."""
    ratio = _ratio(cases[name])
    assert ratio <= 1.0
    if cases[name]["rel"] == F32_REL:
        assert ratio <= TC_MARGIN


def test_prefix_len_0_is_flat(cases):
    """A prefix pool at prefix_len 0 contributes nothing: the emulation's
    output equals the one without a pool, bit for bit."""
    c = cases["prefix_0"]
    with_pool = emulate(c["q"], c["k"], c["v"], c["vis"], c["bk"], c["prefix"], c["pbk"])
    alone = emulate(c["q"], c["k"], c["v"], c["vis"], c["bk"])
    assert torch.equal(with_pool, alone)


def test_one_pass_misses_the_limit(cases):
    """hi*hi alone (one TF32 pass a product) on the same data passes the f32
    limit: the lo parts are what keeps the route within it."""
    assert _ratio(cases["flat_read"], passes=1) > 1.0


def test_split_recovers_f32():
    """hi + lo = x within 2^-22 |x| over a wide exponent range; hi is x
    rounded to nearest TF32 (ties away from zero), both parts TF32."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy((rng.standard_normal(4096)
                          * np.exp2(rng.integers(-60, 60, 4096))).astype(np.float32))
    x[:4] = torch.tensor([1 + 2.0**-11, -(1 + 2.0**-11), 1 + 3 * 2.0**-11, 0.0])
    hi, lo = split_tf32(x)
    for part in (hi, lo):
        assert not (part.view(torch.int32) & 0x1FFF).any()
    assert ((x.double() - hi.double()).abs() <= 2.0**-11 * x.double().abs()).all()
    assert ((x.double() - (hi.double() + lo.double())).abs()
            <= 2.0**-22 * x.double().abs()).all()
    # ties go away from zero: 1 + 2^-11 lies halfway between two TF32 values
    assert hi[:3].tolist() == [1 + 2.0**-10, -(1 + 2.0**-10), 1 + 2 * 2.0**-10]
