"""The port's paged attention (`page_table` mode of K2 `flash_attention_update`,
with and without `page_straddle`, K3 `flash_attention` and K4
`flash_decode_update`; plain versions on the CPU) against the JAX package's
Pallas kernels in interpret mode, on the cases of tests/test_paged_attn.py:
scrambled tables, a page shared by two rows, stacked layers, writes that
cross a page, bf16 and int8 pools. Written pages are
byte-equal to the JAX pool's, every other page keeps its bytes, int8 scales
are bit-equal (the JAX scale pool in its first H lanes); outputs lie within
2^-6 * attention(q, k, |v|) per element, as in tests/test_torch_kv_quant.py.
Inputs come from seeded NumPy."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llamavk_tpu.ops import flash_attn as jfa
from llamavk_tpu.ops import flash_decode as jfd
from llamavk_tpu_torch.ops import flash_attn as tfa
from llamavk_tpu_torch.ops import flash_decode as tfd

torch.set_num_threads(2)

HPAD = 8  # the JAX scale pools' lane count here (any count >= H works in interpret mode)


def _bf16(a):
    """(JAX bf16, the port's bf16) of one float array, rounded once by JAX."""
    j = jnp.asarray(a, jnp.bfloat16)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(torch.bfloat16)


def _np(x):
    return x.float().numpy() if x.dtype == torch.bfloat16 else x.numpy()


def pool_planes(rng, layers, n_pages, h, ps, d, quant):
    """A pool for both sides: (JAX planes, port planes). bf16 N(0, 1) data
    [L, NP, H, PS, D]; or int8 data with f32 scales, [L, NP, PS, HPAD] for
    JAX and their first H lanes, [L, NP, PS, H], for the port (the JAX
    package pads the scale pool's head lanes, the port does not)."""
    shape = (layers, n_pages, h, ps, d)
    if not quant:
        pairs = [_bf16(rng.standard_normal(shape)) for _ in range(2)]
        return [j for j, _ in pairs], [t for _, t in pairs]
    data = [rng.integers(-127, 128, shape).astype(np.int8) for _ in range(2)]
    scales = [rng.uniform(0.001, 0.1, (layers, n_pages, ps, HPAD)).astype(np.float32)
              for _ in range(2)]
    jax_planes = [jnp.asarray(a) for a in data + scales]
    port_planes = [torch.from_numpy(a.copy()) for a in data]
    port_planes += [torch.from_numpy(np.ascontiguousarray(a[..., :h])) for a in scales]
    return jax_planes, port_planes


def scrambled_table(rng, n_pages, b, maxlb):
    """[B, MAXLB] int32: distinct pages in a scrambled order."""
    return rng.permutation(n_pages)[: b * maxlb].reshape(b, maxlb).astype(np.int32)


def _kw(planes, table):
    """The port's keyword operands: scales (int8) and the page table."""
    kw = dict(page_table=torch.from_numpy(table))
    if len(planes) == 4:
        kw.update(k_scale=planes[2], v_scale=planes[3])
    return kw


def _jkw(planes, table):
    kw = dict(page_table=jnp.asarray(table))
    if len(planes) == 4:
        kw.update(k_scale=planes[2], v_scale=planes[3])
    return kw


def check_output(got, want, q, planes, n_past, layer, table):
    """Outputs within 2^-6 * attention(q, k, |v|) per element: each side
    rounds its probabilities to bf16 at its own scale (2^-8 each)."""
    kw = _kw(planes, table)
    limit = 2.0**-6 * tfa.flash_attention(q, planes[0], planes[1].abs(), n_past,
                                          layer_idx=layer, **kw).numpy()
    err = np.abs(got.numpy() - np.asarray(want))
    assert (err <= limit).all(), float((err / limit).max())


def check_pools(got_planes, want_planes, before, touched, h):
    """Every plane byte-equal to the JAX one (scales in their first H
    lanes), and every page outside `touched` unchanged."""
    for g, w, b0 in zip(got_planes, want_planes, before):
        w = np.asarray(w.astype(jnp.float32) if w.dtype == jnp.bfloat16 else w)
        if g.dim() == 4 or g.shape[-1] != w.shape[-1]:
            w = w[..., :h]
        np.testing.assert_array_equal(_np(g), w)
        for p in range(g.shape[1]):
            if p not in touched:
                np.testing.assert_array_equal(_np(g[:, p]), _np(b0[:, p]))


# (b, t, h, ps, maxlb, d, n_past, block_k), tests/test_paged_attn.py:40-48 (bf16)
# and :226-233 (int8)
READ_CASES = [
    (False, (2, 1, 2, 64, 4, 32, [17, 130], 64)),  # decode, mid-page bounds
    (False, (2, 8, 2, 64, 4, 32, [13, 56], 64)),  # multi-token
    (False, (1, 64, 2, 64, 2, 32, [64], 32)),  # prefill block, sub-page block_k
    (False, (2, 1, 4, 128, 2, 32, [100, 255], 128)),  # bigger pages
    (True, (2, 8, 2, 64, 4, 32, [13, 56], 32)),
    (True, (1, 64, 2, 64, 4, 32, [64], 64)),
]
# the first-token and int8 decode reads of the JAX file are the K4 test's
# rows at n_past 0 and the int8 update cases at T = 1 below


@pytest.mark.parametrize("quant,case", READ_CASES,
                         ids=[f"{'int8' if q else 'bf16'}-{i}" for i, (q, _) in enumerate(READ_CASES)])
def test_paged_read_matches_jax(quant, case):
    b, t, h, ps, maxlb, d, n_past, bk = case
    rng = np.random.default_rng(len(READ_CASES) * quant + t)
    n_pages = b * maxlb + 3
    jplanes, planes = pool_planes(rng, 1, n_pages, h, ps, d, quant)
    table = scrambled_table(rng, n_pages, b, maxlb)
    qj, qt = _bf16(rng.standard_normal((b, t, h, d)))
    jscales = dict(k_scale=jplanes[2][0], v_scale=jplanes[3][0]) if quant else {}
    want = jfa.flash_attention(qj, jplanes[0][0], jplanes[1][0], jnp.asarray(n_past, jnp.int32),
                               block_t=32, block_k=bk, page_table=jnp.asarray(table), **jscales)
    npt = torch.tensor(n_past, dtype=torch.int32)
    got = tfa.flash_attention(qt, planes[0], planes[1], npt, layer_idx=0, block_k=bk,
                              **_kw(planes, table))
    check_output(got, want, qt, planes, npt, 0, table)


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
def test_paged_read_shared_page_and_layers(quant):
    """Two rows alias one physical page for their first logical block (a
    shared prefix), read at each layer of a two-layer pool
    (tests/test_paged_attn.py:67-92, :174-193)."""
    rng = np.random.default_rng(4 + quant)
    b, t, h, ps, d = 2, 1, 2, 64, 32
    jplanes, planes = pool_planes(rng, 2, 4, h, ps, d, quant)
    table = np.array([[2, 0], [2, 1]], np.int32)  # page 2 shared
    qj, qt = _bf16(rng.standard_normal((b, t, h, d)))
    n_past = [80, 100]
    npt = torch.tensor(n_past, dtype=torch.int32)
    for layer in range(2):
        want = jfa.flash_attention(qj, *jplanes[:2], jnp.asarray(n_past, jnp.int32), block_t=32,
                                   block_k=64, layer_idx=jnp.int32(layer), **_jkw(jplanes, table))
        got = tfa.flash_attention(qt, *planes[:2], npt, layer_idx=layer, block_k=64,
                                  **_kw(planes, table))
        check_output(got, want, qt, planes, npt, layer, table)


# (b, t, n_past), tests/test_paged_attn.py:94-102 (bf16) and :257-266 (int8)
UPDATE_CASES = [
    (False, 2, 1, [17, 130]),  # decode write mid-page
    (False, 2, 1, [63, 127]),  # write at a page's tail
    (False, 2, 1, [64, 128]),  # write at a page's head
    (False, 2, 64, [0, 64]),  # page-aligned prefill chunk (T == PS)
    (False, 2, 32, [32, 96]),  # half-page chunk, aligned to its own size
    (True, 2, 1, [17, 130]),
    (True, 2, 1, [63, 127]),
    (True, 2, 1, [64, 128]),
    (True, 2, 8, [8, 72]),  # small admission bucket
]
# the JAX file's int8 half-page chunk is left out for time: the bf16 one
# takes the same write route, and int8 T = 8 the same quantizing write


@pytest.mark.parametrize("quant,b,t,n_past", UPDATE_CASES,
                         ids=[f"{'int8' if c[0] else 'bf16'}-{i}" for i, c in enumerate(UPDATE_CASES)])
def test_paged_update_matches_jax(quant, b, t, n_past):
    """The fused write + attention through a scrambled table: the new rows
    (int8: quantized, and their scales) land in their pages, byte-equal to
    the JAX pool's, the other pages keep their bytes, and the outputs agree
    (tests/test_paged_attn.py:104-172, :267-353)."""
    rng = np.random.default_rng(12 + t)
    h, ps, maxlb, d = 2, 64, 4, 32
    n_pages = b * maxlb + 2
    jplanes, planes = pool_planes(rng, 1, n_pages, h, ps, d, quant)
    before = [p.clone() for p in planes]
    table = scrambled_table(rng, n_pages, b, maxlb)
    (qj, qt), (knj, knt), (vnj, vnt) = (_bf16(rng.standard_normal((b, t, h, d)))
                                        for _ in range(3))
    want = jfa.flash_attention_update(qj, knj, vnj, *jplanes[:2], jnp.asarray(n_past, jnp.int32),
                                      jnp.int32(0), block_t=32, block_k=64,
                                      **_jkw(jplanes, table))
    npt = torch.tensor(n_past, dtype=torch.int32)
    got = tfa.flash_attention_update(qt, knt, vnt, *planes[:2], npt, 0, block_t=32, block_k=64,
                                     **_kw(planes, table))
    assert all(g is p for g, p in zip(got[1:], planes))  # updated in place
    touched = {int(table[r, (n_past[r] + i) // ps]) for r in range(b) for i in range(t)}
    check_pools(planes, want[1:], before, touched, h)
    check_output(got[0], want[0], qt, planes, npt, 0, table)


def test_paged_write_invariant():
    """A host-int n_past whose T-block write would cross a page is refused,
    as the JAX kernel's caller invariant (flash_attn.py:1029-1033 there)
    requires; page-aligned power-of-two chunks pass."""
    rng = np.random.default_rng(3)
    _, planes = pool_planes(rng, 1, 6, 2, 8, 64, False)
    table = torch.from_numpy(scrambled_table(rng, 6, 1, 4))
    q = torch.randn((1, 8, 2, 64)).to(torch.bfloat16)
    for n_past, ok in ((8, True), (16, True), (4, False)):
        call = lambda: tfa.flash_attention_update(q, q, q, *planes[:2], n_past, 0,  # noqa: E731
                                                  block_t=8, page_table=table)
        if ok:
            call()
        else:
            with pytest.raises(ValueError, match="cross a page"):
                call()


# (int8, n_past) of tests/test_paged_attn.py:370-527, T = 4 at PS 64
STRADDLE_CASES = [
    (False, [61, 10]),  # row 0 spills 3 rows into its next page
    (False, [63, 127]),  # one spilled row; a spill at the second boundary
    (False, [60, 59]),  # an exact fit: T = 4 ends at the boundary
    (False, [8, 40]),  # mid-page, no spill
    (True, [61, 10]),
    (True, [63, 127]),
    (True, [62, 10]),
]


@pytest.mark.parametrize("quant,n_past", STRADDLE_CASES,
                         ids=[f"{'int8' if q else 'bf16'}-{n[0]}-{n[1]}"
                              for q, n in STRADDLE_CASES])
def test_paged_update_straddle_matches_jax(quant, n_past):
    """page_straddle: a T = 4 verify write at any n_past lands row by row in
    its logical page, spilling into the next mapped one, data and int8 scale
    pools byte-equal to the JAX interpret kernel's (whose second RMW window
    rewrites the rest of the spill page unchanged); every other page keeps
    its bytes; the outputs agree."""
    rng = np.random.default_rng(40 + quant)
    b, t, h, ps, maxlb, d = 2, 4, 2, 64, 4, 32
    n_pages = b * maxlb + 2
    jplanes, planes = pool_planes(rng, 1, n_pages, h, ps, d, quant)
    before = [p.clone() for p in planes]
    table = scrambled_table(rng, n_pages, b, maxlb)
    (qj, qt), (knj, knt), (vnj, vnt) = (_bf16(rng.standard_normal((b, t, h, d)))
                                        for _ in range(3))
    want = jfa.flash_attention_update(qj, knj, vnj, *jplanes[:2], jnp.asarray(n_past, jnp.int32),
                                      jnp.int32(0), block_t=32, block_k=64, page_straddle=True,
                                      **_jkw(jplanes, table))
    npt = torch.tensor(n_past, dtype=torch.int32)
    got = tfa.flash_attention_update(qt, knt, vnt, *planes[:2], npt, 0, block_t=32, block_k=64,
                                     page_straddle=True, **_kw(planes, table))
    touched = {int(table[r, (n_past[r] + i) // ps]) for r in range(b) for i in range(t)}
    check_pools(planes, want[1:], before, touched, h)
    check_output(got[0], want[0], qt, planes, npt, 0, table)


def test_paged_straddle_invariant():
    """With page_straddle a host-int n_past may cross a page, and the write
    must end inside the table (n_past + T <= MAXLB * PS,
    flash_attn.py:1034-1038 there); a flat cache has no straddle mode."""
    rng = np.random.default_rng(5)
    _, planes = pool_planes(rng, 1, 6, 2, 8, 64, False)
    table = torch.from_numpy(scrambled_table(rng, 6, 1, 4))
    q = torch.randn((1, 4, 2, 64)).to(torch.bfloat16)
    for n_past, ok in ((6, True), (28, True), (29, False)):
        call = lambda: tfa.flash_attention_update(q, q, q, *planes[:2], n_past, 0,  # noqa: E731
                                                  block_t=8, page_table=table, page_straddle=True)
        if ok:
            call()
        else:
            with pytest.raises(ValueError, match="runs past"):
                call()
    with pytest.raises(ValueError, match="cross a page"):
        tfa.flash_attention_update(q, q, q, *planes[:2], 6, 0, block_t=8, page_table=table)
    flat = [torch.zeros((1, 1, 2, 32, 64), dtype=torch.bfloat16) for _ in range(2)]
    with pytest.raises(ValueError, match="page table"):
        tfa.flash_attention_update(q, q, q, *flat, 6, 0, page_straddle=True)


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
def test_paged_decode_matches_jax(quant):
    """K4 through a scrambled table (flash_decode.py:104-114, :261-273
    there): each row's new row lands at its page's row n_past % PS, at a
    page's tail, head and middle and in the first row; then the same
    checks as the fused update, and the plain K4 equals the plain K2 at
    T = 1 element for element."""
    rng = np.random.default_rng(21 + quant)
    b, h, ps, maxlb, d, bk = 4, 2, 32, 4, 64, 32
    n_past = [0, 31, 32, 100]
    n_pages = b * maxlb + 2
    jplanes, planes = pool_planes(rng, 2, n_pages, h, ps, d, quant)
    planes2 = [p.clone() for p in planes]
    before = [p.clone() for p in planes]
    table = scrambled_table(rng, n_pages, b, maxlb)
    (qj, qt), (knj, knt), (vnj, vnt) = (_bf16(rng.standard_normal((b, 1, h, d)))
                                        for _ in range(3))
    want = jfd.flash_decode_update(qj, knj, vnj, *jplanes[:2], jnp.asarray(n_past, jnp.int32),
                                   jnp.int32(1), block_k=bk, **_jkw(jplanes, table))
    npt = torch.tensor(n_past, dtype=torch.int32)
    got = tfd.flash_decode_update(qt, knt, vnt, *planes[:2], npt, 1, block_k=bk,
                                  **_kw(planes, table))
    touched = {int(table[r, n_past[r] // ps]) for r in range(b)}
    check_pools(planes, want[1:], before, touched, h)
    check_output(got[0], want[0], qt, planes, npt, 1, table)
    k2 = tfa.flash_attention_update(qt, knt, vnt, *planes2[:2], npt, 1, block_k=bk,
                                    **_kw(planes2, table))
    for g, w in zip(got, k2):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
