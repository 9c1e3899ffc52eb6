"""The kernel modes of the parallel paths, in their plain versions on the
CPU: K1 and K5 over weights packed in 2 K chunks (the tensor-parallel
row-split packing, `repack_q4_0(chunks=2)`) against the JAX package's
`q4_matmul` in Pallas interpret mode, within the existing K1 and K5
tolerances; K2's `commit=0` (no cache byte changes) and the `batch_offset`
of K2, K3 and K4 (equal to the same call on a cache of just the offset
rows). Inputs come from seeded NumPy."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llamavk_tpu import ops as jops
from llamavk_tpu.formats import quantize_q4_0, quantize_q4_1, repack_q4_0, repack_q4_1
from llamavk_tpu.formats.repack import LAYOUT_ILV, LAYOUT_LIN
from llamavk_tpu_torch.ops import flash_attn as fa
from llamavk_tpu_torch.ops import flash_decode as fd
from llamavk_tpu_torch.ops import q4_matmul as tq4
from llamavk_tpu_torch.ops import qweight as tqw
from llamavk_tpu_torch.ops.kv_quant import quantize_rows

torch.set_num_threads(2)

# K1: the port's plain K1 and the JAX interpret kernel sum the same f32
# products in different orders, as tests/test_torch_ops.py's MATMUL_TOL says
MATMUL_TOL = dict(rtol=1e-4, atol=1e-4)


def _bf16(a):
    j = jnp.asarray(a, jnp.bfloat16)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(torch.bfloat16)


def _chunked(k, n, chunks, layout=LAYOUT_ILV, q41=False, seed=0):
    """One weight packed in `chunks` K slices, for both packages."""
    w = (np.random.default_rng(seed).standard_normal((n, k)) * 0.1).astype(np.float32)
    pk = (repack_q4_1(*quantize_q4_1(w), layout=layout, chunks=chunks) if q41
          else repack_q4_0(*quantize_q4_0(w), layout=layout, chunks=chunks))
    return (jops.qweight_from_packed(pk, scale_dtype=jnp.bfloat16),
            tqw.qweight_from_packed(pk, scale_dtype=torch.bfloat16, device="cpu"))


@pytest.mark.parametrize("layout", [LAYOUT_ILV, LAYOUT_LIN])
@pytest.mark.parametrize("m", [1, 8])
def test_q4_matmul_chunks_matches_jax(layout, m):
    jqw, tw = _chunked(512, 256, 2, layout, q41=m == 8, seed=m)
    assert tw.chunks == 2
    xj, xt = _bf16(np.random.default_rng(3).standard_normal((m, 512)))
    want = np.asarray(jops.q4_matmul(xj, jqw, out_dtype=jnp.float32))
    got = tq4.q4_matmul(xt, tw, out_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), want, **MATMUL_TOL)


def test_q4_matmul_chunks_stacked_layer_select():
    """A stacked chunked weight (as `wo`/`w2` are under tp packing) at layer
    1, against JAX's stacked chunk loop (q4_matmul.py:714-728 there)."""
    pairs = [_chunked(256, 128, 2, seed=s) for s in (4, 5)]
    jst = jops.QWeight(packed=jnp.stack([p[0].packed for p in pairs]),
                       scales=jnp.stack([p[0].scales for p in pairs]), bias=None,
                       layout=LAYOUT_ILV, chunks=2)
    tst = tqw.QWeight(packed=torch.stack([p[1].packed for p in pairs]),
                      scales=torch.stack([p[1].scales for p in pairs]), chunks=2)
    xj, xt = _bf16(np.random.default_rng(6).standard_normal((4, 256)))
    want = np.asarray(jops.q4_matmul(xj, jst, out_dtype=jnp.float32, layer_idx=jnp.int32(1)))
    got = tq4.q4_matmul(xt, tst, out_dtype=torch.float32, layer_idx=1)
    np.testing.assert_allclose(got.numpy(), want, **MATMUL_TOL)


@pytest.mark.parametrize("m", [1, 8])
def test_q4_matmul_i8_chunks_matches_jax(m):
    """K5 over 2 chunks within the sum-order bound G 2^-24 sum_g |d sx s|
    of the JAX interpret kernel (tests/test_torch_q4_i8.py's limit: d is
    exact on both sides, each chunk's groups over its own nibbles; the f32
    sums run in different orders)."""
    jqw, tw = _chunked(512, 256, 2, seed=10 + m)
    xj, xt = _bf16(np.random.default_rng(7).standard_normal((m, 512)))
    assert tq4.i8_route("i8", m, 512, 256, tw)
    want = np.asarray(jops.q4_matmul(xj, jqw, out_dtype=jnp.float32, dot_mode="i8"))
    got = tq4.q4_matmul(xt, tw, out_dtype=torch.float32, dot_mode="i8")
    xq, sx = tq4.quantize_act_blocks(xt)
    gc = tw.g // 2
    terms = sum((torch.einsum("mgb,mgn->gbn", xq[:, c * gc : (c + 1) * gc].double(),
                              tq4._nibbles(tw.chunk(c).packed, gc).double())
                 * sx[c * gc : (c + 1) * gc].double()[:, :, None]
                 * tw.chunk(c).scales.double()[:, None, :]).abs().sum(0) for c in range(2))
    limit = tw.g * 2.0**-24 * terms.numpy()
    assert (np.abs(got.numpy().astype(np.float64) - want) <= limit).all()


B_CACHE, H, S, D = 4, 2, 64, 64


def _cache(quant: bool, seed: int = 0):
    """A two-layer cache [2, 4, H, S, D]: bf16 N(0, 1), or its int8 rows
    and scales [2, 4, S, H]."""
    g = torch.Generator().manual_seed(seed)
    planes = [torch.randn((2, B_CACHE, H, S, D), generator=g).to(torch.bfloat16)
              for _ in range(2)]
    if not quant:
        return planes
    qs = [quantize_rows(x) for x in planes]
    return [q for q, _ in qs] + [s.transpose(2, 3).contiguous() for _, s in qs]


def _sc(planes):
    return dict(k_scale=planes[2], v_scale=planes[3]) if len(planes) == 4 else {}


def _qkv(b, t, seed=1):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn((b, t, H, D), generator=g).to(torch.bfloat16) for _ in range(3)]


@pytest.mark.parametrize("quant", [False, True])
def test_update_commit0_leaves_cache(quant):
    """K2 with commit=0 (a pipeline's idle hop in the JAX schedule) writes
    no byte, data or scale, and attends over the unchanged rows."""
    planes = _cache(quant)
    before = [p.clone() for p in planes]
    q, kn, vn = _qkv(B_CACHE, 8)
    npast = torch.tensor([0, 5, 17, 40], dtype=torch.int32)
    out = fa.flash_attention_update(q, kn, vn, planes[0], planes[1], npast, 1, block_k=32,
                                    commit=0, **_sc(planes))[0]
    assert all(torch.equal(a, b) for a, b in zip(planes, before))
    want = fa.flash_attention(q, planes[0], planes[1], npast, layer_idx=1, **_sc(planes))
    assert torch.equal(out, want)
    # commit=1 writes: the rows change
    fa.flash_attention_update(q, kn, vn, planes[0], planes[1], npast, 1, **_sc(planes))
    assert not torch.equal(planes[0], before[0])


@pytest.mark.parametrize("kernel", ["update", "read", "decode"])
@pytest.mark.parametrize("quant", [False, True])
def test_batch_offset_equals_offset_rows(kernel, quant):
    """B = 2 rows at batch_offset 1 of a 4-row cache == the same call on a
    2-row cache of rows [1, 3): outputs and those rows equal, the other rows
    untouched (K2; K3 over rows written by `write_rows`; K4)."""
    b0, b = 1, 2
    t = 1 if kernel == "decode" else 8
    full = _cache(quant, seed=2)
    part = [p[:, b0 : b0 + b].clone() for p in full]
    before = [p.clone() for p in full]
    q, kn, vn = _qkv(b, t, seed=3)
    npast = torch.tensor([3, 30], dtype=torch.int32)
    if kernel == "read":
        for planes in (full, part):
            rows = planes if planes is part else [p[:, b0 : b0 + b] for p in planes]
            fa.write_rows(kn, vn, rows[0], rows[1], npast, 1, *rows[2:])
        got = fa.flash_attention(q, full[0], full[1], npast, layer_idx=1, batch_offset=b0,
                                 **_sc(full))
        want = fa.flash_attention(q, part[0], part[1], npast, layer_idx=1, **_sc(part))
    else:
        call = fd.flash_decode_update if kernel == "decode" else fa.flash_attention_update
        got = call(q, kn, vn, full[0], full[1], npast, 1, batch_offset=b0, **_sc(full))[0]
        want = call(q, kn, vn, part[0], part[1], npast, 1, **_sc(part))[0]
    assert torch.equal(got, want)
    for f, p, old in zip(full, part, before):
        assert torch.equal(f[:, b0 : b0 + b], p)
        assert torch.equal(f[:, :b0], old[:, :b0]) and torch.equal(f[:, b0 + b :],
                                                                    old[:, b0 + b :])


def test_wider_cache_needs_batch_offset():
    """The batch slice is taken only when asked for: a flat cache wider than
    the call's rows raises without `batch_offset`, and `batch_offset=0`
    runs on rows [0, B), equal to the call on a cache of just those rows."""
    full = _cache(False, seed=4)
    q, kn, vn = _qkv(2, 1, seed=5)
    with pytest.raises(ValueError, match="does not fit"):
        fa.flash_attention_update(q, kn, vn, full[0], full[1], 3, 1)
    with pytest.raises(ValueError, match="does not fit"):
        fa.flash_attention(q, full[0], full[1], 3, layer_idx=1)
    with pytest.raises(ValueError, match="does not fit"):
        fd.flash_decode_update(q, kn, vn, full[0], full[1], 3, 1)
    part = [p[:, :2].clone() for p in full]
    got = fa.flash_attention_update(q, kn, vn, full[0], full[1], 3, 1, batch_offset=0)[0]
    want = fa.flash_attention_update(q, kn, vn, part[0], part[1], 3, 1)[0]
    assert torch.equal(got, want) and torch.equal(full[0][:, :2], part[0])


def test_pp_modes_refuse_paged():
    planes = _cache(False)
    q, kn, vn = _qkv(2, 1)
    table = torch.zeros((2, 1), dtype=torch.int32)
    with pytest.raises(ValueError, match="flat cache"):
        fa.flash_attention_update(q, kn, vn, planes[0], planes[1], 0, 0, batch_offset=1,
                                  page_table=table)
    with pytest.raises(ValueError, match="leave the cache"):
        fa.flash_attention(q, planes[0], planes[1], 0, batch_offset=3)
