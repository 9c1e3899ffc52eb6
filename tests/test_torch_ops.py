"""The port's ops against the JAX package's: dequantize, q4_matmul (the JAX
kernel in Pallas interpret mode, the port on the CPU through its plain
version), rms_norm and RoPE. Inputs come from seeded NumPy."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from llamavk_tpu import ops as jops
from llamavk_tpu.formats import quantize_q4_0, quantize_q4_1, repack_q4_0, repack_q4_1
from llamavk_tpu.formats.repack import LAYOUT_ILV, LAYOUT_LIN
from llamavk_tpu_torch.ops import norms as tnorms
from llamavk_tpu_torch.ops import q4_matmul as tq4
from llamavk_tpu_torch.ops import qweight as tqw
from llamavk_tpu_torch.ops import rope as trope

torch.set_num_threads(2)


def _packed(k, n, layout=LAYOUT_ILV, q41=False, seed=0):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((n, k)) * 0.1).astype(np.float32)  # checkpoint order [N, K]
    if q41:
        d, m, q = quantize_q4_1(w)
        return repack_q4_1(d, m, q, layout=layout)
    d, q = quantize_q4_0(w)
    return repack_q4_0(d, q, layout=layout)


def _pair(pk):
    """The same packed weight as a JAX QWeight and a port QWeight (bf16 scales)."""
    return (
        jops.qweight_from_packed(pk, scale_dtype=jnp.bfloat16),
        tqw.qweight_from_packed(pk, scale_dtype=torch.bfloat16, device="cpu"),
    )


def _bf16(a: np.ndarray):
    """One bf16 array for both frameworks (rounded once, by JAX)."""
    j = jnp.asarray(a, jnp.bfloat16)
    t = torch.from_numpy(np.array(j.astype(jnp.float32))).to(torch.bfloat16)
    return j, t


@pytest.mark.parametrize("layout", [LAYOUT_ILV, LAYOUT_LIN])
@pytest.mark.parametrize("q41", [False, True])
def test_dequantize_qweight_matches_jax(layout, q41):
    jqw, tqw_ = _pair(_packed(128, 256, layout, q41))
    want = np.asarray(jops.dequantize_qweight(jqw))
    got = tqw.dequantize_qweight(tqw_).numpy()
    # the same f32 products of the same bf16 scales: exact
    np.testing.assert_array_equal(got, want)


# x @ W with bf16 x and bf16 weights summed in f32 on both sides: the only
# difference is the f32 summation order over K (<= 256 terms of |x*w| < 1),
# so 1e-4 absolute covers it with room
MATMUL_TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize(
    "m,k,n,q41",
    [(1, 256, 256, False), (5, 256, 256, False), (64, 256, 256, False),
     (5, 128, 320, False), (5, 128, 128, True)],
)
def test_q4_matmul_matches_jax(m, k, n, q41):
    """M covers decode (1), a small prefill (5) and the tiled prefill (64);
    N = 320 is ragged against a 128-wide tile; one Q4_1 case."""
    jqw, tqw_ = _pair(_packed(k, n, q41=q41, seed=m))
    xj, xt = _bf16(np.random.default_rng(100 + m).standard_normal((m, k)))
    want = np.asarray(jops.q4_matmul(xj, jqw, out_dtype=jnp.float32))
    got = tq4.q4_matmul(xt, tqw_, out_dtype=torch.float32)
    assert got.dtype == torch.float32 and tuple(got.shape) == (m, n)
    np.testing.assert_allclose(got.numpy(), want, **MATMUL_TOL)


def test_q4_matmul_stacked_layer_select():
    """A stacked [L, K/2, N] weight read through layer_idx (views, no copy)."""
    pks = [_packed(256, 256, seed=s) for s in (7, 8)]
    jst = jops.qweight_from_packed(pks[0], scale_dtype=jnp.bfloat16)
    jst = type(jst)(
        packed=jnp.stack([jnp.asarray(p.packed) for p in pks]),
        scales=jnp.stack([jnp.asarray(p.scales, jnp.bfloat16) for p in pks]),
        bias=None, layout=jst.layout, chunks=jst.chunks,
    )
    tst = tqw.QWeight(
        packed=torch.from_numpy(np.stack([p.packed for p in pks])),
        scales=torch.from_numpy(np.stack([p.scales for p in pks])).to(torch.bfloat16),
    )
    xj, xt = _bf16(np.random.default_rng(9).standard_normal((2, 3, 256)))
    want = np.asarray(jops.q4_matmul(xj, jst, out_dtype=jnp.float32, layer_idx=jnp.int32(1)))
    got = tq4.q4_matmul(xt, tst, out_dtype=torch.float32, layer_idx=1)
    assert tuple(got.shape) == (2, 3, 256)
    np.testing.assert_allclose(got.numpy(), want, **MATMUL_TOL)
    # layer 1 is not layer 0
    other = tq4.q4_matmul(xt, tst, out_dtype=torch.float32, layer_idx=0)
    assert not torch.allclose(other, got)


def test_rms_norm_matches_jax():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((4, 64)).astype(np.float32)
    w = rng.standard_normal(64).astype(np.float32)
    want = np.asarray(jops.rms_norm(jnp.asarray(x), jnp.asarray(w)))
    got = tnorms.rms_norm(torch.from_numpy(x), torch.from_numpy(w)).numpy()
    # f32 on both sides; only the mean's summation order differs
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_rope_matches_jax():
    rng = np.random.default_rng(4)
    b, t, h, d = 1, 5, 2, 64
    x = rng.standard_normal((b, t, h, d)).astype(np.float32)
    pos = np.arange(37, 37 + t)
    jc, js = jops.rope_cos_sin(jnp.asarray(pos), d)
    tc, ts = trope.rope_cos_sin(torch.from_numpy(pos), d)
    # f32 sin/cos of the same f32 angles; libm and XLA differ by an ulp or so
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0, atol=1e-5)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0, atol=1e-5)
    want = np.asarray(jops.apply_rope(jnp.asarray(x), jc, js))
    got = trope.apply_rope(torch.from_numpy(x), tc, ts).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
