"""The port's int8 KV cache against the JAX package's: `quantize_rows`, and
the int8 modes of the fused write + attention (`flash_attention_update`) and
of the read-only attention (`flash_attention`), the port's plain versions on
the CPU against the JAX Pallas kernels in interpret mode. Inputs come from
seeded NumPy."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llamavk_tpu.ops import flash_attn as jfa
from llamavk_tpu.ops import kv_quant as jkq
from llamavk_tpu_torch.ops import flash_attn as tfa
from llamavk_tpu_torch.ops import kv_quant as tkq

torch.set_num_threads(2)

L, H, S, D = 2, 2, 64, 64
LAYER = 1
HS = 8  # the JAX scale planes' lane count here (any count >= H works in interpret mode)


def _bf16(rng, shape, std=1.0):
    """One bf16 array for both frameworks (rounded once, by JAX)."""
    j = jnp.asarray(std * rng.standard_normal(shape), jnp.bfloat16)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(torch.bfloat16)


def _int8_cache(rng, b):
    """An int8 cache with scales: JAX planes [L, B, S, HS], the port's [L, B, S, H]."""
    k = rng.integers(-127, 128, (L, b, H, S, D)).astype(np.int8)
    v = rng.integers(-127, 128, (L, b, H, S, D)).astype(np.int8)
    ks = rng.uniform(0.001, 0.05, (L, b, S, HS)).astype(np.float32)
    vs = rng.uniform(0.001, 0.05, (L, b, S, HS)).astype(np.float32)
    jax_planes = [jnp.asarray(a) for a in (k, v, ks, vs)]
    port_planes = [torch.from_numpy(a.copy()) for a in (k, v)]
    port_planes += [torch.from_numpy(np.ascontiguousarray(a[..., :H])) for a in (ks, vs)]
    return jax_planes, port_planes


def _limit(q, k, v, n_past, ks, vs):
    """2^-6 * attention(q, k, |v|) per element: the JAX kernel rounds its
    probabilities (relative to the running max of its KV block walk) times
    the value scales to bf16, the plain version the same relative to the
    row's max, each within 2^-8 of itself (an 8-bit significand), so where
    the walk rescales an output element moves by at most 2^-7 of
    sum_j p_j |v_j| / l; the limit takes twice that (the f32 score and sum
    differences are orders of magnitude smaller)."""
    return 2.0**-6 * tfa.flash_attention(q, k, v.abs(), n_past, layer_idx=LAYER,
                                         k_scale=ks, v_scale=vs).numpy()


def test_quantize_rows_matches_jax():
    """Bit-equal int8 bytes and scales against the JAX function as XLA
    compiles it (jitted, as every JAX caller runs it), on rows with an
    all-zero row and exact half-way values (round half to even)."""
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((3, 5, D)) * 3).astype(np.float32)
    x[0, 0] = 0.0
    # amax 127 gives scale 127 * f32(1/127) = 1, so these land on .5 exactly
    x[1, 2, :8] = [127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5]
    xj = jnp.asarray(x, jnp.bfloat16)
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(torch.bfloat16)
    qj, sj = jax.jit(jkq.quantize_rows)(xj)
    qt, st = tkq.quantize_rows(xt)
    assert qt.dtype == torch.int8 and st.dtype == torch.float32
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    assert st[0, 0] == 1.0 and not qt[0, 0].any()
    assert qt[1, 2, :8].tolist() == [127, 0, 2, 2, 0, -2, -2, 126]
    np.testing.assert_array_equal(tkq.dequantize_rows(qt, st).numpy(),
                                  np.asarray(jkq.dequantize_rows(qj, sj)))


@pytest.mark.parametrize("b,t,n_past", [(1, 1, 0), (1, 1, 37), (2, 8, 13)])
def test_update_int8_matches_jax(b, t, n_past):
    rng = np.random.default_rng(100 * t + n_past)
    qj, qt = _bf16(rng, (b, t, H, D))
    knj, knt = _bf16(rng, (b, t, H, D), std=2.0)
    vnj, vnt = _bf16(rng, (b, t, H, D), std=2.0)
    (kj, vj, ksj, vsj), (kt, vt, kst, vst) = _int8_cache(rng, b)
    want = jfa.flash_attention_update(
        qj, knj, vnj, kj, vj, jnp.int32(n_past), jnp.int32(LAYER), block_k=32,
        k_scale=ksj, v_scale=vsj,
    )
    got = tfa.flash_attention_update(qt, knt, vnt, kt, vt, n_past, LAYER, block_k=32,
                                     k_scale=kst, v_scale=vst)
    # every cache plane is updated in place, and every byte equals the JAX
    # cache's (the scale planes in their first H lanes)
    assert all(g is p for g, p in zip(got[1:], (kt, vt, kst, vst)))
    np.testing.assert_array_equal(kt.numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(vt.numpy(), np.asarray(want[2]))
    np.testing.assert_array_equal(kst.numpy(), np.asarray(want[3])[..., :H])
    np.testing.assert_array_equal(vst.numpy(), np.asarray(want[4])[..., :H])
    err = np.abs(got[0].numpy() - np.asarray(want[0]))
    limit = _limit(qt, kt, vt, n_past, kst, vst)
    assert (err <= limit).all(), float((err / limit).max())


def test_read_int8_matches_jax():
    """The read path at T = 5, not a multiple of the 32-row KV block."""
    t, n_past = 5, 20
    rng = np.random.default_rng(7)
    qj, qt = _bf16(rng, (1, t, H, D))
    (kj, vj, ksj, vsj), (kt, vt, kst, vst) = _int8_cache(rng, 1)
    want = jfa.flash_attention(qj, kj, vj, jnp.int32(n_past), block_k=32,
                               layer_idx=jnp.int32(LAYER), k_scale=ksj, v_scale=vsj)
    got = tfa.flash_attention(qt, kt, vt, n_past, layer_idx=LAYER, block_k=32,
                              k_scale=kst, v_scale=vst)
    err = np.abs(got.numpy() - np.asarray(want))
    limit = _limit(qt, kt, vt, n_past, kst, vst)
    assert (err <= limit).all(), float((err / limit).max())


# One KV block (block_k = S): the JAX kernel's running max is the row's max,
# so the plain version rounds the same probabilities exp(s - max) * v_scale
# to bf16 and divides by the same f32 sum l at the end; what is left is the
# f32 summation order of the products and sums and the two exp routines (a
# few f32 ulps). The plain version once rounded the normalized
# probabilities and missed this limit by ~1000x (2^-8 relative per term).
ONE_BLOCK_REL = 2.0**-18


@pytest.mark.parametrize("path", ["update", "read"])
def test_int8_rounding_point_matches_jax(path):
    """The plain int8 attention rounds where the JAX kernel rounds: with the
    cache in one KV block, it agrees with the kernel to f32 rounding."""
    b, t, n_past = 2, 8, 13
    rng = np.random.default_rng(31)
    qj, qt = _bf16(rng, (b, t, H, D), std=2.0)
    knj, knt = _bf16(rng, (b, t, H, D), std=2.0)
    vnj, vnt = _bf16(rng, (b, t, H, D), std=2.0)
    (kj, vj, ksj, vsj), (kt, vt, kst, vst) = _int8_cache(rng, b)
    kw = dict(block_k=S)
    if path == "update":
        want = jfa.flash_attention_update(qj, knj, vnj, kj, vj, jnp.int32(n_past),
                                          jnp.int32(LAYER), k_scale=ksj, v_scale=vsj, **kw)[0]
        got = tfa.flash_attention_update(qt, knt, vnt, kt, vt, n_past, LAYER, k_scale=kst,
                                         v_scale=vst, **kw)[0]
    else:
        want = jfa.flash_attention(qj, kj, vj, jnp.int32(n_past), layer_idx=jnp.int32(LAYER),
                                   k_scale=ksj, v_scale=vsj, **kw)
        got = tfa.flash_attention(qt, kt, vt, n_past, layer_idx=LAYER, k_scale=kst,
                                  v_scale=vst, **kw)
    err = np.abs(got.numpy() - np.asarray(want))
    limit = ONE_BLOCK_REL / 2.0**-6 * _limit(qt, kt, vt, n_past, kst, vst)
    assert (err <= limit).all(), float((err / limit).max())
