"""The port's attention (bf16 flat cache, plain version on the CPU) against the
JAX package's Pallas kernels in interpret mode: the fused cache write plus
attention (`flash_attention_update`) and the read-only path
(`flash_attention`). Inputs come from seeded NumPy."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from llamavk_tpu.ops import flash_attn as jfa
from llamavk_tpu_torch.ops import flash_attn as tfa

torch.set_num_threads(2)

L, B, H, S, D = 2, 1, 2, 64, 64
LAYER = 1

# The JAX kernel runs an online softmax over KV blocks and feeds the PV
# product probabilities relative to its running max, rounded to bf16; the
# plain version rounds them relative to the row's max, which differ where
# the walk rescales. Outputs are O(1) averages of N(0,1) values, so the gap
# is a few bf16 ulps (2^-8 relative): the JAX package's own
# kernel-vs-reference tolerance (tests/test_flash_attn.py).
ATTN_TOL = dict(rtol=2e-2, atol=2e-2)


def _bf16(rng, shape, std=1.0):
    """One bf16 array for both frameworks (rounded once, by JAX)."""
    j = jnp.asarray(std * rng.standard_normal(shape), jnp.bfloat16)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(torch.bfloat16)


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


@pytest.mark.parametrize("t,n_past", [(1, 0), (1, 37), (8, 13)])
def test_update_matches_jax(t, n_past):
    rng = np.random.default_rng(100 * t + n_past)
    qj, qt = _bf16(rng, (B, t, H, D))
    knj, knt = _bf16(rng, (B, t, H, D))
    vnj, vnt = _bf16(rng, (B, t, H, D))
    kcj, kct = _bf16(rng, (L, B, H, S, D))
    vcj, vct = _bf16(rng, (L, B, H, S, D))

    want, kj2, vj2 = jfa.flash_attention_update(
        qj, knj, vnj, kcj, vcj, jnp.int32(n_past), jnp.int32(LAYER)
    )
    got, kt2, vt2 = tfa.flash_attention_update(qt, knt, vnt, kct, vct, n_past, LAYER)
    # the cache is updated in place, and every byte equals the JAX cache
    assert kt2 is kct and vt2 is vct
    np.testing.assert_array_equal(_f32(kt2), _f32(kj2))
    np.testing.assert_array_equal(_f32(vt2), _f32(vj2))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ATTN_TOL)


def test_read_matches_jax():
    """The read path at T = 5, which is not a multiple of the 32-row KV block
    nor of the query block."""
    t, n_past = 5, 20
    rng = np.random.default_rng(7)
    qj, qt = _bf16(rng, (B, t, H, D))
    kcj, kct = _bf16(rng, (L, B, H, S, D))
    vcj, vct = _bf16(rng, (L, B, H, S, D))
    want = jfa.flash_attention(
        qj, kcj, vcj, jnp.int32(n_past), block_k=32, layer_idx=jnp.int32(LAYER)
    )
    got = tfa.flash_attention(qt, kct, vct, n_past, layer_idx=LAYER, block_k=32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ATTN_TOL)


def test_read_matches_jax_head_dim_128():
    """At D = 128 the scale 1/sqrt(D) is not a power of two, so rounding the
    scaled q to bf16, as the JAX kernel does, moves the scores; the plain
    version rounds it the same way. What is left is each side's bf16 rounding
    of the probabilities (2^-8 relative each, relative to another max where
    the kernel's walk rescales), so an output element lies
    within 2^-7 of attention(q, k, |v|); the limit takes twice that. q and K
    have std 4, so the scores spread (std ~16) as a trained model's do and
    an unrounded q would miss the limit."""
    t, n_past, d = 5, 20, 128
    rng = np.random.default_rng(9)
    qj, qt = _bf16(rng, (B, t, H, d), std=4.0)
    kcj, kct = _bf16(rng, (L, B, H, S, d), std=4.0)
    vcj, vct = _bf16(rng, (L, B, H, S, d))
    want = jfa.flash_attention(
        qj, kcj, vcj, jnp.int32(n_past), block_k=32, layer_idx=jnp.int32(LAYER)
    )
    got = tfa.flash_attention(qt, kct, vct, n_past, layer_idx=LAYER, block_k=32)
    limit = 2.0**-6 * tfa.flash_attention(qt, kct, vct.abs(), n_past, layer_idx=LAYER)
    err = np.abs(got.numpy() - np.asarray(want))
    assert (err <= limit.numpy()).all(), float((err / limit.numpy()).max())


def test_vector_n_past_matches_scalar():
    """A [B] int32 n_past gives what the scalar gives, row by row."""
    rng = np.random.default_rng(8)
    _, qt = _bf16(rng, (2, 1, H, D))
    _, kct = _bf16(rng, (L, 2, H, S, D))
    _, vct = _bf16(rng, (L, 2, H, S, D))
    n_past = torch.tensor([3, 40], dtype=torch.int32)
    got = tfa.flash_attention(qt, kct, vct, n_past, layer_idx=0)
    for b in range(2):
        row = tfa.flash_attention(
            qt[b : b + 1], kct[:, b : b + 1].contiguous(), vct[:, b : b + 1].contiguous(),
            int(n_past[b]), layer_idx=0,
        )
        torch.testing.assert_close(got[b : b + 1], row, rtol=0, atol=0)


# every launch-key mode of K2 (update) and K3 (read): (path, paged, straddle,
# mode), over every cache type
ROUTE_MODES = [("update", False, False, ""), ("update", True, False, ""),
               ("update", True, True, ""), ("update", False, False, "ring"),
               ("update", False, False, "prefix"), ("update", False, False, "boff"),
               ("update", False, False, "nocommit"), ("read", False, False, ""),
               ("read", True, False, ""), ("read", False, False, "ring"),
               ("read", False, False, "prefix"), ("read", False, False, "boff")]


@pytest.mark.parametrize("kind", ["bf16", "int8", "f32"])
@pytest.mark.parametrize("t", [1, 4, 15, 16, 32, 353])
def test_attn_route(t, kind):
    """`attn_route` takes the split route from T = 1 to 15 and the tensor
    cores from T = 16 (an f32 cache on three TF32 passes), over every cache
    type; the key a wrapper call counts its launch under (`call_launch`)
    follows T and the cache type alone, whatever B and the mode, and every
    key is one of `launches`, with `_tc` exactly on the tensor-core route and
    `_split` exactly on the split route."""
    want = "tensor_core" if t >= 16 else "split"
    assert tfa.attn_route(t, kind) == want
    dtype = {"bf16": torch.bfloat16, "int8": torch.int8, "f32": torch.float32}[kind]
    for path, paged, straddle, mode in ROUTE_MODES:
        for b in (1, 4, 32):
            q = torch.zeros((b, t, H, D), dtype=torch.bfloat16)
            k = torch.zeros((L, b, H, S, D), dtype=dtype)
            route, key = tfa.call_launch(path, q, k, paged, straddle, mode)
            assert route == want
            assert key == tfa.launch_name(path, kind, paged, straddle, mode, want)
            assert key in tfa.launches
            assert ("_tc" in key) == (want == "tensor_core")
            assert ("_split" in key) == (want == "split")
