"""The port's batched decode attention (`ops/flash_decode.py`, plain version
on the CPU) against the JAX package's `flash_decode_update` (Pallas in
interpret mode), bf16 and int8, and against the port's own fused update
attention at T = 1: the two share one block partition, so the plain K4 must
equal the plain K2 exactly. Then one B=3 decode step of the tiny model
through that route, against JAX `llama_forward`."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llamavk_tpu.models import llama as jm
from llamavk_tpu.models import loader as jl
from llamavk_tpu.ops import flash_decode as jfd
from llamavk_tpu_torch.models import llama as tm
from llamavk_tpu_torch.models import loader as tl
from llamavk_tpu_torch.ops import flash_attn as tfa
from llamavk_tpu_torch.ops import flash_decode as tfd

torch.set_num_threads(2)

B, H, S, D, L = 4, 4, 256, 64, 3
LAYER = 1
NPAST = [0, 7, 130, 255]
HS = 8  # the JAX scale planes' lane count here


def _case(quantized: bool, seed: int = 0):
    """(JAX operands, port operands): q, k_new, v_new [B, 1, H, D] bf16 and a
    bf16 cache, or an int8 cache with its scale planes."""
    rng = np.random.default_rng(seed)
    new = [jnp.asarray(rng.standard_normal((B, 1, H, D)), jnp.bfloat16) for _ in range(3)]
    if quantized:
        cache = [rng.integers(-127, 127, (L, B, H, S, D)).astype(np.int8) for _ in range(2)]
        cache += [(np.abs(rng.standard_normal((L, B, S, HS))) * 0.02 + 0.001).astype(np.float32)
                  for _ in range(2)]
        jax_cache = [jnp.asarray(a) for a in cache]
        port_cache = [torch.from_numpy(a.copy()) for a in cache[:2]]
        port_cache += [torch.from_numpy(np.ascontiguousarray(a[..., :H])) for a in cache[2:]]
    else:
        jax_cache = [jnp.asarray(rng.standard_normal((L, B, H, S, D)), jnp.bfloat16)
                     for _ in range(2)]
        port_cache = [torch.from_numpy(np.array(a.astype(jnp.float32))).to(torch.bfloat16)
                      for a in jax_cache]
    port_new = [torch.from_numpy(np.array(a.astype(jnp.float32))).to(torch.bfloat16) for a in new]
    return new, jax_cache, port_new, port_cache


def _np(x):
    return x.float().numpy() if x.dtype == torch.bfloat16 else x.numpy()


def test_work_list():
    """tests/test_flash_decode.py::test_work_list's expectations, and the JAX
    function's output."""
    npast = [0, 255, 256, 511]
    row, blk, total = tfd.decode_work_list(torch.tensor(npast, dtype=torch.int32), 4, 512, 256)
    # per-row blocks: 1, 1, 2, 2 -> total 6
    assert total == 6
    assert row[:6].tolist() == [0, 1, 2, 2, 3, 3]
    assert blk[:6].tolist() == [0, 0, 0, 1, 0, 1]
    assert row[6:].tolist() == [3, 3]  # padding clamps to the last row
    jrow, jblk, jtotal = jfd.decode_work_list(jnp.asarray(npast, jnp.int32), 4, 512, 256)
    np.testing.assert_array_equal(row.numpy(), np.asarray(jrow))
    np.testing.assert_array_equal(blk.numpy(), np.asarray(jblk))
    assert total == int(jtotal)


@pytest.mark.parametrize("quantized", [False, True], ids=["bf16", "int8"])
def test_decode_matches_jax(quantized):
    new, jax_cache, port_new, port_cache = _case(quantized)
    jkw = dict(k_scale=jax_cache[2], v_scale=jax_cache[3]) if quantized else {}
    want = jfd.flash_decode_update(*new, *jax_cache[:2], jnp.asarray(NPAST, jnp.int32),
                                   jnp.int32(LAYER), block_k=64, **jkw)
    tkw = dict(k_scale=port_cache[2], v_scale=port_cache[3]) if quantized else {}
    npast = torch.tensor(NPAST, dtype=torch.int32)
    got = tfd.flash_decode_update(*port_new, *port_cache[:2], npast, LAYER, block_k=64, **tkw)
    # caches updated in place, byte-equal to the JAX caches (scale planes in
    # their first H lanes)
    assert all(g is p for g, p in zip(got[1:], port_cache))
    for g, w in zip(got[1:], want[1:]):
        w = np.asarray(w.astype(jnp.float32) if w.dtype == jnp.bfloat16 else w)
        np.testing.assert_array_equal(_np(g), w[..., :H] if g.dim() == 4 else w)
    # outputs: the per-element limit of tests/test_torch_kv_quant.py, two
    # bf16 probability roundings (2^-7 of attention(q, k, |v|)), doubled
    err = np.abs(got[0].numpy() - np.asarray(want[0]))
    limit = 2.0**-6 * tfa.flash_attention(port_new[0], port_cache[0], port_cache[1].abs(), npast,
                                          layer_idx=LAYER, **tkw).numpy()
    assert (err <= limit).all(), float((err / limit).max())


@pytest.mark.parametrize("quantized", [False, True], ids=["bf16", "int8"])
def test_plain_decode_equals_plain_update(quantized):
    """The plain K4 and the plain K2 at T = 1 and equal block_k: equal
    outputs and caches, element for element."""
    _, _, new, cache = _case(quantized, seed=3)
    cache2 = [c.clone() for c in cache]
    npast = torch.tensor(NPAST, dtype=torch.int32)
    names = ("k_scale", "v_scale")
    got = tfd.flash_decode_update(*new, *cache[:2], npast, LAYER, block_k=64,
                                  **dict(zip(names, cache[2:])))
    want = tfa.flash_attention_update(*new, *cache2[:2], npast, LAYER, block_k=64,
                                      **dict(zip(names, cache2[2:])))
    assert len(got) == len(want) == (5 if quantized else 3)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_batched_decode_step_int8_matches_jax(tmp_path, monkeypatch):
    """One decode step of the tiny model at B=3 with the per-row positions
    [10, 5, 3] over a seeded int8 cache: the batched decode route of
    llama.py:571-588, against JAX. Logits within two bf16 ulps (0.032, the
    tolerance of tests/test_torch_model.py); the new rows quantize from
    activations that may sit an ulp apart, so the caches compare
    dequantized, within one quantization step of such rows (0.032)."""
    path = str(tmp_path / "tiny-q4.bin")
    jl.random_tiny_model(write_path=path, quantize=True)
    jcfg, jparams, _ = jl.load_model(path)
    cfg, params, _ = tl.load_model(path, device="cpu")
    rng = np.random.default_rng(5)
    n_ctx = 64
    shape = (cfg.n_layer, 3, cfg.n_head, n_ctx, cfg.head_dim)
    data = [rng.integers(-127, 128, shape).astype(np.int8) for _ in range(2)]
    scales = [rng.uniform(0.005, 0.03, (cfg.n_layer, 3, n_ctx, cfg.n_head)).astype(np.float32)
              for _ in range(2)]
    jcache = jm.KVCache(*(jnp.asarray(a) for a in data + scales))
    cache = tm.KVCache(*(torch.from_numpy(a.copy()) for a in data + scales))
    toks, npast = [[4], [8], [15]], [10, 5, 3]
    fwd = jax.jit(jm.llama_forward, static_argnames=("cfg", "attn_impl"))
    want, jcache, _ = fwd(jparams, jnp.asarray(toks, jnp.int32), jcache,
                          jnp.asarray(npast, jnp.int32), jcfg, attn_impl="flash")
    calls = []
    monkeypatch.setattr(tm, "flash_decode_update",
                        lambda *a, _fn=tm.flash_decode_update, **k: calls.append(1) or _fn(*a, **k))
    got, _, _ = tm.llama_forward(params, torch.tensor(toks), cache,
                                 torch.tensor(npast, dtype=torch.int32), cfg)
    assert len(calls) == cfg.n_layer
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=0.032)
    for plane, sc, wp, ws in ((cache.k, cache.k_scale, jcache.k, jcache.k_scale),
                              (cache.v, cache.v_scale, jcache.v, jcache.v_scale)):
        deq = [np.asarray(p, np.float32) * np.asarray(x).transpose(0, 1, 3, 2)[..., None]
               for p, x in ((plane.numpy(), sc.numpy()), (wp, ws))]
        np.testing.assert_allclose(deq[0], deq[1], rtol=0, atol=0.032)
