"""The port's f32 KV cache and f32 scale planes on the CPU, against the JAX
package: the plain versions of the f32 modes of K2, K3 and K4 against the
JAX kernels in interpret mode (new rows stored as they arrive, nothing
rounded to bf16), over flat caches, f32 page pools through a scrambled
table, and f32 slots under the bf16 prefix pool; K1 with f32 scales,
`llama_forward` over an f32 cache (flash and einsum, the latter as
`perplexity --f32` runs it) and an f32 page pool, the single-stream engine
and its embeddings and the shared-prefix batched engine over f32 slots
against the JAX engines, the batched engine against the port's own single
stream, and the modes that stay refused. Inputs come from seeded NumPy."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llamavk_tpu.models import llama as jm
from llamavk_tpu.models import loader as jl
from llamavk_tpu.ops import flash_attn as jfa
from llamavk_tpu.ops import flash_decode as jfd
from llamavk_tpu import ops as jops
from llamavk_tpu.runtime import batching as jb
from llamavk_tpu.formats.q4 import quantize_q4_0, quantize_q4_1
from llamavk_tpu.formats.repack import repack_q4_0, repack_q4_1
from llamavk_tpu.runtime import engine as je
from llamavk_tpu.runtime import sampling as js
from llamavk_tpu_torch.models import llama as tm
from llamavk_tpu_torch.models import loader as tl
from llamavk_tpu_torch.ops import flash_attn as tfa
from llamavk_tpu_torch.ops import flash_decode as tfd
from llamavk_tpu_torch.ops import q4_matmul as tq4
from llamavk_tpu_torch.ops import qweight as tqw
from llamavk_tpu_torch.runtime import sampling as ts
from llamavk_tpu_torch.runtime.batching import BatchConfig, BatchedEngine
from llamavk_tpu_torch.runtime.engine import Engine, EngineConfig

torch.set_num_threads(2)

L, S, LAYER = 2, 64, 1
# An f32 cache rounds nothing to bf16. What is left between the dense plain
# version and the JAX kernel's online softmax is the f32 summation order of
# the scores (at most D 2^-24 sum_d |q_d k_d|, ~6e-5 at unit scores of
# D = 128), of l and of the PV sum (S 2^-24 each): 2^-12 of attention(q, k,
# |v|) covers twice their sum, 64 times tighter than the bf16 mode's 2^-6.
F32_REL = 2.0**-12
# K1 with f32 scales: bf16 products of the same bf16(q * s) weights summed
# in f32 on both sides (tests/test_torch_ops.py's limit)
MATMUL_TOL = dict(rtol=1e-4, atol=1e-4)
# logits of the tiny model (|logit| < 4) with bf16 activations: two bf16
# ulps (tests/test_torch_model.py)
LOGIT_TOL = 0.032


def _bf16(rng, shape, std=1.0):
    """One bf16 array for both frameworks (rounded once, by JAX)."""
    j = jnp.asarray(std * rng.standard_normal(shape), jnp.bfloat16)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(torch.bfloat16)


def _f32(rng, shape):
    a = rng.standard_normal(shape).astype(np.float32)
    return jnp.asarray(a), torch.from_numpy(a.copy())


def _limit(q, k, v, n_past, **kw) -> np.ndarray:
    return F32_REL * tfa.flash_attention_ref(q, k, v.abs(), n_past, layer_idx=LAYER,
                                             **kw).numpy()


@pytest.mark.parametrize("b,t,n_past,d", [(1, 1, 37, 64), (1, 8, 13, 64), (2, 1, 20, 128)])
def test_update_f32_matches_jax(b, t, n_past, d):
    """K2's f32 mode: bf16 queries and rows (the engines' activations) over
    an f32 cache. The written rows equal the JAX cache byte for byte (the
    untouched rows with them), and the outputs agree within F32_REL."""
    h = 2
    rng = np.random.default_rng(10 * t + n_past)
    qj, qt = _bf16(rng, (b, t, h, d), std=2.0)
    knj, knt = _bf16(rng, (b, t, h, d), std=2.0)
    vnj, vnt = _bf16(rng, (b, t, h, d))
    kcj, kct = _f32(rng, (L, b, h, S, d))
    vcj, vct = _f32(rng, (L, b, h, S, d))
    before = kct.clone()
    want, kj2, vj2 = jfa.flash_attention_update(qj, knj, vnj, kcj, vcj, jnp.int32(n_past),
                                                jnp.int32(LAYER), block_k=32)
    got, kt2, vt2 = tfa.flash_attention_update(qt, knt, vnt, kct, vct, n_past, LAYER,
                                               block_k=32)
    assert kt2 is kct and kt2.dtype == torch.float32
    np.testing.assert_array_equal(kt2.numpy(), np.asarray(kj2))
    np.testing.assert_array_equal(vt2.numpy(), np.asarray(vj2))
    rows = slice(n_past, n_past + t)
    assert torch.equal(kt2[LAYER, :, :, rows], knt.float().transpose(1, 2))
    untouched = torch.ones(S, dtype=torch.bool)
    untouched[rows] = False
    assert torch.equal(kt2[:, :, :, untouched], before[:, :, :, untouched])
    err = np.abs(got.numpy() - np.asarray(want))
    assert (err <= _limit(qt, kt2, vt2, n_past)).all()


def test_read_f32_matches_jax():
    """K3's f32 mode at T = 5 (not a multiple of the 32-row KV block), D = 128."""
    t, n_past, h, d = 5, 20, 2, 128
    rng = np.random.default_rng(7)
    qj, qt = _bf16(rng, (1, t, h, d), std=2.0)
    kcj, kct = _f32(rng, (L, 1, h, S, d))
    vcj, vct = _f32(rng, (L, 1, h, S, d))
    want = jfa.flash_attention(qj, kcj, vcj, jnp.int32(n_past), block_k=32,
                               layer_idx=jnp.int32(LAYER))
    got = tfa.flash_attention(qt, kct, vct, n_past, layer_idx=LAYER, block_k=32)
    err = np.abs(got.numpy() - np.asarray(want))
    assert (err <= _limit(qt, kct, vct, n_past)).all()
    # the f32 mode rounds nothing: the bf16 mode's output is another function
    bf = tfa.flash_attention(qt, kct.to(torch.bfloat16), vct.to(torch.bfloat16), n_past,
                             layer_idx=LAYER)
    assert not torch.equal(bf, got)


def test_decode_f32_matches_jax_and_update():
    """K4's f32 mode at B = 4 with ragged n_past against the JAX kernel, and
    the plain K4 equal to the plain K2 at T = 1, row by row, bit for bit."""
    b, h, d = 4, 2, 64
    npast = [0, 7, 33, 63]
    rng = np.random.default_rng(3)
    new = [_bf16(rng, (b, 1, h, d)) for _ in range(3)]
    kcj, kct = _f32(rng, (L, b, h, S, d))
    vcj, vct = _f32(rng, (L, b, h, S, d))
    orig = (kct.clone(), vct.clone())
    want, kj2, vj2 = jfd.flash_decode_update(*(j for j, _ in new), kcj, vcj,
                                             jnp.asarray(npast, jnp.int32), jnp.int32(LAYER),
                                             block_k=32)
    nt = torch.tensor(npast, dtype=torch.int32)
    got, kt2, vt2 = tfd.flash_decode_update(*(t for _, t in new), kct, vct, nt, LAYER,
                                            block_k=32)
    np.testing.assert_array_equal(kt2.numpy(), np.asarray(kj2))
    np.testing.assert_array_equal(vt2.numpy(), np.asarray(vj2))
    err = np.abs(got.numpy() - np.asarray(want))
    assert (err <= _limit(new[0][1], kt2, vt2, nt)).all()
    for r in range(b):
        kr, vr = (x[:, r : r + 1].clone() for x in orig)
        out = tfa.flash_attention_update(*(t[r : r + 1] for _, t in new), kr, vr, npast[r],
                                         LAYER, block_k=32)[0]
        assert torch.equal(out[0], got[r])
        assert torch.equal(kr[:, 0], kt2[:, r]) and torch.equal(vr[:, 0], vt2[:, r])


@pytest.mark.parametrize("m", [1, 8])
@pytest.mark.parametrize("q41", [False, True], ids=["q4_0", "q4_1"])
def test_q4_f32_scales_matches_jax(m, q41):
    """K1 with an f32 scale plane (and an f32 bias plane for Q4_1), as
    `perplexity --f32` loads it, against the JAX kernel in interpret mode."""
    k, n = 256, 256
    rng = np.random.default_rng(m + 10 * q41)
    w = (rng.standard_normal((n, k)) * 0.1).astype(np.float32)
    pk = repack_q4_1(*quantize_q4_1(w)) if q41 else repack_q4_0(*quantize_q4_0(w))
    jw = jops.qweight_from_packed(pk, scale_dtype=jnp.float32)
    tw = tqw.qweight_from_packed(pk, scale_dtype=torch.float32, device="cpu")
    assert tw.scales.dtype == torch.float32
    xj, xt = _bf16(rng, (m, k))
    want = np.asarray(jops.q4_matmul(xj, jw, out_dtype=jnp.float32))
    got = tq4.q4_matmul(xt, tw, out_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), want, **MATMUL_TOL)
    # f32 scales are another weight than their bf16 rounding
    t16 = tqw.qweight_from_packed(pk, scale_dtype=torch.bfloat16, device="cpu")
    assert not torch.equal(tq4.q4_matmul(xt, t16, out_dtype=torch.float32), got)


# --- the model and the engines ------------------------------------------------

# a model seed and prompt whose greedy stream keeps every top-2 logit gap
# above 3 * LOGIT_TOL for 12 steps with an f32 cache (checked below; the
# smallest is 0.127 at step 4). The JAX engine's logits lie within
# LOGIT_TOL of the port's, so the argmax agrees wherever the gap exceeds
# 2 * LOGIT_TOL.
MODEL_SEED = 219
PROMPT = [1, 28, 171, 252, 203, 125, 195, 227]
N_PREDICT = 12
N_CTX = 64


@pytest.fixture(scope="module")
def tiny_path(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("tiny") / "tiny-q4.bin")
    jl.random_tiny_model(seed=MODEL_SEED, write_path=path, quantize=True)
    return path


@pytest.fixture(scope="module")
def models(tiny_path):
    """(port, JAX) (cfg, params) of the tiny file, bf16 scales."""
    return tl.load_model(tiny_path, device="cpu")[:2], jl.load_model(tiny_path)[:2]


@pytest.mark.parametrize("impl", ["flash", "einsum"])
def test_forward_f32_cache_matches_jax(tiny_path, impl):
    """An 8-token prefill over an f32 cache (the engine test below decodes).
    flash: bf16 activations and scales (the llama.h API's f16_kv = false).
    einsum: f32 activations, scales and dense weights (perplexity --f32)."""
    f32 = impl == "einsum"
    tkw = dict(scale_dtype=torch.float32, dense_dtype=torch.float32) if f32 else {}
    jkw = dict(scale_dtype=jnp.float32, dense_dtype=jnp.float32) if f32 else {}
    tcfg, tparams, _ = tl.load_model(tiny_path, device="cpu", **tkw)
    jcfg, jparams, _ = jl.load_model(tiny_path, **jkw)
    tdt, jdt = (torch.float32, jnp.float32) if f32 else (torch.bfloat16, jnp.bfloat16)
    tc = tm.init_kv_cache(tcfg, 1, N_CTX, torch.float32, "cpu")
    jc = jm.init_kv_cache(jcfg, 1, N_CTX, dtype=jnp.float32)
    tl_, tc, _ = tm.llama_forward(tparams, torch.tensor([PROMPT]), tc, 0, tcfg, dtype=tdt,
                                  attn_impl=impl, logits_all=True)
    jl_, jc, _ = jm.llama_forward(jparams, jnp.asarray([PROMPT], jnp.int32), jc, jnp.int32(0),
                                  jcfg, dtype=jdt, attn_impl=impl, logits_all=True)
    np.testing.assert_allclose(tl_.numpy(), np.asarray(jl_), rtol=0, atol=LOGIT_TOL)
    assert tc.k.dtype == torch.float32
    n = len(PROMPT)
    np.testing.assert_allclose(tc.k[:, :, :, :n].numpy(), np.asarray(jc.k)[:, :, :, :n],
                               rtol=0, atol=LOGIT_TOL)


def test_engine_f32_matches_jax(tiny_path, models):
    """Engine(kv_dtype="float32")'s greedy stream and embeddings against the
    JAX engine's (the same default KV block on both sides), after a near-tie
    guard on the port's own forward."""
    (cfg, params), (jcfg, jparams) = models
    greedy = ts.SamplerParams(temp=0.0)
    eng = Engine(cfg, params, EngineConfig(n_ctx=N_CTX, kv_dtype="float32"), device="cpu")
    assert eng.cache.k.dtype == torch.float32
    jeng = je.Engine(jcfg, jparams, je.EngineConfig(n_ctx=N_CTX, kv_dtype="float32"))
    eng.eval(PROMPT)
    jeng.eval(PROMPT)
    np.testing.assert_allclose(eng.get_embeddings(), jeng.get_embeddings(), rtol=0,
                               atol=LOGIT_TOL)
    eng.reset()
    jeng.reset()
    got = eng.generate(PROMPT, N_PREDICT, greedy, ignore_eos=True)
    cache = tm.init_kv_cache(cfg, 1, N_CTX, torch.float32, "cpu")
    logits, _, _ = tm.llama_forward(params, torch.tensor([PROMPT]), cache, 0, cfg)
    for i, tok in enumerate(got):
        top2 = torch.topk(logits[0, -1], 2).values
        assert float(top2[0] - top2[1]) > 3 * LOGIT_TOL, f"near-tie at step {i}"
        assert int(logits[0, -1].argmax()) == tok
        if i + 1 < len(got):
            logits, _, _ = tm.llama_forward(params, torch.tensor([[tok]]), cache,
                                            len(PROMPT) + i, cfg)
    want = jeng.generate(PROMPT, N_PREDICT, js.SamplerParams(temp=0.0), ignore_eos=True)
    assert got == want


def test_engine_f32_session_roundtrip(models):
    """save_session / restore_session keep the f32 planes: the continuation
    from a restored state equals the first one exactly."""
    (cfg, params), _ = models
    eng = Engine(cfg, params, EngineConfig(n_ctx=N_CTX, kv_dtype="float32"), device="cpu")
    eng.eval(PROMPT)
    s = eng.save_session()
    assert s.k.dtype == torch.float32
    a = eng.eval([5, 6])
    eng.restore_session(s)
    np.testing.assert_array_equal(eng.eval([5, 6]), a)


def test_batched_f32_matches_single(models):
    """BatchedEngine(kv_dtype="float32") on flat caches: every greedy stream
    equals the port's single-stream f32 engine's (K4 at T = 1 computes what
    K2 does, row by row)."""
    (cfg, params), _ = models
    prompts = [[10, 177, 191], [30, 145], [60, 51, 246, 212, 166], [42]]
    be = BatchedEngine(cfg, params, BatchConfig(max_batch=4, n_ctx=N_CTX, block=4,
                                                kv_dtype="float32"), device="cpu")
    assert be.cache.k.dtype == torch.float32
    reqs = [be.submit(p, 6, ts.SamplerParams(temp=0.0), ignore_eos=True) for p in prompts]
    be.run()
    for p, r in zip(prompts, reqs):
        eng = Engine(cfg, params, EngineConfig(n_ctx=N_CTX, kv_dtype="float32"), device="cpu")
        assert r.generated == eng.generate(p, 6, ts.SamplerParams(temp=0.0), ignore_eos=True)


def test_f32_modes_still_refused(models):
    """What stays refused over f32: the paged BatchedEngine, as the JAX
    engine asserts bf16 or int8 pools (batching.py:180-183 there; its
    forward and kernels take an f32 pool, and so do the port's, below), and
    a float16 cache; an f32 history ring is built (its streams:
    tests/test_torch_ring.py)."""
    (cfg, params), _ = models
    ring = tm.init_kv_cache(cfg, 1, 32, torch.float32, "cpu", ring=True)
    assert ring.k.dtype == torch.float32 and ring.pos is not None
    eng = Engine(cfg, params, EngineConfig(n_ctx=32, kv_dtype="float32", ctx_ring=True),
                 device="cpu")
    assert eng.cache.k.dtype == torch.float32 and eng.cache.pos is not None
    with pytest.raises(NotImplementedError, match="batching.py:180-183"):
        BatchedEngine(cfg, params, BatchConfig(max_batch=2, n_ctx=N_CTX, kv_dtype="float32",
                                               paged=True, page_size=8), device="cpu")
    with pytest.raises(NotImplementedError):
        Engine(cfg, params, EngineConfig(n_ctx=32, kv_dtype="float16"), device="cpu")


# --- f32 page pools and f32 slots under the prefix pool -----------------------

PS, MAXLB = 8, 4  # 8-row pages (the f32 KV block step), 4 a table row


def _pool(rng, b: int, d: int, h: int = 2):
    """f32 pool planes [L, NP, H, PS, D] for both frameworks and a scrambled
    [B, MAXLB] table that maps no page twice and never page 0."""
    n_pages = b * MAXLB + 3
    kj, kt = _f32(rng, (L, n_pages, h, PS, d))
    vj, vt = _f32(rng, (L, n_pages, h, PS, d))
    table = (rng.permutation(n_pages - 1)[: b * MAXLB] + 1).reshape(b, MAXLB).astype(np.int32)
    return (kj, vj), (kt, vt), table


@pytest.mark.parametrize("kernel", ["read", "update", "decode"])
def test_f32_pool_matches_jax(kernel):
    """K3 (T = 5), K2 (T = 4) and K4 over an f32 page pool through a
    scrambled table, bf16 queries and rows, against the JAX kernels in
    interpret mode: the pool bytes equal the JAX pool's (the new rows stored
    as they arrive), the outputs within F32_REL; K4 equals the plain K2 at
    T = 1 bit for bit, pool included."""
    b, d = 2, 64
    t = {"read": 5, "update": 4, "decode": 1}[kernel]
    rng = np.random.default_rng(40 + t)
    (kj, vj), (kt, vt), table = _pool(rng, b, d)
    npast = np.array([4, 19] if kernel != "read" else [3, 20], np.int32)
    qj, qt = _bf16(rng, (b, t, 2, d), std=2.0)
    knj, knt = _bf16(rng, (b, t, 2, d), std=2.0)
    vnj, vnt = _bf16(rng, (b, t, 2, d))
    tab_j, tab_t, np_t = jnp.asarray(table), torch.from_numpy(table), torch.from_numpy(npast)
    if kernel == "read":
        tfa.write_rows(knt, vnt, kt, vt, np_t, LAYER, page_table=tab_t)
        kj, vj = jnp.asarray(kt.numpy()), jnp.asarray(vt.numpy())
        want = jfa.flash_attention(qj, kj, vj, jnp.asarray(npast), block_k=PS,
                                   layer_idx=jnp.int32(LAYER), page_table=tab_j)
        got = tfa.flash_attention(qt, kt, vt, np_t, layer_idx=LAYER, block_k=PS,
                                  page_table=tab_t)
    elif kernel == "update":
        want, kj, vj = jfa.flash_attention_update(qj, knj, vnj, kj, vj, jnp.asarray(npast),
                                                  jnp.int32(LAYER), block_t=PS, block_k=PS,
                                                  page_table=tab_j)
        got, kt, vt = tfa.flash_attention_update(qt, knt, vnt, kt, vt, np_t, LAYER,
                                                 block_t=PS, block_k=PS, page_table=tab_t)
    else:
        k0, v0 = kt.clone(), vt.clone()
        want, kj, vj = jfd.flash_decode_update(qj, knj, vnj, kj, vj, jnp.asarray(npast),
                                               jnp.int32(LAYER), block_k=PS, page_table=tab_j)
        got, kt, vt = tfd.flash_decode_update(qt, knt, vnt, kt, vt, np_t, LAYER, block_k=PS,
                                              page_table=tab_t)
        k2 = tfa.flash_attention_update(qt, knt, vnt, k0, v0, np_t, LAYER, block_t=PS,
                                        block_k=PS, page_table=tab_t)
        assert torch.equal(k2[0], got) and torch.equal(k0, kt) and torch.equal(v0, vt)
    assert kt.dtype == torch.float32
    np.testing.assert_array_equal(kt.numpy(), np.asarray(kj))
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    err = np.abs(got.numpy() - np.asarray(want))
    assert (err <= _limit(qt, kt, vt, np_t, page_table=tab_t)).all()


def test_paged_forward_f32_pool_matches_jax(tiny_path, models):
    """llama_forward over an f32 page pool through a scrambled table: an
    8-token prefill that fills each row's first page (K2), then a decode
    step into the second page (K4), against the JAX forward. Logits within
    LOGIT_TOL with equal argmax, the pools within as much, every page off
    the table still zero."""
    (cfg, params), (jcfg, jparams) = models
    rng = np.random.default_rng(11)
    b = 2
    n_pages = b * MAXLB + 3
    jpool = jm.init_paged_kv_cache(jcfg, n_pages, PS, dtype=jnp.float32)
    pool = tm.init_paged_kv_cache(cfg, n_pages, PS, torch.float32, device="cpu")
    assert pool.k.dtype == torch.float32 and pool.k.shape[3] == PS
    table = rng.permutation(n_pages)[: b * MAXLB].reshape(b, MAXLB).astype(np.int32)
    fwd = jax.jit(jm.llama_forward, static_argnames=("cfg", "kv_block"))
    toks, n_past = rng.integers(0, cfg.n_vocab, (b, PS)), np.zeros(b, np.int32)
    for _ in range(2):
        want, jpool, _ = fwd(jparams, jnp.asarray(toks, jnp.int32), jpool, jnp.asarray(n_past),
                             jcfg, kv_block=PS, page_table=jnp.asarray(table))
        got, _, _ = tm.llama_forward(params, torch.from_numpy(toks), pool,
                                     torch.from_numpy(n_past), cfg, kv_block=PS,
                                     page_table=torch.from_numpy(table))
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=LOGIT_TOL)
        assert (got[:, -1].argmax(-1).numpy() == want[:, -1].argmax(-1)).all()
        n_past = n_past + toks.shape[1]
        toks = want[:, -1].argmax(-1)[:, None]  # the JAX stream's tokens
    for g, w in ((pool.k, jpool.k), (pool.v, jpool.v)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=LOGIT_TOL)
    off_table = sorted(set(range(n_pages)) - set(table.ravel().tolist()))
    assert not any(p[:, off_table].any() for p in pool.planes())


# the pool's rows round q and p to bf16 over f32 slots too (flash_attn.py:
# 697-713 there), so an output takes the bf16 mode's limit
PREFIX_REL = 2.0**-6


@pytest.mark.parametrize("update", [False, True], ids=["read", "update"])
def test_prefix_f32_slots_match_jax(update):
    """K3 (T = 5) and K2 (T = 4) over f32 slots under a bf16 prefix pool of
    ragged entries (prefix_len 0 = none), against the JAX kernels in
    interpret mode: the slot rows (K2) equal the JAX cache, the pool
    untouched, the outputs within PREFIX_REL of attention(q, k, |v|); at
    prefix_len 0 on every row the port equals its flat f32 call bit for
    bit."""
    b, h, d, sp = 3, 2, 32, 64
    t = 4 if update else 5
    rng = np.random.default_rng(60 + update)
    npast = np.array([3, 9, 5], np.int32)
    qj, qt = _bf16(rng, (b, t, h, d), std=2.0)
    knj, knt = _bf16(rng, (b, t, h, d), std=2.0)
    vnj, vnt = _bf16(rng, (b, t, h, d))
    kj, kt = _f32(rng, (L, b, h, S, d))
    vj, vt = _f32(rng, (L, b, h, S, d))
    pkj, pkt = _bf16(rng, (L, 3, h, sp, d))
    pvj, pvt = _bf16(rng, (L, 3, h, sp, d))
    pid, plen = np.array([2, 0, 1], np.int32), np.array([33, 0, 64], np.int32)
    jkw = dict(prefix_k=pkj, prefix_v=pvj, prefix_id=jnp.asarray(pid),
               prefix_len=jnp.asarray(plen))
    tkw = dict(prefix_k=pkt, prefix_v=pvt, prefix_id=torch.from_numpy(pid),
               prefix_len=torch.from_numpy(plen))
    np_t = torch.from_numpy(npast)
    flat = (kt.clone(), vt.clone())
    pool = (pkt.clone(), pvt.clone())
    if update:
        want, kj, vj = jfa.flash_attention_update(qj, knj, vnj, kj, vj, jnp.asarray(npast),
                                                  jnp.int32(LAYER), block_t=4, block_k=32,
                                                  **jkw)
        got, kt, vt = tfa.flash_attention_update(qt, knt, vnt, kt, vt, np_t, LAYER, block_t=4,
                                                 block_k=32, **tkw)
        np.testing.assert_array_equal(kt.numpy(), np.asarray(kj))
        np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
        zero = tfa.flash_attention_update(qt, knt, vnt, *flat, np_t, LAYER, block_t=4,
                                          block_k=32, **{**tkw, "prefix_len": np_t * 0})[0]
        plain = tfa.flash_attention_update(qt, knt, vnt, kt.clone(), vt.clone(), np_t, LAYER,
                                           block_t=4, block_k=32)[0]
    else:
        tfa.write_rows(knt, vnt, kt, vt, np_t, LAYER)
        kj, vj = jnp.asarray(kt.numpy()), jnp.asarray(vt.numpy())
        want = jfa.flash_attention(qj, kj, vj, jnp.asarray(npast), block_k=32,
                                   layer_idx=jnp.int32(LAYER), **jkw)
        got = tfa.flash_attention(qt, kt, vt, np_t, layer_idx=LAYER, block_k=32, **tkw)
        zero = tfa.flash_attention(qt, kt, vt, np_t, layer_idx=LAYER, block_k=32,
                                   **{**tkw, "prefix_len": np_t * 0})
        plain = tfa.flash_attention(qt, kt, vt, np_t, layer_idx=LAYER, block_k=32)
    assert torch.equal(zero, plain)
    assert torch.equal(pkt, pool[0]) and torch.equal(pvt, pool[1])
    lim = PREFIX_REL * tfa.flash_attention_ref(qt, kt, vt.abs(), np_t, layer_idx=LAYER,
                                               **{**tkw, "prefix_v": pvt.abs()}).numpy()
    assert (np.abs(got.numpy() - np.asarray(want)) <= lim).all()


# the shared-prefix engines' prefix and requests over f32 slots (model seed
# 219): the port's and the JAX engine's streams agree token for token
F32_PREFIX = [1, 28, 171, 252, 203, 125, 195]
F32_SUFFIXES = [([227, 5], 4), ([61, 40, 167], 3)]


def test_shared_prefix_f32_engine_matches_jax(models):
    """BatchedEngine(shared_prefix=True, kv_dtype="float32") at kv_block 32:
    the greedy streams of two requests continuing one registered prefix
    equal the JAX engine's (interpret mode); the pool is bf16 (its rows
    rounded, unlike a flat f32 cache's), the slots f32 and hold only the
    suffix."""
    (cfg, params), (jcfg, jparams) = models
    kw = dict(max_batch=2, n_ctx=N_CTX, block=4, shared_prefix=True, prefix_ctx=256,
              kv_dtype="float32", kv_block=32)
    streams = []
    for be, greedy in ((BatchedEngine(cfg, params, BatchConfig(**kw), device="cpu"),
                        ts.SamplerParams(temp=0.0)),
                       (jb.BatchedEngine(jcfg, jparams, jb.BatchConfig(**kw)),
                        js.SamplerParams(temp=0.0))):
        pid = be.register_prefix(F32_PREFIX)
        reqs = [be.submit(sfx, n, greedy, ignore_eos=True, prefix=pid)
                for sfx, n in F32_SUFFIXES]
        be.run()
        streams.append([r.generated for r in reqs])
    port = BatchedEngine(cfg, params, BatchConfig(**kw), device="cpu")
    assert port.cache.k.dtype == torch.float32 and port.pfx_k.dtype == torch.bfloat16
    assert streams[0] == streams[1]
    assert [len(x) for x in streams[0]] == [n for _, n in F32_SUFFIXES]
