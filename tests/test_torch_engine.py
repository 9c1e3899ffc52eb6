"""The port's engine and sampler against the JAX package's: a greedy
`Engine.generate` stream on one tiny GGJT file, the sampling distribution,
the repeat penalty, and session save/restore."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from llamavk_tpu.models import loader as jl
from llamavk_tpu.runtime import engine as je
from llamavk_tpu.runtime import sampling as js
from llamavk_tpu_torch.models import llama as tm
from llamavk_tpu_torch.models import loader as tl
from llamavk_tpu_torch.runtime import engine as te
from llamavk_tpu_torch.runtime import sampling as ts

torch.set_num_threads(2)

# a model seed and prompt whose greedy stream has no near-tie in its first
# 16 steps and does not collapse onto one token
MODEL_SEED = 219
PROMPT = [1, 28, 171, 252, 203, 125, 195, 227]
N_PREDICT = 16
N_CTX = 64
# the port's logits sit within two bf16 ulps (0.032) of the JAX package's on
# the tiny model (tests/test_torch_model.py); greedy streams can only be
# compared where the top-2 gap is well above that
LOGIT_TOL = 0.032


@pytest.fixture(scope="module")
def tiny_path(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("tiny") / "tiny-q4.bin")
    jl.random_tiny_model(seed=MODEL_SEED, write_path=path, quantize=True)
    return path


@pytest.fixture(scope="module")
def port_model(tiny_path):
    return tl.load_model(tiny_path, device="cpu")


def test_greedy_generate_matches_jax(tiny_path, port_model):
    cfg, params, _ = port_model
    greedy = ts.SamplerParams(temp=0.0)
    eng = te.Engine(cfg, params, te.EngineConfig(n_ctx=N_CTX), device="cpu")
    got = eng.generate(PROMPT, N_PREDICT, greedy, ignore_eos=True)
    assert len(got) == N_PREDICT

    # near-tie guard: replay the stream step by step and check each top-2 gap
    cache = tm.init_kv_cache(cfg, 1, N_CTX, device="cpu")
    logits, _, _ = tm.llama_forward(params, torch.tensor([PROMPT]), cache, 0, cfg)
    for i, tok in enumerate(got):
        top2 = torch.topk(logits[0, -1], 2).values
        assert float(top2[0] - top2[1]) > 4 * LOGIT_TOL, f"near-tie at step {i}"
        assert int(logits[0, -1].argmax()) == tok
        if i + 1 < len(got):
            logits, _, _ = tm.llama_forward(
                params, torch.tensor([[tok]]), cache, len(PROMPT) + i, cfg
            )

    jcfg, jparams, _ = jl.load_model(tiny_path)
    jeng = je.Engine(jcfg, jparams, je.EngineConfig(n_ctx=N_CTX))
    want = jeng.generate(PROMPT, N_PREDICT, js.SamplerParams(temp=0.0), ignore_eos=True)
    assert got == want
    assert eng.n_past == jeng.n_past and eng.tokens == jeng.tokens


@pytest.mark.parametrize("top_k,top_p,temp", [(40, 0.95, 0.8), (0, 0.5, 1.3), (5, 1.0, 0.0)])
def test_probs_from_logits_matches_jax(top_k, top_p, temp):
    logits = (np.random.default_rng(top_k).standard_normal(256) * 3).astype(np.float32)
    want = np.asarray(js.probs_from_logits(jnp.asarray(logits), top_k, top_p, temp))
    got = ts.probs_from_logits(torch.from_numpy(logits), top_k, top_p, temp)
    # f32 softmax and renormalization of the same values on both sides
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


def test_sample_token_stays_in_kept_set():
    logits = torch.from_numpy((np.random.default_rng(1).standard_normal(256) * 3).astype(np.float32))
    sp = ts.SamplerParams(top_k=20, top_p=0.8, temp=0.9, repeat_penalty=1.0)
    kept = set(torch.nonzero(ts.probs_from_logits(logits, sp.top_k, sp.top_p, sp.temp)).flatten().tolist())
    gen = torch.Generator().manual_seed(5)
    last = torch.full((8,), -1, dtype=torch.int64)
    draws = [int(ts.sample_token(logits, last, gen, sp)) for _ in range(300)]
    assert set(draws) <= kept
    assert len(set(draws)) > 1  # it samples, it does not take the argmax
    again = torch.Generator().manual_seed(5)
    assert draws[:20] == [int(ts.sample_token(logits, last, again, sp)) for _ in range(20)]


def test_repeat_penalty_matches_jax():
    rng = np.random.default_rng(2)
    for trial in range(20):
        logits = (rng.standard_normal(64) * 2).astype(np.float32)
        window = rng.integers(-1, 64, 12)
        window[0] = int(logits.argmax())  # the penalty must be able to move the argmax
        want_scaled = np.asarray(
            js._apply_repeat_penalty(jnp.asarray(logits), jnp.asarray(window, jnp.int32), 1 / 0.7, 1.3)
        )
        got_scaled = ts._apply_repeat_penalty(
            torch.from_numpy(logits), torch.from_numpy(window), 1 / 0.7, 1.3
        )
        np.testing.assert_array_equal(got_scaled.numpy(), want_scaled)
        # top_k = 1 makes the draw deterministic: the penalized argmax
        sp = ts.SamplerParams(top_k=1, top_p=1.0, temp=0.7, repeat_penalty=1.3)
        want = js.sample_logits_host(logits, window, js.SamplerParams(**vars(sp)),
                                     np.random.default_rng(trial))
        got = int(ts.sample_token(torch.from_numpy(logits), torch.from_numpy(window),
                                  torch.Generator().manual_seed(trial), sp))
        assert got == want
        assert ts.sample_logits_host(logits, window, sp, np.random.default_rng(trial)) == want


def test_session_round_trip(port_model):
    cfg, params, _ = port_model
    sp = ts.SamplerParams(temp=0.8, top_k=40, top_p=0.95)
    eng = te.Engine(cfg, params, te.EngineConfig(n_ctx=N_CTX, decode_block=4), device="cpu")
    eng.generate(PROMPT, 6, sp, ignore_eos=True)
    state = eng.save_session()
    eng.set_seed(11)
    first = eng.generate([7, 8], 6, sp, ignore_eos=True)
    k_after = eng.cache.k.clone()
    # the snapshot did not move with the live (in-place) cache
    assert not torch.equal(state.k, eng.cache.k)
    eng.restore_session(state)
    eng.set_seed(11)
    second = eng.generate([7, 8], 6, sp, ignore_eos=True)
    assert first == second
    assert torch.equal(eng.cache.k, k_after)
