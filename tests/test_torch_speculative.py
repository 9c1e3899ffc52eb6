"""The port's speculative decoding (`runtime/speculative.py`) against the JAX
package's on the CPU: the prompt-lookup matcher and the round assembly on
seeded contexts, `LookupEngine` greedy streams against the JAX
`LookupEngine` and the port's plain greedy stream (with the round and
acceptance counts a NumPy twin predicts), `SpeculativeEngine` with an
unrelated draft, a self draft and gamma = 1, and the two rejection-sampling
schemes run on the port's own functions with a fixed `torch.Generator`
(their first emitted token distributed as the target's)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llamavk_tpu.models import loader as jl
from llamavk_tpu.runtime import speculative as jsp
from llamavk_tpu_torch.models import llama as tm
from llamavk_tpu_torch.models import loader as tl
from llamavk_tpu_torch.runtime import speculative as tsp
from llamavk_tpu_torch.runtime.engine import Engine, EngineConfig
from llamavk_tpu_torch.runtime.sampling import SamplerParams

torch.set_num_threads(2)

GREEDY = SamplerParams(temp=0.0)
# a repetitive prompt gives the 2-gram matcher something to find; on the
# seed-0 tiny model its 20-token greedy stream keeps every top-2 logit gap
# above 0.26, and 12 drafts are accepted in 9 rounds
LOOKUP_PROMPT = [155, 60, 233, 155, 60, 233, 155, 60, 233]
# the port's logits sit within two bf16 ulps (0.032) of the JAX package's on
# the tiny model (tests/test_torch_model.py): streams of the two packages
# are compared only where every top-2 gap is well above that
LOGIT_TOL = 0.032


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """(target path, port target, port draft): the seed-0 tiny model and an
    unrelated draft (other weights, one layer, a narrower FFN), as
    tests/test_speculative.py:14-24 makes them."""
    d = tmp_path_factory.mktemp("m")
    tpath, dpath = str(d / "target.bin"), str(d / "draft.bin")
    jl.random_tiny_model(write_path=tpath, quantize=True, seed=0)
    jl.random_tiny_model(write_path=dpath, quantize=True, seed=7, n_layer=1, n_ff=128)
    cfg_t, params_t, _ = tl.load_model(tpath, device="cpu")
    cfg_d, params_d, _ = tl.load_model(dpath, device="cpu")
    return tpath, (cfg_t, params_t), (cfg_d, params_d)


def _plain(model, prompt, n, n_ctx=128):
    cfg, params = model
    return Engine(cfg, params, EngineConfig(n_ctx=n_ctx), device="cpu").generate(
        prompt, n, GREEDY, ignore_eos=True)


# --- the pure functions -------------------------------------------------------


@pytest.mark.parametrize("gamma", [1, 3, 4])
def test_lookup_draft_batched_matches_jax(gamma):
    """Seeded contexts over a 6-token alphabet (many 2-gram repeats), ragged
    n_past, and one row whose pending 2-gram never occurred (the -1 draft):
    seq, draft and p equal the JAX function's."""
    rng = np.random.default_rng(gamma)
    b, s = 5, 40
    ctx = rng.integers(0, 6, (b, s))
    n_past = np.array([3, 17, 25, 39 - gamma, 12])
    toks = rng.integers(0, 6, b)
    ctx[4, :12] = np.arange(12) + 10  # no repeats: row 4 cannot match
    toks[4] = 50
    want = jsp.lookup_draft_batched(jnp.asarray(ctx, jnp.int32), jnp.asarray(toks, jnp.int32),
                                    jnp.asarray(n_past, jnp.int32), gamma)
    got = tsp.lookup_draft_batched(torch.from_numpy(ctx), torch.from_numpy(toks),
                                   torch.from_numpy(n_past).to(torch.int32), gamma)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert int(got[2][4]) == -1 and (got[1][4] == -1).all()
    if gamma > 1:
        assert (got[2] >= 0).sum() >= 2  # the alphabet makes matches


def test_first_reject_and_assemble_match_jax():
    rng = np.random.default_rng(5)
    for gamma in (1, 2, 4):
        acc = rng.random((6, gamma - 1)) < 0.6
        acc[0] = True  # every draft accepted: k = gamma - 1, the bonus token
        draft = rng.integers(-1, 50, (6, gamma - 1))
        corr = rng.integers(0, 50, 6)
        k = tsp.first_reject(torch.from_numpy(acc))
        np.testing.assert_array_equal(k.numpy(), np.asarray(jsp.first_reject(jnp.asarray(acc))))
        assert int(k[0]) == gamma - 1
        em, cnt = tsp.assemble_emitted(k, torch.from_numpy(draft), torch.from_numpy(corr), gamma)
        jem, jcnt = jsp.assemble_emitted(jnp.asarray(k.numpy()), jnp.asarray(draft, jnp.int32),
                                         jnp.asarray(corr, jnp.int32), gamma)
        np.testing.assert_array_equal(em.numpy(), np.asarray(jem))
        np.testing.assert_array_equal(cnt.numpy(), np.asarray(jcnt))


# --- LookupEngine ---------------------------------------------------------------


def _lookup_twin(prompt, plain_out, gamma, rounds_per_block, n_predict):
    """The round and acceptance counts of LookupEngine (a NumPy twin,
    tests/test_speculative.py:120-156): greedy equivalence makes every
    on-path verify output the plain greedy stream's. `plain_out` runs gamma
    tokens past n_predict: the last round's count looks that far."""
    seq = list(prompt) + list(plain_out)
    n_past, n_out = len(prompt), 1
    rounds = accepted = 0
    while n_out < n_predict:
        for _ in range(rounds_per_block):
            tok, prev = seq[n_past], seq[n_past - 1]
            p = max((q for q in range(1, n_past - gamma + 1)
                     if seq[q] == tok and seq[q - 1] == prev), default=-1)
            draft = seq[p + 1 : p + gamma] if p >= 0 else [-1] * (gamma - 1)
            k = next((j for j in range(gamma - 1) if draft[j] != seq[n_past + j + 1]), gamma - 1)
            rounds += 1
            accepted += k
            n_out += k + 1
            n_past += k + 1
            if n_out >= n_predict:
                break
    return rounds, accepted


@pytest.fixture(scope="module")
def jax_lookup_stream(models):
    """The JAX LookupEngine's greedy stream on LOOKUP_PROMPT (20 tokens,
    gamma 4, 4 rounds per block), computed once."""
    jcfg, jparams, _ = jl.load_model(models[0])
    eng = jsp.LookupEngine(jcfg, jparams, jsp.SpecConfig(n_ctx=128, gamma=4, rounds_per_block=4))
    return eng.generate(LOOKUP_PROMPT, 20, ignore_eos=True), dict(eng.stats)


def test_lookup_engine_matches_jax_and_plain(models, jax_lookup_stream):
    cfg, params = models[1]
    eng = tsp.LookupEngine(cfg, params, tsp.SpecConfig(n_ctx=128, gamma=4, rounds_per_block=4),
                           device="cpu")
    got = eng.generate(LOOKUP_PROMPT, 20, ignore_eos=True)
    want = _plain(models[1], LOOKUP_PROMPT, 24)
    assert got == want[:20]
    # near-tie guard before holding the stream against the JAX package's
    cache = tm.init_kv_cache(cfg, 1, 128, device="cpu")
    logits = tm.llama_forward(params, torch.tensor([LOOKUP_PROMPT]), cache, 0, cfg)[0]
    for i, tok in enumerate(got[:-1]):
        top2 = torch.topk(logits[0, -1], 2).values
        assert float(top2[0] - top2[1]) > 4 * LOGIT_TOL, f"near-tie at step {i}"
        logits = tm.llama_forward(params, torch.tensor([[tok]]), cache,
                                  len(LOOKUP_PROMPT) + i, cfg)[0]
    jgot, jstats = jax_lookup_stream
    assert got == jgot
    assert eng.stats == jstats
    assert (eng.stats["rounds"], eng.stats["accepted"]) == _lookup_twin(LOOKUP_PROMPT, want, 4,
                                                                        4, 20)
    assert eng.stats["accepted"] > 0  # drafts were proposed and taken


@pytest.mark.parametrize("prompt,gamma,n", [([7, 3, 11], 3, 16), ([4, 8, 15], 1, 8)])
def test_lookup_engine_generic_prompt_and_gamma_one(models, prompt, gamma, n):
    """A prompt without repeats, and gamma = 1 (no drafts: plain decode):
    the plain greedy stream and the twin's counts
    (tests/test_speculative.py:180-207)."""
    cfg, params = models[1]
    eng = tsp.LookupEngine(cfg, params, tsp.SpecConfig(n_ctx=128, gamma=gamma,
                                                       rounds_per_block=4), device="cpu")
    want = _plain(models[1], prompt, n + gamma)
    assert eng.generate(prompt, n, ignore_eos=True) == want[:n]
    assert (eng.stats["rounds"], eng.stats["accepted"]) == _lookup_twin(prompt, want, gamma, 4, n)


def test_lookup_engine_headroom(models):
    cfg, params = models[1]
    eng = tsp.LookupEngine(cfg, params, tsp.SpecConfig(n_ctx=64, gamma=4, rounds_per_block=4),
                           device="cpu")
    with pytest.raises(ValueError, match="headroom"):
        eng.generate([1, 2, 3], 41)  # 3 + 41 + 4*4 + 4 + 1 > 64


def test_lookup_sampled_is_seeded(models):
    """Sampled lookup rounds: seeded runs repeat, another seed gives another
    stream, every id is in the vocabulary (tests/test_speculative.py:229)."""
    cfg, params = models[1]
    sp = SamplerParams(temp=0.9, top_k=40, top_p=0.95, repeat_penalty=1.0)
    eng = tsp.LookupEngine(cfg, params, tsp.SpecConfig(n_ctx=128, gamma=3, rounds_per_block=4),
                           device="cpu")
    prompt = LOOKUP_PROMPT[:8]
    out1 = eng.generate(prompt, 12, ignore_eos=True, sp=sp, seed=7)
    assert out1 == eng.generate(prompt, 12, ignore_eos=True, sp=sp, seed=7)
    assert len(out1) == 12 and all(0 <= t < cfg.n_vocab for t in out1)
    assert eng.generate(prompt, 12, ignore_eos=True, sp=sp, seed=8) != out1
    with pytest.raises(AssertionError):
        eng.generate(prompt, 4, sp=SamplerParams(temp=0.9, repeat_penalty=1.1))


# --- SpeculativeEngine ------------------------------------------------------------


def test_spec_unrelated_draft_equals_target_greedy(models):
    spec = tsp.SpeculativeEngine(*models[1], *models[2],
                                 tsp.SpecConfig(n_ctx=64, gamma=3, rounds_per_block=4),
                                 device="cpu")
    assert spec.generate([5, 9, 2, 30], 12, ignore_eos=True) == _plain(models[1], [5, 9, 2, 30],
                                                                        12, 64)
    assert spec.stats["rounds"] > 0


def test_spec_self_draft_accepts_everything(models):
    spec = tsp.SpeculativeEngine(*models[1], *models[1],
                                 tsp.SpecConfig(n_ctx=64, gamma=4, rounds_per_block=2),
                                 device="cpu")
    assert spec.generate([7, 3, 11], 10, ignore_eos=True) == _plain(models[1], [7, 3, 11], 10, 64)
    assert spec.acceptance_rate == 1.0


def test_spec_gamma_one_degenerates(models):
    spec = tsp.SpeculativeEngine(*models[1], *models[2],
                                 tsp.SpecConfig(n_ctx=64, gamma=1, rounds_per_block=4),
                                 device="cpu")
    assert spec.generate([4, 8, 15], 8, ignore_eos=True) == _plain(models[1], [4, 8, 15], 8, 64)


def test_spec_sampled_self_draft_high_acceptance(models):
    """Self draft with the same sampler: p_draft == p_target, so (nearly)
    every proposal is accepted; seeded runs repeat (speculative.py:68-84
    of the JAX tests)."""
    sp = SamplerParams(temp=0.8, top_k=40, top_p=0.95, repeat_penalty=1.0)
    spec = tsp.SpeculativeEngine(*models[1], *models[1],
                                 tsp.SpecConfig(n_ctx=64, gamma=3, rounds_per_block=3),
                                 device="cpu")
    out1 = spec.generate([5, 9, 2], 10, ignore_eos=True, sp=sp, seed=3)
    assert len(out1) == 10 and spec.acceptance_rate > 0.9
    assert spec.generate([5, 9, 2], 10, ignore_eos=True, sp=sp, seed=3) == out1
    assert spec.generate([5, 9, 2], 10, ignore_eos=True, sp=sp, seed=4) != out1


# --- the rejection schemes, on the port's functions ------------------------------

N_DRAWS = 60_000
V = 12


def _target_and_draft():
    rng = np.random.default_rng(0)
    pt = rng.dirichlet(np.ones(V) * 0.5).astype(np.float32)
    pd = rng.dirichlet(np.ones(V) * 0.5).astype(np.float32)
    return torch.from_numpy(pt), torch.from_numpy(pd)


def test_spec_rejection_scheme_is_unbiased():
    """The draft-model round's first emitted token, with the port's
    first_reject, assemble_emitted and exponential-race draws on N rows at
    once: distributed as p_target within total variation 0.02 (the noise
    floor at 60000 draws is ~0.01)."""
    pt, pd = _target_and_draft()
    gen = torch.Generator().manual_seed(0)
    d = tsp._categorical(pd.expand(N_DRAWS, V), gen)  # the draft's proposals
    u = torch.rand(N_DRAWS, generator=gen)
    acc = (u < torch.clamp(pt[d] / torch.clamp(pd[d], min=1e-30), max=1.0))[:, None]
    k = tsp.first_reject(acc)  # gamma = 2: one draft
    resid = torch.where((k < 1)[:, None], torch.clamp(pt - pd, min=0.0), pt)
    corr = tsp._categorical(resid, gen)
    emitted, count = tsp.assemble_emitted(k, d[:, None], corr, 2)
    emp = torch.bincount(emitted[:, 0], minlength=V).float() / N_DRAWS
    assert float((emp - pt).abs().sum()) < 0.02
    assert set(count.tolist()) <= {1, 2}


def test_lookup_rejection_scheme_is_unbiased():
    """The lookup round's point-mass proposal: accept d with probability
    p_t(d), else draw from p_t with d removed; the first emitted token is
    distributed as p_t (total variation < 0.02)."""
    pt, _ = _target_and_draft()
    gen = torch.Generator().manual_seed(1)
    d = torch.full((N_DRAWS, 1), 3, dtype=torch.int64)
    k = tsp.first_reject(torch.rand((N_DRAWS, 1), generator=gen) < pt[3])
    resid = pt.expand(N_DRAWS, V).clone()
    resid[:, 3] = torch.where(k < 1, 0.0, pt[3])
    emitted, _ = tsp.assemble_emitted(k, d, tsp._categorical(resid, gen), 2)
    emp = torch.bincount(emitted[:, 0], minlength=V).float() / N_DRAWS
    assert float((emp - pt).abs().sum()) < 0.02
