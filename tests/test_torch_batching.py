"""The port's continuous-batching engine (`runtime/batching.py`) on the tiny
model on the CPU: its greedy streams against the JAX package's
`BatchedEngine` and against the port's own single-stream `Engine` (bf16 and
int8 caches), slot reuse, mixed budgets, prefix caching, per-request seeded
sampling, the batched sampler's distributions against JAX, and prompt-lookup
speculation (`lookup_gamma`) against the single-stream greedy streams."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llamavk_tpu.models import loader as jl
from llamavk_tpu.runtime import batching as jb
from llamavk_tpu.runtime import sampling as js
from llamavk_tpu_torch.models import llama as tm
from llamavk_tpu_torch.models import loader as tl
from llamavk_tpu_torch.runtime import sampling as ts
from llamavk_tpu_torch.runtime.batching import BatchConfig, BatchedEngine
from llamavk_tpu_torch.runtime.engine import Engine, EngineConfig

torch.set_num_threads(2)

GREEDY = ts.SamplerParams(temp=0.0)
N_CTX = 64
# three requests of different lengths and budgets on two slots: the third
# waits for a slot and reuses it. Each prompt's greedy stream keeps every
# top-2 logit gap above 0.15 for its budget on the seed-0 tiny model.
PROMPTS = [[10, 177, 191], [30, 145], [60, 51, 246, 212, 166]]
BUDGETS = [6, 4, 5]
# the port's logits sit within two bf16 ulps (0.032) of the JAX package's on
# the tiny model (tests/test_torch_model.py): greedy streams can only be
# compared where every top-2 gap is well above that
LOGIT_TOL = 0.032


@pytest.fixture(scope="module")
def tiny_path(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("tiny") / "tiny-q4.bin")
    jl.random_tiny_model(write_path=path, quantize=True)
    return path


@pytest.fixture(scope="module")
def model(tiny_path):
    cfg, params, _ = tl.load_model(tiny_path, device="cpu")
    return cfg, params


def _single(cfg, params, prompt, n, kv_dtype="bfloat16"):
    eng = Engine(cfg, params, EngineConfig(n_ctx=N_CTX, kv_dtype=kv_dtype), device="cpu")
    return eng.generate(prompt, n, GREEDY, ignore_eos=True)


def _batched(cfg, params, prompts, budgets, max_batch=2, **kw):
    be = BatchedEngine(cfg, params, BatchConfig(max_batch=max_batch, n_ctx=N_CTX, block=4, **kw),
                       device="cpu")
    reqs = [be.submit(p, n, GREEDY, ignore_eos=True) for p, n in zip(prompts, budgets)]
    done = be.run()
    assert {id(r) for r in done} == {id(r) for r in reqs}
    return be, [r.generated for r in reqs]


def test_batched_matches_jax(tiny_path, model):
    cfg, params = model
    # near-tie guard: replay each stream alone and check every top-2 gap
    _, got = _batched(cfg, params, PROMPTS, BUDGETS)
    for prompt, stream in zip(PROMPTS, got):
        cache = tm.init_kv_cache(cfg, 1, N_CTX, device="cpu")
        logits, _, _ = tm.llama_forward(params, torch.tensor([prompt]), cache, 0, cfg)
        for i, tok in enumerate(stream):
            top2 = torch.topk(logits[0, -1], 2).values
            assert float(top2[0] - top2[1]) > 4 * LOGIT_TOL, f"near-tie at step {i}"
            assert int(logits[0, -1].argmax()) == tok
            logits, _, _ = tm.llama_forward(params, torch.tensor([[tok]]), cache,
                                            len(prompt) + i, cfg)
    jcfg, jparams, _ = jl.load_model(tiny_path)
    jbe = jb.BatchedEngine(jcfg, jparams, jb.BatchConfig(max_batch=2, n_ctx=N_CTX, block=4))
    jreqs = [jbe.submit(p, n, js.SamplerParams(temp=0.0), ignore_eos=True)
             for p, n in zip(PROMPTS, BUDGETS)]
    jbe.run()
    assert got == [r.generated for r in jreqs]


@pytest.mark.parametrize("kv_dtype", ["bfloat16", "int8"])
def test_batched_matches_single(model, kv_dtype):
    cfg, params = model
    prompts = PROMPTS + [[42]]
    be, got = _batched(cfg, params, prompts, [6] * 4, max_batch=4, kv_dtype=kv_dtype)
    assert be.cache.k.dtype == (torch.int8 if kv_dtype == "int8" else torch.bfloat16)
    for p, stream in zip(prompts, got):
        assert stream == _single(cfg, params, p, 6, kv_dtype)


def test_more_requests_than_slots(model):
    cfg, params = model
    prompts = [[i + 1, i + 2] for i in range(5)]
    be, got = _batched(cfg, params, prompts, [4] * 5)
    assert be.stats["prefills"] == 5 and be.stats["tokens"] == 5 * 3
    for p, stream in zip(prompts, got):
        assert stream == _single(cfg, params, p, 4)


def test_mixed_lengths_and_budgets(model):
    cfg, params = model
    _, got = _batched(cfg, params, [[5, 6], [9, 8, 7]], [2, 7], max_batch=3)
    assert [len(s) for s in got] == [2, 7]
    assert got == [_single(cfg, params, [5, 6], 2), _single(cfg, params, [9, 8, 7], 7)]


def test_prefix_caching_matches_full_prompt(model):
    """register_prefix + suffix submit equals submitting prefix + suffix."""
    cfg, params = model
    prefix = [5, 9, 2, 30, 7]
    suffixes = [[3, 1], [4, 4, 4], [8]]
    _, plain = _batched(cfg, params, [prefix + s for s in suffixes], [6] * 3, max_batch=3)
    be = BatchedEngine(cfg, params, BatchConfig(max_batch=3, n_ctx=N_CTX, block=4), device="cpu")
    pid = be.register_prefix(prefix)
    reqs = [be.submit(s, 6, GREEDY, ignore_eos=True, prefix=pid) for s in suffixes]
    be.run()
    assert be.stats["prefills"] == len(suffixes)  # the prefix was evaluated once
    assert [r.generated for r in reqs] == plain


def test_sampled_stream_independent_of_slot(model):
    """A seeded sampled request gives the same stream alone in slot 0 and
    in slot 2 of a batch with greedy and sampled neighbours."""
    cfg, params = model
    sp = ts.SamplerParams(temp=0.9, top_k=40, top_p=0.95, repeat_penalty=1.1)
    alone = BatchedEngine(cfg, params, BatchConfig(max_batch=1, n_ctx=N_CTX, block=4),
                          device="cpu")
    a = alone.submit([3, 4, 5], 10, sp, seed=7, ignore_eos=True)
    alone.run()
    crowd = BatchedEngine(cfg, params, BatchConfig(max_batch=3, n_ctx=N_CTX, block=2),
                          device="cpu")
    crowd.submit([9, 9], 3, GREEDY, ignore_eos=True)
    crowd.submit([1, 2, 3, 4, 5], 12, sp, seed=11, ignore_eos=True)
    b = crowd.submit([3, 4, 5], 10, sp, seed=7, ignore_eos=True)
    crowd.run()
    assert a.slot == 0 and b.slot == 2
    assert a.generated == b.generated
    assert len(set(a.generated)) > 1  # it samples
    other = BatchedEngine(cfg, params, BatchConfig(max_batch=1, n_ctx=N_CTX, block=4),
                          device="cpu")
    c = other.submit([3, 4, 5], 10, sp, seed=8, ignore_eos=True)
    other.run()
    assert c.generated != a.generated  # another seed, another stream


def test_probs_batched_dyn_matches_jax():
    """The full-vocab distributions over [B, V] logits with per-row
    parameters (a greedy row among them) and repeat-penalty windows, within
    1e-6: f32 softmax and renormalization of the same values on both sides.
    The windows hold no token 0, where the JAX scatter of its -1 padding
    lands."""
    rng = np.random.default_rng(4)
    b, v, w, top_k = 4, 256, 8, 40
    logits = (rng.standard_normal((b, v)) * 3).astype(np.float32)
    last = rng.integers(1, v, (b, w))
    last[:, :2] = -1
    last[:, -1] = logits.argmax(-1)  # the penalty can move the argmax
    top_p = np.asarray([0.95, 0.5, 1.0, 0.9], np.float32)
    temp = np.asarray([0.8, 1.3, 0.0, 0.5], np.float32)
    pen = np.asarray([1.1, 1.3, 1.0, 1.2], np.float32)
    want = np.asarray(js.probs_batched_dyn(
        jnp.asarray(logits), jnp.asarray(last, jnp.int32), top_k, jnp.asarray(top_p),
        jnp.asarray(temp), jnp.asarray(pen)))
    args = [torch.from_numpy(a) for a in (logits, last)]
    got = ts.probs_batched_dyn(*args, top_k, *(torch.from_numpy(a) for a in (top_p, temp, pen)))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    one = ts.probs_from_logits_dyn(args[0][1], args[1][1], top_k, top_p[1], temp[1], pen[1])
    torch.testing.assert_close(one, got[1], rtol=0, atol=0)
    # the sampler draws inside each row's kept set; the greedy row takes the
    # argmax of its raw logits, not of the penalized ones
    noise = torch.empty((b, top_k)).exponential_(generator=torch.Generator().manual_seed(0))
    toks = ts.sample_tokens_batched(*args, noise, top_k,
                                    *(torch.from_numpy(a) for a in (top_p, temp, pen)))
    assert all(got[r, t] > 0 for r, t in enumerate(toks.tolist()))
    assert int(toks[2]) == int(logits[2].argmax())
    assert ts.sample_token_dyn(args[0][1], args[1][1], noise[1], top_k, top_p[1], temp[1],
                               pen[1]) == toks[1]


# --- prompt-lookup speculation (tests/test_batching.py:112-185) ----------------


def test_lookup_batched_matches_single(model):
    """lookup_gamma: repetitive and generic prompts across admission waves
    (4 requests on 2 slots) emit exactly the single-stream greedy streams;
    the first tokens come from admission, so decode emits 4 * 8 - 4."""
    cfg, params = model
    prompts = [[5, 9, 2, 30, 5, 9, 2, 30, 5, 9], [7, 3, 11], [1, 2, 3, 4, 1, 2, 3, 4], [42]]
    be = BatchedEngine(cfg, params, BatchConfig(max_batch=2, n_ctx=128, block=4, lookup_gamma=4),
                       device="cpu")
    reqs = [be.submit(p, 8, GREEDY, ignore_eos=True) for p in prompts]
    assert len(be.run()) == 4
    for p, r in zip(prompts, reqs):
        eng = Engine(cfg, params, EngineConfig(n_ctx=128), device="cpu")
        assert r.generated == eng.generate(p, 8, GREEDY, ignore_eos=True), p
    assert be.stats["rounds"] > 0 and be.stats["accepted"] > 0
    assert be.stats["tokens"] == 4 * 8 - 4


def test_lookup_batched_with_prefix_cache(model):
    """Lookup over prefix caching: the history rows hold the prefix too."""
    cfg, params = model
    pfx = [3, 1, 4, 1, 5, 9, 2, 6]
    be = BatchedEngine(cfg, params, BatchConfig(max_batch=2, n_ctx=128, block=4, lookup_gamma=3),
                       device="cpu")
    pid = be.register_prefix(pfx)
    reqs = [be.submit(s, 6, GREEDY, ignore_eos=True, prefix=pid) for s in ([8, 2], [7])]
    assert len(be.run()) == 2
    for r, sfx in zip(reqs, ([8, 2], [7])):
        eng = Engine(cfg, params, EngineConfig(n_ctx=128), device="cpu")
        assert r.generated == eng.generate(pfx + sfx, 6, GREEDY, ignore_eos=True)


def test_lookup_rejects_overflowing_requests(model):
    """A lookup round writes gamma rows: a request needs gamma - 1 rows of
    slack, so one that would fill its slot exactly is refused at submit."""
    cfg, params = model
    be = BatchedEngine(cfg, params, BatchConfig(max_batch=2, n_ctx=64, lookup_gamma=4),
                       device="cpu")
    with pytest.raises(ValueError, match="slack"):
        be.submit([1, 2], 62, GREEDY)
    be.submit([1, 2], 59, GREEDY)  # 2 + 59 + 3 fits


def test_lookup_batched_sampled_mixed(model):
    """The sampled round (any sampled row): greedy rows still emit the plain
    greedy streams (a point-mass target accepts exactly the argmax), sampled
    rows (one with the repeat penalty folded in per verify position) emit
    full budgets of valid ids, and the same engine config repeats."""
    cfg, params = model

    def run():
        be = BatchedEngine(cfg, params, BatchConfig(max_batch=4, n_ctx=128, block=4,
                                                    lookup_gamma=3), device="cpu")
        reqs = [be.submit([5, 9, 2, 30, 5, 9, 2, 30], 8, GREEDY, ignore_eos=True),
                be.submit([7, 3, 11], 8, ts.SamplerParams(temp=0.8, repeat_penalty=1.1), seed=3,
                          ignore_eos=True),
                be.submit([1, 2, 3, 4, 1, 2, 3, 4], 8, GREEDY, ignore_eos=True),
                be.submit([42, 17], 8, ts.SamplerParams(temp=1.0), seed=9, ignore_eos=True)]
        be.run()
        return [r.generated for r in reqs]

    first = run()
    assert run() == first
    for i in (0, 2):
        prompt = [[5, 9, 2, 30, 5, 9, 2, 30], None, [1, 2, 3, 4, 1, 2, 3, 4]][i]
        eng = Engine(cfg, params, EngineConfig(n_ctx=128), device="cpu")
        assert first[i] == eng.generate(prompt, 8, GREEDY, ignore_eos=True)
    for i in (1, 3):
        assert len(first[i]) == 8 and all(0 <= t < cfg.n_vocab for t in first[i])
