"""The decode step the CUDA graphs capture (`runtime/graphs.py`), run
uncaptured on the CPU: `Engine`'s static step against the JAX package's
`Engine.generate` (bf16, int8 and f32 caches) and against the per-step loop
it replaced (greedy and seeded sampled streams, a history ring across its
wrap, the cache planes bit for bit, exact budgets); the int32 [1] position
against the host int at B = 1; the live cache, buffers and generator kept
by reset, restore_session and set_seed; `BatchedEngine`'s static block
against the loop it replaced (flat, paged and shared-prefix caches, greedy
and sampled slots) and its slot generators reseeded in place; and the
launch tally a capture leaves, added once per replay."""

import collections
import types

import numpy as np
import pytest
import torch

from llamavk_tpu.models import loader as jl
from llamavk_tpu.runtime import engine as je
from llamavk_tpu.runtime import sampling as js
from llamavk_tpu_torch.models import llama as tm
from llamavk_tpu_torch.models import loader as tl
from llamavk_tpu_torch.ops import _build
from llamavk_tpu_torch.ops import flash_attn as fa
from llamavk_tpu_torch.ops import flash_decode as fd
from llamavk_tpu_torch.ops import q4_matmul as q4
from llamavk_tpu_torch.runtime import graphs
from llamavk_tpu_torch.runtime import sampling as ts
from llamavk_tpu_torch.runtime.batching import BatchConfig, BatchedEngine
from llamavk_tpu_torch.runtime.engine import Engine, EngineConfig

torch.set_num_threads(2)

MODEL_SEED = 219
# a prompt whose greedy stream on the seed-219 tiny model keeps every top-2
# gap of its first 9 steps above 4 * LOGIT_TOL and takes 5 tokens, for
# every cache type
PROMPT = [1, 219, 143, 11, 196]
N_CTX = 64  # one KV block of the JAX kernels: the plain softmax's order
GREEDY = ts.SamplerParams(temp=0.0)
SAMPLED = ts.SamplerParams(temp=0.9, top_k=40, top_p=0.95, repeat_penalty=1.1)
# the port's logits sit within two bf16 ulps (0.032) of the JAX package's on
# the tiny model (tests/test_torch_model.py): greedy streams can only be
# compared where every top-2 gap is well above that
LOGIT_TOL = 0.032
KV_TYPES = {"bfloat16": torch.bfloat16, "int8": torch.int8, "float32": torch.float32}


@pytest.fixture(scope="module")
def tiny_path(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("tiny") / "tiny-q4.bin")
    jl.random_tiny_model(seed=MODEL_SEED, write_path=path, quantize=True)
    return path


@pytest.fixture(scope="module")
def model(tiny_path):
    cfg, params, _ = tl.load_model(tiny_path, device="cpu")
    return cfg, params


@pytest.fixture(scope="module")
def jax_model(tiny_path):
    jcfg, jparams, _ = jl.load_model(tiny_path)
    return jcfg, jparams


def _old_decode_block(self, tok, last, sp, n_steps):
    """`Engine._decode_block` as it was before the static step: a host-int
    position per step, a new window and token tensor per step."""
    toks = torch.empty(n_steps, dtype=torch.int64, device=self.device)
    for i in range(n_steps):
        logits, self.cache, _ = self._forward(tok.view(1, 1), self.n_past + i)
        tok = ts.sample_token(logits[0, -1], last, self.generator, sp)
        last = torch.roll(last, -1)
        last[-1] = tok
        toks[i] = tok
    return toks, last


def _engines(model, **ecfg):
    """(an Engine on the static step, one on the old per-step loop)."""
    cfg, params = model
    new = Engine(cfg, params, EngineConfig(**ecfg), device="cpu")
    old = Engine(cfg, params, EngineConfig(**ecfg), device="cpu")
    old._decode_block = types.MethodType(_old_decode_block, old)
    return new, old


def _planes(cache):
    return cache.planes() + ([cache.pos] if cache.ring else [])


def _assert_same_state(new, old):
    assert new.n_past == old.n_past and new.tokens == old.tokens
    for a, b in zip(_planes(new.cache), _planes(old.cache)):
        assert torch.equal(a, b)


# --- (a) Engine against the JAX package's Engine.generate -------------------


@pytest.mark.parametrize("kv", list(KV_TYPES))
def test_engine_matches_jax(model, jax_model, kv):
    """The static step's greedy stream in blocks of 4 (an exact budget of
    9: the prefill's token, then 4 + 4) equals JAX's Engine.generate, at
    n_ctx 64 (one KV block in the JAX kernels)."""
    cfg, params = model
    n = 9
    eng = Engine(cfg, params, EngineConfig(n_ctx=N_CTX, kv_dtype=kv, decode_block=4),
                 device="cpu")
    got = eng.generate(PROMPT, n, GREEDY, ignore_eos=True)
    assert len(got) == n and eng.n_past == len(PROMPT) + n - 1
    # near-tie guard: every step's top-2 gap, on the plain forward
    cache = tm.init_kv_cache(cfg, 1, N_CTX, KV_TYPES[kv], device="cpu")
    logits, _, _ = tm.llama_forward(params, torch.tensor([PROMPT]), cache, 0, cfg)
    for i, tok in enumerate(got):
        top2 = torch.topk(logits[0, -1], 2).values
        assert float(top2[0] - top2[1]) > 4 * LOGIT_TOL, f"near-tie at step {i}"
        assert int(logits[0, -1].argmax()) == tok
        logits, _, _ = tm.llama_forward(params, torch.tensor([[tok]]), cache,
                                        len(PROMPT) + i, cfg)
    jcfg, jparams = jax_model
    jeng = je.Engine(jcfg, jparams, je.EngineConfig(n_ctx=N_CTX, kv_dtype=kv, decode_block=8))
    assert got == jeng.generate(PROMPT, n, js.SamplerParams(temp=0.0), ignore_eos=True)


# --- the position as a device tensor at B = 1 --------------------------------


@pytest.mark.parametrize("kv,ring", [("bfloat16", False), ("int8", False), ("float32", False),
                                     ("bfloat16", True)])
def test_vector_position_matches_int(model, kv, ring):
    """A T = 1 forward at an int32 [1] n_past gives the host int's bits:
    logits and every cache plane (a ring's past its wrap)."""
    cfg, params = model
    s, keep = (16, 4) if ring else (N_CTX, 0)
    caches = [tm.init_kv_cache(cfg, 1, s, KV_TYPES[kv], "cpu", ring=ring) for _ in range(2)]
    toks = np.random.default_rng(3).integers(3, cfg.n_vocab, 24)
    for pos, t in enumerate(toks):
        outs = []
        for cache, n_past in zip(caches, (pos, torch.tensor([pos], dtype=torch.int32))):
            lg, _, _ = tm.llama_forward(params, torch.tensor([[int(t)]]), cache, n_past, cfg,
                                        ring_keep=keep)
            outs.append(lg)
        assert torch.equal(outs[0], outs[1])
    for a, b in zip(_planes(caches[0]), _planes(caches[1])):
        assert torch.equal(a, b)


# --- (b), (c) the static step against the old loop ----------------------------


@pytest.mark.parametrize("kv", list(KV_TYPES))
def test_static_step_matches_old_loop(model, kv):
    """Greedy, then seeded sampled streams over one engine's life (blocks of
    3, budgets not a multiple of the block): the static step equals the old
    per-step loop token for token, the caches bit for bit."""
    new, old = _engines(model, n_ctx=N_CTX, kv_dtype=kv, decode_block=3, seed=5)
    for eng in (new, old):
        eng.set_seed(17)
    calls = [(PROMPT, 7, GREEDY), ([40, 41], 8, SAMPLED),
             ([9], 5, ts.SamplerParams(temp=0.7, repeat_last_n=0))]
    for prompt, n, sp in calls:
        got = new.generate(prompt, n, sp, ignore_eos=True)
        assert len(got) == n
        assert got == old.generate(prompt, n, sp, ignore_eos=True)
        _assert_same_state(new, old)
    assert len(new._decodes) == 3  # one static step per SamplerParams


def test_ring_static_step_matches_old_loop(model):
    """A history ring (n_ctx 32, 4 pinned rows): a greedy run up to just
    before the wrap, then a sampled one across it and past; streams, cache
    planes and the position plane equal to the old loop's, every budget
    exact."""
    new, old = _engines(model, n_ctx=32, decode_block=4, ctx_ring=True, ring_keep=4, seed=9)
    first = new.generate(PROMPT, 20, GREEDY, ignore_eos=True)
    assert first == old.generate(PROMPT, 20, GREEDY, ignore_eos=True)
    _assert_same_state(new, old)
    assert new.n_past == len(PROMPT) + 19 < 32 and int(new.cache.pos.max()) == new.n_past - 1
    second = new.generate([], 27, SAMPLED, ignore_eos=True)
    assert len(second) == 27
    assert second == old.generate([], 27, SAMPLED, ignore_eos=True)
    _assert_same_state(new, old)
    assert new.n_past == len(PROMPT) + 46 > 32  # wrapped
    assert int(new.cache.pos.max()) == new.n_past - 1


# --- (d) the addresses the graphs hold ------------------------------------------


def test_reset_restore_seed_keep_addresses(model):
    """reset, restore_session and set_seed write into the live cache,
    static buffers and generator: every address stays, and the restored
    state decodes as the saved one did."""
    cfg, params = model
    eng = Engine(cfg, params, EngineConfig(n_ctx=N_CTX, kv_dtype="int8", decode_block=4),
                 device="cpu")
    gen = eng.generator
    cache_ptrs = [t.data_ptr() for t in _planes(eng.cache)]
    eng.generate(PROMPT, 6, SAMPLED, ignore_eos=True)
    st = eng._decodes[SAMPLED]
    buf_ptrs = [t.data_ptr() for t in (st.n_past, st.tok, st.last, st.out, st.step)]
    saved = eng.save_session()
    eng.set_seed(11)
    first = eng.generate([7, 8], 6, SAMPLED, ignore_eos=True)
    after = [t.clone() for t in _planes(eng.cache)]
    eng.restore_session(saved)
    eng.set_seed(11)
    assert eng.generate([7, 8], 6, SAMPLED, ignore_eos=True) == first
    assert all(torch.equal(a, b) for a, b in zip(_planes(eng.cache), after))
    eng.reset()
    assert not any(t.any() for t in eng.cache.planes())
    eng.generate(PROMPT, 3, SAMPLED, ignore_eos=True)
    assert eng.generator is gen and eng._decodes[SAMPLED] is st
    assert [t.data_ptr() for t in _planes(eng.cache)] == cache_ptrs
    assert [t.data_ptr() for t in (st.n_past, st.tok, st.last, st.out, st.step)] == buf_ptrs
    bad = tm.init_kv_cache(cfg, 1, N_CTX, torch.bfloat16, "cpu")
    with pytest.raises(ValueError, match="does not fit"):
        eng.restore_session(type(saved)(k=bad.k, v=bad.v, n_past=0, tokens=[]))


def test_ring_reset_empties_positions(model):
    cfg, params = model
    eng = Engine(cfg, params, EngineConfig(n_ctx=32, ctx_ring=True, ring_keep=4), device="cpu")
    pos = eng.cache.pos
    eng.generate(PROMPT, 4, GREEDY, ignore_eos=True)
    eng.reset()
    assert eng.cache.pos is pos and bool((pos == -1).all())


# --- (e) BatchedEngine's static block against the old loop --------------------


def _old_batched_block(self, n_steps):
    """`BatchedEngine._decode_block` as it was before the static step: new
    tensors every step, noise drawn for sampled slots only."""
    st = self._block_inputs()
    cur, last = st.cur, st.last
    b = self.bcfg.max_batch
    slots = list(range(b))
    npast = self._dev(self.n_past, torch.int32)
    kw = {} if self.pager is None else dict(page_table=self._table_dev)
    kw.update(self._pfx_kw())
    toks = torch.empty((b, n_steps), dtype=torch.int64, device=self.device)
    for i in range(n_steps):
        logits, _, _ = self._fwd(cur[:, None], self.cache, npast, **kw)
        cur = self._sample(logits[:, -1, :], last, slots)
        last = torch.cat([last[:, 1:], cur[:, None]], dim=1)
        toks[:, i] = cur
        npast = npast + 1
    return toks, last


BATCHED = {
    "flat": dict(kv_dtype="int8"),
    "paged": dict(paged=True, page_size=8),
    "shared": dict(shared_prefix=True, prefix_pool=2, prefix_ctx=256),
}


@pytest.mark.parametrize("layout", list(BATCHED))
def test_batched_static_block_matches_old_loop(model, layout):
    """Six requests on three slots (slots reused mid-run), greedy and
    seeded sampled mixed, budgets ending mid-block: every stream equals the
    old loop's, and the block's buffers and page table keep their
    addresses."""
    cfg, params = model
    engines = []
    for old in (False, True):
        be = BatchedEngine(cfg, params, BatchConfig(max_batch=3, n_ctx=N_CTX, block=4,
                                                    **BATCHED[layout]), device="cpu")
        if old:
            be._decode_block = types.MethodType(_old_batched_block, be)
        pfx = be.register_prefix([5, 9, 2, 30, 7, 11]) if layout == "shared" else -1
        reqs = [be.submit([3 + i, 17, 4 * i + 1], 5 + 2 * i, SAMPLED if i % 2 else GREEDY,
                          seed=100 + i, ignore_eos=True, prefix=pfx if i % 3 == 0 else -1)
                for i in range(6)]
        engines.append((be, reqs))
    (new, reqs_new), (old, reqs_old) = engines
    new.step()
    st = new._decode
    ptrs = [t.data_ptr() for t in (st.cur, st.last, st.npast, st.out, st.top_p)]
    table = new._table_dev.data_ptr() if layout == "paged" else None
    new.run()
    old.run()
    assert [r.generated for r in reqs_new] == [r.generated for r in reqs_old]
    assert [len(r.generated) for r in reqs_new] == [5 + 2 * i for i in range(6)]
    assert new._decode is st and [t.data_ptr() for t in (st.cur, st.last, st.npast, st.out,
                                                         st.top_p)] == ptrs
    if table is not None:
        assert new._table_dev.data_ptr() == table


def test_slot_generator_reseeded_in_place(model):
    """A slot keeps one generator for the engine's life: admission reseeds
    it in place, and it then draws what a fresh generator with the
    request's seed draws; a greedy request's slot keeps it too."""
    cfg, params = model
    be = BatchedEngine(cfg, params, BatchConfig(max_batch=2, n_ctx=N_CTX, block=4),
                       device="cpu")
    gens = list(be._slot_gens)
    torch.empty(50).exponential_(generator=gens[1])  # a previous occupant's draws
    be._set_slot(1, be.submit([4, 5], 3, SAMPLED, seed=23), [4, 5], 2)
    assert be._slot_gens[1] is gens[1] and be.gens[1] is gens[1]
    want = torch.empty(40).exponential_(generator=torch.Generator().manual_seed(23))
    assert torch.equal(torch.empty(40).exponential_(generator=gens[1]), want)
    be._set_slot(0, be.submit([4], 3, GREEDY, seed=5), [4], 1)
    assert be._slot_gens[0] is gens[0] and be.gens[0] is None


# --- (f) the launch tally of a capture ---------------------------------------------


def test_launch_tally_adds_a_capture_once_per_replay(monkeypatch):
    """A capture's rise in every counter (the wrappers' launches and shapes,
    the libraries' C-side counts) is taken back, then added once per
    replay."""
    for mod, names in ((q4, ("launches", "shapes", "shapes_f32", "shapes_i8", "shapes_modes")),
                       (fa, ("launches", "shapes")), (fd, ("launches", "shapes"))):
        for name in names:
            monkeypatch.setattr(mod, name, type(getattr(mod, name))(getattr(mod, name)))
    monkeypatch.setattr(_build, "replayed", collections.Counter())
    c_side = collections.Counter({"q4_matmul": 1000, "flash_attn": 40})  # the C counters
    monkeypatch.setattr(graphs, "_library_counts", lambda: {
        name: n + _build.replayed[name] for name, n in c_side.items()})

    before = graphs.launch_counts()
    # what a capture of one step on a 2-layer model counts: 9 K1 calls,
    # 2 split-route updates, their shapes and C-side launches
    q4.launches["gemv"] += 9
    q4.shapes[(1, 128, 384)] += 2
    fa.launches["update_split"] += 2
    fa.shapes[("update", 1, 1, 2, 64, 64, 64, "bf16", None, None, False, None)] += 2
    c_side.update(q4_matmul=9, flash_attn=2)
    after = graphs.launch_counts()
    tally = graphs.LaunchTally(before, after)
    assert tally.delta[-1] == {"q4_matmul": 9, "flash_attn": 2}
    tally.add(-1)  # nothing ran
    assert graphs.launch_counts() == before
    for _ in range(5):  # five replays
        tally.add()
    assert q4.launches["gemv"] == before[0]["gemv"] + 45
    assert q4.shapes[(1, 128, 384)] == before[1].get((1, 128, 384), 0) + 10
    assert fa.launches["update_split"] == before[5]["update_split"] + 10
    assert graphs.launch_counts()[-1] == {"q4_matmul": 1045, "flash_attn": 50}
    assert graphs.launch_counts()[7] == before[7]  # K4 never counted
