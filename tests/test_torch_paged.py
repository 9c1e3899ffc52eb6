"""The port's paged KV against the JAX package's, on the CPU: the page
allocator and slot tables (`runtime/paged.py`, the same operation sequences
on the port's copy and on the JAX module), paged `llama_forward` through a
scrambled table (bf16 and int8), and the paged engine: greedy streams equal
to the JAX paged engine's and to the port's flat engine at kv_block =
page_size, prefix pages shared by refcount, preemption under a small pool,
page reuse across waves, every page returned at the end, the paged
server's statistics, and prompt-lookup speculation on the paged engine
(its verify writes crossing pages) against the flat lookup engine."""

import json
import threading
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llamavk_tpu.models import llama as jm
from llamavk_tpu.models import loader as jl
from llamavk_tpu.runtime import batching as jb
from llamavk_tpu.runtime import paged as jp
from llamavk_tpu.runtime import sampling as js
from llamavk_tpu_torch.models import llama as tm
from llamavk_tpu_torch.models import loader as tl
from llamavk_tpu_torch.runtime import paged as tp
from llamavk_tpu_torch.runtime.batching import BatchConfig, BatchedEngine
from llamavk_tpu_torch.runtime.sampling import SamplerParams
from llamavk_tpu_torch.runtime.server import LlamaServer

torch.set_num_threads(2)

GREEDY = SamplerParams(temp=0.0)
SAMPLED = SamplerParams(temp=1.1, top_k=20, top_p=0.9)
N_CTX = 64
# the greedy prompts of tests/test_torch_batching.py plus [42]: every top-2
# logit gap of their streams stays far above the two-ulp logit tolerance
# between the two packages on the seed-0 tiny model
PROMPTS = [[10, 177, 191], [30, 145], [60, 51, 246, 212, 166], [42]]
# both packages keep bf16 activations and sum in f32 in other orders: the
# logits may sit two bf16 ulps apart (tests/test_torch_model.py), and cached
# rows, or int8 rows dequantized, as much
TOL = dict(rtol=0, atol=0.032)
MODULES = pytest.mark.parametrize("mod", [tp, jp], ids=["port", "jax"])


# --- the allocator: tests/test_paged.py:19-75 on both modules ---------------


@MODULES
def test_allocator_alloc_release(mod):
    a = mod.PageAllocator(4)
    p = a.alloc(3)
    assert len(set(p)) == 3 and a.n_free == 1
    a.release(p[:2])
    assert a.n_free == 3
    with pytest.raises(MemoryError):
        a.alloc(4)
    a.release(p[2:])
    assert a.n_free == 4


@MODULES
def test_allocator_refcount_sharing(mod):
    a = mod.PageAllocator(4)
    shared = a.alloc(2)
    a.retain(shared)  # a second user
    a.release(shared)
    assert a.n_free == 2  # still held by the first
    a.release(shared)
    assert a.n_free == 4


@MODULES
def test_slot_pages_ensure_and_free(mod):
    a = mod.PageAllocator(8)
    sp = mod.SlotPages(max_batch=2, max_pages_per_slot=4, allocator=a)
    sp.ensure(0, 100, page_size=64)  # 2 pages
    assert sp.n_mapped[0] == 2 and a.n_free == 6
    sp.ensure(0, 120, page_size=64)  # still 2
    assert sp.n_mapped[0] == 2 and a.n_free == 6
    sp.ensure(0, 129, page_size=64)  # 3
    assert sp.n_mapped[0] == 3 and a.n_free == 5
    sp.ensure(1, 64, page_size=64)
    assert a.n_free == 4
    assert sp.table.tolist() == [[0, 1, 2, 0], [3, 0, 0, 0]]
    sp.free_slot(0)
    assert a.n_free == 7 and sp.n_mapped[0] == 0 and sp.dirty


@MODULES
def test_slot_pages_share_prefix(mod):
    a = mod.PageAllocator(8)
    sp = mod.SlotPages(max_batch=2, max_pages_per_slot=4, allocator=a)
    pfx = a.alloc(2)  # a registered prefix owns 2 full pages
    sp.share(0, pfx)
    sp.ensure(0, 3 * 64, page_size=64)  # one more page for the suffix
    assert list(sp.table[0, :3]) == pfx + sp.owned[0][2:]
    assert a.n_free == 5 and a.refs[pfx].tolist() == [2, 2]
    sp.free_slot(0)  # returns the suffix page; the prefix pages stay retained
    assert a.n_free == 6
    a.release(pfx)
    assert a.n_free == 8


@MODULES
def test_slot_pages_exhaustion(mod):
    a = mod.PageAllocator(2)
    sp = mod.SlotPages(max_batch=2, max_pages_per_slot=4, allocator=a)
    sp.ensure(0, 128, page_size=64)
    with pytest.raises(MemoryError):
        sp.ensure(1, 64, page_size=64)
    with pytest.raises(MemoryError):  # wider than the table
        sp.ensure(1, 5 * 64, page_size=64)


# --- the model -----------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("tiny") / "tiny-q4.bin")
    jl.random_tiny_model(write_path=path, quantize=True)
    jcfg, jparams, _ = jl.load_model(path)
    cfg, params, tok = tl.load_model(path, device="cpu")
    return path, (jcfg, jparams), (cfg, params, tok)


def pool_from_jax(jpool, n_head: int) -> tm.KVCache:
    """The port's pool with a JAX pool's bytes: the data planes as they are,
    an int8 pool's scale pools [L, NP, PS, Hpad] cut to their first H lanes
    (the JAX package pads them to 128 lanes, the port does not)."""
    def plane(a, cut):
        a = np.asarray(a.astype(jnp.float32) if a.dtype == jnp.bfloat16 else a)
        t = torch.from_numpy(np.array(a[..., :n_head] if cut else a))
        return t.to(torch.bfloat16) if jpool.k.dtype == jnp.bfloat16 and not cut else t
    planes = [plane(jpool.k, False), plane(jpool.v, False)]
    if jpool.quantized:
        planes += [plane(jpool.k_scale, True), plane(jpool.v_scale, True)]
    return tm.KVCache(*planes)


def dequant(pool: tm.KVCache) -> list[np.ndarray]:
    """f32 [L, NP, H, PS, D] values of a pool's K and V planes."""
    if not pool.quantized:
        return [pool.k.float().numpy(), pool.v.float().numpy()]
    return [p.float().numpy() * s.numpy().transpose(0, 1, 3, 2)[..., None]
            for p, s in ((pool.k, pool.k_scale), (pool.v, pool.v_scale))]


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
def test_paged_forward_matches_jax(tiny, quant):
    """llama_forward through a scrambled table (tests/test_paged.py:85-126,
    :232-275): a prefill that fills each row's first page exactly, then
    decode steps with per-row positions into the second page. Logits within
    two bf16 ulps and equal argmax, the pools equal within as much (int8
    dequantized), every page off the table still zero."""
    _, (jcfg, jparams), (cfg, params, _) = tiny
    rng = np.random.default_rng(5 + quant)
    b, ps, maxlb = 2, (32 if quant else 8), 2
    jdtype, dtype = (jnp.int8, torch.int8) if quant else (jnp.bfloat16, torch.bfloat16)
    n_pages = b * maxlb + 3
    jpool = jm.init_paged_kv_cache(jcfg, n_pages, ps, dtype=jdtype)
    pool = tm.init_paged_kv_cache(cfg, n_pages, ps, dtype, device="cpu")
    assert pool.k.shape == (cfg.n_layer, n_pages, cfg.n_head, ps, cfg.head_dim)
    if quant:
        assert pool.k_scale.shape == (cfg.n_layer, n_pages, ps, cfg.n_head)
    table = rng.permutation(n_pages)[: b * maxlb].reshape(b, maxlb).astype(np.int32)
    fwd = jax.jit(jm.llama_forward, static_argnames=("cfg", "kv_block"))
    toks, n_past = rng.integers(0, cfg.n_vocab, (b, ps)), np.zeros(b, np.int32)
    for _ in range(4):
        want, jpool, _ = fwd(jparams, jnp.asarray(toks, jnp.int32), jpool, jnp.asarray(n_past),
                             jcfg, kv_block=ps, page_table=jnp.asarray(table))
        got, _, _ = tm.llama_forward(params, torch.from_numpy(toks), pool,
                                     torch.from_numpy(n_past), cfg, kv_block=ps,
                                     page_table=torch.from_numpy(table))
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, **TOL)
        assert (got[:, -1].argmax(-1).numpy() == want[:, -1].argmax(-1)).all()
        n_past = n_past + toks.shape[1]
        toks = want[:, -1].argmax(-1)[:, None]  # the JAX stream's tokens
    for g, w in zip(dequant(pool), dequant(pool_from_jax(jpool, cfg.n_head))):
        np.testing.assert_allclose(g, w, **TOL)
    off_table = sorted(set(range(n_pages)) - set(table.ravel().tolist()))
    assert not any(p[:, off_table].any() for p in pool.planes())


def test_paged_forward_refuses_off_path(tiny):
    """Paged KV takes only the fused routes (llama.py:553-557 there), and a
    write that crosses a page needs page_straddle (llama.py:603-626 there),
    which then lands it row by row as the flat cache does."""
    _, _, (cfg, params, _) = tiny
    pool = tm.init_paged_kv_cache(cfg, 5, 8, device="cpu")
    table = torch.tensor([[1, 2, 3, 4]], dtype=torch.int32)
    with pytest.raises(ValueError, match="fused"):  # 300 % 256 != 0: the read route
        tm.llama_forward(params, torch.zeros((1, 300), dtype=torch.int64), pool, 0, cfg,
                         page_table=table)
    toks = torch.tensor([[5, 9, 2, 30]])
    with pytest.raises(ValueError, match="cross a page"):
        tm.llama_forward(params, toks, pool, 6, cfg, page_table=table)
    flat = tm.init_kv_cache(cfg, 1, 32, device="cpu")
    want = tm.llama_forward(params, toks, flat, 6, cfg, logits_all=True, kv_block=8)[0]
    got = tm.llama_forward(params, toks, pool, 6, cfg, logits_all=True, page_table=table,
                           page_straddle=True)[0]
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    for plane, fplane in zip(pool.planes(), flat.planes()):  # rows 6, 7 | 8, 9
        torch.testing.assert_close(plane[:, 1, :, 6:], fplane[:, 0, :, 6:8], rtol=0, atol=0)
        torch.testing.assert_close(plane[:, 2, :, :2], fplane[:, 0, :, 8:10], rtol=0, atol=0)


# --- the engine ----------------------------------------------------------------


def _streams(model, subs, max_batch=4, **kw):
    """(engine, streams) of the port's engine on `subs`, [(prompt, n, sp,
    seed)], run to the end."""
    cfg, params, _ = model
    be = BatchedEngine(cfg, params, BatchConfig(max_batch=max_batch, n_ctx=N_CTX, block=4, **kw),
                       device="cpu")
    reqs = [be.submit(p, n, sp, seed=seed, ignore_eos=True) for p, n, sp, seed in subs]
    done = be.run()
    assert {id(r) for r in done} == {id(r) for r in reqs}
    return be, [r.generated for r in reqs]


def _all_pages_back(be) -> bool:
    """Every page free but the trash page."""
    return be.pager.alloc.n_free == be.pager.alloc.n_pages - 1


def test_paged_engine_matches_jax(tiny):
    """Greedy streams of the port's paged engine equal the JAX paged
    engine's (page_size 8, bf16; tests/test_paged.py:142-162)."""
    _, (jcfg, jparams), model = tiny
    jbe = jb.BatchedEngine(jcfg, jparams, jb.BatchConfig(max_batch=4, n_ctx=N_CTX, block=4,
                                                          paged=True, page_size=8))
    jreqs = [jbe.submit(p, 6, js.SamplerParams(temp=0.0), ignore_eos=True) for p in PROMPTS]
    jbe.run()
    be, got = _streams(model, [(p, 6, GREEDY, 0) for p in PROMPTS], paged=True, page_size=8)
    assert got == [r.generated for r in jreqs]
    assert _all_pages_back(be)


@pytest.mark.parametrize("kv_dtype,ps", [("bfloat16", 8), ("int8", 32)])
def test_paged_engine_matches_flat(tiny, kv_dtype, ps):
    """Greedy and seeded sampled streams of the paged engine equal the flat
    engine's at kv_block = page_size (tests/test_paged.py:129-162,
    :278-303). The plain versions here attend over n_ctx columns on both
    sides, so even the sampled draws agree."""
    subs = [(p, 6, GREEDY, 0) for p in PROMPTS[:3]] + [([1, 2, 3, 4, 5, 6], 5, SAMPLED, 7)]
    _, want = _streams(tiny[2], subs, kv_dtype=kv_dtype, kv_block=ps)
    be, got = _streams(tiny[2], subs, kv_dtype=kv_dtype, paged=True, page_size=ps)
    assert got == want
    assert be.cache.k.dtype == (torch.int8 if kv_dtype == "int8" else torch.bfloat16)
    assert len(set(got[3])) > 1  # it samples
    assert _all_pages_back(be)


@pytest.mark.parametrize("kv_dtype,ps,plen,n_pages", [("bfloat16", 8, 19, 0),
                                                      ("int8", 32, 37, 7)])
def test_paged_prefix_pages_shared(tiny, kv_dtype, ps, plen, n_pages):
    """register_prefix prefills the prefix's full pages once; every slot
    that continues it maps them (refcount 1 + slots) and re-evaluates only
    the sub-page remainder with its suffix. Streams equal the flat engine's
    prefix caching (tests/test_paged.py:165-191, :306-330; the int8 pool is
    tight)."""
    cfg, params, _ = tiny[2]
    prefix = list(range(3, 3 + plen))
    suffixes = [[3, 1], [4, 4, 4], [8]]
    flat = BatchedEngine(cfg, params, BatchConfig(max_batch=4, n_ctx=N_CTX, block=4,
                                                  kv_dtype=kv_dtype, kv_block=ps), device="cpu")
    fp = flat.register_prefix(prefix)
    want = [flat.submit(s, 8, GREEDY, ignore_eos=True, prefix=fp) for s in suffixes]
    flat.run()
    be = BatchedEngine(cfg, params, BatchConfig(max_batch=4, n_ctx=N_CTX, block=4,
                                                kv_dtype=kv_dtype, paged=True, page_size=ps,
                                                n_pages=n_pages), device="cpu")
    pid = be.register_prefix(prefix)
    pages = be.prefixes[pid][0]
    assert len(pages) == plen // ps
    reqs = [be.submit(s, 8, GREEDY, ignore_eos=True, prefix=pid) for s in suffixes]
    be.step()  # admission and one block of 4: no request is done yet
    assert be.pager.alloc.refs[pages].tolist() == [1 + len(suffixes)] * len(pages)
    assert all(be.pager.table[r.slot, : len(pages)].tolist() == pages for r in reqs)
    be.run()
    assert [r.generated for r in reqs] == [r.generated for r in want]
    assert be.pager.alloc.refs[pages].tolist() == [1] * len(pages)  # the registry's hold
    assert be.pager.alloc.n_free == be.pager.alloc.n_pages - 1 - len(pages)


def test_paged_preemption(tiny):
    """A pool of 7 usable pages (56 rows) for 3 requests that need ~28 rows
    each: the youngest is preempted when pages run dry, recomputes on
    re-admission, and every greedy stream stays exact
    (tests/test_paged.py:194-210)."""
    prompts = [[5, 9, 2, 30], [7, 3, 11], [1, 2, 3]]
    subs = [(p, 20, GREEDY, 0) for p in prompts]
    _, want = _streams(tiny[2], subs, max_batch=3, kv_block=8)
    be, got = _streams(tiny[2], subs, max_batch=3, paged=True, page_size=8, n_pages=8)
    assert be.stats["preempted"] > 0
    assert got == want
    assert _all_pages_back(be)


def test_paged_page_reuse_across_waves(tiny):
    """A second wave runs on the first wave's freed pages, mapped in another
    order, and still matches the flat streams (tests/test_paged.py:213-226)."""
    cfg, params, _ = tiny[2]
    be = BatchedEngine(cfg, params, BatchConfig(max_batch=2, n_ctx=N_CTX, block=4, paged=True,
                                                page_size=8), device="cpu")
    used = []
    for wave in ([[5, 9, 2], [7, 3]], [[11, 12, 13], [1]]):
        _, want = _streams(tiny[2], [(p, 6, GREEDY, 0) for p in wave], max_batch=2, kv_block=8)
        reqs = [be.submit(p, 6, GREEDY, ignore_eos=True) for p in wave]
        be.step()
        used.append(sorted(be.pager.table[be.pager.table > 0].tolist()))
        be.run()
        assert [r.generated for r in reqs] == want
        assert _all_pages_back(be)
    assert set(used[1]) <= set(used[0]) | set(be.pager.alloc.free)


def test_paged_server_stats(tiny):
    """The server over a paged engine answers a completion and reports its
    preemptions and the pool's pages in /stats and /metrics."""
    cfg, params, tok = tiny[2]
    srv = LlamaServer(cfg, params, tok, BatchConfig(max_batch=2, n_ctx=N_CTX, block=4,
                                                    paged=True, page_size=8), device="cpu")
    httpd = srv.start("127.0.0.1", 0)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        req = urllib.request.Request(
            base + "/v1/completions", method="POST", headers={"Content-Type": "application/json"},
            data=json.dumps(dict(prompt=PROMPTS[0], max_tokens=6, temperature=0.0,
                                 ignore_eos=True)).encode())
        with urllib.request.urlopen(req, timeout=60) as r:
            text = json.loads(r.read())["choices"][0]["text"]
        with urllib.request.urlopen(base + "/stats", timeout=60) as r:
            stats = json.loads(r.read())
        with urllib.request.urlopen(base + "/metrics", timeout=60) as r:
            metrics = r.read().decode()
    finally:
        srv.shutdown()
        thread.join(timeout=30)
    _, want = _streams(tiny[2], [(PROMPTS[0], 6, GREEDY, 0)], max_batch=2)
    assert text == b"".join(tok.decode_token(t) for t in want[0]).decode()
    assert stats["preempted"] == 0 and "llamavk_preempted 0" in metrics
    assert stats["pages_total"] == 2 * N_CTX // 8 + 1
    assert stats["pages_free"] == stats["pages_total"] - 1


def test_paged_preempted_before_first_block(tiny):
    """A request preempted between its admission and its first decode block
    keeps the first token its admission sampled; when that token ends it
    (n_predict 1), it finishes there and is not admitted again. Two usable
    8-row pages: each prompt takes one, and the older request's block needs
    a second, so the one just admitted is preempted."""
    cfg, params, _ = tiny[2]
    be = BatchedEngine(cfg, params, BatchConfig(max_batch=2, n_ctx=N_CTX, block=4, paged=True,
                                                page_size=8, n_pages=3), device="cpu")
    old = be.submit(list(range(3, 11)), 9, GREEDY, ignore_eos=True)
    young = be.submit([5, 9, 2], 1, GREEDY, ignore_eos=True)
    first = be.step()
    assert be.stats["preempted"] == 1 and first == [young]
    assert len(young.generated) == 1 and young not in be.queue
    assert be.run() == [old] and len(old.generated) == 9
    _, want = _streams(tiny[2], [(old.prompt, 9, GREEDY, 0), (young.prompt, 1, GREEDY, 0)],
                       max_batch=2)
    assert [old.generated, young.generated] == want
    assert _all_pages_back(be)


def test_paged_preempted_admit_leaves_other_rows(tiny):
    """A request admitted into a freed slot and preempted in the same step
    (before its first block) takes no other slot's row: its pending first
    token must not land in the last slot, which here holds an older live
    request. Four usable 8-row pages: A (slot 0) finishes at its first
    token, D takes slot 0 in the next step, and B's and C's second pages
    leave D, the youngest, without one."""
    cfg, params, _ = tiny[2]
    be = BatchedEngine(cfg, params, BatchConfig(max_batch=3, n_ctx=N_CTX, block=4, paged=True,
                                                page_size=8, n_pages=5), device="cpu")
    subs = [([5, 9, 2], 1), ([7, 3, 11], 12), ([1, 2, 3], 12), ([11, 12, 13], 6)]
    reqs = [be.submit(p, n, GREEDY, ignore_eos=True) for p, n in subs[:3]]
    assert be.step() == [reqs[0]]
    reqs.append(be.submit(*subs[3], GREEDY, ignore_eos=True))
    be.step()
    assert be.stats["preempted"] == 1 and reqs[3].slot == -1 and be.slots[2] is reqs[2]
    be.run()
    _, want = _streams(tiny[2], [(p, n, GREEDY, 0) for p, n in subs], max_batch=3, kv_block=8)
    assert [r.generated for r in reqs] == want
    assert _all_pages_back(be)


# --- prompt-lookup speculation on pages (tests/test_paged.py:347-446) ----------


LOOKUP_PROMPTS = [([5, 9, 2, 30, 5, 9], GREEDY, 0), ([7, 3, 11, 7, 3], GREEDY, 0),
                  ([1, 2, 3, 1, 2, 3], SAMPLED, 7)]


@pytest.mark.parametrize("kv_dtype,ps,budgets", [("bfloat16", 8, (10, 8, 6)),
                                                 ("int8", 32, (30, 28, 12))])
def test_paged_lookup_matches_flat(tiny, kv_dtype, ps, budgets):
    """Greedy and seeded sampled lookup streams (gamma 3) of the paged engine
    equal the flat lookup engine's at kv_block = page_size; the gamma-row
    verify writes cross pages through page_straddle (bf16 data pages, and
    int8 data and scale pages: the budgets run past row 32); every page
    comes back."""
    subs = [(p, n, sp, seed) for (p, sp, seed), n in zip(LOOKUP_PROMPTS, budgets)]
    _, want = _streams(tiny[2], subs, lookup_gamma=3, kv_dtype=kv_dtype, kv_block=ps)
    be, got = _streams(tiny[2], subs, lookup_gamma=3, kv_dtype=kv_dtype, paged=True,
                       page_size=ps)
    assert got == want
    assert be.stats["straddled"] > 0 and be.stats["rounds"] > 0
    assert _all_pages_back(be)


@pytest.mark.parametrize("kv_dtype,ps,n,n_pages", [("bfloat16", 8, 16, 9), ("int8", 32, 24, 4)])
def test_paged_lookup_preemption(tiny, kv_dtype, ps, n, n_pages):
    """Lookup under a tight pool: preempt-youngest and recompute on
    re-admission (generated tokens re-enter the prefill, the history rows
    are re-seeded) keep the greedy streams equal to the flat lookup
    engine's; the int8 budget pushes every slot past a 32-row page while
    the pool holds 3 usable pages."""
    subs = [(p, n, GREEDY, 0) for p in ([5, 9, 2, 30, 5, 9], [7, 3, 11, 7], [1, 2, 3, 1])]
    _, want = _streams(tiny[2], subs, max_batch=3, lookup_gamma=3, kv_dtype=kv_dtype,
                       kv_block=ps)
    be, got = _streams(tiny[2], subs, max_batch=3, lookup_gamma=3, kv_dtype=kv_dtype,
                       paged=True, page_size=ps, n_pages=n_pages)
    assert be.stats["preempted"] > 0
    assert got == want
    assert _all_pages_back(be)
