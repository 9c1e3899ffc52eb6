"""The port's shared-prefix pool on the CPU against the JAX package's: the
prefix pre-pass of the attention's plain versions against the Pallas kernels
in interpret mode (bf16 and int8 slot caches over a bf16 pool, ragged
prefix lengths with none, the pool's own KV block), `BatchedEngine
(shared_prefix=True)` greedy streams against the JAX engine's (prefixed and
plain requests mixed, two pool entries, slot reuse; int8 slots with
prompt-lookup speculation) and against the plain compositions they stand
for, and `serve --shared-prefix` registering through POST /v1/prefixes."""

import json
import subprocess
import sys
import urllib.request
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llamavk_tpu.models import loader as jl
from llamavk_tpu.ops import flash_attn as jfa
from llamavk_tpu.ops.kv_quant import quantize_rows as jquant
from llamavk_tpu.runtime import batching as jb
from llamavk_tpu.runtime import sampling as js
from llamavk_tpu_torch.cli import serve
from llamavk_tpu_torch.models import llama as tm
from llamavk_tpu_torch.models import loader as tl
from llamavk_tpu_torch.ops import flash_attn as tfa
from llamavk_tpu_torch.runtime import sampling as ts
from llamavk_tpu_torch.runtime.batching import BatchConfig, BatchedEngine
from llamavk_tpu_torch.runtime.engine import Engine, EngineConfig

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
# the JAX package's prefix kernel-vs-dense tolerances (tests/test_flash_attn.py,
# tests/test_kv_quant.py); the plain version is that dense softmax over the
# pool rows and the cache rows with the kernels' rounding points
ATTN_TOL = dict(rtol=2e-2, atol=2e-2)
INT8_ATTN_TOL = dict(rtol=3e-2, atol=3e-2)
GREEDY_T = ts.SamplerParams(temp=0.0)
GREEDY_J = js.SamplerParams(temp=0.0)
# both prefixes fit one 8-row prefill bucket: one JAX compile for both
PREFIXES = [[5, 9, 2, 30, 7, 11, 4], [1, 2, 3, 4, 5, 6, 7, 8]]
# (prefix index or -1, suffix, tokens) on 2 slots: two pool entries and a
# plain request in one batch, and the fourth request reuses a freed slot
MIXED = [(0, [3, 1], 6), (1, [7], 5), (-1, [42, 17, 3], 5), (0, [8], 4)]
# the int8 x lookup engine's requests (tests/test_batching.py:201-382)
LOOKUP = [(0, [3, 1], 6), (0, [4, 4, 4], 6), (0, [8], 6)]


def _bf16(rng, shape):
    """One bf16 array for both frameworks (rounded once, by JAX)."""
    j = jnp.asarray(rng.standard_normal(shape), jnp.bfloat16)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(torch.bfloat16)


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def _cache(rng, quant: bool, shape):
    """A cache for both frameworks: bf16 values, or their int8 rows and
    [..., S, H] scales."""
    kj, kt = _bf16(rng, shape)
    vj, vt = _bf16(rng, shape)
    if not quant:
        return (kj, vj), (kt, vt), {}, {}
    kq, ks = jquant(kj)
    vq, vs = jquant(vj)
    perm = tuple(range(ks.ndim - 2)) + (ks.ndim - 1, ks.ndim - 2)
    ks, vs = ks.transpose(perm), vs.transpose(perm)
    return ((kq, vq), (_t(kq), _t(vq)), dict(k_scale=ks, v_scale=vs),
            dict(k_scale=_t(ks), v_scale=_t(vs)))


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("b,t,h,sp,s,d,bk", [(3, 8, 2, 128, 64, 32, 32),
                                             (2, 1, 2, 256, 320, 32, 256)])
def test_prefix_read_matches_jax(quant, b, t, h, sp, s, d, bk):
    """K3's prefix pre-pass over ragged pool entries (prefix_len 0 = none)
    against the JAX kernel, bf16 and int8 slots; the second case snaps the
    slot's KV block to 160, which does not divide the 256-row pool, so the
    pre-pass fits its own (tests/test_flash_attn.py:186-222)."""
    rng = np.random.default_rng(1 + quant)
    npast = np.array([3, 9, 5][:b], np.int32)
    qj, qt = _bf16(rng, (b, t, h, d))
    (kj, vj), (kt, vt), scj, sct = _cache(rng, quant, (b, h, s, d))
    pkj, pkt = _bf16(rng, (3, h, sp, d))
    pvj, pvt = _bf16(rng, (3, h, sp, d))
    pid = np.array([2, 0, 1][:b], np.int32)
    plen = np.array([33, 0, 64][:b] if sp == 128 else [100, 256], np.int32)
    want = jfa.flash_attention(qj, kj, vj, jnp.asarray(npast), block_t=32, block_k=bk,
                               prefix_k=pkj, prefix_v=pvj, prefix_id=jnp.asarray(pid),
                               prefix_len=jnp.asarray(plen), **scj)
    got = tfa.flash_attention(qt, kt[None], vt[None], torch.from_numpy(npast), block_k=bk,
                              prefix_k=pkt[None], prefix_v=pvt[None], prefix_id=_t(pid),
                              prefix_len=_t(plen),
                              **{k: v[None] for k, v in sct.items()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               **(INT8_ATTN_TOL if quant else ATTN_TOL))


@pytest.mark.parametrize("quant", [False, True])
def test_prefix_update_matches_jax(quant):
    """K2 with the pre-pass (the decode and admission path of shared-prefix
    serving): the T = 4 rows land at the slot-local n_past, the caches (int8:
    data and scales) byte-equal to the JAX kernel's, the pool untouched
    (tests/test_flash_attn.py:158-183, tests/test_kv_quant.py:260-290)."""
    rng = np.random.default_rng(7 + quant)
    L, b, t, h, s, d, sp = 2, 2, 4, 2, 64, 32, 64
    n_past = np.array([10, 3], np.int32)
    qj, qt = _bf16(rng, (b, t, h, d))
    knj, knt = _bf16(rng, (b, t, h, d))
    vnj, vnt = _bf16(rng, (b, t, h, d))
    (kj, vj), (kt, vt), scj, sct = _cache(rng, quant, (L, b, h, s, d))
    pkj, pkt = _bf16(rng, (L, 3, h, sp, d))
    pvj, pvt = _bf16(rng, (L, 3, h, sp, d))
    pool = (pkt.clone(), pvt.clone())
    pid = np.array([1, 2], np.int32)
    plen = np.array([40, 16], np.int32)
    want = jfa.flash_attention_update(qj, knj, vnj, kj, vj, jnp.asarray(n_past), jnp.int32(1),
                                      block_t=4, block_k=32, prefix_k=pkj, prefix_v=pvj,
                                      prefix_id=jnp.asarray(pid),
                                      prefix_len=jnp.asarray(plen), **scj)
    got = tfa.flash_attention_update(qt, knt, vnt, kt, vt, torch.from_numpy(n_past), 1,
                                     block_t=4, block_k=32, prefix_k=pkt, prefix_v=pvt,
                                     prefix_id=_t(pid), prefix_len=_t(plen), **sct)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g.float().numpy(), np.asarray(w.astype(jnp.float32)))
    assert torch.equal(pkt, pool[0]) and torch.equal(pvt, pool[1])
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               **(INT8_ATTN_TOL if quant else ATTN_TOL))


def test_prefix_modes_refused():
    """Ring and prefix exclude each other and a page table, as the JAX
    asserts do; llama_forward needs a per-row n_past with a pool."""
    q = torch.zeros((1, 1, 2, 32), dtype=torch.bfloat16)
    k = torch.zeros((1, 1, 2, 64, 32), dtype=torch.bfloat16)
    pool = torch.zeros((1, 1, 2, 64, 32), dtype=torch.bfloat16)
    one = torch.ones(1, dtype=torch.int32)
    pkw = dict(prefix_k=pool, prefix_v=pool, prefix_id=one - 1, prefix_len=one)
    with pytest.raises(ValueError, match="non-ring"):
        tfa.flash_attention(q, k, k, 0, kv_pos=torch.zeros((64, 1), dtype=torch.int32), **pkw)
    with pytest.raises(ValueError, match="paged"):
        tfa.flash_attention(q, k, k, 0, page_table=torch.zeros((1, 1), dtype=torch.int32),
                            **pkw)


@pytest.fixture(scope="module")
def tiny_path(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("tiny") / "tiny-q4.bin")
    jl.random_tiny_model(write_path=path, quantize=True)
    return path


@pytest.fixture(scope="module")
def model(tiny_path):
    cfg, params, _ = tl.load_model(tiny_path, device="cpu")
    return cfg, params


def _run(make, cfg, params, bcfg, reqs, greedy):
    """Streams of `reqs` through a shared-prefix engine of either package."""
    be = make(cfg, params, bcfg)
    pids = [be.register_prefix(p) for p in PREFIXES]
    handles = [be.submit(sfx, n, greedy, ignore_eos=True, prefix=pids[i] if i >= 0 else -1)
               for i, sfx, n in reqs]
    be.run()
    return be, [r.generated for r in handles]


@pytest.fixture(scope="module")
def jax_streams(tiny_path):
    """The JAX BatchedEngine's streams: bf16 slots with MIXED, and int8 slots
    at kv_block 32 with lookup_gamma 3 on LOOKUP."""
    jcfg, jparams, _ = jl.load_model(tiny_path)
    out = {}
    for name, reqs, kw in (("mixed", MIXED, {}),
                           ("int8_lookup", LOOKUP,
                            dict(kv_dtype="int8", kv_block=32, lookup_gamma=3))):
        bcfg = jb.BatchConfig(max_batch=2, n_ctx=64, block=4, shared_prefix=True,
                              prefix_ctx=256, **kw)
        be, out[name] = _run(jb.BatchedEngine, jcfg, jparams, bcfg, reqs, GREEDY_J)
        if kw:
            assert be.stats.get("rounds", 0) > 0
    return out


def _port(cfg, params, reqs, **kw):
    bcfg = BatchConfig(max_batch=2, n_ctx=64, block=4, shared_prefix=True, prefix_ctx=256, **kw)
    return _run(lambda c, p, b: BatchedEngine(c, p, b, device="cpu"), cfg, params, bcfg, reqs,
                GREEDY_T)


def _single(cfg, params, prompt, n):
    eng = Engine(cfg, params, EngineConfig(n_ctx=128), device="cpu")
    return eng.generate(prompt, n, GREEDY_T, ignore_eos=True)


def test_shared_prefix_mixed_matches_jax(model, jax_streams):
    """Prefixed rows (two pool entries) and a plain row in one batch, and a
    freed slot reused by another prefix: the streams equal the JAX engine's
    and the single-stream streams of prefix + suffix; slots hold only the
    suffix, every admission prefilled only it."""
    cfg, params = model
    be, got = _port(cfg, params, MIXED)
    assert got == jax_streams["mixed"]
    for (i, sfx, n), stream in zip(MIXED, got):
        assert stream == _single(cfg, params, (PREFIXES[i] if i >= 0 else []) + sfx, n)
    assert be.stats["prefills"] == len(MIXED)
    assert be.pfx_k.dtype == torch.bfloat16 and be.pfx_k.shape[1] == 4
    assert not be.pfx_len.any() and all(s is None for s in be.slots)


def _bucket(n: int) -> int:
    """The power of two >= n, at least 8: the engines' prefill buckets."""
    b = 8
    while b < n:
        b *= 2
    return b


def _pool_oracle(cfg, params, prefix, suffix, n, kv_dtype):
    """The composition a shared-prefix engine implements, request by request
    (tests/test_batching.py:311-366): the prefix prefilled once into a bf16
    pool, the suffix and the decode against a slot cache of `kv_dtype`
    holding only the suffix rows, at kv_block 32."""
    plen = len(prefix)
    pool = tm.init_kv_cache(cfg, 1, 256, device="cpu")
    tm.llama_forward(params, torch.tensor([prefix + [0] * (_bucket(plen) - plen)]), pool, 0,
                     cfg, last_idx=plen - 1, kv_block=32)
    pkw = dict(prefix_kv=(pool.k, pool.v), prefix_id=torch.zeros(1, dtype=torch.int32),
               prefix_len=torch.tensor([plen], dtype=torch.int32))
    slot = tm.init_kv_cache(cfg, 1, 64, dtype=kv_dtype, device="cpu")
    toks = suffix + [0] * (_bucket(len(suffix)) - len(suffix))
    logits, _, _ = tm.llama_forward(params, torch.tensor([toks]), slot,
                                    torch.tensor([plen], dtype=torch.int32), cfg,
                                    last_idx=torch.tensor([len(suffix) - 1]), kv_block=32, **pkw)
    out, npos = [int(logits[0, -1].argmax())], plen + len(suffix)
    for _ in range(n - 1):
        logits, _, _ = tm.llama_forward(params, torch.tensor([[out[-1]]]), slot,
                                        torch.tensor([npos], dtype=torch.int32), cfg,
                                        kv_block=32, **pkw)
        out.append(int(logits[0, -1].argmax()))
        npos += 1
    return out


def test_shared_prefix_int8_lookup_matches_jax(model, jax_streams):
    """int8 slots over the bf16 pool with prompt-lookup speculation at
    kv_block 32: the streams equal the JAX engine's, and the plain int8
    composition's (the oracle of tests/test_batching.py:359-379)."""
    cfg, params = model
    be, got = _port(cfg, params, LOOKUP, kv_dtype="int8", kv_block=32, lookup_gamma=3)
    assert be.stats["rounds"] > 0 and be.ctx_dev.shape[1] == 64 + 256
    assert got == jax_streams["int8_lookup"]
    for (i, sfx, n), stream in zip(LOOKUP, got):
        assert stream == _pool_oracle(cfg, params, PREFIXES[i], sfx, n, torch.int8)


@pytest.mark.parametrize("kv_dtype,gamma", [("int8", 0), ("bfloat16", 3)])
def test_shared_prefix_matches_composition(model, kv_dtype, gamma):
    """Without speculation over int8 slots, and with it over bf16 slots: the
    streams equal the plain composition (int8) or the single stream of
    prefix + suffix (bf16)."""
    cfg, params = model
    _, got = _port(cfg, params, LOOKUP, kv_dtype=kv_dtype, kv_block=32, lookup_gamma=gamma)
    for (i, sfx, n), stream in zip(LOOKUP, got):
        want = (_pool_oracle(cfg, params, PREFIXES[i], sfx, n, torch.int8) if kv_dtype == "int8"
                else _single(cfg, params, PREFIXES[i] + sfx, n))
        assert stream == want


def test_shared_prefix_engine_checks(model):
    """The JAX engine's asserts, as errors: paged excludes the pool, the pool
    holds prefix_pool entries of at most prefix_ctx rows, and a submit
    counts only the suffix against n_ctx."""
    cfg, params = model
    with pytest.raises(ValueError, match="excludes shared_prefix"):
        BatchedEngine(cfg, params, BatchConfig(paged=True, shared_prefix=True, n_ctx=64,
                                               page_size=8), device="cpu")
    be = BatchedEngine(cfg, params, BatchConfig(max_batch=1, n_ctx=64, shared_prefix=True,
                                                prefix_pool=1), device="cpu")
    with pytest.raises(ValueError, match="pool ctx"):
        be.register_prefix(list(range(3, 260)))
    pid = be.register_prefix(list(range(3, 103)))  # 100 rows: more than a slot's 64
    with pytest.raises(ValueError, match="pool full"):
        be.register_prefix([5, 6])
    be.submit([7] * 30, 30, GREEDY_T, prefix=pid)  # 100 + 60 positions, 60 slot rows


def test_serve_shared_prefix_registers_into_the_pool(tiny_path):
    """`serve --shared-prefix` in its own process on the CPU: POST
    /v1/prefixes registers into the pool and a completion continuing it
    answers with the prefix + suffix stream of the engine."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "llamavk_tpu_torch.cli.serve", "-m", tiny_path, "--device", "cpu",
         "--port", "0", "-c", "64", "--max-batch", "2", "--kv-dtype", "int8",
         "--shared-prefix", "--prefix-pool", "2", "--prefix-ctx", "256"],
        cwd=ROOT, stderr=subprocess.PIPE, text=True)

    def post(base, path, body):
        req = urllib.request.Request(base + path, method="POST",
                                     headers={"Content-Type": "application/json"},
                                     data=json.dumps(body).encode())
        with urllib.request.urlopen(req, timeout=60) as r:
            return json.loads(r.read())

    try:
        base = next(line.split(" on ")[-1].strip() for line in proc.stderr if " serving " in line)
        reg = post(base, "/v1/prefixes", {"tokens": PREFIXES[0]})
        choice = post(base, "/v1/completions", dict(prompt=[3, 1], max_tokens=6, temperature=0,
                                                    ignore_eos=True,
                                                    prefix_id=reg["prefix_id"]))["choices"][0]
    finally:
        proc.terminate()
        proc.wait(timeout=60)
    assert reg == {"prefix_id": 0, "n_tokens": len(PREFIXES[0])}
    cfg, params, tok = tl.load_model(tiny_path, device="cpu")
    want = _run(lambda c, p, b: BatchedEngine(c, p, b, device="cpu"), cfg, params,
                BatchConfig(max_batch=2, n_ctx=64, shared_prefix=True, kv_dtype="int8",
                            prefix_pool=2), [(0, [3, 1], 6)], GREEDY_T)[1][0]
    assert choice["text"] == b"".join(tok.decode_token(t) for t in want).decode()


def test_serve_shared_prefix_flags(tiny_path, capsys):
    args = serve.build_argparser().parse_args(["-m", tiny_path, "--shared-prefix",
                                               "--prefix-pool", "2", "--prefix-ctx", "512"])
    assert (args.shared_prefix, args.prefix_pool, args.prefix_ctx) == (True, 2, 512)
    args = serve.build_argparser().parse_args(["-m", tiny_path])
    assert (args.shared_prefix, args.prefix_pool, args.prefix_ctx) == (False, 4, 256)
