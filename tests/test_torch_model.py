"""The port's model against the JAX package's on the tiny random model:
parameters carried across with `params_from_arrays`, a flash-path prefill of
8 tokens plus 2 decode steps against JAX `llama_forward` (Pallas kernels in
interpret mode), and the two loaders on one GGJT file."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llamavk_tpu.models import llama as jm
from llamavk_tpu.models import loader as jl
from llamavk_tpu_torch.models import llama as tm
from llamavk_tpu_torch.models import loader as tl

torch.set_num_threads(2)

PROMPT = [1, 5, 9, 2, 30, 7, 3, 11]
N_CTX = 64

# Both sides keep activations in bf16 between ops and sum in f32, in
# different orders, so an activation can land one bf16 ulp apart and carry
# that through the layers. The logits of this model stay below 4 in
# magnitude, where a bf16 ulp is 2^-6 = 0.0156: allow two.
LOGIT_TOL = dict(rtol=0, atol=0.032)
# cached K/V rows are bf16 of magnitude < 4 as well: two ulps
CACHE_TOL = dict(rtol=0, atol=0.032)


def jax_arrays(params) -> dict[str, np.ndarray]:
    """The JAX parameter pytree flattened to NumPy, keyed by attribute path."""
    flat, _ = jax.tree_util.tree_flatten_with_path(params)
    return {".".join(p.name for p in path): np.asarray(leaf) for path, leaf in flat}


def port_arrays(obj, prefix="") -> dict[str, np.ndarray]:
    """The port's parameter dataclasses flattened the same way."""
    if isinstance(obj, torch.Tensor):
        return {prefix: obj.float().numpy() if obj.dtype == torch.bfloat16 else obj.numpy()}
    out = {}
    for f in dataclasses.fields(obj):
        val = getattr(obj, f.name)
        if isinstance(val, torch.Tensor) or dataclasses.is_dataclass(val):
            out.update(port_arrays(val, f"{prefix}.{f.name}" if prefix else f.name))
    return out


def port_cfg(cfg) -> tm.ModelConfig:
    return tm.ModelConfig(**{f.name: getattr(cfg, f.name) for f in dataclasses.fields(tm.ModelConfig)})


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("tiny") / "tiny-q4.bin")
    jl.random_tiny_model(write_path=path, quantize=True)
    cfg, params, _ = jl.load_model(path)
    return path, cfg, params


@pytest.fixture(scope="module")
def jax_run(tiny):
    """JAX logits and cache after prefill + 2 greedy decode steps."""
    _, cfg, params = tiny
    # one compile per shape: the two decode steps share one program
    fwd = jax.jit(jm.llama_forward, static_argnames=("cfg", "logits_all", "attn_impl"))
    cache = jm.init_kv_cache(cfg, 1, N_CTX)
    logits, cache, _ = fwd(
        params, jnp.asarray([PROMPT], jnp.int32), cache, jnp.int32(0), cfg,
        logits_all=True, attn_impl="flash",
    )
    steps = [np.asarray(logits)]
    for i in range(2):
        tok = int(steps[-1][0, -1].argmax())
        logits, cache, _ = fwd(
            params, jnp.asarray([[tok]], jnp.int32), cache, jnp.int32(len(PROMPT) + i),
            cfg, attn_impl="flash",
        )
        steps.append(np.asarray(logits))
    return steps, np.asarray(cache.k.astype(jnp.float32)), np.asarray(cache.v.astype(jnp.float32))


def test_forward_matches_jax(tiny, jax_run):
    _, cfg, params = tiny
    tcfg = port_cfg(cfg)
    tparams = tl.params_from_arrays(jax_arrays(params), tcfg, device="cpu")
    want_steps, want_k, want_v = jax_run
    cache = tm.init_kv_cache(tcfg, 1, N_CTX, device="cpu")
    logits, cache2, _ = tm.llama_forward(
        tparams, torch.tensor([PROMPT]), cache, 0, tcfg, logits_all=True, attn_impl="flash"
    )
    assert cache2 is cache  # updated in place
    got_steps = [logits.numpy()]
    for i in range(2):
        # feed the JAX stream's token, so both sides see the same inputs
        tok = int(want_steps[i][0, -1].argmax())
        logits, cache, _ = tm.llama_forward(
            tparams, torch.tensor([[tok]]), cache, len(PROMPT) + i, tcfg, attn_impl="flash"
        )
        got_steps.append(logits.numpy())
    for got, want in zip(got_steps, want_steps):
        assert got.shape == want.shape and np.isfinite(got).all()
        np.testing.assert_allclose(got, want, **LOGIT_TOL)
    np.testing.assert_allclose(cache.k.float().numpy(), want_k, **CACHE_TOL)
    np.testing.assert_allclose(cache.v.float().numpy(), want_v, **CACHE_TOL)


def test_load_model_matches_jax(tiny):
    """Both loaders read one GGJT file into identical packed bytes, scales
    and norms."""
    path, cfg, params = tiny
    tcfg, tparams, tok = tl.load_model(path, device="cpu")
    assert tcfg == port_cfg(cfg)
    want = jax_arrays(params)
    got = port_arrays(tparams)
    assert sorted(got) == sorted(want)
    for key, val in want.items():
        np.testing.assert_array_equal(got[key], val.astype(got[key].dtype), err_msg=key)
    assert len(tok.vocab) == cfg.n_vocab


def test_dense_model_matches_jax(tmp_path):
    """An f32 checkpoint: dense weights on both sides, same loader output,
    and prefill logits within the same tolerance."""
    path = str(tmp_path / "tiny-f32.bin")
    jl.random_tiny_model(write_path=path, quantize=False)
    cfg, params, _ = jl.load_model(path)
    tcfg, tparams, _ = tl.load_model(path, device="cpu")
    want = jax_arrays(params)
    got = port_arrays(tparams)
    assert sorted(got) == sorted(want)
    for key, val in want.items():
        np.testing.assert_array_equal(got[key], val.astype(got[key].dtype), err_msg=key)
    fwd = jax.jit(jm.llama_forward, static_argnames=("cfg", "logits_all", "attn_impl"))
    jlog, _, _ = fwd(params, jnp.asarray([PROMPT], jnp.int32), jm.init_kv_cache(cfg, 1, N_CTX),
                     jnp.int32(0), cfg, logits_all=True, attn_impl="flash")
    tlog, _, _ = tm.llama_forward(tparams, torch.tensor([PROMPT]),
                                  tm.init_kv_cache(tcfg, 1, N_CTX, device="cpu"), 0, tcfg,
                                  logits_all=True)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **LOGIT_TOL)


@pytest.mark.parametrize("t,route", [(1, "update"), (5, "update"), (256, "update"),
                                     (300, "read"), (512, "update")])
def test_attention_route(tiny, monkeypatch, t, route):
    """The dispatch of llama.py:589-687: the update kernel when
    T % min(256, T) == 0, else a plain row write and the read kernel."""
    _, cfg, params = tiny
    tcfg = port_cfg(cfg)
    tparams = tl.params_from_arrays(jax_arrays(params), tcfg, device="cpu")
    calls = []
    for name in ("flash_attention", "flash_attention_update"):
        fn = getattr(tm, name)
        monkeypatch.setattr(tm, name, lambda *a, _fn=fn, _n=name, **k: calls.append(_n) or _fn(*a, **k))
    cache = tm.init_kv_cache(tcfg, 1, 512, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(t).integers(0, tcfg.n_vocab, (1, t)))
    logits, _, _ = tm.llama_forward(tparams, toks, cache, 0, tcfg)
    want = "flash_attention_update" if route == "update" else "flash_attention"
    assert calls == [want] * tcfg.n_layer
    # rows [0, T) of every layer were written, the rest of the cache was not
    assert bool((cache.k[:, :, :, :t] != 0).any(dim=-1).all())
    assert not bool(cache.k[:, :, :, t:].any())
    assert torch.isfinite(logits).all()


# int8 caches: the K/V rows each side quantizes come from activations that
# may sit a bf16 ulp apart, so a quantized value can differ by one step
# (scale/127 of a row whose amax is < 4 here, i.e. < 0.032) and a scale by
# a few f32 ulps; the logits stay within the bf16 tolerance above. The B > 1
# decode route is held against JAX in tests/test_torch_flash_decode.py.
INT8_CACHE_TOL = dict(rtol=0, atol=0.032)


def dequant(k, ks, lanes):
    """f32 [L, B, H, S, D] values of an int8 cache plane and its scales (the
    first `lanes` head lanes of the scale plane)."""
    ks = np.asarray(ks, np.float32)[..., :lanes]
    return np.asarray(k, np.float32) * ks.transpose(0, 1, 3, 2)[..., None]


def check_int8_cache(cache, want, cfg):
    """The port's int8 cache against a JAX one, dequantized."""
    assert cache.k.dtype == torch.int8 and cache.k_scale.shape == (
        cfg.n_layer, cache.k.shape[1], cache.k.shape[3], cfg.n_head)
    for plane, scale, wp, ws in ((cache.k, cache.k_scale, want.k, want.k_scale),
                                 (cache.v, cache.v_scale, want.v, want.v_scale)):
        np.testing.assert_allclose(dequant(plane.numpy(), scale.numpy(), cfg.n_head),
                                   dequant(wp, ws, cfg.n_head), **INT8_CACHE_TOL)


def test_forward_int8_matches_jax(tiny):
    """int8 cache: a prefill of 8 tokens and 2 greedy decode steps (the
    fused update kernel's int8 route) against JAX llama_forward."""
    _, cfg, params = tiny
    fwd = jax.jit(jm.llama_forward, static_argnames=("cfg", "logits_all", "attn_impl"))
    jcache = jm.init_kv_cache(cfg, 1, N_CTX, dtype=jnp.int8)
    tcfg = port_cfg(cfg)
    tparams = tl.params_from_arrays(jax_arrays(params), tcfg, device="cpu")
    cache = tm.init_kv_cache(tcfg, 1, N_CTX, dtype=torch.int8, device="cpu")
    toks, n_past = [PROMPT], 0
    for i in range(3):
        want, jcache, _ = fwd(params, jnp.asarray(toks, jnp.int32), jcache, jnp.int32(n_past),
                              cfg, logits_all=i == 0, attn_impl="flash")
        got, _, _ = tm.llama_forward(tparams, torch.tensor(toks), cache, n_past, tcfg,
                                     logits_all=i == 0, attn_impl="flash")
        assert got.shape == want.shape and torch.isfinite(got).all()
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)
        n_past += len(toks[0])
        toks = [[int(np.asarray(want)[0, -1].argmax())]]  # the JAX stream's token
    check_int8_cache(cache, jcache, tcfg)
