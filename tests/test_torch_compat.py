"""The port's llama.h API (`compat.py`) and its evaluation CLIs
(`cli/perplexity.py`, `cli/embedding.py`, `cli/quantize.py`) on the CPU, on
the tiny model: the workflow of tests/test_compat.py, logits against the JAX
package's compat for f16_kv True and False, KV blobs that cross between the
packages, the quantizer's bytes, running perplexities (bf16 and --f32) and
the embedding CLI's vector against the JAX CLIs."""

import os

import numpy as np
import pytest
import torch

from llamavk_tpu import compat as jcompat
from llamavk_tpu.cli import embedding as jembedding
from llamavk_tpu.cli import perplexity as jppl
from llamavk_tpu.cli.quantize import quantize_file as jquantize_file
from llamavk_tpu.models import loader as jl
from llamavk_tpu_torch import compat as llama
from llamavk_tpu_torch.cli import embedding as tembedding
from llamavk_tpu_torch.cli import perplexity as tppl
from llamavk_tpu_torch.cli.quantize import quantize_file
from llamavk_tpu_torch.formats.q4 import GGML_FTYPE_Q4_0, GGML_FTYPE_Q4_1
from llamavk_tpu_torch.models import loader as tl

torch.set_num_threads(2)

N_CTX = 64
# logits of the tiny model (|logit| < 4) with bf16 activations: the two
# packages sum in different orders, two bf16 ulps apart at most
# (tests/test_torch_model.py)
LOGIT_TOL = 0.032


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    d = tmp_path_factory.mktemp("m")
    q4, f32 = str(d / "tiny-q4.bin"), str(d / "tiny-f32.bin")
    jl.random_tiny_model(write_path=q4, quantize=True)
    jl.random_tiny_model(write_path=f32, quantize=False)
    return q4, f32


def _params(f16_kv: bool = True, **kw):
    p = llama.llama_context_default_params()
    p.n_ctx, p.f16_kv, p.device = N_CTX, f16_kv, "cpu"
    for k, v in kw.items():
        setattr(p, k, v)
    return p


@pytest.fixture(scope="module")
def ctx(paths):
    return llama.llama_init_from_file(paths[0], _params())


def test_reference_workflow(ctx):
    # the canonical llama.h usage loop: tokenize -> eval -> sample -> repeat
    ids = llama.llama_tokenize(ctx, "<t5><t6>", add_bos=True)
    assert ids[0] == llama.llama_token_bos()
    assert llama.llama_eval(ctx, ids, n_past=0, n_threads=4) == 0
    logits = llama.llama_get_logits(ctx)
    assert logits.shape == (1, llama.llama_n_vocab(ctx))
    tok = llama.llama_sample_top_p_top_k(ctx, ids, 40, 0.95, 0.0, 1.1)
    # greedy sample must equal argmax when temp <= 0
    assert tok == int(np.argmax(logits[-1]))
    tok = llama.llama_sample_top_p_top_k(ctx, ids, 40, 0.95, 0.8, 1.1)
    assert 0 <= tok < llama.llama_n_vocab(ctx)
    assert llama.llama_eval(ctx, [tok]) == 0
    assert llama.llama_get_kv_cache_token_count(ctx) == len(ids) + 1


def test_dims_strings_and_timings(ctx, capsys):
    assert llama.llama_n_ctx(ctx) == N_CTX
    assert llama.llama_n_embd(ctx) == 128
    assert llama.llama_token_to_str(ctx, 7) == b"<t7>"
    assert llama.llama_token_eos() == 2
    info = llama.llama_print_system_info()
    assert "platform = " in info and "torch = " in info
    assert llama.llama_mmap_supported() and not llama.llama_mlock_supported()
    llama.llama_eval(ctx, [1, 2, 3], n_past=0)
    emb = llama.llama_get_embeddings(ctx)
    assert emb.shape == (llama.llama_n_embd(ctx),) and emb.dtype == np.float32
    llama.llama_print_timings(ctx)
    assert "eval" in capsys.readouterr().out
    llama.llama_reset_timings(ctx)
    assert ctx.engine.timings.n_prompt == 0
    assert llama.llama_internal_get_tensor_map(ctx) is ctx.engine.params


def test_logits_all_and_rewind(paths):
    """logits_all returns one row per token; a rewind (n_past below the
    engine's) re-evaluates from there, as the reference does."""
    c = llama.llama_init_from_file(paths[0], _params(logits_all=True))
    llama.llama_eval(c, [1, 5, 9, 2])
    rows = llama.llama_get_logits(c).copy()
    assert rows.shape == (4, 256)
    llama.llama_eval(c, [9, 2], n_past=2)
    np.testing.assert_array_equal(llama.llama_get_logits(c), rows[2:])


@pytest.mark.parametrize("f16_kv", [True, False], ids=["bf16_kv", "f32_kv"])
def test_logits_and_blobs_cross_jax(paths, f16_kv):
    """The same eval through both packages' compat (f16_kv False: an f32
    cache): logits within LOGIT_TOL, equal KV blob sizes; a JAX blob restored
    in the port, and a port blob in JAX, continue to the logits of the
    package that wrote it."""
    t = llama.llama_init_from_file(paths[0], _params(f16_kv))
    jp = jcompat.llama_context_default_params()
    jp.n_ctx, jp.f16_kv = N_CTX, f16_kv
    j = jcompat.llama_init_from_file(paths[0], jp)
    assert t.engine.cache.k.dtype == (torch.bfloat16 if f16_kv else torch.float32)
    ids = [1, 28, 171, 252, 203]
    llama.llama_eval(t, ids)
    jcompat.llama_eval(j, ids)
    np.testing.assert_allclose(llama.llama_get_logits(t), jcompat.llama_get_logits(j),
                               rtol=0, atol=LOGIT_TOL)
    size = llama.llama_get_kv_cache_size(t)
    assert size == jcompat.llama_get_kv_cache_size(j)
    assert size == 2 * 2 * 2 * N_CTX * 64 * (2 if f16_kv else 4)
    tblob, jblob = llama.llama_get_kv_cache(t), jcompat.llama_get_kv_cache(j)
    assert len(tblob) == len(jblob) == size
    llama.llama_eval(t, [7])
    jcompat.llama_eval(j, [7])
    t_next, j_next = llama.llama_get_logits(t).copy(), jcompat.llama_get_logits(j).copy()
    # swap the snapshots: each package continues from the other's cache
    llama.llama_set_kv_cache(t, jblob, len(ids))
    jcompat.llama_set_kv_cache(j, tblob, len(ids))
    llama.llama_eval(t, [7])
    jcompat.llama_eval(j, [7])
    np.testing.assert_allclose(llama.llama_get_logits(t), j_next, rtol=0, atol=LOGIT_TOL)
    np.testing.assert_allclose(jcompat.llama_get_logits(j), t_next, rtol=0, atol=LOGIT_TOL)
    # the port's own round trip is exact
    llama.llama_set_kv_cache(t, tblob, len(ids))
    assert llama.llama_get_kv_cache_token_count(t) == len(ids)
    llama.llama_eval(t, [7])
    np.testing.assert_array_equal(llama.llama_get_logits(t), t_next)


def test_vocab_only_and_quantize(paths, tmp_path):
    vctx = llama.llama_init_from_file(paths[0], _params(vocab_only=True))
    assert vctx.engine is None
    # byte fallback, as tests/test_compat.py: byte-fallback id = byte + 3
    assert llama.llama_tokenize(vctx, "<t9>", add_bos=False) == [b + 3 for b in b"<t9>"]
    out = str(tmp_path / "q41.bin")
    assert llama.llama_model_quantize(paths[0], out, 3) == 0
    assert os.path.getsize(out) > 0


@pytest.mark.parametrize("ftype", [GGML_FTYPE_Q4_0, GGML_FTYPE_Q4_1], ids=["q4_0", "q4_1"])
def test_quantize_bytes_equal_jax(paths, tmp_path, ftype):
    """The port's NumPy quantizer writes the file the JAX CLI writes, byte
    for byte."""
    a, b = str(tmp_path / "port.bin"), str(tmp_path / "jax.bin")
    quantize_file(paths[1], a, ftype, verbose=False)
    jquantize_file(paths[1], b, ftype, verbose=False)
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()


# running perplexities: the per-token NLLs differ by the logits' drift
# (LOGIT_TOL at most on both the target logit and the log-sum-exp), so the
# running means, and the perplexities' logarithms, lie within 2 LOGIT_TOL
PPL_LOG_TOL = 2 * LOGIT_TOL


@pytest.mark.parametrize("model,f32", [(0, False), (1, False), (1, True)],
                         ids=["q4", "f32_model", "f32_model_--f32"])
def test_perplexity_matches_jax(paths, model, f32):
    """perplexity_chunks on 2 chunks of n_ctx 16 (tests/test_cli.py's
    text): the q4 model and the f32 dense model in bf16, and the dense model
    as --f32 runs it (f32 activations, scales and dense weights, the einsum
    attention over an f32 cache)."""
    import jax.numpy as jnp

    text = bytes([65 + (i % 26) for i in range(2000)])
    tkw = dict(scale_dtype=torch.float32, dense_dtype=torch.float32) if f32 else {}
    jkw = dict(scale_dtype=jnp.float32, dense_dtype=jnp.float32) if f32 else {}
    cfg, params, tok = tl.load_model(paths[model], device="cpu", **tkw)
    jcfg, jparams, jtok = jl.load_model(paths[model], **jkw)
    run = dict(dtype=torch.float32, attn_impl="einsum") if f32 else {}
    jrun = dict(dtype=jnp.float32, attn_impl="einsum") if f32 else {}
    got = tppl.perplexity_chunks(cfg, params, tok, text, n_ctx=16, max_chunks=2,
                                 verbose=False, **run)
    want = jppl.perplexity_chunks(jcfg, jparams, jtok, text, n_ctx=16, max_chunks=2,
                                  verbose=False, **jrun)
    assert len(got) == 2 and all(np.isfinite(got)) and min(got) > 1.0
    np.testing.assert_allclose(np.log(got), np.log(want), rtol=0, atol=PPL_LOG_TOL)


def test_perplexity_cli(paths, tmp_path, capsys):
    text = tmp_path / "text.raw"
    text.write_bytes(bytes([65 + (i % 26) for i in range(2000)]))
    argv = ["-m", paths[1], "-f", str(text), "-c", "16", "--max-chunks", "2", "--device", "cpu"]
    assert tppl.main(argv + ["--f32"]) == 0
    assert tppl.main(argv) == 0
    lines = [ln for ln in capsys.readouterr().out.splitlines() if "final perplexity" in ln]
    assert len(lines) == 2
    with pytest.raises(NotImplementedError, match="ggml_rounding"):
        tppl.make_chunk_nll(None, 16, ggml_rounding="f16")


def test_embedding_cli_matches_jax(paths, capsys):
    assert tembedding.main(["-m", paths[0], "-p", "hi", "-c", "32", "--device", "cpu"]) == 0
    got = np.array(capsys.readouterr().out.split(), np.float32)
    assert jembedding.main(["-m", paths[0], "-p", "hi", "-c", "32"]) == 0
    want = np.array(capsys.readouterr().out.split(), np.float32)
    assert got.shape == want.shape == (128,)
    np.testing.assert_allclose(got, want, rtol=0, atol=LOGIT_TOL)
