"""The port's int8 dot (K5's route of `ops/q4_matmul.py`) against the JAX
package's on the CPU: the activation quantization bit for bit against
`jax.jit(quantize_act_blocks)`, the plain `q4_matmul_i8_ref` against JAX
`q4_matmul(dot_mode="i8")` in Pallas interpret mode (flat, and stacked with
a layer select), the route predicate against the JAX gate over a grid of
shapes, every value of the dot-mode switches, and, in one subprocess under
LLAMAVK_Q4_DOT=i8 (both packages read it at import), a tiny forward and a
lookup stream of both packages. Inputs come from seeded NumPy."""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import llamavk_tpu.ops.q4_matmul  # noqa: F401  (the module, not the function ops exports)
from llamavk_tpu import ops as jops
from llamavk_tpu.formats import quantize_q4_0, quantize_q4_1, repack_q4_0, repack_q4_1
from llamavk_tpu.formats.repack import LAYOUT_LIN
from llamavk_tpu_torch.ops import q4_matmul as tq4
from llamavk_tpu_torch.ops import qweight as tqw

jq4 = sys.modules["llamavk_tpu.ops.q4_matmul"]
torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parent.parent


def _bf16(a):
    j = jnp.asarray(a, jnp.bfloat16)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(torch.bfloat16)


def _weights(k, n, seed):
    """A Q4_0 ilv weight for both packages (bf16 scales)."""
    w = (np.random.default_rng(seed).standard_normal((n, k)) * 0.1).astype(np.float32)
    pk = repack_q4_0(*quantize_q4_0(w))
    return (jops.qweight_from_packed(pk, scale_dtype=jnp.bfloat16),
            tqw.qweight_from_packed(pk, scale_dtype=torch.bfloat16, device="cpu"))


def _sum_order_limit(x, qw):
    """G * 2^-24 * sum_g |d * sx * s| per element: two f32 sums of the same
    G products (d exact on both sides) in different orders."""
    xq, sx = tq4.quantize_act_blocks(x.reshape(-1, qw.k).to(torch.bfloat16))
    d = torch.einsum("mgb,mgn->gbn", xq.double(), tq4._nibbles(qw.packed, qw.g).double())
    terms = (d * sx.double()[:, :, None] * qw.scales.double()[:, None, :]).abs().sum(0)
    return qw.g * 2.0**-24 * terms.numpy()


@pytest.mark.parametrize("b,k", [(5, 256), (16, 4096)])
def test_quantize_act_blocks_matches_jit(b, k):
    """xq and sx bit-equal to the jitted JAX function (whose amax / 127 XLA
    compiles as a multiplication by f32(1/127)), with an all-zero block
    (sx = 1), ties at .5 after scaling, and wide and narrow blocks."""
    rng = np.random.default_rng(k)
    block_scale = rng.choice([0.01, 1.0, 30.0], (b, k // 32, 1)).repeat(32, 2).reshape(b, k)
    x = rng.standard_normal((b, k)) * block_scale
    x[0, :32] = 0.0
    x[1, :32] = np.arange(32) - 16.0  # amax 16: x / sx lands on .5 steps
    xj, xt = _bf16(x)
    want = jax.jit(jq4.quantize_act_blocks)(xj)
    got = tq4.quantize_act_blocks(xt)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert float(got[1][0, 0]) == 1.0


@pytest.mark.parametrize("b,k,n", [(1, 128, 256), (8, 256, 384), (16, 192, 128)])
def test_q4_matmul_i8_ref_matches_jax(b, k, n):
    """tests/test_ops.py:133-142's shapes: the plain K5 within the sum-order
    bound of the JAX interpret kernel, and through q4_matmul's i8 route."""
    jqw, tw = _weights(k, n, b)
    xj, xt = _bf16(np.random.default_rng(1).standard_normal((b, k)))
    want = np.asarray(jops.q4_matmul(xj, jqw, out_dtype=jnp.float32, dot_mode="i8"))
    got = tq4.q4_matmul_i8_ref(xt, tw)
    assert got.dtype == torch.float32 and tuple(got.shape) == (b, n)
    assert (np.abs(got.numpy() - want) <= _sum_order_limit(xt, tw)).all()
    routed = tq4.q4_matmul(xt, tw, out_dtype=torch.float32, dot_mode="i8")
    torch.testing.assert_close(routed, got, rtol=0, atol=0)


def test_q4_matmul_i8_stacked_layer_select():
    """A stacked [L, K/2, N] weight through layer_idx (tests/test_ops.py:145-164)."""
    k, n, layers = 128, 256, 3
    pairs = [_weights(k, n, 10 + l) for l in range(layers)]
    jst = jax.tree.map(lambda *a: jnp.stack(a), *[j for j, _ in pairs])
    tst = tqw.QWeight(packed=torch.stack([t.packed for _, t in pairs]),
                      scales=torch.stack([t.scales for _, t in pairs]))
    xj, xt = _bf16(np.random.default_rng(2).standard_normal((4, k)))
    for l in range(layers):
        want = np.asarray(jops.q4_matmul(xj, jst, out_dtype=jnp.float32, dot_mode="i8",
                                         layer_idx=jnp.int32(l)))
        got = tq4.q4_matmul(xt, tst, out_dtype=torch.float32, layer_idx=l, dot_mode="i8")
        assert (np.abs(got.numpy() - want) <= _sum_order_limit(xt, pairs[l][1])).all()


def _jax_gate(b, k, n):
    """The JAX route gate (q4_matmul.py:649-666 there) for a Q4_0 ilv weight."""
    return b <= jq4._I8_MAX_B and jq4._fit_bn_i8(
        min(jq4._pick_bn(b), jq4._round_up(n, 128)), k // 2, k // 32,
        jq4._round_up(max(b, 8), 8)) > 0


def test_i8_route_matches_jax_gate():
    """Over b = 1..65 and the 7B widths, K = 11008 among them (w2 leaves K5
    once b > 16), and two small ones: the port routes where the JAX package
    does, and fits the same tile."""
    shapes = [(4096, 12288), (4096, 4096), (4096, 22016), (11008, 4096), (4096, 32000),
              (128, 256), (8192, 28672)]
    for k, n in shapes:
        qw = tqw.QWeight(packed=torch.zeros((k // 2, n), dtype=torch.int8),
                         scales=torch.zeros((k // 32, n)))
        for b in (1, 2, 4, 8, 9, 16, 17, 24, 32, 33, 48, 63, 64, 65):
            assert tq4.i8_route("i8", b, k, n, qw) == _jax_gate(b, k, n), (b, k, n)
            bp = -(-max(b, 8) // 8) * 8
            assert tq4.fit_bn_i8(512, k // 2, k // 32, bp) == jq4._fit_bn_i8(512, k // 2, k // 32,
                                                                           bp)
            assert not tq4.i8_route("bf16", b, k, n, qw)
    assert tq4.i8_route("i8", 16, 11008, 4096, qw) and not tq4.i8_route("i8", 17, 11008, 4096, qw)
    # a Q4_1 weight (bias) and the lin layout stay on K1
    w = (np.random.default_rng(0).standard_normal((256, 128)) * 0.1).astype(np.float32)
    q41 = tqw.qweight_from_packed(repack_q4_1(*quantize_q4_1(w)), device="cpu")
    lin = tqw.qweight_from_packed(repack_q4_0(*quantize_q4_0(w), layout=LAYOUT_LIN), device="cpu")
    assert not tq4.i8_route("i8", 4, 128, 256, q41)
    assert not tq4.i8_route("i8", 4, 128, 256, lin)


@pytest.mark.parametrize("mode", ["bf16", "i4", "i8", "f32", "other", "mul-bf16"])
def test_dot_modes(mode, monkeypatch):
    """bf16 (the default) and i4 take K1's plain version (i4 is the TPU's
    int4-bitcast unpack of the same bytes, the same numbers); i8 takes K5's
    where the route says so; the f32 dot takes K1's plain version with the
    f32 weight q * s (not the bf16 dot's numbers), and LLAMAVK_Q4_MUL=bf16
    K1's with bf16-rounded scales, which over this bf16 scale plane is the
    default's result bit for bit. Each as a per-call argument and from the
    environment alike; unknown modes raise NotImplementedError."""
    _, tw = _weights(128, 256, 3)
    _, xt = _bf16(np.random.default_rng(4).standard_normal((2, 128)))
    k1 = tq4.q4_matmul_ref(xt, tw, torch.float32)
    if mode == "mul-bf16":
        want = tq4.q4_matmul_ref(xt, tw, torch.float32, mul_dtype=torch.bfloat16)
        torch.testing.assert_close(want, k1, rtol=0, atol=0)
        got = tq4.q4_matmul(xt, tw, torch.float32, mul_dtype=torch.bfloat16)
        torch.testing.assert_close(got, want, rtol=0, atol=0)
        monkeypatch.setattr(tq4, "ENV_MUL", "bf16")  # as if read from the environment
        torch.testing.assert_close(tq4.q4_matmul(xt, tw, torch.float32), want, rtol=0, atol=0)
        return
    if mode == "other":
        with pytest.raises(NotImplementedError, match="dot mode"):
            tq4.q4_matmul(xt, tw, torch.float32, dot_mode=mode)
        monkeypatch.setattr(tq4, "ENV_DOT", mode)  # as if read from the environment
        with pytest.raises(NotImplementedError):
            tq4.q4_matmul(xt, tw, torch.float32)
        return
    got = tq4.q4_matmul(xt, tw, torch.float32, dot_mode=mode)
    if mode == "i8":
        want = tq4.q4_matmul_i8_ref(xt, tw)
    elif mode == "f32":
        want = tq4.q4_matmul_ref(xt, tw, torch.float32, dot_mode="f32")
        assert not torch.equal(want, k1)
    else:
        want = k1
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    monkeypatch.setattr(tq4, "ENV_DOT", mode)
    torch.testing.assert_close(tq4.q4_matmul(xt, tw, torch.float32), want, rtol=0, atol=0)


# One process under LLAMAVK_Q4_DOT=i8: both packages read the variable at
# import, and the JAX jit caches would ignore a monkeypatch.
_I8_CHILD = r"""
import json, sys
import numpy as np, torch
torch.set_num_threads(2)
import jax.numpy as jnp
from llamavk_tpu.models import llama as jm, loader as jl
from llamavk_tpu.runtime.speculative import LookupEngine as JLookup, SpecConfig as JSpec
from llamavk_tpu_torch.models import llama as tm, loader as tl
from llamavk_tpu_torch.ops import q4_matmul as tq4
from llamavk_tpu_torch.runtime.speculative import LookupEngine, SpecConfig
path, prompt = sys.argv[1], json.loads(sys.argv[2])
jl.random_tiny_model(write_path=path, quantize=True)
jcfg, jparams, _ = jl.load_model(path)
cfg, params, _ = tl.load_model(path, device="cpu")
calls = []
orig = tq4.q4_matmul_i8_ref
tq4.q4_matmul_i8_ref = lambda *a, **k: calls.append(1) or orig(*a, **k)
jlog = jm.llama_forward(jparams, jnp.asarray([prompt]), jm.init_kv_cache(jcfg, 1, 64), 0, jcfg,
                        logits_all=True)[0]
tlog = tm.llama_forward(params, torch.tensor([prompt]), tm.init_kv_cache(cfg, 1, 64, device="cpu"),
                        0, cfg, logits_all=True)[0]
k5_calls = len(calls)
jout = JLookup(jcfg, jparams, JSpec(n_ctx=128, gamma=4, rounds_per_block=2)).generate(
    prompt, 4, ignore_eos=True)
tout = LookupEngine(cfg, params, SpecConfig(n_ctx=128, gamma=4, rounds_per_block=2),
                    device="cpu").generate(prompt, 4, ignore_eos=True)
top2 = torch.topk(tlog[0, -1], 2).values
# K5 over an f32 scale plane (scales off the bf16 grid), as perplexity --f32
# loads it: the plain version against the JAX kernel (interpret mode) at
# M = 1 and 4, each element's error over K5's limit
import dataclasses
import llamavk_tpu.ops.q4_matmul
from llamavk_tpu import ops as jops
from llamavk_tpu.formats import quantize_q4_0, repack_q4_0
from llamavk_tpu_torch.ops import qweight as tqw
pk = repack_q4_0(*quantize_q4_0((np.random.default_rng(9).standard_normal((256, 128)) * 0.1)
                                .astype(np.float32)))
pk = dataclasses.replace(pk, scales=pk.scales * np.float32(1.001))
jqw = jops.qweight_from_packed(pk, scale_dtype=jnp.float32)
tw = tqw.qweight_from_packed(pk, scale_dtype=torch.float32, device="cpu")
f32_ratio = 0.0
for m in (1, 4):
    xj = jnp.asarray(np.random.default_rng(m).standard_normal((m, 128)), jnp.bfloat16)
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(torch.bfloat16)
    want = np.asarray(jops.q4_matmul(xj, jqw, out_dtype=jnp.float32, dot_mode="i8"))
    got = tq4.q4_matmul(xt, tw, torch.float32).double()
    xq, sx = tq4.quantize_act_blocks(xt)
    d = torch.einsum("mgb,mgn->gbn", xq.double(), tq4._nibbles(tw.packed, tw.g).double())
    terms = d * sx.double()[:, :, None] * tw.scales.double()[:, None, :]
    limit = tw.g * 2.0**-24 * terms.abs().sum(0)
    f32_ratio = max(f32_ratio, float(((got - torch.from_numpy(want).double()).abs() / limit).max()))
# the perplexity --f32 route on the tiny file at 8 rows: f32 scales reach K5
from llamavk_tpu_torch.cli.perplexity import make_chunk_nll
_, fparams, _ = tl.load_model(path, device="cpu", scale_dtype=torch.float32,
                              dense_dtype=torch.float32)
calls.clear()
nll = make_chunk_nll(cfg, 8, dtype=torch.float32, attn_impl="einsum")(fparams,
                                                                      torch.tensor([prompt]))
print(json.dumps({"mode": tq4.ENV_DOT, "k5_calls": k5_calls,
                  "max_abs": float(np.abs(np.asarray(jlog) - tlog.numpy()).max()),
                  "top2_gap": float(top2[0] - top2[1]), "jax": jout, "port": tout,
                  "f32_scales_ratio": f32_ratio, "f32_k5_calls": len(calls),
                  "f32_nll_finite": bool(torch.isfinite(nll).all())}))
"""


# Both packages keep bf16 activations and may round one a bf16 ulp apart (the
# bf16 dot's logits then sit within 0.032, tests/test_torch_model.py); under
# the int8 dot that activation can also quantize one int8 step apart, 1/127
# of its block's largest value, up to twice its bf16 ulp: twice the bf16
# dot's tolerance.
I8_LOGIT_TOL = 0.064


def test_i8_forward_and_lookup_match_jax(tmp_path):
    """Under LLAMAVK_Q4_DOT=i8: every matmul of a tiny 8-token forward takes
    K5's plain version (the 4 per layer and the output, at b = 8), the
    logits sit within I8_LOGIT_TOL of the JAX package's, and a 4-token lookup
    stream (its first token's top-2 gap far above that) equals the JAX
    LookupEngine's. K5 over an f32 scale plane is within its limit of the
    JAX kernel at M = 1 and 4, and perplexity --f32's chunk (f32 scales, 8
    rows) takes it for every matmul."""
    prompt = [46, 189, 194, 46, 189, 194, 46, 189]
    env = dict(os.environ, LLAMAVK_Q4_DOT="i8", JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join(filter(None, [str(ROOT), os.environ.get("PYTHONPATH")])))
    proc = subprocess.run([sys.executable, "-c", _I8_CHILD, str(tmp_path / "tiny.bin"),
                           json.dumps(prompt)], cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["mode"] == "i8"
    assert res["k5_calls"] == 4 * 2 + 1  # tiny model: 2 layers, fused wqkv and w13
    assert res["max_abs"] <= I8_LOGIT_TOL
    assert res["top2_gap"] > 4 * I8_LOGIT_TOL
    assert res["port"] == res["jax"] and len(res["port"]) == 4
    assert res["f32_scales_ratio"] <= 1.0
    assert res["f32_k5_calls"] == 4 * 2 + 1 and res["f32_nll_finite"]
