"""K1's layout and numerics modes in the port against the JAX package on the
CPU: the lin layout, the f32 dot (LLAMAVK_Q4_DOT=f32) and the bf16
nibble-scale multiply (LLAMAVK_Q4_MUL=bf16, or `mul_dtype`), for Q4_0 and
Q4_1 weights with bf16 and f32 scale planes.

The JAX references run in Pallas interpret mode and are compiled without
XLA's excess precision (`xla_allow_excess_precision`): XLA:CPU otherwise
keeps the ilv branch's bf16 product q * s in f32 (its lin branch rounds),
where the kernel as written, and a TPU, round it to bf16. The mode tests run
in one child process under LLAMAVK_Q4_DOT=f32, which both packages read at
import. Inputs come from seeded NumPy."""

import dataclasses
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

from llamavk_tpu import ops as jops
from llamavk_tpu.formats import quantize_q4_0, repack_q4_0
from llamavk_tpu.models import llama as jm
from llamavk_tpu.models import loader as jl
from llamavk_tpu_torch.models import llama as tm
from llamavk_tpu_torch.models import loader as tl
from llamavk_tpu_torch.ops import q4_matmul as tq4
from llamavk_tpu_torch.ops import qweight as tqw

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parent.parent
NO_EXCESS = {"xla_allow_excess_precision": False}
PROMPT = [1, 5, 9, 2, 30, 7, 3, 11]
# both sides keep bf16 activations: two bf16 ulps of the tiny model's
# logits (below 4 in magnitude), as tests/test_torch_model.py
LOGIT_TOL = 0.032


def _jax_arrays(params) -> dict[str, np.ndarray]:
    flat, _ = jax.tree_util.tree_flatten_with_path(params)
    return {".".join(p.name for p in path): np.asarray(leaf) for path, leaf in flat}


def _port_cfg(cfg) -> tm.ModelConfig:
    return tm.ModelConfig(**{f.name: getattr(cfg, f.name)
                             for f in dataclasses.fields(tm.ModelConfig)})


@pytest.mark.parametrize("layout", ["ilv", "lin"])
@pytest.mark.parametrize("scales", ["bf16", "f32"])
def test_mul_bf16_weight_bits(layout, scales):
    """The weight each mode feeds the dot, read through an identity x (one
    product per output, exact): under mul_dtype=bf16 the port's plain K1 and
    the JAX kernel give the same bits, bf16(f32(q) * bf16(s)); over a bf16
    scale plane those are the default's bits; over an f32 plane (scales
    off the bf16 grid) they are not. The default multiply's bits agree too."""
    k, n = 128, 256
    w = (np.random.default_rng(5).standard_normal((n, k)) * 0.1).astype(np.float32)
    pk = repack_q4_0(*quantize_q4_0(w), layout=layout)
    if scales == "f32":
        pk = dataclasses.replace(pk, scales=pk.scales * np.float32(1.001))
    jqw = jops.qweight_from_packed(pk, scale_dtype=jnp.bfloat16 if scales == "bf16"
                                   else jnp.float32)
    tw = tqw.qweight_from_packed(pk, scale_dtype=torch.bfloat16 if scales == "bf16"
                                 else torch.float32, device="cpu")
    eye = np.eye(k, dtype=np.float32)
    bits = {}
    for mul, jmul, tmul in (("f32", jnp.float32, torch.float32),
                            ("bf16", jnp.bfloat16, torch.bfloat16)):
        fn = jax.jit(lambda x, qw, m=jmul: jops.q4_matmul(x, qw, out_dtype=jnp.float32,
                                                          mul_dtype=m))
        xj = jnp.asarray(eye, jnp.bfloat16)
        want = np.asarray(fn.lower(xj, jqw).compile(compiler_options=NO_EXCESS)(xj, jqw))
        got = tq4.q4_matmul(torch.from_numpy(eye), tw, torch.float32, mul_dtype=tmul).numpy()
        np.testing.assert_array_equal(got, want, err_msg=mul)
        np.testing.assert_array_equal(got, tq4.mode_weight(tw, "bf16", tmul).numpy())
        bits[mul] = got
    assert np.array_equal(bits["bf16"], bits["f32"]) == (scales == "bf16")


def test_synthetic_params_lin():
    """synthetic_params(layout="lin") at tiny size: every weight plane is
    lin with the ilv build's bytes (the same seed), and a forward through
    them is finite and differs from the ilv one (the layouts place the same
    bytes at other k)."""
    cfg = tm.ModelConfig(n_vocab=256, n_embd=128, n_layer=2, n_head=2, n_rot=64, n_ff=256)
    lin = tl.synthetic_params(cfg, seed=3, device="cpu", layout="lin")
    ilv = tl.synthetic_params(cfg, seed=3, device="cpu")
    for name in ("wqkv", "wo", "w13", "w2"):
        a, b = getattr(lin.layers, name), getattr(ilv.layers, name)
        assert a.layout == "lin" and b.layout == "ilv"
        assert torch.equal(a.packed, b.packed) and torch.equal(a.scales, b.scales)
    assert lin.output.layout == "lin"
    with pytest.raises(NotImplementedError):
        tl.synthetic_params(cfg, device="cpu", layout="i4")
    logits = {}
    for name, params in (("lin", lin), ("ilv", ilv)):
        cache = tm.init_kv_cache(cfg, 1, 32, device="cpu")
        logits[name] = tm.llama_forward(params, torch.tensor([PROMPT]), cache, 0, cfg)[0]
    assert torch.isfinite(logits["lin"]).all()
    assert not torch.equal(logits["lin"], logits["ilv"])


@pytest.fixture(scope="module")
def tiny_path(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("tiny") / "tiny-q4.bin")
    jl.random_tiny_model(write_path=path, quantize=True)
    return path


@pytest.mark.parametrize("layout,scales", [("lin", "bf16"), ("lin", "f32")])
def test_forward_lin_and_f32_scales_match_jax(tiny_path, layout, scales):
    """The tiny file loaded by both packages with lin planes and/or f32
    scale planes: the port's loader gives the JAX loader's bytes, the JAX
    params carried across with params_from_arrays keep them, and an 8-token
    forward of each matches the JAX forward (interpret mode) within
    LOGIT_TOL."""
    jsd, tsd = (jnp.float32, torch.float32) if scales == "f32" else (jnp.bfloat16, torch.bfloat16)
    jcfg, jparams, _ = jl.load_model(tiny_path, layout=layout, scale_dtype=jsd)
    cfg, loaded, _ = tl.load_model(tiny_path, device="cpu", layout=layout, scale_dtype=tsd)
    arrays = _jax_arrays(jparams)
    carried = tl.params_from_arrays(arrays, _port_cfg(jcfg), device="cpu", layout=layout)
    for name in ("wqkv", "wo", "w13", "w2"):
        for plane in ("packed", "scales"):
            want = arrays[f"layers.{name}.{plane}"]
            for params in (loaded, carried):
                got = getattr(getattr(params.layers, name), plane)
                assert got.dtype == (torch.int8 if plane == "packed" else tsd)
                np.testing.assert_array_equal(got.float().numpy(), want.astype(np.float32))
        assert getattr(loaded.layers, name).layout == layout
    fwd = jax.jit(jm.llama_forward, static_argnames=("cfg", "logits_all"))
    want = np.asarray(fwd(jparams, jnp.asarray([PROMPT], jnp.int32), jm.init_kv_cache(jcfg, 1, 32),
                          jnp.int32(0), jcfg, logits_all=True)[0])
    for params in (loaded, carried):
        got = tm.llama_forward(params, torch.tensor([PROMPT]), tm.init_kv_cache(cfg, 1, 32,
                                                                               device="cpu"),
                               0, cfg, logits_all=True)[0]
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=LOGIT_TOL)


# One process under LLAMAVK_Q4_DOT=f32 (both packages read it at import, and
# the JAX kernel reads it when traced), compiled without excess precision.
_MODES_CHILD = r"""
import dataclasses, itertools, json, sys
import numpy as np, torch
torch.set_num_threads(2)
import jax, jax.numpy as jnp
import llamavk_tpu.ops.q4_matmul
from llamavk_tpu import ops as jops
from llamavk_tpu.formats import quantize_q4_0, quantize_q4_1, repack_q4_0, repack_q4_1
from llamavk_tpu.models import llama as jm, loader as jl
from llamavk_tpu.runtime import engine as je, sampling as js
from llamavk_tpu_torch.models import llama as tm, loader as tl
from llamavk_tpu_torch.ops import q4_matmul as tq4, qweight as tqw
from llamavk_tpu_torch.runtime import engine as te, sampling as ts
jq4 = sys.modules["llamavk_tpu.ops.q4_matmul"]
path, prompt = sys.argv[1], json.loads(sys.argv[2])
n_predict, n_ctx = int(sys.argv[3]), int(sys.argv[4])
K, N = 128, 256
rng = np.random.default_rng(11)
w = (rng.standard_normal((N, K)) * 0.1).astype(np.float32)
cases = []
for layout, q41, f32s in itertools.product(("ilv", "lin"), (False, True), (False, True)):
    pk = (repack_q4_1(*quantize_q4_1(w), layout=layout) if q41
          else repack_q4_0(*quantize_q4_0(w), layout=layout))
    if f32s:  # scales off the bf16 grid
        pk = dataclasses.replace(pk, scales=pk.scales * np.float32(1.001))
    jqw = jops.qweight_from_packed(pk, scale_dtype=jnp.float32 if f32s else jnp.bfloat16)
    tw = tqw.qweight_from_packed(pk, scale_dtype=torch.float32 if f32s else torch.bfloat16,
                                 device="cpu")
    for m in (1, 8, 40):
        xj = jnp.asarray(rng.standard_normal((m, K)), jnp.bfloat16)
        xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(torch.bfloat16)
        for mul in ("f32", "bf16"):
            jmul, tmul = ((jnp.float32, torch.float32) if mul == "f32"
                          else (jnp.bfloat16, torch.bfloat16))
            want = np.asarray(jops.q4_matmul(xj, jqw, out_dtype=jnp.float32, mul_dtype=jmul))
            got = tq4.q4_matmul(xt, tw, torch.float32, mul_dtype=tmul)
            call = tq4.q4_matmul(xt, tw, torch.float32, dot_mode="f32", mul_dtype=tmul)
            # L(x, w) = 2 K 2^-24 sum_k |x w| (the Q4_1 bias term's products too)
            mag = xt.double().abs() @ tq4.mode_weight(tw, "f32", tmul).double().abs()
            if tw.bias is not None:
                mag = mag + (tq4._bias_term(xt.abs(), tqw.QWeight(tw.packed, tw.scales,
                                                                   tw.bias.abs())).double())
            limit = 2 * K * 2.0**-24 * mag
            cases.append({"case": [layout, q41, f32s, m, mul],
                          "ratio": float(((got.double() - torch.from_numpy(want).double()).abs()
                                          / limit).max()),
                          "call_equal_env": bool(torch.equal(call, got))})
# a tiny greedy stream through both engines (n_ctx below every default KV
# block, so both sum each softmax over one block) and the logits along it
jcfg, jparams, _ = jl.load_model(path)
cfg, params, _ = tl.load_model(path, device="cpu")
jout = je.Engine(jcfg, jparams, je.EngineConfig(n_ctx=n_ctx)).generate(
    prompt, n_predict, js.SamplerParams(temp=0.0), ignore_eos=True)
tout = te.Engine(cfg, params, te.EngineConfig(n_ctx=n_ctx), device="cpu").generate(
    prompt, n_predict, ts.SamplerParams(temp=0.0), ignore_eos=True)
fwd = jax.jit(jm.llama_forward, static_argnames=("cfg", "logits_all"))
seq = prompt + tout
jlog = np.asarray(fwd(jparams, jnp.asarray([seq], jnp.int32), jm.init_kv_cache(jcfg, 1, n_ctx),
                      jnp.int32(0), jcfg, logits_all=True)[0])
tlog = tm.llama_forward(params, torch.tensor([seq]), tm.init_kv_cache(cfg, 1, n_ctx, device="cpu"),
                        0, cfg, logits_all=True)[0].numpy()
steps = tlog[0, len(prompt) - 1 : len(seq) - 1]
top2 = np.sort(steps, axis=-1)[:, -2:]
print(json.dumps({"dot": [tq4.ENV_DOT, jq4._ENV_DOT], "cases": cases, "jax": jout, "port": tout,
                  "max_abs": float(np.abs(jlog - tlog).max()),
                  "min_top2_gap": float((top2[:, 1] - top2[:, 0]).min())}))
"""


@pytest.fixture(scope="module")
def engine_path(tmp_path_factory):
    """The model of tests/test_torch_engine.py, whose greedy stream from its
    prompt has no near tie in 16 steps."""
    path = str(tmp_path_factory.mktemp("tiny219") / "tiny-q4.bin")
    jl.random_tiny_model(seed=219, write_path=path, quantize=True)
    return path


def test_f32_dot_modes_match_jax(engine_path):
    """Under LLAMAVK_Q4_DOT=f32: K1's plain version against the JAX kernel
    in interpret mode for ilv and lin, Q4_0 and Q4_1, bf16 and f32 scales,
    M = 1, 8, 40 and the f32 and bf16 multiplies (per call in both packages),
    each within L(x, w); the per-call f32 dot equal to the environment's;
    and a 16-token greedy stream of the port's Engine equal to the JAX
    Engine's, the logits along it within LOGIT_TOL, every top-2 gap on it
    above 4 LOGIT_TOL."""
    prompt = [1, 28, 171, 252, 203, 125, 195, 227]  # tests/test_torch_engine.py's
    env = dict(os.environ, LLAMAVK_Q4_DOT="f32", JAX_PLATFORMS="cpu",
               XLA_FLAGS=" ".join(filter(None, [os.environ.get("XLA_FLAGS"),
                                                "--xla_allow_excess_precision=false"])),
               PYTHONPATH=os.pathsep.join(filter(None, [str(ROOT), os.environ.get("PYTHONPATH")])))
    proc = subprocess.run([sys.executable, "-c", _MODES_CHILD, engine_path, json.dumps(prompt),
                           "16", "64"], cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["dot"] == ["f32", "f32"]
    assert len(res["cases"]) == 48
    for c in res["cases"]:
        assert c["ratio"] <= 1.0 and c["call_equal_env"], c
    assert res["port"] == res["jax"] and len(res["port"]) == 16
    assert res["max_abs"] <= LOGIT_TOL
    assert res["min_top2_gap"] > 4 * LOGIT_TOL
