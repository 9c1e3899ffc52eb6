"""The port's history-ring KV cache on the CPU against the JAX package's:
`ring_phys`, the ring modes of the attention's plain versions against the
Pallas kernels in interpret mode (the position-plane mask with empty rows,
the write at the physical row, bf16 and int8), `llama_forward` across the
wrap, `Engine(ctx_ring=True)` greedy streams past the wrap, eval chunking
with save/restore, and `generate --ctx-swap ring` against the JAX CLI."""

import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llamavk_tpu.cli import generate as jcli
from llamavk_tpu.models import llama as jm
from llamavk_tpu.models import loader as jl
from llamavk_tpu.ops import flash_attn as jfa
from llamavk_tpu.ops.kv_quant import quantize_rows as jquant
from llamavk_tpu.runtime import engine as je
from llamavk_tpu.runtime import sampling as js
from llamavk_tpu_torch.cli import generate as tcli
from llamavk_tpu_torch.models import llama as tm
from llamavk_tpu_torch.models import loader as tl
from llamavk_tpu_torch.ops import flash_attn as tfa
from llamavk_tpu_torch.runtime import engine as te
from llamavk_tpu_torch.runtime import sampling as ts

torch.set_num_threads(2)

# the JAX package's kernel-vs-dense tolerance (tests/test_ring.py); the
# plain version is that dense softmax with the kernel's rounding points
ATTN_TOL = dict(rtol=2e-2, atol=2e-2)
# the port's logits sit within two bf16 ulps of the JAX package's on the
# tiny model (tests/test_torch_model.py)
LOGIT_TOL = dict(rtol=0, atol=0.032)
N_CTX, KEEP = 32, 4
# a 20-token prompt and 20 greedy tokens wrap the 32-row ring at the 13th
# (the JAX Pallas kernels run in interpret mode: each step costs ~0.5 s);
# on the seed-0 tiny model every top-2 logit gap of this stream stays above
# 0.14 (bf16 and int8 KV), over four times LOGIT_TOL, and its last tokens
# change after the wrap
PROMPT = [int(x) for x in np.random.default_rng(103).integers(3, 250, 20)]
N_GEN = 20
GREEDY_T = ts.SamplerParams(temp=0.0)
GREEDY_J = js.SamplerParams(temp=0.0)


def _bf16(rng, shape):
    """One bf16 array for both frameworks (rounded once, by JAX)."""
    j = jnp.asarray(rng.standard_normal(shape), jnp.bfloat16)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(torch.bfloat16)


def _plane(n_logical: int, s: int, keep: int, b: int = 1) -> np.ndarray:
    """The position plane [S, B] an engine leaves after n_logical positions."""
    pos = np.full((s, b), -1, np.int32)
    for p in range(n_logical):
        pos[int(jm.ring_phys(jnp.int32(p), keep, s))] = p
    return pos


@pytest.fixture(scope="module")
def tiny_path(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("tiny") / "tiny-q4.bin")
    jl.random_tiny_model(write_path=path, quantize=True)
    return path


@pytest.fixture(scope="module")
def models(tiny_path):
    jcfg, jparams, _ = jl.load_model(tiny_path)
    tcfg, tparams, _ = tl.load_model(tiny_path, device="cpu")
    return jcfg, jparams, tcfg, tparams


def test_ring_phys_matches_jax():
    s, keep = 32, 4
    want = [int(jm.ring_phys(jnp.int32(p), keep, s)) for p in range(80)]
    assert [tm.ring_phys(p, keep, s) for p in range(80)] == want
    assert tm.ring_phys(torch.arange(80), keep, s).tolist() == want


def _empty_rows_plane(s: int) -> np.ndarray:
    """Only rows 32..36 hold positions 0..4 (tests/test_ring.py:71-90): a
    whole leading block is empty for every query."""
    pos = np.full((s, 1), -1, np.int32)
    pos[32:37, 0] = np.arange(5)
    return pos


@pytest.mark.parametrize("case", ["wrapped", "empty_rows"])
def test_ring_read_matches_jax(case):
    """K3's ring mode (the whole ring scanned) against the JAX kernel:
    rows 8..13 of a 64-row ring (keep 8) holding positions 64..69 of a
    wrapped history, B = 2; and a plane whose first block is empty."""
    rng = np.random.default_rng(3 if case == "wrapped" else 4)
    b, h, s, d = (2, 2, 64, 32) if case == "wrapped" else (1, 2, 64, 32)
    n_past = 70 if case == "wrapped" else 4
    pos = np.tile(_plane(70, s, 8), (1, b)) if case == "wrapped" else _empty_rows_plane(s)
    qj, qt = _bf16(rng, (b, 1, h, d))
    kj, kt = _bf16(rng, (b, h, s, d))
    vj, vt = _bf16(rng, (b, h, s, d))
    want = jfa.flash_attention(qj, kj, vj, jnp.int32(n_past), block_t=32, block_k=32,
                               kv_pos=jnp.asarray(pos))
    got = tfa.flash_attention(qt, kt[None], vt[None], n_past, block_k=32,
                              kv_pos=torch.from_numpy(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ATTN_TOL)


# the bf16 and int8 cases keep the ids they had as quant=False/True
@pytest.mark.parametrize("kv", ["bfloat16", "int8", "float32"], ids=["False", "True", "float32"])
def test_ring_update_matches_jax(kv):
    """K2's ring mode: T = 4 rows written at physical rows [write_row,
    write_row + 4) of a wrapped 64-row ring while n_past stays logical; the
    caches (int8: data and scales; f32: the rows as they arrive) byte-equal
    to the JAX kernel's."""
    quant = kv == "int8"
    rng = np.random.default_rng(11 + quant + 2 * (kv == "float32"))
    L, b, t, h, s, d, keep = 2, 1, 4, 2, 64, 32, 8
    n_past = 100
    wrow = int(jm.ring_phys(jnp.int32(n_past), keep, s))
    pos = _plane(n_past + t, s, keep)
    qj, qt = _bf16(rng, (b, t, h, d))
    knj, knt = _bf16(rng, (b, t, h, d))
    vnj, vnt = _bf16(rng, (b, t, h, d))
    kj, kt = _bf16(rng, (L, b, h, s, d))
    vj, vt = _bf16(rng, (L, b, h, s, d))
    kw_j = dict(kv_pos=jnp.asarray(pos), write_row=jnp.int32(wrow), ring_bounded=True,
                block_k=32)
    kw_t = dict(kv_pos=torch.from_numpy(pos), write_row=wrow, ring_bounded=True, block_k=32)
    if quant:
        kq, ks = jquant(kj)
        vq, vs = jquant(vj)
        ks, vs = ks.transpose(0, 1, 3, 2), vs.transpose(0, 1, 3, 2)  # [L, B, S, H]
        want = jfa.flash_attention_update(qj, knj, vnj, kq, vq, jnp.int32(n_past), jnp.int32(1),
                                          k_scale=ks, v_scale=vs, **kw_j)
        tc = [torch.from_numpy(np.array(x)) for x in (kq, vq, ks, vs)]
        got = tfa.flash_attention_update(qt, knt, vnt, tc[0], tc[1], n_past, 1,
                                         k_scale=tc[2], v_scale=tc[3], **kw_t)
    elif kv == "float32":  # an f32 ring: the JAX kernel widens q and the rows
        kf, vf = kj.astype(jnp.float32), vj.astype(jnp.float32)
        want = jfa.flash_attention_update(qj, knj, vnj, kf, vf, jnp.int32(n_past), jnp.int32(1),
                                          **kw_j)
        got = tfa.flash_attention_update(qt, knt, vnt, kt.float(), vt.float(), n_past, 1, **kw_t)
    else:
        want = jfa.flash_attention_update(qj, knj, vnj, kj, vj, jnp.int32(n_past), jnp.int32(1),
                                          **kw_j)
        got = tfa.flash_attention_update(qt, knt, vnt, kt, vt, n_past, 1, **kw_t)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g.float().numpy(), np.asarray(w.astype(jnp.float32)))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), **ATTN_TOL)


def test_ring_forward_across_wrap(models):
    """llama_forward on a ring of 32 rows (keep 4): two 16-token chunks fill
    it, then T = 1 steps wrap it (rows 4 and 5 take positions 32 and 33);
    logits within the tolerance of the JAX forward, position planes equal."""
    jcfg, jparams, tcfg, tparams = models
    rng = np.random.default_rng(5)
    toks = rng.integers(3, 250, 34).tolist()
    fwd = jax.jit(jm.llama_forward, static_argnames=("cfg", "ring_keep"))
    jc = jm.init_kv_cache(jcfg, 1, N_CTX, ring=True)
    tc = tm.init_kv_cache(tcfg, 1, N_CTX, device="cpu", ring=True)
    n_past = 0
    for t in (16, 16, 1, 1):
        chunk = toks[n_past : n_past + t]
        jl_, jc, _ = fwd(jparams, jnp.asarray([chunk], jnp.int32), jc, jnp.int32(n_past), jcfg,
                         ring_keep=KEEP)
        tl_, tc, _ = tm.llama_forward(tparams, torch.tensor([chunk]), tc, n_past, tcfg,
                                      ring_keep=KEEP)
        np.testing.assert_allclose(tl_.numpy(), np.asarray(jl_), **LOGIT_TOL)
        np.testing.assert_array_equal(tc.pos.numpy(), np.asarray(jc.pos))
        n_past += t
    assert tc.pos[4:6, 0].tolist() == [32, 33]


@pytest.fixture(scope="module")
def jax_ring_streams(models):
    """The JAX Engine's greedy streams past the wrap (n_ctx 32, keep 4),
    bf16, int8 and f32 KV."""
    jcfg, jparams, _, _ = models
    out = {}
    for kv in ("bfloat16", "int8", "float32"):
        eng = je.Engine(jcfg, jparams, je.EngineConfig(n_ctx=N_CTX, ctx_ring=True,
                                                       ring_keep=KEEP, kv_dtype=kv,
                                                       decode_block=8))
        out[kv] = eng.generate(PROMPT, N_GEN, GREEDY_J, ignore_eos=True)
        assert eng.n_past > N_CTX
    return out


@pytest.mark.parametrize("kv", ["bfloat16", "int8", "float32"])
def test_ring_engine_matches_jax(models, jax_ring_streams, kv):
    _, _, tcfg, tparams = models
    eng = te.Engine(tcfg, tparams, te.EngineConfig(n_ctx=N_CTX, ctx_ring=True, ring_keep=KEEP,
                                                   kv_dtype=kv, decode_block=8), device="cpu")
    got = eng.generate(PROMPT, N_GEN, GREEDY_T, ignore_eos=True)
    assert eng.n_past > N_CTX and eng.cache.pos is not None
    assert got == jax_ring_streams[kv]


def test_ring_decode_keeps_the_window(models):
    """After 22 tokens (a last block of 5) the plane holds exactly the pinned
    rows and the last 28 positions: the port decodes exactly the budget, so
    no row of the window is overwritten by a position not yet evaluated
    (the JAX Engine snaps that block to 8 and leaves positions 41-43 in
    rows 13-15, ROADMAP queue 3)."""
    _, _, tcfg, tparams = models
    eng = te.Engine(tcfg, tparams, te.EngineConfig(n_ctx=N_CTX, ctx_ring=True, ring_keep=KEEP,
                                                   decode_block=8), device="cpu")
    eng.generate(PROMPT, 22, GREEDY_T, ignore_eos=True)
    assert eng.n_past == 41
    assert eng.cache.pos[:, 0].tolist() == _plane(41, N_CTX, KEEP)[:, 0].tolist()


def test_ring_matches_plain_before_wrap(models):
    _, _, tcfg, tparams = models
    plain = te.Engine(tcfg, tparams, te.EngineConfig(n_ctx=64), device="cpu")
    ring = te.Engine(tcfg, tparams, te.EngineConfig(n_ctx=64, ctx_ring=True, ring_keep=KEEP),
                     device="cpu")
    assert (plain.generate(PROMPT, 10, GREEDY_T, ignore_eos=True)
            == ring.generate(PROMPT, 10, GREEDY_T, ignore_eos=True))


def test_ring_eval_chunks_across_wrap(models):
    """eval of 50 tokens on a 32-row ring goes in chunks that stop at the
    ring's end (32, 16, 2: JAX engine.py:234-248), so the plane holds the
    last 28 positions after the 4 pinned ones; a continuation after
    save/restore equals the one before (tests/test_ring.py:94-132)."""
    _, _, tcfg, tparams = models
    toks = [int(x) for x in np.random.default_rng(0).integers(3, 200, 50)]
    eng = te.Engine(tcfg, tparams, te.EngineConfig(n_ctx=N_CTX, ctx_ring=True, ring_keep=KEEP),
                    device="cpu")
    logits = eng.eval(toks)
    assert eng.n_past == 50 and logits.shape == (1, tcfg.n_vocab)
    want = _plane(50, N_CTX, KEEP)[:, 0].tolist()
    assert eng.cache.pos[:, 0].tolist() == want
    assert eng.eval([7, 8, 9], logits_all=True).shape == (3, tcfg.n_vocab)
    snap = eng.save_session()
    cont1 = eng.generate([3], 6, GREEDY_T, ignore_eos=True)
    eng.reset()
    eng.restore_session(snap)
    assert torch.equal(eng.cache.pos, snap.pos)
    assert eng.generate([3], 6, GREEDY_T, ignore_eos=True) == cont1


def test_cli_ctx_swap_ring_matches_jax(tiny_path):
    """generate --ctx-swap ring -c 32 --n-keep 4: the ring absorbs the
    overflow with no swap, and the printed text equals the JAX CLI's."""
    argv = ["-m", tiny_path, "-p", "<t17><t42><t99><t3><t5>", "-n", "16", "-c", "32", "--temp",
            "0", "--ignore-eos", "--n-keep", "4", "--ctx-swap", "ring"]
    jout, tout = io.StringIO(), io.StringIO()
    assert jcli.run(jcli.build_argparser().parse_args(argv), stdout=jout) == 0
    targs = tcli.build_argparser().parse_args(argv + ["--device", "cpu"])
    assert targs.ctx_swap == "ring"
    assert tcli.run(targs, stdout=tout) == 0
    assert tout.getvalue() == jout.getvalue()
