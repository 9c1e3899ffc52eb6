"""The port's `parallel/` against the JAX single-device forward.

The tiny model of tests/test_parallel.py (n_embd 512, 8 heads, n_ff 512,
vocab 256) with 4 layers, so that 4 pipeline stages hold a layer each. The
JAX `llama_forward` runs once per module on one device (its Pallas kernels
in interpret mode); `tests/test_parallel.py` already holds the JAX sharded
forward against it. The port's sharded forward runs in two worlds of
processes over gloo on the CPU (the plain kernel versions), each spawned
once per module with its own deadline: 2 ranks (tp 2; pp 2; pp 2 with 2
microbatches) and 4 ranks (tp 2 x dp 2; pp 2 x tp 2; pp 4 with 2
microbatches). Every case prefills 4 tokens of a 4-row batch and decodes
2 more, teacher-forced, and each rank saves its logits, embeddings, cache
shard after the prefill and its count of update-kernel calls. The cases of
INT8_CASES run over an int8 cache (its [L, B, S, H] scale planes split on
H by `shard_cache`), against the port's single-device forward over an int8
cache; tests/test_torch_tp_serving.py holds the tp int8 engine's greedy
streams against the JAX single-device int8 engine's.
"""

from __future__ import annotations


import numpy as np
import pytest
import torch

from llamavk_tpu_torch.formats.ggml_io import CheckpointReader
from llamavk_tpu_torch.models import llama as tm
from llamavk_tpu_torch.models import loader as tl
from llamavk_tpu_torch.parallel import make_mesh, make_sharded_forward, multihost
from llamavk_tpu_torch.parallel import shard_cache, shard_params

torch.set_num_threads(2)

B, T, N_CTX, N_LAYER = 4, 4, 32, 4  # N_CTX: an int8 cache takes rows in 32s
DEADLINE_S = 100  # each world of ranks, spawn to exit
# (tp, dp, pp, microbatches) of each case, by world size
WORLDS = {
    2: {"tp2": (2, 1, 1, 1), "pp2": (1, 1, 2, 1), "pp2_mb2": (1, 1, 2, 2),
        "tp2_i8": (2, 1, 1, 1)},
    4: {"tp2_dp2": (2, 2, 1, 1), "pp2_tp2": (2, 1, 2, 1), "pp4_mb2": (1, 1, 4, 2)},
}
CASES = {name: world for world, cases in WORLDS.items() for name in cases}
INT8_CASES = {"tp2_i8"}  # over an int8 cache; every other case bf16
# The port's sharded forward against the JAX single-device one: both keep
# activations in bf16 between ops and sum in f32 in different orders (tp
# adds an f32 all-reduce of the wo/w2 partials), so an activation can land
# one bf16 ulp apart after any matmul and carry that through 4 layers: the
# logits (|x| < 5) drift by up to ~0.065 (two to four bf16 ulps at their
# size). Half of tests/test_parallel.py's rtol, its atol: tighter everywhere.
LOGIT_TOL = dict(rtol=2.5e-2, atol=6e-2)


def _tokens() -> np.ndarray:
    return np.random.default_rng(2).integers(0, 256, (B, T + 2)).astype(np.int64)


def _kv_dtype(case: str) -> torch.dtype:
    return torch.int8 if case in INT8_CASES else torch.bfloat16


def _rank(rank: int, world: int, init: str, path: str, out: str) -> None:
    """One rank of a world: every case of WORLDS[world], results saved."""
    torch.set_num_threads(1)
    multihost.initialize(init, world, rank, device="cpu", timeout_s=60)
    calls = {"n": 0}
    update = tm.flash_attention_update

    def counted(*a, **kw):  # the update kernel's calls on this rank
        calls["n"] += 1
        return update(*a, **kw)

    tm.flash_attention_update = counted
    toks = torch.from_numpy(_tokens())
    results = {}
    for name, (tp, dp, pp, mb) in WORLDS[world].items():
        mesh = make_mesh(tp=tp, dp=dp, pp=pp, device="cpu")
        cfg, whole = tl.params_from_reader(CheckpointReader(path), scale_dtype=torch.float32,
                                           device="cpu", tp=tp)
        params = shard_params(whole, mesh)
        fwd = make_sharded_forward(cfg, params, mesh, pp_microbatch=mb,
                                   quantized_kv=name in INT8_CASES)
        cache = shard_cache(tm.init_kv_cache(cfg, B, N_CTX, dtype=_kv_dtype(name),
                                             device="cpu"), mesh)
        calls["n"] = 0
        logits, cache, emb = fwd(params, toks[:, :T], cache, 0)
        res = dict(prefill=logits, emb=emb, cache=[c.clone() for c in cache.planes()],
                   calls=calls["n"], local_layers=cache.k.shape[0],
                   coord={a: mesh.axis(a).index for a in ("dp", "pp", "tp")})
        for i in range(2):
            res[f"decode{i}"] = fwd(params, toks[:, T + i : T + i + 1], cache, T + i)[0]
        results[name] = res
    torch.save(results, f"{out}.{rank}")
    multihost.shutdown()


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("m") / "tiny.bin")
    tl.random_tiny_model(write_path=path, n_embd=512, n_head=8, n_ff=512, n_vocab=256,
                         n_layer=N_LAYER, quantize=True)
    return path


@pytest.fixture(scope="module")
def jax_ref(tiny):
    """JAX single-device logits (prefill, 2 decode steps) and embeddings."""
    import jax
    import jax.numpy as jnp

    from llamavk_tpu.formats import CheckpointReader as JReader
    from llamavk_tpu.models import init_kv_cache, llama_forward, params_from_reader

    cfg, params = params_from_reader(JReader(tiny), scale_dtype=jnp.float32)
    fwd = jax.jit(llama_forward, static_argnames=("cfg",))
    toks = jnp.asarray(_tokens(), jnp.int32)
    cache = init_kv_cache(cfg, B, N_CTX)
    logits, cache, emb = fwd(params, toks[:, :T], cache, jnp.int32(0), cfg=cfg)
    out = dict(prefill=np.asarray(logits), emb=np.asarray(emb))
    for i in range(2):
        logits, cache, _ = fwd(params, toks[:, T + i : T + i + 1], cache, jnp.int32(T + i),
                               cfg=cfg)
        out[f"decode{i}"] = np.asarray(logits)
    return out


@pytest.fixture(scope="module")
def port_cache(tiny):
    """The port's single-device cache after the same prefill (plain kernel
    versions on the CPU, as the ranks run them)."""
    cfg, params = tl.params_from_reader(CheckpointReader(tiny), scale_dtype=torch.float32,
                                        device="cpu")
    cache = tm.init_kv_cache(cfg, B, N_CTX, device="cpu")
    tm.llama_forward(params, torch.from_numpy(_tokens())[:, :T], cache, 0, cfg)
    return cache


@pytest.fixture(scope="module")
def runs(tiny, tmp_path_factory):
    """Each world spawned once: {case: [rank 0's results, rank 1's, ...]}."""
    out = {}
    for world in WORLDS:
        d = tmp_path_factory.mktemp(f"world{world}")
        multihost.spawn(_rank, world, (world, f"file://{d}/init", tiny, str(d / "res")),
                        deadline_s=DEADLINE_S)
        ranks = [torch.load(d / f"res.{r}") for r in range(world)]
        for name in WORLDS[world]:
            out[name] = [r[name] for r in ranks]
    return out


def _close(got: torch.Tensor, want: np.ndarray, tol: dict) -> None:
    np.testing.assert_allclose(got.float().numpy(), want, **tol)


@pytest.mark.parametrize("case", ["tp2", "tp2_dp2"])
def test_tp_forward_matches_single(runs, jax_ref, case):
    for res in runs[case]:  # every rank returns the whole logits
        _close(res["prefill"], jax_ref["prefill"], LOGIT_TOL)
        _close(res["emb"], jax_ref["emb"], LOGIT_TOL)


def test_tp_decode_consistency(runs, jax_ref):
    """Prefill + decode under tp 2 matches single-device decode."""
    for res in runs["tp2"]:
        for i in range(2):
            _close(res[f"decode{i}"], jax_ref[f"decode{i}"], LOGIT_TOL)


def _cache_matches(res: dict, cache: tm.KVCache, tp: int, dp: int) -> None:
    """A rank's cache shard equals the port's single-device cache's slice
    (its stage's layers, its dp rows, its tp heads; an int8 cache's scale
    planes [L, B, S, H] too) bit for bit: the same plain kernels wrote the
    same rows, each once. (Its drift from the JAX cache is the
    single-device one of tests/test_torch_model.py.)"""
    c = res["coord"]
    ll, h = res["local_layers"], 8 // tp
    layers = slice(c["pp"] * ll, (c["pp"] + 1) * ll)
    rows = slice(c["dp"] * (B // dp), (c["dp"] + 1) * (B // dp))
    heads = slice(c["tp"] * h, (c["tp"] + 1) * h)
    planes = cache.planes()
    assert len(res["cache"]) == len(planes)
    for i, (got, plane) in enumerate(zip(res["cache"], planes)):
        want = plane[layers, rows, heads] if i < 2 else plane[layers, rows, :, heads]
        assert torch.equal(got, want)


@pytest.mark.parametrize("case", ["pp2", "pp2_tp2", "tp2_dp2"])
def test_pp_forward_matches_single(runs, jax_ref, port_cache, case):
    """Pipeline stages (and tp/dp shards) match single-device logits, and
    each rank's cache rows are the single-device cache's."""
    tp, dp, _, _ = WORLDS[CASES[case]][case]
    for res in runs[case]:
        _close(res["prefill"], jax_ref["prefill"], LOGIT_TOL)
        _cache_matches(res, port_cache, tp, dp)


@pytest.mark.parametrize("case", ["pp2_mb2", "pp4_mb2"])
def test_pp_microbatched_matches_single(runs, jax_ref, port_cache, case):
    """Microbatched stages == single-device, and every microbatch's cache
    rows on every stage equal the single-device cache."""
    for res in runs[case]:
        _close(res["prefill"], jax_ref["prefill"], LOGIT_TOL)
        _cache_matches(res, port_cache, 1, 1)


def _port_single_run(tiny: str, dtype: torch.dtype) -> dict:
    """The port's single-device logits (prefill, 2 decode steps) and
    embeddings over a cache of `dtype`, and the cache after the prefill."""
    cfg, params = tl.params_from_reader(CheckpointReader(tiny), scale_dtype=torch.float32,
                                        device="cpu")
    cache = tm.init_kv_cache(cfg, B, N_CTX, dtype=dtype, device="cpu")
    toks = torch.from_numpy(_tokens())
    logits, cache, emb = tm.llama_forward(params, toks[:, :T], cache, 0, cfg)
    out = dict(prefill=logits, emb=emb, cache=cache.clone())
    for i in range(2):
        out[f"decode{i}"] = tm.llama_forward(params, toks[:, T + i : T + i + 1], cache, T + i,
                                             cfg)[0]
    return out


# tp 2 against the port's own single-device forward over the same int8
# cache: the same plain kernels, and only the f32 all-reduce of the wo/w2
# partials sums in another order, so an activation may land a bf16 ulp
# apart (2^-8 of it) and the int8 rows quantized from it a step apart. One
# bf16 ulp of the logits at their size, and 2^-6 near 0: a quarter of the
# bf16 cases' tolerance against JAX. Measured on this model: bit-equal.
TP_I8_TOL = dict(rtol=2.0**-7, atol=2.0**-6)


def test_tp_int8_kv_matches_single(runs, tiny):
    """tp 2 over an int8 cache (heads and scale planes split on H, the int8
    update kernel over each rank's 4 heads): prefill, embeddings and 2
    decode steps match the single-device forward over an int8 cache, and
    each rank's shard, scales included, is its cache's slice bit for bit."""
    want = _port_single_run(tiny, torch.int8)
    for res in runs["tp2_i8"]:
        for key in ("prefill", "emb", "decode0", "decode1"):
            _close(res[key], want[key].float().numpy(), TP_I8_TOL)
        _cache_matches(res, want["cache"], 2, 1)


# The single-device int8 forward against JAX's (the JAX tests' tolerance,
# tests/test_parallel.py). JAX is compiled with XLA's excess precision off:
# XLA:CPU otherwise keeps fused bf16 intermediates (the residual sum that
# feeds rms_norm) in f32, where the graph, and the port, round them to bf16.
# Traced op by op, layer 0's norm, wqkv, rope and int8 rows and scales are
# bit-equal; its attention output differs by f32 ulps (the order of the f32
# sums; equal after its bf16 rounding), and the first bf16 difference is one
# ulp in 3 of wo's 8192 outputs (K1's f32 summation order), which the int8
# rows of the deeper layers carry as a quantization step or two. Measured:
# at most 0.64 of the tolerance (0.060 of the logits, |logits| < 6). Before
# the plain attention rounded where the JAX kernel rounds (its probabilities
# relative to the max, times the value scales, then divided by the sum), it
# rounded the normalized probabilities, and prefill missed by 1.27x.
INT8_JAX_TOL = dict(rtol=5e-2, atol=6e-2)


@pytest.fixture(scope="module")
def jax_int8_ref(tiny):
    """JAX single-device logits (prefill, 2 decode steps), embeddings and
    the int8 cache after the prefill, compiled without excess precision."""
    import jax
    import jax.numpy as jnp

    from llamavk_tpu.formats import CheckpointReader as JReader
    from llamavk_tpu.models import init_kv_cache, llama_forward, params_from_reader

    cfg, params = params_from_reader(JReader(tiny), scale_dtype=jnp.float32)
    progs = {}

    def fwd(toks, cache, n_past):
        if toks.shape not in progs:
            progs[toks.shape] = jax.jit(lambda p, t, c, n: llama_forward(p, t, c, n, cfg=cfg)).lower(
                params, toks, cache, n_past).compile(
                compiler_options={"xla_allow_excess_precision": False})
        return progs[toks.shape](params, toks, cache, n_past)

    toks = jnp.asarray(_tokens(), jnp.int32)
    cache = init_kv_cache(cfg, B, N_CTX, dtype=jnp.int8)
    logits, cache, emb = fwd(toks[:, :T], cache, jnp.int32(0))
    out = dict(prefill=np.asarray(logits), emb=np.asarray(emb),
               cache=[np.asarray(p) for p in (cache.k, cache.v, cache.k_scale, cache.v_scale)])
    for i in range(2):
        logits, cache, _ = fwd(toks[:, T + i : T + i + 1], cache, jnp.int32(T + i))
        out[f"decode{i}"] = np.asarray(logits)
    return out


def test_int8_forward_matches_jax(tiny, jax_int8_ref):
    """The port's single-device forward over an int8 cache holds to JAX's at
    the JAX tests' tolerance (prefill, embeddings, 2 decode steps), and
    layer 0's int8 rows and scales are JAX's bit for bit."""
    got = _port_single_run(tiny, torch.int8)
    for key in ("prefill", "emb", "decode0", "decode1"):
        _close(got[key], jax_int8_ref[key], INT8_JAX_TOL)
    for i, (plane, want) in enumerate(zip(got["cache"].planes(), jax_int8_ref["cache"])):
        want = want[0] if i < 2 else want[0, ..., : plane.shape[-1]]
        np.testing.assert_array_equal(plane[0].numpy(), want)


@pytest.mark.parametrize("case", ["pp2", "pp2_mb2"])
def test_pp_decode_steps(runs, jax_ref, case):
    for res in runs[case]:
        for i in range(2):
            _close(res[f"decode{i}"], jax_ref[f"decode{i}"], LOGIT_TOL)


@pytest.mark.parametrize("case", ["pp2", "pp2_mb2", "pp4_mb2", "tp2", "tp2_i8"])
def test_update_calls_per_rank(runs, case):
    """Each stage runs each microbatch once: M x local layers update-kernel
    calls per rank in the prefill, so no idle wave launches anything (the
    JAX schedule's M + P - 1 waves would make (M + P - 1) x local layers)."""
    mb = WORLDS[CASES[case]][case][3]
    for res in runs[case]:
        assert res["calls"] == mb * res["local_layers"]


def test_mesh_single_process():
    """A mesh in one process has every axis of size 1, and the sharded
    forward is the plain forward."""
    mesh = make_mesh(device="cpu")
    assert mesh.shape == {"dp": 1, "pp": 1, "tp": 1} and mesh.size == 1
    assert all(mesh.axis(a).group is None for a in ("dp", "pp", "tp"))
    with pytest.raises(AssertionError, match="n_devices"):
        make_mesh(tp=2, device="cpu")


def test_regroup_fused(tiny):
    """tp-packed fused columns regrouped to tp = 1 are the tp = 1 packing's
    bytes; wo/w2 keep their tp chunks."""
    reader = CheckpointReader(tiny)
    _, p1 = tl.params_from_reader(reader, device="cpu")
    _, p2 = tl.params_from_reader(reader, device="cpu", tp=2)
    back = tl.regroup_fused(p2, 2, 1)
    for kind in ("wqkv", "w13"):
        a, b = getattr(p1.layers, kind), getattr(back.layers, kind)
        assert torch.equal(a.packed, b.packed) and torch.equal(a.scales, b.scales)
    assert back.layers.wo.chunks == 2 and back.layers.wo is p2.layers.wo
    again = tl.regroup_fused(back, 1, 2)
    assert torch.equal(again.layers.wqkv.packed, p2.layers.wqkv.packed)


def test_tp_packing_entry_points(tiny):
    """tp packing through every loader: JAX params packed for tp 2 carried
    across keep their bytes and chunks, and equal the port's own tp load;
    `load_model(tp=)` and `synthetic_params(tp=)` pack wo/w2 in tp chunks."""
    import jax

    from llamavk_tpu.formats import CheckpointReader as JReader
    from llamavk_tpu.models import params_from_reader as jax_params_from_reader

    cfg, jparams = jax_params_from_reader(JReader(tiny), tp=2)
    flat, _ = jax.tree_util.tree_flatten_with_path(jparams)
    arrays = {".".join(p.name for p in path): np.asarray(leaf) for path, leaf in flat}
    tcfg = tm.ModelConfig(**{k: getattr(cfg, k) for k in ("n_vocab", "n_embd", "n_layer",
                                                           "n_head", "n_rot", "n_ff")})
    carried = tl.params_from_arrays(arrays, tcfg, device="cpu", tp=2)
    _, own, _ = tl.load_model(tiny, device="cpu", tp=2)
    for kind in ("wqkv", "wo", "w13", "w2"):
        a, b = getattr(carried.layers, kind), getattr(own.layers, kind)
        assert a.chunks == b.chunks == (2 if kind in ("wo", "w2") else 1)
        assert torch.equal(a.packed, b.packed) and torch.equal(a.scales, b.scales)
    synth = tl.synthetic_params(tcfg, device="cpu", tp=2)
    assert synth.layers.wo.chunks == synth.layers.w2.chunks == 2
