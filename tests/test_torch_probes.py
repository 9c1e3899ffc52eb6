"""The Hopper probes' plain versions (`llamavk_tpu_torch/tools/`) against the
TPU probes of `tools/` (P1-P5): each probe's kernel bodies, imported by path,
wrapped in `pl.pallas_call(..., interpret=True)` at small shapes (K = N =
256, B 8; P4 L 2, B 1; P5 b 1, t 64, h 4, d 32, bt = bk = 32, hg 2), on the
same NumPy-seeded inputs. The tools' own `make_*` builders compile for the
TPU only, so the calls are built here with the tools' kernels and block
shapes. JAX programs are compiled with XLA's excess precision off, so that
XLA:CPU rounds to bf16 where the kernels say so (as a TPU does).

The port's probes take x in original k order; the TPU probes take the same
activations in their ilv order (`_common.probe_order`)."""

from __future__ import annotations

import importlib.util
from functools import partial
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from llamavk_tpu_torch.ops import q4_matmul as q4
from llamavk_tpu_torch.tools import _common, _unpack
from llamavk_tpu_torch.tools import bench_i4_stacked as p4
from llamavk_tpu_torch.tools import bench_int8_mxu as p2
from llamavk_tpu_torch.tools import bench_prefill_ownrows as p5
from llamavk_tpu_torch.tools import bench_unpack2 as p3
from llamavk_tpu_torch.tools import bench_unpack_trick as p1

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
K = N = 256
B = 8
G = K // 32


def _tool(name: str):
    """A TPU probe of tools/, imported by path (tools/ is not a package)."""
    spec = importlib.util.spec_from_file_location(f"tpu_probe_{name}", ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jrun(fn, *args):
    """fn(*args) jitted and compiled without XLA's excess precision."""
    return np.asarray(jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})(*args))


def _whole(kernel, out_shape):
    """One program over whole arrays in interpret mode."""
    return pl.pallas_call(kernel, out_shape=jax.ShapeDtypeStruct(out_shape, jnp.float32),
                          interpret=True)


def _j(t: torch.Tensor, dtype=None):
    a = jnp.asarray(t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy())
    return a.astype(dtype) if dtype is not None else a


@pytest.fixture(scope="module")
def case():
    """NumPy-seeded x bf16 [8, K], ilv bytes [K/2, N], scales bf16 and f32."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((B, K)).astype(np.float32)).to(torch.bfloat16)
    packed = torch.from_numpy(rng.integers(-128, 128, (K // 2, N), dtype=np.int8))
    s32 = torch.from_numpy(rng.uniform(0.005, 0.02, (G, N)).astype(np.float32))
    return x, packed, s32, s32.to(torch.bfloat16)


@pytest.fixture(scope="module")
def jax_cur(case):
    """The TPU baseline body (P1 `kernel_current` = P3 `kernel_cur`) over bf16
    and over f32 scales, on the probe-ordered x."""
    x, packed, s32, s16 = case
    xj = _j(_common.probe_order(x), jnp.bfloat16)
    call = _whole(_tool("bench_unpack2").kernel_cur, (B, N))
    return {dt: _jrun(call, xj, _j(packed), _j(s, dt))
            for dt, s in ((jnp.bfloat16, s16), (jnp.float32, s32))}


# Both sides sum the same exact f32 products x * bf16(q * s) in different
# orders: each sum lies within (K - 1) 2^-24 sum_k |x_k w_kn| of the exact
# one, so they differ by at most twice that (K1's limit, `k1_limit`).
def _close_k1(got: torch.Tensor, want: np.ndarray, x, w) -> None:
    err = float(np.abs(got.numpy() - want).max())
    assert err <= _common.k1_limit(x, w), (err, _common.k1_limit(x, w))


def test_p1_current_and_trick(case, jax_cur):
    """P1: the port's shift (`current`) and magic-number (`trick`) unpacks
    both compute `kernel_current`'s product, and trick's weights are the
    shift unpack's bit for bit (bf16 scales)."""
    x, packed, _, s16 = case
    w = _unpack.byte_weights(packed, s16)
    for fn in (p1.current, p1.trick):
        _close_k1(fn(x, packed, s16), jax_cur[jnp.bfloat16], x, w)
    assert torch.equal(_unpack.dequant(packed, s16, "bytes", "trick"),
                       _unpack.dequant(packed, s16, "bytes", "shift"))


def test_p1_tpu_trick_is_not_the_product(case, jax_cur):
    """The TPU probe's `kernel_trick` leaves its +136 offset unwired (its
    docstring: "numerics of the trick variant are not wired"): on the same
    bytes its output is far from the Q4 product, where the port's trick
    computes it (test_p1_current_and_trick)."""
    x, packed, _, s16 = case
    xj = _j(_common.probe_order(x), jnp.bfloat16)
    got = _jrun(_whole(_tool("bench_unpack_trick").kernel_trick, (B, N)), xj, _j(packed),
                _j(s16, jnp.bfloat16))
    gap = float(np.abs(got - jax_cur[jnp.bfloat16]).max())
    assert gap > 100 * _common.k1_limit(x, _unpack.byte_weights(packed, s16))


@pytest.mark.parametrize("dot", ["i8", "bf16"])
def test_p2_group_dot(case, dot):
    """P2's `kernel_i8_batched` (int8 and bf16 dots) on K5's quantization of
    x: with unit scales the port's plain group dot equals it (the dots are
    exact integers on both sides); with random scales within G 2^-24
    sum_g |D s sx| per element (the f32 fold summed over g in other
    orders)."""
    x, packed, s32, _ = case
    p_gm = p2.gm_order(packed)
    xq, sx = p2.quantized_x(x)
    call = pl.pallas_call(
        partial(_tool("bench_int8_mxu").kernel_i8_batched,
                dot_dtype=jnp.int8 if dot == "i8" else jnp.bfloat16),
        out_shape=jax.ShapeDtypeStruct((B, N), jnp.float32), interpret=True)
    ones_s, ones_sx = torch.ones_like(s32), torch.ones_like(sx)
    got = _jrun(call, _j(xq), _j(p_gm), _j(ones_s), _j(ones_sx))
    np.testing.assert_array_equal(p2.group_dot(xq, p_gm, ones_s, ones_sx, dot).numpy(), got)
    got = _jrun(call, _j(xq), _j(p_gm), _j(s32), _j(sx))
    d = torch.einsum("gbj,gjn->gbn", xq.double(), p2.group_weights(p_gm).double())
    limit = G * 2.0**-24 * (d * s32.double()[:, None, :] * sx.double()[:, :, None]).abs().sum(0)
    err = np.abs(p2.group_dot(xq, p_gm, s32, sx, dot).double().numpy() - got)
    assert (err <= limit.numpy()).all()


def test_p2_current_is_k1(case, jax_cur):
    """P2's `kernel_current` (f32 scales) is K1's function: the port's
    baseline, K1's plain version on the same bytes, within K1's limit."""
    x, packed, s32, _ = case
    got = q4.q4_matmul_ref(x, q4.QWeight(packed, s32), torch.float32)
    _close_k1(got, jax_cur[jnp.float32], x, _unpack.byte_weights(packed, s32))


@pytest.mark.parametrize("name", ["cur", "i8shift", "i8shift16", "int4", "int4f32"])
def test_p3_unpack_variants(case, name):
    """P3's `kernel_cur`, `kernel_i8shift` (f32 and bf16 multiply) and
    `kernel_int4` (bf16 and f32 multiply, over the int4 plane in ilv row
    order) against the port's variant on the same weights (f32 scales)."""
    x, packed, s32, _ = case
    tool = _tool("bench_unpack2")
    xj = _j(_common.probe_order(x), jnp.bfloat16)
    mul = jnp.bfloat16 if name in ("i8shift16", "int4") else jnp.float32
    if name == "cur":
        call, w = _whole(tool.kernel_cur, (B, N)), _j(packed)
    elif name.startswith("i8shift"):
        call, w = _whole(partial(tool.kernel_i8shift, mul_dtype=mul), (B, N)), _j(packed)
    else:  # the int4 plane [K, N]: row r < K/2 the low nibbles of byte row r, then the high
        p = packed.to(torch.int32)
        w = _j(torch.cat([(p << 28) >> 28, p >> 4]).to(torch.int8)).astype(jnp.int4)
        call = _whole(partial(tool.kernel_int4, mul_dtype=mul), (B, N))
    got = _jrun(call, xj, w, _j(s32))
    plane = _unpack.repack_int4(packed)
    storage = p3.VARIANTS[name][0]
    _close_k1(p3.unpack_variant(name, x, packed, s32, plane), got, x,
              _unpack.weights(plane if storage == "plane" else packed, s32, storage,
                              p3.VARIANTS[name][2]))


@pytest.mark.parametrize("name", ["bitcast4", "bitcast4f32"])
def test_p3_bitcast4_is_cur_permuted(case, name):
    """The port's bitcast4 reads the ilv bytes as they lie as its int4
    plane; with its permutation applied (the ilv bytes that hold the
    weights of that view, `_unpack.pack_bytes`) it is `kernel_cur` (bf16
    multiply: the scales rounded to bf16 first)."""
    x, packed, s32, _ = case
    view = _unpack.plane_nibbles(_unpack.bitcast_view(packed))
    mulb = p3.VARIANTS[name][2]
    s = s32.to(torch.bfloat16).float() if mulb else s32
    want = _jrun(_whole(_tool("bench_unpack2").kernel_cur, (B, N)),
                 _j(_common.probe_order(x), jnp.bfloat16), _j(_unpack.pack_bytes(view)), _j(s))
    _close_k1(p3.unpack_variant(name, x, packed, s32), want, x,
              _unpack.weights(packed, s32, "bitcast", mulb))


def test_p3_perm_and_tpu_bitcast(case):
    """`perm_probe.kern` and `kernel_bitcast4` in interpret mode: the CPU
    interpreter's int8 -> int4 view puts byte row r's nibbles in int4 rows
    2r (low) and 2r + 1 (high) of the same column, and `kernel_bitcast4` is
    `kernel_cur` on the ilv bytes that hold that view. The port's view (its
    `perm`) is another permutation of the same nibbles, the one the card's
    32-bit words give (`_unpack.bitcast_perm`)."""
    x, packed, s32, _ = case
    tool = _tool("bench_unpack2")

    def kern(p_ref, o_ref):  # perm_probe.kern, which perm_probe() builds inside
        o_ref[:] = pltpu.bitcast(p_ref[:], jnp.int4).astype(jnp.float32)

    jview = _jrun(_whole(kern, (K, N)), _j(packed))
    p = packed.to(torch.int32)
    lohi = torch.stack([(p << 28) >> 28, p >> 4], dim=1).reshape(K, N)  # rows 2r, 2r + 1
    np.testing.assert_array_equal(jview, lohi.numpy())
    got = _unpack.perm(packed)
    src = _unpack.bitcast_perm(K, N)
    nib = torch.stack([(p << 28) >> 28, p >> 4], dim=-1)
    assert torch.equal(got, nib[src[..., 0], src[..., 1], src[..., 2]].float())
    assert torch.equal(got.flatten().sort().values, torch.from_numpy(jview).flatten().sort().values)
    assert not torch.equal(got, torch.from_numpy(jview))
    # kernel_bitcast4 (bf16 multiply) is kernel_cur over the bytes of the
    # interpreter's view: int4 row j multiplies x_ilv[:, j] with s[j % G]
    xj = _j(_common.probe_order(x), jnp.bfloat16)
    got_b = _jrun(_whole(partial(tool.kernel_bitcast4, mul_dtype=jnp.bfloat16), (B, N)), xj,
                  _j(packed), _j(s32))
    ilv_rows = torch.from_numpy(jview).to(torch.int32)  # the view's rows in ilv row order
    holder = (ilv_rows[: K // 2] & 15) | ((ilv_rows[K // 2 :] & 15) << 4)
    holder = torch.where(holder >= 128, holder - 256, holder).to(torch.int8)
    s16 = s32.to(torch.bfloat16).float()
    want_b = _jrun(_whole(tool.kernel_cur, (B, N)), xj, _j(holder), _j(s16))
    _close_k1(torch.from_numpy(got_b), want_b, x, _unpack.byte_weights(holder, s16))


def test_p3_i8dot2d_exact():
    """P3's `kernel_i8dot2d`: an int8 x int8 product exact in int32, equal."""
    rng = np.random.default_rng(3)
    xq = torch.from_numpy(rng.integers(-128, 128, (8, K), dtype=np.int8))
    w8 = torch.from_numpy(rng.integers(-128, 128, (K, N), dtype=np.int8))
    got = _jrun(_whole(_tool("bench_unpack2").kernel_i8dot2d, (8, N)), _j(xq), _j(w8))
    np.testing.assert_array_equal(p3.i8dot2d(xq, w8).numpy(), got)


@pytest.mark.parametrize("name", ["prod", "i4st", "i4st_bf16"])
def test_p4_stacked(name):
    """P4's `kernel_prod` and `kernel_i4st` (f32 and bf16 multiply) under
    PrefetchScalarGridSpec, the layer from the prefetched index, B 1, L 2:
    the port's stacked variant on each layer, its index a tensor."""
    tool = _tool("bench_i4_stacked")
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((1, K)).astype(np.float32)).to(torch.bfloat16)
    packed = torch.from_numpy(rng.integers(-128, 128, (2, K // 2, N), dtype=np.int8))
    s = torch.from_numpy(rng.uniform(0.005, 0.02, (2, G, N)).astype(np.float32))
    half = K // 2
    if name == "prod":
        kernel, wshape, w = tool.kernel_prod, (1, half, N), _j(packed)
    else:
        p = packed.to(torch.int32)
        w4 = torch.cat([(p << 28) >> 28, p >> 4], dim=1).to(torch.int8)  # [L, K, N] ilv rows
        mul = jnp.bfloat16 if name == "i4st_bf16" else jnp.float32
        kernel, wshape, w = partial(tool.kernel_i4st, mul_dtype=mul), (1, K, N), _j(w4)
    call = pl.pallas_call(
        kernel,
        grid_spec=pltpu.PrefetchScalarGridSpec(
            num_scalar_prefetch=1, grid=(1, 1),
            in_specs=[pl.BlockSpec((1, K), lambda i, j, idx: (0, 0)),
                      pl.BlockSpec(wshape, lambda i, j, idx: (idx[0], 0, j)),
                      pl.BlockSpec((1, G, N), lambda i, j, idx: (idx[0], 0, j))],
            out_specs=pl.BlockSpec((1, 1, N), lambda i, j, idx: (0, 0, j))),
        out_shape=jax.ShapeDtypeStruct((1, 1, N), jnp.float32), interpret=True)
    xj = _j(_common.probe_order(x), jnp.bfloat16)
    plane = _unpack.repack_int4(packed)
    stack = packed if name == "prod" else plane
    storage, mulb = p4.VARIANTS[name]
    for layer in range(2):
        idx = jnp.asarray([layer], jnp.int32)
        wj = w if name == "prod" else w.astype(jnp.int4)
        got = _jrun(call, idx, xj, wj, _j(s))[0]
        mine = p4.stacked(name, x, stack, s, torch.tensor([layer], dtype=torch.int32))
        _close_k1(mine, got, x, _unpack.weights(stack[layer], s[layer], storage, mulb))


def test_p5_direct():
    """P5's `kern_direct` (b 1, t 64, h 4, d 32, bt = bk = 32, hg 2): the
    port's one-launch prefill writes the same cache rows, byte for byte, and
    its output lies within 2^-6 attention(q, k, |v|) of the kernel's (the
    kernel rounds its running probabilities to bf16 relative to its running
    max, the plain version relative to the row's max, 2^-8 each)."""
    tool = _tool("bench_prefill_ownrows")
    b, t, h, d, bt, hg = 1, 64, 4, 32, 32, 2
    rng = np.random.default_rng(5)
    q, kn, vn = (torch.from_numpy(rng.standard_normal((b, h, t, d)).astype(np.float32))
                 .to(torch.bfloat16) for _ in range(3))
    blk = pl.BlockSpec((1, hg, bt, d), lambda b_, h_, t_: (b_, h_, t_, 0))
    any_spec = pl.BlockSpec(memory_space=pl.ANY)
    call = pl.pallas_call(
        partial(tool.kern_direct, bt=bt, bk=bt, scale=1.0 / d**0.5),
        grid=(b, h // hg, t // bt), in_specs=[blk, blk, blk, any_spec, any_spec],
        out_specs=[blk, any_spec, any_spec],
        out_shape=[jax.ShapeDtypeStruct((b, h, t, d), jnp.float32),
                   jax.ShapeDtypeStruct((1, b, h, t, d), jnp.bfloat16),
                   jax.ShapeDtypeStruct((1, b, h, t, d), jnp.bfloat16)],
        input_output_aliases={3: 1, 4: 2},
        scratch_shapes=[pltpu.VMEM((2, hg, bt, d), jnp.bfloat16),
                        pltpu.VMEM((2, hg, bt, d), jnp.bfloat16),
                        pltpu.SemaphoreType.DMA((2, 2)), pltpu.SemaphoreType.DMA((2,))],
        interpret=True)
    zeros = jnp.zeros((1, b, h, t, d), jnp.bfloat16)
    out, kc_j, vc_j = call(_j(q, jnp.bfloat16), _j(kn, jnp.bfloat16), _j(vn, jnp.bfloat16),
                           zeros, zeros)
    kc, vc = (torch.zeros((1, b, h, t, d), dtype=torch.bfloat16) for _ in range(2))
    got = p5.prefill_direct(q, kn, vn, kc, vc, block_k=bt)
    np.testing.assert_array_equal(kc.float().numpy(), np.asarray(kc_j.astype(jnp.float32)))
    np.testing.assert_array_equal(vc.float().numpy(), np.asarray(vc_j.astype(jnp.float32)))
    limit = 2.0**-6 * p5.prefill_direct_ref(q, kn, vn.abs(), kc.clone(), vc.clone())
    assert (np.abs(got.numpy() - np.asarray(out)) <= limit.numpy()).all()
