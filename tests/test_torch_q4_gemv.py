"""K1's decode GEMV (M = 1) on the CPU. The kernel runs on the card
(`chip_smoke.py`); here:

* its conversion-free dequantization (csrc/q4_dequant.cuh, shared with the
  GEMM), written in torch on bf16 bit patterns (mask, xor 0x4300, subtract
  136, a bf16 multiply; an f32 multiply rounded by integer operations),
  against `mode_weight`'s weights bit for bit;
* an emulation of the kernel's lanes (the 16-byte chunks each lane loads,
  the A and B fragments of each MMA, the warps' and the splits' in-order
  sums) against the plain version and the JAX package's K1;
* its split rule, scratch and counters.

Inputs come from seeded NumPy."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llamavk_tpu import ops as jops
from llamavk_tpu.formats import quantize_q4_0, repack_q4_0
from llamavk_tpu.formats.repack import LAYOUT_ILV, LAYOUT_LIN
from llamavk_tpu_torch.ops import q4_matmul as q4
from llamavk_tpu_torch.ops.qweight import QWeight, qweight_from_packed

torch.set_num_threads(2)

MAGIC = 0x4300  # bf16 128.0; 0x4300 | (q ^ 8) is 136 + q


def _bits(t: torch.Tensor) -> torch.Tensor:
    """The bf16 bit patterns of t (any float) rounded to bf16, as int32."""
    return t.to(torch.bfloat16).view(torch.int16).to(torch.int32) & 0xFFFF


def _bf16(bits: torch.Tensor) -> torch.Tensor:
    """bf16 values from their bit patterns (int32 0..0xFFFF)."""
    return (bits - ((bits & 0x8000) << 1)).to(torch.int16).view(torch.bfloat16)


def _rne_hi(f: torch.Tensor) -> torch.Tensor:
    """q4_dequant.cuh's rne_hi: f32 -> bf16 to nearest even by integer
    operations, the bf16 bits in bits 16-31 (returned as int64 bits)."""
    u = f.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    return (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFFFFFF


def _q_from_magic(nib: torch.Tensor) -> torch.Tensor:
    """An unsigned nibble (0-15, the two's complement q) as the kernels make
    q: the bf16 0x4300 | (n ^ 8) minus 136, an exact bf16 subtract."""
    return _bf16(MAGIC | (nib ^ 8)) - torch.tensor(136.0, dtype=torch.bfloat16)


def _weights(nib: torch.Tensor, s: torch.Tensor, mul_bf16: bool, parts: int = 1) -> torch.Tensor:
    """The weights the kernels form from nibbles and f32-held scales `s`
    (bf16 values for a bf16 plane): weight_pair of q4_dequant.cuh, summed
    over its `parts` bf16 parts, as f32; parts = 0: the GEMV's exact f32
    q * s over an f32 scale (its fmaf path)."""
    q = _q_from_magic(nib)
    if s.dtype == torch.bfloat16 or mul_bf16:
        if s.dtype != torch.bfloat16:  # RS: the scale rounded by rne_hi
            s = _bf16((_rne_hi(s) >> 16).to(torch.int32))
        w0 = q * s  # one rounding of the exact product
        if parts == 1:
            return w0.float()
        # __hfma2(q, s, -w0): q s - w0 is exact in bf16
        w1 = (q.double() * s.double() - w0.double()).to(torch.bfloat16)
        assert torch.equal(w1.double(), q.double() * s.double() - w0.double())
        return w0.float() + w1.float()
    # an f32 scale: q made an f32 by its bf16 bits, multiplied in f32
    a = (q.view(torch.int16).to(torch.int32) << 16).view(torch.float32) * s
    if parts == 0:
        return a
    out = torch.zeros_like(a)
    for _ in range(parts):
        h = (_rne_hi(a) & 0xFFFF0000).to(torch.int32).view(torch.float32)
        out = out + h
        a = a - h
    return out


def _all_nibbles_plane(n: int) -> torch.Tensor:
    """An ilv plane [16, n] (K = 32) whose group holds every nibble in each
    column: row m's low nibble m, its high nibble 15 - m."""
    m = torch.arange(16, dtype=torch.int32)[:, None]
    return ((m | ((15 - m) << 4)).expand(16, n)).to(torch.uint8).view(torch.int8).contiguous()


def _nibbles_of(packed: torch.Tensor) -> torch.Tensor:
    """The unsigned nibbles [32, N] of a one-group ilv plane, in k order."""
    p = packed.view(torch.uint8).to(torch.int32)
    return torch.cat([p & 15, p >> 4], dim=0)


def test_dequant_every_bf16_scale_bit_exact():
    """All 16 nibbles times every finite positive bf16 scale (0x0001 to
    0x7F7F, 523K weights): the magic-number q times the bf16 scale in one
    bf16 multiply equals mode_weight's bf16(f32(q) * f32(s)), bit for bit,
    in the default mode and under LLAMAVK_Q4_MUL=bf16 (the same on a bf16
    plane); the f32 dot's two parts w0 + w1 equal its f32 w exactly
    wherever w is 0 or a normal f32 within bf16's range (above it w0 is
    infinite; below 2^-126 the f32 w itself is rounded)."""
    scales = _bf16(torch.arange(1, 0x7F80, dtype=torch.int32))[None, :]
    packed = _all_nibbles_plane(scales.shape[1])
    qw = QWeight(packed=packed, scales=scales, layout=LAYOUT_ILV)
    nib = _nibbles_of(packed)
    got = _weights(nib, scales, False)
    for mul in (torch.float32, torch.bfloat16):
        want = q4.mode_weight(qw, "bf16", mul)
        assert torch.equal(_bits(got), _bits(want))
        assert torch.equal(got, want)
    w32 = q4.mode_weight(qw, "f32")
    normal = ((w32.abs() <= torch.finfo(torch.bfloat16).max)
              & ((w32 == 0) | (w32.abs() >= torch.finfo(torch.float32).tiny)))
    assert torch.equal(_weights(nib, scales, False, parts=2)[normal], w32[normal])
    assert bool(normal[:, 0x0100: 0x7C00].all())


@pytest.mark.parametrize("what", ["default", "mul_bf16", "dot_f32"])
def test_dequant_f32_scales(what):
    """A seeded sweep of 65536 f32 scales (magnitudes 2^-20 to 2^10) over
    every nibble: q (by its magic number) times s in f32, rounded once to
    bf16 by integer operations, is mode_weight's weight bit for bit; under
    LLAMAVK_Q4_MUL=bf16 the scale rounded so, then the bf16 multiply; under
    the f32 dot three bf16 parts leave at most 2^-24 |w| of the f32 w (two
    parts do not)."""
    rng = np.random.default_rng(17)
    s = (2.0 ** rng.uniform(-20, 10, 65536)).astype(np.float32)
    scales = torch.from_numpy(s)[None, :]
    packed = _all_nibbles_plane(scales.shape[1])
    qw = QWeight(packed=packed, scales=scales, layout=LAYOUT_ILV)
    nib = _nibbles_of(packed)
    if what == "dot_f32":
        want = q4.mode_weight(qw, "f32")
        err3 = (_weights(nib, scales, False, parts=3) - want).abs()
        assert bool((err3 <= want.abs() * 2.0**-24).all())
        assert not bool(((_weights(nib, scales, False, parts=2) - want).abs()
                         <= want.abs() * 2.0**-24).all())
        return
    mul_bf16 = what == "mul_bf16"
    want = q4.mode_weight(qw, "bf16", torch.bfloat16 if mul_bf16 else torch.float32)
    assert torch.equal(_weights(nib, scales, mul_bf16), want)


# the GEMV kernel's geometry (csrc/q4_matmul.cu, namespace gemv)
BN, WARPS = q4.GEMV_BN, q4.GEMV_WARPS


def emulate_gemv(x: torch.Tensor, qw: QWeight, ksplit: int, dot: str = "bf16") -> torch.Tensor:
    """The GEMV kernel's arithmetic for rows x [R, K] (each row one launch),
    lane by lane, the 32 lanes of a warp at once: block (tile, split) stages
    x in its k order; warp w takes units w, w + WARPS, ... of the split;
    lane (g, t) loads its 16 columns 16 g .. 16 g + 15 of packed rows
    8s + 2t + j of a unit (`chunk`), and for k step s feeds each column's
    k pairs (the low nibbles of rows j = 0, 1; their high nibbles) against
    the x pairs at kl, kh of the stage (`mma_unit`); an MMA sums a column's
    16 k over the four lanes t of its g; the warps add in warp order, the
    splits in split order. Returns [R, N] f32."""
    r, k = x.shape
    n = qw.packed.shape[1]
    units = k // 32
    lin = qw.layout == LAYOUT_LIN
    ups = -(-units // ksplit)
    splits = -(-units // ups)
    pk = qw.packed.view(torch.uint8).to(torch.int32)
    xf = x.float()
    g = torch.arange(8)[:, None, None]
    t = torch.arange(4)[None, :, None]
    out = torch.zeros(r, n)
    # the f32 dot: two bf16 parts over bf16 scales; over f32 scales the
    # exact f32 w by fmaf
    parts_w = (0 if qw.scales.dtype == torch.float32 else 2) if dot == "f32" else 1
    for tile in range(-(-n // BN)):
        n0 = tile * BN
        cols = n0 + 16 * g + torch.arange(16)  # [8, 1, 16]: lane group g's columns
        ok = cols < n
        cc = cols.clamp(max=n - 1)
        total = None
        for y in range(splits):
            u_begin = y * ups
            nb = min(units, u_begin + ups) - u_begin
            xs = (torch.cat([xf[:, 16 * u_begin: 16 * (u_begin + nb)],
                             xf[:, k // 2 + 16 * u_begin: k // 2 + 16 * (u_begin + nb)]], 1)
                  if lin else xf[:, 32 * u_begin: 32 * (u_begin + nb)])
            block = None
            for warp in range(WARPS):
                acc = torch.zeros(r, 8, 16)  # column 16 g + c's MMA sums
                for u in range(u_begin + warp, u_begin + nb, WARPS):
                    j_u = u - u_begin
                    srow = (u // 2, units // 2 + u // 2) if lin else (u, u)
                    s_lo = torch.where(ok, qw.scales[srow[0], cc], 0)
                    s_hi = torch.where(ok, qw.scales[srow[1], cc], 0)
                    for s in range(2):
                        byt = []
                        for j in range(2):
                            m = 8 * s + 2 * t + j  # [1, 4, 1]
                            prow = 16 * u + m if lin else m * units + u
                            byt.append(torch.where(ok, pk[prow, cc], 0))  # [8, 4, 16]
                        kl = (16 * j_u if lin else 32 * j_u) + 8 * s + 2 * t[0, :, 0]  # [4]
                        kh = 16 * nb + kl if lin else kl + 16
                        b = [xs[:, kk][:, None, :, None] for kk in (kl, kl + 1, kh, kh + 1)]
                        w = [_weights(byt[0] & 15, s_lo, False, parts_w),
                             _weights(byt[1] & 15, s_lo, False, parts_w),
                             _weights(byt[0] >> 4, s_hi, False, parts_w),
                             _weights(byt[1] >> 4, s_hi, False, parts_w)]
                        lane = sum(wi[None] * bi for wi, bi in zip(w, b))  # [R, 8, 4, 16]
                        acc = acc + lane.sum(dim=2)
                # lane (g, t) writes its columns 4t .. 4t + 3 (MMAs 2t, 2t + 1)
                acc = acc.reshape(r, BN)
                block = acc if block is None else block + acc
            total = block if total is None else total + block
        hi = min(n, n0 + BN)
        out[:, n0:hi] = total[:, : hi - n0]
    return out


def _weight(k: int, n: int, layout: str, seed: int, scale_dtype=torch.bfloat16):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((n, k)) * 0.1).astype(np.float32)
    d, q = quantize_q4_0(w)
    pk = repack_q4_0(d, q, layout=layout)
    return pk, qweight_from_packed(pk, scale_dtype=scale_dtype, device="cpu")


@pytest.mark.parametrize("layout", [LAYOUT_ILV, LAYOUT_LIN])
def test_emulated_gemv_matches_plain_and_jax(layout):
    """The emulation at K = 256 (8 units) over N = 136 (a ragged second
    tile of 8 columns) in 3 splits (3, 3, 2 units; warps with 0-1 units):
    within the kernel's limit 2 K 2^-24 max_n sum_k |x_k w_kn| of the plain
    version, and against the JAX package's K1 (interpret mode) within the
    tolerance of tests/test_torch_ops.py; with a one-hot x it reads back
    row k of mode_weight's weight exactly, at every k of the first and the
    last group (both lin halves)."""
    k, n = 256, 136
    pk, qw = _weight(k, n, layout, seed=3)
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(k).astype(np.float32)
                         ).to(torch.bfloat16)
    got = emulate_gemv(x[None], qw, ksplit=3)[0]
    want = q4.q4_matmul_ref(x[None], qw, torch.float32)[0]
    w = q4.mode_weight(qw)
    limit = 2 * k * 2.0**-24 * float((x.float().abs()[None] @ w.abs()).max())
    assert float((got - want).abs().max()) <= limit
    jqw = jops.qweight_from_packed(pk, scale_dtype=jnp.bfloat16)
    jwant = np.asarray(jops.q4_matmul(jnp.asarray(x.float().numpy(), jnp.bfloat16)[None], jqw,
                                      out_dtype=jnp.float32))[0]
    np.testing.assert_allclose(got.numpy(), jwant, rtol=1e-4, atol=1e-4)
    rows = torch.cat([torch.arange(32), torch.arange(k - 32, k)])
    onehot = torch.zeros(len(rows), k, dtype=torch.bfloat16)
    onehot[torch.arange(len(rows)), rows] = 1
    assert torch.equal(emulate_gemv(onehot, qw, ksplit=3), w[rows])


@pytest.mark.parametrize("scale_dtype", [torch.bfloat16, torch.float32])
def test_emulated_gemv_dot_f32_parts(scale_dtype):
    """Under the f32 dot the emulated GEMV feeds two bf16 parts of each
    weight to the MMAs over bf16 scales, and multiplies the exact f32 w by
    fmaf over f32 scales: in both, one-hot rows read back mode_weight's f32
    weight exactly."""
    k, n = 64, 128
    _, qw = _weight(k, n, LAYOUT_ILV, seed=5, scale_dtype=scale_dtype)
    w = q4.mode_weight(qw, "f32")
    onehot = torch.eye(k, dtype=torch.bfloat16)
    assert torch.equal(emulate_gemv(onehot, qw, ksplit=2, dot="f32"), w)


# the 7B matmuls (K, N), a tp = 2 rank's, the tiny model's and the edges'
SHAPES = [(4096, 12288), (4096, 4096), (4096, 22016), (11008, 4096), (4096, 32000),
          (4096, 6144), (2048, 4096), (4096, 11008), (5504, 4096), (4096, 16000),
          (128, 384), (96, 136), (8192, 1024)]
SMS = (132, 114, 66)


@pytest.mark.parametrize("k,n", SHAPES)
def test_gemv_split_rule(k, n):
    """Whole units a split (all but the last of one size, none empty), at
    most 256 units a split, at least a unit per warp where K has that many;
    every block of the grid resident at once where the tiles allow it; the
    scratch is [splits, N] (None for one split)."""
    units = k // 32
    tiles = -(-n // BN)
    for sms in SMS:
        ksplit = q4.gemv_ksplit(k, n, sms)
        splits = q4.gemv_splits(k, n, sms)
        ups = -(-units // ksplit)
        assert splits == -(-units // ups) and (splits - 1) * ups < units <= splits * ups
        assert ups <= q4.GEMV_MAX_UPS
        if units >= WARPS and units <= q4.GEMV_MAX_UPS:
            assert ups >= WARPS
        if tiles <= q4.GEMV_BLOCKS_PER_SM * sms and units <= q4.GEMV_MAX_UPS:
            assert tiles * splits <= q4.GEMV_BLOCKS_PER_SM * sms
        assert q4.scratch_shape(1, k, n, sms) == (None if splits == 1 else (splits, n))


def test_gemv_counters_cover_the_grid():
    """One zeroed int32 counter per 128-column tile, per device, grown for a
    wider N and kept otherwise."""
    q4._gemv_counters.clear()
    dev = torch.device("cpu")
    cnt = q4.gemv_counters(dev, 4096)
    assert cnt.dtype == torch.int32 and cnt.numel() >= 32 and not cnt.any()
    assert q4.gemv_counters(dev, 32000) is cnt  # 250 tiles fit the first 1024
    wide = q4.gemv_counters(dev, 2000 * BN)
    assert wide.numel() >= 2000 and not wide.any()
    assert q4.gemv_counters(dev, 128) is wide
    q4._gemv_counters.clear()
