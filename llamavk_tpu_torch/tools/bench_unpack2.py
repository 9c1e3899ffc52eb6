"""P3 on Hopper: can another unpack of the 4-bit weights, or another weight
storage, beat K1's shift unpack?

The port of `tools/bench_unpack2.py` (its kernels `kernel_cur` :45,
`kernel_i8shift` :63, `kernel_int4` :83, `kernel_bitcast4` :100,
`perm_probe.kern` :144 and `kernel_i8dot2d` :171), all but i8dot2d in the
probe kernel of `csrc/probe_q4_unpack.cu`, i8dot2d in `csrc/probe_q4_i8.cu`.

    python -m llamavk_tpu_torch.tools.bench_unpack2 [--batch 8]   # the card
    python -m llamavk_tpu_torch.tools.bench_unpack2 --perm-probe
    python -m llamavk_tpu_torch.tools.bench_unpack2 --device cpu

Variants at B = --batch rows (1..8) and the TPU probe's three (K, N), f32
scales, one line a shape on stderr:

  cur          the shift unpack (K1's inner loop; `kernel_cur`)
  i8shift      four nibbles at a time by byte-SIMD (__vsub4), f32 multiply
  i8shift16    the same, the scale rounded to bf16 (bf16 multiply)
  int4         the int4 plane (`_unpack.repack_int4`: 8 k of one column a
               32-bit word, the order the magic-number pair unpack wants),
               bf16 multiply
  int4f32      the same, f32 multiply
  bitcast4     the int4 plane's kernel on the ilv bytes as they lie, bf16
               multiply (its weights are a permutation of the bytes'; the
               plain version multiplies the same permuted weights)
  bitcast4f32  the same, f32 multiply
  i8dot2d      a plain int8 x int8 -> int32 GEMM on the int8 tensor cores
               (mma m16n8k32), max(B, 8) rows rounded up to 8

beside K1 (`ops.q4_matmul.q4_matmul_cuda`: its GEMV at B = 1, GEMM above)
on the same bytes. `--perm-probe` prints where the bitcast view finds each
weight of a 32 x 128 plane (the TPU probe's row-encoded bytes) and times
the decode at the first shape. `--device cpu` runs the plain versions at
K = N = 256.
"""

from __future__ import annotations

import torch

from ..ops import _build
from ..ops import q4_matmul as q4
from . import _common, _unpack
from ._common import QK
from .bench_int8_mxu import _lib as _lib_i8
from .bench_int8_mxu import int_mm_call, library_exact

# (storage, unpack, bf16 multiply) of each unpack variant
VARIANTS = {
    "cur": ("bytes", "shift", False),
    "i8shift": ("bytes", "i8shift", False),
    "i8shift16": ("bytes", "i8shift", True),
    "int4": ("plane", "shift", True),
    "int4f32": ("plane", "shift", False),
    "bitcast4": ("bitcast", "shift", True),
    "bitcast4f32": ("bitcast", "shift", False),
}
launches = {"i8dot2d": 0}


def unpack_variant(name: str, x, packed, scales, plane=None):
    """Variant `name` of VARIANTS: x bf16 [M, K], the ilv bytes [K/2, N]
    (int4: their int4 plane `plane`), scales f32 [G, N] -> f32 [M, N]."""
    storage, unpack, mulb = VARIANTS[name]
    src = plane if storage == "plane" else packed
    return _unpack.gemv(f"p3_{name}", x, src, scales, storage, unpack, mulb)


def unpack_variant_ref(name: str, x, packed, scales, plane=None):
    storage, _, mulb = VARIANTS[name]
    return _unpack.gemv_ref(x, plane if storage == "plane" else packed, scales, storage, mulb)


def i8dot2d_ref(xq: torch.Tensor, w8: torch.Tensor) -> torch.Tensor:
    """Plain version of `i8dot2d`: the exact integer product (float64 holds
    it), converted to f32 once."""
    return (xq.to(torch.float64) @ w8.to(torch.float64)).to(torch.float32)


def i8dot2d(xq: torch.Tensor, w8: torch.Tensor) -> torch.Tensor:
    """xq int8 [R, K] (R 8..32, a multiple of 8) @ w8 int8 [K, N] -> f32
    [R, N], exact in int32 and converted once. CUDA tensors launch the
    kernel, CPU tensors take `i8dot2d_ref`."""
    if not xq.is_cuda:
        return i8dot2d_ref(xq, w8)
    r, k = xq.shape
    n = w8.shape[-1]
    if (xq.dtype, w8.dtype) != (torch.int8, torch.int8) or w8.shape != (k, n) \
            or r % 8 or not 8 <= r <= 32 or k % QK or n % 16:
        raise ValueError(f"probe i8dot2d: xq {tuple(xq.shape)} w8 {tuple(w8.shape)} (int8, "
                         "R 8..32 a multiple of 8, K % 32, N % 16)")
    _common.require_cuda("probe i8dot2d", xq, w8)
    dev = xq.device.index if xq.device.index is not None else torch.cuda.current_device()
    ks = _common.ksplit(k // QK, n, 128, dev, k // QK)
    out = torch.empty((r, n), dtype=torch.float32, device=xq.device)
    partial = torch.empty((ks, r, n), dtype=torch.int32, device=xq.device)
    rc = _lib_i8().probe_i8dot2d_launch(xq.data_ptr(), w8.data_ptr(), out.data_ptr(),
                                        partial.data_ptr(), r, k, n, ks, _common.stream(xq))
    _build.check(rc, "probe_i8dot2d_launch")
    launches["i8dot2d"] += 1
    return out


def run(device, reps: int = 20, batch: int = 8) -> list[dict]:
    """Every variant at every shape against its plain version: the unpack
    variants within K1's limit, with the weights the kernel unpacks equal
    to the plain weights bit for bit; i8dot2d equal."""
    cuda = device.type == "cuda"
    timer = _common.Timer(reps) if cuda else None
    gen = torch.Generator(device=device).manual_seed(0)
    rows = []
    for k, n in _common.PROBE_SHAPES if cuda else _common.CPU_SHAPES:
        g = k // QK
        x = _common.random_x(gen, batch, k, device)
        packed, scales = _common.random_q4(gen, k, n, torch.float32, device=device)
        plane = _unpack.repack_int4(packed)
        shape = f"B={batch} K={k} N={n}"
        prod = (lambda: q4.q4_matmul_cuda(x, packed, scales)) if cuda else None
        line = []
        for name, (storage, unpack, mulb) in VARIANTS.items():
            src = plane if storage == "plane" else packed
            w = _unpack.weights(src, scales, storage, mulb)
            exact = torch.equal(_unpack.dequant(src, scales, storage, unpack, mulb),
                                w.to(torch.bfloat16))
            w_bf16 = w.to(torch.bfloat16)
            line.append(_common.measure(
                f"probe_p3_{name}", name, shape,
                lambda name=name: unpack_variant(name, x, packed, scales, plane),
                lambda name=name: unpack_variant_ref(name, x, packed, scales, plane),
                timer=timer, n_bytes=batch * k * 2 + k // 2 * n + g * n * 4 + batch * n * 4,
                n_ops=2.0 * batch * k * n, limit=_common.k1_limit(x, w), production=prod,
                library=(lambda w_bf16=w_bf16: torch.matmul(x, w_bf16)) if cuda else None,
                checks={"weights_exact": exact}))
            del w
        r = -(-max(batch, 8) // 8) * 8
        xq = torch.randint(-128, 128, (r, k), dtype=torch.int8, device=device, generator=gen)
        w8 = torch.randint(-128, 128, (k, n), dtype=torch.int8, device=device, generator=gen)
        lib_call, lib_name = int_mm_call(xq, w8) if cuda else (None, None)
        row = _common.measure(
            "probe_p3_i8dot2d", "i8dot2d", f"R={r} K={k} N={n}", lambda: i8dot2d(xq, w8),
            lambda: i8dot2d_ref(xq, w8), timer=timer, n_bytes=r * k + k * n + r * n * 4,
            n_ops=2.0 * r * k * n, peak=_common.INT8_OP_PER_S, library=lib_call)
        row["library"] = lib_name
        if cuda:
            row["library_exact"] = library_exact(lib_call, xq, w8)
        line.append(row)
        _common.log(_common.shape_line(f"B={batch} K={k:5d} N={n:5d}", line, "K1"))
        rows += line
    return rows


def perm_probe(device, reps: int = 20) -> list[dict]:
    """Where the bitcast view finds each weight: the TPU probe's 16 x 128
    row-encoded bytes (byte row r: low nibble r % 8, high (r // 8 + 1) % 8)
    decoded by the kernel, each int4 row's column 0 printed with its
    source (`_unpack.bitcast_perm`); then the decode of the first probe
    shape's byte plane (the CPU's small one) against its plain version,
    timed."""
    s, l = 16, 128
    rows_ = torch.arange(s, dtype=torch.int32)
    byte = ((rows_ // 8 + 1) % 8 * 16 + rows_ % 8).to(torch.int8)
    p = byte[:, None].expand(s, l).contiguous().to(device)
    out = _unpack.perm(p).cpu()
    src = _unpack.bitcast_perm(2 * s, l)
    for r4 in range(2 * s):
        br, col, hi = src[r4, 0].tolist()
        _common.log(f"int4 row {r4:2d} = value {int(out[r4, 0])} from byte row {br} "
                    f"column {col} {'hi' if hi else 'lo'}")
    nib = torch.stack([(p.int() << 28) >> 28, p.int() >> 4], dim=-1).cpu()
    consistent = torch.equal(out, nib[src[..., 0], src[..., 1], src[..., 2]].float())
    cuda = device.type == "cuda"
    k, n = _common.PROBE_SHAPES[0] if cuda else _common.CPU_SHAPES[0]
    gen = torch.Generator(device=device).manual_seed(0)
    big = torch.randint(-128, 128, (k // 2, n), dtype=torch.int8, device=device, generator=gen)
    row = _common.measure(
        "probe_p3_perm", "perm", f"S={k // 2} L={n}", lambda: _unpack.perm(big),
        lambda: _unpack.perm_ref(big), timer=_common.Timer(reps) if cuda else None,
        n_bytes=k // 2 * n + k * n * 4, n_ops=0.0, checks={"matches_bitcast_perm": consistent})
    _common.log(_common.shape_line(f"perm S={k // 2:5d} L={n:5d}", [row]))
    return [row]


def main(argv=None) -> list[dict]:
    ap = _common.parser(__doc__)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--perm-probe", action="store_true")
    args = ap.parse_args(argv)
    device = _common.device_of(args)
    if args.perm_probe:
        return perm_probe(device, args.reps)
    return run(device, args.reps, args.batch)


if __name__ == "__main__":
    main()
