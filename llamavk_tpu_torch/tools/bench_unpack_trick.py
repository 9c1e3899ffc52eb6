"""P1 on Hopper: does the magic-number bf16 unpack beat the shift unpack in
K1's inner loop?

The port of `tools/bench_unpack_trick.py` (its kernels `kernel_current` :33
and `kernel_trick` :52). The bf16 bit pattern of 136 + q, for a signed
nibble q, is 0x4300 | ((q ^ 8) & 15), so two weights come out of a packed
32-bit word with one mask-and-xor (lop3) and one bf16x2 subtraction, no
conversions (`csrc/probe_q4_unpack.cu`). Unlike the TPU probe, the trick is
wired: its weights are bit-equal to the shift unpack's.

    python -m llamavk_tpu_torch.tools.bench_unpack_trick            # the card
    python -m llamavk_tpu_torch.tools.bench_unpack_trick --device cpu

Variants, each on the same seeded bytes (bf16 scales, B = 8, K 4096, N
11008, as the TPU probe), one line on stderr:

  current  the probe kernel with K1's shift unpack (`kernel_current`)
  trick    the probe kernel with the magic-number unpack (`kernel_trick`)

beside K1 itself (`ops.q4_matmul.q4_matmul_cuda`, its GEMM at M = 8) on the
same bytes, the production baseline. `--device cpu` runs the plain versions
at K = N = 256.
"""

from __future__ import annotations

import torch

from ..ops import q4_matmul as q4
from . import _common, _unpack
from ._common import QK

SHAPES = [(4096, 11008)]
B = 8


def current(x, packed, scales):
    """The shift unpack (K1's) in the probe kernel: x bf16 [M, K] (original
    k order), packed int8 [K/2, N] ilv, scales bf16 [G, N] -> f32 [M, N]."""
    return _unpack.gemv("p1_current", x, packed, scales, "bytes", "shift")


def trick(x, packed, scales):
    """The magic-number unpack in the probe kernel, as `current`."""
    return _unpack.gemv("p1_trick", x, packed, scales, "bytes", "trick")


def plain(x, packed, scales):
    """Plain version of both: the same weights bf16(f32(q) * s)."""
    return _unpack.gemv_ref(x, packed, scales, "bytes")


def run(device, reps: int = 20) -> list[dict]:
    """Every variant at every shape (K = N = 256 on the CPU): rows of
    `_common.measure`; trick's row also holds its weights bit-equal to the
    shift unpack's, as the kernels unpack them."""
    cuda = device.type == "cuda"
    timer = _common.Timer(reps) if cuda else None
    gen = torch.Generator(device=device).manual_seed(0)
    rows = []
    for k, n in SHAPES if cuda else _common.CPU_SHAPES:
        x = _common.random_x(gen, B, k, device)
        packed, scales = _common.random_q4(gen, k, n, torch.bfloat16, device=device)
        w = _unpack.byte_weights(packed, scales)
        w_bf16 = w.to(torch.bfloat16)
        n_bytes = B * k * 2 + k // 2 * n + k // QK * n * 2 + B * n * 4
        shape = f"B={B} K={k} N={n}"
        same = torch.equal(_unpack.dequant(packed, scales, "bytes", "trick"),
                           _unpack.dequant(packed, scales, "bytes", "shift"))
        line = []
        for name, fn in (("current", current), ("trick", trick)):
            line.append(_common.measure(
                f"probe_p1_{name}", name, shape, lambda fn=fn: fn(x, packed, scales),
                lambda: plain(x, packed, scales), timer=timer, n_bytes=n_bytes,
                n_ops=2.0 * B * k * n, limit=_common.k1_limit(x, w),
                production=(lambda: q4.q4_matmul_cuda(x, packed, scales)) if cuda else None,
                library=(lambda: torch.matmul(x, w_bf16)) if cuda else None,
                checks={"weights_bit_equal_to_shift": same} if name == "trick" else None))
        _common.log(_common.shape_line(f"B={B} K={k:5d} N={n:5d}", line, "K1"))
        rows += line
    return rows


def main(argv=None) -> list[dict]:
    args = _common.parser(__doc__).parse_args(argv)
    return run(_common.device_of(args), args.reps)


if __name__ == "__main__":
    main()
