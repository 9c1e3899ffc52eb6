"""P4 on Hopper: does an int4-stored weight plane survive the production
decode structure, and what does a layer index read on the device cost?

The port of `tools/bench_i4_stacked.py` (its kernels `kernel_prod` :43 and
`kernel_i4st` :71). The TPU kernels take the layer of an [L, ...] weight
stack through scalar prefetch; here the probe kernel reads it from a device
int32 (`csrc/probe_q4_unpack.cu`, stacked), what a CUDA-graph decode block
needs, where K1 takes a pointer offset from the host.

    python -m llamavk_tpu_torch.tools.bench_i4_stacked [--batch 1 --layers 4]
    python -m llamavk_tpu_torch.tools.bench_i4_stacked --device cpu

Variants at B = --batch (default 1), an L = --layers (default 4) stack, the
7B decode shapes (wqkv, w13, w2, wo, logits), f32 scales, one line a shape
on stderr, each timed as L launches back to back (layers 0..L-1, as the TPU
probe's scan cycles them) and reported per launch:

  prod       the shift unpack over the ilv byte stack, layer read on the card
  i4st       the int4 plane stack (`_unpack.repack_int4`), f32 multiply
  i4st_bf16  the same, bf16 multiply

beside K1 (`ops.q4_matmul.q4_matmul_cuda` on each layer's views: a pointer
offset) timed the same way. `--device cpu` runs the plain versions at
K = N = 256, L = 2.
"""

from __future__ import annotations

import torch

from ..ops import q4_matmul as q4
from . import _common, _unpack
from ._common import QK

SHAPES = [(4096, 12288, "wqkv"), (4096, 22016, "w13"), (11008, 4096, "w2"),
          (4096, 4096, "wo"), (4096, 32000, "logits")]
# (storage, bf16 multiply) of each variant
VARIANTS = {"prod": ("bytes", False), "i4st": ("plane", False), "i4st_bf16": ("plane", True)}


def stacked(name: str, x, stack, scales, idx):
    """Variant `name` on layer idx[0] of a stack: x bf16 [M, K], the ilv
    byte stack [L, K/2, N] (prod) or int4-plane stack [L, G, 4, N], scales
    f32 [L, G, N], idx one int32 on the stack's device -> f32 [M, N]."""
    storage, mulb = VARIANTS[name]
    return _unpack.gemv(f"p4_{name}", x, stack, scales, storage, "shift", mulb, idx=idx)


def stacked_ref(name: str, x, stack, scales, layer: int):
    storage, mulb = VARIANTS[name]
    return _unpack.gemv_ref(x, stack, scales, storage, mulb, layer)


def run(device, reps: int = 20, batch: int = 1, layers: int = 4) -> list[dict]:
    """Every variant at every shape: layer 0 and layer L - 1 within K1's
    limit of the plain version, the plane's weights (layer L - 1) equal to
    the plain ones bit for bit; times per launch over the L layers."""
    cuda = device.type == "cuda"
    timer = _common.Timer(reps) if cuda else None
    gen = torch.Generator(device=device).manual_seed(0)
    idx = torch.arange(layers, dtype=torch.int32, device=device)
    last = layers - 1
    rows = []
    totals = {name: 0.0 for name in VARIANTS}
    totals["K1"] = 0.0
    for k, n, label in SHAPES if cuda else [(256, 256, "tiny")]:
        g = k // QK
        x = _common.random_x(gen, batch, k, device)
        packed, scales = _common.random_q4(gen, k, n, torch.float32, layers, device=device)
        plane = _unpack.repack_int4(packed)

        def k1_layers():
            for layer in range(layers):
                q4.q4_matmul_cuda(x, packed[layer], scales[layer])

        line = []
        for name, (storage, mulb) in VARIANTS.items():
            stack = plane if storage == "plane" else packed
            w = _unpack.weights(stack[last], scales[last], storage, mulb)
            w_bf16 = w.to(torch.bfloat16)
            exact = torch.equal(_unpack.dequant(stack[last], scales[last], storage, "shift",
                                                mulb), w_bf16)
            first = stacked(name, x, stack, scales, idx[0:1])
            first_ok = float((first - stacked_ref(name, x, stack, scales, 0)).abs().max()) <= \
                _common.k1_limit(x, _unpack.weights(stack[0], scales[0], storage, mulb))

            def all_layers(name=name, stack=stack):
                for layer in range(layers):
                    out = stacked(name, x, stack, scales, idx[layer : layer + 1])
                return out

            row = _common.measure(
                f"probe_p4_{name}", name, f"B={batch} {label} K={k} N={n} L={layers}",
                lambda name=name, stack=stack: stacked(name, x, stack, scales,
                                                       idx[last : last + 1]),
                lambda name=name, stack=stack: stacked_ref(name, x, stack, scales, last),
                timer=None, n_bytes=batch * k * 2 + k // 2 * n + g * n * 4 + batch * n * 4,
                n_ops=2.0 * batch * k * n, limit=_common.k1_limit(x, w),
                checks={"weights_exact": exact, "layer0_within_limit": first_ok})
            if cuda:  # per launch, over the L layers back to back
                row["ms"] = timer(all_layers) / layers
                row["plain_ms"] = timer(lambda name=name, stack=stack: stacked_ref(
                    name, x, stack, scales, last), reps=3)
                row["production_ms"] = timer(k1_layers) / layers
                row["library_ms"] = timer(lambda w_bf16=w_bf16: torch.matmul(x, w_bf16))
                row["bound_ms"], row["bound_by"] = _common.bound(row["n_bytes"], 2.0 * batch * k * n)
                totals[name] += row["ms"]
            line.append(row)
            del w
        if cuda:
            totals["K1"] += line[0]["production_ms"]
        _common.log(_common.shape_line(f"B={batch} {label:6s} K={k:5d} N={n:5d}", line, "K1"))
        rows += line
    if cuda:
        _common.log("layer-equivalent sums (wqkv+w13+w2+wo; logits separate):")
        for name, t in totals.items():
            _common.log(f"  {name:10s} {t * 1e3:8.1f}us total over the {len(SHAPES)} shapes")
    return rows


def main(argv=None) -> list[dict]:
    ap = _common.parser(__doc__)
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--layers", type=int, default=None,
                    help="stack depth (default 4 on the card, 2 on the CPU)")
    args = ap.parse_args(argv)
    device = _common.device_of(args)
    layers = args.layers or (4 if device.type == "cuda" else 2)
    return run(device, args.reps, args.batch, layers)


if __name__ == "__main__":
    main()
