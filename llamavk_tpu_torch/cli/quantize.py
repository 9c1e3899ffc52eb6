"""Model quantizer CLI (twin of `llamavk_tpu/cli/quantize.py`) — parity with
examples/quantize + llama_model_quantize_internal (llama.cpp:1465-1577).

Streams tensors from an f16/f32 (or already-quantized) GGML/GGMF/GGJT file,
quantizes every 2-D '*weight' tensor to Q4_0 or Q4_1, writes a GGJT v1 file
readable by both packages and the C reference, and prints per-tensor sizes
plus the 16-bucket nibble histogram. The quantizer is the threaded C++ one of
`native.py` where it builds, else the NumPy reference (`formats/q4.py`):
the same bytes.

usage: python -m llamavk_tpu_torch.cli.quantize model-f16.bin model-q4_0.bin 2
       (type 2 = q4_0, 3 = q4_1 — same codes as the reference CLI)
"""

from __future__ import annotations

import sys
import time

import numpy as np

from ..formats.ggml_io import CheckpointReader, CheckpointWriter, Hparams
from ..formats.q4 import (
    GGML_FTYPE_Q4_0,
    GGML_FTYPE_Q4_1,
    ftype_row_bytes,
)
from ..native import quantize_tensor_with_hist


def quantize_file(path_in: str, path_out: str, ftype: int, verbose: bool = True) -> None:
    if ftype not in (GGML_FTYPE_Q4_0, GGML_FTYPE_Q4_1):
        raise ValueError(f"invalid quantization type {ftype} (2=q4_0, 3=q4_1)")
    r = CheckpointReader(path_in)
    hp = r.hparams
    out_hp = Hparams(
        n_vocab=hp.n_vocab, n_embd=hp.n_embd, n_mult=hp.n_mult, n_head=hp.n_head,
        n_layer=hp.n_layer, n_rot=hp.n_rot, ftype=ftype,
    )
    total_hist = np.zeros(16, np.int64)
    size_in = size_out = 0
    with CheckpointWriter(path_out, out_hp, r.vocab) as w:
        for name, t in r.tensors.items():
            ne = t.ne
            do_quant = len(ne) == 2 and name.endswith("weight")
            n = int(np.prod(ne))
            size_in += t.nbytes
            if do_quant:
                data = r.load_f32(name)  # dequantizes f16 (or q4) to f32 first
                blob, hist = quantize_tensor_with_hist(data, ftype)
                total_hist += hist
                w.write_tensor(name, ne, ftype, blob)
                size_out += len(blob)
                if verbose:
                    dist = " ".join(f"{h / n:.3f}" for h in hist)
                    print(
                        f"{name:>48} {str(tuple(ne)):>16} q{'4_0' if ftype == 2 else '4_1'}"
                        f" | hist: {dist}",
                        file=sys.stderr,
                    )
            else:
                data = r.load_f32(name).astype(np.float32)
                w.write_array(name, data, 0)
                size_out += ftype_row_bytes(0, n)
                if verbose:
                    print(f"{name:>48} {str(tuple(ne)):>16} f32 (kept)", file=sys.stderr)
    tot = total_hist.sum()
    if verbose and tot:
        print(
            "overall nibble histogram: "
            + " ".join(f"{h / tot:.3f}" for h in total_hist),
            file=sys.stderr,
        )
        print(
            f"size: {size_in / 1e6:.1f} MB -> {size_out / 1e6:.1f} MB", file=sys.stderr
        )


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) != 3:
        print(__doc__, file=sys.stderr)
        return 1
    t0 = time.time()
    quantize_file(argv[0], argv[1], int(argv[2]))
    print(f"quantized in {time.time() - t0:.1f}s", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
