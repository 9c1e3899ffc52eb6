"""Serving CLI (twin of `llamavk_tpu/cli/serve.py`): start the HTTP front-end
over the continuous-batching engine (`runtime/server.py`), one replica on one
device, flat bf16 or int8 KV.

    python -m llamavk_tpu_torch.cli.serve -m model.bin --port 8000 --max-batch 32 --kv-dtype int8
    curl -d '{"prompt": "Hello", "max_tokens": 32}' localhost:8000/v1/completions

--device cpu runs the plain PyTorch versions of the kernels; --port 0 takes
any free port (the server prints the one it took). Paged KV, the shared
prefix pool, lookup speculation, tensor/data parallelism and replicas are
not ported yet: argparse rejects their flags and says so.
"""

from __future__ import annotations

import argparse

from ..models.loader import load_model
from ..runtime.batching import BatchConfig
from ..runtime.server import LlamaServer


class _NotPorted(argparse.Action):
    """A flag of the JAX package's serve CLI that the port does not take yet."""

    def __call__(self, parser, namespace, values, option_string=None):
        parser.error(f"{option_string} is not ported yet")


# (flag, takes a value) of the reference CLI's unported options
UNPORTED = (
    ("--paged", False), ("--shared-prefix", False), ("--lookup-gamma", True),
    ("--tp", True), ("--dp", True), ("--replicas", True), ("--page-size", True),
    ("--n-pages", True), ("--prefix-pool", True), ("--prefix-ctx", True),
)


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("-m", "--model", required=True)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("-c", "--ctx-size", type=int, default=512,
                    help="per-slot context length")
    ap.add_argument("--max-batch", type=int, default=8,
                    help="concurrent decode slots")
    ap.add_argument("--block", type=int, default=8,
                    help="decode steps per host round-trip")
    ap.add_argument("--admit-chunk", type=int, default=4)
    ap.add_argument("--kv-dtype", choices=["bfloat16", "int8"], default="bfloat16")
    ap.add_argument("--model-name", default=None)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the hand-written kernels) or cpu (their plain versions)")
    for flag, takes_value in UNPORTED:
        ap.add_argument(flag, action=_NotPorted, nargs=None if takes_value else 0,
                        help=argparse.SUPPRESS)
    return ap


def main(argv=None):
    args = build_argparser().parse_args(argv)
    cfg, params, tok = load_model(args.model, device=args.device)
    bcfg = BatchConfig(
        max_batch=args.max_batch,
        n_ctx=args.ctx_size,
        block=args.block,
        admit_chunk=args.admit_chunk,
        kv_dtype=args.kv_dtype,
    )
    server = LlamaServer(cfg, params, tok, bcfg, model_name=args.model_name,
                         device=args.device)
    server.serve_forever(args.host, args.port)


if __name__ == "__main__":
    main()
