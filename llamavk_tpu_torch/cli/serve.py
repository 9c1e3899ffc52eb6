"""Serving CLI (twin of `llamavk_tpu/cli/serve.py`): start the HTTP front-end
over the continuous-batching engine (`runtime/server.py`), one replica on one
device, bf16 or int8 KV, flat or paged, or flat with the shared-prefix pool
(--shared-prefix: a prefix registered through POST /v1/prefixes is held once,
in bf16, for every slot), with optional prompt-lookup speculation
(--lookup-gamma).

    python -m llamavk_tpu_torch.cli.serve -m model.bin --port 8000 --max-batch 32 \
        --kv-dtype int8 --paged --lookup-gamma 4
    python -m llamavk_tpu_torch.cli.serve -m model.bin --max-batch 32 --kv-dtype int8 \
        --shared-prefix --prefix-pool 4 --prefix-ctx 256
    curl -d '{"prompt": "Hello", "max_tokens": 32}' localhost:8000/v1/completions

--device cpu runs the plain PyTorch versions of the kernels; --port 0 takes
any free port (the server prints the one it took). --no-int4-weights is
accepted and ignored, as the JAX CLI ignores it off the TPU. Tensor/data
parallelism and replicas are not ported yet: the CLI rejects their flags
and says so.
"""

from __future__ import annotations

import argparse

from ..models.loader import load_model
from ..runtime.batching import BatchConfig
from ..runtime.server import LlamaServer

# (flag, takes a value) of the reference CLI's unported options
UNPORTED = (("--tp", True), ("--dp", True), ("--replicas", True))


class _NotPorted(argparse.Action):
    """An option of the reference CLI that the port does not have yet."""

    def __call__(self, parser, namespace, values, option_string=None):
        parser.error(f"{option_string} is not ported yet")


class _Parser(argparse.ArgumentParser):
    """Refuses the flag combinations the JAX CLI refuses (serve.py:73-83
    there) when the flags are parsed."""

    def parse_args(self, args=None, namespace=None):
        ns = super().parse_args(args, namespace)
        if ns.shared_prefix and ns.paged:
            self.error("--shared-prefix and --paged are exclusive "
                       "(the block table IS the sharing mechanism)")
        return ns


def build_argparser() -> argparse.ArgumentParser:
    ap = _Parser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("-m", "--model", required=True)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("-c", "--ctx-size", type=int, default=512,
                    help="per-slot context length")
    ap.add_argument("--max-batch", type=int, default=8,
                    help="concurrent decode slots")
    ap.add_argument("--block", type=int, default=8,
                    help="decode steps (lookup: rounds) per host round-trip")
    ap.add_argument("--admit-chunk", type=int, default=4)
    ap.add_argument("--kv-dtype", choices=["bfloat16", "int8"], default="bfloat16")
    ap.add_argument("--paged", action="store_true",
                    help="block-table paged KV (pool memory = pages in use)")
    ap.add_argument("--page-size", type=int, default=128, help="pool page rows")
    ap.add_argument("--n-pages", type=int, default=0,
                    help="pool pages (0 = flat-equivalent footprint); size it smaller to "
                    "oversubscribe slots")
    ap.add_argument("--shared-prefix", action="store_true",
                    help="registered prefixes live in one read-only pool (bf16, non-paged)")
    ap.add_argument("--prefix-pool", type=int, default=4, help="shared-prefix pool entries")
    ap.add_argument("--prefix-ctx", type=int, default=256,
                    help="shared-prefix pool entry rows (a multiple of 256)")
    ap.add_argument("--lookup-gamma", type=int, default=0,
                    help=">0: prompt-lookup speculative decoding, this many rows verified "
                    "per round")
    ap.add_argument("--no-int4-weights", action="store_true",
                    help="accepted for the JAX CLI's sake and ignored: the port keeps the "
                    "byte-packed planes it loads")
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
        paged=args.paged,
        page_size=args.page_size,
        n_pages=args.n_pages,
        shared_prefix=args.shared_prefix,
        prefix_pool=args.prefix_pool,
        prefix_ctx=args.prefix_ctx,
        lookup_gamma=args.lookup_gamma,
    )
    server = LlamaServer(cfg, params, tok, bcfg, model_name=args.model_name,
                         device=args.device)
    server.serve_forever(args.host, args.port)


if __name__ == "__main__":
    main()
