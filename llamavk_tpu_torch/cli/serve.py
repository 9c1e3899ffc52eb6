"""Serving CLI (twin of `llamavk_tpu/cli/serve.py`): start the HTTP front-end
over the continuous-batching engine (`runtime/server.py`), one replica on one
device, bf16 or int8 KV, flat or paged, or flat with the shared-prefix pool
(--shared-prefix: a prefix registered through POST /v1/prefixes is held once,
in bf16, for every slot), with optional prompt-lookup speculation
(--lookup-gamma); or one tensor-parallel replica over --tp N ranks (flat bf16
or int8 KV).

    python -m llamavk_tpu_torch.cli.serve -m model.bin --port 8000 --max-batch 32 \
        --kv-dtype int8 --paged --lookup-gamma 4
    python -m llamavk_tpu_torch.cli.serve -m model.bin --max-batch 32 --kv-dtype int8 \
        --shared-prefix --prefix-pool 4 --prefix-ctx 256
    curl -d '{"prompt": "Hello", "max_tokens": 32}' localhost:8000/v1/completions

    python -m llamavk_tpu_torch.cli.serve -m model.bin --tp 2 --kv-dtype int8

--tp N starts N ranks on this host (this process is rank 0, the HTTP front
door; N - 1 more run this CLI with the hidden --dist-rank), rendezvous
through a file in a fresh temporary directory, and one of the
torch.distributed backends (`parallel.multihost.choose_backend`: NCCL when
every rank has a card of its own, gloo when they share one; printed at
start). Each rank loads the checkpoint packed for tp and keeps its shard.
When rank 0 exits, the others follow its stop message; any left after 10 s
are killed.

--device cpu runs the plain PyTorch versions of the kernels; --port 0 takes
any free port (the server prints the one it took). --no-int4-weights is
accepted and ignored, as the JAX CLI ignores it off the TPU. --dp (slot
sharding), --replicas, and --paged, --shared-prefix or --lookup-gamma under
--tp are not ported yet: the CLI rejects them and names ROADMAP.md.
"""

from __future__ import annotations

import argparse
import signal
import subprocess
import sys
import tempfile
from pathlib import Path

from ..models.loader import load_model
from ..parallel import multihost
from ..runtime.batching import BatchConfig
from ..runtime.server import LlamaServer, follow_rank

NOT_PORTED = "is not ported yet (ROADMAP.md queue 1, item 6)"
# (flag, takes a value) of the reference CLI's options the port refuses above 1
UNPORTED = (("--dp", True), ("--replicas", True))


class _Parser(argparse.ArgumentParser):
    """Refuses the flag combinations the JAX CLI refuses (serve.py:81-83
    there; its --dp and --replicas combinations come with those options),
    and the options the port does not run yet, when the flags are parsed."""

    def parse_args(self, args=None, namespace=None):
        ns = super().parse_args(args, namespace)
        if ns.shared_prefix and ns.paged:
            self.error("--shared-prefix and --paged are exclusive "
                       "(the block table IS the sharing mechanism)")
        if ns.tp < 1:
            self.error("--tp must be at least 1")
        for flag, _ in UNPORTED:
            if getattr(ns, flag[2:]) > 1:
                self.error(f"{flag} {NOT_PORTED}")
        if ns.tp > 1:
            for flag, on in (("--paged", ns.paged), ("--shared-prefix", ns.shared_prefix),
                             ("--lookup-gamma", ns.lookup_gamma > 0)):
                if on:
                    self.error(f"{flag} under --tp {NOT_PORTED}")
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
    ap.add_argument("--tp", type=int, default=1,
                    help="tensor-parallel degree: one replica over tp ranks on this host "
                    "(Megatron split; the weights packed to match)")
    ap.add_argument("--dp", type=int, default=1,
                    help="data-parallel degree (slot sharding): not ported yet")
    ap.add_argument("--replicas", type=int, default=1,
                    help="independent model replicas: not ported yet")
    ap.add_argument("--model-name", default=None)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the hand-written kernels) or cpu (their plain versions)")
    # a --tp rank started by rank 0: its rank and the rendezvous file
    ap.add_argument("--dist-rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--dist-init", default=None, help=argparse.SUPPRESS)
    return ap


def _bcfg(args) -> BatchConfig:
    return BatchConfig(
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


def run_rank(rank: int, tp: int, init: str, load, bcfg: BatchConfig, serve,
             device: str = "cuda", model_name: str | None = None,
             timeout_s: float = multihost.DEFAULT_TIMEOUT_S) -> None:
    """One rank of `--tp N`: join the group of `tp` ranks through `init`,
    build the tp mesh, take the tp-packed model `load()` returns ((cfg,
    params, tokenizer); each rank keeps its shard, on its device), then
    rank 0 builds the LlamaServer over the mesh and hands it to
    `serve(server)`, and the other ranks follow it (`follow_rank`) until it
    stops."""
    from ..parallel import make_mesh

    multihost.initialize(init, tp, rank, device=device, timeout_s=timeout_s)
    try:
        mesh = make_mesh(tp=tp, dp=1, device=device)
        cfg, params, tok = load()
        if rank == 0:
            server = LlamaServer(cfg, params, tok, bcfg, model_name=model_name, mesh=mesh)
            del params  # the engine keeps its shard
            serve(server)
        else:
            follow_rank(cfg, params, bcfg, mesh)
    finally:
        multihost.shutdown()


def _run_rank(args, rank: int, init: str) -> None:
    """`run_rank` for the CLI: the checkpoint loaded on the host, packed
    for tp, and rank 0 serving on --host:--port until it is stopped."""
    run_rank(rank, args.tp, init, lambda: load_model(args.model, device="cpu", tp=args.tp),
             _bcfg(args), lambda server: server.serve_forever(args.host, args.port),
             args.device, args.model_name)


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    args = build_argparser().parse_args(argv)
    if args.tp == 1:
        cfg, params, tok = load_model(args.model, device=args.device)
        server = LlamaServer(cfg, params, tok, _bcfg(args), model_name=args.model_name,
                             device=args.device)
        server.serve_forever(args.host, args.port)
        return
    if args.dist_rank is not None:
        _run_rank(args, args.dist_rank, args.dist_init)
        return
    # SIGTERM unwinds rank 0 like ^C, so that its server sends the others
    # their stop message before it exits
    signal.signal(signal.SIGTERM, lambda *_: sys.exit(143))
    init = "file://" + str(Path(tempfile.mkdtemp(prefix="llamavk-tp-")) / "rendezvous")
    workers = [subprocess.Popen([sys.executable, "-m", "llamavk_tpu_torch.cli.serve", *argv,
                                 "--dist-rank", str(r), "--dist-init", init])
               for r in range(1, args.tp)]
    try:
        _run_rank(args, 0, init)
    finally:
        for w in workers:
            try:
                w.wait(timeout=10)
            except subprocess.TimeoutExpired:
                w.kill()
                w.wait()


if __name__ == "__main__":
    main()
