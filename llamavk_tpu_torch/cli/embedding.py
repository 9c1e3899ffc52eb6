"""Embedding extraction CLI (twin of `llamavk_tpu/cli/embedding.py`) — parity
with examples/embedding (`examples/embedding/embedding.cpp`): evaluate the
prompt once and print the final-norm activation vector of the last token
(llama_get_embeddings). Runs on the card unless `--device cpu`.

    python -m llamavk_tpu_torch.cli.embedding -m model.bin -p "text"
"""

from __future__ import annotations

import argparse
import sys

from ..models.loader import load_model
from ..runtime.engine import Engine, EngineConfig


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("-m", "--model", required=True)
    ap.add_argument("-p", "--prompt", default="")
    ap.add_argument("-c", "--ctx-size", type=int, default=512)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; the CUDA kernels) or cpu (their plain versions)")
    return ap


def main(argv=None):
    args = build_argparser().parse_args(argv)
    cfg, params, tok = load_model(args.model, device=args.device)
    engine = Engine(cfg, params, EngineConfig(n_ctx=args.ctx_size), device=args.device)
    ids = tok.encode(" " + args.prompt, bos=True)
    engine.eval(ids)
    emb = engine.get_embeddings()
    print(" ".join(f"{v:.6f}" for v in emb))
    print(engine.timings.report(), file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
