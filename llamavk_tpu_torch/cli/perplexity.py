"""Perplexity harness (twin of `llamavk_tpu/cli/perplexity.py`) — parity with
examples/perplexity (`examples/perplexity/perplexity.cpp:22-79`).

Tokenizes the input text (BOS prepended), splits into n_ctx-token chunks,
evaluates each chunk with logits_all, and accumulates NLL over the second
half of each window (positions n_ctx/2 .. n_ctx-1 predicting the next
token), printing running perplexity per chunk. The NLL reduction runs on the
device: only [T-1] floats reach the host per chunk.

`--f32` is the numerics-oracle mode: f32 activations, f32 scale planes and
dense weights, the einsum attention over an f32 KV cache, as the JAX CLI
builds it. Runs on the card unless `--device cpu`.

    python -m llamavk_tpu_torch.cli.perplexity -m model.bin -f wiki.test.raw
"""

from __future__ import annotations

import argparse
import math
import sys
import time

import numpy as np
import torch

from ..models.llama import init_kv_cache, init_paged_kv_cache, llama_forward
from ..models.loader import load_model


def make_chunk_nll(cfg, n_ctx: int, dtype=torch.bfloat16, attn_impl: str = "auto",
                   kv_dtype=None, ggml_rounding: str | None = None,
                   paged: bool = False, page_size: int = 32):
    """Per-chunk NLL: chunk_nll(params, tokens [1, T]) → nll [T-1] f32 on the
    tokens' device.

    nll[j] is the negative logprob of tokens[j+1] given positions 0..j —
    the quantity perplexity.cpp:66-75 computes per position. The KV cache is
    f32 when `dtype` is f32, else bf16, unless `kv_dtype` says otherwise.
    paged=True evaluates the chunk through a page pool (an identity table
    over pages 1..n_ctx/page_size; page 0 is the trash page by convention).
    The ggml numerics oracle
    (`ggml_rounding`) is not ported yet (ROADMAP.md queue 1)."""
    if ggml_rounding:
        raise NotImplementedError("perplexity: ggml_rounding is not ported yet (ROADMAP.md "
                                  "queue 1, item 5)")
    kv = kv_dtype if kv_dtype is not None else (
        torch.float32 if dtype == torch.float32 else torch.bfloat16
    )
    if paged and n_ctx % page_size:
        # a truncated table would under-cover the chunk tail
        raise ValueError(
            f"paged perplexity: n_ctx ({n_ctx}) must be a multiple of page_size ({page_size})"
        )

    def chunk_nll(params, tokens: torch.Tensor) -> torch.Tensor:
        dev = tokens.device
        extra = {}
        if paged:
            nb = n_ctx // page_size
            cache = init_paged_kv_cache(cfg, nb + 1, page_size, kv, dev)
            extra["page_table"] = torch.arange(1, nb + 1, dtype=torch.int32, device=dev)[None]
        else:
            cache = init_kv_cache(cfg, 1, n_ctx, kv, dev)
        logits, _, _ = llama_forward(params, tokens, cache, 0, cfg, logits_all=True,
                                     dtype=dtype, attn_impl=attn_impl, **extra)
        logp = torch.log_softmax(logits[0].to(torch.float32), dim=-1)  # [T, V]
        tgt = tokens[0, 1:].to(torch.int64)
        return -logp[:-1].gather(1, tgt[:, None])[:, 0]

    return chunk_nll


def perplexity_chunks(
    cfg, params, tokenizer, text: str | bytes, n_ctx: int = 512,
    max_chunks: int | None = None, dtype=torch.bfloat16, attn_impl: str = "auto",
    kv_dtype=None, verbose: bool = True, ggml_rounding: str | None = None,
    paged: bool = False, page_size: int = 32,
) -> list[float]:
    """Returns the running perplexity after each chunk (the reference's
    `[i]x.xxxx,` sequence). Chunks run on the device that holds `params`."""
    tokens = tokenizer.encode(text, bos=True)
    n_chunks = len(tokens) // n_ctx
    if max_chunks is not None:
        n_chunks = min(n_chunks, max_chunks)
    if n_chunks == 0:
        raise ValueError(f"text too short: {len(tokens)} tokens < n_ctx {n_ctx}")
    chunk_nll = make_chunk_nll(cfg, n_ctx, dtype=dtype, attn_impl=attn_impl,
                               kv_dtype=kv_dtype, ggml_rounding=ggml_rounding,
                               paged=paged, page_size=page_size)
    dev = params.norm.device
    nll, count, out = 0.0, 0, []
    for i in range(n_chunks):
        chunk = np.asarray(tokens[i * n_ctx : (i + 1) * n_ctx], np.int64)
        t0 = time.time()
        nll_vec = chunk_nll(params, torch.from_numpy(chunk)[None].to(dev)).cpu().numpy()
        # NLL over the second half of the window (perplexity.cpp:66-75)
        nll += float(nll_vec[n_ctx // 2 : n_ctx - 1].sum())
        count += (n_ctx - 1) - n_ctx // 2
        ppl = math.exp(nll / count)
        out.append(ppl)
        if verbose:
            print(
                f"chunk {i + 1}/{n_chunks}: ppl {ppl:.4f}  ({time.time() - t0:.2f}s)",
                file=sys.stderr,
                flush=True,
            )
    return out


def perplexity(
    cfg, params, tokenizer, text: str | bytes, n_ctx: int = 512,
    max_chunks: int | None = None, **kw,
) -> float:
    return perplexity_chunks(cfg, params, tokenizer, text, n_ctx, max_chunks, **kw)[-1]


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("-m", "--model", required=True)
    ap.add_argument("-f", "--file", required=True, help="raw text file (e.g. wikitext-2 test)")
    ap.add_argument("-c", "--ctx-size", type=int, default=512)
    ap.add_argument("--max-chunks", type=int, default=None)
    ap.add_argument(
        "--f32", action="store_true",
        help="fp32 activations + fp32 KV (numerics-oracle mode for parity "
        "runs against the C reference)",
    )
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; the CUDA kernels) or cpu (their plain versions)")
    return ap


def main(argv=None):
    args = build_argparser().parse_args(argv)
    dtype = torch.float32 if args.f32 else torch.bfloat16
    cfg, params, tok = load_model(
        args.model, device=args.device,
        **({"scale_dtype": torch.float32, "dense_dtype": torch.float32} if args.f32 else {}),
    )
    with open(args.file, "rb") as f:
        text = f.read()
    ppl = perplexity(cfg, params, tok, text, args.ctx_size, args.max_chunks,
                     dtype=dtype, attn_impl="einsum" if args.f32 else "auto")
    print(f"final perplexity: {ppl:.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
