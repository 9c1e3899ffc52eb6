"""Generation CLI (twin of `llamavk_tpu/cli/generate.py`, one-shot mode).

Prompt eval + streaming decode with the sampling flags of examples/main
(top-k/top-p/temp/repeat-penalty/repeat-last-n), --ignore-eos, and --n-keep
with infinite generation past the context: --ctx-swap reeval keeps n_keep
prompt tokens and re-feeds half of the recent window on overflow
(main.cpp:246-266), --ctx-swap ring keeps min(n_keep, ctx/2) pinned rows in a
history-ring KV cache and never re-evaluates. A bf16 or int8 KV cache
(--kv-dtype), and speculative decoding: --draft-lookup drafts from the
context itself (prompt lookup), --draft-model from a second checkpoint,
--draft-n tokens per round (neither under a ring, as there). Interactive and
instruct modes are not ported yet; argparse rejects their flags.
LLAMAVK_Q4_DOT=i8 in the environment takes the int8 dot (K5) where the JAX
package takes it.

    python -m llamavk_tpu_torch.cli.generate -m model.bin -p "text" --device cuda
    python -m llamavk_tpu_torch.cli.generate -m model.bin -p "text" --draft-lookup --temp 0
    python -m llamavk_tpu_torch.cli.generate -m model.bin -p "text" --ctx-swap ring --n-keep 32
"""

from __future__ import annotations

import argparse
import sys
import time

from ..models.loader import load_model
from ..runtime.engine import Engine, EngineConfig
from ..runtime.sampling import SamplerParams
from ..runtime.speculative import LookupEngine, SpecConfig, SpeculativeEngine
from ..tokenizer import EOS_ID


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("-m", "--model", required=True)
    ap.add_argument("-p", "--prompt", default="")
    ap.add_argument("-f", "--file", help="read prompt from file")
    ap.add_argument("-n", "--n-predict", type=int, default=128)
    ap.add_argument("-c", "--ctx-size", type=int, default=512)
    ap.add_argument("-s", "--seed", type=int, default=-1)
    ap.add_argument("--top-k", type=int, default=40)
    ap.add_argument("--top-p", type=float, default=0.95)
    ap.add_argument("--temp", type=float, default=0.8)
    ap.add_argument("--repeat-penalty", type=float, default=1.10)
    ap.add_argument("--repeat-last-n", type=int, default=64)
    ap.add_argument("--ignore-eos", action="store_true")
    ap.add_argument("--n-keep", type=int, default=0)
    ap.add_argument(
        "--ctx-swap", choices=["reeval", "ring"], default="reeval",
        help="context-overflow strategy: reeval = keep n_keep + re-feed half the window "
        "(main.cpp:246-266 parity); ring = history-ring KV, no re-eval")
    ap.add_argument("--kv-dtype", choices=["bfloat16", "int8"], default="bfloat16",
                    help="KV cache type: bf16, or int8 with per-row scales")
    ap.add_argument("--draft-model", default=None,
                    help="speculative decoding: a smaller checkpoint drafts the tokens the "
                    "model verifies (greedy only; the output is the plain greedy stream)")
    ap.add_argument("--draft-n", type=int, default=4,
                    help="draft tokens proposed per verify round (gamma)")
    ap.add_argument("--draft-lookup", action="store_true",
                    help="speculative decoding without a draft model: draft from the most "
                    "recent matching 2-gram of the context (prompt lookup); a round costs "
                    "about one decode step and emits 1..draft-n tokens")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the hand-written kernels) or cpu (their plain versions)")
    return ap


class ContextManager:
    """Infinite generation: when the context fills, keep the first n_keep
    tokens and re-feed the last half of the remaining window."""

    def __init__(self, engine: Engine, n_ctx: int, n_keep: int):
        self.engine = engine
        self.n_ctx = n_ctx
        self.n_keep = n_keep

    def ensure_room(self, needed: int) -> None:
        e = self.engine
        if e.n_past + needed <= self.n_ctx:
            return
        # the last sampled token is not in the cache yet: it stays pending, so
        # the next generate() evaluates it and samples from its logits
        backlog = e.tokens[e.n_past :]
        n_left = e.n_past - self.n_keep
        keep_tokens = e.tokens[: self.n_keep]
        refeed = e.tokens[max(self.n_keep, e.n_past - n_left // 2) : e.n_past]
        e.reset()
        if keep_tokens:
            e.eval(keep_tokens)
        if refeed:
            e.eval(refeed)
        e.tokens = list(keep_tokens) + list(refeed) + list(backlog)


def run(args, stdout=sys.stdout) -> int:
    t_load0 = time.perf_counter()
    cfg, params, tok = load_model(args.model, device=args.device)

    prompt = args.prompt
    if args.file:
        with open(args.file) as f:
            prompt = f.read()
    # reference behavior: prepend a space to the prompt (main.cpp:138-141)
    prompt_tokens = tok.encode(" " + prompt, bos=True)
    # --n-keep -1 = keep the whole prompt (main.cpp:151-153)
    n_keep = args.n_keep if args.n_keep > 0 else len(prompt_tokens)

    ring = args.ctx_swap == "ring"
    engine = Engine(
        cfg, params,
        EngineConfig(n_ctx=args.ctx_size, kv_dtype=args.kv_dtype,
                     seed=args.seed if args.seed >= 0 else 0, ctx_ring=ring,
                     ring_keep=min(n_keep, args.ctx_size // 2) if ring else 0),
        device=args.device,
    )
    engine.timings.t_load_us = (time.perf_counter() - t_load0) * 1e6
    sp = SamplerParams(
        top_k=args.top_k,
        top_p=args.top_p,
        temp=args.temp,
        repeat_penalty=args.repeat_penalty,
        repeat_last_n=args.repeat_last_n,
    )
    ctxman = ContextManager(engine, args.ctx_size, min(n_keep, args.ctx_size // 2))
    if args.draft_lookup and _lookup(args, cfg, params, tok, prompt_tokens, sp, stdout):
        return 0
    if args.draft_model and _draft_model(args, cfg, params, tok, prompt_tokens, stdout):
        return 0

    def stream(t: int) -> bool:
        stdout.write(tok.decode_token(t).decode("utf-8", errors="replace"))
        stdout.flush()
        return True

    # echo the prompt like the reference main (input echo on by default)
    stdout.write(b"".join(tok.decode_token(t) for t in prompt_tokens).decode(
        "utf-8", errors="replace"))
    stdout.flush()

    pending = prompt_tokens
    remaining = args.n_predict
    while remaining > 0:
        if ring:
            n = remaining  # the ring absorbs overflow; no swap, no re-eval
        else:
            ctxman.ensure_room(len(pending) + 1)
            n = min(remaining, args.ctx_size - engine.n_past - len(pending))
        if n <= 0:
            break
        got = engine.generate(pending, n, sp, on_token=stream, ignore_eos=args.ignore_eos)
        remaining -= len(got)
        if not got or (not args.ignore_eos and got[-1] == EOS_ID):
            break
        pending = []  # the last sampled token is pending in engine.tokens
    stdout.write("\n")
    print(engine.timings.report(), file=sys.stderr)
    return 0


def _write_tokens(tok, out: list[int], stdout) -> None:
    stdout.write(b"".join(tok.decode_token(t) for t in out).decode("utf-8", errors="replace"))
    stdout.write("\n")


def _lookup(args, cfg, params, tok, prompt_tokens, sp, stdout) -> bool:
    """--draft-lookup (generate.py:202-253 there): single-shot, the budget
    clamped to what fits, since the speculative engines do no context swap.
    Returns False, after a warning, where it falls back to plain decode."""
    if args.ctx_swap == "ring" or not (args.temp <= 0 or args.repeat_penalty == 1.0):
        print("warning: --draft-lookup requires non-interactive, non-ring, and repeat-penalty "
              "1.0 when sampling; ignoring", file=sys.stderr)
        return False
    g = max(1, args.draft_n)
    scfg = SpecConfig(n_ctx=args.ctx_size, gamma=g, kv_dtype=args.kv_dtype)
    budget = args.ctx_size - len(prompt_tokens) - (scfg.rounds_per_block * g + g + 1)
    if budget < 1:
        print("warning: prompt leaves no room for --draft-lookup decoding; falling back to "
              "plain decode", file=sys.stderr)
        return False
    if budget < args.n_predict:
        print(f"warning: --draft-lookup clamps -n to {budget} (no context shift in "
              "speculative mode)", file=sys.stderr)
    spec = LookupEngine(cfg, params, scfg, device=args.device)
    out = spec.generate(prompt_tokens, min(args.n_predict, budget), ignore_eos=args.ignore_eos,
                        sp=sp if args.temp > 0 else None,
                        seed=args.seed if args.seed >= 0 else 0)
    _write_tokens(tok, out, stdout)
    st = spec.stats
    print(f"lookup-speculative: {st['emitted']} tokens in {st['rounds']} rounds "
          f"({st['emitted'] / max(st['rounds'], 1):.2f} tok/round, "
          f"{1e3 * spec.t_rounds / max(st['rounds'], 1):.2f} ms/round)", file=sys.stderr)
    return True


def _draft_model(args, cfg, params, tok, prompt_tokens, stdout) -> bool:
    """--draft-model (generate.py:255-290 there): greedy only, single-shot.
    Returns False, after a warning, when sampling asks for plain decode."""
    if args.temp > 0 or args.ctx_swap == "ring":
        print("warning: --draft-model requires --temp 0, non-interactive, non-ring; ignoring "
              "the draft", file=sys.stderr)
        return False
    dcfg, dparams, _ = load_model(args.draft_model, device=args.device)
    spec = SpeculativeEngine(cfg, params, dcfg, dparams,
                             SpecConfig(n_ctx=args.ctx_size, gamma=max(1, args.draft_n),
                                        kv_dtype=args.kv_dtype), device=args.device)
    out = spec.generate(prompt_tokens, args.n_predict, ignore_eos=args.ignore_eos)
    _write_tokens(tok, out, stdout)
    st = spec.stats
    print(f"speculative: {st['emitted']} tokens in {st['rounds']} rounds, acceptance "
          f"{spec.acceptance_rate:.0%} ({st['accepted']} drafts accepted, "
          f"{1e3 * spec.t_rounds / max(st['rounds'], 1):.2f} ms/round)", file=sys.stderr)
    return True


def main(argv=None):
    args = build_argparser().parse_args(argv)
    return run(args)


if __name__ == "__main__":
    sys.exit(main())
