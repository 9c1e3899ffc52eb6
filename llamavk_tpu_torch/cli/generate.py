"""Generation CLI (twin of `llamavk_tpu/cli/generate.py`).

Prompt eval + streaming decode with the sampling flags of examples/main
(top-k/top-p/temp/repeat-penalty/repeat-last-n), --ignore-eos, and --n-keep
with infinite generation past the context: --ctx-swap reeval keeps n_keep
prompt tokens and re-feeds half of the recent window on overflow
(main.cpp:246-266), --ctx-swap ring keeps min(n_keep, ctx/2) pinned rows in a
history-ring KV cache and never re-evaluates. A bf16 or int8 KV cache
(--kv-dtype), and speculative decoding: --draft-lookup drafts from the
context itself (prompt lookup), --draft-model from a second checkpoint,
--draft-n tokens per round (neither under a ring or interactively, as
there). Interactive mode (-i) with reverse-prompt detection (-r), instruct
mode (-ins, the Alpaca prefix and suffix), the SIGINT interject (the first
^C drops to the input prompt, a second exits 130), ANSI --color, the --mtest
memory probe (-b tokens at n_past 0, then one at n_past n_predict-1) and
--random-prompt, as main.cpp does. --no-int4-weights is accepted and ignored,
as the JAX CLI ignores it off the TPU. LLAMAVK_Q4_DOT (i8, f32) and
LLAMAVK_Q4_MUL=bf16 in the environment pick K1's or K5's numerics as they do
in the JAX package.

    python -m llamavk_tpu_torch.cli.generate -m model.bin -p "text" --device cuda
    python -m llamavk_tpu_torch.cli.generate -m model.bin -i -r "User:" -f chat.txt
    python -m llamavk_tpu_torch.cli.generate -m model.bin -p "text" --draft-lookup --temp 0
    python -m llamavk_tpu_torch.cli.generate -m model.bin -p "text" --ctx-swap ring --n-keep 32
"""

from __future__ import annotations

import argparse
import random
import signal
import sys
import time

from ..models.loader import load_model
from ..runtime.engine import Engine, EngineConfig
from ..runtime.sampling import SamplerParams
from ..runtime.speculative import LookupEngine, SpecConfig, SpeculativeEngine
from ..tokenizer import EOS_ID

INSTRUCT_PREFIX = "\n\n### Instruction:\n\n"
INSTRUCT_SUFFIX = "\n\n### Response:\n\n"

# ANSI colors (common.cpp:271-302): prompt echo yellow, user input bold
# green, generated text default
ANSI_RESET = "\x1b[0m"
ANSI_YELLOW = "\x1b[33m"
ANSI_BOLD_GREEN = "\x1b[1m\x1b[32m"

# the reference's starter pool for --random-prompt (common.cpp:256-267)
RANDOM_PROMPTS = [
    "So", "Once upon a time", "When", "The", "After", "If", "import",
    "He", "She", "They",
]


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
    ap.add_argument("--no-int4-weights", action="store_true",
                    help="accepted for the JAX CLI's sake and ignored: the port keeps the "
                    "byte-packed planes it loads")
    ap.add_argument("--draft-model", default=None,
                    help="speculative decoding: a smaller checkpoint drafts the tokens the "
                    "model verifies (greedy only; the output is the plain greedy stream)")
    ap.add_argument("--draft-n", type=int, default=4,
                    help="draft tokens proposed per verify round (gamma)")
    ap.add_argument("--draft-lookup", action="store_true",
                    help="speculative decoding without a draft model: draft from the most "
                    "recent matching 2-gram of the context (prompt lookup); a round costs "
                    "about one decode step and emits 1..draft-n tokens")
    ap.add_argument("-i", "--interactive", action="store_true")
    ap.add_argument("-r", "--reverse-prompt", action="append", default=[])
    ap.add_argument("-ins", "--instruct", action="store_true")
    ap.add_argument("--color", action="store_true",
                    help="ANSI colors: prompt yellow, user input green (common.cpp)")
    ap.add_argument("--mtest", action="store_true",
                    help="memory probe: eval a full batch at n_past=0 and one token at "
                    "n_past=n_predict-1, print timings, exit (main.cpp:119-135)")
    ap.add_argument("--random-prompt", action="store_true",
                    help="start with a random short prompt when -p is empty")
    ap.add_argument("-b", "--batch-size", type=int, default=8)
    ap.add_argument("--verbose", action="store_true")
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


def run(args, stdin=sys.stdin, stdout=sys.stdout) -> int:
    t_load0 = time.perf_counter()
    cfg, params, tok = load_model(args.model, device=args.device)

    prompt = args.prompt
    if args.file:
        with open(args.file) as f:
            prompt = f.read()
    if not prompt and args.random_prompt:
        rng = random.Random(args.seed if args.seed >= 0 else None)
        prompt = rng.choice(RANDOM_PROMPTS)
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
    use_color = args.color

    def put(text: str, color: str | None = None) -> None:
        stdout.write(color + text + ANSI_RESET if use_color and color else text)
        stdout.flush()

    if args.mtest:
        # worst-case memory probe (main.cpp:119-135): the largest prompt
        # batch, then a decode step at the deepest n_past
        engine.eval([0] * min(args.batch_size, args.ctx_size))
        engine.reset()
        engine.n_past = min(args.n_predict - 1, args.ctx_size - 1)
        engine.eval([0])
        print(engine.timings.report(), file=sys.stderr)
        return 0

    sp = SamplerParams(
        top_k=args.top_k,
        top_p=args.top_p,
        temp=args.temp,
        repeat_penalty=args.repeat_penalty,
        repeat_last_n=args.repeat_last_n,
    )
    if args.instruct:
        args.interactive = True
        args.reverse_prompt.append(INSTRUCT_PREFIX.strip())
    ctxman = ContextManager(engine, args.ctx_size, min(n_keep, args.ctx_size // 2))
    if args.draft_lookup and _lookup(args, cfg, params, tok, prompt_tokens, sp, stdout):
        return 0
    if args.draft_model and _draft_model(args, cfg, params, tok, prompt_tokens, stdout):
        return 0

    reverse_seqs = [tok.encode(r, bos=False) for r in args.reverse_prompt]
    # SIGINT interject (main.cpp:26-36): during interactive generation the
    # first ^C stops the decode loop (at decode-block granularity) and drops
    # to the input prompt; a second ^C while already interacting exits 130
    interject = {"flag": False, "waiting": False}

    def _sigint(signo, frame):
        if use_color:
            stdout.write(ANSI_RESET)
        stdout.write("\n")
        stdout.flush()
        if interject["waiting"] or interject["flag"]:
            raise SystemExit(130)
        interject["flag"] = True

    prev_handler = signal.signal(signal.SIGINT, _sigint) if args.interactive else None

    def stream(t: int) -> bool:
        stdout.write(tok.decode_token(t).decode("utf-8", errors="replace"))
        stdout.flush()
        if interject["flag"]:
            return False
        # antiprompt detection on the token tail
        return not any(rs and engine.tokens[-len(rs):] == rs for rs in reverse_seqs)

    # echo the prompt like the reference main (input echo on by default)
    put(b"".join(tok.decode_token(t) for t in prompt_tokens).decode("utf-8", errors="replace"),
        ANSI_YELLOW)

    try:
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
            ended = not got or (not args.ignore_eos and got[-1] == EOS_ID)
            pending = []  # the last sampled token is pending in engine.tokens
            if not args.interactive:
                if ended:
                    break
                continue
            # interactive mode keeps prompting when the budget runs out
            # (n_remain resets, main.cpp:444-448); only the end of stdin ends
            # the session
            if remaining <= 0 or ended:
                remaining = args.n_predict
            interject["flag"] = False
            stdout.write("\n> ")
            if use_color:
                stdout.write(ANSI_BOLD_GREEN)
            stdout.flush()
            interject["waiting"] = True
            try:
                line = stdin.readline()
            finally:
                interject["waiting"] = False
                if use_color:
                    stdout.write(ANSI_RESET)
                    stdout.flush()
            if not line:
                break
            if args.instruct:
                line = INSTRUCT_PREFIX + line.rstrip("\n") + INSTRUCT_SUFFIX
            pending = tok.encode(line, bos=False)
    finally:
        if prev_handler is not None:
            signal.signal(signal.SIGINT, prev_handler)
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
    if (args.interactive or args.ctx_swap == "ring"
            or not (args.temp <= 0 or args.repeat_penalty == 1.0)):
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
    if args.temp > 0 or args.interactive or args.ctx_swap == "ring":
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
