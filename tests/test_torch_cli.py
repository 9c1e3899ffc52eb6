"""The port's CLIs on the CPU: one-shot greedy output of `generate` equals the
port's own Engine.generate stream (bf16 and int8 caches), the context swap
keeps generating past n_ctx, every flag of the JAX CLI parses, `generate --draft-lookup` and `--draft-model`
print the speculative engines' streams (and fall back or clamp as the JAX
CLI does), `serve` rejects the flags it does not port yet, and `serve
--paged` (with and without --lookup-gamma) answers completions."""

import io
import json
import subprocess
import sys
import urllib.request
from pathlib import Path

import pytest
import torch

from llamavk_tpu_torch.cli import generate as cli
from llamavk_tpu_torch.cli import serve
from llamavk_tpu_torch.models import loader as tl
from llamavk_tpu_torch.runtime.engine import Engine, EngineConfig
from llamavk_tpu_torch.runtime.sampling import SamplerParams
from llamavk_tpu_torch.runtime.speculative import LookupEngine, SpecConfig

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
PROMPT = "<t17><t42><t99><t3>"


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("tiny") / "tiny-q4.bin")
    tl.random_tiny_model(write_path=path, quantize=True)
    return path


def test_cli_prints_the_engine_stream(tiny):
    n = 12
    proc = subprocess.run(
        [sys.executable, "-m", "llamavk_tpu_torch.cli.generate", "-m", tiny, "-p", PROMPT,
         "-n", str(n), "--temp", "0", "-s", "42", "--device", "cpu"],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr

    cfg, params, tok = tl.load_model(tiny, device="cpu")
    prompt_tokens = tok.encode(" " + PROMPT, bos=True)
    eng = Engine(cfg, params, EngineConfig(n_ctx=512, seed=42), device="cpu")
    stream = eng.generate(prompt_tokens, n, SamplerParams(temp=0.0))
    assert stream
    text = b"".join(tok.decode_token(t) for t in prompt_tokens + stream).decode()
    assert proc.stdout == text + "\n"
    assert "eval" in proc.stderr  # the timings report


def test_cli_context_swap(tiny):
    """-c 32 with 40 tokens to predict: the ContextManager keeps n_keep
    tokens, re-feeds half of the window and generation goes on to the full
    count."""
    args = cli.build_argparser().parse_args(
        ["-m", tiny, "-p", PROMPT, "-n", "40", "-c", "32", "--temp", "0", "--ignore-eos",
         "--n-keep", "2", "--device", "cpu"]
    )
    out = io.StringIO()
    assert cli.run(args, stdout=out) == 0
    _, _, tok = tl.load_model(tiny, device="cpu")
    n_prompt = len(tok.encode(" " + PROMPT, bos=True))  # every token prints as <tN>
    assert out.getvalue().count("<t") == n_prompt + 40


def test_cli_rejects_unported_modes(tiny):
    """Every flag of the JAX CLI parses (interactive and instruct modes are
    ported); a flag neither CLI has is still rejected."""
    with pytest.raises(SystemExit):
        cli.build_argparser().parse_args(["-m", tiny, "--ctx-ring"])
    args = cli.build_argparser().parse_args(
        ["-m", tiny, "--interactive", "--instruct", "-r", "User:", "--color", "--mtest", "-b", "4",
         "--random-prompt", "--verbose", "--no-int4-weights"])
    assert args.interactive and args.instruct and args.reverse_prompt == ["User:"]


@pytest.mark.parametrize("kv_dtype", ["bfloat16", "int8"])
def test_cli_kv_dtype(tiny, kv_dtype):
    """--kv-dtype: the printed stream equals the Engine's with that cache."""
    args = cli.build_argparser().parse_args(
        ["-m", tiny, "-p", PROMPT, "-n", "8", "--temp", "0", "--kv-dtype", kv_dtype,
         "--device", "cpu"])
    out = io.StringIO()
    assert cli.run(args, stdout=out) == 0
    cfg, params, tok = tl.load_model(tiny, device="cpu")
    prompt_tokens = tok.encode(" " + PROMPT, bos=True)
    eng = Engine(cfg, params, EngineConfig(n_ctx=512, kv_dtype=kv_dtype), device="cpu")
    stream = eng.generate(prompt_tokens, 8, SamplerParams(temp=0.0))
    assert out.getvalue() == b"".join(tok.decode_token(t) for t in prompt_tokens + stream).decode() + "\n"


@pytest.mark.parametrize("flag", [f for f, _ in serve.UNPORTED])
def test_serve_rejects_unported_flags(tiny, flag, capsys):
    argv = ["-m", tiny, flag] + ([] if flag == "--shared-prefix" else ["2"])
    with pytest.raises(SystemExit) as e:
        serve.build_argparser().parse_args(argv)
    assert e.value.code == 2
    assert f"{flag} is not ported yet" in capsys.readouterr().err
    args = serve.build_argparser().parse_args(["-m", tiny, "--kv-dtype", "int8", "--port", "0"])
    assert (args.kv_dtype, args.port, args.device) == ("int8", 0, "cuda")
    assert serve.build_argparser().parse_args(["-m", tiny, "--tp", "2"]).tp == 2  # ported


def test_serve_paged_flags(tiny):
    args = serve.build_argparser().parse_args(["-m", tiny, "--paged", "--page-size", "32",
                                               "--n-pages", "9", "--kv-dtype", "int8"])
    assert (args.paged, args.page_size, args.n_pages) == (True, 32, 9)
    args = serve.build_argparser().parse_args(["-m", tiny])
    assert (args.paged, args.page_size, args.n_pages) == (False, 128, 0)


@pytest.mark.parametrize("argv,msg", [(["--shared-prefix"],
                                       "--shared-prefix and --paged are exclusive"),
                                      (["--dp", "2"], "--dp is not ported yet")])
def test_serve_paged_combination_errors(tiny, argv, msg, capsys):
    """With --paged, in either order: --shared-prefix is refused with the JAX
    CLI's combination error (serve.py:81-83 there), and the unported --dp as
    unported (the JAX CLI's --dp error needs the flag first)."""
    for order in (["--paged", *argv], [*argv, "--paged"]):
        with pytest.raises(SystemExit) as e:
            serve.build_argparser().parse_args(["-m", tiny, *order])
        assert e.value.code == 2 and msg in capsys.readouterr().err


@pytest.mark.parametrize("kv_dtype,page_size,gamma", [("bfloat16", "8", "0"),
                                                      ("int8", "32", "0"), ("int8", "32", "3")])
def test_serve_cli_paged_answers(tiny, kv_dtype, page_size, gamma):
    """`serve --paged` in its own process on the CPU answers a completion
    with the tokens it was asked for, and reports its page pool (and, with
    --lookup-gamma, its lookup rounds)."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "llamavk_tpu_torch.cli.serve", "-m", tiny, "--device", "cpu",
         "--port", "0", "-c", "64", "--max-batch", "2", "--paged", "--page-size", page_size,
         "--kv-dtype", kv_dtype, "--lookup-gamma", gamma],
        cwd=ROOT, stderr=subprocess.PIPE, text=True)
    try:
        base = next(line.split(" on ")[-1].strip() for line in proc.stderr if " serving " in line)
        req = urllib.request.Request(
            base + "/v1/completions", method="POST", headers={"Content-Type": "application/json"},
            data=json.dumps(dict(prompt=[5, 9, 2], max_tokens=6, temperature=0,
                                 ignore_eos=True)).encode())
        with urllib.request.urlopen(req, timeout=60) as r:
            choice = json.loads(r.read())["choices"][0]
        with urllib.request.urlopen(base + "/stats", timeout=60) as r:
            stats = json.loads(r.read())
    finally:
        proc.terminate()
        proc.wait(timeout=60)
    assert choice["text"].count("<t") == 6 and choice["finish_reason"] == "length"
    assert stats["pages_total"] == 2 * 64 // int(page_size) + 1
    assert (stats.get("rounds", 0) > 0) == (gamma != "0")


def _run(argv):
    """(stdout, stderr) of the generate CLI run in this process."""
    args = cli.build_argparser().parse_args(argv)
    out, err = io.StringIO(), io.StringIO()
    from contextlib import redirect_stderr

    with redirect_stderr(err):
        assert cli.run(args, stdout=out) == 0
    return out.getvalue(), err.getvalue()


LOOKUP_TEXT = "<t155><t60><t233><t155><t60><t233><t155><t60><t233>"


def test_cli_draft_lookup(tiny):
    """--draft-lookup --draft-n 4 prints the LookupEngine's stream (the plain
    greedy one) and its rounds, as generate.py:202-253 there does; a prompt
    that leaves no room falls back to plain decode, and a budget past the
    room is clamped."""
    out, err = _run(["-m", tiny, "-p", LOOKUP_TEXT, "-n", "16", "--temp", "0", "--draft-lookup",
                     "--draft-n", "4", "--device", "cpu"])
    cfg, params, tok = tl.load_model(tiny, device="cpu")
    prompt = tok.encode(" " + LOOKUP_TEXT, bos=True)
    eng = LookupEngine(cfg, params, SpecConfig(n_ctx=512, gamma=4), device="cpu")
    stream = eng.generate(prompt, 16)
    assert stream == Engine(cfg, params, EngineConfig(n_ctx=512), device="cpu").generate(
        prompt, 16, SamplerParams(temp=0.0))
    assert out == b"".join(tok.decode_token(t) for t in stream).decode() + "\n"
    assert f"lookup-speculative: {eng.stats['emitted']} tokens in {eng.stats['rounds']} rounds" \
        in err
    # -c 160 leaves 160 - len(prompt) - (16 * 4 + 4 + 1) tokens of budget
    out, err = _run(["-m", tiny, "-p", LOOKUP_TEXT, "-n", "40", "-c", "160", "--temp", "0",
                     "--draft-lookup", "--device", "cpu"])
    budget = 160 - len(prompt) - 69
    assert 0 < budget < 40
    assert f"clamps -n to {budget}" in err and out.count("<t") == budget
    out, err = _run(["-m", tiny, "-p", LOOKUP_TEXT, "-n", "4", "-c", "64", "--temp", "0",
                     "--draft-lookup", "--device", "cpu"])
    assert "falling back to plain decode" in err and "eval" in err
    assert out.count("<t") == len(prompt) + 4  # the plain path echoes the prompt


def test_cli_draft_model(tiny, tmp_path):
    """--draft-model with an unrelated draft prints the target's greedy
    stream (generate.py:255-290 there); sampling ignores the draft."""
    draft = str(tmp_path / "draft.bin")
    tl.random_tiny_model(write_path=draft, quantize=True, seed=7, n_layer=1, n_ff=128)
    out, err = _run(["-m", tiny, "-p", PROMPT, "-n", "10", "--temp", "0", "--draft-model", draft,
                     "--draft-n", "3", "--device", "cpu"])
    cfg, params, tok = tl.load_model(tiny, device="cpu")
    prompt = tok.encode(" " + PROMPT, bos=True)
    stream = Engine(cfg, params, EngineConfig(n_ctx=512), device="cpu").generate(
        prompt, 10, SamplerParams(temp=0.0))
    assert out == b"".join(tok.decode_token(t) for t in stream).decode() + "\n"
    assert "speculative:" in err and "acceptance" in err
    out, err = _run(["-m", tiny, "-p", PROMPT, "-n", "4", "--temp", "0.8", "--draft-model", draft,
                     "--device", "cpu"])
    assert "ignoring the draft" in err
