"""The rest of the port's generate CLI against the JAX CLI on the CPU:
--mtest, --color and --random-prompt (tests/test_cli.py:105's contract), the
SIGINT interject (:128's), an interactive session with a reverse prompt and
an instruct session, each with two scripted turns of stdin, printing the
JAX CLI's text on the same file, greedy; --no-int4-weights accepted by
generate and serve; and quantize_stats (tests/test_cli.py:57's contract)."""

import contextlib
import io
import signal

import pytest
import torch

from llamavk_tpu.cli import generate as jcli
from llamavk_tpu.models import loader as jl
from llamavk_tpu_torch.cli import generate as cli
from llamavk_tpu_torch.cli import quantize_stats as qs
from llamavk_tpu_torch.cli import serve
from llamavk_tpu_torch.formats.q4 import GGML_FTYPE_Q4_0, GGML_FTYPE_Q4_1
from llamavk_tpu_torch.models import llama as tm
from llamavk_tpu_torch.models import loader as tl

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("tiny") / "tiny-q4.bin")
    jl.random_tiny_model(write_path=path, quantize=True)
    return path


@pytest.fixture(scope="module")
def f32_model(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("m") / "tiny-f32.bin")
    tl.random_tiny_model(write_path=path, quantize=False)
    return path


class Lines:
    """A scripted stdin: one line per readline, then EOF."""

    def __init__(self, lines):
        self.lines = list(lines)

    def readline(self):
        return self.lines.pop(0) if self.lines else ""


def _session(module, argv, lines) -> str:
    args = module.build_argparser().parse_args(argv)
    out = io.StringIO()
    with contextlib.redirect_stderr(io.StringIO()):
        assert module.run(args, stdin=Lines(lines), stdout=out) == 0
    return out.getvalue()


# Both sides' logits lie within LOGIT_TOL of each other on the tiny models
# (tests/test_torch_model.py), so a greedy pick can only differ where the
# top-2 gap is below twice that.
LOGIT_TOL = 0.032


# Prompts of 4 tokens and turns of 3 (the tiny vocabulary spells text byte
# by byte) keep every JAX prefill at one bucket. Each session ends well
# inside n_ctx, so no context swap arises (ROADMAP.md queue 3). The model
# seeds and prompts were picked for the widest top-2 gaps along the
# sessions (0.105 and 0.070).
@pytest.mark.parametrize("seed,argv", [
    (5, ["-p", "go", "-i", "-r", "J"]),
    (3, ["-p", "ok", "-ins"]),
], ids=["interactive", "instruct"])
def test_interactive_sessions_print_the_jax_text(tmp_path, monkeypatch, seed, argv):
    """`-i -r J` (the reverse prompt ends a turn where the stream spells J,
    as it does in the first two turns here) and `-ins` (each line wrapped in
    the Alpaca prefix and suffix): two turns of stdin ("ok", "go"), then
    EOF; the port's text equals the JAX CLI's, prompts ("> ") included, and
    every generated token's top-2 gap is above 2 LOGIT_TOL."""
    path = str(tmp_path / "tiny.bin")
    tl.random_tiny_model(write_path=path, quantize=True, seed=seed)
    common = ["-m", path, *argv, "-n", "8", "--temp", "0", "-c", "128"]
    lines = ["ok\n", "go\n"]
    seen = {}

    class Recording(cli.Engine):
        """The CLI's engine, noting the positions whose next token it sampled."""

        def generate(self, prompt_tokens, n_predict, *a, **k):
            base = len(self.tokens) + len(prompt_tokens)
            out = super().generate(prompt_tokens, n_predict, *a, **k)
            seen.setdefault("pos", []).extend(range(base - 1, base - 1 + len(out)))
            seen["engine"] = self
            return out

    monkeypatch.setattr(cli, "Engine", Recording)
    got = _session(cli, common + ["--device", "cpu"], lines)
    want = _session(jcli, common, lines)
    assert got == want
    assert got.count("\n> ") == 3
    if "-r" in argv:
        assert got.count("<t77>") >= 2  # "J" ended the first two turns
    eng = seen["engine"]
    logits = tm.llama_forward(eng.params, torch.tensor([eng.tokens]),
                              tm.init_kv_cache(eng.cfg, 1, 128, device="cpu"), 0, eng.cfg,
                              logits_all=True)[0][0]
    top2 = torch.topk(logits[seen["pos"]], 2).values
    assert float((top2[:, 0] - top2[:, 1]).min()) > 2 * LOGIT_TOL


def test_mtest_color_random(f32_model):
    """--mtest probes memory and exits 0; --color wraps the prompt echo in
    ANSI yellow; --random-prompt picks a seeded starter when -p is empty."""
    args = cli.build_argparser().parse_args(
        ["-m", f32_model, "--mtest", "-n", "8", "-c", "32", "-b", "4", "--device", "cpu"])
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        assert cli.run(args, stdout=io.StringIO()) == 0
    assert "prompt eval" in err.getvalue() and "/ 5 tokens" in err.getvalue()
    args = cli.build_argparser().parse_args(
        ["-m", f32_model, "--random-prompt", "--color", "-s", "3", "-n", "2", "--temp", "0",
         "-c", "64", "--ignore-eos", "--verbose", "--device", "cpu"])
    out = io.StringIO()
    with contextlib.redirect_stderr(io.StringIO()):
        assert cli.run(args, stdout=out) == 0
    text = out.getvalue()
    assert cli.ANSI_YELLOW in text and cli.ANSI_RESET in text
    assert cli.RANDOM_PROMPTS == jcli.RANDOM_PROMPTS
    assert cli.INSTRUCT_PREFIX == jcli.INSTRUCT_PREFIX
    assert cli.INSTRUCT_SUFFIX == jcli.INSTRUCT_SUFFIX


def test_sigint_interject(f32_model):
    """The first ^C during interactive generation drops to the input prompt
    (main.cpp:26-36); a second ^C while waiting for input exits 130. The CLI
    puts the previous SIGINT handler back either way."""

    class InterruptingOut(io.StringIO):
        """Raises SIGINT in-process after the first generated piece lands."""

        def __init__(self):
            super().__init__()
            self.fired = False

        def write(self, s):
            r = super().write(s)
            if not self.fired and s and not s.startswith("\x1b"):
                self.fired = True
                signal.raise_signal(signal.SIGINT)
            return r

    before = signal.getsignal(signal.SIGINT)
    args = cli.build_argparser().parse_args(
        ["-m", f32_model, "-p", "hi", "-i", "-n", "6", "--temp", "0", "-c", "64",
         "--ignore-eos", "--device", "cpu"])
    out = InterruptingOut()
    with contextlib.redirect_stderr(io.StringIO()):
        assert cli.run(args, stdin=Lines(["more\n"]), stdout=out) == 0
    assert out.fired and "> " in out.getvalue()
    assert signal.getsignal(signal.SIGINT) is before  # the CLI restored it

    class SigintStdin:
        def readline(self):
            signal.raise_signal(signal.SIGINT)  # ^C while interacting
            return "never\n"

    args = cli.build_argparser().parse_args(
        ["-m", f32_model, "-p", "hi", "-i", "-n", "2", "--temp", "0", "-c", "64",
         "--ignore-eos", "--device", "cpu"])
    try:
        with pytest.raises(SystemExit) as ei, contextlib.redirect_stderr(io.StringIO()):
            cli.run(args, stdin=SigintStdin(), stdout=io.StringIO())
        assert signal.getsignal(signal.SIGINT) is before  # restored on the way out too
    finally:
        signal.signal(signal.SIGINT, before)
    assert ei.value.code == 130


def test_no_int4_weights_accepted(tiny):
    """Both CLIs accept --no-int4-weights and ignore it; generate's drafts
    warn and step aside in interactive mode, as the JAX CLI's do."""
    args = cli.build_argparser().parse_args(["-m", tiny, "--no-int4-weights"])
    assert args.no_int4_weights
    assert serve.build_argparser().parse_args(["-m", tiny, "--no-int4-weights"]).no_int4_weights
    for flag in (["--draft-lookup"], ["--draft-model", tiny]):
        args = cli.build_argparser().parse_args(
            ["-m", tiny, "-p", "hi", "-n", "2", "--temp", "0", "-c", "64", "-i", "--ignore-eos",
             "--no-int4-weights", "--device", "cpu", *flag])
        err = io.StringIO()
        with contextlib.redirect_stderr(err):
            assert cli.run(args, stdin=Lines([]), stdout=io.StringIO()) == 0
        assert "non-interactive" in err.getvalue()


def test_quantize_stats(f32_model, capsys):
    res = qs.run_stats(f32_model, GGML_FTYPE_Q4_0, per_layer=False, device=None,
                       out=io.StringIO())
    tot = res["__total__"]
    assert 0 < tot["rmse"] < 0.02  # ~uniform quant error of 0.1-scale weights
    # the packed layout round-trips identically to the codec, on the CPU here
    res_dev = qs.run_stats(f32_model, GGML_FTYPE_Q4_0, per_layer=False, device="cpu",
                           out=io.StringIO())
    assert res_dev["__total__"]["rmse"] == pytest.approx(tot["rmse"], abs=1e-7)
    res_q41 = qs.run_stats(f32_model, GGML_FTYPE_Q4_1, per_layer=False, device="cpu",
                           out=io.StringIO())
    assert 0 < res_q41["__total__"]["rmse"] < tot["rmse"]
    # include/exclude are regexes searched in the name; exclude wins
    res_inc = qs.run_stats(f32_model, GGML_FTYPE_Q4_0, include=[r"attention.*wq"],
                           device="cpu", out=io.StringIO())
    assert res_inc and all("wq" in k for k in res_inc if k != "__total__")
    res_exc = qs.run_stats(f32_model, GGML_FTYPE_Q4_0, include=[r"attention"],
                           exclude=[r"wq\.weight$"], device="cpu", out=io.StringIO())
    assert all("wq" not in k for k in res_exc)
    # the card by default and for the JAX CLI's bare --device; the CPU on request
    ap = qs.build_argparser()
    assert ap.parse_args(["-m", f32_model, "--device"]).device == "cuda"
    assert ap.parse_args(["-m", f32_model]).device == "cuda"
    assert ap.parse_args(["-m", f32_model, "--device", "cpu"]).device == "cpu"
    capsys.readouterr()
    assert qs.main(["-m", f32_model, "-l", "output", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "output.weight" in out and "TOTAL" in out
