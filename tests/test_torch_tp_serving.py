"""Tensor-parallel serving in the port: `BatchedEngine(mesh=...)` at tp = 2
against a greedy loop over the port's `make_sharded_forward` with the same
tp (the oracle of JAX tests/test_tp_serving.py: the same math in another
summation order, so the streams must be equal, or part only at a token
whose top-2 logit gap is under one bf16 ulp), for bf16 and int8 KV; the
int8 engine's greedy streams against the JAX single-device int8
`BatchedEngine`'s (its Pallas kernels in interpret mode), by the same
rule; a seeded sampled run that
gives the same streams on every rank and on a rerun, and the check that
raises on every rank when a rank's ids differ; `LlamaServer` on rank 0
with `follow_rank` on rank 1 over HTTP; and the serve CLI's argument
checks. The two ranks run once per module, over gloo on the CPU (the plain
kernel versions), within a deadline."""

from __future__ import annotations

import json
import math
import threading
import urllib.request

import pytest
import torch

from llamavk_tpu_torch.cli import serve
from llamavk_tpu_torch.formats.ggml_io import CheckpointReader
from llamavk_tpu_torch.models import llama as tm
from llamavk_tpu_torch.models import loader as tl
from llamavk_tpu_torch.parallel import make_mesh, make_sharded_forward, multihost
from llamavk_tpu_torch.parallel import shard_cache, shard_params
from llamavk_tpu_torch.runtime.batching import BatchConfig, BatchedEngine
from llamavk_tpu_torch.runtime.sampling import SamplerParams
from llamavk_tpu_torch.tokenizer import Tokenizer

torch.set_num_threads(2)

TP = 2
DEADLINE_S = 100
GREEDY = SamplerParams(temp=0.0)
PROMPTS = [[5, 9, 2, 30], [7, 3, 11], [1, 2, 3, 4, 5, 6]]
N_PRED = [6, 6, 5]
SAMPLED = SamplerParams(temp=0.8, top_p=0.95, repeat_penalty=1.1)


def _near_tie(row: torch.Tensor) -> bool:
    """Whether a logit row's top-2 gap is under one bf16 ulp of its largest
    logit: a greedy pick that any f32 summation order may flip."""
    top2 = row.float().topk(2).values
    ulp = 2.0 ** (math.floor(math.log2(float(row.float().abs().max()))) - 7)
    return float(top2[0] - top2[1]) < ulp


def _oracle(cfg, params, mesh, kv: str, n_ctx: int = 64) -> list[tuple[list[int], list[bool]]]:
    """Greedy streams of a loop over the sharded forward, one prompt at a
    time in a one-row cache, each with its near ties (`_near_tie`) per
    token."""
    dtype = torch.int8 if kv == "int8" else torch.bfloat16
    fwd = make_sharded_forward(cfg, params, mesh, quantized_kv=kv == "int8")
    outs = []
    for p, n in zip(PROMPTS, N_PRED):
        cache = shard_cache(tm.init_kv_cache(cfg, 1, n_ctx, dtype, device="cpu"), mesh)
        logits, cache, _ = fwd(params, torch.tensor([p]), cache, 0)
        tok = int(logits[0, -1].argmax())
        stream, ties, n_past = [tok], [_near_tie(logits[0, -1])], len(p)
        for _ in range(n - 1):
            logits, cache, _ = fwd(params, torch.tensor([[tok]]), cache, n_past)
            tok = int(logits[0, -1].argmax())
            stream.append(tok)
            ties.append(_near_tie(logits[0, -1]))
            n_past += 1
        outs.append((stream, ties))
    return outs


def _agree(got: list[list[int]], oracle: list[tuple[list[int], list[bool]]]) -> None:
    """Each stream equals the oracle's, or parts from it only at a token
    where the oracle's top-2 logit gap is under one bf16 ulp (the tokens
    after a parting have other histories and are not compared)."""
    for j, (g, (want, ties)) in enumerate(zip(got, oracle)):
        assert len(g) == len(want), (j, g, want)
        i = next((i for i, (a, b) in enumerate(zip(g, want)) if a != b), None)
        assert i is None or ties[i], f"prompt {j} parts at token {i} on a clear gap: {g} vs {want}"


def _engine_streams(cfg, whole, mesh, bcfg, sp, seeds) -> list[list[int]]:
    be = BatchedEngine(cfg, whole, bcfg, mesh=mesh)
    reqs = [be.submit(p, n, sp, seed=s, ignore_eos=True)
            for p, n, s in zip(PROMPTS, N_PRED, seeds)]
    be.run()
    return [r.generated for r in reqs]


def _http(base: str, body: dict) -> dict:
    req = urllib.request.Request(base + "/v1/completions", json.dumps(body).encode(),
                                 {"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.loads(r.read())


def _rank(rank: int, init: str, path: str, out: str) -> None:
    torch.set_num_threads(1)
    multihost.initialize(init, TP, rank, device="cpu", timeout_s=60)
    from llamavk_tpu_torch.runtime.server import LlamaServer, follow_rank

    mesh = make_mesh(tp=TP, dp=1, device="cpu")
    reader = CheckpointReader(path)
    cfg, whole = tl.params_from_reader(reader, device="cpu", tp=TP)
    params = shard_params(whole, mesh)
    res = {}
    for kv in ("bfloat16", "int8"):
        bcfg = BatchConfig(max_batch=4, n_ctx=64, block=4, kv_dtype=kv)
        res[f"oracle_{kv}"] = _oracle(cfg, params, mesh, kv)
        res[f"engine_{kv}"] = _engine_streams(cfg, whole, mesh, bcfg, GREEDY, [0, 0, 0])
    bcfg = BatchConfig(max_batch=4, n_ctx=64, block=4)
    res["sampled"] = [_engine_streams(cfg, whole, mesh, bcfg, SAMPLED, [11, 12, 13])
                      for _ in range(2)]
    try:  # rank 1 seeds differently: its ids part from rank 0's
        _engine_streams(cfg, whole, mesh, bcfg, SAMPLED, [11 + rank, 12, 13])
        res["mismatch"] = None
    except RuntimeError as e:
        res["mismatch"] = str(e)
    # the server over the mesh: rank 0 answers HTTP, rank 1 follows
    if rank == 0:
        srv = LlamaServer(cfg, whole, Tokenizer(reader.vocab), bcfg, mesh=mesh)
        httpd = srv.start(port=0)
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        base = f"http://127.0.0.1:{httpd.server_address[1]}"
        res["http"] = [_http(base, {"prompt": p, "max_tokens": n, "temperature": 0,
                                    "ignore_eos": True})["choices"][0]["text"]
                       for p, n in zip(PROMPTS, N_PRED)]
        # a stop string cancels the request through the replica's loop
        res["http_stop"] = _http(base, {"prompt": PROMPTS[0], "max_tokens": 30,
                                        "temperature": 0, "ignore_eos": True,
                                        "stop": [f"<t{res['engine_bfloat16'][0][2]}>"]})
        res["stats"] = srv.stats()
        srv.shutdown()
    else:
        follow_rank(cfg, whole, bcfg, mesh)
    torch.save(res, f"{out}.{rank}")
    multihost.shutdown()


@pytest.fixture(scope="module")
def tiny_tp(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("m") / "tiny-tp.bin")
    # dims divisible by tp with >= 64-wide row chunks (like test_tp_serving)
    tl.random_tiny_model(write_path=path, n_embd=512, n_head=8, n_ff=512, n_vocab=256,
                         quantize=True)
    return path


@pytest.fixture(scope="module")
def ranks(tiny_tp, tmp_path_factory):
    d = tmp_path_factory.mktemp("tp")
    multihost.spawn(_rank, TP, (f"file://{d}/init", tiny_tp, str(d / "res")),
                    deadline_s=DEADLINE_S)
    return [torch.load(d / f"res.{r}") for r in range(TP)]


@pytest.mark.parametrize("kv", ["bfloat16", "int8"])
def test_tp_engine_matches_sharded_forward(ranks, kv):
    """Equal to the oracle's streams, or parting only at a near tie."""
    for res in ranks:
        _agree(res[f"engine_{kv}"], res[f"oracle_{kv}"])
    assert ranks[0][f"engine_{kv}"] == ranks[1][f"engine_{kv}"]


def test_tp_engine_int8_matches_jax(ranks, tiny_tp):
    """The tp = 2 engine over int8 KV (shard_cache splitting the scale
    planes on H, the int8 K2/K4 over each rank's 4 heads) gives the JAX
    single-device int8 engine's greedy streams on every rank: token ids,
    compared exactly up to a near tie of the tp oracle's logits, where the
    two may part (`_agree`: the engine's stream must then equal the oracle's
    up to that token)."""
    from llamavk_tpu.models import loader as jl
    from llamavk_tpu.runtime import batching as jb
    from llamavk_tpu.runtime import sampling as js

    jcfg, jparams, _ = jl.load_model(tiny_tp)
    jbe = jb.BatchedEngine(jcfg, jparams, jb.BatchConfig(max_batch=4, n_ctx=64, block=4,
                                                         kv_dtype="int8"))
    jreqs = [jbe.submit(p, n, js.SamplerParams(temp=0.0), ignore_eos=True)
             for p, n in zip(PROMPTS, N_PRED)]
    jbe.run()
    jax_streams = [r.generated for r in jreqs]
    for res in ranks:
        for j, (mine, theirs) in enumerate(zip(res["engine_int8"], jax_streams)):
            i = next((i for i, (a, b) in enumerate(zip(mine, theirs)) if a != b), None)
            if i is None:
                assert len(mine) == len(theirs)
                continue
            stream, ties = res["oracle_int8"][j]
            assert mine[:i] == stream[:i] and ties[i], (
                f"prompt {j} parts from JAX at token {i} on a clear gap: {mine} vs {theirs}")


def test_tp_engine_sampled_deterministic(ranks):
    """Seeded sampled requests: the same streams on both ranks and on a
    rerun; a rank seeded apart makes every rank raise."""
    first, again = ranks[0]["sampled"]
    assert first == again and ranks[1]["sampled"] == [first, first]
    assert first != ranks[0]["engine_bfloat16"]  # sampling really ran
    for res in ranks:
        assert res["mismatch"] is not None and "differ between ranks" in res["mismatch"]


def test_tp_server_follows_rank0(ranks):
    """Rank 0's HTTP server with rank 1 following: greedy answers equal the
    engine's streams; a stop string ends a request cleanly on both ranks."""
    want = ["".join(f"<t{t}>" for t in s) for s in ranks[0]["engine_bfloat16"]]
    assert ranks[0]["http"] == want
    stop = ranks[0]["http_stop"]["choices"][0]
    assert stop["finish_reason"] == "stop" and stop["text"] == want[0][: want[0].index(
        f"<t{ranks[0]['engine_bfloat16'][0][2]}>")]
    assert ranks[0]["stats"]["requests"] == 4


@pytest.mark.parametrize("argv, msg", [
    (["--dp", "2"], "--dp"),
    (["--replicas", "2"], "--replicas"),
    (["--tp", "2", "--paged"], "--paged under --tp"),
    (["--tp", "2", "--shared-prefix"], "--shared-prefix under --tp"),
    (["--tp", "2", "--lookup-gamma", "4"], "--lookup-gamma under --tp"),
    (["--dp", "2", "--paged"], "--dp"),
    (["--tp", "0"], "--tp must be at least 1"),
])
def test_serve_cli_refuses(capsys, argv, msg):
    with pytest.raises(SystemExit):
        serve.build_argparser().parse_args(["-m", "x", *argv])
    err = capsys.readouterr().err
    assert msg in err
    assert "at least" in msg or "ROADMAP.md" in err
