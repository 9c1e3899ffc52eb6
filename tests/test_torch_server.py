"""The port's HTTP serving front-end (`runtime/server.py`) on the tiny model on
the CPU over a real local socket: endpoints, greedy completions equal to the
port's `BatchedEngine`, streaming SSE, stop strings, concurrency, prefix
registration and bad requests (the single-replica cases of
tests/test_server.py). The UTF-8 hold-back is held against the JAX
package's function."""

import json
import threading
import urllib.error
import urllib.request

import pytest
import torch

from llamavk_tpu.runtime.server import _utf8_complete_len as jax_utf8_complete_len
from llamavk_tpu_torch.models import loader as tl
from llamavk_tpu_torch.runtime.batching import BatchConfig, BatchedEngine
from llamavk_tpu_torch.runtime.sampling import SamplerParams
from llamavk_tpu_torch.runtime.server import LlamaServer, _utf8_complete_len

torch.set_num_threads(2)

BCFG = BatchConfig(max_batch=4, n_ctx=64, block=4)


def test_utf8_holdback_matches_jax():
    s = "héllo ✓ 𝄞".encode()
    table = [s[:cut] for cut in range(len(s) + 1)]
    table += [b"abc", "é".encode()[:1], b"\x80abc", b"\xbf", b"\xf0\x9f", b"a\xe2\x9c"]
    for b in table:
        n = _utf8_complete_len(b)
        assert n == jax_utf8_complete_len(b), b
        assert n <= len(b)
    for cut in range(len(s) + 1):
        s[:_utf8_complete_len(s[:cut])].decode("utf-8")  # must never raise


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("m") / "tiny-q4.bin")
    tl.random_tiny_model(write_path=path, quantize=True)
    return tl.load_model(path, device="cpu")


@pytest.fixture(scope="module")
def server(tiny):
    cfg, params, tok = tiny
    srv = LlamaServer(cfg, params, tok, BCFG, model_name="tiny-test", device="cpu")
    httpd = srv.start("127.0.0.1", 0)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    yield f"http://127.0.0.1:{httpd.server_address[1]}"
    srv.shutdown()


def _get(base, path):
    with urllib.request.urlopen(base + path, timeout=120) as r:
        return r.status, r.read()


def _post(base, path, body):
    req = urllib.request.Request(
        base + path, data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"}, method="POST",
    )
    with urllib.request.urlopen(req, timeout=120) as r:
        return r.status, r.read()


def _completion(base, **body):
    status, data = _post(base, "/v1/completions", body)
    assert status == 200
    return json.loads(data)


def _text(tok, ids):
    return b"".join(tok.decode_token(t) for t in ids).decode()


def test_health_models_metrics(server):
    status, data = _get(server, "/health")
    assert status == 200 and json.loads(data)["status"] == "ok"
    status, data = _get(server, "/v1/models")
    assert json.loads(data)["data"][0]["id"] == "tiny-test"
    status, data = _get(server, "/stats")
    assert json.loads(data)["model"] == "tiny-test"
    status, data = _get(server, "/metrics")
    assert status == 200 and b"llamavk_uptime_seconds" in data


def test_completion_equals_batched_engine(server, tiny):
    cfg, params, tok = tiny
    be = BatchedEngine(cfg, params, BCFG, device="cpu")
    req = be.submit([5, 9, 2, 30], 6, SamplerParams(temp=0.0), ignore_eos=True)
    be.run()
    r = _completion(server, prompt=[5, 9, 2, 30], max_tokens=6, temperature=0.0,
                    ignore_eos=True)
    assert r["object"] == "text_completion"
    assert r["choices"][0]["text"] == _text(tok, req.generated)
    assert r["choices"][0]["finish_reason"] == "length"
    echo = _completion(server, prompt=[5, 9], max_tokens=3, temperature=0.0,
                       ignore_eos=True, echo=True)
    assert echo["choices"][0]["text"].startswith("<t5><t9>")


def test_streaming_matches_non_streaming(server):
    body = dict(prompt=[7, 3, 11], max_tokens=6, temperature=0.0, ignore_eos=True)
    want = _completion(server, **body)["choices"][0]["text"]
    req = urllib.request.Request(
        server + "/v1/completions", data=json.dumps(dict(body, stream=True)).encode(),
        headers={"Content-Type": "application/json"}, method="POST",
    )
    chunks, finishes = [], []
    with urllib.request.urlopen(req, timeout=120) as r:
        assert r.headers["Content-Type"].startswith("text/event-stream")
        for raw in r:
            line = raw.decode().strip()
            if not line.startswith("data: "):
                continue
            payload = line[len("data: "):]
            if payload == "[DONE]":
                break
            obj = json.loads(payload)
            chunks.append(obj["choices"][0]["text"])
            finishes.append(obj["choices"][0]["finish_reason"])
    assert "".join(chunks) == want
    assert finishes[-1] == "length" and all(f is None for f in finishes[:-1])


def test_stop_string_cuts(server):
    body = dict(prompt=[5, 9, 2, 30], max_tokens=8, temperature=0.0, ignore_eos=True)
    full = _completion(server, **body)["choices"][0]["text"]
    pieces = full.replace(">", ">\x00").split("\x00")
    stop = pieces[2]  # the 3rd generated piece as the stop marker
    r = _completion(server, **dict(body, stop=[stop]))
    assert r["choices"][0]["text"] == full[: full.index(stop)]
    assert r["choices"][0]["finish_reason"] == "stop"


def test_concurrent_requests(server):
    bodies = [
        dict(prompt=[5, 9, 2, 30], max_tokens=5, temperature=0.0, ignore_eos=True),
        dict(prompt=[7, 3], max_tokens=5, temperature=0.0, ignore_eos=True),
        dict(prompt=[1, 2, 3], max_tokens=5, temperature=1.1, top_p=0.9, seed=7,
             ignore_eos=True),
    ]
    want = [_completion(server, **b)["choices"][0]["text"] for b in bodies]
    got = [None] * len(bodies)

    def run(i):
        got[i] = _completion(server, **bodies[i])["choices"][0]["text"]

    threads = [threading.Thread(target=run, args=(i,)) for i in range(len(bodies))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert got == want
    stats = json.loads(_get(server, "/stats")[1])
    assert stats["requests"] >= 2 * len(bodies) and stats["ttft_ms_p50"] > 0


def test_prefix_registration_and_use(server):
    status, data = _post(server, "/v1/prefixes", {"tokens": list(range(3, 20))})
    assert status == 200
    pid = json.loads(data)["prefix_id"]
    r = _completion(server, prompt=[5, 9], max_tokens=4, temperature=0.0, ignore_eos=True,
                    prefix_id=pid)
    want = _completion(server, prompt=list(range(3, 20)) + [5, 9], max_tokens=4,
                       temperature=0.0, ignore_eos=True)
    assert r["choices"][0]["text"] == want["choices"][0]["text"]


@pytest.mark.parametrize("data", [b"not json", json.dumps({"prompt": [1] * 60,
                                                           "max_tokens": 50}).encode()],
                         ids=["bad_json", "past_n_ctx"])
def test_bad_requests(server, data):
    """Unparsable JSON, and a request past n_ctx, answer 400."""
    req = urllib.request.Request(server + "/v1/completions", data=data,
                                 headers={"Content-Type": "application/json"}, method="POST")
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(req, timeout=120)
    assert e.value.code == 400
