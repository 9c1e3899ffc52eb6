"""HTTP serving front-end over the continuous-batching engine (twin of
`llamavk_tpu/runtime/server.py`, one replica on one device or over a
tensor-parallel mesh).

Stdlib only (no web framework): a `ThreadingHTTPServer` handles connections
while ONE dedicated engine thread owns the `BatchedEngine`, so all device
work stays on that thread; HTTP handler threads talk to it through
thread-safe queues.

Endpoints:
  GET  /health          liveness + model info
  GET  /v1/models       OpenAI-style model listing
  GET  /metrics         Prometheus text-format counters
  GET  /stats           raw engine stats (JSON)
  POST /v1/completions  OpenAI-style text completion; `"stream": true`
                        streams server-sent events (one JSON chunk per text
                        delta, then `data: [DONE]`)
  POST /v1/prefixes     register a shared prompt prefix once (prefix
                        caching); requests then pass `"prefix_id": <id>`

Request body (POST /v1/completions):
  prompt: str | [int]     text (tokenized server-side) or raw token ids
  max_tokens: int = 64
  temperature: float = 0.8,  top_p: float = 0.95,  top_k: int = 40
  repeat_penalty: float = 1.1,  seed: int = 0
  stop: [str] = []        cut generation at any of these strings
  stream: bool = false
  ignore_eos: bool = false
  echo: bool = false      prepend the prompt text to the completion
  prefix_id: int = -1     continue a registered shared prefix

Streaming emits only COMPLETE UTF-8: byte-fallback tokens can split a
multi-byte character across tokens, so the encoder holds back trailing
partial sequences (and the longest stop-string prefix) until resolved.

Over a tensor-parallel mesh of several ranks (`mesh`, `serve --tp N`), rank
0 holds this server: the HTTP front door and the request queue. Each turn of
its engine loop broadcasts that turn's messages (submissions, prefix
registrations, cancellations, or none: a heartbeat at least every 0.5 s)
to the other ranks, which run `follow_rank` and apply them to their own
`BatchedEngine` in the same order before the same step, so every rank's
scheduler decides alike. A cancellation from an HTTP thread (a stop string,
a client gone) is such a message, never a direct write, so that no rank
sees it mid-step. Several replicas behind one front door raise
NotImplementedError (ROADMAP.md queue 1, item 6).
"""

from __future__ import annotations

import json
import queue
import sys
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import torch.distributed as dist

from ..models.llama import ModelConfig
from .batching import BatchConfig, BatchedEngine, Request
from .sampling import SamplerParams


def _utf8_complete_len(b: bytes) -> int:
    """Length of the longest prefix of `b` that is complete UTF-8 (a
    trailing partial multi-byte sequence is held back)."""
    n = len(b)
    i = n - 1
    # scan back over up to 3 continuation bytes
    back = 0
    while i >= 0 and back < 3 and (b[i] & 0xC0) == 0x80:
        i -= 1
        back += 1
    if i < 0:
        return 0 if back else n
    lead = b[i]
    if lead < 0x80:
        need = 1
    elif lead >= 0xF0:
        need = 4
    elif lead >= 0xE0:
        need = 3
    elif lead >= 0xC0:
        need = 2
    else:  # stray continuation byte: pass through
        return n
    have = 1 + back
    return n if have >= need else i


class _Stream:
    """Per-request bridge between the engine thread and an HTTP handler.

    The token queue is created BEFORE the request is submitted and `put`
    rides in as the engine's on_token callback, so the admission-time first
    token is delivered through the same path as every other (no replay
    races). The first token's arrival reports the time to first token
    (seconds since submission) to `on_first`."""

    def __init__(self, on_first=None, post=None):
        self.req: Request | None = None
        self.q: queue.Queue = queue.Queue()
        self.t_submit = time.perf_counter()
        self.on_first = on_first
        self.post = post  # a mesh replica's `post`: cancellations go through its loop

    def put(self, tok: int) -> None:
        if self.on_first is not None:
            self.on_first(time.perf_counter() - self.t_submit)
            self.on_first = None
        self.q.put(tok)

    def cancel(self):
        # the engine thread checks req.done at every emit and frees the slot
        # at the end of the current block; a mesh replica marks it at the
        # start of its next turn, on every rank
        if self.req is None:
            return
        if self.post is not None:
            self.post("cancel", self.req.rid)
        else:
            self.req.done = True


class _Replica:
    """The model replica: a BatchedEngine owned by one engine thread, fed
    through a thread-safe pending list; over a mesh of several ranks, rank
    0's part, which broadcasts each turn's messages (module docstring)."""

    def __init__(self, cfg, params, bcfg, device, mesh=None):
        self.engine = BatchedEngine(cfg, params, bcfg, mesh=mesh, device=device)
        self.mesh = mesh if mesh is not None and mesh.size > 1 else None
        self.pending: list[tuple] = []  # (kind, payload, reply queue)
        self.cv = threading.Condition()
        self.running = False
        self.thread: threading.Thread | None = None

    def _apply(self, kind: str, payload):
        """One message, on any rank: a submission, a prefix registration or a
        cancellation (by request id). Returns what the HTTP thread gets."""
        eng = self.engine
        if kind == "submit":
            return eng.submit(**payload)
        if kind == "prefix":
            return eng.register_prefix(payload)
        for req in [*eng.slots, *eng.queue]:  # "cancel"
            if req is not None and req.rid == payload:
                req.done = True
        return None

    def loop(self):
        eng = self.engine
        while True:
            with self.cv:
                while (
                    self.running
                    and not self.pending
                    and not eng.queue
                    and not any(eng.slots)
                ):
                    # a mesh's followers hear from rank 0 at least this often
                    if not self.cv.wait(timeout=0.5) and self.mesh is not None:
                        break
                running = self.running
                pending, self.pending = self.pending, []
            if self.mesh is not None:
                wire = [(kind, {k: v for k, v in payload.items() if k not in ("on_token",
                                                                                "_stream")}
                         if kind == "submit" else payload) for kind, payload, _ in pending]
                _broadcast(wire + ([] if running else [("stop", None)]), self.mesh)
            if not running:
                return
            for kind, payload, reply in pending:
                try:
                    stream = payload.pop("_stream") if kind == "submit" else None
                    out = self._apply(kind, payload)
                    if stream is not None:
                        # attach HERE (engine thread) so the finished-request
                        # sentinel below can never miss a just-submitted req
                        stream.req = out
                        out._stream = stream
                    reply.put(out)
                except Exception as e:  # surface to the HTTP thread
                    reply.put(e)
            if eng.queue or any(eng.slots):
                finished = eng.step()
                for req in finished:
                    stream = getattr(req, "_stream", None)
                    if stream is not None:
                        stream.q.put(None)  # end-of-stream sentinel

    def follow(self):
        """A follower rank's loop: apply each broadcast turn as rank 0 does,
        then step, until rank 0 sends "stop"."""
        eng = self.engine
        while True:
            for kind, payload in _broadcast(None, self.mesh):
                if kind == "stop":
                    return
                try:
                    self._apply(kind, payload)
                except Exception:  # noqa: BLE001 - rank 0 answers the client with it
                    pass
            if eng.queue or any(eng.slots):
                eng.step()

    def post(self, kind: str, payload) -> queue.Queue:
        reply: queue.Queue = queue.Queue()
        with self.cv:
            self.pending.append((kind, payload, reply))
            self.cv.notify()
        return reply

    def start(self):
        self.running = True
        self.thread = threading.Thread(target=self.loop, daemon=True)
        self.thread.start()

    def stop(self):
        with self.cv:
            self.running = False
            self.cv.notify()
        if self.thread is not None:
            self.thread.join(timeout=30)


def _broadcast(msgs, mesh):
    """Rank 0's list of (kind, payload) messages, on every rank of the mesh
    (over its gloo control group)."""
    box = [msgs]
    dist.broadcast_object_list(box, src=0, group=mesh.control)
    return box[0]


def follow_rank(cfg: ModelConfig, params, bcfg: BatchConfig, mesh) -> None:
    """A mesh rank other than 0: its part of the replica (whole tp-packed
    params in, its shard kept), driven by rank 0's `LlamaServer` until that
    shuts down."""
    _Replica(cfg, params, bcfg, mesh.device, mesh).follow()


class LlamaServer:
    """Serving runtime: one engine thread + an HTTP front door. `device`
    defaults to "cuda" and raises without it unless the CPU is asked for.
    `mesh` (tp only): this is rank 0 of a tensor-parallel replica whose
    other ranks run `follow_rank`; params are the whole tp-packed params."""

    def __init__(self, cfg: ModelConfig, params, tokenizer,
                 bcfg: BatchConfig = BatchConfig(),
                 model_name: str | None = None, mesh=None,
                 replicas: int = 1, devices=None, device="cuda"):
        if replicas > 1 or devices is not None:
            raise NotImplementedError(
                "LlamaServer: several replicas are not ported yet (ROADMAP.md queue 1, item 6)"
            )
        if mesh is not None and mesh.rank != 0:
            raise ValueError("LlamaServer runs on rank 0 of its mesh; the other ranks run "
                             "follow_rank")
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.model_name = model_name or f"llama-{cfg.type_name}"
        self.bcfg = bcfg
        self.replica = _Replica(cfg, params, bcfg, device, mesh)
        self.engine = self.replica.engine
        self._httpd: ThreadingHTTPServer | None = None
        self.t_start = time.time()
        self.n_requests = 0
        self.n_stream = 0
        self._count_lock = threading.Lock()  # HTTP threads bump the counts
        self.ttft_s: list[float] = []  # time to first token of each request

    def submit(self, prompt_ids, n_predict, sp: SamplerParams, seed=0,
               ignore_eos=False, prefix=-1) -> _Stream:
        stream = _Stream(on_first=self.ttft_s.append,
                         post=self.replica.post if self.replica.mesh is not None else None)
        payload = dict(prompt=prompt_ids, n_predict=n_predict, sp=sp,
                       seed=seed, ignore_eos=ignore_eos, prefix=prefix,
                       on_token=stream.put, _stream=stream)
        req = self.replica.post("submit", payload).get()
        if isinstance(req, Exception):
            raise req
        return stream

    def register_prefix(self, tokens: list[int]) -> int:
        out = self.replica.post("prefix", tokens).get()
        if isinstance(out, Exception):
            raise out
        return out

    # --- lifecycle ----------------------------------------------------------

    def start(self, host: str = "127.0.0.1", port: int = 8000):
        self.replica.start()
        server = self

        class Handler(_Handler):
            srv = server

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._httpd.daemon_threads = True
        return self._httpd

    def serve_forever(self, host: str = "127.0.0.1", port: int = 8000):
        httpd = self.start(host, port)
        print(f"llamavk serving {self.model_name} on http://{host}:{httpd.server_address[1]}",
              file=sys.stderr, flush=True)
        try:
            httpd.serve_forever()
        finally:
            self.shutdown()

    def shutdown(self):
        self.replica.stop()
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()

    # --- request handling (called from HTTP threads) ------------------------

    def completion_events(self, body: dict):
        """Parse + submit (errors raise HERE, before any bytes are sent),
        then return a generator of (delta_text, finish_reason|None)."""
        prompt = body.get("prompt", "")
        if isinstance(prompt, list):
            ids = [int(t) for t in prompt]
            prompt_text = self.tokenizer.decode(ids).decode("utf-8", "replace")
        else:
            bos = body.get("prefix_id", -1) < 0
            ids = self.tokenizer.encode(prompt, bos=bos)
            prompt_text = prompt
        sp = SamplerParams(
            top_k=int(body.get("top_k", 40)),
            top_p=float(body.get("top_p", 0.95)),
            temp=float(body.get("temperature", 0.8)),
            repeat_penalty=float(body.get("repeat_penalty", 1.1)),
        )
        max_tokens = int(body.get("max_tokens", 64))
        stream = self.submit(
            ids, max_tokens, sp, seed=int(body.get("seed", 0)),
            ignore_eos=bool(body.get("ignore_eos", False)),
            prefix=int(body.get("prefix_id", -1)),
        )
        with self._count_lock:
            self.n_requests += 1
        return self._event_gen(body, stream, prompt_text)

    def _event_gen(self, body: dict, stream: _Stream, prompt_text: str):
        stops = [s.encode() for s in body.get("stop", []) or []]
        max_stop = max((len(s) for s in stops), default=0)

        if body.get("echo"):
            yield prompt_text, None

        raw = b""  # all generated bytes
        sent = 0  # bytes already yielded
        finish = "length"
        try:
            while True:
                tok = stream.q.get()
                if tok is None:
                    break
                if tok == 2 and not body.get("ignore_eos", False):
                    finish = "stop"
                    # engine marks done; wait for the sentinel
                    continue
                raw += self.tokenizer.decode_token(tok)
                if stops:
                    cut = min(
                        (i for s in stops if (i := raw.find(s)) >= 0),
                        default=-1,
                    )
                    if cut >= 0:
                        finish = "stop"
                        stream.cancel()
                        raw = raw[:cut]
                        # drain to the sentinel so the slot frees cleanly
                        while stream.q.get() is not None:
                            pass
                        break
                # emit complete UTF-8, holding back a possible stop prefix
                emit_to = _utf8_complete_len(raw)
                if max_stop:
                    emit_to = min(emit_to, len(raw) - (max_stop - 1))
                if emit_to > sent:
                    yield raw[sent:emit_to].decode("utf-8", "replace"), None
                    sent = emit_to
        except GeneratorExit:
            # client went away mid-stream: stop generating for this slot
            stream.cancel()
            raise
        tail = raw[sent : _utf8_complete_len(raw)]
        yield tail.decode("utf-8", "replace"), finish

    def stats(self) -> dict:
        eng = self.engine
        s = dict(eng.stats)
        s.update(
            active_slots=sum(r is not None for r in eng.slots),
            queued=len(eng.queue),
            uptime_s=round(time.time() - self.t_start, 1),
            requests=self.n_requests,
            model=self.model_name,
            max_batch=self.bcfg.max_batch,
            replicas=1,
        )
        if eng.pager is not None:  # paged KV: the pool, trash page included
            s.update(pages_total=eng.pager.alloc.n_pages, pages_free=eng.pager.alloc.n_free)
        if s.get("t_decode"):
            s["decode_tok_s"] = round(s["tokens"] / s["t_decode"], 1)
        if self.ttft_s:
            s["ttft_ms_p50"] = round(1e3 * sorted(self.ttft_s)[len(self.ttft_s) // 2], 1)
        return s


class _Handler(BaseHTTPRequestHandler):
    srv: LlamaServer = None  # bound by LlamaServer.start
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):  # quiet by default
        pass

    def _json(self, code: int, obj: dict):
        data = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def do_GET(self):
        if self.path == "/health":
            return self._json(200, {"status": "ok", "model": self.srv.model_name})
        if self.path == "/v1/models":
            return self._json(200, {
                "object": "list",
                "data": [{"id": self.srv.model_name, "object": "model",
                          "owned_by": "llamavk_tpu_torch"}],
            })
        if self.path == "/stats":
            return self._json(200, self.srv.stats())
        if self.path == "/metrics":
            s = self.srv.stats()
            lines = [f"llamavk_{k} {s[k]}" for k in (
                "tokens", "steps", "prefills", "prefill_calls", "requests", "active_slots",
                "queued", "preempted") if k in s]
            lines += [f"llamavk_lookup_{k} {s[k]}" for k in ("rounds", "accepted") if k in s]
            lines.append(f"llamavk_uptime_seconds {s['uptime_s']}")
            lines.append(f"llamavk_replicas {s['replicas']}")
            if "decode_tok_s" in s:
                lines.append(f"llamavk_decode_tokens_per_second {s['decode_tok_s']}")
            data = ("\n".join(lines) + "\n").encode()
            self.send_response(200)
            self.send_header("Content-Type", "text/plain; version=0.0.4")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)
            return
        self._json(404, {"error": "not found"})

    def _read_body(self) -> dict:
        n = int(self.headers.get("Content-Length", 0))
        if n <= 0:
            return {}
        return json.loads(self.rfile.read(n) or b"{}")

    def do_POST(self):
        try:
            body = self._read_body()
        except Exception as e:
            return self._json(400, {"error": f"bad json: {e}"})
        if self.path == "/v1/prefixes":
            try:
                toks = body.get("tokens")
                if toks is None:
                    toks = self.srv.tokenizer.encode(body["prompt"], bos=True)
                pid = self.srv.register_prefix([int(t) for t in toks])
            except Exception as e:
                return self._json(400, {"error": str(e)})
            return self._json(200, {"prefix_id": pid, "n_tokens": len(toks)})
        if self.path != "/v1/completions":
            return self._json(404, {"error": "not found"})

        rid = f"cmpl-{uuid.uuid4().hex[:24]}"
        created = int(time.time())
        base = {"id": rid, "object": "text_completion", "created": created,
                "model": self.srv.model_name}
        try:
            events = self.srv.completion_events(body)
        except Exception as e:
            return self._json(400, {"error": str(e)})

        if body.get("stream"):
            with self.srv._count_lock:
                self.srv.n_stream += 1
            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.send_header("Cache-Control", "no-cache")
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()

            def chunk(data: bytes):
                self.wfile.write(f"{len(data):X}\r\n".encode() + data + b"\r\n")

            try:
                for text, finish in events:
                    if not text and finish is None:
                        continue
                    obj = dict(base, choices=[{
                        "text": text, "index": 0, "finish_reason": finish,
                    }])
                    chunk(b"data: " + json.dumps(obj).encode() + b"\n\n")
                chunk(b"data: [DONE]\n\n")
                chunk(b"")  # final chunk
            except (BrokenPipeError, ConnectionResetError):
                events.close()
            return

        parts, finish = [], "length"
        try:
            for text, fin in events:
                parts.append(text)
                if fin is not None:
                    finish = fin
        except Exception as e:
            return self._json(500, {"error": str(e)})
        self._json(200, dict(base, choices=[{
            "text": "".join(parts), "index": 0, "finish_reason": finish,
        }]))
