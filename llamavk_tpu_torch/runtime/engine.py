"""Decode engine: prefill + a decode loop with on-device sampling (twin of
`llamavk_tpu/runtime/engine.py`).

The sampled token is fed straight back into the next forward step as a device
tensor; the host receives one [n_steps] tensor of token ids per decode block,
never a per-step `.item()`. The KV cache is updated in place. The API mirrors
llama.h: eval / sample / get-set-kv-cache / timings.

A decode step is one forward and one sample over static buffers (`_Decode`:
the position as an int32 [1] device tensor, the current token, the repeat
window, the block's token row and the step index), all advanced in place.
On CUDA it is captured once in a CUDA graph (`runtime/graphs.py`) per
`SamplerParams`, the static arguments of JAX's jitted block
(`make_decode_block`, engine.py:93-125 there), and a block of n tokens is n
replays: the budget stays exact, never snapped to a power of two. The graph
is the decode path on CUDA; a failed capture or replay raises. The CPU runs
the same step uncaptured. The graphs hold the cache's addresses and the
generator: `reset`, `restore_session` and `set_seed` write into the live
cache and generator, never replace them.

The KV cache is bf16, int8 or f32 (`EngineConfig.kv_dtype`; f32 is the
llama.h API's `f16_kv = false`). With `ctx_ring` (any of the three)
it is a history ring (engine.py:149-185 there): the first `ring_keep` rows
stay pinned and the rest recycle, so generation runs past n_ctx with no
swap and no re-evaluation; each eval chunk stops at the ring's end. The
ggml numerics oracle is not ported yet. Activations are bf16.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, replace
from typing import Callable

import numpy as np
import torch

from ..device import resolve
from ..models.llama import (
    KVCache,
    LlamaParams,
    ModelConfig,
    init_kv_cache,
    llama_forward,
    ring_phys,
)
from ..ops.flash_attn import kv_step
from .graphs import StepGraph
from .sampling import SamplerParams, sample_token


@dataclass(frozen=True)
class EngineConfig:
    n_ctx: int = 512
    kv_dtype: str = "bfloat16"  # "float32" is llama.h's f16_kv = false (llama.h:56); or "int8"
    seed: int = 0
    decode_block: int = 16  # tokens decoded per host round-trip
    ctx_ring: bool = False  # history-ring KV: generation past n_ctx, no re-eval
    ring_keep: int = 0  # the ring's pinned first rows
    ggml_numerics: str | None = None  # the C-reference numerics oracle (not ported yet)


@dataclass
class SessionState:
    """Snapshot of inference state — llama_get_kv_cache/llama_set_kv_cache
    parity. Holds clones: the live cache is updated in place."""

    k: torch.Tensor
    v: torch.Tensor
    n_past: int
    tokens: list[int]
    k_scale: torch.Tensor | None = None  # int8 caches (ops/kv_quant.py)
    v_scale: torch.Tensor | None = None
    pos: torch.Tensor | None = None  # the history ring's position plane


@dataclass
class Timings:
    """llama_print_timings parity (llama.cpp:1807-1827)."""

    t_load_us: float = 0.0
    t_prompt_us: float = 0.0
    n_prompt: int = 0
    t_eval_us: float = 0.0
    n_eval: int = 0

    def report(self) -> str:
        lines = [f"load time   = {self.t_load_us / 1e3:9.2f} ms"]
        if self.n_prompt:
            lines.append(
                f"prompt eval = {self.t_prompt_us / 1e3:9.2f} ms / {self.n_prompt} tokens"
                f" ({self.t_prompt_us / 1e3 / max(self.n_prompt, 1):.2f} ms/tok)"
            )
        if self.n_eval:
            lines.append(
                f"eval        = {self.t_eval_us / 1e3:9.2f} ms / {self.n_eval} tokens"
                f" ({self.t_eval_us / 1e3 / max(self.n_eval, 1):.2f} ms/tok,"
                f" {self.n_eval / (self.t_eval_us / 1e6):.2f} tok/s)"
            )
        return "\n".join(lines)


def kv_dtype(name: str, n_ctx: int) -> torch.dtype:
    """The cache type of a `kv_dtype` option ("bfloat16", "int8" or
    "float32"), after checking that n_ctx is a multiple of its KV block step
    (32 rows for int8, 8 for bf16 and f32, as engine.py:137-138 there)."""
    types = {"bfloat16": torch.bfloat16, "int8": torch.int8, "float32": torch.float32}
    if name not in types:
        raise NotImplementedError(f"kv_dtype={name!r}: bfloat16, int8 or float32")
    step = kv_step(types[name])
    if n_ctx % step:
        raise ValueError(
            f"n_ctx must be a multiple of {step} ({name} KV tile constraint); got {n_ctx}"
        )
    return types[name]


@dataclass
class _Decode:
    """The static buffers of one decode step (one per SamplerParams), and
    its captured graph once there is one."""

    n_past: torch.Tensor  # int32 [1]: the step's position
    tok: torch.Tensor  # int64 [1]: the token the step evaluates
    last: torch.Tensor  # int64 [W]: the repeat window
    out: torch.Tensor  # int64 [decode_block]: the block's sampled tokens
    step: torch.Tensor  # int64 [1]: the row of `out` the step writes
    graph: StepGraph | None = None


class Engine:
    def __init__(
        self,
        cfg: ModelConfig,
        params: LlamaParams,
        ecfg: EngineConfig = EngineConfig(),
        device="cuda",
    ):
        self.device = resolve(device)
        self.kv_dtype = kv_dtype(ecfg.kv_dtype, ecfg.n_ctx)
        if ecfg.ggml_numerics is not None:
            raise NotImplementedError("Engine: ggml_numerics is not ported yet")
        self.cfg = cfg
        self.params = params
        self.ecfg = ecfg
        self.timings = Timings()
        self.cache = init_kv_cache(cfg, 1, ecfg.n_ctx, self.kv_dtype, self.device,
                                   ring=ecfg.ctx_ring)
        self.generator = torch.Generator(device=self.device)
        self._decodes: dict[SamplerParams, _Decode] = {}
        self._cache_ptrs = self._addresses()
        self.reset()

    # --- state ---------------------------------------------------------

    def reset(self) -> None:
        """An empty context: the live cache zeroed in place (a ring's
        positions emptied), the generator reseeded with ecfg.seed."""
        for plane in self.cache.planes():
            plane.zero_()
        if self.cache.ring:
            self.cache.pos.fill_(-1)
        self.n_past = 0
        self.tokens: list[int] = []
        self._last_emb: torch.Tensor | None = None
        self.set_seed(self.ecfg.seed)

    def _addresses(self) -> list[int]:
        """The cache's tensor addresses, which the captured graphs hold."""
        return [t.data_ptr() for t in self.cache.planes() + [self.cache.pos]
                if t is not None]

    def set_seed(self, seed: int) -> None:
        """Reseed the engine's generator in place (the captured graphs draw
        from it)."""
        self.generator.manual_seed(seed)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _forward(self, tokens: torch.Tensor, n_past: int | torch.Tensor, **kw):
        return llama_forward(self.params, tokens, self.cache, n_past, self.cfg,
                             ring_keep=self.ecfg.ring_keep, **kw)

    def _ring_row(self, pos: int) -> int:
        """The physical ring row of logical position `pos` (ring_phys)."""
        return ring_phys(pos, self.ecfg.ring_keep, self.ecfg.n_ctx)

    # --- eval (llama_eval parity) ---------------------------------------

    def _eval(self, tokens, logits_all: bool = False) -> torch.Tensor:
        """eval() on the device: logits [T or 1, V] f32 as a device tensor."""
        backlog = self.tokens[self.n_past :]
        new_toks = [int(t) for t in np.asarray(tokens)]
        full = list(backlog) + new_toks
        if not full:
            raise ValueError("eval: no tokens to evaluate")
        ring = self.ecfg.ctx_ring
        if not ring and self.n_past + len(full) > self.ecfg.n_ctx:
            raise ValueError(
                f"context overflow: n_past({self.n_past}) + n_tokens({len(full)})"
                f" > n_ctx({self.ecfg.n_ctx})"
            )
        t0 = time.perf_counter()
        if ring:
            # chunk so no write crosses the ring's end, each chunk the
            # largest power of two that fits the room (engine.py:234-248 there)
            parts = []
            i = 0
            while i < len(full):
                room = self.ecfg.n_ctx - self._ring_row(self.n_past)
                take = min(len(full) - i, 1 << (room.bit_length() - 1))
                parts.append(self._eval_chunk(full[i : i + take], logits_all))
                i += take
            logits = torch.cat(parts) if logits_all else parts[-1]
        else:
            logits = self._eval_chunk(full, logits_all)
        if logits_all:
            logits = logits[len(backlog) :]
        self._sync()
        self.tokens.extend(new_toks)
        self.timings.t_prompt_us += (time.perf_counter() - t0) * 1e6
        self.timings.n_prompt += len(full)
        return logits

    def _eval_chunk(self, chunk: list[int], logits_all: bool) -> torch.Tensor:
        """One forward over `chunk` at n_past: logits [T, V] or [1, V]."""
        # bucket-pad T to a power of two, capped by the room left (the JAX
        # package's compile buckets; kept so both take the same kernel
        # routes). Garbage KV rows past the real tokens sit beyond n_past and
        # are overwritten before any query can attend to them; in a ring that
        # has wrapped they take the place of the oldest rows until then, as
        # there (engine.py:210-217).
        t_real = len(chunk)
        bucket = 1 << (t_real - 1).bit_length()
        row = self._ring_row(self.n_past) if self.ecfg.ctx_ring else self.n_past
        bucket = min(bucket, self.ecfg.n_ctx - row)
        padded = chunk + [0] * (bucket - t_real)
        toks = torch.tensor([padded], dtype=torch.int64, device=self.device)
        logits, self.cache, self._last_emb = self._forward(
            toks, self.n_past, last_idx=t_real - 1, logits_all=logits_all
        )
        self.n_past += t_real
        return logits[0][:t_real] if logits_all else logits[0]

    def eval(self, tokens, logits_all: bool = False) -> np.ndarray:
        """Evaluate tokens at the current position; returns host logits
        [T or 1, V]. A final sampled token of a previous generate() is in
        self.tokens but not yet in the cache; it is prepended here."""
        return self._eval(tokens, logits_all).cpu().numpy()

    def get_embeddings(self) -> np.ndarray:
        """Final-norm activations of the last evaluated token, f32
        [n_embd] (llama_get_embeddings parity, llama.h:115-118; engine.py:258
        there). Set by eval, not by the decode loop."""
        if self._last_emb is None:
            raise ValueError("get_embeddings: nothing evaluated yet")
        return self._last_emb[0].cpu().numpy()

    # --- generation ------------------------------------------------------

    def _decode_state(self, sp: SamplerParams, w: int) -> _Decode:
        """The static buffers of `sp`'s decode step (a window of w tokens)."""
        st = self._decodes.get(sp)
        if st is None:
            def buf(n, dtype=torch.int64):
                return torch.zeros(n, dtype=dtype, device=self.device)

            st = _Decode(buf(1, torch.int32), buf(1), buf(w), buf(self.ecfg.decode_block), buf(1))
            self._decodes[sp] = st
        return st

    def _step(self, st: _Decode, sp: SamplerParams, generator: torch.Generator) -> None:
        """One decode step on the static buffers: the forward of st.tok at
        st.n_past, a sample, and every buffer advanced in place. No host
        value changes from step to step."""
        logits, _, _ = self._forward(st.tok.view(1, 1), st.n_past)
        tok = sample_token(logits[0, -1], st.last, generator, sp).view(1)
        st.last.copy_(torch.cat([st.last[1:], tok]))
        st.out.index_copy_(0, st.step, tok)
        st.tok.copy_(tok)
        st.n_past.add_(1)
        st.step.add_(1)

    def _run_uncaptured(self, st: _Decode, sp: SamplerParams, n_steps: int) -> None:
        """The block's steps run one by one: the CPU's decode path, and the
        plain version a graph's replays are held against on the card."""
        for _ in range(n_steps):
            self._step(st, sp, self.generator)

    def _run_block(self, st: _Decode, sp: SamplerParams, n_steps: int) -> None:
        """The block's steps: replays of the step's CUDA graph on CUDA
        (captured at first use), uncaptured on the CPU."""
        if self.device.type != "cuda":
            return self._run_uncaptured(st, sp, n_steps)
        if self._addresses() != self._cache_ptrs:
            raise RuntimeError("Engine: the KV cache was replaced; the decode graphs hold the "
                               "first cache's addresses (write into it instead)")
        if st.graph is None:
            st.graph = StepGraph(lambda gens: self._step(st, sp, gens[0]),
                                 [st.n_past, st.tok, st.last, st.step], [self.generator],
                                 self.device)
        for _ in range(n_steps):
            st.graph.replay()

    def _decode_block(self, tok: torch.Tensor, last: torch.Tensor, sp: SamplerParams,
                      n_steps: int):
        """n_steps forward + sample steps from `tok` at self.n_past; the
        token never leaves the device. Returns ([n_steps] tokens, the final
        window), views of the static buffers."""
        st = self._decode_state(sp, last.shape[0])
        st.n_past.fill_(self.n_past)
        st.tok.copy_(tok.view(1))
        st.last.copy_(last)
        st.step.zero_()
        self._run_block(st, sp, n_steps)
        return st.out[:n_steps], st.last

    def graph_stats(self) -> dict:
        """The captured decode graphs: how many, their capture seconds and
        the bytes their private pools reserved, summed."""
        graphs = [st.graph for st in self._decodes.values() if st.graph is not None]
        return {"graphs": len(graphs), "capture_s": sum(g.capture_s for g in graphs),
                "pool_bytes": sum(g.pool_bytes for g in graphs),
                "replays": sum(g.replays for g in graphs)}

    def generate(
        self,
        prompt_tokens: list[int],
        n_predict: int,
        sp: SamplerParams = SamplerParams(),
        on_token: Callable[[int], bool] | None = None,
        eos_id: int = 2,
        ignore_eos: bool = False,
    ) -> list[int]:
        """Prefill the prompt, then decode up to n_predict tokens, surfacing
        tokens to the host in blocks of ecfg.decode_block. on_token returns
        False to stop early."""
        if not self.ecfg.ctx_ring and self.n_past + len(prompt_tokens) + n_predict > self.ecfg.n_ctx:
            raise ValueError("context overflow; use ctx_ring or the CLI's ContextManager")
        if sp.repeat_last_n <= 0:
            # penalty disabled: a 1-slot dummy window and a neutral factor
            sp = replace(sp, repeat_last_n=1, repeat_penalty=1.0)
            last_np = np.full(1, -1, np.int64)
        else:
            w = sp.repeat_last_n
            last_np = np.full(w, -1, np.int64)
            hist = (self.tokens + list(prompt_tokens))[-w:]
            if hist:
                last_np[-len(hist):] = hist
        last = torch.from_numpy(last_np).to(self.device)

        logits = self._eval(prompt_tokens)
        tok = sample_token(logits[-1], last, self.generator, sp)
        last = torch.roll(last, -1)
        last[-1] = tok

        out: list[int] = []
        t0 = time.perf_counter()
        n_eval = 0
        stop = False

        def surface(t: int) -> bool:
            """Append one sampled token; returns True if generation must stop."""
            nonlocal stop
            out.append(t)
            self.tokens.append(t)
            if on_token is not None and not on_token(t):
                stop = True
            if not ignore_eos and t == eos_id:
                stop = True
            return stop or len(out) >= n_predict

        surface(int(tok))  # first token, sampled from the prefill logits
        while not stop and len(out) < n_predict:
            n = min(self.ecfg.decode_block, n_predict - len(out))
            if not self.ecfg.ctx_ring:  # a ring decodes past n_ctx
                n = min(n, self.ecfg.n_ctx - self.n_past)
            toks, last = self._decode_block(tok, last, sp, n)
            block = toks.tolist()  # the one host read of this block
            consumed = 0
            for t in block:
                consumed += 1
                if surface(t):
                    break
            n_eval += consumed
            # feeding tok evaluated it; of the consumed samples all but the
            # last are evaluated too -> n_past advances by `consumed`; the
            # final sample stays pending (eval() backlogs it)
            self.n_past += consumed
            tok = toks[consumed - 1]
        self.timings.t_eval_us += (time.perf_counter() - t0) * 1e6
        self.timings.n_eval += n_eval
        return out[:n_predict]

    # --- session save/restore (llama_get/set_kv_cache parity) ------------

    def save_session(self) -> SessionState:
        """Clone the cache, scale planes included (bf16, int8 or f32 data):
        the live one is updated in place."""
        c = self.cache.clone()
        return SessionState(k=c.k, v=c.v, n_past=self.n_past, tokens=list(self.tokens),
                            k_scale=c.k_scale, v_scale=c.v_scale, pos=c.pos)

    def restore_session(self, s: SessionState) -> None:
        """Copy the snapshot into the live cache (same shapes and types; any
        device): its tensors stay where the captured graphs hold them."""
        saved = KVCache(s.k, s.v, s.k_scale, s.v_scale, s.pos)
        if (saved.quantized != self.cache.quantized or saved.ring != self.cache.ring
                or any(a.shape != b.shape or a.dtype != b.dtype
                       for a, b in zip(saved.planes(), self.cache.planes()))):
            raise ValueError("restore_session: the snapshot does not fit this engine's cache")
        for dst, src in zip(self.cache.planes(), saved.planes()):
            dst.copy_(src)
        if self.cache.ring:
            self.cache.pos.copy_(s.pos)
        self.n_past = s.n_past
        self.tokens = list(s.tokens)
