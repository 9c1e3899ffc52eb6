"""llama.h-shaped compatibility API (twin of `llamavk_tpu/compat.py`).

The reference's public surface is a C ABI (`llama.h:36-168`): context
lifecycle, eval, tokenize, sampling, KV-cache snapshot, timings. This module
exposes the same functions under the same names over the port's engine, so
code written against the reference's Python bindings ports by changing one
import. Each function cites the llama.h declaration it mirrors. The context
runs on the card unless `llama_context_params.device` is "cpu".

    from llamavk_tpu_torch import compat as llama

    ctx = llama.llama_init_from_file("ggml-model-q4_0.bin",
                                     llama.llama_context_default_params())
    ids = llama.llama_tokenize(ctx, b" Hello", add_bos=True)
    llama.llama_eval(ctx, ids, n_past=0)
    tok = llama.llama_sample_top_p_top_k(ctx, ids, 40, 0.95, 0.8, 1.1)
    print(llama.llama_token_to_str(ctx, tok))

`f16_kv = false` (the reference's `--memory_f32`) gives an f32 KV cache.
The KV blob of `llama_get_kv_cache` has the JAX package's layout for bf16
and f32 caches ([L, 1, H, n_ctx, D] K, then V, native byte order), so a blob
written by either package restores in the other.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from .models.loader import load_model
from .runtime.engine import Engine, EngineConfig, SessionState, Timings
from .runtime.sampling import SamplerParams, sample_token
from .tokenizer import Tokenizer
from .utils.trace import system_info


@dataclass
class llama_context_params:
    """llama_context_params (llama.h:50-68), plus the device to run on."""

    n_ctx: int = 512
    n_parts: int = -1  # auto
    seed: int = 0
    f16_kv: bool = True
    logits_all: bool = False
    vocab_only: bool = False
    use_mmap: bool = True  # always mmap-backed here
    use_mlock: bool = False
    embedding: bool = True
    device: str = "cuda"  # "cpu" runs the kernels' plain versions


@dataclass
class llama_context:
    """Opaque context handle (llama_context, llama.cpp:105-157)."""

    engine: Engine | None
    tokenizer: Tokenizer
    params: llama_context_params
    logits: np.ndarray = field(default_factory=lambda: np.zeros((0,), np.float32))


def llama_context_default_params() -> llama_context_params:
    """llama_context_default_params (llama.h:70, llama.cpp:702-718)."""
    return llama_context_params()


def llama_mmap_supported() -> bool:  # llama.h:72
    return True


def llama_mlock_supported() -> bool:  # llama.h:73
    return False  # device memory, not host pages — nothing to mlock


def llama_init_from_file(path: str, params: llama_context_params | None = None):
    """llama_init_from_file (llama.h:78-80)."""
    p = params or llama_context_default_params()
    n_parts = None if p.n_parts < 0 else p.n_parts
    if p.vocab_only:
        from .formats.ggml_io import CheckpointReader

        reader = CheckpointReader(path, n_parts)
        return llama_context(engine=None, tokenizer=Tokenizer(reader.vocab), params=p)
    t0 = time.perf_counter()
    cfg, model_params, tok = load_model(path, n_parts=n_parts, device=p.device)
    eng = Engine(
        cfg,
        model_params,
        EngineConfig(
            n_ctx=p.n_ctx,
            kv_dtype="bfloat16" if p.f16_kv else "float32",
            seed=p.seed,
        ),
        device=p.device,
    )
    eng.timings.t_load_us = (time.perf_counter() - t0) * 1e6
    return llama_context(engine=eng, tokenizer=tok, params=p)


def llama_free(ctx: llama_context) -> None:
    """llama_free (llama.h:82) — buffers are freed with their last reference."""
    ctx.engine = None


def llama_model_quantize(fname_inp: str, fname_out: str, itype: int) -> int:
    """llama_model_quantize (llama.h:85-88). Returns 0 on success."""
    from .cli.quantize import quantize_file

    quantize_file(fname_inp, fname_out, itype, verbose=False)
    return 0


def llama_eval(ctx, tokens, n_past: int | None = None, n_threads: int = 0) -> int:
    """llama_eval (llama.h:108-113). n_threads is accepted for signature
    parity and ignored (the device schedules its own work)."""
    eng = ctx.engine
    if n_past is not None and n_past != eng.n_past:
        if n_past == 0:
            eng.reset()
        elif n_past < eng.n_past:
            eng.n_past = n_past  # rewind: cache beyond n_past is stale-but-masked
            eng.tokens = eng.tokens[:n_past]
    ctx.logits = eng.eval(list(tokens), logits_all=ctx.params.logits_all)
    return 0


def llama_tokenize(ctx, text: bytes | str, add_bos: bool = False) -> list[int]:
    """llama_tokenize (llama.h:120-128)."""
    return ctx.tokenizer.encode(text, bos=add_bos)


def llama_n_vocab(ctx) -> int:  # llama.h:130
    return len(ctx.tokenizer.vocab)


def llama_n_ctx(ctx) -> int:  # llama.h:131
    return ctx.params.n_ctx


def llama_n_embd(ctx) -> int:  # llama.h:132
    return ctx.engine.cfg.n_embd


def llama_get_logits(ctx) -> np.ndarray:
    """llama_get_logits (llama.h:134-139): rows = n_tokens if logits_all else 1."""
    lg = ctx.logits
    return lg if lg.ndim == 2 else lg[None]


def llama_get_embeddings(ctx) -> np.ndarray:  # llama.h:141-144
    return ctx.engine.get_embeddings()


def llama_token_to_str(ctx, token: int) -> bytes:  # llama.h:146-147
    return ctx.tokenizer.decode_token(token)


def llama_token_bos() -> int:  # llama.h:149-151
    return 1


def llama_token_eos() -> int:
    return 2


def llama_sample_top_p_top_k(
    ctx,
    last_n_tokens: list[int],
    top_k: int,
    top_p: float,
    temp: float,
    repeat_penalty: float,
) -> int:
    """llama_sample_top_p_top_k (llama.h:153-161) over the last logits row,
    drawn from the engine's generator (temp <= 0: the argmax)."""
    eng = ctx.engine
    sp = SamplerParams(
        top_k=top_k,
        top_p=top_p,
        temp=temp,
        repeat_penalty=repeat_penalty,
        repeat_last_n=max(len(last_n_tokens), 1),
    )
    w = sp.repeat_last_n
    last = np.full(w, -1, np.int64)
    if last_n_tokens:
        last[-len(last_n_tokens):] = last_n_tokens[-w:]
    logits = torch.from_numpy(np.ascontiguousarray(llama_get_logits(ctx)[-1]))
    tok = sample_token(logits.to(eng.device), torch.from_numpy(last).to(eng.device),
                       eng.generator, sp)
    return int(tok)


# --- KV-cache snapshot (llama.h:91-106) -------------------------------------


def _planes(c) -> list[torch.Tensor]:
    """The blob's planes in order: k, v, the scale planes of an int8 cache,
    the history ring's position plane."""
    return c.planes() + ([c.pos] if c.ring else [])


def _bytes(t: torch.Tensor) -> bytes:
    return t.detach().contiguous().cpu().view(torch.uint8).numpy().tobytes()


def llama_get_kv_cache(ctx) -> bytes:
    return b"".join(_bytes(t) for t in _planes(ctx.engine.cache))


def llama_get_kv_cache_size(ctx) -> int:
    return sum(t.numel() * t.element_size() for t in _planes(ctx.engine.cache))


def llama_get_kv_cache_token_count(ctx) -> int:
    return ctx.engine.n_past


def llama_set_kv_cache(ctx, data: bytes, n_token_count: int) -> None:
    eng = ctx.engine
    raw = np.frombuffer(data, np.uint8)
    planes, off = [], 0
    for tmpl in _planes(eng.cache):
        n = tmpl.numel() * tmpl.element_size()
        chunk = torch.from_numpy(raw[off : off + n].copy())
        planes.append(chunk.view(tmpl.dtype).reshape(tmpl.shape).to(eng.device))
        off += n
    c = eng.cache
    ks = vs = pos = None
    if c.quantized:
        ks, vs = planes[2:4]
    if c.ring:
        pos = planes[-1]
    eng.restore_session(
        SessionState(k=planes[0], v=planes[1], n_past=n_token_count,
                     tokens=eng.tokens[:n_token_count], k_scale=ks, v_scale=vs, pos=pos)
    )


# --- timings / info ----------------------------------------------------------


def llama_print_timings(ctx) -> None:  # llama.h:164
    print(ctx.engine.timings.report())


def llama_reset_timings(ctx) -> None:  # llama.h:165
    ctx.engine.timings = Timings()


def llama_print_system_info() -> str:  # llama.h:168
    return system_info()


def llama_internal_get_tensor_map(ctx):
    """llama_internal_get_tensor_map (llama_internal.h:91-102 analog): the
    engine's parameters for introspection tooling."""
    return ctx.engine.params
