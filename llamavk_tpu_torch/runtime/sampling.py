"""On-device top-k / top-p / repeat-penalty sampling (twin of
`llamavk_tpu/runtime/sampling.py`), plain torch.

Semantics of the reference CPU sampler `llama_sample_top_p_top_k`
(`llama.cpp:1368-1459`):

  1. repetition penalty on tokens present in the last-N window: the scaled
     logit is divided by `repeat_penalty` when positive, multiplied when
     negative;
  2. temperature scale 1/temp (temp <= 0 → greedy argmax);
  3. keep top-k by logit;
  4. softmax over kept; top-p keeps the smallest prefix of the descending
     order whose cumulative prob reaches top_p (the crossing token stays);
  5. draw from the renormalized distribution with an explicit
     `torch.Generator` on the logits' device.

The sampled id stays a device tensor: nothing here waits for the device.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True)
class SamplerParams:
    top_k: int = 40
    top_p: float = 0.95
    temp: float = 0.8
    repeat_penalty: float = 1.10
    repeat_last_n: int = 64  # size of the penalty window


def _apply_repeat_penalty(
    logits: torch.Tensor,  # [V] f32
    last_tokens: torch.Tensor,  # [W] int, padded with -1
    scale: float,
    repeat_penalty: float,
) -> torch.Tensor:
    v = logits.shape[-1]
    # padding (-1) scatters into a spare slot V that is cut off
    idx = torch.where(last_tokens >= 0, last_tokens, v).to(torch.int64)
    seen = torch.zeros(v + 1, dtype=torch.bool, device=logits.device)
    seen.scatter_(0, idx, True)  # no host value: a CUDA graph captures it
    seen = seen[:v]
    scaled = logits * scale
    penalized = torch.where(logits < 0.0, scaled * repeat_penalty, scaled / repeat_penalty)
    return torch.where(seen, penalized, scaled)


def _top_k_top_p(scaled: torch.Tensor, top_k: int, top_p: float):
    """(probs over the kept descending top-k set with top-p applied, ids)."""
    v = scaled.shape[-1]
    k = v if top_k <= 0 else min(top_k, v)
    top_vals, top_idx = torch.topk(scaled, k)  # descending
    probs = torch.softmax(top_vals, dim=-1)
    csum = torch.cumsum(probs, dim=-1)
    # keep entries whose *preceding* cumulative mass is < top_p
    keep = torch.cat([torch.ones(1, dtype=torch.bool, device=probs.device), csum[:-1] < top_p])
    return torch.where(keep, probs, torch.zeros_like(probs)), top_idx


def sample_token(
    logits: torch.Tensor,  # [V] f32 (single position)
    last_tokens: torch.Tensor,  # [W] int, -1 padded
    generator: torch.Generator,  # on logits' device
    sp: SamplerParams,
) -> torch.Tensor:
    """Returns a 0-dim int64 token id on logits' device."""
    if sp.temp <= 0.0:
        # greedy; argmax picks the lowest index among ties like the reference
        return torch.argmax(logits)
    scaled = _apply_repeat_penalty(logits, last_tokens, 1.0 / sp.temp, sp.repeat_penalty)
    probs, top_idx = _top_k_top_p(scaled, sp.top_k, sp.top_p)
    # exponential race: argmax p_i / E_i with E_i ~ Exp(1) draws i with
    # probability p_i / sum(p) — a categorical draw that never syncs the host
    e = torch.empty_like(probs).exponential_(generator=generator).clamp_min(1e-30)
    # a gather, not an index by a 0-dim tensor (which reads it on the host)
    return top_idx.gather(0, torch.argmax(probs / e).view(1)).view(())


def probs_from_logits(
    logits: torch.Tensor,  # [V] f32
    top_k: int,
    top_p: float,
    temp: float,
) -> torch.Tensor:
    """The full-vocab distribution sample_token draws from (temperature +
    top-k + top-p, renormalized; zero outside the kept set). Greedy
    (temp <= 0) is a point mass on the argmax."""
    v = logits.shape[-1]
    if temp <= 0.0:
        out = torch.zeros(v, dtype=torch.float32, device=logits.device)
        out[torch.argmax(logits)] = 1.0
        return out
    probs, top_idx = _top_k_top_p(logits / max(temp, 1e-6), top_k, top_p)
    probs = probs / probs.sum()
    out = torch.zeros(v, dtype=probs.dtype, device=logits.device)
    out[top_idx] = probs
    return out


def sample_logits_host(logits, last_tokens, sp: SamplerParams, rng: np.random.Generator):
    """NumPy twin of sample_token (copy of the JAX package's), for tests."""
    logits = np.asarray(logits, np.float32)
    if sp.temp <= 0.0:
        return int(logits.argmax())
    scale = 1.0 / sp.temp
    scaled = logits * scale
    for t in set(int(t) for t in last_tokens if t >= 0):
        scaled[t] = (
            logits[t] * scale * sp.repeat_penalty
            if logits[t] < 0
            else logits[t] * scale / sp.repeat_penalty
        )
    k = len(logits) if sp.top_k <= 0 else min(sp.top_k, len(logits))
    order = np.argsort(-scaled, kind="stable")[:k]
    vals = scaled[order]
    probs = np.exp(vals - vals.max())
    probs /= probs.sum()
    if sp.top_p < 1.0:
        csum = np.cumsum(probs)
        cut = int(np.searchsorted(csum, sp.top_p) + 1)
        probs = probs[:cut]
        order = order[:cut]
        probs = probs / probs.sum()
    return int(order[rng.choice(len(probs), p=probs)])


# --- vectorized sampler (continuous batching: per-slot parameters) ----------


def _penalize_batched(logits, last_tokens, scale, repeat_penalty):
    """_apply_repeat_penalty over [B, V] logits with [B, W] windows and [B]
    scales and penalties."""
    b, v = logits.shape
    idx = torch.where(last_tokens >= 0, last_tokens, v).to(torch.int64)
    seen = torch.zeros((b, v + 1), dtype=torch.bool, device=logits.device)
    seen.scatter_(1, idx, True)
    seen = seen[:, :v]
    scaled = logits * scale[:, None]
    pen = repeat_penalty[:, None]
    return torch.where(seen, torch.where(logits < 0.0, scaled * pen, scaled / pen), scaled)


def _kept_probs_batched(logits, last_tokens, top_k, top_p, temp, repeat_penalty):
    """(probs over each row's descending top-k set with top-p applied, ids):
    repeat penalty, temperature (1 for greedy rows), top-k, softmax, top-p
    (sampling.py:120-143 there)."""
    v = logits.shape[-1]
    scale = torch.where(temp > 0, 1.0 / torch.clamp(temp, min=1e-6), torch.ones_like(temp))
    scaled = _penalize_batched(logits, last_tokens, scale, repeat_penalty)
    k = v if top_k <= 0 else min(top_k, v)
    top_vals, top_idx = torch.topk(scaled, k, dim=-1)
    probs = torch.softmax(top_vals, dim=-1)
    csum = torch.cumsum(probs, dim=-1)
    first = torch.ones_like(csum[:, :1], dtype=torch.bool)
    keep = torch.cat([first, csum[:, :-1] < top_p[:, None]], dim=1)
    return torch.where(keep, probs, torch.zeros_like(probs)), top_idx


def sample_tokens_batched(
    logits: torch.Tensor,  # [B, V] f32
    last_tokens: torch.Tensor,  # [B, W] int, -1 padded
    noise: torch.Tensor,  # [B, min(top_k, V)] Exp(1) draws, one row per slot
    top_k: int,  # shared pool size (BatchConfig.top_k)
    top_p: torch.Tensor,  # [B] per-row parameters
    temp: torch.Tensor,
    repeat_penalty: torch.Tensor,
) -> torch.Tensor:
    """One token per row, [B] int64 on the logits' device (no host sync).
    A row with temp <= 0 takes the argmax of its RAW logits, as
    sampling.py:142 there does; the others draw from their kept set by the
    exponential race argmax p_i / E_i, with E the row's noise. The caller
    draws each row's noise from that row's own generator."""
    probs, top_idx = _kept_probs_batched(logits, last_tokens, top_k, top_p, temp,
                                         repeat_penalty)
    choice = torch.argmax(probs / noise.clamp_min(1e-30), dim=-1, keepdim=True)
    sampled = top_idx.gather(1, choice)[:, 0]
    return torch.where(temp > 0, sampled, torch.argmax(logits, dim=-1))


def sample_token_dyn(logits, last_tokens, noise, top_k, top_p, temp, repeat_penalty):
    """sample_tokens_batched for one row: logits [V], last_tokens [W],
    noise [k], tensor scalars for the parameters."""
    params = (torch.as_tensor(x, dtype=torch.float32, device=logits.device).reshape(1)
              for x in (top_p, temp, repeat_penalty))
    return sample_tokens_batched(logits[None], last_tokens[None], noise[None], top_k,
                                 *params)[0]


def probs_batched_dyn(
    logits: torch.Tensor,  # [B, V] f32
    last_tokens: torch.Tensor,  # [B, W] int, -1 padded
    top_k: int,
    top_p: torch.Tensor,  # [B]
    temp: torch.Tensor,
    repeat_penalty: torch.Tensor,
) -> torch.Tensor:
    """The full-vocab distributions sample_tokens_batched draws from,
    [B, V] (renormalized; zero outside the kept set). A greedy row is a
    point mass on the argmax of its raw logits (sampling.py:178-202 there)."""
    b, v = logits.shape
    probs, top_idx = _kept_probs_batched(logits, last_tokens, top_k, top_p, temp,
                                         repeat_penalty)
    probs = probs / probs.sum(dim=-1, keepdim=True)
    full = torch.zeros((b, v), dtype=probs.dtype, device=logits.device).scatter(1, top_idx, probs)
    greedy = torch.zeros_like(full).scatter(1, torch.argmax(logits, dim=-1, keepdim=True), 1.0)
    return torch.where(temp[:, None] > 0, full, greedy)


def probs_from_logits_dyn(logits, last_tokens, top_k, top_p, temp, repeat_penalty):
    """probs_batched_dyn for one row: logits [V], last_tokens [W]."""
    params = (torch.as_tensor(x, dtype=torch.float32, device=logits.device).reshape(1)
              for x in (top_p, temp, repeat_penalty))
    return probs_batched_dyn(logits[None], last_tokens[None], top_k, *params)[0]
