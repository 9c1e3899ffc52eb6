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
    seen[idx] = True
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
    return top_idx[torch.argmax(probs / e)]


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
