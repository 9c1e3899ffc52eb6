"""Speculative decoding (twin of `llamavk_tpu/runtime/speculative.py`): a draft
proposes up to gamma - 1 tokens, the target verifies them in one
multi-token forward.

Two drafters:

* `LookupEngine`, prompt lookup: the draft is the continuation of the most
  recent earlier occurrence of the current 2-gram (previous token, pending
  token) in the row's own context (`lookup_draft_batched`). No second model:
  a round costs about one decode step and yields 1..gamma tokens.
* `SpeculativeEngine`, a draft model decoding gamma tokens one by one.

Per round, on the device: draft, one target forward over [tok, d_0 ..
d_{gamma-2}] (gamma rows at n_past, the KV writes in place), accept the
longest agreeing prefix (`first_reject`), then emit the target's own token at
the first disagreement, or the bonus token (`assemble_emitted`). Rows past the
accepted prefix hold stale K/V at positions >= n_past, which no query reads
and the next round overwrites. `rounds_per_block` rounds run per host
round-trip: the tokens, the context and n_past stay device tensors, and only
the emitted ids and their counts cross to the host, once per block.

Greedy rounds emit exactly the target's greedy stream; the drafts only change
how many tokens a round yields. Sampled rounds use rejection sampling over
the transformed (temperature / top-k / top-p) distributions, so the emitted
tokens are distributed as target-only sampling; a prompt-lookup draft is a
point mass, so its scheme accepts d with probability p_t(d) and otherwise
draws from p_t with d removed. Random draws come from a `torch.Generator`
seeded per call (the JAX package's keys give other numbers).

A draft id of -1 (no match) is fed to the verify forward as it is: the
embedding gather wraps it to the last vocabulary row in both frameworks, and
the K/V it leaves is junk the next round overwrites. The engines' headroom
asserts keep every write inside the cache, where the JAX package's
`dynamic_update_slice` would clamp.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import torch

from ..device import resolve
from ..models.llama import LlamaParams, ModelConfig, init_kv_cache, llama_forward
from .engine import kv_dtype as _kv_dtype
from .sampling import SamplerParams, probs_from_logits


@dataclass(frozen=True)
class SpecConfig:
    n_ctx: int = 512
    gamma: int = 4  # draft tokens proposed per round, the pending token included
    rounds_per_block: int = 16  # verify rounds per host round-trip
    kv_dtype: str = "bfloat16"


def lookup_draft_batched(ctx: torch.Tensor, toks: torch.Tensor, n_past: torch.Tensor,
                         gamma: int):
    """Batched 2-gram prompt-lookup drafting (speculative.py:120-146 there).

    ctx [B, S] token history (rows < n_past[b] valid), toks [B] pending
    tokens, n_past [B] -> (seq [B, gamma] verify inputs, draft [B, gamma-1],
    -1 where nothing matched, p [B] the match positions or -1). The match is
    the latest p in [1, n_past - gamma] with ctx[p] == tok and ctx[p-1] ==
    the previous token; the draft is ctx[p+1 : p+gamma]."""
    bsz, s = ctx.shape
    dev = ctx.device
    n_past = n_past.to(torch.int64)
    idx = torch.arange(s, device=dev)[None]
    prev = ctx.gather(1, torch.clamp(n_past - 1, min=0)[:, None])[:, 0]
    shifted = torch.roll(ctx, 1, dims=1)  # shifted[:, p] = ctx[:, p-1]
    match = ((idx >= 1) & (idx <= (n_past - gamma)[:, None]) & (ctx == toks[:, None])
             & (shifted == prev[:, None]))
    p = torch.where(match, idx, torch.full_like(idx, -1)).amax(dim=1)
    # the slice start as dynamic_slice clamps it (p <= n_past - gamma keeps
    # it in range whenever a match exists)
    start = torch.clamp(torch.clamp(p, min=0) + 1, max=s - (gamma - 1))
    draft = ctx.gather(1, start[:, None] + torch.arange(gamma - 1, device=dev)[None])
    draft = torch.where((p >= 0)[:, None], draft, torch.full_like(draft, -1))
    seq = torch.cat([toks[:, None].to(ctx.dtype), draft], dim=1)
    return seq, draft, p


def first_reject(acc: torch.Tensor) -> torch.Tensor:
    """acc [B, gamma-1] accept flags -> k [B]: the index of the first
    rejection, gamma-1 when every draft was accepted (speculative.py:149)."""
    last = torch.ones((acc.shape[0], 1), dtype=torch.bool, device=acc.device)
    stop = torch.cat([~acc, last], dim=1)
    return stop.to(torch.int8).argmax(dim=1)  # the first maximum


def assemble_emitted(k: torch.Tensor, draft: torch.Tensor, corr: torch.Tensor, gamma: int):
    """Round outputs (speculative.py:158-168 there): emitted [B, gamma], the
    accepted draft prefix then the correction or bonus token, and count [B] =
    k + 1 valid entries per row."""
    draft_pad = torch.cat([draft, torch.zeros((draft.shape[0], 1), dtype=draft.dtype,
                                              device=draft.device)], dim=1)
    pos = torch.arange(gamma, device=draft.device)[None]
    emitted = torch.where(pos < k[:, None], draft_pad, corr[:, None].to(draft.dtype))
    return emitted, k + 1


def _categorical(probs: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
    """One draw per row of probs [..., V] (unnormalized, >= 0) by the
    exponential race argmax p_i / E_i, E ~ Exp(1): no host sync."""
    e = torch.empty_like(probs).exponential_(generator=gen).clamp_min(1e-30)
    return torch.argmax(probs / e, dim=-1)


def _verify_probs(logits: torch.Tensor, sp: SamplerParams) -> torch.Tensor:
    """The sampler's distributions of the gamma verify rows [gamma, V]."""
    return torch.stack([probs_from_logits(lg, sp.top_k, sp.top_p, sp.temp) for lg in logits])


class _SpecBase:
    """Prefill, the host side of the round loop, and the stats shared by the
    two engines."""

    def __init__(self, scfg: SpecConfig, device):
        self.device = resolve(device)
        self.scfg = scfg
        self.kv_dtype = _kv_dtype(scfg.kv_dtype, scfg.n_ctx)
        if scfg.gamma < 1:
            raise ValueError("gamma must be >= 1")
        self.stats = {"rounds": 0, "accepted": 0, "emitted": 0}
        self.t_rounds = 0.0  # host seconds of the round blocks, prefill excluded

    def _cache(self, cfg: ModelConfig):
        return init_kv_cache(cfg, 1, self.scfg.n_ctx, self.kv_dtype, self.device)

    def _prefill(self, params, cfg, cache, prompt: list[int]) -> torch.Tensor:
        """The prompt in a power-of-two bucket (capped at n_ctx) at n_past 0;
        returns the last prompt row's logits [V]."""
        plen = len(prompt)
        bucket = min(1 << (plen - 1).bit_length(), self.scfg.n_ctx)
        toks = torch.zeros((1, bucket), dtype=torch.int64)
        toks[0, :plen] = torch.tensor(prompt)
        logits, _, _ = llama_forward(params, toks.to(self.device), cache, 0, cfg,
                                     last_idx=plen - 1)
        return logits[0, -1]

    def _check_room(self, plen: int, n_predict: int) -> None:
        # every block runs rounds_per_block full rounds: the last one can
        # overshoot the budget by rounds_per_block * gamma rows of writes
        g = self.scfg.gamma
        headroom = self.scfg.rounds_per_block * g + g + 1
        if plen < 1 or plen + n_predict + headroom > self.scfg.n_ctx:
            raise ValueError(f"context overflow: prompt {plen} + n_predict {n_predict} + "
                             f"rounds_per_block*gamma headroom {headroom} > n_ctx "
                             f"{self.scfg.n_ctx}")

    def _consume(self, out: list[int], toks_r: torch.Tensor, counts: torch.Tensor,
                 n_predict: int, eos_id: int, ignore_eos: bool) -> bool:
        """Append a block's emitted tokens ([R, gamma] and [R]: its one host
        read); True when generation stops."""
        toks_h, counts_h = toks_r.tolist(), counts.tolist()
        for row, c in zip(toks_h, counts_h):
            self.stats["rounds"] += 1
            self.stats["accepted"] += c - 1
            for t in row[:c]:
                out.append(int(t))
                self.stats["emitted"] += 1
                if (not ignore_eos and int(t) == eos_id) or len(out) >= n_predict:
                    return True
        return False

    def _generate(self, prompt_tokens, n_predict, eos_id, ignore_eos, logits, sp, gen,
                  round_fn) -> list[int]:
        """The host loop: the first token from the prefill logits (greedy
        when sp is None), then blocks of rounds_per_block rounds (`round_fn`:
        (tok, n_past) -> (emitted, count, tok, n_past), all device tensors)
        until n_predict tokens or EOS."""
        if sp is None:
            tok = torch.argmax(logits)
        else:
            tok = _categorical(probs_from_logits(logits, sp.top_k, sp.top_p, sp.temp), gen)
        out = [int(tok)]
        t0 = time.perf_counter()
        if ignore_eos or out[-1] != eos_id:
            npast = torch.tensor([len(prompt_tokens)], dtype=torch.int32, device=self.device)
            tok = tok.view(1)
            while len(out) < n_predict:
                toks, counts = [], []
                for _ in range(self.scfg.rounds_per_block):
                    emitted, count, tok, npast = round_fn(tok, npast)
                    toks.append(emitted)
                    counts.append(count)
                if self._consume(out, torch.stack(toks), torch.cat(counts), n_predict, eos_id,
                                 ignore_eos):
                    break
        self.t_rounds += time.perf_counter() - t0
        # the device ran ahead of any early stop; the host-consumed prefix is
        # the valid context: the prompt and every token but the pending last
        out = out[:n_predict]
        self.n_past = len(prompt_tokens) + max(len(out) - 1, 0)
        return out

    @property
    def acceptance_rate(self) -> float:
        r = self.stats["rounds"]
        return self.stats["accepted"] / max(r * (self.scfg.gamma - 1), 1)


class SpeculativeEngine(_SpecBase):
    """Decode over a (target, draft) model pair (speculative.py:369-515
    there). Greedy rounds emit the target's greedy stream; sampled rounds
    (`sp.temp > 0`) use standard rejection sampling with both models'
    transformed distributions."""

    def __init__(self, cfg_t: ModelConfig, params_t: LlamaParams, cfg_d: ModelConfig,
                 params_d: LlamaParams, scfg: SpecConfig = SpecConfig(), device="cuda"):
        super().__init__(scfg, device)
        self.cfg_t, self.params_t = cfg_t, params_t
        self.cfg_d, self.params_d = cfg_d, params_d
        self.reset()

    def reset(self) -> None:
        self.cache_t = self._cache(self.cfg_t)
        self.cache_d = self._cache(self.cfg_d)
        self.n_past = 0

    def _draft(self, tok, npast, sp_d: SamplerParams | None, gen):
        """gamma draft steps, each fed back; the gamma-th writes d_{gamma-2}'s
        K/V row, which a fully accepted round's next drafts attend to.
        Returns (draft [gamma], draft distributions [gamma, V] or None)."""
        g = self.scfg.gamma
        toks, probs = [], []
        t = tok
        for i in range(g):
            lg, _, _ = llama_forward(self.params_d, t.view(1, 1), self.cache_d, npast + i,
                                     self.cfg_d)
            if sp_d is None:
                t = torch.argmax(lg[0, -1]).view(1)
            else:
                pd = probs_from_logits(lg[0, -1], sp_d.top_k, sp_d.top_p, sp_d.temp)
                probs.append(pd)
                t = _categorical(pd, gen).view(1)
            toks.append(t)
        return torch.cat(toks), (torch.stack(probs) if probs else None)

    def _round(self, tok, npast, sp, sp_d, gen):
        """One round (greedy: speculative.py:56-117; sampled: :291-366 there)."""
        g = self.scfg.gamma
        draft, pd_all = self._draft(tok, npast, sp_d, gen)
        seq = torch.cat([tok, draft[:-1]])[None]
        lg, _, _ = llama_forward(self.params_t, seq, self.cache_t, npast, self.cfg_t,
                                 logits_all=True)
        if sp is None:
            y = torch.argmax(lg[0], dim=-1)  # [gamma]
            k = first_reject((draft[: g - 1] == y[: g - 1])[None])
            corr = y[k]
        else:
            pt_all = _verify_probs(lg[0], sp)
            idx = torch.arange(g - 1, device=self.device)
            us = torch.rand(g - 1, generator=gen, device=self.device)
            ratio = pt_all[idx, draft[: g - 1]] / torch.clamp(pd_all[idx, draft[: g - 1]],
                                                               min=1e-30)
            k = first_reject((us < torch.clamp(ratio, max=1.0))[None])
            # the residual at the rejection, or p_t itself for the bonus token
            sub = torch.where(k < g - 1, pd_all[k], torch.zeros_like(pd_all[k]))
            corr = _categorical(torch.clamp(pt_all[k] - sub, min=0.0), gen)
        emitted, count = assemble_emitted(k, draft[None, : g - 1], corr, g)
        return emitted[0], count, corr, npast + count.to(npast.dtype)

    def generate(self, prompt_tokens: list[int], n_predict: int, eos_id: int = 2,
                 ignore_eos: bool = False, sp: SamplerParams | None = None,
                 draft_sp: SamplerParams | None = None, seed: int = 0) -> list[int]:
        """Single-shot generation (the engine resets itself first). sp None or
        greedy: the target's greedy stream. Otherwise speculative rejection
        sampling; repeat_penalty must be off (1.0): its window would have to
        evolve within rounds on both models."""
        sampled = sp is not None and sp.temp > 0
        if sampled:
            assert sp.repeat_penalty == 1.0, "speculative sampling does not support repeat_penalty"
            draft_sp = draft_sp or sp
        self._check_room(len(prompt_tokens), n_predict)
        self.reset()
        logits = self._prefill(self.params_t, self.cfg_t, self.cache_t, prompt_tokens)
        self._prefill(self.params_d, self.cfg_d, self.cache_d, prompt_tokens)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        sp_t, sp_d = (sp, draft_sp) if sampled else (None, None)
        return self._generate(prompt_tokens, n_predict, eos_id, ignore_eos, logits, sp_t, gen,
                              lambda tok, npast: self._round(tok, npast, sp_t, sp_d, gen))


class LookupEngine(_SpecBase):
    """Decode with prompt-lookup (n-gram) drafts (speculative.py:518-631
    there): no draft model, a round costs about one decode step. Greedy
    rounds emit exactly the plain greedy stream; sampled rounds use the
    deterministic-proposal rejection scheme."""

    def __init__(self, cfg: ModelConfig, params: LlamaParams, scfg: SpecConfig = SpecConfig(),
                 device="cuda"):
        super().__init__(scfg, device)
        self.cfg, self.params = cfg, params
        self.reset()

    def reset(self) -> None:
        self.cache = self._cache(self.cfg)
        self.n_past = 0

    def _round(self, tok, ctx, npast, sp, gen):
        """One round (greedy: speculative.py:171-222; sampled: :225-288
        there). ctx [1, n_ctx] is updated in place with the consumed inputs."""
        g = self.scfg.gamma
        seq, draft, p = lookup_draft_batched(ctx, tok, npast, g)
        lg, _, _ = llama_forward(self.params, seq, self.cache, npast, self.cfg, logits_all=True)
        if sp is None:
            y = torch.argmax(lg[0], dim=-1)
            k = first_reject(draft == y[None, : g - 1])
            corr = y[k]
        else:
            pt_all = _verify_probs(lg[0], sp)
            us = torch.rand(g - 1, generator=gen, device=self.device)
            # a point-mass proposal: accept d_i with probability p_t(d_i); a
            # -1 draft (no match) is a certain rejection
            safe = torch.clamp(draft[0], min=0)
            acc = (us < pt_all[torch.arange(g - 1, device=self.device), safe]) & (draft[0] >= 0)
            k = first_reject(acc[None])
            # the residual: p_t with the rejected draft removed (a no-match
            # round and the bonus keep p_t as it is)
            rej = torch.cat([safe, torch.zeros_like(safe[:1])])[torch.clamp(k, max=g - 1)]
            drop = (k < g - 1) & (p >= 0)
            resid = pt_all[k].clone()
            resid[0].scatter_(0, rej, torch.where(drop, 0.0, 1.0) * resid[0].gather(0, rej))
            corr = _categorical(resid, gen)
        emitted, count = assemble_emitted(k, draft, corr, g)
        # the consumed-input rows: seq[0..k] valid, the rest junk that the
        # next round overwrites (rows >= n_past are never read)
        ctx.scatter_(1, npast.to(torch.int64)[:, None] + torch.arange(g, device=self.device), seq)
        return emitted[0], count, corr, npast + count.to(npast.dtype)

    def generate(self, prompt_tokens: list[int], n_predict: int, eos_id: int = 2,
                 ignore_eos: bool = False, sp: SamplerParams | None = None,
                 seed: int = 0) -> list[int]:
        """sp None or greedy: the plain greedy stream. Otherwise sampled
        lookup speculation; repeat_penalty must be off (1.0)."""
        sampled = sp is not None and sp.temp > 0
        if sampled:
            assert sp.repeat_penalty == 1.0, "lookup sampling does not support repeat_penalty"
        self._check_room(len(prompt_tokens), n_predict)
        self.reset()
        logits = self._prefill(self.params, self.cfg, self.cache, prompt_tokens)
        ctx = torch.zeros((1, self.scfg.n_ctx), dtype=torch.int64)
        ctx[0, : len(prompt_tokens)] = torch.tensor(prompt_tokens)
        ctx = ctx.to(self.device)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        sp_round = sp if sampled else None
        return self._generate(prompt_tokens, n_predict, eos_id, ignore_eos, logits, sp_round, gen,
                              lambda tok, npast: self._round(tok, ctx, npast, sp_round, gen))
