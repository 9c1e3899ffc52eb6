"""Continuous batching scheduler, the serving layer (twin of
`llamavk_tpu/runtime/batching.py`, flat and paged caches, one device or a
tensor-parallel mesh).

B request slots decode in lockstep through one batched forward pass per
step; requests join and leave between decode blocks, and each slot owns a
region of the KV cache addressed by its own n_past (a per-row position
vector). A decode block of `block` steps repeats one step of `llama_forward`
and `sample_tokens_batched` over static buffers (`_BatchDecode`: the tokens,
positions and windows of every slot, the block's per-slot sampler
parameters, the token rows, the page table and prefix operands); its sampled
tokens stay on the device and the host receives one [B, n_steps] tensor per
block. On CUDA the step is captured once in a CUDA graph
(`runtime/graphs.py`; the counterpart of the jitted blocks of
batching.py:331-410 there) and each step of a block is a replay; the graph
is the decode path there, and a failed capture or replay raises. The CPU,
a mesh and the lookup rounds run their steps uncaptured. Admission prefills the
queued prompts in power-of-two chunks of one bucket length into a scratch
cache, copies each row into its slot (in place), and samples the first
tokens on the device; those stay device tensors until the decode block that
consumes them is queued (`_block_inputs`), and reach the host after it
(`_finish_admits`). Finished slots keep computing garbage until the block
ends.

Each slot keeps its own `torch.Generator` for the engine's life, reseeded in
place from the request's `seed` at admission, and draws one row of noise per
decode step (the rows of greedy and free slots are drawn and unused; the
admission sample and the lookup rounds draw for sampled slots only): a
request's draws depend on its seed and its step, never on its slot or its
neighbours.

Paged KV (`BatchConfig.paged`, batching.py:89-114 and 1039-1557 there): K/V
live in one pool of pages (`runtime/paged.py`), so KV memory is the pages in
use. Admission prefills each chunk straight into its slots' pages through
their table rows (no scratch cache, no copies); a registered prefix's full
pages are shared by every slot that continues it, its sub-page remainder
re-evaluated with each suffix; each decode block maps its write pages up
front and, when the pool runs dry, preempts the youngest request (highest
rid), which goes back to the head of the queue with its generated tokens as
prompt. Page 0 is the trash page: free slots keep decoding into it until
their block ends, and no live slot maps it.

Lookup speculation (`BatchConfig.lookup_gamma`, batching.py:455-640 and
1559-1664 there): each step runs rounds instead of single decode steps. A
round drafts up to gamma - 1 tokens per row from the row's own token history
(`ctx_dev [B, n_ctx]`, seeded at admission), verifies gamma rows per slot in
one forward at the rows' own n_past, and emits 1..gamma tokens per row
(`runtime/speculative.py`). Greedy rows emit exactly the plain greedy
stream; sampled rows use the deterministic-proposal rejection scheme with the
repeat penalty folded in per verify position. Paged, each block maps
n_steps * gamma rows of pages ahead and the verify writes may cross a page
(`page_straddle`). A request needs gamma - 1 rows of slack in n_ctx.

Shared-prefix pool (`BatchConfig.shared_prefix`, batching.py:74-82, 662-812
and 962-986 there): a registered prefix is prefilled once into a bf16 cache
of `prefix_ctx` rows and copied into its entry of one pool
[L, prefix_pool, H, prefix_ctx, D], which every slot that continues it
attends through the kernels' prefix pre-pass. Slots hold only suffix rows,
so prefix KV memory is O(pool), not O(batch); n_past stays logical (the
slot's rows are n_past - prefix_len), and a request without a prefix runs
with prefix_len 0. It composes with an int8 slot cache and with
`lookup_gamma`, not with `paged`.

A tensor-parallel mesh (`mesh`, batching.py:168-216 there, tp only): every
rank of the mesh runs this same engine on its shard (`parallel.sharding`:
whole tp-packed params in, the shard kept; a cache of n_head / tp heads),
fed the same requests in the same order (`runtime/server.py` broadcasts
them), so the host logic decides the same on every rank. The forward's
all-gather gives every rank the same logits bits and the slots' generators
are seeded alike, so the sampled ids agree; each step checks it and raises
RuntimeError on every rank if a rank's ids differ from rank 0's. dp (slot
sharding), pp, and paged KV, the shared-prefix pool or lookup under a mesh
raise NotImplementedError (ROADMAP.md queue 1, item 6).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable

import numpy as np
import torch

from ..device import resolve
from ..models.llama import (
    KVCache,
    LlamaParams,
    ModelConfig,
    init_kv_cache,
    init_paged_kv_cache,
    llama_forward,
)
from ..parallel.comm import same_on_every_rank
from .engine import kv_dtype
from .graphs import StepGraph
from .paged import PageAllocator, SlotPages
from .sampling import SamplerParams, probs_batched_dyn, sample_tokens_batched
from .speculative import assemble_emitted, first_reject, lookup_draft_batched


@dataclass
class Request:
    prompt: list[int]
    n_predict: int
    sp: SamplerParams = SamplerParams()
    seed: int = 0
    ignore_eos: bool = False
    prefix: int = -1  # id from register_prefix: prompt continues that prefix
    # filled by the scheduler:
    rid: int = -1
    slot: int = -1
    generated: list[int] = field(default_factory=list)
    done: bool = False
    on_token: Callable[[int], None] | None = None

    @property
    def output(self) -> list[int]:
        return self.generated


@dataclass(frozen=True)
class BatchConfig:
    max_batch: int = 8
    n_ctx: int = 512  # per-slot KV region length
    block: int = 8  # decode steps per host round-trip
    top_k: int = 64  # shared sampler pool (the per-request top_k is not read)
    repeat_last_n: int = 64
    kv_dtype: str = "bfloat16"  # or "int8", or "float32" (not paged)
    admit_chunk: int = 4  # max requests per batched admission prefill
    paged: bool = False  # block-table paged KV (runtime/paged.py)
    page_size: int = 128  # pool page rows: a power of two dividing n_ctx
    n_pages: int = 0  # pool pages; 0 -> max_batch * n_ctx / page_size + 1
    # cap on the attention kernels' KV block (0: the fitted default). It pins
    # the online-softmax accumulation order: a flat engine at kv_block=c sums
    # like a paged one at page_size=c
    kv_block: int = 0
    # > 0: prompt-lookup speculative decoding, gamma rows verified per round
    lookup_gamma: int = 0
    # registered prefixes live in ONE read-only bf16 pool that every slot
    # attends before its own rows; slots hold only suffix rows
    shared_prefix: bool = False
    prefix_pool: int = 4  # shared-prefix pool entries
    prefix_ctx: int = 256  # pool entry rows (positions; a multiple of 256)


@dataclass
class _BatchDecode:
    """The static buffers of the batched decode step, and its captured
    graph once there is one."""

    cur: torch.Tensor  # int64 [B]: each slot's token to evaluate
    last: torch.Tensor  # int64 [B, W]: the repeat windows
    npast: torch.Tensor  # int32 [B]: the positions
    out: torch.Tensor  # int64 [B, block]: the block's sampled tokens
    step: torch.Tensor  # int64 [1]: the column of `out` the step writes
    noise: torch.Tensor  # f32 [B, k]: the step's Exp(1) draws, a row per slot
    top_p: torch.Tensor  # f32 [B] each: the block's per-slot sampler parameters
    temp: torch.Tensor
    penalty: torch.Tensor
    graph: StepGraph | None = None


def _rows(plane: torch.Tensor, batch, n: int) -> torch.Tensor:
    """View of cache positions [0, n) of batch row(s) `batch` of one cache
    plane: data [L, B, H, S, D] keeps positions on axis 3, scales
    [L, B, S, H] on axis 2."""
    if plane.dim() == 5:
        return plane[:, batch, :, :n]
    return plane[:, batch, :n]


def _bucket(n: int, cap: int, floor: int = 8) -> int:
    """The power of two >= n (at least `floor`), capped at `cap`."""
    b = floor
    while b < n:
        b *= 2
    return min(b, cap)


class BatchedEngine:
    """Continuous-batching decode engine over one model replica on one
    device, or this rank's part of a tensor-parallel replica (`mesh`; the
    device is then the mesh's). The cache is updated in place."""

    def __init__(self, cfg: ModelConfig, params: LlamaParams,
                 bcfg: BatchConfig = BatchConfig(), mesh=None, device="cuda"):
        self.mesh = mesh
        self._tp_axis = None
        self._heads = cfg.n_head
        if mesh is not None:
            params = self._mesh_params(cfg, params, bcfg, mesh)
            device = mesh.device
        self.device = resolve(device)
        if bcfg.shared_prefix and bcfg.paged:
            raise ValueError("paged KV excludes shared_prefix (the block table IS the "
                             "sharing mechanism)")
        if bcfg.shared_prefix and bcfg.prefix_ctx % 256:
            raise ValueError(f"prefix_ctx {bcfg.prefix_ctx}: a multiple of 256")
        self.cfg = cfg
        self.params = params
        self.bcfg = bcfg
        self.kv_dtype = kv_dtype(bcfg.kv_dtype, bcfg.n_ctx)
        if self.kv_dtype == torch.float32 and bcfg.paged:
            # the JAX engine asserts bf16 or int8 pools (batching.py:180-183
            # there); its forward and kernels take an f32 pool, and so do the
            # port's
            raise NotImplementedError("BatchedEngine: paged KV takes bf16 or int8 pools, as the "
                                      "JAX engine asserts (batching.py:180-183 there)")
        b, w = bcfg.max_batch, bcfg.repeat_last_n
        self.pager: SlotPages | None = None
        if bcfg.paged:
            ps = bcfg.page_size
            if ps < 8 or ps & (ps - 1) or bcfg.n_ctx % ps:
                raise ValueError(f"page_size {ps}: a power of two >= 8 dividing n_ctx")
            n_pages = bcfg.n_pages or b * bcfg.n_ctx // ps + 1
            self.cache = init_paged_kv_cache(cfg, n_pages, ps, self.kv_dtype, self.device)
            alloc = PageAllocator(n_pages)
            # page 0 (the allocator's first) is the TRASH page: freed slots
            # keep decoding garbage until the block ends, and their zeroed
            # table rows must point at memory no live request owns
            alloc.alloc(1)
            self.pager = SlotPages(b, bcfg.n_ctx // ps, alloc)
            self._table_dev = self._dev(self.pager.table)
        else:
            self.cache = self._new_cache(b, bcfg.n_ctx)
        self.n_past = np.zeros(b, np.int32)
        self.cur_tok = np.zeros(b, np.int64)
        self.last_window = np.full((b, w), -1, np.int64)
        self.top_p = np.ones(b, np.float32)
        self.temp = np.zeros(b, np.float32)
        self.penalty = np.ones(b, np.float32)
        # one generator per slot for the engine's life (the decode graph
        # draws from each), reseeded in place at admission; `gens` names a
        # sampled slot's, for the admission sample and the lookup rounds
        self._slot_gens = [torch.Generator(device=self.device) for _ in range(b)]
        self.gens: list[torch.Generator | None] = [None] * b  # sampled slots only
        self.slots: list[Request | None] = [None] * b
        self.queue: list[Request] = []
        self._rid = 0
        # id -> (cache1, length, tokens); paged: (shared full pages, length, tokens)
        self.prefixes: dict[int, tuple] = {}
        self._pid = 0
        self._pending_admits: list[tuple] = []  # (chunk requests, device ids [n])
        self._host_ids: list[int] = []  # first tokens brought to the host this step
        self._done_waiting: list[Request] = []  # preempted ones that their first token finished
        self.stats = {
            "tokens": 0, "steps": 0, "t_decode": 0.0, "prefills": 0, "prefill_calls": 0,
            "preempted": 0,
        }
        if self.pager is not None:
            self.stats["pages_peak"] = 1  # the most pages in use at a block's start
        self.shared = bcfg.shared_prefix
        if self.shared:
            # the pool is bf16 whatever the slot cache holds: one copy serves
            # every slot (batching.py:671-690 there)
            pool = (cfg.n_layer, bcfg.prefix_pool, cfg.n_head, bcfg.prefix_ctx, cfg.head_dim)
            self.pfx_k = torch.zeros(pool, dtype=torch.bfloat16, device=self.device)
            self.pfx_v = torch.zeros(pool, dtype=torch.bfloat16, device=self.device)
            self.pfx_len = np.zeros(b, np.int32)  # each slot's pool rows
            self.pfx_id = np.zeros(b, np.int32)  # and their entry
            # their device copies, the decode operands, loaded once a block
            self._pfx_len_dev = torch.zeros(b, dtype=torch.int32, device=self.device)
            self._pfx_id_dev = torch.zeros(b, dtype=torch.int32, device=self.device)
        # the lookup history spans logical positions: prefix + suffix when
        # the prefix lives in the pool
        self._ctx_len = bcfg.n_ctx + (bcfg.prefix_ctx if self.shared else 0)
        if bcfg.lookup_gamma > 0:
            # each row's token history at logical positions, read by the
            # lookup drafter on the device
            self.ctx_dev = torch.zeros((b, self._ctx_len), dtype=torch.int64, device=self.device)
            self.stats.update(rounds=0, accepted=0)
            if self.pager is not None:
                self.stats["straddled"] = 0  # verify writes that crossed a page
        self._decode: _BatchDecode | None = None

    def _mesh_params(self, cfg, params, bcfg, mesh) -> LlamaParams:
        """The checks of a mesh engine (batching.py:186-205 there) and this
        rank's shard of the whole tp-packed params."""
        from ..parallel.sharding import shard_params

        if mesh.shape["dp"] > 1 or mesh.shape["pp"] > 1:
            raise NotImplementedError("BatchedEngine: dp (slot sharding) and pp meshes are not "
                                      "ported yet (ROADMAP.md queue 1, item 6)")
        if bcfg.paged or bcfg.shared_prefix or bcfg.lookup_gamma > 0:
            raise NotImplementedError("BatchedEngine: paged KV, the shared-prefix pool and "
                                      "lookup under a mesh are not ported yet (ROADMAP.md "
                                      "queue 1, item 6)")
        tp = mesh.shape["tp"]
        if cfg.n_head % tp:
            raise ValueError(f"n_head {cfg.n_head} does not split over tp = {tp}")
        if tp > 1:
            self._tp_axis = mesh.axis("tp")
        self._heads = cfg.n_head // tp
        return shard_params(params, mesh)

    # --- helpers -------------------------------------------------------------

    def _fwd(self, tokens, cache, n_past, **kw):
        return llama_forward(self.params, tokens, cache, n_past, self.cfg,
                             kv_block=self.bcfg.kv_block or None, tp_axis=self._tp_axis, **kw)

    def _new_cache(self, batch: int, rows: int, dtype=None) -> KVCache:
        """A zeroed flat cache of this engine's heads (n_head / tp)."""
        return init_kv_cache(self.cfg, batch, rows, dtype or self.kv_dtype, self.device,
                             n_head_local=self._heads)

    def _dev(self, a, dtype=None) -> torch.Tensor:
        return torch.as_tensor(a, dtype=dtype).to(self.device)

    def _pfx_kw(self, ids=None, lens=None) -> dict:
        """The prefix-pool operands of a forward whose rows continue pool
        entries `ids` over `lens` rows (default: every slot's), or {}
        without the pool."""
        if not self.shared:
            return {}
        if ids is None:  # the block's operands (`_load_block`)
            return dict(prefix_kv=(self.pfx_k, self.pfx_v), prefix_id=self._pfx_id_dev,
                        prefix_len=self._pfx_len_dev)
        return dict(prefix_kv=(self.pfx_k, self.pfx_v), prefix_id=self._dev(ids, torch.int32),
                    prefix_len=self._dev(lens, torch.int32))

    def _free(self, slot: int) -> None:
        """A finished slot's per-slot state back to idle."""
        self.slots[slot] = None
        self.n_past[slot] = 0
        self.gens[slot] = None
        if self.pager is not None:
            self.pager.free_slot(slot)
        if self.shared:
            self.pfx_len[slot] = 0
            self.pfx_id[slot] = 0

    def _noise(self, slots) -> torch.Tensor:
        """[len(slots), k] Exp(1) draws: one row from each sampled slot's own
        generator, ones for greedy and free slots (their rows are unused)."""
        k = min(self.bcfg.top_k, self.cfg.n_vocab) if self.bcfg.top_k > 0 else self.cfg.n_vocab
        noise = torch.ones((len(slots), k), dtype=torch.float32, device=self.device)
        for i, s in enumerate(slots):
            if self.gens[s] is not None:
                noise[i].exponential_(generator=self.gens[s])
        return noise

    def _sample(self, logits, last, slots) -> torch.Tensor:
        rows = np.asarray(slots)
        return sample_tokens_batched(
            logits, last, self._noise(slots), self.bcfg.top_k,
            self._dev(self.top_p[rows]), self._dev(self.temp[rows]),
            self._dev(self.penalty[rows]),
        )

    # --- public API ----------------------------------------------------------

    def _set_slot(self, slot: int, req: Request, hist: list[int], n_past: int) -> None:
        """A request's per-slot sampler state at admission: its repeat
        window, top_p, temperature, penalty, position and generator."""
        self.last_window[slot] = -1
        hist = hist[-self.bcfg.repeat_last_n:]
        if hist:
            self.last_window[slot, -len(hist):] = hist
        self.top_p[slot] = req.sp.top_p
        self.temp[slot] = req.sp.temp
        self.penalty[slot] = req.sp.repeat_penalty
        self.n_past[slot] = n_past
        gen = self._slot_gens[slot].manual_seed(req.seed)  # in place: the graph holds it
        self.gens[slot] = gen if req.sp.temp > 0 else None

    def register_prefix(self, tokens: list[int]) -> int:
        """Prefill a shared prompt prefix (e.g. a system prompt) ONCE and
        return its id. Requests submitted with prefix=id prefill only their
        suffix: the prefix K/V rows are copied into the slot at admission
        (prefix caching, batching.py:988-1012 there). Paged: the prefix's
        full pages are shared by the slots' tables instead (`_register_paged`)."""
        plen = len(tokens)
        if self.shared:
            return self._register_shared(tokens)
        if not 0 < plen < self.bcfg.n_ctx:
            raise ValueError("prefix length out of range")
        if self.pager is not None:
            return self._register_paged(tokens)
        bucket = _bucket(plen, self.bcfg.n_ctx)
        padded = np.zeros((1, bucket), np.int64)
        padded[0, :plen] = tokens
        cache1 = self._new_cache(1, self.bcfg.n_ctx)
        self._fwd(self._dev(padded), cache1, 0, last_idx=self._dev([plen - 1]))
        pid = self._pid
        self._pid += 1
        self.prefixes[pid] = (cache1, plen, list(tokens))
        return pid

    def submit(self, prompt: list[int], n_predict: int,
               sp: SamplerParams = SamplerParams(), seed: int = 0,
               ignore_eos: bool = False,
               on_token: Callable[[int], None] | None = None,
               prefix: int = -1) -> Request:
        if prefix >= 0 and prefix not in self.prefixes:
            raise ValueError(f"unknown prefix id {prefix}")
        total = len(prompt) + (self.prefixes[prefix][1] if prefix >= 0 else 0)
        if self.shared:
            total = len(prompt)  # the slot holds only the suffix
        # lookup rounds write gamma-row windows: gamma - 1 rows of slack
        slack = max(self.bcfg.lookup_gamma - 1, 0)
        if total + n_predict + slack > self.bcfg.n_ctx:
            raise ValueError(f"request exceeds n_ctx (with {slack} rows of lookup slack)")
        if len(prompt) < 1:
            raise ValueError("prompt suffix must be non-empty")
        req = Request(prompt=list(prompt), n_predict=n_predict, sp=sp, seed=seed,
                      ignore_eos=ignore_eos, rid=self._rid, on_token=on_token,
                      prefix=prefix)
        self._rid += 1
        self.queue.append(req)
        return req

    def _register_shared(self, tokens: list[int]) -> int:
        """Shared pool (batching.py:962-986 there): prefill the prefix into a
        one-row bf16 cache of prefix_ctx rows and copy it into the next pool
        entry (`_pool_write`)."""
        plen = len(tokens)
        if not 0 < plen <= self.bcfg.prefix_ctx:
            raise ValueError("prefix exceeds pool ctx")
        pid = self._pid
        if pid >= self.bcfg.prefix_pool:
            raise ValueError("prefix pool full")
        bucket = _bucket(plen, self.bcfg.prefix_ctx)
        padded = np.zeros((1, bucket), np.int64)
        padded[0, :plen] = tokens
        cache1 = init_kv_cache(self.cfg, 1, self.bcfg.prefix_ctx, torch.bfloat16, self.device)
        self._fwd(self._dev(padded), cache1, 0, last_idx=self._dev([plen - 1]))
        self._pool_write(cache1, pid)
        self._pid += 1
        self.prefixes[pid] = (None, plen, list(tokens))
        return pid

    def _pool_write(self, cache1: KVCache, pid: int) -> None:
        """Pool entry `pid` = the one-row cache's rows (batching.py:802-812
        there)."""
        self.pfx_k[:, pid] = cache1.k[:, 0]
        self.pfx_v[:, pid] = cache1.v[:, 0]

    def _register_paged(self, tokens: list[int]) -> int:
        """Paged prefix (batching.py:930-961 there): its FULL pages are
        prefilled straight into the pool, in decreasing power-of-two chunks
        (each starts at a multiple of its length, so its writes stay in
        pages), and shared read-only by every slot that continues it
        (refcounted); the sub-page remainder rides on each suffix."""
        ps = self.bcfg.page_size
        full = len(tokens) // ps
        pages = self.pager.alloc.alloc(full) if full else []
        if full:
            table = np.zeros((1, self.pager.table.shape[1]), np.int32)
            table[0, :full] = pages
            tdev = self._dev(table)
            body = np.asarray(tokens[: full * ps], np.int64)
            start = 0
            while start < full * ps:
                c = 1 << ((full * ps - start).bit_length() - 1)
                self._fwd(self._dev(body[None, start : start + c]), self.cache, start,
                          page_table=tdev)
                start += c
        pid = self._pid
        self._pid += 1
        self.prefixes[pid] = (pages, len(tokens), list(tokens))
        return pid

    def _admit(self) -> None:
        """Fill free slots from the queue, batching prefills.

        Admissions group by prompt bucket length and prefix, and run in
        power-of-two chunks capped by bcfg.admit_chunk: one batched prefill
        into a scratch cache of `scratch_len` rows, one in-place copy of each
        row into its slot, one batched first-token sample per chunk
        (batching.py:1174-1307 there). The sampled ids stay on the device."""
        if self.pager is not None:
            return self._admit_paged()
        free = [s for s in range(self.bcfg.max_batch) if self.slots[s] is None]
        admitted = []
        while free and self.queue:
            req = self.queue.pop(0)
            req.slot = free.pop(0)
            self.slots[req.slot] = req
            admitted.append(req)
        if not admitted:
            return
        groups: dict[tuple, list[Request]] = {}
        for req in admitted:
            key = (_bucket(len(req.prompt), self.bcfg.n_ctx), req.prefix)
            groups.setdefault(key, []).append(req)

        for (bucket, pfx), items in groups.items():
            pfx_cache, pfx_len, pfx_tokens = self.prefixes[pfx] if pfx >= 0 else (None, 0, [])
            # suffix writes live at [pfx_len, pfx_len + bucket): clamp the
            # padding so they cannot run past the slot region (shared: the
            # slot holds only the suffix, from row 0)
            rows0 = 0 if self.shared else pfx_len
            bucket = min(bucket, self.bcfg.n_ctx - rows0)
            # every admission copy is bounded to the rows the chunk touches:
            # the power of two >= rows0 + bucket (64 at least), not n_ctx.
            # Slot rows past it keep the previous occupant's stale K/V, which
            # no query reads before decode overwrites them.
            scratch_len = _bucket(rows0 + bucket, self.bcfg.n_ctx, floor=64)
            for chunk in self._chunks(items):
                n = len(chunk)
                toks = np.zeros((n, bucket), np.int64)
                last_idx = np.zeros(n, np.int64)
                for j, req in enumerate(chunk):
                    plen = len(req.prompt)
                    toks[j, :plen] = req.prompt
                    last_idx[j] = plen - 1
                    self._set_slot(req.slot, req, pfx_tokens + req.prompt, pfx_len + plen)
                    if self.shared:
                        self.pfx_len[req.slot] = pfx_len
                        self.pfx_id[req.slot] = max(pfx, 0)
                if pfx >= 0 and not self.shared:  # the prefix rows, copied into every chunk row
                    scratch = KVCache(*(
                        _rows(p, slice(None), scratch_len).expand(-1, n, *[-1] * (p.dim() - 2))
                        .clone() for p in pfx_cache.planes()))
                else:
                    scratch = self._new_cache(n, scratch_len)
                # shared (_admit_chunk_shared, batching.py:747-800 there): the
                # suffix attends the pool, its rows land at 0, n_past logical
                npast = self._dev([pfx_len] * n, torch.int32) if self.shared else pfx_len
                logits, _, _ = self._fwd(self._dev(toks), scratch, npast,
                                         last_idx=self._dev(last_idx),
                                         **self._pfx_kw([max(pfx, 0)] * n, [pfx_len] * n))
                for j, req in enumerate(chunk):
                    for dst, src in zip(self.cache.planes(), scratch.planes()):
                        _rows(dst, req.slot, scratch_len).copy_(src[:, j])
                self._sample_first(chunk, logits)
        self._seed_ctx(admitted)

    def _seed_ctx(self, admitted: list[Request]) -> None:
        """Write the admitted rows' consumed tokens (prefix, prompt and, for a
        re-admitted request, what it generated; the pending first token is
        not consumed yet) into the lookup history, one copy for the wave
        (batching.py:1151-1172, 1312-1324 there)."""
        if self.bcfg.lookup_gamma <= 0 or not admitted:
            return
        rows = np.zeros((len(admitted), self._ctx_len), np.int64)
        for j, req in enumerate(admitted):
            pfx_tokens = self.prefixes[req.prefix][2] if req.prefix >= 0 else []
            hist = (pfx_tokens + req.prompt + req.generated)[: self._ctx_len]
            rows[j, : len(hist)] = hist
        self.ctx_dev[self._dev([r.slot for r in admitted], torch.int64)] = self._dev(rows)

    def _chunks(self, items: list[Request]):
        """Power-of-two runs of `items`, each at most bcfg.admit_chunk long."""
        i = 0
        while i < len(items):
            n = 1 << max(0, (len(items) - i).bit_length() - 1)
            n = min(n, max(1, self.bcfg.admit_chunk))
            yield items[i : i + n]
            i += n

    def _sample_first(self, chunk: list[Request], logits) -> None:
        """Sample a chunk's first tokens on the device and keep them pending."""
        slots = [r.slot for r in chunk]
        ids = self._sample(logits[:, 0, :], self._dev(self.last_window[slots]), slots)
        self.stats["prefills"] += len(chunk)
        self.stats["prefill_calls"] += 1
        self._pending_admits.append((chunk, ids))

    def _paged_admit_info(self, req: Request):
        """(shared pages, page-aligned prefix rows, suffix tokens, bucket).
        The prefix's sub-page remainder rides prepended to the suffix, so
        admission writes start page-aligned; a preempted request's generated
        tokens re-enter the same way (batching.py:1039-1057 there)."""
        if req.prefix >= 0:
            pages, _, ptoks = self.prefixes[req.prefix]
            aligned = len(pages) * self.bcfg.page_size
            suffix = ptoks[aligned:] + req.prompt + req.generated
        else:
            pages, aligned = [], 0
            suffix = req.prompt + req.generated
        return pages, aligned, suffix, _bucket(len(suffix), self.bcfg.n_ctx - aligned)

    def _admit_paged(self) -> None:
        """Paged admission (batching.py:1059-1149 there): map each request's
        pages (a prefix's full pages shared by aliasing), then prefill each
        chunk STRAIGHT into its slots' pages through their table rows. A dry
        pool leaves the rest queued until decode frees pages."""
        free = [s for s in range(self.bcfg.max_batch) if self.slots[s] is None]
        admitted, infos = [], {}
        while free and self.queue:
            req = self.queue[0]
            info = self._paged_admit_info(req)
            pages, aligned, _, bucket = info
            slot = free[0]
            try:
                if pages:
                    self.pager.share(slot, pages)
                self.pager.ensure(slot, aligned + bucket, self.bcfg.page_size)
            except MemoryError:
                self.pager.free_slot(slot)
                break  # pool full: keep queueing; decode frees pages
            free.pop(0)
            self.queue.pop(0)
            req.slot = slot
            self.slots[slot] = req
            admitted.append(req)
            infos[req.rid] = info
        groups: dict[tuple, list[Request]] = {}
        for req in admitted:
            groups.setdefault((infos[req.rid][3], req.prefix), []).append(req)
        for (bucket, pfx), items in groups.items():
            pfx_tokens = self.prefixes[pfx][2] if pfx >= 0 else []
            aligned = infos[items[0].rid][1]
            for chunk in self._chunks(items):
                n = len(chunk)
                toks = np.zeros((n, bucket), np.int64)
                last_idx = np.zeros(n, np.int64)
                table = np.zeros((n, self.pager.table.shape[1]), np.int32)
                for j, req in enumerate(chunk):
                    suffix = infos[req.rid][2]
                    toks[j, : len(suffix)] = suffix
                    last_idx[j] = len(suffix) - 1
                    table[j] = self.pager.table[req.slot]
                    # a re-admitted request's generator restarts from its
                    # seed, as the JAX arm re-keys (:1124-1126 there)
                    self._set_slot(req.slot, req, pfx_tokens + req.prompt + req.generated,
                                   aligned + len(suffix))
                logits, _, _ = self._fwd(self._dev(toks), self.cache, aligned,
                                         last_idx=self._dev(last_idx), page_table=self._dev(table))
                self._sample_first(chunk, logits)
        self._seed_ctx(admitted)

    def _finish_admits(self) -> None:
        """Bring the deferred admission first tokens to the host (emitting them
        to streams) and mirror the device-side cur_tok/last_window updates
        into the host arrays. Called after the decode block is queued. A
        request preempted before its first block keeps its token, which
        re-enters its prefill on re-admission."""
        pending, self._pending_admits = self._pending_admits, []
        for chunk, ids in pending:
            ids = ids.cpu().numpy()
            if self.mesh is not None:
                self._host_ids.extend(int(i) for i in ids)
            for j, req in enumerate(chunk):
                tok = int(ids[j])
                slot = req.slot
                self._emit(req, tok)
                if slot < 0:  # preempted: back in the queue
                    if req.done:
                        self.queue.remove(req)
                        self._done_waiting.append(req)
                    continue
                self.cur_tok[slot] = tok
                self.last_window[slot] = np.roll(self.last_window[slot], -1)
                self.last_window[slot, -1] = tok

    def _block_inputs(self) -> _BatchDecode:
        """The block's operands loaded into the static buffers
        (`_decode_state`), one host-to-device copy each: the tokens and
        windows (the host arrays with the pending admission chunks' first
        tokens scattered in on the device, no host sync; _admit_merge of
        batching.py:649-660 there), the positions, the per-slot sampler
        parameters, the prefix operands, the step index 0. A request
        preempted since its admission (slot -1) is left out: index -1 would
        land on the last slot."""
        st = self._decode_state()
        if self.shared:
            self._pfx_id_dev.copy_(torch.from_numpy(self.pfx_id))
            self._pfx_len_dev.copy_(torch.from_numpy(self.pfx_len))
        for dst, src in ((st.cur, self.cur_tok), (st.last, self.last_window),
                         (st.npast, self.n_past), (st.top_p, self.top_p), (st.temp, self.temp),
                         (st.penalty, self.penalty)):
            dst.copy_(torch.from_numpy(src))
        st.step.zero_()
        for chunk, ids in self._pending_admits:
            keep = [j for j, r in enumerate(chunk) if r.slot >= 0]
            if len(keep) < len(chunk):
                ids = ids[self._dev(keep, torch.int64)]
            rows = self._dev([chunk[j].slot for j in keep], torch.int64)
            st.cur[rows] = ids
            st.last[rows] = torch.cat([st.last[rows, 1:], ids[:, None]], dim=1)
        return st

    def _emit(self, req: Request, tok: int) -> None:
        req.generated.append(tok)
        if req.on_token is not None:
            req.on_token(tok)
        if len(req.generated) >= req.n_predict or (not req.ignore_eos and tok == 2):
            req.done = True

    def _decode_state(self) -> _BatchDecode:
        """The decode step's static buffers, made at first use."""
        if self._decode is None:
            b, w = self.bcfg.max_batch, self.bcfg.repeat_last_n
            k = min(self.bcfg.top_k, self.cfg.n_vocab) if self.bcfg.top_k > 0 else self.cfg.n_vocab

            def buf(*shape, dtype=torch.int64):
                return torch.zeros(shape, dtype=dtype, device=self.device)

            f32 = torch.float32
            self._decode = _BatchDecode(buf(b), buf(b, w), buf(b, dtype=torch.int32),
                                        buf(b, self.bcfg.block), buf(1), buf(b, k, dtype=f32),
                                        buf(b, dtype=f32), buf(b, dtype=f32), buf(b, dtype=f32))
        return self._decode

    def _step(self, st: _BatchDecode, gens) -> None:
        """One batched decode step on the static buffers: the forward of
        st.cur at st.npast, one row of noise from each slot's generator in
        `gens`, the sample, and every buffer advanced in place."""
        kw = {} if self.pager is None else dict(page_table=self._table_dev)
        logits, _, _ = self._fwd(st.cur[:, None], self.cache, st.npast, **kw, **self._pfx_kw())
        for s, gen in enumerate(gens):
            st.noise[s].exponential_(generator=gen)
        tok = sample_tokens_batched(logits[:, -1, :], st.last, st.noise, self.bcfg.top_k,
                                    st.top_p, st.temp, st.penalty)
        st.last.copy_(torch.cat([st.last[:, 1:], tok[:, None]], dim=1))
        st.out.index_copy_(1, st.step, tok[:, None])
        st.cur.copy_(tok)
        st.npast.add_(1)
        st.step.add_(1)

    def _run_uncaptured(self, st: _BatchDecode, n_steps: int) -> None:
        """The block's steps run one by one: the CPU's and a mesh's decode
        path, and the plain version a graph's replays are held against on
        the card."""
        for _ in range(n_steps):
            self._step(st, self._slot_gens)

    def _run_block(self, st: _BatchDecode, n_steps: int) -> None:
        """The block's steps: replays of the step's CUDA graph on one CUDA
        device (captured at first use), uncaptured on the CPU and under a
        mesh."""
        if self.device.type != "cuda" or self.mesh is not None:
            return self._run_uncaptured(st, n_steps)
        if st.graph is None:
            st.graph = StepGraph(lambda gens: self._step(st, gens),
                                 [st.cur, st.last, st.npast, st.step], self._slot_gens,
                                 self.device)
        for _ in range(n_steps):
            st.graph.replay()

    def _decode_block(self, n_steps: int):
        """n_steps batched forward + sample steps from the block's inputs
        (`_block_inputs`); tokens stay on the device. Returns ([B, n_steps]
        tokens, the final [B, W] windows), views of the static buffers."""
        st = self._block_inputs()
        self._run_block(st, n_steps)
        return st.out[:, :n_steps], st.last

    def graph_stats(self) -> dict:
        """The captured decode graph: its capture seconds, the bytes its
        private pool reserved, its replays (zeros before a capture)."""
        g = self._decode.graph if self._decode is not None else None
        return {"graphs": int(g is not None), "capture_s": g.capture_s if g else 0.0,
                "pool_bytes": g.pool_bytes if g else 0, "replays": g.replays if g else 0}

    def _check_ranks(self, toks: np.ndarray) -> None:
        """Under a mesh, every rank's step ids (the block's tokens and the
        first tokens of this step's admissions) must equal rank 0's: raises
        RuntimeError on every rank where one differs."""
        ids, self._host_ids = self._host_ids, []
        if self.mesh is not None and self.mesh.size > 1:
            same_on_every_rank(np.concatenate([toks.ravel(), np.asarray(ids, np.int64)]),
                               self.mesh.control, "sampled token ids")

    def _preempt(self, slot: int) -> None:
        """Release `slot`'s pages and return its request to the queue head
        (batching.py:1458-1469 there). Its generated tokens re-enter the
        admission prefill as prompt suffix; emitted tokens are never
        rolled back."""
        req = self.slots[slot]
        self.slots[slot] = None
        self.pager.free_slot(slot)
        self.n_past[slot] = 0
        self.gens[slot] = None
        req.slot = -1
        self.queue.insert(0, req)
        self.stats["preempted"] += 1

    def _ensure_block_pages(self, n_steps: int, rows_per_step: int = 1) -> None:
        """Map every live slot's write pages for the coming block up front
        (n_steps * rows_per_step rows past its n_past: a lookup round writes
        gamma rows), preempting the youngest request when the pool runs dry,
        then copy the table to the device if it changed: at most one copy
        per block, and none inside it (batching.py:1471-1505 there)."""
        ps = self.bcfg.page_size
        for slot in range(self.bcfg.max_batch):
            while self.slots[slot] is not None:
                try:
                    self.pager.ensure(
                        slot, min(self.bcfg.n_ctx,
                                  int(self.n_past[slot]) + n_steps * rows_per_step), ps)
                    break
                except MemoryError:
                    victims = [s for s in range(self.bcfg.max_batch) if self.slots[s] is not None]
                    if victims == [slot]:
                        raise MemoryError("KV page pool too small for one request; "
                                          "increase BatchConfig.n_pages") from None
                    # if `slot` itself is the youngest, its zeroed table row
                    # points at the trash page until re-admission
                    self._preempt(max(victims, key=lambda s: self.slots[s].rid))
        alloc = self.pager.alloc
        self.stats["pages_peak"] = max(self.stats["pages_peak"], alloc.n_pages - alloc.n_free)
        if self.pager.dirty:  # into the one table the decode graph reads
            self._table_dev.copy_(torch.from_numpy(self.pager.table))
            self.pager.dirty = False

    def step(self) -> list[Request]:
        """Admit queued requests, run one decode block, return finished ones.

        Power-of-two blocks, clamped by the room left in the fullest slot's
        context (batching.py:1363-1456 there). A request that finishes
        mid-block frees its slot (and its pages); its extra KV writes sit
        beyond the slot's n_past and are never attended."""
        self._admit()
        if not any(s is not None for s in self.slots):
            return []
        # the slots' cache rows: n_past, less the pool rows when shared
        local = self.n_past - self.pfx_len if self.shared else self.n_past
        room = self.bcfg.n_ctx - 1 - int(local.max())
        if self.bcfg.lookup_gamma > 0:
            return self._step_lookup(room, self.bcfg.lookup_gamma)
        n_steps = min(self.bcfg.block, max(1, room))
        n_steps = 1 << (n_steps.bit_length() - 1)  # snap down to a power of 2
        if self.pager is not None:
            self._ensure_block_pages(n_steps)
        t0 = time.perf_counter()
        toks, last = self._decode_block(n_steps)
        self._finish_admits()  # the block is queued on the device already
        toks = toks.cpu().numpy()  # [B, n_steps]: the block's one host read
        self._check_ranks(toks)
        self.last_window = last.cpu().numpy()
        self.stats["t_decode"] += time.perf_counter() - t0
        self.stats["steps"] += n_steps

        finished, self._done_waiting = self._done_waiting, []
        for slot, req in enumerate(self.slots):
            if req is None:
                continue
            consumed = 0
            for t in toks[slot]:
                consumed += 1
                if req.done:
                    break
                self._emit(req, int(t))
                self.stats["tokens"] += 1
                if req.done:
                    break
            self.n_past[slot] += consumed
            self.cur_tok[slot] = toks[slot][consumed - 1]
            if req.done:
                finished.append(req)
                self._free(slot)
        return finished

    # --- lookup speculation ---------------------------------------------------

    def _round_draws(self, g: int) -> tuple[torch.Tensor, torch.Tensor]:
        """One sampled lookup round's draws: uniforms [B, g-1] for the accept
        tests and Exp(1) noise [B, V] for the correction, each sampled row's
        from its own generator; greedy and free rows take 0.5 and 1, which
        their point-mass distributions make irrelevant."""
        b, v = self.bcfg.max_batch, self.cfg.n_vocab
        us = torch.full((b, g - 1), 0.5, dtype=torch.float32, device=self.device)
        noise = torch.ones((b, v), dtype=torch.float32, device=self.device)
        for s in range(b):
            if self.gens[s] is not None:
                us[s].uniform_(generator=self.gens[s])
                noise[s].exponential_(generator=self.gens[s])
        return us, noise.clamp_min(1e-30)

    def _lookup_round(self, cur, last, npast, g: int, params):
        """One batched lookup round over every slot (the body of
        `_decode_lookup`, or with the per-slot sampler `params` (top_p, temp,
        penalty) of `_decode_lookup_sampled`, batching.py:455-640 there).
        Returns (emitted [B, g], count [B], next tokens, n_past, windows)."""
        kw = {} if self.pager is None else dict(page_table=self._table_dev, page_straddle=True)
        kw.update(self._pfx_kw())
        seq, draft, p = lookup_draft_batched(self.ctx_dev, cur, npast, g)
        logits, _, _ = self._fwd(seq, self.cache, npast, logits_all=True, **kw)  # [B, g, V]
        if params is None:
            y = torch.argmax(logits, dim=-1)
            k = first_reject(draft == y[:, : g - 1])
            corr = y.gather(1, torch.clamp(k, max=g - 1)[:, None])[:, 0]
        else:
            # the penalty window of verify position i: the known inputs
            # seq[:, 1 : i + 1] appended to the round's window
            w = last.shape[1]
            pt_all = torch.stack([
                probs_batched_dyn(logits[:, i], torch.cat([last, seq[:, 1 : i + 1]], 1)[:, -w:],
                                  self.bcfg.top_k, *params)
                for i in range(g)], dim=1)  # [B, g, V]
            us, noise = self._round_draws(g)
            safe = torch.clamp(draft, min=0)
            pt_draft = pt_all[:, : g - 1].gather(2, safe[:, :, None])[..., 0]
            k = first_reject((us < pt_draft) & (draft >= 0))
            pt_k = pt_all.gather(1, k[:, None, None].expand(-1, 1, pt_all.shape[2]))[:, 0]
            # the residual: p_t with the rejected draft removed (a no-match
            # round and the bonus keep p_t)
            rej = torch.cat([safe, torch.zeros_like(safe[:, :1])], 1).gather(
                1, torch.clamp(k, max=g - 1)[:, None])
            drop = ((k < g - 1) & (p >= 0))[:, None]
            resid = pt_k.scatter(1, rej, torch.where(drop, 0.0, pt_k.gather(1, rej)))
            corr = torch.argmax(resid / noise, dim=-1)
        emitted, count = assemble_emitted(k, draft, corr, g)
        # the consumed inputs at their positions: seq[:, :count] valid, the
        # rest junk the next round overwrites (the slack keeps it in bounds)
        pos = npast.to(torch.int64)[:, None] + torch.arange(g, device=self.device)
        self.ctx_dev.scatter_(1, pos, seq)
        if params is not None:
            w = last.shape[1]
            last = torch.cat([last, emitted], 1).gather(
                1, count[:, None] + torch.arange(w, device=self.device))
        return emitted, count, corr, npast + count.to(torch.int32), last

    def _step_lookup(self, room: int, g: int) -> list[Request]:
        """One lookup block: n_steps rounds, each emitting 1..g tokens per row
        (batching.py:1559-1657 there). The submit-time slack and the room
        clamp keep every round's g-row write inside the slot's n_ctx; paged,
        the block's pages are mapped up front, n_steps * g rows per slot."""
        n_steps = min(self.bcfg.block, max(1, room // g))
        n_steps = 1 << (n_steps.bit_length() - 1)
        if self.pager is not None:
            self._ensure_block_pages(n_steps, g)
        sampled = any(req is not None and req.sp.temp > 0 for req in self.slots)
        t0 = time.perf_counter()
        st = self._block_inputs()
        cur, last, npast = st.cur, st.last, st.npast
        params = (st.top_p, st.temp, st.penalty) if sampled else None
        ems, cnts = [], []
        for _ in range(n_steps):
            emitted, count, cur, npast, last = self._lookup_round(cur, last, npast, g, params)
            ems.append(emitted)
            cnts.append(count)
        self._finish_admits()  # the rounds are queued on the device already
        em = torch.stack(ems).cpu().numpy()  # [n_steps, B, g]: the block's host read
        cnt = torch.stack(cnts).cpu().numpy()  # [n_steps, B]
        toks, npast_h = cur.cpu().numpy(), npast.cpu().numpy()
        if sampled:
            self.last_window = last.cpu().numpy()
        self.stats["t_decode"] += time.perf_counter() - t0
        self.stats["steps"] += n_steps

        finished, self._done_waiting = self._done_waiting, []
        ps = self.bcfg.page_size
        for slot, req in enumerate(self.slots):
            if req is None:
                continue
            row = int(self.n_past[slot])  # the round's verify write starts here
            for i in range(n_steps):
                if req.done:
                    break  # rounds past `done` count toward nothing
                c = int(cnt[i, slot])
                self.stats["rounds"] += 1
                self.stats["accepted"] += c - 1
                if self.pager is not None and row // ps != (row + g - 1) // ps:
                    self.stats["straddled"] += 1
                row += c
                for t in em[i, slot, :c]:
                    if req.done:
                        break
                    self._emit(req, int(t))
                    self.stats["tokens"] += 1
            # the device ran every round: mirror its n_past and pending token
            # (rounds past `done` wrote rows the next occupant overwrites)
            self.n_past[slot] = npast_h[slot]
            self.cur_tok[slot] = toks[slot]
            if req.done:
                finished.append(req)
                self._free(slot)
        return finished

    def run(self) -> list[Request]:
        """Drain the queue; returns all finished requests."""
        done: list[Request] = []
        while self.queue or any(s is not None for s in self.slots):
            done.extend(self.step())
        return done
