#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`llamavk_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py                 # every phase, as a check of the card
    python3 chip_smoke.py --phases env,build,kernels --out report.json

Phases, each printing one JSON line (any failure exits non-zero):

  env         versions, nvcc, triton, the card's name and power limit
  build       nvcc builds `llamavk_tpu_torch/csrc/*.cu` for sm_90a
  kernels     each hand-written kernel against its plain PyTorch version on
              the card at the LLaMA-7B shapes of the main path: error, time
              (CUDA events, median, L2 flushed between launches), bound, and
              one PyTorch call computing the same function as a yardstick;
              then correctness alone at row counts, group counts, ragged
              widths and head sizes off those shapes
  tiny_cli    the generate CLI on a tiny GGJT file, greedy, on the card and
              on the CPU: the two token streams must be equal
  generate_7b synthetic LLaMA-7B Q4_0 weights, n_ctx 512, bf16 KV: kernel and
              plain forward passes agree on the main path's routes and
              shapes; then the main path (a 32-token prompt generating 128
              tokens, and a 300-token follow-up turn that reaches the
              read-only attention) with launch counts and the device's idle
              share

The line before the last is `{"kernels": [...]}`; the last line is
`{"ok": true, "device": {...}}`. Without CUDA the script exits 2 and prints
no result.
"""

from __future__ import annotations

import argparse
import io
import json
import math
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
# published peaks of one H100 SXM (NVIDIA's data sheet, dense, at 700 W)
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12

# 7B matmul shapes (K, N) of the main path and their calls per forward
K1_SHAPES = {
    "wqkv": (4096, 12288),
    "wo": (4096, 4096),
    "w13": (4096, 22016),
    "w2": (11008, 4096),
    "output": (4096, 32000),
}
N_CTX = 512
H, D = 32, 128

KERNEL_META = {
    "q4_gemv": ("llamavk_tpu_torch/csrc/q4_matmul.cu", "llamavk_tpu/ops/q4_matmul.py:96"),
    "q4_gemm": ("llamavk_tpu_torch/csrc/q4_matmul.cu", "llamavk_tpu/ops/q4_matmul.py:96"),
    "attn_update": ("llamavk_tpu_torch/csrc/flash_attn.cu", "llamavk_tpu/ops/flash_attn.py:120"),
    "attn_read": ("llamavk_tpu_torch/csrc/flash_attn.cu", "llamavk_tpu/ops/flash_attn.py:474"),
}

# the tiny model's prompt for the CLI phase: its greedy stream keeps every
# top-2 logit gap above 0.19 for 16 steps (on the CPU), far above the
# kernels' drift from the plain versions
TINY_PROMPT = "<t148><t159><t106><t66><t132><t104>"


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


# ------------------------------------------------------------------ timing


class Timer:
    """Median device time of a call: CUDA events around each launch, and a
    write of 2x the L2 cache between launches so every call finds its
    inputs in device memory, as the main path does (each layer's weights
    and cache rows are read once per step)."""

    def __init__(self, reps: int):
        self.reps = reps
        self.flush = torch.empty(100 * 2**20, dtype=torch.uint8, device="cuda")

    def __call__(self, fn, reps: int | None = None) -> float:
        fn()  # warm-up
        times = []
        for _ in range(reps or self.reps):
            self.flush.zero_()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        return statistics.median(times)


def bound(n_bytes: float, n_flops: float) -> tuple[float, str]:
    """The least time on the card (ms) and what sets it."""
    tb = n_bytes / HBM_BYTES_PER_S * 1e3
    tf = n_flops / BF16_FLOP_PER_S * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


# ------------------------------------------------------------------ phases


def phase_env() -> dict:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from llamavk_tpu_torch.ops import _build

    nvcc = subprocess.run([_build.nvcc_path(), "--version"], capture_output=True, text=True,
                          check=True).stdout
    release = next((ln.strip() for ln in nvcc.splitlines() if "release" in ln), nvcc.strip())
    try:
        import triton  # noqa: F401

        has_triton = True
    except ImportError:
        has_triton = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    return {
        "torch": torch.__version__, "cuda": torch.version.cuda, "nvcc": release,
        "triton": has_triton, "python": sys.version.split()[0],
        "device": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
        "nvidia_smi": smi,
    }


def phase_build() -> dict:
    from llamavk_tpu_torch.ops import _build

    t0 = time.perf_counter()
    logs = _build.build_all()
    secs = time.perf_counter() - t0
    # ptxas resource lines: registers, spills, shared memory per kernel
    usage = [ln.strip() for log in logs.values() for ln in log.splitlines()
             if "registers" in ln or "spill" in ln]
    return {"seconds": round(secs, 2), "sources": sorted(logs), "ptxas": usage}


def _q4_case(gen, m: int, k: int, n: int):
    from llamavk_tpu_torch.ops.qweight import QWeight

    packed = torch.randint(-128, 128, (k // 2, n), dtype=torch.int8, device="cuda", generator=gen)
    scales = torch.empty((k // 32, n), device="cuda").uniform_(0.005, 0.02, generator=gen)
    x = torch.randn((m, k), device="cuda", generator=gen).to(torch.bfloat16)
    return x, QWeight(packed=packed, scales=scales.to(torch.bfloat16))


def kernel_q4(timer: Timer, gen, name: str, m: int, main_path: bool) -> dict:
    from llamavk_tpu_torch.ops import q4_matmul as q4
    from llamavk_tpu_torch.ops.qweight import dequantize_qweight

    k, n = K1_SHAPES[name]
    x, qw = _q4_case(gen, m, k, n)
    got = q4.q4_matmul_cuda(x, qw.packed, qw.scales)
    want = q4.q4_matmul_ref(x, qw, out_dtype=torch.float32)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    # both sum the same bf16 products in f32, in different orders: each sum
    # is within (K-1) u sum_k |x_k w_kn| of the exact one (u = 2^-24)
    w_bf16 = dequantize_qweight(qw).to(torch.bfloat16)
    mag = float((x.float().abs() @ w_bf16.float().abs()).max())
    limit = 2 * k * 2.0**-24 * mag
    ms = timer(lambda: q4.q4_matmul_cuda(x, qw.packed, qw.scales))
    plain_ms = timer(lambda: q4.q4_matmul_ref(x, qw, out_dtype=torch.float32), reps=5)
    library_ms = timer(lambda: torch.matmul(x, w_bf16))
    n_bytes = m * k * 2 + k // 2 * n + k // 32 * n * 2 + m * n * 4
    b_ms, b_by = bound(n_bytes, 2.0 * m * k * n)
    return {
        "kernel": "q4_gemv" if m == 1 else "q4_gemm", "shape": f"{name} M={m} K={k} N={n}",
        "main_path": main_path,
        "max_abs_err": err, "limit": limit, "err_over_limit": err / limit, "ok": err <= limit,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": library_ms,
    }


def _sdpa(q, k, v, n_past: int, layer: int):
    """One PyTorch call for the same attention: the cache's visible rows,
    an explicit causal mask offset by n_past."""
    t = q.shape[1]
    kv = n_past + t
    qh = q.transpose(1, 2)  # [B, H, T, D]
    mask = (torch.arange(kv, device=q.device)[None, :]
            <= n_past + torch.arange(t, device=q.device)[:, None])
    return torch.nn.functional.scaled_dot_product_attention(
        qh, k[layer, :, :, :kv], v[layer, :, :, :kv], attn_mask=mask
    )


def _attn_sizes(t: int, n_past: int, update: bool) -> tuple[float, float]:
    """Bytes and operations one call needs: q read, the f32 output written,
    QK and PV over each query's visible keys. The update function reads the
    n_past earlier K/V rows from the cache and the T new ones from
    k_new/v_new, and writes the new ones to the cache; the read function
    reads all n_past + T rows from the cache."""
    visible = sum(n_past + i + 1 for i in range(t))
    n_bytes = t * H * D * 2 + t * H * D * 4
    if update:
        n_bytes += 2 * n_past * H * D * 2 + 2 * (2 * t * H * D * 2)
    else:
        n_bytes += 2 * (n_past + t) * H * D * 2
    return n_bytes, 4.0 * H * D * visible


# online softmax (kernel) against a dense softmax (plain version), both on
# the same bf16-rounded scaled q: each side rounds every probability to bf16
# (relative error <= 2^-8, an 8-bit significand), at different scales,
# before the PV product, so an output element may differ by 2^-7 of
# sum_j p_j |v_j| / l. The f32 differences in the scores and sums are orders
# of magnitude smaller; the limit is twice the bound, element by element.
ATTN_REL = 2.0**-6
ATTN_LIMIT_RULE = "2^-6 * attention(q, k, |v|) per element"


def _attn_err(got, want, q, k, v, n_past, layer: int) -> tuple[float, float]:
    """(max |got - want|, the largest ratio of an element's error to its own
    limit) for attention outputs over layer `layer` of the cache k, v."""
    from llamavk_tpu_torch.ops import flash_attn as fa

    lim = ATTN_REL * fa.flash_attention_ref(q, k, v.abs(), n_past, layer_idx=layer)
    err = (got - want).abs()
    return float(err.max()), float((err / lim.clamp_min(1e-30)).max())


def kernel_attn(timer: Timer, gen, t: int, n_past: int, update: bool, main_path: bool) -> dict:
    from llamavk_tpu_torch.ops import flash_attn as fa

    layers = 2
    layer = 1  # a layer past the first: the wrapper offsets into the stack
    shape = (layers, 1, H, N_CTX, D)
    k = torch.randn(shape, device="cuda", generator=gen).to(torch.bfloat16)
    v = torch.randn(shape, device="cuda", generator=gen).to(torch.bfloat16)
    q = torch.randn((1, t, H, D), device="cuda", generator=gen).to(torch.bfloat16)
    kn = torch.randn((1, t, H, D), device="cuda", generator=gen).to(torch.bfloat16)
    vn = torch.randn((1, t, H, D), device="cuda", generator=gen).to(torch.bfloat16)
    bk = 512 if t >= 256 else 256  # llama_forward's default KV block
    if update:
        k2, v2 = k.clone(), v.clone()
        got, _, _ = fa.flash_attention_update(q, kn, vn, k, v, n_past, layer, block_k=bk)
        want, _, _ = fa.flash_attention_update_ref(q, kn, vn, k2, v2, n_past, layer)
        torch.cuda.synchronize()
        cache_equal = bool(torch.equal(k, k2) and torch.equal(v, v2))
        run = lambda: fa.flash_attention_update(q, kn, vn, k, v, n_past, layer, block_k=bk)  # noqa: E731
        plain = lambda: fa.flash_attention_update_ref(q, kn, vn, k2, v2, n_past, layer)  # noqa: E731
    else:
        fa.write_rows(kn, vn, k, v, n_past, layer)
        got = fa.flash_attention(q, k, v, n_past, layer_idx=layer, block_k=bk)
        want = fa.flash_attention_ref(q, k, v, n_past, layer_idx=layer)
        torch.cuda.synchronize()
        cache_equal = True
        run = lambda: fa.flash_attention(q, k, v, n_past, layer_idx=layer, block_k=bk)  # noqa: E731
        plain = lambda: fa.flash_attention_ref(q, k, v, n_past, layer_idx=layer)  # noqa: E731
    err, ratio = _attn_err(got, want, q, k, v, n_past, layer)
    ms = timer(run)
    plain_ms = timer(plain, reps=5)
    library_ms = timer(lambda: _sdpa(q, k, v, n_past, layer))
    b_ms, b_by = bound(*_attn_sizes(t, n_past, update))
    return {
        "kernel": "attn_update" if update else "attn_read",
        "shape": f"T={t} n_past={n_past} H={H} D={D} S={N_CTX} block_k={bk}",
        "main_path": main_path,
        "max_abs_err": err, "limit": ATTN_LIMIT_RULE, "err_over_limit": ratio,
        "cache_bytes_equal": cache_equal, "ok": ratio <= 1.0 and cache_equal,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": library_ms,
    }


def kernel_edges(gen) -> dict:
    """Correctness only, off the 7B shapes: the GEMM at the row counts of
    short prompts' buckets (M = 2..9), an odd group count and a ragged N,
    the GEMV on a ragged N, and the attention at D = 64 with a small KV
    block, T = 8 and a vector n_past."""
    from llamavk_tpu_torch.ops import flash_attn as fa
    from llamavk_tpu_torch.ops import q4_matmul as q4
    from llamavk_tpu_torch.ops.qweight import dequantize_qweight

    worst = {}
    for m, k, n in ((2, 4096, 4096), (3, 4096, 4096), (4, 4096, 4096), (5, 11008, 4096),
                    (6, 4096, 4096), (7, 4096, 4096), (8, 4096, 12288), (9, 4096, 4096),
                    (1, 96, 136), (17, 96, 136), (64, 128, 320)):
        x, qw = _q4_case(gen, m, k, n)
        err = float((q4.q4_matmul_cuda(x, qw.packed, qw.scales)
                     - q4.q4_matmul_ref(x, qw, out_dtype=torch.float32)).abs().max())
        w = dequantize_qweight(qw).to(torch.bfloat16).float()
        limit = 2 * k * 2.0**-24 * float((x.float().abs() @ w.abs()).max())
        worst[f"q4 M={m} K={k} N={n}"] = (err, limit, err / limit)
    h, d, s = 2, 64, 64
    for b, t, n_past, update in ((1, 8, 13, True), (1, 5, 20, False), (2, 1, None, True)):
        k = torch.randn((2, b, h, s, d), device="cuda", generator=gen).to(torch.bfloat16)
        v = torch.randn((2, b, h, s, d), device="cuda", generator=gen).to(torch.bfloat16)
        q, kn, vn = (torch.randn((b, t, h, d), device="cuda", generator=gen).to(torch.bfloat16)
                     for _ in range(3))
        np_ = torch.tensor([3, 40], dtype=torch.int32, device="cuda") if n_past is None else n_past
        if update:
            k2, v2 = k.clone(), v.clone()
            got, _, _ = fa.flash_attention_update(q, kn, vn, k, v, np_, 1, block_k=32)
            want, _, _ = fa.flash_attention_update_ref(q, kn, vn, k2, v2, np_, 1)
            if not (torch.equal(k, k2) and torch.equal(v, v2)):
                raise SystemExit(f"kernel edges: cache rows differ (B={b} T={t})")
        else:
            fa.write_rows(kn, vn, k, v, np_, 1)
            got = fa.flash_attention(q, k, v, np_, layer_idx=1, block_k=32)
            want = fa.flash_attention_ref(q, k, v, np_, layer_idx=1)
        name = f"attn {'update' if update else 'read'} B={b} T={t} D={d} n_past={n_past or [3, 40]}"
        err, ratio = _attn_err(got, want, q, k, v, np_, 1)
        worst[name] = (err, ATTN_LIMIT_RULE, ratio)
    torch.cuda.synchronize()
    bad = {name: e for name, e in worst.items() if not e[2] <= 1.0}
    if bad:
        raise SystemExit(f"kernel edges disagree with their plain versions: {bad}")
    return {name: {"max_abs_err": e, "limit": lim, "err_over_limit": r}
            for name, (e, lim, r) in worst.items()}


def phase_kernels(reps: int) -> list[dict]:
    timer = Timer(reps)
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    # (M, on the main path of generate_7b): decode and the output matmul at
    # M = 1, the layers' matmuls in the 32-token prefill and the second
    # turn's 353-row bucket; M = 512 is a full-context prefill
    for m, main in ((1, True), (32, True), (353, True), (512, False)):
        for name in K1_SHAPES:
            if m > 1 and main and name == "output":
                continue  # the main path takes logits of the last row only
            rows.append(kernel_q4(timer, gen, name, m, main))
            emit({"phase": "kernel", **rows[-1]})
    # (T, n_past, update kernel, on the main path): decode steps, the first
    # prompt, the second turn (301 tokens at n_past 159 in a 353-row bucket,
    # which takes the read route), and a full-context and odd-length prefill
    for t, n_past, update, main in ((1, 0, True, False), (1, 37, True, True),
                                    (1, 480, True, True), (1, 511, True, False),
                                    (32, 0, True, True), (512, 0, True, False),
                                    (353, 159, False, True), (412, 100, False, False)):
        rows.append(kernel_attn(timer, gen, t, n_past, update, main))
        emit({"phase": "kernel", **rows[-1]})
    emit({"phase": "kernel_edges", **kernel_edges(gen)})
    bad = [r["shape"] for r in rows if not r["ok"]]
    if bad:
        raise SystemExit(f"kernels disagree with their plain versions: {bad}")
    return rows


def phase_tiny_cli(work: Path) -> dict:
    from llamavk_tpu_torch.cli import generate as cli
    from llamavk_tpu_torch.models.loader import random_tiny_model

    path = str(work / "tiny-q4.bin")
    random_tiny_model(write_path=path, quantize=True)
    outs = {}
    for device in ("cuda", "cpu"):
        args = cli.build_argparser().parse_args(
            ["-m", path, "-p", TINY_PROMPT, "-n", "16", "--temp", "0", "-s", "42",
             "--device", device]
        )
        buf = io.StringIO()
        if cli.run(args, stdout=buf) != 0:
            raise SystemExit(f"tiny_cli: run on {device} failed")
        outs[device] = buf.getvalue()
    if outs["cuda"] != outs["cpu"]:
        raise SystemExit(f"tiny_cli: card and CPU streams differ:\n{outs['cuda']!r}\n{outs['cpu']!r}")
    return {"tokens_text": outs["cuda"].strip(), "equal_to_cpu": True}


def _reset_counts() -> None:
    from llamavk_tpu_torch.ops import flash_attn as fa
    from llamavk_tpu_torch.ops import q4_matmul as q4

    for d in (q4.launches, fa.launches):
        for key in d:
            d[key] = 0


def _counts() -> dict:
    from llamavk_tpu_torch.ops import flash_attn as fa
    from llamavk_tpu_torch.ops import q4_matmul as q4

    return {"q4_gemv": q4.launches["gemv"], "q4_gemm": q4.launches["gemm"],
            "attn_update": fa.launches["update"], "attn_read": fa.launches["read"]}


# kernel against plain forward passes on the 7B synthetic model: both keep
# bf16 activations and sum in f32 in different orders, so an activation can
# land one bf16 rounding step apart after any matmul and carry that through
# 32 layers. The logits may drift by at most one bf16 step (2^-8) of the
# largest logit, and the argmax must agree where the top-2 gap is wider.
LOGIT_REL_LIMIT = 2.0**-8


def _device_busy(fn) -> tuple[float, float | None, int]:
    """Host wall time (ms) of fn, the device time inside it from
    torch.profiler (None when the profiler sees no device activity), and
    the number of device activities (kernels and copies)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    from torch.autograd import DeviceType

    dev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    dev_us = sum(getattr(e, "self_device_time_total", 0) or getattr(e, "self_cuda_time_total", 0)
                 for e in dev)
    return wall, (dev_us / 1e3 if dev_us > 0 else None), sum(e.count for e in dev)


def phase_generate_7b(seed: int) -> tuple[dict, dict]:
    from llamavk_tpu_torch.models.llama import ModelConfig, init_kv_cache, llama_forward
    from llamavk_tpu_torch.models.loader import LLAMA_CONFIGS, synthetic_params
    from llamavk_tpu_torch.runtime.engine import Engine, EngineConfig
    from llamavk_tpu_torch.runtime.sampling import SamplerParams

    cfg = ModelConfig(**LLAMA_CONFIGS["7B"])
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = synthetic_params(cfg, seed=seed, device="cuda")
    torch.cuda.synchronize()
    t_params = time.perf_counter() - t0
    gen = torch.Generator(device="cpu").manual_seed(seed)

    # kernel path against the plain path, through the main path's routes: a
    # 32-token prefill and 4 decode steps, a 123-token fill to n_past 159,
    # then the second turn's eval (301 tokens padded to a 353-row bucket at
    # n_past 159: GEMM M=353 and the read-only attention)
    caches = {ref: init_kv_cache(cfg, 1, N_CTX, device="cuda") for ref in (False, True)}
    logits = {ref: [] for ref in (False, True)}

    def both(tokens, n_past: int, last_idx: int | None = None) -> None:
        for ref in (False, True):
            lg, _, _ = llama_forward(params, tokens, caches[ref], n_past, cfg,
                                     last_idx=last_idx, use_ref=ref)
            logits[ref].append(lg)

    both(torch.randint(3, cfg.n_vocab, (1, 32), generator=gen).cuda(), 0)
    for i in range(4):
        both(logits[True][-1][0, -1].argmax().view(1, 1), 32 + i)  # the plain stream's token
    both(torch.randint(3, cfg.n_vocab, (1, 123), generator=gen).cuda(), 36)
    turn2 = torch.randint(3, cfg.n_vocab, (1, 353), generator=gen)
    turn2[:, 301:] = 0  # the engine's bucket padding
    both(turn2.cuda(), 159, last_idx=300)
    cmp = []
    for a, b in zip(logits[False], logits[True]):
        diff = float((a - b).abs().max())
        scale = float(b.abs().max())
        top2 = torch.topk(b[0, -1], 2).values
        cmp.append({"max_abs": diff, "rel": diff / scale,
                    "argmax_equal": bool(a[0, -1].argmax() == b[0, -1].argmax()),
                    "top2_gap_rel": float(top2[0] - top2[1]) / scale})
        if not all(map(math.isfinite, (diff, scale))):
            raise SystemExit("generate_7b: non-finite logits")
    worst = max(c["rel"] for c in cmp)
    if worst > LOGIT_REL_LIMIT:
        raise SystemExit(f"generate_7b: kernel logits {worst:.3g} from plain (limit {LOGIT_REL_LIMIT})")
    for c in cmp:
        if c["top2_gap_rel"] > LOGIT_REL_LIMIT and not c["argmax_equal"]:
            raise SystemExit("generate_7b: kernel and plain argmax differ on a clear top-2 gap")
    del caches, logits

    # the main path: a 32-token prompt generating 128 tokens (the last one
    # pending, n_past 159), then a second turn whose 300-token prompt plus
    # the pending token, 301 rows at n_past 159 in a bucket capped at 353,
    # takes the read-only attention route
    eng = Engine(cfg, params, EngineConfig(n_ctx=N_CTX, seed=seed), device="cuda")
    greedy = SamplerParams(temp=0.0)
    prompt1 = torch.randint(3, cfg.n_vocab, (32,), generator=gen).tolist()
    prompt2 = torch.randint(3, cfg.n_vocab, (300,), generator=gen).tolist()
    eng.generate(prompt1, 8, greedy, ignore_eos=True)  # warm-up
    eng.reset()
    eng.timings = type(eng.timings)()
    torch.cuda.synchronize()
    _reset_counts()
    out1 = eng.generate(prompt1, 128, greedy, ignore_eos=True)
    counts1 = _counts()
    prefill_ms = eng.timings.t_prompt_us / 1e3
    n_decode = eng.timings.n_eval
    decode_ms = eng.timings.t_eval_us / 1e3 / n_decode
    out2 = eng.generate(prompt2, 16, greedy, ignore_eos=True)
    counts = _counts()
    turn2_prefill_ms = eng.timings.t_prompt_us / 1e3 - prefill_ms
    peak = torch.cuda.max_memory_allocated()
    # where a decode step's time goes: 8 forward passes timed on the host
    # clock, then 8 more under the profiler for the device's busy time. The
    # profiler slows the host, so the idle share divides the busy time by
    # the unprofiled wall time.
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.generate([], 8, greedy, ignore_eos=True)
    torch.cuda.synchronize()
    plain_wall_ms = (time.perf_counter() - t0) * 1e3
    wall_ms, busy_ms, n_dev = _device_busy(lambda: eng.generate([], 8, greedy, ignore_eos=True))
    if len(out1) != 128 or len(out2) != 16:
        raise SystemExit("generate_7b: short generation")
    # K1: 4 matmuls per layer + the output matmul, per forward pass
    forwards1 = 1 + (len(out1) - 1)
    k1_1 = counts1["q4_gemv"] + counts1["q4_gemm"]
    if k1_1 != (4 * cfg.n_layer + 1) * forwards1:
        raise SystemExit(f"generate_7b: {k1_1} K1 launches for {forwards1} forward passes")
    missing = [k for k, n in counts.items() if n == 0]
    if missing:
        raise SystemExit(f"generate_7b: kernels never launched on the main path: {missing}")
    result = {
        "params_s": round(t_params, 3), "kernel_vs_plain": cmp, "limit_rel": LOGIT_REL_LIMIT,
        "prefill_tokens": len(prompt1), "prefill_ms": prefill_ms,
        "decode_tokens": n_decode, "decode_ms_per_token": decode_ms,
        "tok_per_s": 1e3 / decode_ms, "k1_launches_per_token": k1_1 / forwards1,
        "turn2_prompt": len(prompt2), "turn2_prefill_ms": turn2_prefill_ms,
        "turn2_tokens": len(out2), "peak_mem_bytes": peak, "launches": counts,
        "wall_ms_per_step": plain_wall_ms / 8, "profiled_wall_ms_per_step": wall_ms / 8,
        "device_busy_ms_per_step": None if busy_ms is None else busy_ms / 8,
        "device_activities_per_step": n_dev / 8,
        "device_idle_share": None if busy_ms is None else 1 - busy_ms / plain_wall_ms,
    }
    return result, counts


def summary(rows: list[dict], counts: dict) -> dict:
    """One entry per kernel, at the main-path shape that costs it most; the
    error is the largest over every shape it was checked at."""
    out = []
    for name, (source, replaces) in KERNEL_META.items():
        mine = [r for r in rows if r["kernel"] == name]
        worst = max((r for r in mine if r["main_path"]), key=lambda r: r["ms"])
        out.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": counts.get(name, 0), "max_abs_err": max(r["max_abs_err"] for r in mine),
            "ms": worst["ms"], "plain_ms": worst["plain_ms"], "bound_ms": worst["bound_ms"],
            "bound_by": worst["bound_by"], "library_ms": worst["library_ms"],
            "shape": worst["shape"],
        })
    return {"kernels": out}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default="env,build,kernels,tiny_cli,generate_7b")
    ap.add_argument("--reps", type=int, default=20, help="timed launches per kernel")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", help="also write every phase's result to this JSON file")
    args = ap.parse_args()
    phases = args.phases.split(",")

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    import llamavk_tpu_torch  # noqa: F401  (fails outside a checkout of the repo)

    report: dict = {}
    env = phase_env()
    report["env"] = env
    emit({"phase": "env", **env})
    if "build" in phases:
        report["build"] = phase_build()
        emit({"phase": "build", **report["build"]})
    rows: list[dict] = []
    if "kernels" in phases:
        rows = phase_kernels(args.reps)
        report["kernels"] = rows
    if "tiny_cli" in phases:
        (ROOT / "build").mkdir(exist_ok=True)
        with tempfile.TemporaryDirectory(dir=ROOT / "build") as work:
            report["tiny_cli"] = phase_tiny_cli(Path(work))
        emit({"phase": "tiny_cli", **report["tiny_cli"]})
    counts: dict = {}
    if "generate_7b" in phases:
        report["generate_7b"], counts = phase_generate_7b(args.seed)
        emit({"phase": "generate_7b", **report["generate_7b"]})
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(report, indent=1))
    print(env["nvidia_smi"])
    if rows:
        emit(summary(rows, counts))
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
