#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`llamavk_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py                 # every phase, as a check of the card
    python3 chip_smoke.py --phases env,build,kernels --out report.json

Phases, each printing one JSON line (any failure exits non-zero):

  env         versions, nvcc, triton, the card's name and power limit
  build       nvcc builds `llamavk_tpu_torch/csrc/*.cu` for sm_90a, g++ the
              native host library (the loader's repack: native or NumPy,
              as printed); the SASS of K5's kernels must hold IMMA, that of
              K1's GEMV kernels HMMA and no I2F, F2F or F2FP
  kernels     each hand-written kernel against its plain PyTorch version on
              the card at the LLaMA-7B shapes of the main paths: error, time
              (CUDA events, median, L2 flushed between launches), bound, and
              one PyTorch call computing the same function as a yardstick;
              the batched decode kernel's outputs bit-equal to the fused
              update kernel's at T = 1, row by row; then correctness alone
              at row counts, group counts, ragged widths and head sizes off
              those shapes. K2 and K3 take the route `attn_route` picks
              (split-KV attention at T 1-15 over every cache type, named
              with `_split`, K4's kernel too; the tensor cores at T >= 16
              over every cache type, named with `_tc`, f32 caches on three
              TF32 passes a product); a split-route row (K4's too) carries
              its split count (`splits`, `split_rows`) and the CUDA kernels
              one call launches (the attention libraries' counters; must be
              1: K2's row writes are in the same launch), and every row
              also times the same call on the CUDA-core route the split
              and tensor-core routes replaced (`cuda_core_ms`)
  probes      the Hopper probes of `llamavk_tpu_torch/tools/` (the TPU
              probes P1-P5 of `tools/`) through their entry points, at the
              TPU probes' shapes on seeded random bytes: every probe kernel
              against its plain version (unpacked weights bit-equal, the
              magic-number unpack's to the shift unpack's; integer dots
              exact; the one-launch prefill's cache rows byte-equal),
              timed beside K1 or K2, its bound and one PyTorch call
  tiny_cli    the generate CLI on a tiny GGJT file, greedy, bf16 and int8
              KV, on the card and on the CPU: the token streams must be
              equal; also an interactive session (-i -r, two scripted
              turns of stdin) with equal text; the re-evaluating context
              swap through the decode graph and the uncaptured step, equal
  generate_7b synthetic LLaMA-7B Q4_0 weights, n_ctx 512, bf16 KV: kernel and
              plain forward passes agree on the main path's routes and
              shapes, and 4 decode steps at an int32 [1] n_past give the
              host int's bits; then the main path (a 32-token prompt generating 128
              tokens, and a 300-token follow-up turn that reaches the
              read-only attention) with launch counts (K1 4 x 32 + 1 a
              forward, graph replays counted); decode blocks through the
              graph and through the uncaptured step alternated: ms a token,
              device busy ms a token, activities a step, idle share; the
              graphs' capture seconds and pool bytes; the graph's streams
              equal to the uncaptured step's token for token (bf16 greedy
              128 and seeded sampled 64 tokens, int8 and f32 engines 32
              tokens each, greedy and sampled)
  tiny_serve  the HTTP server on the tiny GGJT file on the card, bf16 and
              int8 KV, 4 concurrent greedy requests to a LlamaServer here and
              to the serve CLI in its own process, without and with
              --lookup-gamma 4: their streams must equal the CPU's batched
              engine
  serve_7b    synthetic LLaMA-7B, the production serving flags without
              paging (32 slots, n_ctx 512, int8 KV): a B=32 decode step with
              ragged n_past through the kernels and the plain versions (int8
              and bf16); then 32 of the 64 smoke requests over HTTP and one that
              continues a registered prefix, with throughput, time to first
              token, launch counts and the idle share; 32 requests (greedy
              and seeded sampled) through a BatchedEngine's graph and its
              uncaptured step, streams equal token for token; then every
              kernel against its plain version at every shape that phase
              launched it at (K1, K2/K3 int8 admission and prefix shapes, K4)
  serve_7b_paged
              the same with --paged (page_size 128, the default pool of 129
              pages): 8 greedy requests through a paged and a flat engine at
              kv_block 128 with equal streams; the 64 requests; a registered
              300-token prefix (2 shared pages) continued by 4 concurrent
              suffixes; the 64 requests again on a quarter pool (33 pages),
              which preempts; serve_7b's graph against uncaptured check,
              paged; then every kernel at every shape it launched
  generate_7b_lookup
              the generate CLI with --draft-lookup --draft-n 4 on synthetic
              7B at 16 of its 32 layers (a 16-token pattern repeated 3
              times, 128 tokens) and plain greedy, with the default dot here
              and LLAMAVK_Q4_DOT=i8 (K5) in a process of its own: streams
              equal, or parting only at a near tie; under i8 also a B=32
              decode step against the plain path and a perplexity --f32
              -c 64 chunk (K5 over f32 scales); the device's idle share
              over a 16-token lookup run (--lookup-idle-tokens 16,64 adds
              windows)
  spec_7b_self
              generate --draft-model with the 7B weights (the lookup phase's
              16 layers) as target and draft, 64 tokens: the plain greedy
              stream and full acceptance, up to a near tie
  serve_7b_lookup
              serve --lookup-gamma 4, int8 KV: 8 repeated-pattern greedy
              requests through flat and paged lookup engines against a plain
              one (verify writes crossing pages: K2's page_straddle), then
              serve_7b's 64 requests to the paged lookup server; then every
              kernel at every shape it launched

  generate_7b_ring
              the generate CLI with --ctx-swap ring --n-keep 32 on synthetic
              7B (16 of its 32 layers), n_ctx 512, bf16 KV: a 32-token prompt
              and 700 tokens (one wrap and 220 more), equal to the same run
              through the uncaptured step, the first 480 against
              the plain greedy CLI's (equal, or parting only at a near tie),
              ms per token before and after the wrap, a post-wrap forward
              through the kernels against the plain versions, the idle share
  serve_7b_shared
              --shared-prefix --prefix-pool 4 --prefix-ctx 256, int8 KV, 32
              slots: a 200-token prefix registered once, 8 greedy suffix
              requests against the plain-version composition, then 32
              concurrent requests continuing it over HTTP; pool and slot
              cache bytes; then every kernel at every shape it launched
  tiny_compat the llama.h API (compat.py) on the tiny GGJT file on the card,
              f16_kv True and False (an f32 cache): greedy tokens equal to
              the CPU's, logits within two bf16 ulps, a KV blob round trip on
              the card and onto the CPU; BatchedEngine(kv_dtype="float32")
              streams equal to the CPU's; the perplexity CLI (bf16 and
              --f32) and the embedding CLI in their own processes on the
              card against --device cpu
  eval_7b_f32 synthetic 7B: one 512-token perplexity chunk through
              make_chunk_nll, bf16 and as --f32 runs it (f32 scales, einsum
              attention, f32 KV), NLLs against the plain versions and ms per
              chunk; the llama.h API with f16_kv = false (f32 KV): a
              32-token prompt, 128 greedy tokens and a 300-token turn through
              llama_eval, against the plain forward teacher-forced on the
              stream, ms per token, idle share, cache bytes, embeddings; 32
              requests through BatchedEngine(kv_dtype="float32"); a B=32
              decode step over an f32 cache, kernels against plain; then
              every kernel at every shape it launched
  parallel_7b make_sharded_forward on synthetic 7B at full width, two ranks on
              the one card over gloo (spawned processes): tp = 2 (a 32-token
              prompt, 16 greedy decode steps) and pp = 2 with 2 microbatches
              at B = 4 (4 steps); every step's logits bit-equal on both
              ranks and within 2^-8 of the single-device forward's largest
              logit (teacher-forced; the tp-packed weights run whole: K1 over
              2 chunks), greedy tokens equal or parting at a near tie, K2's
              batch_offset launches = microbatches x local layers per
              forward; host ms per step (not a scaling result)
  serve_7b_tp serve --tp 2's ranks (a LlamaServer on rank 0, follow_rank on
              rank 1) on synthetic 7B, int8 KV, 8 concurrent greedy HTTP
              requests: streams against one rank serving the same weights,
              equal or parting at a near tie; tok/s, ms per step, backend;
              the one-rank run's chunked K1 shapes against the plain version
  generate_7b_modes
              K1's modes through the single-stream entry points on
              synthetic 7B: the generate CLI (32-token prompt, 128 greedy
              tokens, each stream against the plain forward teacher-forced
              on it, ms per token and prefill ms) on the ilv weights, on lin
              weights, and under LLAMAVK_Q4_DOT=f32 in a process of its own;
              a 512-token perplexity --f32 chunk under LLAMAVK_Q4_MUL=bf16 in
              another, NLL against plain; --mtest -b 32 on the lin weights;
              then, in each process, every kernel at every shape it launched

Decoding runs through CUDA graphs (`runtime/graphs.py`) wherever an
`Engine` or a one-device `BatchedEngine` decodes a plain block: tiny_cli,
generate_7b, the plain runs of generate_7b_lookup, generate_7b_ring,
generate_7b_modes, tiny_serve and tiny_compat without lookup, serve_7b,
serve_7b_paged, serve_7b_shared and eval_7b_f32's batched requests. Lookup
and speculative rounds, the tp and pp ranks and every prefill run eagerly.
The uncaptured step (the graphs' plain version) is reached only through the
engines' private `_run_uncaptured` (`_uncaptured()` here).

The kernels phase holds K1's GEMM (M >= 2) in every mode (ilv and lin,
bf16 and f32 scales, LLAMAVK_Q4_DOT=f32, LLAMAVK_Q4_MUL=bf16) at the five
7B shapes and M = 2, 4, 8, 16, 32, 64, 353, 512, 1024, each row beside the
time of the WMMA GEMM it replaced on the same row (`wmma_ms`, from
tools/bench_gemm_wmma.jsonl), and every GEMV row (M = 1) beside the time
of the GEMV it replaced (`parent_ms`, from tools/bench_gemv_runs.jsonl),
with the CUDA kernels its launch made (`cuda_launches`, which must be 1)
and its K ranges (`splits`); the dequantized weights of the GEMM's two
routes and of the GEMV bit for bit against `mode_weight`'s in every mode,
and two GEMV launches bit-equal at each 7B shape in every mode; the page-table modes of K2, K3 and K4 (bf16, int8 and f32,
scrambled tables of 128-row pages; K2 also in page_straddle mode) against
their plain versions, with written pages byte-equal and the others
unchanged, and bit for bit against the flat kernels on the gathered view at
block_k = 128 (K4 also against the paged K2 at T = 1), and K5 (the int8
dot, on the int8 tensor cores) at M = 1, 4, 8, 16 and 32, beside the time
of the dp4a kernel it replaced on the same row (`parent_ms`, from
tools/bench_i8_runs.jsonl); K1's GEMV over an f32 scale plane and the f32
cache of K2, K3 and K4 (limit 2^-12 of attention(q, k, |v|), K4 bit-equal
to K2); and the history ring and shared-prefix modes of K2 and K3 (bf16 and
int8, and f32 slots under the bf16 pool, caches byte-equal, the position
plane and the pool unchanged; ring K2 before a wrap and prefix K2 at
prefix_len 0 bit-equal to flat K2; the f32 ring's decode step before and
after a wrap); K1's GEMV on the lin layout and under the f32 dot, and K5
over f32 scales at M = 1, 4 and 64; and the parallel paths' modes: K1 and
K5 over wo/w2 packed in 2 chunks, K1 at one tp = 2 rank's shapes, K2 with
batch_offset (pp microbatches) and commit=0, K3 and K4 with batch_offset
(each bit-equal to the call on a copy of the offset rows, the other rows
unchanged; commit=0 leaves every byte). tiny_cli also runs --ctx-swap ring, and tiny_serve
serves the tiny file with `serve --tp 2` (flat bf16 and int8), paged
(page_size 8 bf16, 32 int8) and with --shared-prefix (bf16 and int8, with
and without --lookup-gamma 4; f32 slots without). Each phase's wall time is
printed on a line of its own.

The line before the last is `{"kernels": [...]}`; the last line is
`{"ok": true, "device": {...}}`. Without CUDA the script exits 2 and prints
no result.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import gc
import io
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from pathlib import Path

import torch

# the timer, the bound and the card's peaks are the probes' (tools/_common.py);
# K1's GEMM grid (modes, M, the 7B shapes) is tools/bench_gemm.py's; the
# attention routes' launch keys are ops/flash_attn.py's
from llamavk_tpu_torch.ops import flash_attn as _fa
from llamavk_tpu_torch.tools import bench_gemm
from llamavk_tpu_torch.tools._common import BF16_OP_PER_S, INT8_OP_PER_S, Timer, bound

ROOT = Path(__file__).resolve().parent
# float32 outside the tensor cores, and dense TF32 on them (NVIDIA's H100
# SXM data sheet, at 700 W)
F32_FLOP_PER_S = 67e12
TF32_OP_PER_S = 494.7e12

# 7B matmul shapes (K, N) of the main path
K1_SHAPES = bench_gemm.SHAPES
# the local shapes of the same matmuls on one rank of tp = 2: column-parallel
# N halved, row-parallel K halved
K1_SHAPES_TP2 = bench_gemm.SHAPES_TP2
ALL_K1_SHAPES = {**K1_SHAPES, **K1_SHAPES_TP2}
N_CTX = 512
H, D = 32, 128
PAGE = 128  # the serving page size (BatchConfig.page_size)

# the split-KV kernel of K2/K3 at T 1-15 and of K4
SPLIT_SOURCE = "llamavk_tpu_torch/csrc/attn_split.cuh"
# K1's sources: the GEMV in q4_matmul.cu, the GEMM (M >= 2) in q4_gemm.cuh
K1_SOURCES = {"gemv": "llamavk_tpu_torch/csrc/q4_matmul.cu",
              "gemm": "llamavk_tpu_torch/csrc/q4_gemm.cuh"}
KERNEL_META = {
    "q4_gemv": ("llamavk_tpu_torch/csrc/q4_matmul.cu", "llamavk_tpu/ops/q4_matmul.py:96"),
    "q4_gemm": ("llamavk_tpu_torch/csrc/q4_gemm.cuh", "llamavk_tpu/ops/q4_matmul.py:96"),
    "attn_update": ("llamavk_tpu_torch/csrc/flash_attn.cu", "llamavk_tpu/ops/flash_attn.py:120"),
    "attn_read": ("llamavk_tpu_torch/csrc/flash_attn.cu", "llamavk_tpu/ops/flash_attn.py:474"),
    "attn_update_i8": ("llamavk_tpu_torch/csrc/flash_attn.cu",
                       "llamavk_tpu/ops/flash_attn.py:120"),
    "attn_read_i8": ("llamavk_tpu_torch/csrc/flash_attn.cu", "llamavk_tpu/ops/flash_attn.py:474"),
    "decode": (SPLIT_SOURCE, "llamavk_tpu/ops/flash_decode.py:67"),
    "decode_i8": (SPLIT_SOURCE, "llamavk_tpu/ops/flash_decode.py:67"),
    # page-table modes (the TPU kernels' `page_table` operand)
    "attn_update_paged": ("llamavk_tpu_torch/csrc/flash_attn.cu",
                          "llamavk_tpu/ops/flash_attn.py:120"),
    "attn_update_paged_i8": ("llamavk_tpu_torch/csrc/flash_attn.cu",
                             "llamavk_tpu/ops/flash_attn.py:120"),
    "attn_read_paged": ("llamavk_tpu_torch/csrc/flash_attn.cu",
                        "llamavk_tpu/ops/flash_attn.py:474"),
    "attn_read_paged_i8": ("llamavk_tpu_torch/csrc/flash_attn.cu",
                           "llamavk_tpu/ops/flash_attn.py:474"),
    "decode_paged": (SPLIT_SOURCE, "llamavk_tpu/ops/flash_decode.py:67"),
    "decode_paged_i8": (SPLIT_SOURCE, "llamavk_tpu/ops/flash_decode.py:67"),
    # K5, the int8 dot (LLAMAVK_Q4_DOT=i8), and K2's page_straddle mode
    "q4_i8": ("llamavk_tpu_torch/csrc/q4_matmul_i8.cu", "llamavk_tpu/ops/q4_matmul.py:226"),
    "attn_update_paged_straddle": ("llamavk_tpu_torch/csrc/flash_attn.cu",
                                   "llamavk_tpu/ops/flash_attn.py:120"),
    "attn_update_paged_straddle_i8": ("llamavk_tpu_torch/csrc/flash_attn.cu",
                                      "llamavk_tpu/ops/flash_attn.py:120"),
    # the f32 scale plane of K1 and the flat f32 cache of K2, K3 and K4
    "q4_gemv_f32": ("llamavk_tpu_torch/csrc/q4_matmul.cu", "llamavk_tpu/ops/q4_matmul.py:96"),
    "q4_gemm_f32": ("llamavk_tpu_torch/csrc/q4_gemm.cuh", "llamavk_tpu/ops/q4_matmul.py:96"),
    "attn_update_f32": ("llamavk_tpu_torch/csrc/flash_attn.cu",
                        "llamavk_tpu/ops/flash_attn.py:120"),
    "attn_read_f32": ("llamavk_tpu_torch/csrc/flash_attn.cu", "llamavk_tpu/ops/flash_attn.py:474"),
    "decode_f32": (SPLIT_SOURCE, "llamavk_tpu/ops/flash_decode.py:67"),
    # the history-ring (`kv_pos`/`write_row`) and shared-prefix pool
    # (`prefix_k/v/id/len`) modes of K2 and K3
    **{f"attn_{path}_{mode}{kind}": ("llamavk_tpu_torch/csrc/flash_attn.cu",
                                      f"llamavk_tpu/ops/flash_attn.py:{line}")
       for path, line in (("update", 120), ("read", 474)) for mode in ("ring", "prefix")
       for kind in ("", "_i8")},
    # K1's lin layout (its branch at q4_matmul.py:190), the bf16 multiply over
    # f32 scales (LLAMAVK_Q4_MUL=bf16) and the f32 dot (LLAMAVK_Q4_DOT=f32),
    # named as q4_matmul.launch_key names them; K5 over f32 scales
    **{f"q4_{base}{mode}": (K1_SOURCES[base],
                            "llamavk_tpu/ops/q4_matmul.py:" + ("190" if "lin" in mode else "96"))
       for base in ("gemv", "gemm")
       for mode in ("_lin", "_lin_f32", "_lin_f32_mulbf16", "_lin_dotf32", "_lin_f32_dotf32",
                    "_f32_mulbf16", "_dotf32", "_f32_dotf32")},
    "q4_i8_f32": ("llamavk_tpu_torch/csrc/q4_matmul_i8.cu", "llamavk_tpu/ops/q4_matmul.py:226"),
    # weights packed in 2 K chunks (tp packing run whole): one launch per
    # chunk, every K1 mode and K5 (q4_matmul.py:714-728, :776-789, :522)
    **{f"q4_{base}{mode}_chunks": (K1_SOURCES[base],
                                   "llamavk_tpu/ops/q4_matmul.py:" + ("190" if "lin" in mode
                                                                       else "96"))
       for base in ("gemv", "gemm")
       for mode in ("", "_f32", "_lin", "_lin_f32", "_lin_f32_mulbf16", "_lin_dotf32",
                    "_lin_f32_dotf32", "_f32_mulbf16", "_dotf32", "_f32_dotf32")},
    **{f"q4_i8{mode}_chunks": ("llamavk_tpu_torch/csrc/q4_matmul_i8.cu",
                               "llamavk_tpu/ops/q4_matmul.py:226") for mode in ("", "_f32")},
    # the pipeline modes: a microbatch's rows of a wider flat cache
    # (`batch_offset`, flash_attn.py:827, :1023, flash_decode.py:391) and K2's
    # commit=0 (flash_attn.py:1018)
    **{f"{name}{kind}": (src, f"llamavk_tpu/ops/{line}")
       for name, src, line in (
           ("attn_update_boff", "llamavk_tpu_torch/csrc/flash_attn.cu", "flash_attn.py:120"),
           ("attn_read_boff", "llamavk_tpu_torch/csrc/flash_attn.cu", "flash_attn.py:474"),
           ("attn_update_nocommit", "llamavk_tpu_torch/csrc/flash_attn.cu", "flash_attn.py:120"),
           ("decode_boff", SPLIT_SOURCE, "flash_decode.py:67"))
       for kind in ("", "_i8", "_f32")},
    # the f32 history ring, page pool and prefix-pool slots of K2 and K3
    # (the CUDA-core route), and K4's f32 page pool
    **{f"attn_{path}_{mode}_f32": ("llamavk_tpu_torch/csrc/flash_attn.cu",
                                   f"llamavk_tpu/ops/flash_attn.py:{line}")
       for path, line, modes in (("update", 120, ("ring", "paged", "paged_straddle", "prefix")),
                                 ("read", 474, ("ring", "paged", "prefix")))
       for mode in modes},
    "decode_paged_f32": (SPLIT_SOURCE, "llamavk_tpu/ops/flash_decode.py:67"),
    # the tensor-core route of K2 and K3 (every cache type at T >= 16,
    # ops/flash_attn.py::attn_route; f32 on 3xTF32), in every mode, named as
    # flash_attn.launch_name names it (`_tc` before the cache type)
    **{f"attn_{path}{mode}_tc{kind}": ("llamavk_tpu_torch/csrc/attn_mma.cuh",
                                       f"llamavk_tpu/ops/flash_attn.py:{line}")
       for path, line, modes in (
           ("update", 120, ("", "_paged", "_paged_straddle", "_ring", "_prefix", "_boff",
                            "_nocommit")),
           ("read", 474, ("", "_paged", "_ring", "_prefix", "_boff")))
       for mode in modes for kind in ("", "_i8", "_f32")},
    # the split route of K2 and K3 (T 1-15, every cache type, ops/flash_attn.py::
    # attn_route), in every mode, named as flash_attn.launch_name names it
    # (`_split` before the cache type)
    **{f"attn_{key}": (SPLIT_SOURCE, "llamavk_tpu/ops/flash_attn.py:"
                       + ("120" if key.startswith("update") else "474"))
       for key in _fa.launches if "_split" in key},
}

# the tiny model's prompt for the CLI phase: its greedy stream keeps every
# top-2 logit gap above 0.19 for 16 steps (on the CPU, bf16 and int8 KV),
# far above the kernels' drift from the plain versions
TINY_PROMPT = "<t148><t159><t106><t66><t132><t104>"
# the tiny_serve prompts (token ids): each greedy stream keeps every top-2
# logit gap above 0.15 for 6 steps on the CPU, with bf16 and int8 caches
TINY_SERVE_PROMPTS = [[10, 177, 191], [95, 126, 17], [60, 51, 246, 212, 166],
                      [250, 68, 150, 8, 250, 173]]


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


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
    """nvcc builds the kernels (all sources started together); g++ builds
    the native host library (`native.py`) meanwhile. Reports which host
    repack the loader takes: the native one, or NumPy where it did not
    build (host code only, no device or kernel on either path)."""
    from llamavk_tpu_torch import native
    from llamavk_tpu_torch.ops import _build

    t0 = time.perf_counter()
    host = threading.Thread(target=native.get_lib)
    host.start()
    logs = _build.build_all()
    host.join()
    secs = time.perf_counter() - t0
    # ptxas resource lines: each kernel's (mangled) name, registers, spills
    # and shared memory
    usage = [ln.strip() for log in logs.values() for ln in log.splitlines()
             if "registers" in ln or "spill" in ln or "Function properties" in ln]
    lib = native.get_lib()
    return {"seconds": round(secs, 2), "sources": sorted(logs), "ptxas": usage,
            "k5_sass_imma": _k5_sass_imma(), "k1_gemv_sass": _k1_gemv_sass(),
            "host_repack": f"native ({lib._name})" if lib is not None else "numpy fallback"}


def _sass_ops(lib: str, match: str) -> dict:
    """The SASS opcode counts (`cuobjdump -sass`) of each kernel of the
    built library `lib` whose mangled name holds `match`, keyed by that
    name."""
    from llamavk_tpu_torch.ops import _build

    _build.load(lib)
    cuobjdump = Path(_build.nvcc_path()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(_build._lib_path(lib))],
                          capture_output=True, text=True, check=True).stdout
    counts, name = {}, None
    for ln in sass.splitlines():
        if "Function :" in ln:
            name = ln.split("Function :")[1].strip()
            if match in name:
                counts[name] = {}
        elif name in counts:
            m = re.search(r"/\*[0-9a-f]+\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9]+)", ln)
            if m:
                counts[name][m.group(1)] = counts[name].get(m.group(1), 0) + 1
    return counts


def _k5_sass_imma() -> dict:
    """The IMMA (int8 tensor-core) instructions in the SASS of each K5 group
    dot kernel, keyed by the kernel's mangled name; fails if a variant has
    none."""
    counts = {name: ops.get("IMMA", 0)
              for name, ops in _sass_ops("q4_matmul_i8", "i8_mma_kernel").items()}
    if len(counts) != 8 or not all(counts.values()):
        raise SystemExit(f"build: K5's kernels must run on IMMA, SASS shows {counts}")
    return counts


def _k1_gemv_sass() -> dict:
    """The conversion and tensor-core instructions in the SASS of each K1
    GEMV kernel, one a mode of K1_MODES, keyed by the kernel's mangled name:
    I2F, F2F and F2FP (none may appear: the GEMV dequantizes with integer
    and bf16x2 operations) and HMMA, which must appear in a kernel whose
    template argument NP (bf16 parts a weight) is 1 or 2 and not in one
    with NP = 3 (the f32 dot over f32 scales, fmaf on the CUDA cores); fails
    otherwise."""
    ops = {name: {op: c.get(op, 0) for op in ("I2F", "F2F", "F2FP", "HMMA")}
           for name, c in _sass_ops("q4_matmul", "gemv").items()}
    # q4_gemv_kernel<ST, LIN, RS, NP>: NP is the template's one int
    parts = {name: int(re.search(r"q4_gemv_kernelI.*?Li(\d+)E", name).group(1)) for name in ops}
    bad = {name: c for name, c in ops.items()
           if c["I2F"] or c["F2F"] or c["F2FP"] or bool(c["HMMA"]) != (parts[name] != 3)}
    if bad or len(ops) != len(K1_MODES):
        raise SystemExit(f"build: K1's GEMV must run conversion-free on HMMA in each of its "
                         f"{len(K1_MODES)} modes, SASS shows {bad or ops}")
    return ops


def _q4_case(gen, m: int, k: int, n: int, f32_scales: bool = False, layout: str = "ilv",
             chunks: int = 1):
    """x bf16 [M, K] and a random Q4_0 weight [K, N] in `layout`, packed in
    `chunks` K slices (random bytes are a valid plane of any packing), its
    scales bf16 or (`f32_scales`) f32 as drawn."""
    from llamavk_tpu_torch.ops.qweight import QWeight

    packed = torch.randint(-128, 128, (k // 2, n), dtype=torch.int8, device="cuda", generator=gen)
    scales = torch.empty((k // 32, n), device="cuda").uniform_(0.005, 0.02, generator=gen)
    x = torch.randn((m, k), device="cuda", generator=gen).to(torch.bfloat16)
    return x, QWeight(packed=packed, scales=scales if f32_scales else scales.to(torch.bfloat16),
                      layout=layout, chunks=chunks)


def kernel_q4(timer: Timer, gen, name: str, m: int, main_path: bool, reps: int | None = None,
              plain_reps: int = 5, f32_scales: bool = False, layout: str = "ilv",
              dot: str = "bf16", mul: torch.dtype = torch.float32, chunks: int = 1) -> dict:
    """K1 against its plain version at (name, M), in a layout, dot mode and
    multiply type, over a weight packed in `chunks` K slices (one launch
    each, the partials summed in f32): within 2 K 2^-24 max_n sum_k
    |x_k w_kn| (w as the mode forms it; a chunked sum is two such sums and
    their f32 sum). The library call is torch.matmul on the mode's
    dequantized weight: bf16, or f32 (TF32 off) for the f32 dot. A GEMV
    row (M = 1) also carries the CUDA kernels each launch of the wrapper
    made (`cuda_launches`, which must be 1: the K split is merged inside the
    launch), its K ranges (`splits`) and the replaced GEMV's time of the
    same row (`parent_ms`, from tools/bench_gemv_runs.jsonl; None where
    that file has none)."""
    from llamavk_tpu_torch.ops import q4_matmul as q4

    k, n = ALL_K1_SHAPES[name]
    x, qw = _q4_case(gen, m, k, n, f32_scales, layout, chunks)

    def kernel():
        return q4.q4_matmul_cuda(x, qw.packed, qw.scales, layout, dot, mul, chunks)

    c_before, w_before = q4.cuda_launches(), sum(q4.launches.values())
    got = kernel()
    per_launch = (q4.cuda_launches() - c_before) / (sum(q4.launches.values()) - w_before)
    want = q4.q4_matmul_ref(x, qw, out_dtype=torch.float32, dot_mode=dot, mul_dtype=mul)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    # both sum the same products (exact in f32) in f32, in different orders:
    # each sum is within (K-1) u sum_k |x_k w_kn| of the exact one (u = 2^-24)
    w = q4.mode_weight(qw, dot, mul)
    mag = float((x.float().abs() @ w.abs()).max())
    limit = 2 * k * 2.0**-24 * mag
    w_f32 = dot == "f32" and mul == torch.float32
    round_s = f32_scales and mul == torch.bfloat16
    ms = timer(kernel, reps)
    plain_ms = timer(lambda: q4.q4_matmul_ref(x, qw, out_dtype=torch.float32, dot_mode=dot,
                                              mul_dtype=mul), reps=plain_reps)
    if w_f32:
        xf = x.float()
        library_ms = timer(lambda: torch.matmul(xf, w), reps)
    else:
        w_bf16 = w.to(torch.bfloat16)
        library_ms = timer(lambda: torch.matmul(x, w_bf16), reps)
    n_bytes = m * k * 2 + k // 2 * n + k // 32 * n * qw.scales.element_size() + m * n * 4
    if w_f32 and f32_scales and m == 1:  # the GEMV's fmaf products, on the CUDA cores
        b_ms, b_by = bound(n_bytes, 2.0 * m * k * n, F32_FLOP_PER_S)
    else:  # the tensor cores: the f32 dot one bf16 pass per part (three over f32 scales)
        passes = (3 if f32_scales else 2) if w_f32 else 1
        b_ms, b_by = bound(n_bytes, 2.0 * m * k * n * passes)
    mode = " ".join(filter(None, [layout if layout != "ilv" else "",
                                  "f32 scales" if f32_scales else "",
                                  "dot f32" if dot == "f32" else "",
                                  "mul bf16" if mul == torch.bfloat16 else "",
                                  f"{chunks} chunks" if chunks > 1 else ""]))
    row = {
        "kernel": "q4_" + q4.launch_key(m, layout == "lin", f32_scales, round_s, w_f32,
                                        chunks > 1),
        "shape": f"{name} M={m} K={k} N={n}" + (f" {mode}" if mode else ""),
        "main_path": main_path,
        "max_abs_err": err, "limit": limit, "err_over_limit": err / limit,
        "ok": err <= limit,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": library_ms,
    }
    if m == 1:
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        row["cuda_launches"] = per_launch
        row["splits"] = q4.gemv_splits(k // chunks, n, sms)
        row["parent_ms"] = _gemv_parent().get((bench_gemm.mode_name(
            layout, f32_scales, dot, "bf16" if mul == torch.bfloat16 else "f32")
            + (f" {chunks} chunks" if chunks > 1 else ""), name, 1))
        row["ok"] = row["ok"] and per_launch == 1
    return row


# the replaced GEMV's time of each M = 1 row: tools/bench_gemm.py --ms 1
# --tp2 run on the parent commit 091761e and on this kernel, alternated in
# one call (NVIDIA H100 80GB HBM3, 700.00 W), keyed (mode, shape, M)
GEMV_RUNS = ROOT / "llamavk_tpu_torch" / "tools" / "bench_gemv_runs.jsonl"


@functools.cache
def _gemv_parent() -> dict:
    """The median over the file's parent runs of each (mode, shape, M)."""
    runs: dict = {}
    if GEMV_RUNS.exists():
        for line in GEMV_RUNS.read_text().splitlines():
            r = json.loads(line)
            if r["tree"] == "parent":
                runs.setdefault((r["mode"], r["shape"], r["m"]), []).append(r["ms"])
    return {key: statistics.median(v) for key, v in runs.items()}


# K1's modes as (layout, f32 scales, dot, multiply type)
K1_MODES = [(layout, f32s, dot, torch.bfloat16 if mul == "bf16" else torch.float32)
            for layout, f32s, dot, mul in bench_gemm.MODES]


def kernel_q4_weight_bits(gen) -> dict:
    """The GEMM's and the GEMV's dequantized weights against `mode_weight`'s,
    bit for bit, in every mode on every route: x one-hot rows, so out[i] is
    row k_i of the weight the kernel fed the tensor cores (one nonzero
    product a sum, exact). M = 64 (the GEMM's split-K route) and the GEMV
    (M = 1, one launch a k, its splits merged in the launch) take every k of
    the first and the last 32-k group (both lin halves); M = K = 4096 (the
    large route) every k. The GEMM's f32 dot over f32 scales feeds three
    bf16 parts (w to 2^-27 |w|), whose f32 sum on the tensor cores rounds
    once more (2^-23 |w| if it truncates): that mode is held to 2^-22 max
    |w| (the GEMV multiplies the exact f32 w there: bit for bit). Then
    the GEMV's determinism: at each 7B shape, in every mode, two launches on
    the same inputs are bit-equal."""
    from llamavk_tpu_torch.ops import q4_matmul as q4

    k, n = K1_SHAPES["wo"]
    out = {}
    edge = torch.cat([torch.arange(32), torch.arange(k - 32, k)]).cuda()
    for layout, f32s, dot, mul in K1_MODES:
        _, qw = _q4_case(gen, 1, k, n, f32s, layout)
        w = q4.mode_weight(qw, dot, mul)
        three_parts = dot == "f32" and f32s and mul == torch.float32
        for m in (1, 64, k):
            rows = torch.arange(k, device="cuda") if m == k else edge
            x = torch.zeros((len(rows), k), device="cuda", dtype=torch.bfloat16)
            x[torch.arange(len(rows), device="cuda"), rows] = 1
            if m == 1:
                got = torch.cat([q4.q4_matmul_cuda(x[i : i + 1], qw.packed, qw.scales, layout,
                                                   dot, mul) for i in range(len(rows))])
            else:
                got = q4.q4_matmul_cuda(x, qw.packed, qw.scales, layout, dot, mul)
            want = w[rows]
            diff = float((got - want).abs().max())
            lim = float(want.abs().max()) * 2.0**-22 if three_parts and m > 1 else 0.0
            name = f"{layout} {'f32' if f32s else 'bf16'} scales dot {dot} mul {mul} M={m}"
            out[name] = {"max_abs_diff": diff, "bit_equal": bool(torch.equal(got, want)),
                         "ok": diff <= lim}
    for name, (k, n) in K1_SHAPES.items():
        x, qw = _q4_case(gen, 1, k, n, True)
        planes = {False: qw.scales.to(torch.bfloat16), True: qw.scales}
        for layout, f32s, dot, mul in K1_MODES:
            a, b = (q4.q4_matmul_cuda(x, qw.packed, planes[f32s], layout, dot, mul)
                    for _ in range(2))
            mode = f"{layout} {'f32' if f32s else 'bf16'} scales dot {dot} mul {mul}"
            out[f"deterministic {name} {mode} M=1"] = {"bit_equal": bool(torch.equal(a, b)),
                                                       "ok": bool(torch.equal(a, b))}
    torch.cuda.synchronize()
    bad = [name for name, r in out.items() if not r["ok"]]
    if bad:
        raise SystemExit(f"K1's dequantized weights differ from mode_weight's, or a GEMV "
                         f"launch is not deterministic: {bad}")
    return out


def kernel_q4_i8(timer: Timer, gen, name: str, m: int, main_path: bool,
                 reps: int | None = None, plain_reps: int = 3, f32_scales: bool = False,
                 chunks: int = 1) -> dict:
    """K5 against its plain version at (name, M), over a weight packed in
    `chunks` K slices: the activation bytes and scales bit-equal to the
    plain quantization on the card, the output within the sum-order bound
    G 2^-24 sum_g |d sx s| per element (d is exact on both sides; each
    chunk's groups with their own nibbles), each row bit-equal to the same
    row computed alone (M = 1) at the edges of the kernel's 8-row token
    tiles (rows 0, 7, 8 and M - 1); where the route sends the shape to K1
    (w2 past 16 rows), the check is that q4_matmul launched K1 and not K5.
    `parent_ms` is the replaced dp4a kernel's time of the row
    (tools/bench_i8_runs.jsonl), None where that file has none."""
    from llamavk_tpu_torch.ops import q4_matmul as q4
    from llamavk_tpu_torch.ops.qweight import dequantize_qweight

    k, n = ALL_K1_SHAPES[name]
    x, qw = _q4_case(gen, m, k, n, f32_scales, chunks=chunks)
    shape = (f"{name} M={m} K={k} N={n}" + (" f32 scales" if f32_scales else "")
             + (f" {chunks} chunks" if chunks > 1 else ""))
    if not q4.i8_route("i8", m, k, n, qw):
        before = dict(q4.launches)
        q4.q4_matmul(x, qw, torch.float32, dot_mode="i8")
        torch.cuda.synchronize()
        took = {key: q4.launches[key] - before[key] for key in before}
        for key in before:  # a check, not a main-path launch
            q4.launches[key] = before[key]
        k1 = ("gemm" if m > 1 else "gemv") + ("_f32" if f32_scales else "")
        ok = took["i8"] == took["i8_f32"] == 0 and took[k1] == 1
        return {"kernel": "q4_i8_route", "shape": shape, "route": "K1", "launched": took,
                "ok": ok}
    got = q4.q4_matmul_i8_cuda(x, qw.packed, qw.scales, chunks)
    want = q4.q4_matmul_i8_ref(x, qw)
    xq, sx = q4.quantize_act_blocks_cuda(x)
    pxq, psx = q4.quantize_act_blocks(x)
    quant_equal = torch.equal(xq, pxq) and torch.equal(sx, psx)
    rows_equal = all(torch.equal(q4.q4_matmul_i8_cuda(x[r : r + 1].contiguous(), qw.packed,
                                                      qw.scales, chunks)[0], got[r])
                     for r in sorted({r for r in (0, 7, 8, m - 1) if r < m}))
    gc = qw.g // chunks
    terms = sum(
        (torch.einsum("mgb,mgn->gbn", pxq[:, c * gc : (c + 1) * gc].double(),
                      q4._nibbles(qw.chunk(c).packed, gc).double())
         * psx[c * gc : (c + 1) * gc].double()[:, :, None]
         * qw.chunk(c).scales.double()[:, None, :]).abs().sum(0)
        for c in range(chunks))
    limit = qw.g * 2.0**-24 * terms
    del terms
    diff = (got.double() - want.double()).abs()
    ratio = float(torch.where(limit > 0, diff / limit.clamp_min(1e-300),
                              diff * float("inf")).nan_to_num(0.0).max())
    err = float(diff.max())
    w_bf16 = dequantize_qweight(qw).to(torch.bfloat16)
    ms = timer(lambda: q4.q4_matmul_i8_cuda(x, qw.packed, qw.scales, chunks), reps)
    plain_ms = timer(lambda: q4.q4_matmul_i8_ref(x, qw), reps=plain_reps)
    library_ms = timer(lambda: torch.matmul(x, w_bf16), reps)
    g = k // 32
    n_bytes = k // 2 * n + g * n * qw.scales.element_size() + m * k + 4 * g * m + 4 * m * n
    b_ms, b_by = bound(n_bytes, 2.0 * m * k * n, INT8_OP_PER_S)
    return {
        "kernel": "q4_" + q4.i8_key(f32_scales, chunks > 1), "shape": shape,
        "main_path": main_path, "route": "K5", "token_tiles": q4.i8_token_tiles(m),
        "ksplit": q4.i8_splits(k, n), "max_abs_err": err,
        "limit": "G * 2^-24 * sum_g |d * sx * s| per element", "err_over_limit": ratio,
        "xq_sx_bit_equal": quant_equal, "rows_bit_equal_to_m1": rows_equal,
        "ok": ratio <= 1.0 and quant_equal and rows_equal,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": library_ms, "library_factor": ms / library_ms,
        "parent_ms": None if chunks > 1 else _i8_parent().get(
            ("f32 scales" if f32_scales else "bf16 scales", name, m)),
    }


# the replaced dp4a K5's time of each row: tools/bench_i8.py run on the
# parent commit 2fd3b78 and on this kernel, alternated in one call (NVIDIA
# H100 80GB HBM3, 700.00 W), keyed (mode, shape, M)
I8_RUNS = ROOT / "llamavk_tpu_torch" / "tools" / "bench_i8_runs.jsonl"


@functools.cache
def _i8_parent() -> dict:
    """The median over the file's parent runs of each (mode, shape, M)."""
    runs: dict = {}
    if I8_RUNS.exists():
        for line in I8_RUNS.read_text().splitlines():
            r = json.loads(line)
            if r["tree"] == "parent":
                runs.setdefault((r["mode"], r["shape"], r["m"]), []).append(r["ms"])
    return {key: statistics.median(v) for key, v in runs.items()}


def _sdpa_call(q, k, v, n_past, layer: int, k_scale=None, v_scale=None):
    """One PyTorch call for the same attention, as a closure: the cache's
    visible rows (an int8 cache dequantized to a bf16 copy first), and an
    explicit causal mask offset by each row's n_past, both made before the
    call; over an f32 cache, on f32 operands."""
    from llamavk_tpu_torch.ops.kv_quant import dequantize_rows

    b, t = q.shape[:2]
    npv = torch.as_tensor(n_past, device=q.device).to(torch.int64).expand(b)
    kv = int(npv.max()) + t
    kl, vl = k[layer, :, :, :kv], v[layer, :, :, :kv]
    if k_scale is not None:
        kl = dequantize_rows(kl, k_scale[layer, :, :kv].transpose(1, 2)).to(torch.bfloat16)
        vl = dequantize_rows(vl, v_scale[layer, :, :kv].transpose(1, 2)).to(torch.bfloat16)
    mask = (torch.arange(kv, device=q.device)[None, None, :]
            <= npv[:, None, None] + torch.arange(t, device=q.device)[None, :, None])
    qh = q.transpose(1, 2).to(kl.dtype)  # [B, H, T, D]
    return lambda: torch.nn.functional.scaled_dot_product_attention(qh, kl, vl,
                                                                    attn_mask=mask[:, None])


@contextlib.contextmanager
def _cuda_core_route():
    """K2, K3 and K4 on the CUDA-core route at every T (the route every
    prefill took before the tensor-core route, and every decode step and
    verify round before the split route), to time it beside the other routes
    in the same call: the wrappers read `attn_route` at each call."""
    from llamavk_tpu_torch.ops import flash_attn as fa

    route = fa.attn_route
    fa.attn_route = lambda t, kind: "cuda_core"
    try:
        yield
    finally:
        fa.attn_route = route


def _route_times(timer, run, row: dict, t: int, kind: str) -> None:
    """The attention route a call at T over a `kind` cache takes
    (`attn_route`), and on the tensor-core and split routes the same call's
    time on the CUDA-core route (`cuda_core_ms`)."""
    from llamavk_tpu_torch.ops import flash_attn as fa

    row["attn_route"] = fa.attn_route(t, kind)
    if row["attn_route"] in ("tensor_core", "split"):
        with _cuda_core_route():
            row["cuda_core_ms"] = timer(run)
    if row["attn_route"] == "split":  # the row write and the attention: one launch
        row["attention_launches_per_call"] = n = _attention_launches(run)
        row["ok"] = row["ok"] and n == 1


def _attn_bound(n_bytes: float, ops: float, kind: str, t: int,
                bf16_ops: float = 0.0) -> tuple[float, str]:
    """`bound` of an attention call at T over a `kind` cache on its route:
    bf16 tensor-core operations (an int8 cache's widened to bf16); over an
    f32 cache on the tensor cores three TF32 passes a product, elsewhere
    the CUDA cores' f32 rate. `bf16_ops` (a prefix pool's pass, bf16 over
    any slot type) run at the bf16 rate beside them."""
    from llamavk_tpu_torch.ops import flash_attn as fa

    if kind != "f32":
        return bound(n_bytes, ops + bf16_ops, BF16_OP_PER_S)
    passes, peak = ((3.0, TF32_OP_PER_S) if fa.attn_route(t, kind) == "tensor_core"
                    else (1.0, F32_FLOP_PER_S))
    return bound(n_bytes, passes * ops + bf16_ops * peak / BF16_OP_PER_S, peak)


def _attention_launches(run) -> int:
    """The CUDA kernels one call of `run` launches from the attention
    libraries (`cuda_launches` of ops/flash_attn.py and flash_decode.py)."""
    from llamavk_tpu_torch.ops import flash_attn as fa
    from llamavk_tpu_torch.ops import flash_decode as fd

    before = fa.cuda_launches() + fd.cuda_launches()
    run()
    return fa.cuda_launches() + fd.cuda_launches() - before


def _splits(row: dict, t: int, n_past, b: int, cap: int, bk: int, plens=None,
            pool_bk: int = 0, ring_rows: int | None = None) -> None:
    """On the split route (T 1-15), the row's `split_rows` and `splits`:
    the split blocks that attend, per head, summed over the batch rows (a
    row's rows [0, min(n_past + T, cap)); the pool's splits of `plens`
    included; an unbounded ring's `ring_rows`)."""
    from llamavk_tpu_torch.ops import flash_attn as fa

    if fa.attn_route(t, "bf16") != "split":
        return
    pasts = n_past if isinstance(n_past, list) else [n_past] * b
    n = sum(len(fa.split_schedule(ring_rows or min(p + t, cap), bk)) for p in pasts)
    if plens is not None:
        n += sum(len(fa.split_schedule(pl, pool_bk)) for pl in plens)
    row["split_rows"], row["splits"] = fa.split_rows(bk), n


def _attn_sizes(b: int, t: int, n_past, update: bool, quant: bool,
                f32: bool = False, h: int = H) -> tuple[float, float]:
    """Bytes and operations one call needs: q read, the f32 output written,
    QK and PV over each query's visible keys. A cached position of K or V
    is h * D elements, h the call's heads (H, or a tp rank's share of them;
    1 byte for int8, plus h f32 scales; 2 for bf16; 4 for f32, whose q and
    new rows are f32 too). The update functions read the
    n_past earlier positions from the cache and the T new ones from
    k_new/v_new, and write the new ones to the cache; the read function
    reads all n_past + T positions from the cache. n_past is one int for
    every row or a list, one per row."""
    pasts = n_past if isinstance(n_past, list) else [n_past] * b
    qb = 4 if f32 else 2
    pos = h * D * (1 if quant else qb) + (h * 4 if quant else 0)
    visible = sum(p + i + 1 for p in pasts for i in range(t))
    n_bytes = b * t * h * D * (qb + 4)
    if update:
        n_bytes += sum(2 * p * pos for p in pasts) + 2 * b * t * (h * D * qb + pos)
    else:
        n_bytes += sum(2 * (p + t) * pos for p in pasts)
    return n_bytes, 4.0 * h * D * visible


# online softmax (kernel) against a dense softmax (plain version), both on
# the same bf16-rounded scaled q: each side rounds every probability (times
# its value scale, int8) to bf16 (relative error <= 2^-8, an 8-bit
# significand), relative to the running max (kernel) or the row's max
# (plain version), before the PV product, so an output
# element may differ by 2^-7 of sum_j p_j |v_j| / l. The f32 differences in
# the scores and sums are orders of magnitude smaller; the limit is twice the
# bound, element by element.
ATTN_REL = 2.0**-6
ATTN_LIMIT_RULE = "2^-6 * attention(q, k, |v|) per element (v dequantized for int8)"
# an f32 cache rounds nothing to bf16: what is left is the f32 summation
# order of the scores (at most D 2^-24 sum_d |q_d k_d|, ~6e-5 at unit scores
# of D = 128), of l and of the PV sum (S 2^-24 each, ~3e-5 at S = 512), on
# each side; 2^-12 (2.4e-4) covers twice their sum, 64 times tighter than
# the bf16 limit. The tensor-core route (T >= 16) sums three TF32 passes a
# product (each operand's hi and lo parts): ~2^-21 of |q_d k_d| and of
# |p v| a product, well inside the same limit (F32_TC_MAX_ERR_OVER_LIMIT)
F32_ATTN_REL = 2.0**-12
F32_ATTN_LIMIT_RULE = "2^-12 * attention(q, k, |v|) per element (f32 cache)"


def _attn_err(got, want, q, k, v, n_past, layer: int, k_scale=None,
              v_scale=None, page_table=None, **mode) -> tuple[float, float]:
    """(max |got - want|, the largest ratio of an element's error to its own
    limit) for attention outputs over layer `layer` of the cache (or pool)
    k, v (the f32 limit over an f32 cache); `mode` the ring's or the prefix
    pool's operands (the pool's values taken as |v| too)."""
    from llamavk_tpu_torch.ops import flash_attn as fa

    if "prefix_v" in mode:
        mode = {**mode, "prefix_v": mode["prefix_v"].abs()}
    # f32 slots under a bf16 pool: the pool's rows round q and p to bf16
    rel = F32_ATTN_REL if k.dtype == torch.float32 and "prefix_v" not in mode else ATTN_REL
    lim = rel * fa.flash_attention_ref(q, k, v.abs(), n_past, layer_idx=layer,
                                            k_scale=k_scale, v_scale=v_scale,
                                            page_table=page_table, **mode)
    err = (got - want).abs()
    return float(err.max()), float((err / lim.clamp_min(1e-30)).max())


def _kv_cache(gen, shape, quant: bool, f32: bool = False) -> list:
    """Random cache planes for `shape` [L, B, H, S, D]: bf16 N(0, 1) values,
    or the int8 rows and [L, B, S, H] scales of such values, or (`f32`) f32
    N(0, 1) values."""
    from llamavk_tpu_torch.ops.kv_quant import quantize_rows

    dtype = torch.float32 if f32 else torch.bfloat16
    planes = [torch.empty(shape, dtype=dtype, device="cuda").normal_(generator=gen)
              for _ in range(2)]
    if not quant:
        return planes
    qs = [quantize_rows(x) for x in planes]
    return [q for q, _ in qs] + [s.transpose(2, 3).contiguous() for _, s in qs]


def _scales(planes) -> dict:
    return dict(k_scale=planes[2], v_scale=planes[3]) if len(planes) == 4 else {}


def kernel_attn(timer: Timer, gen, t: int, n_past, update: bool, main_path: bool,
                b: int = 1, quant: bool = False, s: int = N_CTX, bk: int | None = None,
                f32: bool = False, h: int = H) -> dict:
    """K2 (update) or K3 (read) against its plain version on a random cache
    of S rows (bf16, int8, or `f32`) at block_k `bk` (llama_forward's
    default when None), over h heads (a tp rank's H / tp, or H). n_past is one int, or a list of one per row (passed
    as an int32 vector). q and the new rows are bf16, as the engines'
    activations are (the wrappers widen them to f32 over an f32 cache)."""
    from llamavk_tpu_torch.ops import flash_attn as fa

    layers = 2
    layer = 1  # a layer past the first: the wrapper offsets into the stack
    planes = _kv_cache(gen, (layers, b, h, s, D), quant, f32)
    q, kn, vn = (torch.randn((b, t, h, D), device="cuda", generator=gen).to(torch.bfloat16)
                 for _ in range(3))
    bk = bk or (512 if t >= 256 else 256)  # llama_forward's default KV block
    npast = (torch.tensor(n_past, dtype=torch.int32, device="cuda")
             if isinstance(n_past, list) else n_past)
    k, v, sc = planes[0], planes[1], _scales(planes)
    if update:
        p2 = [x.clone() for x in planes]
        got = fa.flash_attention_update(q, kn, vn, k, v, npast, layer, block_k=bk, **sc)[0]
        want = fa.flash_attention_update_ref(q, kn, vn, p2[0], p2[1], npast, layer,
                                             **_scales(p2))[0]
        torch.cuda.synchronize()
        cache_equal = all(torch.equal(x, y) for x, y in zip(planes, p2))
        run = lambda: fa.flash_attention_update(q, kn, vn, k, v, npast, layer,  # noqa: E731
                                                block_k=bk, **sc)
        plain = lambda: fa.flash_attention_update_ref(q, kn, vn, p2[0], p2[1],  # noqa: E731
                                                      npast, layer, **_scales(p2))
    else:
        fa.write_rows(kn, vn, k, v, npast, layer, *planes[2:])
        got = fa.flash_attention(q, k, v, npast, layer_idx=layer, block_k=bk, **sc)
        want = fa.flash_attention_ref(q, k, v, npast, layer_idx=layer, **sc)
        torch.cuda.synchronize()
        cache_equal = True
        run = lambda: fa.flash_attention(q, k, v, npast, layer_idx=layer,  # noqa: E731
                                         block_k=bk, **sc)
        plain = lambda: fa.flash_attention_ref(q, k, v, npast, layer_idx=layer,  # noqa: E731
                                               **sc)
    err, ratio = _attn_err(got, want, q, k, v, npast, layer, *planes[2:])
    kind = "int8" if quant else "f32" if f32 else "bf16"
    row = {
        "kernel": "attn_" + fa.launch_name("update" if update else "read", kind, False,
                                           route=fa.attn_route(t, kind)),
        "shape": f"B={b} T={t} n_past={n_past} H={h} D={D} S={s} block_k={bk}"
                 + (" int8" if quant else "") + (" f32" if f32 else ""),
        "main_path": main_path,
        "max_abs_err": err, "limit": F32_ATTN_LIMIT_RULE if f32 else ATTN_LIMIT_RULE,
        "err_over_limit": ratio,
        "cache_bytes_equal": cache_equal, "ok": ratio <= 1.0 and cache_equal,
        "ms": timer(run), "plain_ms": timer(plain, reps=5),
    }
    _route_times(timer, run, row, t, kind)
    _splits(row, t, n_past, b, s, bk)
    row["library_ms"] = timer(_sdpa_call(q, k, v, npast, layer, *planes[2:]))
    row["bound_ms"], row["bound_by"] = _attn_bound(
        *_attn_sizes(b, t, n_past, update, quant, f32, h), kind, t)
    return row


def kernel_attn_pp(timer: Timer, gen, path: str, b: int, t: int, n_past, b_cache: int,
                   boff: int, quant: bool, main_path: bool, commit: int = 1,
                   s: int = N_CTX, bk: int | None = None, h: int = H,
                   f32: bool = False) -> dict:
    """K2 (`path` "update"), K3 ("read") or K4 ("decode") on B rows at
    `batch_offset` boff of a random flat cache of B_cache rows (bf16, int8
    or `f32`), or K2 with commit=0: against its plain version (the limit of
    `kernel_attn`); bit-equal, outputs and rows, to the same call on a copy
    of just the offset rows; every other cache row unchanged; with commit=0,
    every cache byte unchanged and the output bit-equal to K3 over the
    same rows. n_past is one int or a list (an int32 vector); h heads."""
    from llamavk_tpu_torch.ops import flash_attn as fa
    from llamavk_tpu_torch.ops import flash_decode as fd

    layer = 1
    planes = _kv_cache(gen, (2, b_cache, h, s, D), quant, f32)
    q, kn, vn = (torch.randn((b, t, h, D), device="cuda", generator=gen).to(torch.bfloat16)
                 for _ in range(3))
    npast = (torch.tensor(n_past, dtype=torch.int32, device="cuda")
             if isinstance(n_past, list) else n_past)
    bk = bk or (512 if t >= 256 else 256)
    if path == "read":  # K3 reads rows the caller wrote
        rows = [x[:, boff : boff + b] for x in planes]
        fa.write_rows(kn, vn, rows[0], rows[1], npast, layer, *rows[2:])

    def call(pl, off: int, ref: bool = False):
        sc = _scales(pl)
        if path == "update":
            f = fa.flash_attention_update_ref if ref else fa.flash_attention_update
            return f(q, kn, vn, pl[0], pl[1], npast, layer, block_k=bk, commit=commit,
                     batch_offset=off, **sc)[0]
        if path == "read":
            f = fa.flash_attention_ref if ref else fa.flash_attention
            return f(q, pl[0], pl[1], npast, layer_idx=layer, block_k=bk, batch_offset=off,
                     **sc)
        f = fd.flash_decode_update_ref if ref else fd.flash_decode_update
        return f(q, kn, vn, pl[0], pl[1], npast, layer, block_k=bk, batch_offset=off, **sc)[0]

    before = [x.clone() for x in planes]
    part = [x[:, boff : boff + b].clone() for x in planes]
    plain = [x.clone() for x in planes]
    got = call(planes, boff)
    alone = call(part, 0)
    want = call(plain, boff, ref=True)
    torch.cuda.synchronize()
    rows_equal = torch.equal(got, alone) and all(
        torch.equal(x[:, boff : boff + b], y) for x, y in zip(planes, part))
    others = all(torch.equal(x[:, :boff], y[:, :boff])
                 and torch.equal(x[:, boff + b :], y[:, boff + b :])
                 for x, y in zip(planes, before))
    checks = {"bit_equal_to_offset_rows": rows_equal, "other_rows_unchanged": others,
              "cache_bytes_equal_to_plain": all(torch.equal(x, y) for x, y in zip(planes, plain))}
    if not commit:
        checks["cache_unchanged"] = all(torch.equal(x, y) for x, y in zip(planes, before))
        checks["bit_equal_to_read_kernel"] = torch.equal(got, fa.flash_attention(
            q, planes[0], planes[1], npast, layer_idx=layer, block_k=bk, batch_offset=boff,
            **_scales(planes)))
    view = [x[:, boff : boff + b] for x in planes]
    err, ratio = _attn_err(got, want, q, view[0], view[1], npast, layer, *view[2:])
    kind = "int8" if quant else "f32" if f32 else "bf16"
    mode = "boff" if commit else "nocommit"
    row = {
        "kernel": ("decode_" + mode + {"bf16": "", "int8": "_i8", "f32": "_f32"}[kind])
                  if path == "decode"
                  else "attn_" + fa.launch_name(path, kind, False, mode=mode,
                                                route=fa.attn_route(t, kind)),
        "shape": f"B={b} of {b_cache} at batch_offset={boff} T={t} n_past={n_past} H={h} D={D} "
                 f"S={s} block_k={bk}" + ("" if kind == "bf16" else f" {kind}")
                 + ("" if commit else " commit=0"),
        "main_path": main_path, "max_abs_err": err,
        "limit": F32_ATTN_LIMIT_RULE if f32 else ATTN_LIMIT_RULE,
        "err_over_limit": ratio, **checks, "ok": ratio <= 1.0 and all(checks.values()),
        "ms": timer(lambda: call(planes, boff)),
        "plain_ms": timer(lambda: call(plain, boff, ref=True), reps=5),
    }
    _route_times(timer, lambda: call(planes, boff), row, t, kind)
    _splits(row, t, n_past, b, s, bk)
    row["library_ms"] = timer(_sdpa_call(q, view[0], view[1], npast, layer, *view[2:]))
    row["bound_ms"], row["bound_by"] = _attn_bound(
        *_attn_sizes(b, t, n_past, path != "read" and bool(commit), quant, f32, h), kind, t)
    return row


def kernels_parallel(timer: Timer, gen, gen_cpu) -> list[dict]:
    """The kernel modes of the parallel paths at 7B width: K1 over wo and
    w2 packed in 2 chunks (tp = 2 packing run whole: parallel_7b's and
    serve_7b_tp's single-device references) at M = 1 and the 32-token
    prompt, K5 over them at M = 1 and 4; K1 at one tp = 2 rank's shapes
    (GEMV, and GEMM at the 32-token prompt); K2 with batch_offset at the
    pp = 2 microbatches' shapes (2 of 4 rows at offset 2: the prompt and a
    decode step; int8 too), K2 with commit=0, K3 and K4 with batch_offset
    (no path reaches them)."""
    rows = []
    for m in (1, 32):
        for name in ("wo", "w2"):
            rows.append(kernel_q4(timer, gen, name, m, True, chunks=2))
            emit({"phase": "kernel", **rows[-1]})
    for m in (1, 4):
        for name in ("wo", "w2"):
            rows.append(kernel_q4_i8(timer, gen, name, m, False, chunks=2))
            emit({"phase": "kernel", **rows[-1]})
    for m in (1, 32):
        for name in K1_SHAPES_TP2:
            if m > 1 and name == "output/tp2":
                continue  # the logits of the last row only
            rows.append(kernel_q4(timer, gen, name, m, True))
            emit({"phase": "kernel", **rows[-1]})
    npl = _decode_npast(16, N_CTX, gen_cpu)
    for args, kw in (
            (("update", 2, 32, 0, 4, 2, False, True), {}),
            (("update", 2, 1, [32, 35], 4, 2, False, True), {}),
            (("update", 2, 32, 0, 4, 2, True, False), {}),
            (("update", 4, 1, [5, 100, 300, 480], 4, 0, False, False), {"commit": 0}),
            (("update", 4, 32, 0, 4, 0, True, False), {"commit": 0}),
            (("read", 2, 301, 159, 4, 2, False, False), {}),
            (("read", 2, 301, 159, 4, 2, True, False), {}),
            (("decode", 16, 1, npl, 32, 16, False, False), {}),
            (("decode", 16, 1, npl, 32, 16, True, False), {})):
        rows.append(kernel_attn_pp(timer, gen, *args, **kw))
        emit({"phase": "kernel", **rows[-1]})
    return rows


def _decode_npast(b: int, s: int, gen_cpu) -> list[int]:
    """Per-row n_past, seeded in [0, s - 1], with 0, s/2 - 1, s/2 and s - 1."""
    npl = torch.randint(0, s, (b,), generator=gen_cpu).tolist()
    npl[:4] = [0, s // 2 - 1, s // 2, s - 1][: min(4, b)]
    return npl


def kernel_decode(timer: Timer, gen, gen_cpu, b: int, quant: bool, main_path: bool,
                  h: int = H, d: int = D, s: int = N_CTX, bk: int = 256,
                  f32: bool = False) -> dict:
    """K4 against its plain version, and against K2 at T = 1 row by row at
    the same block_k: outputs and every cache plane bit-equal. `f32`: an
    f32 cache (bf16 q and new rows, widened by the wrappers)."""
    from llamavk_tpu_torch.ops import flash_attn as fa
    from llamavk_tpu_torch.ops import flash_decode as fd

    layer = 1
    npl = _decode_npast(b, s, gen_cpu)
    npast = torch.tensor(npl, dtype=torch.int32, device="cuda")
    planes = _kv_cache(gen, (2, b, h, s, d), quant, f32)
    q, kn, vn = (torch.randn((b, 1, h, d), device="cuda", generator=gen).to(torch.bfloat16)
                 for _ in range(3))
    p1, p2 = [x.clone() for x in planes], [x.clone() for x in planes]
    got = fd.flash_decode_update(q, kn, vn, p1[0], p1[1], npast, layer, block_k=bk,
                                 **_scales(p1))[0]
    want = fd.flash_decode_update_ref(q, kn, vn, p2[0], p2[1], npast, layer, block_k=bk,
                                      **_scales(p2))[0]
    torch.cuda.synchronize()
    cache_equal = all(torch.equal(x, y) for x, y in zip(p1, p2))
    k2_equal = True
    for r in range(b):
        pr = [x[:, r : r + 1].contiguous() for x in planes]
        out_r = fa.flash_attention_update(q[r : r + 1], kn[r : r + 1], vn[r : r + 1], pr[0],
                                          pr[1], npl[r], layer, block_k=bk, **_scales(pr))[0]
        k2_equal &= bool(torch.equal(out_r[0], got[r])) and all(
            torch.equal(x[:, 0], y[:, r]) for x, y in zip(pr, p1))
    err, ratio = _attn_err(got, want, q, p1[0], p1[1], npast, layer, *p1[2:])
    row = {
        "kernel": "decode" + ("_i8" if quant else "") + ("_f32" if f32 else ""),
        "shape": f"B={b} n_past={min(npl)}..{max(npl)} H={h} D={d} S={s} block_k={bk}"
                 + (" int8" if quant else "") + (" f32" if f32 else ""),
        "main_path": main_path,
        "max_abs_err": err, "limit": F32_ATTN_LIMIT_RULE if f32 else ATTN_LIMIT_RULE,
        "err_over_limit": ratio,
        "cache_bytes_equal": cache_equal, "bit_equal_to_update_kernel": k2_equal,
        "ok": ratio <= 1.0 and cache_equal and k2_equal,
    }
    if timer is None:
        return row
    run = lambda: fd.flash_decode_update(q, kn, vn, p1[0], p1[1], npast, layer,  # noqa: E731
                                         block_k=bk, **_scales(p1))
    row["ms"] = timer(run)
    row["plain_ms"] = timer(lambda: fd.flash_decode_update_ref(
        q, kn, vn, p2[0], p2[1], npast, layer, block_k=bk, **_scales(p2)), reps=5)
    _route_times(timer, run, row, 1, "int8" if quant else "f32" if f32 else "bf16")
    _splits(row, 1, npl, b, s, bk)
    row["library_ms"] = timer(_sdpa_call(q, p1[0], p1[1], npast, layer, *p1[2:]))
    row["bound_ms"], row["bound_by"] = bound(*_attn_sizes(b, 1, npl, True, quant, f32, h),
                                             F32_FLOP_PER_S if f32 else BF16_OP_PER_S)
    return row


def _paged_case(gen, gen_cpu, b: int, quant: bool, s: int, ps: int, h: int = H,
                d: int = D, f32: bool = False) -> tuple[list, torch.Tensor]:
    """Random two-layer pool planes (bf16, int8 or f32) of b * s/ps pages and
    3 more, and a scrambled [B, s/ps] table that maps no page twice and
    never page 0 (the serving engine's trash page)."""
    maxlb = s // ps
    n_pages = b * maxlb + 3
    planes = _kv_cache(gen, (2, n_pages, h, ps, d), quant, f32)
    pages = torch.randperm(n_pages - 1, generator=gen_cpu)[: b * maxlb] + 1
    return planes, pages.reshape(b, maxlb).to(torch.int32).cuda()


def _gathered(planes, table) -> list:
    """The flat cache [L, B, H, S, D] (scales [L, B, S, H]) that the table's
    rows see in pool planes: the kernels' logical view, as a copy."""
    from llamavk_tpu_torch.ops import flash_attn as fa

    return [torch.stack([fa.gather_pages(p[l], table) for l in range(p.shape[0])])
            for p in planes]


def _untouched_equal(planes, before, table, n_past, t: int, ps: int) -> bool:
    """Every page but those rows [n_past, n_past + t) of each table row fall
    in keeps its bytes."""
    pasts = n_past if isinstance(n_past, list) else [n_past] * table.shape[0]
    tab = table.cpu()
    touched = {int(tab[r, (p + i) // ps]) for r, p in enumerate(pasts) for i in range(t)}
    keep = [p for p in range(planes[0].shape[1]) if p not in touched]
    return all(torch.equal(x[:, keep], y[:, keep]) for x, y in zip(planes, before))


def kernel_attn_paged(timer, gen, gen_cpu, t: int, n_past, update: bool, b: int = 1,
                      quant: bool = False, s: int = N_CTX, ps: int = PAGE, bk: int | None = None,
                      h: int = H, d: int = D, main_path: bool = False,
                      straddle: bool = False, f32: bool = False) -> dict:
    """K2 (update) or K3 (read) in page-table mode, on a random pool (bf16,
    int8, or `f32`) through a scrambled table, against its plain version
    (pool bytes equal, pages it does not write unchanged), and bit for bit
    against the flat kernel on the gathered view at the same KV block
    (llama_forward's default fitted to the page: block_k = PS at 7B).
    `straddle`: K2's page_straddle mode, whose writes may cross into the
    next page. Timed unless `timer` is None."""
    from llamavk_tpu_torch.ops import flash_attn as fa

    layer = 1
    planes, table = _paged_case(gen, gen_cpu, b, quant, s, ps, h, d, f32)
    q, kn, vn = (torch.randn((b, t, h, d), device="cuda", generator=gen).to(torch.bfloat16)
                 for _ in range(3))
    bk = fa._fit_block_k(bk or (512 if t >= 256 else 256), ps, fa.kv_step(planes[0].dtype))
    npast = (torch.tensor(n_past, dtype=torch.int32, device="cuda")
             if isinstance(n_past, list) else n_past)
    k, v, sc = planes[0], planes[1], _scales(planes)
    bt = min(256, ps)  # llama_forward's query block on a pool
    if update:
        flat = _gathered(planes, table)
        p2, before = [x.clone() for x in planes], [x.clone() for x in planes]
        pkw = dict(block_t=bt, page_table=table, page_straddle=straddle)
        got = fa.flash_attention_update(q, kn, vn, k, v, npast, layer, block_k=bk, **pkw,
                                        **sc)[0]
        want = fa.flash_attention_update_ref(q, kn, vn, p2[0], p2[1], npast, layer, **pkw,
                                             **_scales(p2))[0]
        flat_out = fa.flash_attention_update(q, kn, vn, flat[0], flat[1], npast, layer,
                                             block_k=bk, **_scales(flat))[0]
        torch.cuda.synchronize()
        pool_equal = (all(torch.equal(x, y) for x, y in zip(planes, p2))
                      and _untouched_equal(planes, before, table, n_past, t, ps))
        flat_equal = torch.equal(flat_out, got) and all(
            torch.equal(x, y) for x, y in zip(flat, _gathered(planes, table)))
        del before
        run = lambda: fa.flash_attention_update(q, kn, vn, k, v, npast, layer,  # noqa: E731
                                                block_k=bk, **pkw, **sc)
        plain = lambda: fa.flash_attention_update_ref(  # noqa: E731
            q, kn, vn, p2[0], p2[1], npast, layer, **pkw, **_scales(p2))
    else:
        fa.write_rows(kn, vn, k, v, npast, layer, *planes[2:], page_table=table)
        flat = _gathered(planes, table)
        got = fa.flash_attention(q, k, v, npast, layer_idx=layer, block_k=bk, page_table=table,
                                 **sc)
        want = fa.flash_attention_ref(q, k, v, npast, layer_idx=layer, page_table=table, **sc)
        flat_out = fa.flash_attention(q, flat[0], flat[1], npast, layer_idx=layer, block_k=bk,
                                      **_scales(flat))
        torch.cuda.synchronize()
        pool_equal, flat_equal = True, torch.equal(flat_out, got)
        run = lambda: fa.flash_attention(q, k, v, npast, layer_idx=layer,  # noqa: E731
                                         block_k=bk, page_table=table, **sc)
        plain = lambda: fa.flash_attention_ref(q, k, v, npast, layer_idx=layer,  # noqa: E731
                                               page_table=table, **sc)
    err, ratio = _attn_err(got, want, q, k, v, npast, layer, *planes[2:], page_table=table)
    kind = "f32" if f32 else "int8" if quant else "bf16"
    past = f"{min(n_past)}..{max(n_past)}" if isinstance(n_past, list) and b > 4 else n_past
    row = {
        "kernel": fa.launch_name("attn_update" if update else "attn_read", kind, True, straddle,
                                 route=fa.attn_route(t, kind)),
        "shape": f"B={b} T={t} n_past={past} H={h} D={d} PS={ps} MAXLB={s // ps} "
                 f"block_k={bk}" + ("" if kind == "bf16" else f" {kind}"),
        "main_path": main_path,
        "max_abs_err": err, "limit": F32_ATTN_LIMIT_RULE if f32 else ATTN_LIMIT_RULE,
        "err_over_limit": ratio,
        "cache_bytes_equal": pool_equal, "bit_equal_to_flat_kernel": flat_equal,
        "ok": ratio <= 1.0 and pool_equal and flat_equal,
    }
    if timer is not None:
        row["ms"] = timer(run)
        row["plain_ms"] = timer(plain, reps=5)
        _route_times(timer, run, row, t, kind)
        _splits(row, t, n_past, b, s, bk)
        row["library_ms"] = timer(_sdpa_call(q, flat[0], flat[1], npast, layer, *flat[2:]))
        row["bound_ms"], row["bound_by"] = _attn_bound(
            *_attn_sizes(b, t, n_past, update, quant, f32), kind, t)
    return row


def kernel_decode_paged(timer, gen, gen_cpu, b: int, quant: bool, s: int = N_CTX,
                        ps: int = PAGE, bk: int = 256, h: int = H, d: int = D,
                        main_path: bool = False, f32: bool = False) -> dict:
    """K4 in page-table mode at n_past seeded over [0, s), bf16, int8 or
    `f32` pools, against its plain version (pool bytes equal, pages it does
    not write unchanged), and bit for bit against the flat K4 on the
    gathered view at the KV block fitted to the page and against the paged
    K2 at T = 1 (outputs and pool). Timed unless `timer` is None."""
    from llamavk_tpu_torch.ops import flash_attn as fa
    from llamavk_tpu_torch.ops import flash_decode as fd

    layer = 1
    npl = _decode_npast(b, s, gen_cpu)
    npast = torch.tensor(npl, dtype=torch.int32, device="cuda")
    planes, table = _paged_case(gen, gen_cpu, b, quant, s, ps, h, d, f32)
    p3 = [x.clone() for x in planes]
    q, kn, vn = (torch.randn((b, 1, h, d), device="cuda", generator=gen).to(torch.bfloat16)
                 for _ in range(3))
    bkf = fa._fit_block_k(bk, ps, fa.kv_step(planes[0].dtype))
    flat = _gathered(planes, table)
    p2, before = [x.clone() for x in planes], [x.clone() for x in planes]
    got = fd.flash_decode_update(q, kn, vn, planes[0], planes[1], npast, layer, block_k=bk,
                                 page_table=table, **_scales(planes))[0]
    want = fd.flash_decode_update_ref(q, kn, vn, p2[0], p2[1], npast, layer, block_k=bk,
                                      page_table=table, **_scales(p2))[0]
    flat_out = fd.flash_decode_update(q, kn, vn, flat[0], flat[1], npast, layer, block_k=bkf,
                                      **_scales(flat))[0]
    torch.cuda.synchronize()
    pool_equal = (all(torch.equal(x, y) for x, y in zip(planes, p2))
                  and _untouched_equal(planes, before, table, npl, 1, ps))
    flat_equal = torch.equal(flat_out, got) and all(
        torch.equal(x, y) for x, y in zip(flat, _gathered(planes, table)))
    k2_out = fa.flash_attention_update(q, kn, vn, p3[0], p3[1], npast, layer, block_k=bk,
                                       block_t=1, page_table=table, **_scales(p3))[0]
    torch.cuda.synchronize()
    k2_equal = torch.equal(k2_out, got) and all(torch.equal(x, y) for x, y in zip(p3, planes))
    del before, p3
    err, ratio = _attn_err(got, want, q, planes[0], planes[1], npast, layer, *planes[2:],
                           page_table=table)
    kind = "f32" if f32 else "int8" if quant else "bf16"
    row = {
        "kernel": fa.launch_name("decode", kind, True),
        "shape": f"B={b} n_past={min(npl)}..{max(npl)} H={h} D={d} PS={ps} MAXLB={s // ps} "
                 f"block_k={bkf}" + ("" if kind == "bf16" else f" {kind}"),
        "main_path": main_path,
        "max_abs_err": err, "limit": F32_ATTN_LIMIT_RULE if f32 else ATTN_LIMIT_RULE,
        "err_over_limit": ratio,
        "cache_bytes_equal": pool_equal, "bit_equal_to_flat_kernel": flat_equal,
        "bit_equal_to_paged_update_kernel": k2_equal,
        "ok": ratio <= 1.0 and pool_equal and flat_equal and k2_equal,
    }
    if timer is None:
        return row
    sc = _scales(planes)
    run = lambda: fd.flash_decode_update(q, kn, vn, planes[0], planes[1], npast,  # noqa: E731
                                         layer, block_k=bk, page_table=table, **sc)
    row["ms"] = timer(run)
    _route_times(timer, run, row, 1, kind)
    _splits(row, 1, npl, b, s, bkf)
    row["plain_ms"] = timer(lambda: fd.flash_decode_update_ref(
        q, kn, vn, p2[0], p2[1], npast, layer, block_k=bk, page_table=table, **_scales(p2)),
        reps=5)
    row["library_ms"] = timer(_sdpa_call(q, flat[0], flat[1], npast, layer, *flat[2:]))
    row["bound_ms"], row["bound_by"] = bound(*_attn_sizes(b, 1, npl, True, quant, f32),
                                             F32_FLOP_PER_S if f32 else BF16_OP_PER_S)
    return row


RING_KEEP = 32  # generate_7b_ring's --n-keep: the ring's pinned rows
POOL, POOL_CTX, PLEN = 4, 256, 200  # serve_7b_shared's pool and registered prefix


def _ring_plane(n_logical: int, s: int, keep: int, holes=()) -> torch.Tensor:
    """The position plane [S, 1] an engine leaves after logical positions
    [0, n_logical) (pos[ring_phys(p)] = p, -1 where empty), with the rows in
    `holes` emptied."""
    from llamavk_tpu_torch.models.llama import ring_phys

    pos = torch.full((s, 1), -1, dtype=torch.int32)
    for p in range(n_logical):
        pos[ring_phys(p, keep, s)] = p
    pos[list(holes)] = -1
    return pos.cuda()


def _dense_rows(planes, layer: int, rows=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Layer `layer`'s K and V [B, H, S', D] in the cache's type (an int8
    cache dequantized to bf16), at physical rows `rows` (all when None)."""
    from llamavk_tpu_torch.ops.kv_quant import dequantize_rows

    kl, vl = planes[0][layer], planes[1][layer]
    if len(planes) == 4:
        kl = dequantize_rows(kl, planes[2][layer].transpose(1, 2)).to(torch.bfloat16)
        vl = dequantize_rows(vl, planes[3][layer].transpose(1, 2)).to(torch.bfloat16)
    if rows is not None:
        kl, vl = kl[:, :, rows], vl[:, :, rows]
    return kl.contiguous(), vl.contiguous()


def _masked_sdpa(q, kl, vl, visible):
    """One PyTorch call for an attention with an explicit mask: kl/vl
    [B, H, S', D] bf16 (f32 where f32 slots join a bf16 pool; q is cast to
    their type), visible [B, T, S'] bool, all made before the call."""
    qh = q.transpose(1, 2).to(kl.dtype)
    mask = visible[:, None]
    return lambda: torch.nn.functional.scaled_dot_product_attention(qh, kl, vl, attn_mask=mask)


def _row_bytes(quant: bool, h: int = H, d: int = D, f32: bool = False) -> int:
    """Bytes of one cached position of K or V: H * D values, and H f32
    scales for int8."""
    return h * d * (1 if quant else 4 if f32 else 2) + (h * 4 if quant else 0)


def kernel_attn_ring(timer, gen, t: int, n_past: int, update: bool, quant: bool,
                     main_path: bool = False, holes=(), keep: int = RING_KEEP, s: int = N_CTX,
                     h: int = H, d: int = D, bk: int | None = None, f32: bool = False) -> dict:
    """K2 (update, ring_bounded as llama_forward passes it) or K3 (read,
    the whole ring) in history-ring mode, B = 1, on a random cache (bf16,
    int8, or `f32`) and the plane the engine leaves at logical n_past + T
    (rows in `holes` emptied), against its plain version: cache bytes equal,
    the plane unchanged by the kernel. Before the first wrap the ring kernel
    must equal the flat one bit for bit (outputs and caches). Timed unless
    `timer` is None; the library call attends over the visible rows,
    gathered."""
    from llamavk_tpu_torch.models.llama import ring_phys
    from llamavk_tpu_torch.ops import flash_attn as fa

    layer = 1
    kind = "int8" if quant else "f32" if f32 else "bf16"
    planes = _kv_cache(gen, (2, 1, h, s, d), quant, f32)
    q, kn, vn = (torch.randn((1, t, h, d), device="cuda", generator=gen).to(torch.bfloat16)
                 for _ in range(3))
    bk = bk or (512 if t >= 256 else 256)
    pos = _ring_plane(n_past + t, s, keep, holes)
    pos0 = pos.clone()
    wrow = ring_phys(n_past, keep, s)
    k, v, sc = planes[0], planes[1], _scales(planes)
    flat_planes = [x.clone() for x in planes]
    if update:
        rkw = dict(kv_pos=pos, write_row=wrow, ring_bounded=True)
        p2 = [x.clone() for x in planes]
        got = fa.flash_attention_update(q, kn, vn, k, v, n_past, layer, block_k=bk, **rkw,
                                        **sc)[0]
        want = fa.flash_attention_update_ref(q, kn, vn, p2[0], p2[1], n_past, layer, block_k=bk,
                                             **rkw, **_scales(p2))[0]
        run = lambda: fa.flash_attention_update(q, kn, vn, k, v, n_past, layer,  # noqa: E731
                                                block_k=bk, **rkw, **sc)
        plain = lambda: fa.flash_attention_update_ref(  # noqa: E731
            q, kn, vn, p2[0], p2[1], n_past, layer, block_k=bk, **rkw, **_scales(p2))
    else:
        rkw = dict(kv_pos=pos)
        fa.write_rows(kn, vn, k, v, wrow, layer, *planes[2:])
        fa.write_rows(kn, vn, flat_planes[0], flat_planes[1], wrow, layer, *flat_planes[2:])
        p2 = planes
        got = fa.flash_attention(q, k, v, n_past, layer_idx=layer, block_k=bk, **rkw, **sc)
        want = fa.flash_attention_ref(q, k, v, n_past, layer_idx=layer, **rkw, **sc)
        run = lambda: fa.flash_attention(q, k, v, n_past, layer_idx=layer,  # noqa: E731
                                         block_k=bk, **rkw, **sc)
        plain = lambda: fa.flash_attention_ref(q, k, v, n_past, layer_idx=layer,  # noqa: E731
                                               **rkw, **sc)
    torch.cuda.synchronize()
    cache_equal = all(torch.equal(x, y) for x, y in zip(planes, p2))
    pos_equal = torch.equal(pos, pos0)
    row = {"kernel": fa.launch_name("attn_update" if update else "attn_read", kind, False,
                                    mode="ring", route=fa.attn_route(t, kind))}
    if n_past + t <= s and not holes:  # before the first wrap: the flat kernel's result
        fsc = _scales(flat_planes)
        if update:
            flat_out = fa.flash_attention_update(q, kn, vn, flat_planes[0], flat_planes[1],
                                                 n_past, layer, block_k=bk, **fsc)[0]
        else:
            flat_out = fa.flash_attention(q, flat_planes[0], flat_planes[1], n_past,
                                          layer_idx=layer, block_k=bk, **fsc)
        torch.cuda.synchronize()
        row["bit_equal_to_flat_kernel"] = torch.equal(flat_out, got) and all(
            torch.equal(x, y) for x, y in zip(flat_planes, planes))
    del flat_planes
    err, ratio = _attn_err(got, want, q, k, v, n_past, layer, *planes[2:], kv_pos=pos)
    row.update({
        "shape": f"B=1 T={t} n_past={n_past} write_row={wrow} keep={keep} H={h} D={d} S={s} "
                 f"block_k={bk}" + (f" holes={len(holes)}" if holes else "")
                 + (" int8" if quant else "") + (" f32" if f32 else ""),
        "main_path": main_path,
        "max_abs_err": err, "limit": F32_ATTN_LIMIT_RULE if f32 else ATTN_LIMIT_RULE,
        "err_over_limit": ratio,
        "cache_bytes_equal": cache_equal, "pos_plane_unchanged": pos_equal,
        "ok": ratio <= 1.0 and cache_equal and pos_equal
              and row.get("bit_equal_to_flat_kernel", True),
    })
    if timer is None:
        return row
    pc = pos[:, 0].cpu()
    valid = (pc >= 0) & (pc <= n_past + t - 1)
    idx = valid.nonzero()[:, 0].cuda()
    kl, vl = _dense_rows(planes, layer, idx)
    visible = pos[idx, 0][None, None, :] <= (n_past + torch.arange(t, device="cuda"))[None, :, None]
    row["ms"] = timer(run)
    row["plain_ms"] = timer(plain, reps=5)
    _route_times(timer, run, row, t, kind)
    _splits(row, t, n_past, 1, s, bk, ring_rows=None if update else s)
    row["library_ms"] = timer(_masked_sdpa(q.to(kl.dtype), kl, vl, visible))
    # bytes: q read, out written, the plane read, the visible rows read once
    # (update: the earlier ones from the cache, the new ones read from
    # k_new/v_new and written); operations: QK and PV over each query's
    # visible rows (an f32 cache's, whose q and new rows arrive as f32, at
    # its route's rate: `_attn_bound`)
    nv = int(valid.sum())
    qb = 4 if f32 else 2
    n_bytes = t * h * d * (qb + 4) + s * 4 + 2 * nv * _row_bytes(quant, h, d, f32)
    if update:
        n_bytes += 2 * t * h * d * qb
    ops = 4.0 * h * d * sum(int(((pc >= 0) & (pc <= n_past + i)).sum()) for i in range(t))
    row["bound_ms"], row["bound_by"] = _attn_bound(n_bytes, ops, kind, t)
    return row


def kernel_attn_prefix(timer, gen, gen_cpu, b: int, t: int, npl: list[int], update: bool,
                       quant: bool, main_path: bool = False, plen=PLEN, sp: int = POOL_CTX,
                       n_pool: int = POOL, s: int = N_CTX, h: int = H, d: int = D,
                       bk: int | None = None, f32: bool = False) -> dict:
    """K2 (update) or K3 (read) in prefix-pool mode: B rows at slot-local
    n_past `npl`, each continuing a seeded entry of a random bf16 pool of
    `n_pool` x `sp` rows over `plen` rows (an int, or one per row), over a
    bf16, int8 or (`f32`) f32 slot cache, against its plain version: cache
    bytes equal,
    the pool unchanged; with prefix_len 0 on every row, bit-equal to the
    flat kernel (outputs and caches). Timed unless `timer` is None; the
    library call attends over the pool rows and the visible slot rows,
    concatenated; the bound counts each pool entry's rows once."""
    from llamavk_tpu_torch.ops import flash_attn as fa

    layer = 1
    planes = _kv_cache(gen, (2, b, h, s, d), quant, f32)
    pool = [torch.randn((2, n_pool, h, sp, d), device="cuda", generator=gen).to(torch.bfloat16)
            for _ in range(2)]
    pool0 = [x.clone() for x in pool]
    q, kn, vn = (torch.randn((b, t, h, d), device="cuda", generator=gen).to(torch.bfloat16)
                 for _ in range(3))
    bk = bk or (512 if t >= 256 else 256)
    pid = torch.randint(0, n_pool, (b,), generator=gen_cpu).to(torch.int32)
    plens = torch.tensor(plen if isinstance(plen, list) else [plen] * b, dtype=torch.int32)
    pkw = dict(prefix_k=pool[0], prefix_v=pool[1], prefix_id=pid.cuda(),
               prefix_len=plens.cuda())
    zkw = {**pkw, "prefix_len": torch.zeros(b, dtype=torch.int32, device="cuda")}
    npast = torch.tensor(npl, dtype=torch.int32, device="cuda")
    k, v, sc = planes[0], planes[1], _scales(planes)
    za, zb = [x.clone() for x in planes], [x.clone() for x in planes]
    if update:
        p2 = [x.clone() for x in planes]
        got = fa.flash_attention_update(q, kn, vn, k, v, npast, layer, block_k=bk, **pkw,
                                        **sc)[0]
        want = fa.flash_attention_update_ref(q, kn, vn, p2[0], p2[1], npast, layer, block_k=bk,
                                             **pkw, **_scales(p2))[0]
        zero_out = fa.flash_attention_update(q, kn, vn, za[0], za[1], npast, layer, block_k=bk,
                                             **zkw, **_scales(za))[0]
        flat_out = fa.flash_attention_update(q, kn, vn, zb[0], zb[1], npast, layer, block_k=bk,
                                             **_scales(zb))[0]
        run = lambda: fa.flash_attention_update(q, kn, vn, k, v, npast, layer,  # noqa: E731
                                                block_k=bk, **pkw, **sc)
        plain = lambda: fa.flash_attention_update_ref(  # noqa: E731
            q, kn, vn, p2[0], p2[1], npast, layer, block_k=bk, **pkw, **_scales(p2))
    else:
        for x in (planes, za, zb):
            fa.write_rows(kn, vn, x[0], x[1], npast, layer, *x[2:])
        p2 = planes
        got = fa.flash_attention(q, k, v, npast, layer_idx=layer, block_k=bk, **pkw, **sc)
        want = fa.flash_attention_ref(q, k, v, npast, layer_idx=layer, **pkw, **sc)
        zero_out = fa.flash_attention(q, za[0], za[1], npast, layer_idx=layer, block_k=bk, **zkw,
                                      **_scales(za))
        flat_out = fa.flash_attention(q, zb[0], zb[1], npast, layer_idx=layer, block_k=bk,
                                      **_scales(zb))
        run = lambda: fa.flash_attention(q, k, v, npast, layer_idx=layer,  # noqa: E731
                                         block_k=bk, **pkw, **sc)
        plain = lambda: fa.flash_attention_ref(q, k, v, npast, layer_idx=layer,  # noqa: E731
                                               **pkw, **sc)
    torch.cuda.synchronize()
    cache_equal = all(torch.equal(x, y) for x, y in zip(planes, p2))
    pool_equal = all(torch.equal(x, y) for x, y in zip(pool, pool0))
    flat_equal = torch.equal(zero_out, flat_out) and all(
        torch.equal(x, y) for x, y in zip(za, zb))
    del za, zb, pool0
    err, ratio = _attn_err(got, want, q, k, v, npast, layer, *planes[2:], **pkw)
    kind = "f32" if f32 else "int8" if quant else "bf16"
    row = {
        "kernel": fa.launch_name("attn_update" if update else "attn_read", kind, False,
                                 mode="prefix", route=fa.attn_route(t, kind)),
        "shape": f"B={b} T={t} n_past={min(npl)}..{max(npl)} prefix_len="
                 f"{int(plens.min())}..{int(plens.max())} of Sp={sp} x {n_pool} H={h} D={d} "
                 f"S={s} block_k={bk}" + ("" if kind == "bf16" else f" {kind} slots"),
        "main_path": main_path,
        "max_abs_err": err, "limit": ATTN_LIMIT_RULE, "err_over_limit": ratio,
        "cache_bytes_equal": cache_equal, "pool_unchanged": pool_equal,
        "bit_equal_to_flat_kernel_at_prefix_len_0": flat_equal,
        "ok": ratio <= 1.0 and cache_equal and pool_equal and flat_equal,
    }
    if timer is None:
        return row
    kv = int(max(npl)) + t
    kl, vl = _dense_rows(planes, layer, slice(0, kv))
    ids = pid.cuda().long()
    kl = torch.cat([pool[0][layer][ids], kl], 2)
    vl = torch.cat([pool[1][layer][ids], vl], 2)
    pvis = torch.arange(sp, device="cuda")[None, :] < plens.cuda()[:, None]
    svis = (torch.arange(kv, device="cuda")[None, None, :]
            <= npast[:, None, None] + torch.arange(t, device="cuda")[None, :, None])
    visible = torch.cat([pvis[:, None, :].expand(-1, t, -1), svis], -1)
    row["ms"] = timer(run)
    row["plain_ms"] = timer(plain, reps=5)
    _route_times(timer, run, row, t, kind)
    _splits(row, t, npl, b, s, bk, plens.tolist(), fa._fit_block_k(min(bk, sp), sp))
    row["library_ms"] = timer(_masked_sdpa(q, kl, vl, visible))
    # the slot part as `_attn_sizes`; each pool entry's rows read once (L2
    # holds a layer's pool for every row that shares it), QK and PV over
    # every row's prefix
    n_bytes, ops = _attn_sizes(b, t, npl, update, quant, f32)
    used = {}
    for i, pl in zip(pid.tolist(), plens.tolist()):
        used[i] = max(used.get(i, 0), pl)
    n_bytes += sum(used.values()) * 2 * h * d * 2
    pool_ops = 4.0 * h * d * t * int(plens.sum())
    row["bound_ms"], row["bound_by"] = _attn_bound(n_bytes, ops, kind, t, pool_ops)
    return row


def _attn_edge(gen, b: int, t: int, n_past, update: bool, bk: int, h: int, d: int, s: int,
               quant: bool = False, f32: bool = False) -> dict:
    """K2 (update) or K3 (read) over a flat cache (bf16, int8 or `f32`) at a
    small width, against its plain version (update: cache bytes equal),
    correctness only; n_past an int or a list (an int32 vector)."""
    from llamavk_tpu_torch.ops import flash_attn as fa

    planes = _kv_cache(gen, (2, b, h, s, d), quant, f32)
    q, kn, vn = (torch.randn((b, t, h, d), device="cuda", generator=gen).to(torch.bfloat16)
                 for _ in range(3))
    np_ = (torch.tensor(n_past, dtype=torch.int32, device="cuda") if isinstance(n_past, list)
           else n_past)
    k, v = planes[0], planes[1]
    cache_equal = True
    if update:
        p2 = [x.clone() for x in planes]
        got = fa.flash_attention_update(q, kn, vn, k, v, np_, 1, block_k=bk, **_scales(planes))[0]
        want = fa.flash_attention_update_ref(q, kn, vn, p2[0], p2[1], np_, 1, **_scales(p2))[0]
        cache_equal = all(torch.equal(x, y) for x, y in zip(planes, p2))
    else:
        fa.write_rows(kn, vn, k, v, np_, 1, *planes[2:])
        got = fa.flash_attention(q, k, v, np_, layer_idx=1, block_k=bk, **_scales(planes))
        want = fa.flash_attention_ref(q, k, v, np_, layer_idx=1, **_scales(planes))
    err, ratio = _attn_err(got, want, q, k, v, np_, 1, *planes[2:])
    kind = "int8" if quant else "f32" if f32 else "bf16"
    return {"kernel": "attn_" + fa.launch_name("update" if update else "read", kind, False,
                                               route=fa.attn_route(t, kind)),
            "shape": f"B={b} T={t} n_past={n_past} H={h} D={d} S={s} block_k={bk}"
                     + ("" if kind == "bf16" else f" {kind}"),
            "max_abs_err": err, "limit": F32_ATTN_LIMIT_RULE if f32 else ATTN_LIMIT_RULE,
            "err_over_limit": ratio, "cache_bytes_equal": cache_equal,
            "ok": ratio <= 1.0 and cache_equal}


def kernel_edges(gen, gen_cpu) -> dict:
    """Correctness only, off the 7B shapes: the GEMM at the row counts of
    short prompts' buckets (M = 2..9), an odd group count and a ragged N,
    the GEMV on a ragged N, the attention at D = 64 (the tiny model's) with
    a small KV block, T = 8 and a vector n_past, bf16 and int8, and the
    batched decode kernel at D = 64."""
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
    # the GEMV's edge tiles over several K splits: a ragged last tile and
    # packed rows only 8-byte aligned (N % 16 = 8), ilv and lin, every scale
    # and dot mode
    for layout, f32s, dot, mul in K1_MODES:
        for k, n in ((4096, 136), (2048, 1224)):
            x, qw = _q4_case(gen, 1, k, n, f32s, layout)
            got = q4.q4_matmul_cuda(x, qw.packed, qw.scales, layout, dot, mul)
            err = float((got - q4.q4_matmul_ref(x, qw, out_dtype=torch.float32, dot_mode=dot,
                                                 mul_dtype=mul)).abs().max())
            w = q4.mode_weight(qw, dot, mul)
            limit = 2 * k * 2.0**-24 * float((x.float().abs() @ w.abs()).max())
            mode = bench_gemm.mode_name(layout, f32s, dot, "bf16" if mul == torch.bfloat16
                                        else "f32")
            worst[f"q4 M=1 K={k} N={n} {mode}"] = (err, limit, err / limit)
    h, d, s = 2, 64, 64
    for quant in (False, True):
        # T 1-15 on the split route (splits of 32 rows; D = 64 at T = 4 with a
        # vector n_past), T 16-40 on the tensor cores, with rows past T in the
        # last 64-row block and a KV block of 32 (two ragged sub-tiles), a
        # vector n_past; then the split route's edges: T = 4 rows crossing a
        # 64-row split (S 128, rows 61-64), T = 15 at block_k 8 (splits of 8
        # rows) and 24 (S 96)
        for b, t, n_past, update, bk, s_e in (
                (1, 8, 13, True, 32, s), (1, 5, 20, False, 32, s), (2, 1, None, True, 32, s),
                (2, 4, None, True, 32, s), (1, 24, 13, True, 32, s), (1, 40, 20, False, 32, s),
                (2, 16, None, True, 32, s), (2, 4, [61, 100], True, 64, 128),
                (1, 15, 40, True, 8, s), (2, 15, [20, 70], True, 24, 96),
                (1, 15, 30, False, 24, 96)):
            r = _attn_edge(gen, b, t, [3, 40] if n_past is None else n_past, update, bk, h, d,
                           s_e, quant)
            if not r["cache_bytes_equal"]:
                raise SystemExit(f"kernel edges: cache rows differ (B={b} T={t})")
            worst[f"{r['kernel']} {r['shape']}"] = (r["max_abs_err"], ATTN_LIMIT_RULE,
                                                   r["err_over_limit"])
        r = kernel_decode(None, gen, gen_cpu, 4, quant, False, h=h, d=d, s=s, bk=32)
        if not r["ok"]:
            raise SystemExit(f"kernel edges: batched decode at D={d} disagrees: {r}")
        worst[f"decode {r['shape']}"] = (r["max_abs_err"], ATTN_LIMIT_RULE, r["err_over_limit"])
        # page-table modes at the tiny server's pages (8 rows bf16, 32 int8):
        # a 64-row tile spans several 8-row pages
        ps = 32 if quant else 8
        for r in (kernel_attn_paged(None, gen, gen_cpu, 8, [ps, 16], True, 2, quant, s, ps, 32,
                                    h, d),
                  kernel_attn_paged(None, gen, gen_cpu, 5, 20, False, 1, quant, s, ps, 32, h, d),
                  kernel_attn_paged(None, gen, gen_cpu, 16, [ps, 16], True, 2, quant, s, ps, 32,
                                    h, d),
                  kernel_attn_paged(None, gen, gen_cpu, 21, 20, False, 1, quant, s, ps, 32, h,
                                    d),
                  kernel_decode_paged(None, gen, gen_cpu, 4, quant, s, ps, 32, h, d)):
            if not r["ok"]:
                raise SystemExit(f"kernel edges: paged kernel at D={d} disagrees: {r}")
            worst[f"{r['kernel']} {r['shape']}"] = (r["max_abs_err"], ATTN_LIMIT_RULE,
                                                   r["err_over_limit"])
        # ring and prefix modes at the tiny model's width: a wrapped 64-row
        # ring (keep 4) at T = 8 and T = 1, one at T = 4 before its wrap
        # (bit-equal to flat), the read over a plane with empty rows, and the
        # pool pre-pass with a KV block of 32
        for r in (kernel_attn_ring(None, gen, 8, 92, True, quant, keep=4, s=s, h=h, d=d, bk=32),
                  kernel_attn_ring(None, gen, 4, 20, True, quant, keep=4, s=s, h=h, d=d, bk=32),
                  kernel_attn_ring(None, gen, 1, 40, True, quant, keep=4, s=s, h=h, d=d, bk=32),
                  kernel_attn_ring(None, gen, 5, 70, False, quant, holes=range(20, 30), keep=4,
                                   s=s, h=h, d=d, bk=32),
                  kernel_attn_prefix(None, gen, gen_cpu, 3, 8, [3, 9, 40], True, quant,
                                     plen=[33, 0, 256], s=s, h=h, d=d, bk=32),
                  kernel_attn_prefix(None, gen, gen_cpu, 2, 5, [0, 20], False, quant,
                                     plen=[100, 7], s=s, h=h, d=d, bk=32),
                  # the tensor-core route: a wrapped ring, one before the
                  # wrap (bit-equal to flat), a read over empty rows, the
                  # pool pre-pass (bit-equal to flat at prefix_len 0)
                  kernel_attn_ring(None, gen, 16, 92, True, quant, keep=4, s=s, h=h, d=d, bk=32),
                  kernel_attn_ring(None, gen, 16, 8, True, quant, keep=4, s=s, h=h, d=d, bk=32),
                  kernel_attn_ring(None, gen, 21, 70, False, quant, holes=range(20, 30), keep=4,
                                   s=s, h=h, d=d, bk=32),
                  kernel_attn_prefix(None, gen, gen_cpu, 3, 16, [3, 9, 40], True, quant,
                                     plen=[33, 0, 256], s=s, h=h, d=d, bk=32),
                  kernel_attn_prefix(None, gen, gen_cpu, 2, 20, [0, 20], False, quant,
                                     plen=[100, 7], s=s, h=h, d=d, bk=32)):
            if not r["ok"]:
                raise SystemExit(f"kernel edges: ring/prefix kernel at D={d} disagrees: {r}")
            worst[f"{r['kernel']} {r['shape']}"] = (r["max_abs_err"], ATTN_LIMIT_RULE,
                                                   r["err_over_limit"])
    # an f32 page pool of 8-row pages and f32 slots under the prefix pool;
    # then the f32 tensor-core route: flat with KV blocks of 16 and 32 rows
    # (16-row sub-tiles; a ragged last one) and rows past T in the last
    # 64-row block, a vector n_past, 8-row pages (8-row sub-tiles), a wrapped ring, one
    # before its wrap (bit-equal to flat), the pool pre-pass over f32 slots
    for r in (kernel_attn_paged(None, gen, gen_cpu, 8, [8, 16], True, 2, False, s, 8, 32, h, d,
                                f32=True),
              kernel_attn_paged(None, gen, gen_cpu, 5, 20, False, 1, False, s, 8, 32, h, d,
                                f32=True),
              kernel_decode_paged(None, gen, gen_cpu, 4, False, s, 8, 32, h, d, f32=True),
              kernel_attn_prefix(None, gen, gen_cpu, 3, 8, [3, 9, 40], True, False,
                                 plen=[33, 0, 256], s=s, h=h, d=d, bk=32, f32=True),
              _attn_edge(gen, 1, 24, 13, True, 16, h, d, s, f32=True),
              _attn_edge(gen, 1, 40, 20, False, 32, h, d, s, f32=True),
              _attn_edge(gen, 2, 16, [3, 40], True, 32, h, d, s, f32=True),
              kernel_attn_paged(None, gen, gen_cpu, 16, [8, 16], True, 2, False, s, 8, 32, h, d,
                                f32=True),
              kernel_attn_paged(None, gen, gen_cpu, 21, 20, False, 1, False, s, 8, 32, h, d,
                                f32=True),
              kernel_attn_ring(None, gen, 16, 92, True, False, keep=4, s=s, h=h, d=d, bk=32,
                               f32=True),
              kernel_attn_ring(None, gen, 16, 8, True, False, keep=4, s=s, h=h, d=d, bk=32,
                               f32=True),
              kernel_attn_ring(None, gen, 21, 70, False, False, holes=range(20, 30), keep=4,
                               s=s, h=h, d=d, bk=32, f32=True),
              kernel_attn_prefix(None, gen, gen_cpu, 3, 16, [3, 9, 40], True, False,
                                 plen=[33, 0, 256], s=s, h=h, d=d, bk=32, f32=True),
              kernel_attn_prefix(None, gen, gen_cpu, 2, 20, [0, 20], False, False,
                                 plen=[100, 7], s=s, h=h, d=d, bk=32, f32=True)):
        if not r["ok"]:
            raise SystemExit(f"kernel edges: f32 paged/prefix kernel at D={d} disagrees: {r}")
        worst[f"{r['kernel']} {r['shape']}"] = (r["max_abs_err"], r["limit"],
                                               r["err_over_limit"])
    torch.cuda.synchronize()
    bad = {name: e for name, e in worst.items() if not e[2] <= 1.0}
    if bad:
        raise SystemExit(f"kernel edges disagree with their plain versions: {bad}")
    return {name: {"max_abs_err": e, "limit": lim, "err_over_limit": r}
            for name, (e, lim, r) in worst.items()}


def phase_kernels(reps: int) -> list[dict]:
    timer = Timer(reps)
    gen = torch.Generator(device="cuda").manual_seed(0)
    gen_cpu = torch.Generator().manual_seed(0)
    rows = []
    # K1's decode GEMV (M = 1) at the five shapes; the GEMM (M >= 2) over
    # every mode in `kernels_gemm`, its dequantized weights bit for bit in
    # `kernel_q4_weight_bits`. Every shape serve_7b launches K1, K2, K3 or
    # K4 at is checked after it, from the wrappers' shape counters
    # (`phase_serve_shapes`).
    for name in K1_SHAPES:
        rows.append(kernel_q4(timer, gen, name, 1, True))
        emit({"phase": "kernel", **rows[-1]})
    rows += kernels_gemm(timer, gen)
    emit({"phase": "kernel_weight_bits", **kernel_q4_weight_bits(gen)})
    # (T, n_past, update kernel, on a main path, B, int8): bf16 decode steps,
    # the first prompt, the second turn (301 tokens at n_past 159 in a
    # 353-row bucket, which takes the read route), a full-context and an
    # odd-length prefill; int8 single-stream decode at n_past 480, chunks of
    # four prompts (buckets 32, 64, 256) in the full 512-row cache (serving
    # admits them into a smaller scratch cache), a full-context prefill, the
    # second-turn shape, and the serving path's prefixed request (a 300-token
    # suffix at n_past 100 in a 412-row bucket, the read route); the bf16
    # lookup verify (generate_7b_lookup: B=1, T=4, a vector n_past); T = 16,
    # the least T of the tensor-core route, bf16 and int8 (the CUDA-core
    # route's time beside it: the routes' crossover)
    for t, n_past, update, main, b, quant in (
            (16, 0, True, False, 1, False), (16, 0, True, False, 4, True),
            (4, [100], True, True, 1, False), (1, 0, True, False, 1, False),
            (1, 37, True, True, 1, False), (1, 480, True, True, 1, False),
            (1, 511, True, False, 1, False),
            (32, 0, True, True, 1, False), (512, 0, True, False, 1, False),
            (353, 159, False, True, 1, False), (412, 100, False, False, 1, False),
            (1, 480, True, False, 1, True), (32, 0, True, False, 4, True),
            (64, 0, True, False, 4, True), (256, 0, True, False, 4, True),
            (512, 0, True, False, 1, True), (353, 159, False, False, 1, True),
            (412, 100, False, True, 1, True)):
        rows.append(kernel_attn(timer, gen, t, n_past, update, main, b, quant))
        emit({"phase": "kernel", **rows[-1]})
    # batched decode at the serving path's 32 slots (int8 there) and at 8
    for b in (32, 8):
        for quant in (False, True):
            rows.append(kernel_decode(timer, gen, gen_cpu, b, quant, b == 32 and quant))
            emit({"phase": "kernel", **rows[-1]})
    # page-table modes through scrambled tables of 128-row pages: K2 at T=1
    # and at admission chunks' T (B=4 from page 0 and 1, B=1 at n_past 256
    # as a request continuing two shared prefix pages, B=2 at T=512 as a
    # re-admission of two preempted requests), K3 at the second
    # turn's shape (no engine path reaches it: paged llama_forward refuses
    # the read route), K4 at the serving path's 32 slots. serve_shapes
    # checks every paged shape serve_7b_paged launches.
    for quant in (False, True):
        for t, n_past, b in ((1, 300, 1), (32, 0, 4), (128, 128, 4), (256, 256, 1), (512, 0, 2)):
            rows.append(kernel_attn_paged(timer, gen, gen_cpu, t, n_past, True, b, quant))
            emit({"phase": "kernel", **rows[-1]})
        rows.append(kernel_attn_paged(timer, gen, gen_cpu, 301, 159, False, 1, quant))
        emit({"phase": "kernel", **rows[-1]})
        rows.append(kernel_decode_paged(timer, gen, gen_cpu, 32, quant))
        emit({"phase": "kernel", **rows[-1]})
    # K5 (LLAMAVK_Q4_DOT=i8) at decode (M = 1), the lookup verify (M = 4),
    # one and two token tiles (M = 8, 16) and the batched decode step
    # (M = 32, where w2 takes K1)
    for m in (1, 4, 8, 16, 32):
        for name in K1_SHAPES:
            rows.append(kernel_q4_i8(timer, gen, name, m, m < 32))
            emit({"phase": "kernel", **rows[-1]})
    # K2's page_straddle mode: a 4-row verify write at n_past values that
    # cross a 128-row page, B = 4, bf16 and int8
    for quant in (False, True):
        rows.append(kernel_attn_paged(timer, gen, gen_cpu, 4, [126, 253, 380, 507], True, 4,
                                      quant, straddle=True))
        emit({"phase": "kernel", **rows[-1]})
    # the verify rounds at T = 4 on the split route: generate_7b_lookup's
    # bf16 B = 1 round at n_past 408, serve_7b_lookup's int8 B = 32 rounds,
    # flat and paged with page_straddle (seeded n_past); and the largest
    # instance (NQ = 16): T = 15, B = 1 bf16 at n_past 480 and B = 32 int8.
    # A seed of their own, so the rows after them keep their n_past
    gen_rows = torch.Generator().manual_seed(15)
    npl = _decode_npast(32, N_CTX - 15, gen_rows)
    for r in (lambda: kernel_attn(timer, gen, 4, [408], True, False, 1, False),
              lambda: kernel_attn(timer, gen, 4, npl, True, False, 32, True),
              lambda: kernel_attn_paged(timer, gen, gen_rows, 4, npl, True, 32, True,
                                        straddle=True),
              lambda: kernel_attn(timer, gen, 15, 480, True, False, 1, False),
              lambda: kernel_attn(timer, gen, 15, npl, True, False, 32, True)):
        rows.append(r())
        emit({"phase": "kernel", **rows[-1]})
    # history ring (32 pinned rows of a 512-row ring, generate_7b_ring's):
    # K2 before the wrap (bit-equal to flat K2), at n_past 700 (wrapped; the
    # decode step), at T = 8 on a chunk that ends on the ring's last row; K3
    # at T = 301 over a wrapped plane with 20 empty rows (no engine path: the
    # ring engine evaluates power-of-two chunks)
    for quant in (False, True):
        for t, n_past, main in ((1, 300, False), (1, 700, not quant), (8, 984, False),
                                (32, 0, not quant)):
            rows.append(kernel_attn_ring(timer, gen, t, n_past, True, quant, main))
            emit({"phase": "kernel", **rows[-1]})
        rows.append(kernel_attn_ring(timer, gen, 301, 580, False, quant,
                                     holes=range(450, 470)))
        emit({"phase": "kernel", **rows[-1]})
    # the f32 ring (Engine(kv_dtype="float32", ctx_ring=True)): K2's decode
    # step before the wrap (bit-equal to flat K2) and after it
    for n_past in (300, 700):
        rows.append(kernel_attn_ring(timer, gen, 1, n_past, True, False, f32=True))
        emit({"phase": "kernel", **rows[-1]})
    # shared-prefix pool (4 entries of 256 rows, 200-row prefixes): K2 at the
    # B = 32 decode step (suffix n_past seeded in 0..300) and at admission
    # (B = 4, T = 64), int8 slots (serve_7b_shared's) and bf16; K3 at T = 301
    for quant in (True, False):
        npl = torch.randint(0, 301, (32,), generator=gen_cpu).tolist()
        for b, t, pasts, update in ((32, 1, npl, True), (4, 64, [0] * 4, True),
                                    (1, 301, [0], False)):
            rows.append(kernel_attn_prefix(timer, gen, gen_cpu, b, t, pasts, update, quant,
                                           quant and update))
            emit({"phase": "kernel", **rows[-1]})
    rows += kernels_f32(timer, gen, gen_cpu)
    rows += kernels_modes(timer, gen)
    rows += kernels_parallel(timer, gen, gen_cpu)
    emit({"phase": "kernel_edges", **kernel_edges(gen, gen_cpu)})
    bad = [r["shape"] for r in rows if not r["ok"]]
    if bad:
        raise SystemExit(f"kernels disagree with their plain versions: {bad}")
    return rows


# the f32 tensor-core route's rows must use at most this share of the f32
# limit (2^-12 of attention(q, k, |v|)): the three TF32 passes leave ~2^-21
# of each product, far inside it; one pass alone would pass the limit
F32_TC_MAX_ERR_OVER_LIMIT = 0.05


def kernels_f32(timer: Timer, gen, gen_cpu) -> list[dict]:
    """The f32 modes at 7B shapes. K1's GEMV over an f32 scale plane (M = 1;
    no main path loads f32 scales and decodes; the GEMM's f32-scale rows are
    `kernels_gemm`'s). The f32 cache of K2 (the llama.h API's f16_kv =
    false: decode at n_past 480, the 32-token prompt; a full-context
    prefill), K3 (its 300-token second turn in a 353-row bucket at n_past
    159) and K4 (BatchedEngine(kv_dtype="float32") at 32 slots, ragged
    n_past, bit-equal to K2 row by row). An f32 page pool (PS = 128, B = 32,
    n_past 0..511 seeded): K2 and K3 at T = 1, bit-equal to the flat kernels
    on the gathered view, and K4, bit-equal to flat K4 and to the paged K2;
    K2 at a B = 4, T = 64 admission (the tensor cores), bit-equal to flat
    at block_k = PS. The f32 ring's prompt (K2 T = 32, bit-equal to flat).
    2 of 4 rows at batch_offset 2, T = 32, bit-equal to the rows alone, and
    the same call with commit = 0 (no byte written, bit-equal to K3). f32
    slots under the bf16 prefix pool (200-row prefixes): K2 at the B = 32
    decode step and at a B = 4, T = 64 admission, K3 at T = 301, each
    bit-equal to flat f32 at prefix_len 0. Every f32 row on the tensor
    cores with the f32 limit stays within F32_TC_MAX_ERR_OVER_LIMIT of it."""
    rows = []
    for name in K1_SHAPES:
        rows.append(kernel_q4(timer, gen, name, 1, False, f32_scales=True))
        emit({"phase": "kernel", **rows[-1]})
    for t, n_past, update, main in ((1, 480, True, True), (32, 0, True, True),
                                    (512, 0, True, False), (353, 159, False, True)):
        rows.append(kernel_attn(timer, gen, t, n_past, update, main, f32=True))
        emit({"phase": "kernel", **rows[-1]})
    rows.append(kernel_attn_paged(timer, gen, gen_cpu, 64, 0, True, 4, f32=True))
    emit({"phase": "kernel", **rows[-1]})
    rows.append(kernel_attn_ring(timer, gen, 32, 0, True, False, f32=True))
    emit({"phase": "kernel", **rows[-1]})
    for commit in (1, 0):
        rows.append(kernel_attn_pp(timer, gen, "update", 2, 32, 0, 4, 2, False, False,
                                   commit=commit, f32=True))
        emit({"phase": "kernel", **rows[-1]})
    rows.append(kernel_decode(timer, gen, gen_cpu, 32, False, True, f32=True))
    emit({"phase": "kernel", **rows[-1]})
    npl = _decode_npast(32, N_CTX, gen_cpu)
    for update in (True, False):
        rows.append(kernel_attn_paged(timer, gen, gen_cpu, 1, npl, update, 32, f32=True))
        emit({"phase": "kernel", **rows[-1]})
    rows.append(kernel_decode_paged(timer, gen, gen_cpu, 32, False, f32=True))
    emit({"phase": "kernel", **rows[-1]})
    npl = torch.randint(0, 301, (32,), generator=gen_cpu).tolist()
    for b, t, pasts, update in ((32, 1, npl, True), (4, 64, [0] * 4, True), (1, 301, [0], False)):
        rows.append(kernel_attn_prefix(timer, gen, gen_cpu, b, t, pasts, update, False, f32=True))
        emit({"phase": "kernel", **rows[-1]})
    for r in rows:
        if r.get("attn_route") == "tensor_core" and r["limit"] == F32_ATTN_LIMIT_RULE:
            r["ok"] = r["ok"] and r["err_over_limit"] <= F32_TC_MAX_ERR_OVER_LIMIT
    return rows


def kernels_modes(timer: Timer, gen) -> list[dict]:
    """K1's GEMV (M = 1) on the lin layout (generate_7b_modes decodes on it)
    and under the f32 dot, at the five shapes, and K5 over f32 scales at
    M = 1 and 4, and at perplexity --f32 -c 64's M = 64 (where w2 takes K1).
    The GEMM's rows of every mode are `kernels_gemm`'s. Over bf16 scales
    the bf16 multiply is the default kernel's launch (its mode bits are 0:
    f32(q) f32(s) of a bf16 s is exact and rounds once either way), so it
    has no row of its own; `kernel_q4_weight_bits` and
    tests/test_torch_q4_modes.py::test_mul_bf16_weight_bits hold the weight
    bits equal."""
    rows = []
    for layout, dot in (("lin", "bf16"), ("ilv", "f32")):
        for name in K1_SHAPES:
            rows.append(kernel_q4(timer, gen, name, 1, True, plain_reps=3, layout=layout,
                                  dot=dot))
            emit({"phase": "kernel", **rows[-1]})
    for m in (1, 4, 64):
        for name in K1_SHAPES:
            rows.append(kernel_q4_i8(timer, gen, name, m, m == 64, f32_scales=True))
            emit({"phase": "kernel", **rows[-1]})
    return rows


# K1's GEMM rows at bench_gemm.MS: M of serving (2-64: decode, verify,
# lookup, admissions), the second turn (353), a perplexity chunk (512) and
# 4 x 256-token admissions (1024); for each mode the M its main paths
# launch it at
GEMM_MAIN = {("ilv", False, "bf16", torch.float32): (4, 32, 353, 512, 1024),
             ("ilv", True, "bf16", torch.float32): (64, 512),
             ("lin", False, "bf16", torch.float32): (32,),
             ("ilv", False, "f32", torch.float32): (32,),
             ("ilv", True, "bf16", torch.bfloat16): (512,)}
# the replaced WMMA GEMM's time of each row: tools/bench_gemm.py run on
# commit b0ec59f (NVIDIA H100 80GB HBM3, 700.00 W), keyed (mode, shape, M)
GEMM_WMMA = ROOT / "llamavk_tpu_torch" / "tools" / "bench_gemm_wmma.jsonl"


def kernels_gemm(timer: Timer, gen) -> list[dict]:
    """K1's GEMM (M >= 2, csrc/q4_gemm.cuh) in every mode (K1_MODES) at the
    five 7B shapes and bench_gemm.MS, each against its plain version, its bound
    and torch.matmul, with the replaced WMMA GEMM's time of the same row
    (`wmma_ms`, None where that file has none). 10 launches timed a row."""
    wmma = {}
    if GEMM_WMMA.exists():
        for line in GEMM_WMMA.read_text().splitlines():
            r = json.loads(line)
            wmma[(r["mode"], r["shape"], r["m"])] = r["ms"]
    rows = []
    for layout, f32s, dot, mul in K1_MODES:
        name_mode = bench_gemm.mode_name(layout, f32s, dot,
                                         "bf16" if mul == torch.bfloat16 else "f32")
        for m in bench_gemm.MS:
            main = m in GEMM_MAIN.get((layout, f32s, dot, mul), ())
            for name in K1_SHAPES:
                row = kernel_q4(timer, gen, name, m, main and name != "output", reps=10,
                                plain_reps=2, f32_scales=f32s, layout=layout, dot=dot, mul=mul)
                row["wmma_ms"] = wmma.get((name_mode, name, m))
                rows.append(row)
                emit({"phase": "kernel", **row})
    return rows


# the probes' entry points as `phase_probes` drives them: (module, argv)
PROBE_RUNS = (("bench_unpack_trick", []), ("bench_int8_mxu", []),
              ("bench_unpack2", ["--batch", "8"]), ("bench_unpack2", ["--batch", "1"]),
              ("bench_unpack2", ["--perm-probe"]), ("bench_i4_stacked", []),
              ("bench_prefill_ownrows", []))


def phase_probes(reps: int) -> tuple[dict, dict, list[dict]]:
    """The Hopper probes of `llamavk_tpu_torch/tools/` (P1-P5) through their
    entry points (`main`, as `python -m` runs them), every probe kernel at
    each of its TPU probe's shapes on seeded random bytes and scales: each
    against its plain version (the bf16-weight variants within K1's limit
    and with their unpacked weights bit-equal to the plain ones, trick's to
    the shift unpack's; the int8 dots exact at unit scales and within the
    fold's sum-order bound; the prefill's cache rows byte-equal, the rows
    past a call unchanged, its output within 2^-6 attention(q, k, |v|)),
    timed beside the production kernel (K1, K2), its bound and one PyTorch
    call. Every probe kernel must launch. Returns the summary, the probes'
    launch counts and the rows."""
    import importlib

    from llamavk_tpu_torch import tools

    KERNEL_META.update(tools.KERNELS)
    tools.reset_counts()
    rows = []
    for name, argv in PROBE_RUNS:
        mod = importlib.import_module(f"llamavk_tpu_torch.tools.{name}")
        for row in mod.main(argv + ["--reps", str(reps)]):
            emit({"phase": "probe", "probe": name, **row})
            rows.append(row)
    counts = tools.launch_counts()
    idle = [k for k in tools.KERNELS if counts[k] == 0]
    if idle:
        raise SystemExit(f"probes: kernels never launched: {idle}")
    bad = [f"{r['kernel']} {r['shape']}" for r in rows if not r["ok"]]
    if bad:
        raise SystemExit(f"probes: kernels disagree with their plain versions at {bad}")
    # an integer product's library call must compute that exact product
    inexact = [f"{r['kernel']} {r['shape']}" for r in rows if r.get("library_exact") is False]
    if inexact:
        raise SystemExit(f"probes: library calls not exact at {inexact}")
    return {"rows": len(rows), "launches": counts}, counts, rows


def phase_tiny_cli(work: Path) -> dict:
    from llamavk_tpu_torch.cli import generate as cli
    from llamavk_tpu_torch.models.loader import random_tiny_model

    path = str(work / "tiny-q4.bin")
    random_tiny_model(write_path=path, quantize=True)
    result = {}
    for kv in ("bfloat16", "int8"):
        outs = {}
        for device in ("cuda", "cpu"):
            args = cli.build_argparser().parse_args(
                ["-m", path, "-p", TINY_PROMPT, "-n", "16", "--temp", "0", "-s", "42",
                 "--kv-dtype", kv, "--device", device]
            )
            buf = io.StringIO()
            if cli.run(args, stdout=buf) != 0:
                raise SystemExit(f"tiny_cli: run on {device} ({kv}) failed")
            outs[device] = buf.getvalue()
        if outs["cuda"] != outs["cpu"]:
            raise SystemExit(f"tiny_cli ({kv}): card and CPU streams differ:\n"
                             f"{outs['cuda']!r}\n{outs['cpu']!r}")
        result[kv] = {"tokens_text": outs["cuda"].strip(), "equal_to_cpu": True}
    # the history ring: the 37-token prompt alone wraps a 32-row ring (keep
    # 4), then 30 tokens. Over 30 tokens every top-2 logit gap stays above
    # 0.013 on the CPU (bf16 and int8); by 60 every prompt tried has reached
    # gaps of 0.001-0.009, below the kernels' drift
    for kv in ("bfloat16", "int8"):
        outs = {}
        for device in ("cuda", "cpu"):
            args = cli.build_argparser().parse_args(
                ["-m", path, "-p", TINY_PROMPT, "-n", "30", "-c", "32", "--n-keep", "4",
                 "--ctx-swap", "ring", "--temp", "0", "-s", "42", "--ignore-eos", "--kv-dtype",
                 kv, "--device", device])
            buf = io.StringIO()
            with contextlib.redirect_stderr(io.StringIO()):
                if cli.run(args, stdout=buf) != 0:
                    raise SystemExit(f"tiny_cli: ring run on {device} ({kv}) failed")
            outs[device] = buf.getvalue()
        if outs["cuda"] != outs["cpu"]:
            raise SystemExit(f"tiny_cli (ring, {kv}): card and CPU streams differ:\n"
                             f"{outs['cuda']!r}\n{outs['cpu']!r}")
        result[f"ring {kv}"] = {"tokens_text": outs["cuda"].strip(), "equal_to_cpu": True}
    # the re-evaluating context swap (-c 24: a 14-token prompt and 24 tokens
    # swap twice) on the card, through the decode graph and through the
    # uncaptured step: equal text
    outs = {}
    for mode in ("graph", "uncaptured"):
        args = cli.build_argparser().parse_args(
            ["-m", path, "-p", "<t148><t159>", "-n", "24", "-c", "24", "--n-keep", "4",
             "--temp", "0", "-s", "42", "--ignore-eos", "--device", "cuda"])
        buf = io.StringIO()
        with contextlib.redirect_stderr(io.StringIO()), \
                _uncaptured() if mode == "uncaptured" else contextlib.nullcontext():
            if cli.run(args, stdout=buf) != 0:
                raise SystemExit(f"tiny_cli: reeval swap run ({mode}) failed")
        outs[mode] = buf.getvalue()
    if outs["graph"] != outs["uncaptured"]:
        raise SystemExit(f"tiny_cli (reeval swap): graph and uncaptured streams differ:\n"
                         f"{outs['graph']!r}\n{outs['uncaptured']!r}")
    result["reeval swap"] = {"tokens_text": outs["graph"].strip(),
                             "graph_equal_to_uncaptured": True}
    # an interactive session: -i -r J with two scripted turns of stdin, then
    # EOF, on a tiny file (seed 5) whose session keeps every top-2 logit gap
    # above 0.105 on the CPU
    path5 = str(work / "tiny5-q4.bin")
    random_tiny_model(write_path=path5, quantize=True, seed=5)
    outs = {}
    for device in ("cuda", "cpu"):
        args = cli.build_argparser().parse_args(
            ["-m", path5, "-p", "go", "-i", "-r", "J", "-n", "8", "--temp", "0", "-c", "128",
             "--device", device])
        buf = io.StringIO()
        with contextlib.redirect_stderr(io.StringIO()):
            if cli.run(args, stdin=_Lines(["ok\n", "go\n"]), stdout=buf) != 0:
                raise SystemExit(f"tiny_cli: interactive session on {device} failed")
        outs[device] = buf.getvalue()
    if outs["cuda"] != outs["cpu"] or outs["cuda"].count("\n> ") != 3:
        raise SystemExit(f"tiny_cli (interactive): card and CPU sessions differ:\n"
                         f"{outs['cuda']!r}\n{outs['cpu']!r}")
    result["interactive -i -r J"] = {"text": outs["cuda"].strip(), "equal_to_cpu": True}
    return result


class _Lines:
    """A scripted stdin: one line per readline, then EOF."""

    def __init__(self, lines: list[str]):
        self.lines = list(lines)

    def readline(self) -> str:
        return self.lines.pop(0) if self.lines else ""


def _reset_counts() -> None:
    """Every launch counter to 0."""
    from llamavk_tpu_torch.ops import flash_attn as fa
    from llamavk_tpu_torch.ops import flash_decode as fd
    from llamavk_tpu_torch.ops import q4_matmul as q4

    for d in (q4.launches, fa.launches, fd.launches):
        for key in d:
            d[key] = 0


def _reset_shapes() -> None:
    """Every kernel's shape counter emptied."""
    from llamavk_tpu_torch.ops import flash_attn as fa
    from llamavk_tpu_torch.ops import flash_decode as fd
    from llamavk_tpu_torch.ops import q4_matmul as q4

    for c in (q4.shapes, q4.shapes_f32, q4.shapes_i8, q4.shapes_modes, fa.shapes, fd.shapes):
        c.clear()


def _shapes() -> dict:
    """The shapes every kernel was launched at since the last
    `_reset_shapes`, with their launch counts: {"q4", "q4_f32" (f32 scales)
    and "q4_i8": {(M, K, N): n}, "q4_modes": {(launch key, M, K, N): n},
    "attn": {(path, B, T, H, S, D, block_k,
    cache type, n_past, MAXLB, straddle, mode): n}, "decode": {(B, H, S, D,
    block_k, cache type, MAXLB): n}}."""
    from llamavk_tpu_torch.ops import flash_attn as fa
    from llamavk_tpu_torch.ops import flash_decode as fd
    from llamavk_tpu_torch.ops import q4_matmul as q4

    return {"q4": dict(q4.shapes), "q4_f32": dict(q4.shapes_f32), "q4_i8": dict(q4.shapes_i8),
            "q4_modes": dict(q4.shapes_modes), "attn": dict(fa.shapes),
            "decode": dict(fd.shapes)}


def _counts() -> dict:
    """Launches by kernel name (KERNEL_META's keys) since the last reset."""
    from llamavk_tpu_torch.ops import flash_attn as fa
    from llamavk_tpu_torch.ops import flash_decode as fd
    from llamavk_tpu_torch.ops import q4_matmul as q4

    counts = {f"q4_{k}": n for k, n in q4.launches.items()}
    counts.update({f"attn_{k}": n for k, n in fa.launches.items()})
    counts.update(fd.launches)
    return counts


def _require(phase: str, counts: dict, kernels) -> None:
    """Fail unless each of `kernels` was launched on the path just driven."""
    missing = [k for k in kernels if counts[k] == 0]
    if missing:
        raise SystemExit(f"{phase}: kernels never launched on the main path: {missing}")


# kernel against plain forward passes on the 7B synthetic model: both keep
# bf16 activations and sum in f32 in different orders, so an activation can
# land one bf16 rounding step apart after any matmul and carry that through
# 32 layers. The logits may drift by at most one bf16 step (2^-8) of the
# largest logit, and the argmax must agree where the top-2 gap is wider.
LOGIT_REL_LIMIT = 2.0**-8


def _device_busy(fn, keep: int | None = 8) -> tuple[float, float | None, int, dict]:
    """Host wall time (ms) of fn, the device time inside it from
    torch.profiler (None when the profiler sees no device activity), the
    number of device activities (kernels and copies), and the device ms of
    the `keep` activities that took most (None: all), by name."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    from torch.autograd import DeviceType

    def dev_ms(e) -> float:
        us = getattr(e, "self_device_time_total", 0) or getattr(e, "self_cuda_time_total", 0)
        return us / 1e3

    dev = sorted((e for e in prof.key_averages() if e.device_type == DeviceType.CUDA),
                 key=dev_ms, reverse=True)
    busy = sum(map(dev_ms, dev))
    top: dict = {}
    for e in dev[:keep]:
        top[e.key[:80]] = top.get(e.key[:80], 0.0) + dev_ms(e)
    return wall, (busy if busy > 0 else None), sum(e.count for e in dev), top


@contextlib.contextmanager
def _uncaptured():
    """Decode through the uncaptured step, the CUDA graphs' plain version,
    in every Engine and BatchedEngine while inside (their private
    `_run_uncaptured` in place of `_run_block`)."""
    from llamavk_tpu_torch.runtime.batching import BatchedEngine
    from llamavk_tpu_torch.runtime.engine import Engine

    saved = [(cls, cls._run_block) for cls in (Engine, BatchedEngine)]
    for cls, _ in saved:
        cls._run_block = cls._run_uncaptured
    try:
        yield
    finally:
        for cls, run in saved:
            cls._run_block = run


def _same_streams(what: str, graph: list, plain: list) -> int:
    """Fail unless the graph's token streams equal the uncaptured step's,
    token for token; returns the tokens compared."""
    for i, (a, b) in enumerate(zip(graph, plain)):
        if a != b:
            at = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y), min(len(a), len(b)))
            raise SystemExit(f"{what}: stream {i} through the graph parts from the uncaptured "
                             f"step at token {at}")
    if len(graph) != len(plain):
        raise SystemExit(f"{what}: {len(graph)} graph streams, {len(plain)} uncaptured")
    return sum(len(a) for a in graph)


def _engine_graph_check(eng, prompt: list[int], n: int, sp, seed: int, what: str) -> dict:
    """One Engine's stream of n tokens through its decode graph and through
    the uncaptured step, each from a reset engine seeded alike: equal token
    for token."""
    runs = []
    for plain in (False, True):
        eng.reset()
        eng.set_seed(seed)
        with _uncaptured() if plain else contextlib.nullcontext():
            runs.append(eng.generate(prompt, n, sp, ignore_eos=True))
    return {"tokens_equal": _same_streams(what, runs[:1], runs[1:]), "sampled": sp.temp > 0}


def _decode_timing(eng, sp, n_blocks: int = 4, reps: int = 2) -> dict:
    """Decode blocks alone (`Engine._decode_block` of ecfg.decode_block
    steps and the block's host read, from the engine's position, which does
    not advance), through the graph and through the uncaptured step,
    alternated `reps` times on the host clock, then once each under the
    profiler: wall ms a token, device busy ms a token, device activities a
    step, idle share (busy over the unprofiled wall time)."""
    n = eng.ecfg.decode_block
    last = torch.full((sp.repeat_last_n,), -1, dtype=torch.int64, device="cuda")
    tok = torch.tensor(7, device="cuda")

    def run():
        for _ in range(n_blocks):
            eng._decode_block(tok, last, sp, n)[0].tolist()

    out: dict = {}
    walls: dict = {"graph": [], "uncaptured": []}
    for _ in range(reps):
        for mode in walls:
            with _uncaptured() if mode == "uncaptured" else contextlib.nullcontext():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                run()
                torch.cuda.synchronize()
                walls[mode].append((time.perf_counter() - t0) * 1e3 / (n_blocks * n))
    for mode, ms in walls.items():
        with _uncaptured() if mode == "uncaptured" else contextlib.nullcontext():
            wall, busy, n_dev, top = _device_busy(run)
        wall_ms = statistics.median(ms)
        out[mode] = {
            "wall_ms_per_token": wall_ms, "wall_ms_runs": ms,
            "profiled_wall_ms_per_token": wall / (n_blocks * n),
            "device_busy_ms_per_token": None if busy is None else busy / (n_blocks * n),
            "device_activities_per_step": n_dev / (n_blocks * n),
            "device_idle_share": None if busy is None else 1 - busy / (n_blocks * n) / wall_ms,
            "device_ms_per_token_by_name": {k: v / (n_blocks * n) for k, v in top.items()},
        }
    return out


def _k5_device_ms(fn) -> dict:
    """The device ms of one call of fn in K5's launches by kernel (the
    quantization, the group dot; the split sums, which K1's launches
    share), and in all kernels."""
    _, busy, _, by_name = _device_busy(fn, keep=None)
    out = {name: sum(ms for key, ms in by_name.items() if name in key)
           for name in ("quantize_kernel", "i8_mma_kernel", "split_sum_kernel")}
    return {**out, "all": busy or 0.0}


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

    prompt0 = torch.randint(3, cfg.n_vocab, (1, 32), generator=gen).cuda()
    both(prompt0, 0)
    steps = []
    for i in range(4):
        steps.append(logits[True][-1][0, -1].argmax().view(1, 1))  # the plain stream's token
        both(steps[-1], 32 + i)
    # the decode graphs' position, an int32 [1] device tensor, against the
    # host int through the kernels: the same logits and cache rows, bit for bit
    vec = init_kv_cache(cfg, 1, N_CTX, device="cuda")
    llama_forward(params, prompt0, vec, 0, cfg)
    for i, tok in enumerate(steps):
        lg, _, _ = llama_forward(params, tok, vec, torch.tensor([32 + i], dtype=torch.int32,
                                                                device="cuda"), cfg)
        if not torch.equal(lg, logits[False][1 + i]):
            raise SystemExit(f"generate_7b: decode step {i} at an int32 [1] n_past differs "
                             "from the host int's")
    if not all(torch.equal(a[:, :, :, :36], b[:, :, :, :36])
               for a, b in zip(vec.planes(), caches[False].planes())):
        raise SystemExit("generate_7b: cache rows at an int32 [1] n_past differ from the host int's")
    del vec
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
    # where a decode step's time goes: decode blocks through the graph and
    # through the uncaptured step, alternated on the host clock, then under
    # the profiler for the device's busy time. The profiler slows the host,
    # so the idle share divides the busy time by the unprofiled wall time.
    timing = _decode_timing(eng, greedy)
    graph_stats = eng.graph_stats()
    if len(out1) != 128 or len(out2) != 16:
        raise SystemExit("generate_7b: short generation")
    # K1: 4 matmuls per layer + the output matmul, per forward pass
    forwards1 = 1 + (len(out1) - 1)
    k1_1 = counts1["q4_gemv"] + counts1["q4_gemm"]
    if k1_1 != (4 * cfg.n_layer + 1) * forwards1:
        raise SystemExit(f"generate_7b: {k1_1} K1 launches for {forwards1} forward passes")
    # decode on the split route; the prompt (T 32) and the second turn's read
    # (T 301 in a 353-row bucket) on the tensor cores
    _require("generate_7b", counts1, ("q4_gemv", "q4_gemm", "attn_update_split",
                                      "attn_update_tc"))
    _require("generate_7b (turn 2)", {k: n - counts1[k] for k, n in counts.items()},
             ("q4_gemm", "attn_read_tc"))
    # the graphs' streams against the uncaptured step's on the card: greedy
    # and seeded sampled bf16, then int8 and f32 engines
    streams = {
        "bf16_greedy": _engine_graph_check(eng, prompt1, 128, greedy, seed,
                                           "generate_7b (bf16 greedy)"),
        "bf16_sampled": _engine_graph_check(eng, prompt1, 64, SamplerParams(), seed + 1,
                                            "generate_7b (bf16 sampled)"),
    }
    del eng
    torch.cuda.empty_cache()
    for kv in ("int8", "float32"):
        other = Engine(cfg, params, EngineConfig(n_ctx=N_CTX, kv_dtype=kv, seed=seed),
                       device="cuda")
        for name, sp in (("greedy", greedy), ("sampled", SamplerParams())):
            streams[f"{kv}_{name}"] = _engine_graph_check(other, prompt1, 32, sp, seed + 2,
                                                          f"generate_7b ({kv} {name})")
        graph_stats[f"{kv}_capture_s"] = other.graph_stats()["capture_s"]
        del other
        torch.cuda.empty_cache()
    g = timing["graph"]
    result = {
        "params_s": round(t_params, 3), "kernel_vs_plain": cmp, "limit_rel": LOGIT_REL_LIMIT,
        "vector_n_past_bit_equal_to_int": {"steps": len(steps), "cache_rows": 36},
        "prefill_tokens": len(prompt1), "prefill_ms": prefill_ms,
        "decode_tokens": n_decode, "decode_ms_per_token": decode_ms,
        "tok_per_s": 1e3 / decode_ms, "k1_launches_per_token": k1_1 / forwards1,
        "turn2_prompt": len(prompt2), "turn2_prefill_ms": turn2_prefill_ms,
        "turn2_tokens": len(out2), "peak_mem_bytes": peak, "launches": counts,
        "wall_ms_per_step": g["wall_ms_per_token"],
        "profiled_wall_ms_per_step": g["profiled_wall_ms_per_token"],
        "device_busy_ms_per_step": g["device_busy_ms_per_token"],
        "device_activities_per_step": g["device_activities_per_step"],
        "device_idle_share": g["device_idle_share"], "decode_timing": timing,
        "graph_capture_s": graph_stats["capture_s"], "graph_pool_bytes": graph_stats["pool_bytes"],
        "graphs": graph_stats, "graph_vs_uncaptured_streams": streams,
    }
    return result, counts


GAMMA = 4  # the speculative phases' draft rows per round (--draft-n, --lookup-gamma)
# generate_7b_lookup's and spec_7b_self's depth: 7B's full width, 16 of its
# 32 layers, to keep the script in its time
LOOKUP_LAYERS = 16
# the lookup runs timed and profiled for the idle share, in tokens
# (--lookup-idle-tokens; the profiler's own cost grows with the window)
LOOKUP_IDLE_TOKENS = (16,)


def _cli_7b(argv: list[str], cfg, params, out: io.StringIO | None = None) -> tuple[str, str]:
    """(stdout, stderr) of the generate CLI run in this process on the
    synthetic 7B model: its loader hands back (cfg, params) and the id
    vocabulary for any path, so --draft-model drafts with the same weights
    (one copy in memory). `out` receives the CLI's output when given."""
    from llamavk_tpu_torch.cli import generate as cli

    tok = _id_tokenizer(cfg.n_vocab)
    load = cli.load_model
    cli.load_model = lambda path, device="cuda": (cfg, params, tok)
    out, err = out or io.StringIO(), io.StringIO()
    try:
        with contextlib.redirect_stderr(err):
            rc = cli.run(cli.build_argparser().parse_args(["-m", "synthetic-7B", *argv]),
                         stdout=out)
    finally:
        cli.load_model = load
    if rc != 0:
        raise SystemExit(f"generate CLI {argv} exited with {rc}:\n{err.getvalue()[-2000:]}")
    return out.getvalue(), err.getvalue()


def _lookup_prompt(seed: int) -> tuple[str, list[int]]:
    """A seeded 16-letter pattern repeated three times, as prompt text and as
    the CLI's token ids (the id vocabulary has no letters: each byte falls
    back to id byte + 3, after BOS and the CLI's leading space)."""
    gen = torch.Generator().manual_seed(seed + 7)
    pattern = "".join(chr(ord("a") + int(i)) for i in torch.randint(0, 26, (16,), generator=gen))
    text = pattern * 3
    return text, [1] + [b + 3 for b in (" " + text).encode()]


def _lookup_cli_runs(seed: int) -> tuple[dict, dict]:
    """generate_7b_lookup under the dot mode this process was started with:
    the generate CLI with --draft-lookup --draft-n 4 (128 tokens), then plain
    greedy through the same CLI, counters reset before each; the two streams
    must be equal, or part only at a near tie. Under i8 also one B=32 decode
    step against the plain path (K5 and, for w2, K1)."""
    from llamavk_tpu_torch.ops import q4_matmul as q4
    from llamavk_tpu_torch.runtime.speculative import LookupEngine, SpecConfig

    t_start = time.perf_counter()
    cfg, params = _model_7b(seed, LOOKUP_LAYERS)
    text, prompt = _lookup_prompt(seed)
    argv = ["-p", text, "-n", "128", "-c", str(N_CTX), "--temp", "0", "--ignore-eos"]
    _reset_shapes()
    marks = {"model": time.perf_counter()}
    _cli_7b(argv + ["-n", "8", "--draft-lookup", "--draft-n", str(GAMMA)], cfg, params)  # warm-up
    torch.cuda.synchronize()
    marks["warm-up"] = time.perf_counter()
    _reset_counts()
    out, err = _cli_7b(argv + ["--draft-lookup", "--draft-n", str(GAMMA)], cfg, params)
    marks["lookup cli"] = time.perf_counter()
    counts = _counts()
    m = re.search(r"lookup-speculative: (\d+) tokens in (\d+) rounds \(([\d.]+) tok/round, "
                  r"([\d.]+) ms/round\)", err)
    if m is None:
        raise SystemExit(f"generate_7b_lookup: no lookup line in {err[-1000:]!r}")
    emitted, rounds, ms_round = int(m[1]), int(m[2]), float(m[4])
    lookup = _ids(out)
    _reset_counts()
    pout, perr = _cli_7b(argv, cfg, params)
    plain_counts = _counts()
    plain = _ids(pout)[len(prompt):]
    marks["plain cli"] = time.perf_counter()
    pm = re.search(r"eval += +([\d.]+) ms / (\d+) tokens .*?([\d.]+) tok/s", perr)
    if len(lookup) != 128 or len(plain) != 128 or pm is None:
        raise SystemExit(f"generate_7b_lookup: {len(lookup)} lookup and {len(plain)} plain tokens")
    # the device's share of a lookup block: each window's tokens driven on
    # the engine, on the host clock, then again under the profiler (prefill
    # included)
    eng = LookupEngine(cfg, params, SpecConfig(n_ctx=N_CTX, gamma=GAMMA), device="cuda")
    windows = []
    for n_tokens in LOOKUP_IDLE_TOKENS:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.generate(prompt, n_tokens, ignore_eos=True)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        n_rounds = eng.stats["rounds"]
        marks[f"idle window {n_tokens}"] = time.perf_counter()
        _, busy_ms, _, top = _device_busy(lambda: eng.generate(prompt, n_tokens,
                                                              ignore_eos=True))
        marks[f"profiled window {n_tokens}"] = time.perf_counter()
        windows.append({
            "idle_window_tokens": n_tokens, "idle_window_rounds": n_rounds,
            "wall_ms_per_round": wall_ms / n_rounds,
            "device_busy_ms_per_round": None if busy_ms is None else busy_ms / n_rounds,
            "device_idle_share": None if busy_ms is None else 1 - busy_ms / wall_ms,
            "device_ms_per_round_by_name": {k: v / n_rounds for k, v in top.items()},
        })
    del eng
    shapes = _shapes()  # of the lookup and plain runs, held to the plain versions below
    mode = q4.resolve_dot_mode()
    split = _split_at(cfg, params, prompt, lookup, plain, f"generate_7b_lookup ({mode})",
                      torch.bfloat16, None)
    marks["split"] = time.perf_counter()
    result = {
        "dot": mode, "prompt_tokens": len(prompt), "tokens": emitted, "rounds": rounds,
        "tok_per_round": emitted / rounds, "ms_per_round": ms_round,
        "tok_per_s": emitted / (rounds * ms_round / 1e3),
        "plain_greedy_tok_per_s": float(pm[3]), "plain_ms_per_token": float(pm[1]) / int(pm[2]),
        "equal_to_plain_greedy": split is None, "split_at_near_tie": split,
        **windows[0], "idle_windows": windows[1:],
        "launches": counts, "plain_launches": plain_counts, "plain_stream": plain,
    }
    if mode == "i8":
        result["decode_step_b32"] = _decode_step_check(params, cfg, seed)
        marks["decode step"] = time.perf_counter()
        k5 = {"q4_i8": counts["q4_i8"] + plain_counts["q4_i8"]}
        _require("generate_7b_lookup (i8)", k5, ("q4_i8",))
        # perplexity --f32 -c 64 under the int8 dot: f32 scales, 64 rows,
        # so K5 over f32 scales for every K = 4096 matmul (w2 takes K1)
        result["perplexity_f32_c64"], ppl_counts = _perplexity_f32(
            cfg, seed, 64, "generate_7b_lookup (i8, perplexity --f32 -c 64)")
        _require("generate_7b_lookup (i8, perplexity --f32 -c 64)", ppl_counts,
                 ("q4_i8_f32", "q4_gemm_f32"))
        for key, n in ppl_counts.items():
            counts[key] += n
        marks["perplexity"] = time.perf_counter()
        shapes = _shapes()  # the perplexity chunk's K1 shapes too
        result.update(_shape_report(shapes))
        result["shape_rows"] = phase_serve_shapes(shapes, seed, 5, "generate_7b_lookup_i8")
        marks["shape rows"] = time.perf_counter()
    # where the phase's time goes, by section
    names, times = list(marks), [t_start, *marks.values()]
    result["seconds"] = {name: round(b - a, 2) for name, a, b in zip(names, times, times[1:])}
    return result, counts


def phase_generate_7b_lookup(seed: int) -> tuple[dict, dict]:
    """The lookup CLI and plain greedy on synthetic 7B, with the default dot
    here and under LLAMAVK_Q4_DOT=i8 in a process of its own (the variable
    is read at import). Returns (result, the lookup runs' launches)."""
    bf16, counts = _lookup_cli_runs(seed)
    _require("generate_7b_lookup", counts, ("q4_gemm", "attn_update_split"))
    i8 = _run_child("lookup_i8_child", seed, {"LLAMAVK_Q4_DOT": "i8"})
    counts = {key: n + i8["launches"][key] for key, n in counts.items()}
    return {"bf16": bf16, "i8": i8}, counts


def _run_child(phase: str, seed: int, env: dict) -> dict:
    """The result of this script's `phase` in a process of its own, under the
    environment variables `env` (the dot and multiply modes are read at
    import)."""
    proc = subprocess.run(
        [sys.executable, str(Path(__file__).resolve()), "--phases", phase, "--seed", str(seed),
         "--lookup-idle-tokens", ",".join(map(str, LOOKUP_IDLE_TOKENS))],
        cwd=ROOT, env=dict(os.environ, **env), capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        raise SystemExit(f"{phase} ({env}) failed:\n{proc.stderr[-3000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def phase_spec_7b_self(seed: int, plain: list[int] | None) -> tuple[dict, dict]:
    """generate --draft-model with the 7B weights as target and draft (one
    copy), greedy, 64 tokens: the stream equals plain greedy (`plain`, the
    lookup phase's, or computed here), or parts only at a near tie; every
    draft is accepted unless it does."""
    cfg, params = _model_7b(seed, LOOKUP_LAYERS)
    text, prompt = _lookup_prompt(seed)
    argv = ["-p", text, "-n", "64", "-c", str(N_CTX), "--temp", "0", "--ignore-eos",
            "--draft-model", "synthetic-7B", "--draft-n", str(GAMMA)]
    _reset_counts()
    out, err = _cli_7b(argv, cfg, params)
    counts = _counts()
    m = re.search(r"speculative: (\d+) tokens in (\d+) rounds, acceptance \d+% \((\d+) drafts "
                  r"accepted, ([\d.]+) ms/round\)", err)
    if m is None:
        raise SystemExit(f"spec_7b_self: no speculative line in {err[-1000:]!r}")
    emitted, rounds, accepted, ms_round = int(m[1]), int(m[2]), int(m[3]), float(m[4])
    if plain is None:
        plain = _ids(_cli_7b(argv[:9], cfg, params)[0])[len(prompt):]
    got = _ids(out)
    split = _split_at(cfg, params, prompt, got, plain[:64], "spec_7b_self", torch.bfloat16, None)
    rate = accepted / (rounds * (GAMMA - 1))
    if split is None and rate < 1.0:
        raise SystemExit(f"spec_7b_self: acceptance {rate:.3f} with the plain greedy stream")
    _require("spec_7b_self", counts, ("q4_gemv", "q4_gemm", "attn_update_split"))
    return {"tokens": emitted, "rounds": rounds, "accepted": accepted, "acceptance_rate": rate,
            "ms_per_round": ms_round, "tok_per_s": emitted / (rounds * ms_round / 1e3),
            "equal_to_plain_greedy": split is None, "split_at_near_tie": split,
            "launches": counts}, counts


def _post(base: str, path: str, body: dict) -> tuple[int, bytes]:
    req = urllib.request.Request(base + path, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=600) as r:
        return r.status, r.read()


def _complete(base: str, body: dict) -> dict:
    """POST one completion; returns its text, status, finish reason and, for
    a streamed one, the seconds to its first text chunk."""
    t0 = time.perf_counter()
    if not body.get("stream"):
        status, data = _post(base, "/v1/completions", body)
        choice = json.loads(data)["choices"][0]
        return {"status": status, "text": choice["text"], "finish": choice["finish_reason"],
                "seconds": time.perf_counter() - t0}
    req = urllib.request.Request(base + "/v1/completions", data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"}, method="POST")
    parts, finish, first = [], None, None
    with urllib.request.urlopen(req, timeout=600) as r:
        status = r.status
        for raw in r:
            line = raw.decode().strip()
            if not line.startswith("data: ") or line == "data: [DONE]":
                continue
            choice = json.loads(line[len("data: "):])["choices"][0]
            if first is None and choice["text"]:
                first = time.perf_counter() - t0
            parts.append(choice["text"])
            finish = choice["finish_reason"] or finish
    return {"status": status, "text": "".join(parts), "finish": finish,
            "seconds": time.perf_counter() - t0, "first_chunk_s": first}


def _serve(srv) -> tuple[str, threading.Thread]:
    """Start srv's HTTP front door on a free port of 127.0.0.1."""
    httpd = srv.start("127.0.0.1", 0)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    return f"http://127.0.0.1:{httpd.server_address[1]}", thread


def _concurrently(base: str, bodies: list[dict]) -> list[dict]:
    """Post every body at once, one client thread each."""
    out: list = [None] * len(bodies)

    def run(i):
        out[i] = _complete(base, bodies[i])

    threads = [threading.Thread(target=run, args=(i,)) for i in range(len(bodies))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
    if any(o is None for o in out):
        raise SystemExit("serve: a client got no answer")
    return out


def _start_serve_cli(path: str, kv: str, extra: list[str]) -> subprocess.Popen:
    """The serve CLI started in its own process on the card (with the flags
    `extra`); `_serve_cli_answers` talks to it and stops it. The tiny_serve
    phase starts all of its CLIs together, so their start-up times overlap."""
    return subprocess.Popen(
        [sys.executable, "-m", "llamavk_tpu_torch.cli.serve", "-m", path, "--port", "0",
         "--max-batch", "4", "-c", "64", "--block", "4", "--kv-dtype", kv, "--device", "cuda",
         *extra],
        cwd=ROOT, stderr=subprocess.PIPE, text=True)


def _serve_cli_answers(proc: subprocess.Popen, bodies: list[dict]) -> list[dict]:
    """Answers to `bodies` from a serve CLI process, which is stopped before
    returning."""
    try:
        for line in proc.stderr:  # the loader's line, then "llamavk serving ... on <url>"
            if " serving " in line:
                return _concurrently(line.split(" on ")[-1].strip(), bodies)
        raise SystemExit(f"tiny_serve: the serve CLI exited with {proc.wait()}")
    finally:
        proc.terminate()
        proc.wait(timeout=60)


def _cpu_streams(path: str, bcfg, n_tokens: int) -> list[str]:
    """The CPU batched engine's greedy texts for TINY_SERVE_PROMPTS."""
    from llamavk_tpu_torch.models.loader import load_model
    from llamavk_tpu_torch.runtime.batching import BatchedEngine
    from llamavk_tpu_torch.runtime.sampling import SamplerParams

    cfg, params, tok = load_model(path, device="cpu")
    be = BatchedEngine(cfg, params, bcfg, device="cpu")
    reqs = [be.submit(p, n_tokens, SamplerParams(temp=0.0), ignore_eos=True)
            for p in TINY_SERVE_PROMPTS]
    be.run()
    return [b"".join(tok.decode_token(t) for t in r.generated).decode() for r in reqs]


def phase_tiny_serve(work: Path) -> tuple[dict, dict]:
    """The server on the card, bf16 and int8 KV, flat and paged (pages of 8
    rows bf16, 32 int8): 4 concurrent greedy requests, to a LlamaServer in
    this process and to the serve CLI in its own (flat: also with --tp 2,
    two ranks of the CLI), whose streams must equal the CPU batched
    engine's; paged, the CPU's paged streams must also equal its flat
    engine's at kv_block = page_size."""
    from llamavk_tpu_torch.models.loader import random_tiny_model

    path = str(work / "tiny-q4.bin")
    random_tiny_model(write_path=path, quantize=True)
    n_tokens = 6
    result, counts = {}, dict.fromkeys(KERNEL_META, 0)
    configs = (("bfloat16", 0), ("int8", 0), ("bfloat16", 8), ("int8", 32))
    clis = {}  # every CLI process of the phase, started together
    try:
        for kv, ps in configs:
            extra = ["--paged", "--page-size", str(ps)] if ps else []
            runs = {"serve CLI": extra, "serve CLI --lookup-gamma": extra + ["--lookup-gamma",
                                                                             str(GAMMA)]}
            if not ps:  # serve --tp 2: two ranks of the CLI on the one card (gloo)
                runs["serve CLI --tp 2"] = ["--tp", "2"]
            for who, flags in runs.items():
                clis[(kv, ps, who)] = _start_serve_cli(path, kv, flags)
        _tiny_serve_checks(path, configs, clis, n_tokens, result, counts)
    finally:
        for proc in clis.values():
            if proc.poll() is None:
                proc.terminate()
                proc.wait(timeout=60)
    result.update(_tiny_shared(path, n_tokens, counts))
    _require("tiny_serve", counts, ("decode", "decode_i8", "attn_update_split",
                                    "attn_update_split_i8", "decode_paged", "decode_paged_i8",
                                    "attn_update_paged_split", "attn_update_paged_split_i8",
                                    "attn_update_prefix_split", "attn_update_prefix_split_i8",
                                    "attn_update_prefix_split_f32"))
    return result, counts


def _tiny_serve_checks(path: str, configs, clis: dict, n_tokens: int, result: dict,
                       counts: dict) -> None:
    """tiny_serve's checks of each cache configuration: the in-process
    server's streams, then each started CLI's, against the CPU's."""
    from llamavk_tpu_torch.models.loader import load_model
    from llamavk_tpu_torch.runtime.batching import BatchConfig
    from llamavk_tpu_torch.runtime.server import LlamaServer

    for kv, ps in configs:
        bcfg = BatchConfig(max_batch=4, n_ctx=64, block=4, kv_dtype=kv, paged=ps > 0,
                           page_size=ps or 128)
        want = _cpu_streams(path, bcfg, n_tokens)
        name = f"{kv} paged {ps}" if ps else kv
        if ps and want != _cpu_streams(path, dataclasses.replace(bcfg, paged=False, kv_block=ps),
                                       n_tokens):
            raise SystemExit(f"tiny_serve ({name}): CPU paged and flat streams differ")
        cfg, params, tok = load_model(path, device="cuda")
        srv = LlamaServer(cfg, params, tok, bcfg, device="cuda")
        base, thread = _serve(srv)
        bodies = [dict(prompt=p, max_tokens=n_tokens, temperature=0.0, ignore_eos=True)
                  for p in TINY_SERVE_PROMPTS]
        _reset_counts()
        got = _concurrently(base, bodies)
        for key, n in _counts().items():
            counts[key] += n
        srv.shutdown()
        thread.join(timeout=30)
        answers = {"server": got}
        for (ckv, cps, who), proc in clis.items():
            if (ckv, cps) == (kv, ps):
                answers[who] = _serve_cli_answers(proc, bodies)
        for who, ans in answers.items():
            texts = [a["text"] for a in ans]
            if texts != want:
                raise SystemExit(f"tiny_serve ({name}, {who}): card streams {texts} differ "
                                 f"from the CPU's {want}")
        result[name] = {"streams": want, "server_and_cli_equal_to_cpu": True,
                        "lookup_cli_equal_to_cpu": True}
        if ps:
            result[name]["cpu_equal_to_flat_at_kv_block"] = ps
        else:
            result[name]["tp2_cli_equal_to_cpu"] = True


# the tiny shared-prefix server's registered prefix: with it, each of
# TINY_SERVE_PROMPTS keeps every top-2 logit gap above 0.088 for 6 tokens on
# the CPU, over bf16 and int8 slots
TINY_PREFIX = [191, 61, 40, 167, 138, 69, 79]


def _tiny_shared(path: str, n_tokens: int, counts: dict) -> dict:
    """The shared-prefix server (--shared-prefix) on the card, bf16 and int8
    slots, without and with --lookup-gamma 4: TINY_PREFIX registered through
    POST /v1/prefixes and 4 concurrent greedy suffix requests continuing it,
    whose streams must equal the CPU shared-prefix engine's."""
    from llamavk_tpu_torch.models.loader import load_model
    from llamavk_tpu_torch.runtime.batching import BatchConfig, BatchedEngine
    from llamavk_tpu_torch.runtime.sampling import SamplerParams
    from llamavk_tpu_torch.runtime.server import LlamaServer

    result = {}
    for kv in ("bfloat16", "int8", "float32"):
        for gamma in (0, GAMMA) if kv != "float32" else (0,):
            bcfg = BatchConfig(max_batch=4, n_ctx=64, block=4, kv_dtype=kv, shared_prefix=True,
                               prefix_pool=2, lookup_gamma=gamma)
            cfg, params, tok = load_model(path, device="cpu")
            be = BatchedEngine(cfg, params, bcfg, device="cpu")
            pid = be.register_prefix(TINY_PREFIX)
            reqs = [be.submit(pr, n_tokens, SamplerParams(temp=0.0), ignore_eos=True, prefix=pid)
                    for pr in TINY_SERVE_PROMPTS]
            be.run()
            want = [b"".join(tok.decode_token(t) for t in r.generated).decode() for r in reqs]
            cfg, params, tok = load_model(path, device="cuda")
            srv = LlamaServer(cfg, params, tok, bcfg, device="cuda")
            base, thread = _serve(srv)
            _reset_counts()
            status, data = _post(base, "/v1/prefixes", {"tokens": TINY_PREFIX})
            pid = json.loads(data)["prefix_id"]
            got = _concurrently(base, [dict(prompt=pr, max_tokens=n_tokens, temperature=0.0,
                                            ignore_eos=True, prefix_id=pid)
                                       for pr in TINY_SERVE_PROMPTS])
            for key, n in _counts().items():
                counts[key] += n
            srv.shutdown()
            thread.join(timeout=30)
            texts = [a["text"] for a in got]
            name = f"{kv} shared-prefix" + (f" lookup {gamma}" if gamma else "")
            if status != 200 or texts != want:
                raise SystemExit(f"tiny_serve ({name}): card streams {texts} differ from the "
                                 f"CPU's {want}")
            result[name] = {"streams": want, "server_equal_to_cpu": True}
    return result


def _decode_step_check(params, cfg, seed: int, kvs=("int8", "bfloat16"),
                       phase: str = "serve_7b") -> dict:
    """One decode step at B=32 with ragged n_past (the batched decode
    kernel's route) through the kernels and through the plain versions,
    over a seeded cache of each type in `kvs` (int8, bfloat16, float32):
    logits within 2^-8 of the largest, and equal argmax wherever the top-2
    gap is wider. Under LLAMAVK_Q4_DOT=i8 also K5's device ms in one
    kernel step over the int8 cache."""
    from llamavk_tpu_torch.models.llama import KVCache, llama_forward
    from llamavk_tpu_torch.ops import q4_matmul as q4

    b, out = 32, {}
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    gen_cpu = torch.Generator().manual_seed(seed + 1)
    npast = torch.tensor(_decode_npast(b, N_CTX, gen_cpu), dtype=torch.int32, device="cuda")
    toks = torch.randint(3, cfg.n_vocab, (b, 1), generator=gen_cpu).cuda()
    for kv in kvs:
        quant = kv == "int8"
        shape = (cfg.n_layer, b, cfg.n_head, N_CTX, cfg.head_dim)
        planes = [torch.randint(-127, 128, shape, dtype=torch.int8, device="cuda", generator=gen)
                  for _ in range(2)] if quant else [
            torch.empty(shape, dtype=getattr(torch, kv), device="cuda").normal_(generator=gen)
            for _ in range(2)]
        if quant:
            sshape = (cfg.n_layer, b, N_CTX, cfg.n_head)
            planes += [torch.empty(sshape, device="cuda").uniform_(0.005, 0.03, generator=gen)
                       for _ in range(2)]
        logits = {}
        for ref in (False, True):
            cache = KVCache(*(p.clone() for p in planes))
            logits[ref] = llama_forward(params, toks, cache, npast, cfg, use_ref=ref)[0][:, -1]
            del cache
        device_ms = None
        if q4.resolve_dot_mode() == "i8" and quant:  # K5's device time in the step
            cache = KVCache(*(p.clone() for p in planes))
            device_ms = _k5_device_ms(lambda: llama_forward(params, toks, cache, npast, cfg))
            del cache
        del planes
        a, w = logits[False], logits[True]
        scale = float(w.abs().max())
        rel = float((a - w).abs().max()) / scale
        top2 = torch.topk(w, 2, dim=-1).values
        clear = (top2[:, 0] - top2[:, 1]) / scale > LOGIT_REL_LIMIT
        argmax_ok = bool(((a.argmax(-1) == w.argmax(-1)) | ~clear).all())
        if not (math.isfinite(rel) and rel <= LOGIT_REL_LIMIT and argmax_ok):
            raise SystemExit(f"{phase}: B=32 decode step ({kv}) kernel vs plain: rel {rel:.3g}, "
                             f"argmax on clear gaps equal: {argmax_ok}")
        out[kv] = {"rel": rel, "limit_rel": LOGIT_REL_LIMIT, "argmax_equal_on_clear_gaps": True,
                   "rows_with_clear_gap": int(clear.sum())}
        if device_ms is not None:
            out[kv]["device_ms_by_name"] = device_ms
    return out


@functools.cache
def _model_7b(seed: int, n_layer: int | None = None):
    """(cfg, params) of synthetic LLaMA-7B Q4_0 on the card, made once for
    the serving phases; at full width with the first `n_layer` of its 32
    layers where given."""
    from llamavk_tpu_torch.models.llama import ModelConfig
    from llamavk_tpu_torch.models.loader import LLAMA_CONFIGS, synthetic_params

    cfg = ModelConfig(**{**LLAMA_CONFIGS["7B"], **({"n_layer": n_layer} if n_layer else {})})
    return cfg, synthetic_params(cfg, seed=seed, device="cuda")


def _id_tokenizer(n_vocab: int):
    """A vocabulary that only names the token ids (<tN>): the 7B phases send
    token-id prompts."""
    from llamavk_tpu_torch.formats.ggml_io import TokenEntry
    from llamavk_tpu_torch.tokenizer import Tokenizer

    return Tokenizer([TokenEntry(f"<t{i}>".encode(), 0.0) for i in range(n_vocab)])


SMOKE_REQUESTS, SMOKE_TOKENS = 64, 64


def _smoke_bodies(n_vocab: int, gen) -> list[dict]:
    """The smoke load: 64 requests of 16-256 prompt tokens and 64 tokens
    out, half greedy and half sampled, a quarter streamed."""
    bodies = []
    for i in range(SMOKE_REQUESTS):
        plen = int(torch.randint(16, 257, (1,), generator=gen))
        sampling = dict(temperature=0.8, top_k=40, top_p=0.95) if i % 2 else dict(temperature=0.0)
        bodies.append(dict(prompt=torch.randint(3, n_vocab, (plen,), generator=gen).tolist(),
                           max_tokens=SMOKE_TOKENS, ignore_eos=True, stream=(i // 2) % 4 == 0,
                           seed=i, **sampling))
    return bodies


def _check_answers(phase: str, answers: list[dict], n_tokens: int = SMOKE_TOKENS) -> None:
    bad = [i for i, a in enumerate(answers)
           if a["status"] != 200 or a["text"].count("<t") != n_tokens or a["finish"] != "length"]
    if bad:
        raise SystemExit(f"{phase}: requests {bad} did not answer 200 with {n_tokens} tokens")


def _load(srv, base: str, bodies: list[dict]) -> dict:
    """Post `bodies` at once and measure: throughput, decode ms per step,
    TTFT p50 and p99 (the largest of 64), prefill calls and preemptions, from
    the engine's counters around the load."""
    stats0 = dict(srv.engine.stats)
    n_ttft = len(srv.ttft_s)
    t0 = time.perf_counter()
    answers = _concurrently(base, bodies)
    wall = time.perf_counter() - t0
    ttft = sorted(srv.ttft_s[n_ttft:])
    return {
        "answers": answers, "requests": len(bodies),
        "streamed": sum(bool(b.get("stream")) for b in bodies),
        "prompt_tokens": sum(len(b["prompt"]) for b in bodies), "wall_s": wall,
        "tok_per_s": len(bodies) * bodies[0]["max_tokens"] / wall,
        "ttft_ms_p50": 1e3 * ttft[len(ttft) // 2], "ttft_ms_p99": 1e3 * ttft[-1],
        **_step_stats(stats0, srv.stats()),
    }


def _step_stats(stats0: dict, stats: dict) -> dict:
    """Decode steps, decode ms per step, prefill calls and preemptions
    between two snapshots of the engine's counters."""
    steps = stats["steps"] - stats0["steps"]
    return {
        "decode_steps": steps,
        "decode_ms_per_step": 1e3 * (stats["t_decode"] - stats0["t_decode"]) / steps,
        "prefill_calls": stats["prefill_calls"] - stats0["prefill_calls"],
        "preempted": stats["preempted"] - stats0["preempted"],
    }


def _idle_window(eng, n_vocab: int, gen, prefix: int = -1) -> dict:
    """The device's idle share over decode blocks of 32 active slots,
    driven on the engine directly (each request continuing `prefix` when it
    is a registered id): one block on the host clock, one more under the
    profiler; the idle share divides busy time by the unprofiled wall
    time."""
    from llamavk_tpu_torch.runtime.sampling import SamplerParams

    for i in range(32):
        eng.submit(torch.randint(3, n_vocab, (64,), generator=gen).tolist(), 200,
                   SamplerParams(temp=0.8 if i % 2 else 0.0), seed=i, ignore_eos=True,
                   prefix=prefix)
    eng.step()  # admission and a first block
    steps0 = eng.stats["steps"]
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    eng.step()
    torch.cuda.synchronize()
    plain_wall_ms = (time.perf_counter() - t1) * 1e3
    n_steps = eng.stats["steps"] - steps0
    wall_ms, busy_ms, n_dev, top = _device_busy(eng.step)
    torch.cuda.synchronize()
    return {
        "idle_window_steps": n_steps, "wall_ms_per_step": plain_wall_ms / n_steps,
        "profiled_wall_ms_per_step": wall_ms / n_steps,
        "device_busy_ms_per_step": None if busy_ms is None else busy_ms / n_steps,
        "device_activities_per_step": n_dev / n_steps,
        "device_idle_share": None if busy_ms is None else 1 - busy_ms / plain_wall_ms,
        "device_ms_per_step_by_name": {k: v / n_steps for k, v in top.items()},
    }


def _batched_graph_check(cfg, params, bcfg, gen, phase: str, n_tokens: int = 32) -> dict:
    """32 requests (16-64 prompt tokens, n_tokens out, greedy and seeded
    sampled alternating) through a BatchedEngine that decodes by its graph
    and through one on the uncaptured step, at the same seeds: every stream
    equal token for token. Also the graph's capture time and pool bytes."""
    from llamavk_tpu_torch.runtime.batching import BatchedEngine
    from llamavk_tpu_torch.runtime.sampling import SamplerParams

    prompts = [torch.randint(3, cfg.n_vocab, (int(torch.randint(16, 65, (1,), generator=gen)),),
                             generator=gen).tolist() for _ in range(32)]
    streams, out = [], {}
    for plain in (False, True):
        be = BatchedEngine(cfg, params, bcfg, device="cuda")
        reqs = [be.submit(p, n_tokens, SamplerParams(temp=0.8 if i % 2 else 0.0), seed=i,
                          ignore_eos=True) for i, p in enumerate(prompts)]
        t0 = time.perf_counter()
        with _uncaptured() if plain else contextlib.nullcontext():
            be.run()
        torch.cuda.synchronize()
        mode = "uncaptured" if plain else "graph"
        out[f"{mode}_wall_s"] = time.perf_counter() - t0
        out[f"{mode}_decode_ms_per_step"] = 1e3 * be.stats["t_decode"] / be.stats["steps"]
        if not plain:
            out["graph"] = be.graph_stats()
        streams.append([r.generated for r in reqs])
        del be, reqs
        torch.cuda.empty_cache()
    out["tokens_equal"] = _same_streams(phase, streams[0], streams[1])
    return out


def _shape_report(shapes: dict) -> dict:
    return {
        "k1_shapes": {f"M={m} K={k} N={n}": c for (m, k, n), c in sorted(shapes["q4"].items())},
        "k1_f32_scale_shapes": {f"M={m} K={k} N={n}": c
                                for (m, k, n), c in sorted(shapes["q4_f32"].items())},
        "k5_shapes": {f"M={m} K={k} N={n}": c
                      for (m, k, n), c in sorted(shapes["q4_i8"].items())},
        "k1_k5_mode_shapes": {f"{key} M={m} K={k} N={n}": c
                              for (key, m, k, n), c in sorted(shapes["q4_modes"].items())},
        "attn_shapes": {str(key): c for key, c in sorted(shapes["attn"].items(), key=str)},
        "decode_shapes": {str(key): c for key, c in sorted(shapes["decode"].items(), key=str)},
    }


def phase_serve_7b(seed: int) -> tuple[dict, dict, dict]:
    """Synthetic LLaMA-7B behind the HTTP server with the production flags
    without paging. Returns (result, launches, the shapes every kernel was
    launched at in the phase, from the warm-up request to the last step)."""
    from llamavk_tpu_torch.runtime.batching import BatchConfig
    from llamavk_tpu_torch.runtime.server import LlamaServer

    cfg, params = _model_7b(seed)
    check = _decode_step_check(params, cfg, seed)
    tok = _id_tokenizer(cfg.n_vocab)
    bcfg = BatchConfig(max_batch=32, n_ctx=N_CTX, block=8, admit_chunk=4, kv_dtype="int8")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    srv = LlamaServer(cfg, params, tok, bcfg, model_name="llama-7B-synthetic", device="cuda")
    base, thread = _serve(srv)
    _reset_shapes()
    _complete(base, dict(prompt=[5, 6, 7], max_tokens=2, temperature=0.0, ignore_eos=True))
    gen = torch.Generator().manual_seed(seed)
    # 32 of the 64 bodies keep the whole script's time within a third of
    # its time before the speculation phases (serve_7b_paged posts all 64)
    bodies = _smoke_bodies(cfg.n_vocab, gen)[:32]
    _reset_counts()
    stats0 = dict(srv.engine.stats)
    load = _load(srv, base, bodies)
    # one request continuing a registered 100-token prefix with a 300-token
    # suffix: its bucket is capped at 412 rows (n_ctx - 100), the read route
    status, data = _post(base, "/v1/prefixes", {
        "tokens": torch.randint(3, cfg.n_vocab, (100,), generator=gen).tolist()})
    prefixed = _complete(base, dict(
        prompt=torch.randint(3, cfg.n_vocab, (300,), generator=gen).tolist(),
        prefix_id=json.loads(data)["prefix_id"], max_tokens=SMOKE_TOKENS, temperature=0.0,
        ignore_eos=True))
    torch.cuda.synchronize()
    counts = _counts()
    peak = torch.cuda.max_memory_allocated()
    # the decode steps and prefill calls of the 64 requests and the prefixed one
    load.update(_step_stats(stats0, srv.stats()))
    srv.shutdown()
    thread.join(timeout=30)
    if status != 200:
        raise SystemExit("serve_7b: the prefix was not registered")
    _check_answers("serve_7b", load.pop("answers") + [prefixed])
    # admissions (T >= 16) and the prefixed request's read on the tensor cores
    _require("serve_7b", counts, ("q4_gemm", "attn_update_tc_i8", "attn_read_tc_i8", "decode_i8"))
    idle = _idle_window(srv.engine, cfg.n_vocab, gen)
    shapes = _shapes()
    graph = srv.engine.graph_stats()
    del srv
    gc.collect()  # the server holds reference cycles
    torch.cuda.empty_cache()
    streams = _batched_graph_check(cfg, params, bcfg, gen, "serve_7b")
    load["requests"] += 1  # the prefixed one
    result = {"kernel_vs_plain_decode_step": check, "max_tokens": SMOKE_TOKENS, **load,
              "peak_mem_bytes": peak, "launches": counts, **_shape_report(shapes), **idle,
              "graph": graph, "graph_vs_uncaptured": streams}
    return result, counts, shapes


def _greedy_streams(cfg, params, bcfg, prompts: list[list[int]], n: int,
                    stats: dict | None = None) -> list[list[int]]:
    """Greedy streams of an engine on the card, driven directly (its
    counters copied into `stats` when given)."""
    from llamavk_tpu_torch.runtime.batching import BatchedEngine
    from llamavk_tpu_torch.runtime.sampling import SamplerParams

    be = BatchedEngine(cfg, params, bcfg, device="cuda")
    reqs = [be.submit(p, n, SamplerParams(temp=0.0), ignore_eos=True) for p in prompts]
    be.run()
    out = [r.generated for r in reqs]
    if stats is not None:
        stats.update(be.stats)
    del be
    torch.cuda.empty_cache()
    return out


def _ids(text: str) -> list[int]:
    """The token ids of a text of the id vocabulary (<tN> per token)."""
    return [int(t) for t in re.findall(r"<t(\d+)>", text)]


def _split_at(cfg, params, prompt: list[int], a: list[int], b: list[int], what: str,
              kv_dtype=torch.int8, kv_block: int | None = PAGE):
    """None when two greedy streams of one prompt are equal. Otherwise they
    may part only at a near tie: the logits of the prompt and the common
    tokens (one flat forward with the given cache type and KV block) put
    both next tokens within 2^-8 of the largest logit of the top one.
    Returns where they part and the tokens' gap to the top; fails on a wider
    one."""
    from llamavk_tpu_torch.models.llama import init_kv_cache, llama_forward

    if a == b:
        return None
    i = next((j for j in range(min(len(a), len(b))) if a[j] != b[j]), None)
    if i is None:
        raise SystemExit(f"{what}: streams of {len(a)} and {len(b)} tokens")
    ctx = prompt + a[:i]
    toks = torch.zeros((1, max(8, 1 << (len(ctx) - 1).bit_length())), dtype=torch.int64)
    toks[0, : len(ctx)] = torch.tensor(ctx)
    cache = init_kv_cache(cfg, 1, N_CTX, kv_dtype, "cuda")
    logits = llama_forward(params, toks.cuda(), cache, 0, cfg, kv_block=kv_block,
                           last_idx=torch.tensor([len(ctx) - 1], device="cuda"))[0][0, -1]
    del cache
    top, scale = float(logits.max()), float(logits.abs().max())
    gaps = [(top - float(logits[t])) / scale for t in (a[i], b[i])]
    if max(gaps) > LOGIT_REL_LIMIT:
        raise SystemExit(f"{what}: streams part at token {i} ({a[i]} against {b[i]}), "
                         f"{max(gaps):.3g} below the top logit (limit {LOGIT_REL_LIMIT})")
    return {"request": what, "token": i, "gap_rel": gaps}


def _stream_split(cfg, params, prompt: list[int], text_a: str, text_b: str, what: str):
    """`_split_at` for two answers of the int8 paged server, as texts."""
    return _split_at(cfg, params, prompt, _ids(text_a), _ids(text_b), what)


def phase_serve_7b_paged(seed: int) -> tuple[dict, dict, dict]:
    """Synthetic LLaMA-7B behind the HTTP server with the production flags
    (`serve --max-batch 32 --kv-dtype int8 --paged`, page_size 128, the
    default pool of 129 pages). Returns (result, launches from the 64
    requests to the end of the quarter-pool load, the shapes every kernel
    was launched at in the phase)."""
    from llamavk_tpu_torch.runtime.batching import BatchConfig
    from llamavk_tpu_torch.runtime.server import LlamaServer

    cfg, params = _model_7b(seed)
    tok = _id_tokenizer(cfg.n_vocab)
    bcfg = BatchConfig(max_batch=32, n_ctx=N_CTX, block=8, admit_chunk=4, kv_dtype="int8",
                       paged=True, page_size=PAGE)
    gen = torch.Generator().manual_seed(seed + 3)
    gc.collect()  # the servers of earlier phases hold reference cycles
    torch.cuda.empty_cache()
    _reset_shapes()
    # 8 greedy requests through a paged engine and a flat one whose KV block
    # is pinned to the page: K2 and K4 sum in the same order on both, so the
    # streams must be equal
    prompts = [torch.randint(3, cfg.n_vocab, (int(torch.randint(16, 257, (1,), generator=gen)),),
                             generator=gen).tolist() for _ in range(8)]
    paged_streams = _greedy_streams(cfg, params, bcfg, prompts, 32)
    flat_streams = _greedy_streams(cfg, params, dataclasses.replace(bcfg, paged=False,
                                                                    kv_block=PAGE), prompts, 32)
    if paged_streams != flat_streams:
        raise SystemExit("serve_7b_paged: paged and flat (kv_block 128) greedy streams differ")

    torch.cuda.reset_peak_memory_stats()
    srv = LlamaServer(cfg, params, tok, bcfg, model_name="llama-7B-synthetic", device="cuda")
    pool_bytes = sum(p.numel() * p.element_size() for p in srv.engine.cache.planes())
    base, thread = _serve(srv)
    _complete(base, dict(prompt=[5, 6, 7], max_tokens=2, temperature=0.0, ignore_eos=True))
    bodies = _smoke_bodies(cfg.n_vocab, torch.Generator().manual_seed(seed))  # serve_7b's
    _reset_counts()
    load = _load(srv, base, bodies)
    answers = load.pop("answers")
    _check_answers("serve_7b_paged", answers)
    pages_peak = srv.stats()["pages_peak"]
    # a registered 300-token prefix, 2 full pages shared by every slot that
    # continues it and a 44-token remainder re-evaluated with each suffix,
    # continued by 4 concurrent 100-token suffixes (buckets of 256 rows at
    # n_past 256)
    status, data = _post(base, "/v1/prefixes", {
        "tokens": torch.randint(3, cfg.n_vocab, (300,), generator=gen).tolist()})
    pid = json.loads(data)["prefix_id"]
    pfx_pages = list(srv.engine.prefixes[pid][0])
    suffixes = [dict(prompt=torch.randint(3, cfg.n_vocab, (100,), generator=gen).tolist(),
                     prefix_id=pid, max_tokens=SMOKE_TOKENS, temperature=0.0, ignore_eos=True)
                for _ in range(4)]
    prefixed = _concurrently(base, suffixes)
    torch.cuda.synchronize()
    counts = _counts()
    peak = torch.cuda.max_memory_allocated()
    stats = srv.stats()
    srv.shutdown()
    thread.join(timeout=30)
    if status != 200 or len(pfx_pages) != 2:
        raise SystemExit(f"serve_7b_paged: prefix registered with {len(pfx_pages)} pages")
    _check_answers("serve_7b_paged (prefix)", prefixed)
    if stats["pages_free"] != stats["pages_total"] - 1 - len(pfx_pages):
        raise SystemExit(f"serve_7b_paged: pages not returned: {stats}")
    idle = _idle_window(srv.engine, cfg.n_vocab, gen)
    del srv
    gc.collect()
    torch.cuda.empty_cache()

    # the same 64 requests against a quarter pool (33 pages: 32 usable of
    # 128 rows, for 32 slots that each need up to 3): the youngest request
    # is preempted when the pool runs dry and recomputes on re-admission
    quarter_cfg = dataclasses.replace(bcfg, n_pages=33)
    srv = LlamaServer(cfg, params, tok, quarter_cfg, model_name="llama-7B-synthetic",
                      device="cuda")
    base, thread = _serve(srv)
    _reset_counts()
    quarter = _load(srv, base, bodies)
    for key, n in _counts().items():
        counts[key] += n
    qstats = srv.stats()
    srv.shutdown()
    thread.join(timeout=30)
    qanswers = quarter.pop("answers")
    _check_answers("serve_7b_paged (quarter pool)", qanswers)
    if quarter["preempted"] == 0:
        raise SystemExit("serve_7b_paged: the quarter pool preempted no request")
    # preemption recomputes a request's rows and must not change a greedy
    # stream, its own or another slot's: the greedy half of the quarter
    # pool's answers equals the default pool's, up to a near tie
    greedy = [i for i, b in enumerate(bodies) if b["temperature"] == 0.0]
    ties = [_stream_split(cfg, params, bodies[i]["prompt"], answers[i]["text"],
                          qanswers[i]["text"], f"serve_7b_paged: greedy request {i}")
            for i in greedy]
    ties = [t for t in ties if t is not None]
    _require("serve_7b_paged", counts, ("q4_gemm", "attn_update_paged_tc_i8", "decode_paged_i8"))
    shapes = _shapes()
    graph = srv.engine.graph_stats()
    del srv
    gc.collect()
    torch.cuda.empty_cache()
    streams = _batched_graph_check(cfg, params, bcfg, gen, "serve_7b_paged")
    result = {
        "paged_equal_to_flat_kv_block_128": {"requests": len(prompts), "tokens": 32},
        "max_tokens": SMOKE_TOKENS, **load, "pages_total": stats["pages_total"],
        "pages_peak": pages_peak, "pool_bytes": pool_bytes, "peak_mem_bytes": peak,
        "prefix": {"pages": len(pfx_pages), "requests": len(suffixes)},
        "quarter_pool": {"pages_total": qstats["pages_total"], "pages_peak": qstats["pages_peak"],
                         "greedy_streams": len(greedy), "greedy_split_at_near_tie": ties,
                         **quarter},
        "launches": counts, **_shape_report(shapes), **idle, "graph": graph,
        "graph_vs_uncaptured": streams,
    }
    return result, counts, shapes


def phase_serve_7b_lookup(seed: int) -> tuple[dict, dict, dict]:
    """serve --lookup-gamma 4 on synthetic 7B, int8 KV, flat and paged (a
    smoke load, not a cell). First 8 greedy requests with repeated-pattern
    prompts of 100-250 tokens, 64 tokens each, driven directly through a
    plain flat engine and through flat and paged lookup engines (kv_block
    and page 128): the lookup streams equal the plain ones or part at a near
    tie, and the paged verify writes cross pages. Then serve_7b's 64 bodies
    over HTTP to `serve --lookup-gamma 4 --paged --kv-dtype int8`. Returns
    (result, launches, the shapes every kernel was launched at)."""
    from llamavk_tpu_torch.runtime.batching import BatchConfig
    from llamavk_tpu_torch.runtime.server import LlamaServer

    cfg, params = _model_7b(seed)
    tok = _id_tokenizer(cfg.n_vocab)
    gen = torch.Generator().manual_seed(seed + 5)
    gc.collect()
    torch.cuda.empty_cache()
    _reset_shapes()
    prompts = []
    for _ in range(8):
        n = int(torch.randint(100, 251, (1,), generator=gen))
        pattern = torch.randint(3, cfg.n_vocab, (int(torch.randint(8, 33, (1,), generator=gen)),),
                                generator=gen).tolist()
        prompts.append((pattern * (n // len(pattern) + 1))[:n])
    bcfg = BatchConfig(max_batch=32, n_ctx=N_CTX, block=8, admit_chunk=4, kv_dtype="int8",
                       kv_block=PAGE)
    plain = _greedy_streams(cfg, params, bcfg, prompts, SMOKE_TOKENS)
    direct, ties = {}, []
    _reset_counts()
    for name, lcfg in (("flat", dataclasses.replace(bcfg, lookup_gamma=GAMMA)),
                       ("paged", dataclasses.replace(bcfg, lookup_gamma=GAMMA, paged=True,
                                                     page_size=PAGE))):
        stats: dict = {}
        got = _greedy_streams(cfg, params, lcfg, prompts, SMOKE_TOKENS, stats)
        for i, (prompt, a, b) in enumerate(zip(prompts, got, plain)):
            tie = _split_at(cfg, params, prompt, a, b, f"serve_7b_lookup: {name} request {i}")
            if tie is not None:
                ties.append(tie)
        direct[name] = {"rounds": stats["rounds"], "accepted": stats["accepted"],
                        "tok_per_round": (stats["rounds"] + stats["accepted"]) / stats["rounds"]}
        if name == "paged":
            direct[name].update(straddled=stats["straddled"], pages_peak=stats["pages_peak"])
            if stats["straddled"] == 0:
                raise SystemExit("serve_7b_lookup: no paged verify write crossed a page")
    counts = _counts()

    lcfg = dataclasses.replace(bcfg, kv_block=0, lookup_gamma=GAMMA, paged=True, page_size=PAGE)
    srv = LlamaServer(cfg, params, tok, lcfg, model_name="llama-7B-synthetic", device="cuda")
    base, thread = _serve(srv)
    _complete(base, dict(prompt=[5, 6, 7], max_tokens=2, temperature=0.0, ignore_eos=True))
    bodies = _smoke_bodies(cfg.n_vocab, torch.Generator().manual_seed(seed))  # serve_7b's
    stats0 = dict(srv.engine.stats)
    _reset_counts()
    load = _load(srv, base, bodies)
    for key, n in _counts().items():
        counts[key] += n
    stats = srv.stats()
    srv.shutdown()
    thread.join(timeout=30)
    _check_answers("serve_7b_lookup", load.pop("answers"))
    idle = _idle_window(srv.engine, cfg.n_vocab, gen)
    del srv
    gc.collect()
    torch.cuda.empty_cache()
    _require("serve_7b_lookup", counts, ("q4_gemm", "attn_update_paged_straddle_split_i8",
                                         "attn_update_split_i8"))
    shapes = _shapes()
    rounds = stats["rounds"] - stats0["rounds"]
    load["ms_per_round"] = load.pop("decode_ms_per_step")
    result = {
        "direct": {"requests": len(prompts), "tokens": SMOKE_TOKENS,
                   "prompt_tokens": [len(p) for p in prompts], "split_at_near_tie": ties,
                   **direct},
        "max_tokens": SMOKE_TOKENS, **load, "rounds": rounds,
        "accepted": stats["accepted"] - stats0["accepted"],
        "straddled": stats["straddled"] - stats0["straddled"], "pages_peak": stats["pages_peak"],
        "launches": counts, **_shape_report(shapes), **idle,
    }
    return result, counts, shapes


RING_TOKENS = 700  # generate_7b_ring: one wrap of the 480 recycled rows, and 220 more
RING_LAYERS = 16  # generate_7b_ring runs 16 of 7B's 32 layers (at full width)


class _TimedOut(io.StringIO):
    """The CLI's stdout, with the host time of each write: the prompt's echo,
    then one write per generated token (a decode block's tokens together)."""

    def __init__(self):
        super().__init__()
        self.times: list[float] = []

    def write(self, s: str) -> int:
        self.times.append(time.perf_counter())
        return super().write(s)


def phase_generate_7b_ring(seed: int) -> tuple[dict, dict]:
    """The generate CLI with --ctx-swap ring --n-keep 32 on synthetic 7B at
    full width and 16 of its 32 layers, n_ctx 512, bf16 KV: a 32-token
    prompt generating 700 tokens (the ring
    wraps at the 481st), whose first 480 must equal the plain greedy CLI's
    stream (which fills the context) or part only at a near tie; ms per
    token before and after the wrap from the CLI's per-token writes; at a
    wrapped state (a 600-token eval), the next forward through the kernels
    and through the plain versions within 2^-8 of the largest plain logit,
    and the device's idle share over 8 decode steps."""
    from llamavk_tpu_torch.models.llama import llama_forward
    from llamavk_tpu_torch.runtime.engine import Engine, EngineConfig
    from llamavk_tpu_torch.runtime.sampling import SamplerParams

    cfg, params = _model_7b(seed, RING_LAYERS)
    gen = torch.Generator().manual_seed(seed + 5)
    text = "".join(chr(ord("a") + int(i)) for i in torch.randint(0, 26, (30,), generator=gen))
    prompt = [1] + [b + 3 for b in (" " + text).encode()]  # BOS, the CLI's space, 30 letters
    argv = ["-p", text, "-c", str(N_CTX), "--temp", "0", "--ignore-eos"]
    ring = argv + ["--ctx-swap", "ring", "--n-keep", str(RING_KEEP)]
    _cli_7b(ring + ["-n", "8"], cfg, params)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    timed = _TimedOut()
    out, err = _cli_7b(ring + ["-n", str(RING_TOKENS)], cfg, params, out=timed)
    counts = _counts()
    peak = torch.cuda.max_memory_allocated()
    got = _ids(out)[len(prompt):]
    # the same CLI run through the uncaptured step: equal across the wrap
    with _uncaptured():
        uout, _ = _cli_7b(ring + ["-n", str(RING_TOKENS)], cfg, params)
    graph_equal = _same_streams("generate_7b_ring", [got], [_ids(uout)[len(prompt):]])
    n_plain = N_CTX - len(prompt)  # 480: the plain stream fills the context
    pout, _ = _cli_7b(argv + ["-n", str(n_plain)], cfg, params)
    plain = _ids(pout)[len(prompt):]
    if len(got) != RING_TOKENS or len(plain) != n_plain:
        raise SystemExit(f"generate_7b_ring: {len(got)} ring and {len(plain)} plain tokens")
    split = _split_at(cfg, params, prompt, got[:n_plain], plain, "generate_7b_ring",
                      torch.bfloat16, None)
    # token i is written at times[1 + i]; blocks of 16 end at tokens 16j.
    # Before the wrap: tokens 16..480 (positions 48..511); after: 496..688
    # (rows recycled from 32 on)
    t = timed.times
    before = 1e3 * (t[1 + 480] - t[1 + 16]) / (480 - 16)
    after = 1e3 * (t[1 + 688] - t[1 + 496]) / (688 - 496)
    # a wrapped state: 600 tokens evaluated in ring chunks (512, then 88 in a
    # 128-row bucket at row 32)
    eng = Engine(cfg, params, EngineConfig(n_ctx=N_CTX, ring_keep=RING_KEEP, ctx_ring=True),
                 device="cuda")
    eng.eval(torch.randint(3, cfg.n_vocab, (600,), generator=gen).tolist())
    logits = {}
    for ref in (False, True):
        cache = eng.cache.clone()
        logits[ref] = llama_forward(params, torch.tensor([[7]], device="cuda"), cache,
                                    eng.n_past, cfg, ring_keep=RING_KEEP, use_ref=ref)[0][0, -1]
        del cache
    a, w = logits[False], logits[True]
    scale = float(w.abs().max())
    rel = float((a - w).abs().max()) / scale
    top2 = torch.topk(w, 2).values
    clear = float(top2[0] - top2[1]) / scale > LOGIT_REL_LIMIT
    if not (math.isfinite(rel) and rel <= LOGIT_REL_LIMIT) or (clear and a.argmax() != w.argmax()):
        raise SystemExit(f"generate_7b_ring: post-wrap kernel logits {rel:.3g} from plain")
    greedy = SamplerParams(temp=0.0)
    eng.generate([7], 8, greedy, ignore_eos=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.generate([], 8, greedy, ignore_eos=True)
    torch.cuda.synchronize()
    plain_wall_ms = (time.perf_counter() - t0) * 1e3
    wall_ms, busy_ms, n_dev, top = _device_busy(lambda: eng.generate([], 8, greedy,
                                                                      ignore_eos=True))
    del eng
    torch.cuda.empty_cache()
    _require("generate_7b_ring", counts, ("q4_gemv", "q4_gemm", "attn_update_ring_split",
                                          "attn_update_ring_tc"))
    em = re.search(r"^eval += +([\d.]+) ms / +(\d+) tokens", err, re.M)
    result = {
        "prompt_tokens": len(prompt), "tokens": len(got), "ring_keep": RING_KEEP,
        "wrapped_at_token": N_CTX - len(prompt),
        "graph_vs_uncaptured_tokens_equal": graph_equal,
        "first_tokens_equal_to_plain_greedy": n_plain if split is None else split["token"],
        "split_at_near_tie": split,
        "ms_per_token_before_wrap": before, "ms_per_token_after_wrap": after,
        "cli_eval_ms_per_token": None if em is None else float(em[1]) / int(em[2]),
        "kernel_vs_plain_post_wrap": {"rel": rel, "limit_rel": LOGIT_REL_LIMIT,
                                      "argmax_equal": bool(a.argmax() == w.argmax())},
        "peak_mem_bytes": peak, "launches": counts,
        "wall_ms_per_step": plain_wall_ms / 8, "profiled_wall_ms_per_step": wall_ms / 8,
        "device_busy_ms_per_step": None if busy_ms is None else busy_ms / 8,
        "device_activities_per_step": n_dev / 8,
        "device_idle_share": None if busy_ms is None else 1 - busy_ms / plain_wall_ms,
        "device_ms_per_step_by_name": {k: v / 8 for k, v in top.items()},
    }
    return result, counts


MODES_TOKENS = 128  # generate_7b_modes' greedy tokens after a 32-token prompt


def _modes_cli_run(cfg, params, seed: int, what: str) -> tuple[dict, dict]:
    """The generate CLI on synthetic 7B in this process's modes: a 32-token
    prompt (seeded letters after BOS and the CLI's space) and 128 greedy
    tokens, after an 8-token warm-up run; the stream against the plain
    forward teacher-forced on it; prefill ms and ms per token from the CLI's
    timings; the run's launches."""
    gen = torch.Generator().manual_seed(seed + 8)
    text = "".join(chr(ord("a") + int(i)) for i in torch.randint(0, 26, (30,), generator=gen))
    prompt = [1] + [b + 3 for b in (" " + text).encode()]
    argv = ["-p", text, "-c", str(N_CTX), "--temp", "0", "--ignore-eos"]
    _cli_7b(argv + ["-n", "8"], cfg, params)  # warm-up
    torch.cuda.synchronize()
    _reset_counts()
    out, err = _cli_7b(argv + ["-n", str(MODES_TOKENS)], cfg, params)
    counts = _counts()
    stream = _ids(out)[len(prompt):]
    pm = re.search(r"^prompt eval += +([\d.]+) ms / +(\d+) tokens", err, re.M)
    em = re.search(r"^eval += +([\d.]+) ms / +(\d+) tokens", err, re.M)
    if len(stream) != MODES_TOKENS or pm is None or em is None:
        raise SystemExit(f"{what}: {len(stream)} tokens, timings {err[-500:]!r}")
    split = _teacher_forced(cfg, params, prompt, stream, what)
    return {"prompt_tokens": len(prompt), "tokens": len(stream),
            "stream_vs_plain": split or "equal", "limit_rel": LOGIT_REL_LIMIT,
            "prefill_ms": float(pm[1]), "ms_per_token": float(em[1]) / int(em[2]),
            "launches": {key: n for key, n in counts.items() if n}}, counts


def _modes_shape_rows(result: dict, seed: int, phase: str) -> None:
    """Every kernel against its plain version at every shape launched since
    the last `_reset_shapes`, into `result` (`shape_rows`, and the shapes)."""
    shapes = _shapes()
    result.update(_shape_report(shapes))
    result["shape_rows"] = phase_serve_shapes(shapes, seed, 5, phase)


def _modes_f32_child(seed: int) -> dict:
    """generate_7b_modes under LLAMAVK_Q4_DOT=f32 (this process was started
    with it): the CLI run on the ilv weights, K1 keeping w = q * s in f32;
    then every kernel at every shape it launched."""
    from llamavk_tpu_torch.ops import q4_matmul as q4

    cfg, params = _model_7b(seed)
    _reset_shapes()
    result, counts = _modes_cli_run(cfg, params, seed, "generate_7b_modes (LLAMAVK_Q4_DOT=f32)")
    _require("generate_7b_modes (LLAMAVK_Q4_DOT=f32)", counts, ("q4_gemv_dotf32", "q4_gemm_dotf32"))
    result = {"dot": q4.resolve_dot_mode(), **result, "launches": counts}
    _modes_shape_rows(result, seed, "generate_7b_modes_f32")
    return result


def _modes_mul_child(seed: int) -> dict:
    """generate_7b_modes under LLAMAVK_Q4_MUL=bf16 (this process was started
    with it): one seeded 512-token chunk of perplexity --f32, whose f32
    scales K1 rounds to bf16, against the plain versions in the same mode;
    then every kernel at every shape it launched."""
    from llamavk_tpu_torch.models.llama import ModelConfig
    from llamavk_tpu_torch.models.loader import LLAMA_CONFIGS
    from llamavk_tpu_torch.ops import q4_matmul as q4

    cfg = ModelConfig(**LLAMA_CONFIGS["7B"])
    _reset_shapes()
    result, counts = _perplexity_f32(cfg, seed, N_CTX,
                                     "generate_7b_modes (perplexity --f32, LLAMAVK_Q4_MUL=bf16)")
    _require("generate_7b_modes (LLAMAVK_Q4_MUL=bf16)", counts, ("q4_gemm_f32_mulbf16",))
    result = {"mul": str(q4.resolve_mul_dtype()), **result, "launches": counts}
    _modes_shape_rows(result, seed, "generate_7b_modes_mul")
    return result


def phase_generate_7b_modes(seed: int) -> tuple[dict, dict]:
    """K1's layout and numerics modes through the single-stream entry
    points on synthetic 7B (full width and depth), n_ctx 512, bf16 KV: the
    generate CLI (32-token prompt, 128 greedy tokens, each stream against
    the plain forward teacher-forced on it) on the ilv weights in the
    default modes, on lin weights (synthetic_params(layout="lin")), and on
    the ilv weights under LLAMAVK_Q4_DOT=f32 in a process of its own; a
    512-token perplexity --f32 chunk under LLAMAVK_Q4_MUL=bf16 in another;
    --mtest -b 32 on the lin weights. Each process then holds every kernel
    against its plain version at every shape it launched (`shape_rows`).
    Returns (result, launches)."""
    from llamavk_tpu_torch.models.loader import synthetic_params

    cfg, params = _model_7b(seed)
    result = {}
    _reset_shapes()
    result["ilv_bf16"], counts = _modes_cli_run(cfg, params, seed, "generate_7b_modes (ilv)")
    lin = synthetic_params(cfg, seed=seed, device="cuda", layout="lin")
    result["lin"], lin_counts = _modes_cli_run(cfg, lin, seed, "generate_7b_modes (lin)")
    _reset_counts()
    _, err = _cli_7b(["--mtest", "-n", str(N_CTX), "-c", str(N_CTX), "-b", "32"], cfg, lin)
    result["lin_mtest"] = [ln.strip() for ln in err.strip().splitlines() if " = " in ln]
    for part in (lin_counts, _counts()):
        for key, n in part.items():
            counts[key] += n
    del lin
    torch.cuda.empty_cache()
    _require("generate_7b_modes (lin)", counts, ("q4_gemv_lin", "q4_gemm_lin"))
    _modes_shape_rows(result, seed, "generate_7b_modes")
    f32 = result["f32_dot"] = _run_child("modes_f32_child", seed, {"LLAMAVK_Q4_DOT": "f32"})
    mul = result["mul_bf16"] = _run_child("modes_mul_child", seed, {"LLAMAVK_Q4_MUL": "bf16"})
    for part in (f32, mul):
        for key, n in part["launches"].items():
            counts[key] += n
        part["launches"] = {key: n for key, n in part["launches"].items() if n}
        result["shape_rows"] += part.pop("shape_rows")
    result["ms_per_token"] = {"ilv bf16": result["ilv_bf16"]["ms_per_token"],
                              "lin": result["lin"]["ms_per_token"],
                              "ilv f32 dot": f32["ms_per_token"]}
    result["launches"] = {key: n for key, n in counts.items() if n}
    return result, counts


SHARED_DIRECT, SHARED_DIRECT_TOKENS = 8, 32  # serve_7b_shared's requests against the oracle


def _shared_oracle(cfg, params, prefix: list[int], suffixes: list[list[int]], n: int):
    """The composition a shared-prefix engine implements, through the plain
    versions (the oracle of tests/test_batching.py:311-379): the prefix
    prefilled once into a bf16 pool entry of POOL_CTX rows; each suffix
    prefilled alone into its row of an int8 slot cache holding only suffix
    rows (padded as the engine's bucket); then every row decoded greedily,
    one T = 1 forward per token for all rows at once (rows never read each
    other's). Returns the streams and each step's logits [B, V]."""
    from llamavk_tpu_torch.models.llama import KVCache, init_kv_cache, llama_forward

    def bucket(m: int) -> int:
        return max(8, 1 << (m - 1).bit_length())

    plen, b = len(prefix), len(suffixes)
    pool = init_kv_cache(cfg, 1, POOL_CTX, device="cuda")
    toks = torch.zeros((1, bucket(plen)), dtype=torch.int64)
    toks[0, :plen] = torch.tensor(prefix)
    llama_forward(params, toks.cuda(), pool, 0, cfg, last_idx=plen - 1, use_ref=True)
    slots = init_kv_cache(cfg, b, N_CTX, torch.int8, "cuda")

    def pkw(rows: int) -> dict:
        return dict(prefix_kv=(pool.k, pool.v),
                    prefix_id=torch.zeros(rows, dtype=torch.int32, device="cuda"),
                    prefix_len=torch.full((rows,), plen, dtype=torch.int32, device="cuda"))

    steps = [torch.empty((b, cfg.n_vocab), device="cuda")]
    for j, sfx in enumerate(suffixes):
        row = KVCache(*(x[:, j : j + 1] for x in slots.planes()))
        toks = torch.zeros((1, bucket(len(sfx))), dtype=torch.int64)
        toks[0, : len(sfx)] = torch.tensor(sfx)
        steps[0][j] = llama_forward(
            params, toks.cuda(), row, torch.tensor([plen], dtype=torch.int32, device="cuda"),
            cfg, last_idx=torch.tensor([len(sfx) - 1], device="cuda"), use_ref=True,
            **pkw(1))[0][0, -1]
    npast = torch.tensor([plen + len(x) for x in suffixes], dtype=torch.int32, device="cuda")
    for _ in range(n - 1):
        tok = steps[-1].argmax(-1)[:, None]
        steps.append(llama_forward(params, tok, slots, npast, cfg, use_ref=True,
                                   **pkw(b))[0][:, -1])
        npast = npast + 1
    streams = torch.stack([x.argmax(-1) for x in steps], 1).tolist()
    return streams, steps


def phase_serve_7b_shared(seed: int) -> tuple[dict, dict, dict]:
    """Synthetic LLaMA-7B serving with the shared-prefix pool (--shared-prefix
    --prefix-pool 4 --prefix-ctx 256 --kv-dtype int8 --max-batch 32, n_ctx
    512): a seeded 200-token prefix registered once; 8 greedy suffix
    requests through the engine against the plain-version composition
    (equal, or parting only at a near tie of the composition's logits); then
    32 concurrent requests over HTTP continuing it (16-128-token suffixes, 64
    tokens, half sampled); the pool's and the slot cache's bytes, peak
    memory, the idle share. Returns (result, launches, shapes)."""
    from llamavk_tpu_torch.runtime.batching import BatchConfig, BatchedEngine
    from llamavk_tpu_torch.runtime.sampling import SamplerParams
    from llamavk_tpu_torch.runtime.server import LlamaServer

    cfg, params = _model_7b(seed)
    tok = _id_tokenizer(cfg.n_vocab)
    bcfg = BatchConfig(max_batch=32, n_ctx=N_CTX, block=8, admit_chunk=4, kv_dtype="int8",
                       shared_prefix=True, prefix_pool=POOL, prefix_ctx=POOL_CTX)
    gen = torch.Generator().manual_seed(seed + 3)
    prefix = torch.randint(3, cfg.n_vocab, (PLEN,), generator=gen).tolist()
    _reset_shapes()
    suffixes = [torch.randint(3, cfg.n_vocab, (int(n),), generator=gen).tolist()
                for n in torch.randint(16, 129, (SHARED_DIRECT,), generator=gen)]
    be = BatchedEngine(cfg, params, bcfg, device="cuda")
    pid = be.register_prefix(prefix)
    reqs = [be.submit(sfx, SHARED_DIRECT_TOKENS, SamplerParams(temp=0.0), ignore_eos=True,
                      prefix=pid) for sfx in suffixes]
    be.run()
    del be
    torch.cuda.empty_cache()
    want, steps = _shared_oracle(cfg, params, prefix, suffixes, SHARED_DIRECT_TOKENS)
    ties = []
    for j, r in enumerate(reqs):
        if r.generated == want[j]:
            continue
        i = next(i for i, (x, y) in enumerate(zip(r.generated, want[j])) if x != y)
        lg = steps[i][j]
        top, scale = float(lg.max()), float(lg.abs().max())
        gaps = [(top - float(lg[x])) / scale for x in (r.generated[i], want[j][i])]
        if max(gaps) > LOGIT_REL_LIMIT:
            raise SystemExit(f"serve_7b_shared: request {j} parts from the plain composition at "
                             f"token {i}, {max(gaps):.3g} below the top (limit {LOGIT_REL_LIMIT})")
        ties.append({"request": j, "token": i, "gap_rel": gaps})
    del steps
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    srv = LlamaServer(cfg, params, tok, bcfg, model_name="llama-7B-synthetic", device="cuda")
    base, thread = _serve(srv)
    status, data = _post(base, "/v1/prefixes", {"tokens": prefix})
    pid = json.loads(data)["prefix_id"]
    _complete(base, dict(prompt=[5, 6, 7], prefix_id=pid, max_tokens=2, temperature=0.0,
                         ignore_eos=True))  # warm-up
    bodies = []
    for i in range(32):
        n = int(torch.randint(16, 129, (1,), generator=gen))
        sampling = dict(temperature=0.8, top_k=40, top_p=0.95) if i % 2 else dict(temperature=0.0)
        bodies.append(dict(prompt=torch.randint(3, cfg.n_vocab, (n,), generator=gen).tolist(),
                           prefix_id=pid, max_tokens=SMOKE_TOKENS, ignore_eos=True,
                           stream=(i // 2) % 4 == 0, seed=i, **sampling))
    _reset_counts()
    load = _load(srv, base, bodies)
    torch.cuda.synchronize()
    counts = _counts()
    peak = torch.cuda.max_memory_allocated()
    eng = srv.engine
    pool_bytes = 2 * eng.pfx_k.numel() * eng.pfx_k.element_size()
    slot_bytes = sum(x.numel() * x.element_size() for x in eng.cache.planes())
    srv.shutdown()
    thread.join(timeout=30)
    if status != 200:
        raise SystemExit("serve_7b_shared: the prefix was not registered")
    _check_answers("serve_7b_shared", load.pop("answers"))
    idle = _idle_window(eng, cfg.n_vocab, gen, prefix=pid)
    del srv, eng
    gc.collect()
    torch.cuda.empty_cache()
    # decode over the prefix on the split route, admissions (T >= 16) on the
    # tensor cores
    _require("serve_7b_shared", counts, ("q4_gemm", "attn_update_prefix_split_i8",
                                         "attn_update_prefix_tc_i8"))
    shapes = _shapes()
    # a per-slot copy of the prefix (serve_7b's registered prefix) puts its
    # rows in every slot that continues it: 32 slots x 200 rows of int8 K
    # and V with their scales
    copy_bytes = 32 * PLEN * 2 * cfg.n_layer * _row_bytes(True, cfg.n_head, cfg.head_dim)
    result = {
        "prefix_tokens": PLEN, "pool_entries": POOL, "pool_rows": POOL_CTX,
        "direct": {"requests": SHARED_DIRECT, "tokens": SHARED_DIRECT_TOKENS,
                   "suffix_tokens": [len(x) for x in suffixes],
                   "equal_to_plain_composition": SHARED_DIRECT - len(ties),
                   "split_at_near_tie": ties},
        "max_tokens": SMOKE_TOKENS, **load, "peak_mem_bytes": peak,
        "pool_bytes": pool_bytes, "slot_cache_bytes": slot_bytes,
        "per_slot_prefix_copy_bytes_at_32_slots": copy_bytes, "launches": counts,
        **_shape_report(shapes), **idle,
    }
    return result, counts, shapes


# the compat phases' greedy prompt on the tiny model: every top-2 logit gap
# stays above 0.15 for 6 tokens on the CPU with an f32 cache (and with bf16
# and int8 caches, TINY_SERVE_PROMPTS)
TINY_COMPAT_PROMPT = TINY_SERVE_PROMPTS[0]
# the tiny CLIs' text: 2000 bytes, 2 chunks of 16 tokens
TINY_TEXT = bytes(65 + (i % 26) for i in range(2000))
# a perplexity's logarithm is the mean NLL: each NLL moves by at most twice
# the logits' drift, which stays within two bf16 ulps (0.032) on the tiny
# model's |logits| < 4 (tests/test_torch_compat.py)
TINY_PPL_LOG_TOL = 0.064


def _compat_greedy(ctx, prompt: list[int], n: int) -> tuple[list[int], list]:
    """llama.h's loop on a compat context: eval the prompt, then n times
    sample greedily and eval the token. Returns the tokens and each step's
    logits row."""
    from llamavk_tpu_torch import compat as llama

    llama.llama_eval(ctx, prompt, n_past=0)
    toks, rows = [], []
    for _ in range(n):
        rows.append(llama.llama_get_logits(ctx)[-1].copy())
        toks.append(llama.llama_sample_top_p_top_k(ctx, toks or prompt, 40, 0.95, 0.0, 1.0))
        llama.llama_eval(ctx, [toks[-1]])
    return toks, rows


def _cli_proc(module: str, argv: list[str]) -> subprocess.Popen:
    return subprocess.Popen([sys.executable, "-m", f"llamavk_tpu_torch.cli.{module}", *argv],
                            cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _cli_out(proc: subprocess.Popen, what: str) -> str:
    out, err = proc.communicate(timeout=600)
    if proc.returncode != 0:
        raise SystemExit(f"tiny_compat: {what} failed ({proc.returncode}):\n{err[-2000:]}")
    return out


def phase_tiny_compat(work: Path) -> tuple[dict, dict]:
    """The llama.h API (compat.py) on the tiny GGJT file on the card, with
    f16_kv True and False (an f32 cache): a greedy llama.h loop whose tokens
    equal the CPU context's and whose logits stay within two bf16 ulps of
    them; a KV blob taken on the card continues identically on the card and
    within the same limit on the CPU. BatchedEngine(kv_dtype="float32")
    streams against the CPU's. The perplexity CLI (bf16 and --f32) and the
    embedding CLI, each in its own process on the card (started together),
    against the same CLIs in this process with --device cpu."""
    from llamavk_tpu_torch import compat as llama
    from llamavk_tpu_torch.cli import embedding, perplexity
    from llamavk_tpu_torch.models.loader import load_model, random_tiny_model
    from llamavk_tpu_torch.runtime.batching import BatchConfig, BatchedEngine
    from llamavk_tpu_torch.runtime.sampling import SamplerParams

    path = str(work / "tiny-q4.bin")
    random_tiny_model(write_path=path, quantize=True)
    text = work / "text.raw"
    text.write_bytes(TINY_TEXT)
    ppl_argv = ["-m", path, "-f", str(text), "-c", "16", "--max-chunks", "2"]
    emb_argv = ["-m", path, "-p", "hi", "-c", "32"]
    procs = {"ppl": _cli_proc("perplexity", ppl_argv + ["--device", "cuda"]),
             "ppl_f32": _cli_proc("perplexity", ppl_argv + ["--f32", "--device", "cuda"]),
             "emb": _cli_proc("embedding", emb_argv + ["--device", "cuda"])}
    result, counts = {}, dict.fromkeys(KERNEL_META, 0)
    for f16 in (True, False):
        name = "f16_kv" if f16 else "f32_kv"
        out = {}
        _reset_counts()
        for device in ("cuda", "cpu"):
            p = llama.llama_context_default_params()
            p.n_ctx, p.f16_kv, p.device = 64, f16, device
            ctx = llama.llama_init_from_file(path, p)
            toks, rows = _compat_greedy(ctx, TINY_COMPAT_PROMPT, 6)
            if device == "cuda":
                for key, n in _counts().items():
                    counts[key] += n
                blob = llama.llama_get_kv_cache(ctx)
                n_tok = llama.llama_get_kv_cache_token_count(ctx)
                llama.llama_eval(ctx, [5, 6])
                after = llama.llama_get_logits(ctx).copy()
                llama.llama_set_kv_cache(ctx, blob, n_tok)
                llama.llama_eval(ctx, [5, 6])
                roundtrip_equal = bool((llama.llama_get_logits(ctx) == after).all())
            else:
                llama.llama_set_kv_cache(ctx, blob, n_tok)  # the card's blob on the CPU
                llama.llama_eval(ctx, [5, 6])
                cross = float(abs(llama.llama_get_logits(ctx) - after).max())
            out[device] = (toks, rows, llama.llama_get_kv_cache_size(ctx))
        drift = max(float(abs(a - b).max()) for a, b in zip(out["cuda"][1], out["cpu"][1]))
        ok = (out["cuda"][0] == out["cpu"][0] and drift <= 0.032 and cross <= 0.032
              and roundtrip_equal and out["cuda"][2] == out["cpu"][2])
        result[name] = {"tokens": out["cuda"][0], "equal_to_cpu": out["cuda"][0] == out["cpu"][0],
                        "logit_drift": drift, "limit": 0.032, "blob_roundtrip_equal":
                        roundtrip_equal, "card_blob_on_cpu_drift": cross,
                        "kv_cache_bytes": out["cuda"][2]}
        if not ok:
            raise SystemExit(f"tiny_compat ({name}): {result[name]}")
    # the library path to K4's f32 mode: 4 slots decoding together
    streams = {}
    _reset_counts()
    for device in ("cuda", "cpu"):
        cfg, params, _ = load_model(path, device=device)
        be = BatchedEngine(cfg, params, BatchConfig(max_batch=4, n_ctx=64, block=4,
                                                    kv_dtype="float32"), device=device)
        reqs = [be.submit(pr, 6, SamplerParams(temp=0.0), ignore_eos=True)
                for pr in TINY_SERVE_PROMPTS]
        be.run()
        streams[device] = [r.generated for r in reqs]
        if device == "cuda":
            for key, n in _counts().items():
                counts[key] += n
    if streams["cuda"] != streams["cpu"]:
        raise SystemExit(f"tiny_compat: batched f32 streams {streams}")
    result["batched_f32"] = {"streams": streams["cuda"], "equal_to_cpu": True}
    # the CLIs: the card's processes against this process on the CPU
    ppl = {}
    for key, extra in (("ppl", []), ("ppl_f32", ["--f32"])):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(io.StringIO()):
            perplexity.main(ppl_argv + extra + ["--device", "cpu"])
        card = _cli_out(procs[key], key)
        vals = [float(re.search(r"final perplexity: ([0-9.]+)", o).group(1))
                for o in (card, buf.getvalue())]
        ppl[key] = {"card": vals[0], "cpu": vals[1],
                    "log_diff": abs(math.log(vals[0]) - math.log(vals[1])),
                    "limit": TINY_PPL_LOG_TOL}
        if ppl[key]["log_diff"] > TINY_PPL_LOG_TOL:
            raise SystemExit(f"tiny_compat: perplexity CLI {key}: {ppl[key]}")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(io.StringIO()):
        embedding.main(emb_argv + ["--device", "cpu"])
    vecs = [torch.tensor([float(v) for v in o.split()])
            for o in (_cli_out(procs["emb"], "embedding"), buf.getvalue())]
    emb_drift = float((vecs[0] - vecs[1]).abs().max())
    if vecs[0].shape != (128,) or emb_drift > 0.032:
        raise SystemExit(f"tiny_compat: embedding CLI drift {emb_drift} ({vecs[0].shape})")
    result["perplexity_cli"] = ppl
    result["embedding_cli"] = {"n": 128, "max_abs_diff_to_cpu": emb_drift, "limit": 0.032}
    _require("tiny_compat", counts, ("q4_gemv", "q4_gemm", "attn_update_split",
                                     "attn_update_split_f32", "decode_f32"))
    return result, counts


# the final-norm activations of a kernel and a plain forward whose bf16
# roundings part somewhere in 32 layers: single elements may move several
# bf16 steps (2^-8 of themselves) while the logits, sums over 4096 of them,
# stay within 2^-8 of the largest; the embedding as a whole is held to 2^-5
# of its L2 norm
EMB_L2_LIMIT = 2.0**-5


def _nll_check(chunk_nll, chunk_plain, params, toks, what: str) -> dict:
    """A chunk's NLLs through the kernels (make_chunk_nll) against the plain
    versions' (`_plain_nll`): each NLL is a log-sum-exp minus a logit,
    so it moves by at most twice the logits' drift, which the kernel phases
    hold to 2^-8 of the largest logit; the limit is twice that bound, from
    the plain forward's largest |logit|. Also the kernels' ms per chunk
    (the median of 3, after a warm-up)."""
    got = chunk_nll(params, toks)
    want, scale = chunk_plain(params, toks)
    torch.cuda.synchronize()
    times = []
    for _ in range(4):
        t0 = time.perf_counter()
        chunk_nll(params, toks)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    err = float((got - want).abs().max())
    limit = 4 * LOGIT_REL_LIMIT * scale
    half = toks.shape[1] // 2
    ppl = [math.exp(float(x[half:].mean())) for x in (got, want)]
    if not (math.isfinite(err) and err <= limit):
        raise SystemExit(f"{what}: NLL {err:.3g} from plain (limit {limit:.3g})")
    return {"nll_max_abs_diff": err, "limit": limit, "max_abs_logit": scale,
            "ppl_second_half": ppl[0], "plain_ppl_second_half": ppl[1],
            "ms_per_chunk": statistics.median(times[1:]), "tokens": toks.shape[1]}


def _teacher_forced(cfg, params, prompt: list[int], stream: list[int], what: str,
                    kv=torch.bfloat16) -> dict | None:
    """The plain forward over the prompt and a greedy stream, teacher-forced
    on the stream: None where every token is the plain argmax; else the
    first that is not, which must lie within 2^-8 of the largest logit of
    the plain top (a near tie)."""
    from llamavk_tpu_torch.models.llama import init_kv_cache, llama_forward

    cache = init_kv_cache(cfg, 1, N_CTX, kv, "cuda")
    lg = llama_forward(params, torch.tensor([prompt + stream]).cuda(), cache, 0, cfg,
                       logits_all=True, use_ref=True)[0]
    del cache
    split = None
    for i, tok in enumerate(stream):
        row = lg[0, len(prompt) - 1 + i]
        top, scale = float(row.max()), float(row.abs().max())
        gap = (top - float(row[tok])) / scale
        if gap > 0:
            if gap > LOGIT_REL_LIMIT:
                raise SystemExit(f"{what}: token {i} ({tok}) is {gap:.3g} below the plain "
                                 f"top logit (limit {LOGIT_REL_LIMIT})")
            split = split or {"token": i, "gap_rel": gap}
    return split


def _perplexity_f32(cfg, seed: int, n_ctx: int, what: str) -> tuple[dict, dict]:
    """One seeded n_ctx-token chunk of perplexity --f32 (f32 scale planes,
    f32 activations and KV, einsum attention) through make_chunk_nll against
    the plain versions, in this process's dot and multiply modes; with the
    chunk's launches (under LLAMAVK_Q4_DOT=i8 also K5's device ms in one
    chunk)."""
    from llamavk_tpu_torch.cli.perplexity import make_chunk_nll
    from llamavk_tpu_torch.models.loader import synthetic_params
    from llamavk_tpu_torch.ops import q4_matmul as q4

    p32 = synthetic_params(cfg, seed=seed, device="cuda", scale_dtype=torch.float32)
    toks = torch.randint(3, cfg.n_vocab, (1, n_ctx),
                         generator=torch.Generator().manual_seed(seed + 9)).cuda()
    _reset_counts()
    chunk_nll = make_chunk_nll(cfg, n_ctx, dtype=torch.float32, attn_impl="einsum")
    res = _nll_check(chunk_nll, _plain_nll(cfg, n_ctx, torch.float32, "einsum"), p32, toks, what)
    counts = _counts()
    if q4.resolve_dot_mode() == "i8":  # K5's device time in one chunk
        res["device_ms_by_name"] = _k5_device_ms(lambda: chunk_nll(p32, toks))
    del p32
    torch.cuda.empty_cache()
    res["launches"] = {key: n for key, n in counts.items() if n}
    return res, counts


def _plain_nll(cfg, n_ctx: int, dtype, attn_impl: str):
    """make_chunk_nll's computation through the plain versions of the
    kernels, also returning the largest |logit| (the limit's scale)."""
    from llamavk_tpu_torch.models.llama import init_kv_cache, llama_forward

    def run(params, toks):
        kv = torch.float32 if dtype == torch.float32 else torch.bfloat16
        cache = init_kv_cache(cfg, 1, n_ctx, kv, "cuda")
        logits = llama_forward(params, toks, cache, 0, cfg, logits_all=True, dtype=dtype,
                               attn_impl=attn_impl, use_ref=True)[0][0]
        logp = torch.log_softmax(logits, dim=-1)
        nll = -logp[:-1].gather(1, toks[0, 1:, None])[:, 0]
        return nll, float(logits.abs().max())

    return run


def phase_eval_7b_f32(seed: int) -> tuple[dict, dict, dict]:
    """Synthetic LLaMA-7B through this slice's entry points. Perplexity: one
    seeded 512-token chunk through make_chunk_nll, bf16 (K1, K2 at T = 512)
    and as --f32 runs it (f32 scales: K1's f32 scale plane; f32 activations,
    einsum attention, f32 KV), NLLs against the plain versions, ms per
    chunk. The llama.h API with f16_kv = false (an f32 cache) over the same
    weights: a 32-token prompt, 128 greedy tokens through llama_eval (K2 f32
    at T = 1), then a 300-token turn (301 rows at n_past 159, a 353-row
    bucket: K3 f32); the stream against the plain forward teacher-forced on
    it (equal, or parting at a near tie), ms per token, the idle share, the
    cache's bytes, and the embeddings against the plain versions' second
    turn over the same cache. BatchedEngine(kv_dtype="float32"): 32 greedy
    requests decoding together (K4 f32). A B=32 decode step over a seeded
    f32 cache, kernels against plain. Returns (result, launches, shapes)."""
    from llamavk_tpu_torch import compat as llama
    from llamavk_tpu_torch.cli.perplexity import make_chunk_nll
    from llamavk_tpu_torch.models.llama import KVCache, llama_forward
    from llamavk_tpu_torch.models.loader import synthetic_params
    from llamavk_tpu_torch.runtime.batching import BatchConfig, BatchedEngine
    from llamavk_tpu_torch.runtime.engine import Engine, EngineConfig
    from llamavk_tpu_torch.runtime.sampling import SamplerParams

    cfg, params = _model_7b(seed)
    gen = torch.Generator().manual_seed(seed + 6)
    result = {}
    _reset_counts()
    _reset_shapes()
    toks = torch.randint(3, cfg.n_vocab, (1, N_CTX), generator=gen).cuda()
    result["perplexity_bf16"] = _nll_check(make_chunk_nll(cfg, N_CTX), _plain_nll(
        cfg, N_CTX, torch.bfloat16, "auto"), params, toks, "eval_7b_f32 (bf16)")
    p32 = synthetic_params(cfg, seed=seed, device="cuda", scale_dtype=torch.float32)
    result["perplexity_f32"] = _nll_check(
        make_chunk_nll(cfg, N_CTX, dtype=torch.float32, attn_impl="einsum"),
        _plain_nll(cfg, N_CTX, torch.float32, "einsum"), p32, toks, "eval_7b_f32 (--f32)")
    del p32
    counts = _counts()

    # the llama.h API with f16_kv = false over the synthetic weights
    cp = llama.llama_context_default_params()
    cp.f16_kv = False
    eng = Engine(cfg, params, EngineConfig(n_ctx=N_CTX, kv_dtype="float32", seed=seed),
                 device="cuda")
    ctx = llama.llama_context(engine=eng, tokenizer=_id_tokenizer(cfg.n_vocab), params=cp)
    prompt1 = torch.randint(3, cfg.n_vocab, (32,), generator=gen).tolist()
    prompt2 = torch.randint(3, cfg.n_vocab, (300,), generator=gen).tolist()
    _compat_greedy(ctx, prompt1, 8)  # warm-up
    _reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    llama.llama_eval(ctx, prompt1, n_past=0)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    stream = []
    t0 = time.perf_counter()
    for i in range(128):
        stream.append(llama.llama_sample_top_p_top_k(ctx, prompt1 + stream, 40, 0.95, 0.0, 1.0))
        if i < 127:  # the last token stays pending, as the generate CLI leaves it
            llama.llama_eval(ctx, [stream[-1]])
    decode_ms = (time.perf_counter() - t0) * 1e3 / 127
    snap = eng.save_session()  # the cache the second turn starts from
    t0 = time.perf_counter()
    llama.llama_eval(ctx, [stream[-1]] + prompt2)
    torch.cuda.synchronize()
    turn2_ms = (time.perf_counter() - t0) * 1e3
    emb = torch.from_numpy(llama.llama_get_embeddings(ctx))
    cache_bytes = llama.llama_get_kv_cache_size(ctx)
    for key, n in _counts().items():
        counts[key] += n
    # the embeddings against the second turn over the same cache (301 rows
    # at n_past 159 in the engine's 353-row bucket): bit-equal to the
    # kernels' forward, and within EMB_L2_LIMIT of the plain versions'; the
    # same drift over the cache in bf16 for comparison
    turn2 = torch.zeros((1, N_CTX - snap.n_past), dtype=torch.int64, device="cuda")
    turn2[0, : len(prompt2) + 1] = torch.tensor([stream[-1]] + prompt2)
    embs = {}
    for kv, ref in ((torch.float32, False), (torch.float32, True), (torch.bfloat16, False),
                    (torch.bfloat16, True)):
        c = KVCache(snap.k.to(kv), snap.v.to(kv))
        embs[kv, ref] = llama_forward(params, turn2, c, snap.n_past, cfg, last_idx=len(prompt2),
                                      use_ref=ref)[2][0].cpu()
        del c
    del snap
    emb_equal = bool(torch.equal(emb, embs[torch.float32, False]))
    emb_drift = {("f32" if kv == torch.float32 else "bf16"): {
        "max_rel": float((embs[kv, False] - embs[kv, True]).abs().max()
                         / embs[kv, True].abs().max()),
        "l2_rel": float((embs[kv, False] - embs[kv, True]).norm() / embs[kv, True].norm())}
        for kv in (torch.float32, torch.bfloat16)}
    split = _teacher_forced(cfg, params, prompt1, stream, "eval_7b_f32", torch.float32)
    if not (emb_equal and emb_drift["f32"]["l2_rel"] <= EMB_L2_LIMIT):
        raise SystemExit(f"eval_7b_f32: embeddings equal to the kernels' forward: {emb_equal}, "
                         f"drift from plain {emb_drift} (limit {EMB_L2_LIMIT})")
    # where a decode step's time goes: 8 llama_eval steps on the host clock,
    # 8 more under the profiler
    llama.llama_eval(ctx, stream[:1], n_past=40)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for t in stream[1:9]:
        llama.llama_eval(ctx, [t])
    torch.cuda.synchronize()
    plain_wall_ms = (time.perf_counter() - t0) * 1e3
    wall_ms, busy_ms, n_dev, top = _device_busy(
        lambda: [llama.llama_eval(ctx, [t]) for t in stream[9:17]])
    del ctx, eng
    result["compat_f32_kv"] = {
        "prompt": len(prompt1), "prefill_ms": prefill_ms, "decode_tokens": 127,
        "decode_ms_per_token": decode_ms, "tok_per_s": 1e3 / decode_ms,
        "turn2_rows": len(prompt2) + 1, "turn2_ms": turn2_ms,
        "stream_vs_plain": split or "equal", "embeddings_equal_to_kernel_forward": emb_equal,
        "embeddings_drift_from_plain": emb_drift, "embeddings_limit_l2_rel": EMB_L2_LIMIT,
        "limit_rel": LOGIT_REL_LIMIT, "kv_cache_bytes": cache_bytes,
        "wall_ms_per_step": plain_wall_ms / 8, "profiled_wall_ms_per_step": wall_ms / 8,
        "device_busy_ms_per_step": None if busy_ms is None else busy_ms / 8,
        "device_activities_per_step": n_dev / 8,
        "device_idle_share": None if busy_ms is None else 1 - busy_ms / plain_wall_ms,
        "device_ms_per_step_by_name": {k: v / 8 for k, v in top.items()},
    }
    # the library path to K4's f32 mode: 32 greedy requests of 16 tokens
    # decoding together in BatchedEngine(kv_dtype="float32")
    be = BatchedEngine(cfg, params, BatchConfig(max_batch=32, n_ctx=N_CTX, block=8,
                                                kv_dtype="float32"), device="cuda")
    reqs = [be.submit(torch.randint(3, cfg.n_vocab, (16,), generator=gen).tolist(), 16,
                      SamplerParams(temp=0.0), ignore_eos=True) for _ in range(32)]
    _reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    be.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    for key, n in _counts().items():
        counts[key] += n
    result["batched_engine_f32"] = {
        "requests": len(reqs), "tokens": sum(len(r.generated) for r in reqs),
        "tok_per_s": sum(len(r.generated) for r in reqs) / wall, "steps": be.stats["steps"],
        "slot_cache_bytes": sum(p.numel() * p.element_size() for p in be.cache.planes())}
    if any(len(r.generated) != 16 for r in reqs):
        raise SystemExit("eval_7b_f32: short batched generation")
    del be, reqs
    # a B=32 decode step over a seeded f32 cache: K4 f32, kernels vs plain
    result["batched_f32_step"] = _decode_step_check(params, cfg, seed, ("float32",),
                                                    "eval_7b_f32")["float32"]
    shapes = _shapes()
    result["launches"] = counts
    result.update(_shape_report(shapes))
    # the bf16 perplexity chunk (T 512) on the tensor cores; the f32 cache's
    # prompt (T 32) and second turn (T 301) on the tensor cores, its decode
    # steps on the split route
    _require("eval_7b_f32", counts, ("q4_gemv", "q4_gemm", "q4_gemm_f32", "attn_update_tc",
                                     "attn_update_tc_f32", "attn_update_split_f32",
                                     "attn_read_tc_f32",
                                     "decode_f32"))
    return result, counts, shapes


# ------------------------------------------------------------------ parallel

# parallel_7b: tp = 2 runs a 32-token prompt and 16 greedy decode steps at
# B = 1; pp = 2 runs the same prompt length at B = 4 in 2 microbatches and
# 4 greedy steps. Two ranks share cuda:0 over gloo (one card).
PAR_PROMPT, PAR_STEPS = 32, 16
PP_BATCH, PP_MICRO, PP_STEPS = 4, 2, 4
PAR_DEADLINE_S = 600  # each spawn of two ranks, start to exit
# serve_7b_tp: 8 concurrent greedy requests of 32 prompt tokens, 32 out
TP_REQUESTS, TP_TOKENS = 8, 32


def _par_prompts(seed: int, n_vocab: int) -> torch.Tensor:
    """parallel_7b's seeded prompts [PP_BATCH, PAR_PROMPT]; tp runs row 0."""
    gen = torch.Generator().manual_seed(seed + 8)
    return torch.randint(3, n_vocab, (PP_BATCH, PAR_PROMPT), generator=gen)


def _sync() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def _timed_ms(fn):
    """(fn's result, host ms to its end on the card)."""
    _sync()
    t0 = time.perf_counter()
    out = fn()
    _sync()
    return out, (time.perf_counter() - t0) * 1e3


def _model_cfg(config: dict | None):
    """The ModelConfig of synthetic 7B, or of `config`'s fields."""
    from llamavk_tpu_torch.models.llama import ModelConfig
    from llamavk_tpu_torch.models.loader import LLAMA_CONFIGS

    return ModelConfig(**(config or LLAMA_CONFIGS["7B"]))


def _parallel_rank(rank: int, init: str, out: str, seed: int, device: str = "cuda",
                   config: dict | None = None) -> None:
    """One of parallel_7b's two ranks on cuda:0: tp = 2 (its shard of
    synthetic 7B packed for tp 2; a 32-token prompt, 16 greedy decode
    steps), then pp = 2 with 2 microbatches at B = 4 (its 16 layers; the
    prompts, 4 greedy steps), through make_sharded_forward. Saves the
    logits of every step, the greedy tokens, host times and launches.
    (`device` "cpu" and a small `config` rehearse it without a card.)"""
    import torch.distributed as dist

    from llamavk_tpu_torch.models.llama import init_kv_cache
    from llamavk_tpu_torch.models.loader import synthetic_params
    from llamavk_tpu_torch.parallel import (make_mesh, make_sharded_forward, multihost,
                                            shard_cache, shard_params)

    torch.set_num_threads(4)
    multihost.initialize(init, 2, rank, device=device, timeout_s=300)
    cfg = _model_cfg(config)
    prompts = _par_prompts(seed, cfg.n_vocab).to(device)
    res = {"backend": dist.get_backend()}
    for name, tp, pp, mb, b, steps in (("tp", 2, 1, 1, 1, PAR_STEPS),
                                       ("pp", 1, 2, PP_MICRO, PP_BATCH, PP_STEPS)):
        mesh = make_mesh(tp=tp, pp=pp, device=device)
        params = shard_params(synthetic_params(cfg, seed=seed, device=device, tp=tp), mesh)
        torch.cuda.empty_cache()
        fwd = make_sharded_forward(cfg, params, mesh, pp_microbatch=mb)
        cache = shard_cache(init_kv_cache(cfg, b, N_CTX, device=device), mesh)
        _reset_counts()
        _reset_shapes()
        (logits, cache, _), prefill_ms = _timed_ms(lambda: fwd(params, prompts[:b], cache, 0))
        rows = [logits[:, -1].float().cpu()]
        toks = [logits[:, -1].argmax(-1)]
        t0 = time.perf_counter()
        for i in range(steps):
            logits, cache, _ = fwd(params, toks[-1][:, None], cache, PAR_PROMPT + i)
            rows.append(logits[:, -1].float().cpu())
            toks.append(logits[:, -1].argmax(-1))
        _sync()
        res[name] = {"logits": torch.stack(rows), "tokens": torch.stack(toks).cpu(),
                     "prefill_ms": prefill_ms,
                     "decode_ms_per_step": (time.perf_counter() - t0) * 1e3 / steps,
                     "counts": {k: n for k, n in _counts().items() if n},
                     "shapes": _shapes(), "local_layers": cache.k.shape[0]}
        del params, cache, fwd
        torch.cuda.empty_cache()
    torch.save(res, f"{out}.{rank}")
    multihost.shutdown()


def _near_tie_steps(single: torch.Tensor, tokens: torch.Tensor, what: str) -> list:
    """Where greedy tokens of a sharded run differ from the single-device
    argmax of the same step, the single-device logits must put both within
    2 * 2^-8 of the largest logit of the top one (each run's logits lie
    within 2^-8 of the other's, so such a flip is a near tie). Returns the
    near ties; fails on a wider gap."""
    ties = []
    for step in range(tokens.shape[0]):
        for row in range(tokens.shape[1]):
            w, tok = single[step, row], int(tokens[step, row])
            top = int(w.argmax())
            if top == tok:
                continue
            gap = float(w[top] - w[tok]) / float(w.abs().max())
            if gap > 2 * LOGIT_REL_LIMIT:
                raise SystemExit(f"{what}: step {step} row {row} took {tok}, the single device "
                                 f"{top}, {gap:.3g} apart (limit {2 * LOGIT_REL_LIMIT})")
            ties.append({"step": step, "row": row, "gap_rel": gap})
    return ties


def _single_teacher_forced(cfg, params, prompts: torch.Tensor, tokens: torch.Tensor
                           ) -> torch.Tensor:
    """The single-device forward's last logits of the prompts' prefill and of
    each step fed the sharded run's tokens: [steps + 1, B, n_vocab]."""
    from llamavk_tpu_torch.models.llama import init_kv_cache, llama_forward

    b = prompts.shape[0]
    cache = init_kv_cache(cfg, b, N_CTX, device="cuda")
    logits = llama_forward(params, prompts.cuda(), cache, 0, cfg)[0]
    rows = [logits[:, -1].float().cpu()]
    for i in range(tokens.shape[0] - 1):
        logits = llama_forward(params, tokens[i].cuda()[:, None], cache, PAR_PROMPT + i, cfg)[0]
        rows.append(logits[:, -1].float().cpu())
    return torch.stack(rows)


def _rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest |got - want| of each step and row over the largest
    |want| there."""
    return float(((got - want).abs().amax(-1) / want.abs().amax(-1)).max())


def phase_parallel_7b(seed: int) -> tuple[dict, dict]:
    """make_sharded_forward on synthetic 7B at full width with two ranks on
    the one card over gloo (`_parallel_rank`): tp = 2 and pp = 2 with 2
    microbatches, each step's logits on both ranks bit-equal, and within
    2^-8 of the largest single-device logit of the same step, teacher-forced
    on the sharded run's tokens; the greedy tokens equal the single-device
    argmax or part at a near tie (`_near_tie_steps`). The tp reference runs
    the same tp-packed weights whole (fused columns regrouped, wo/w2 in 2
    chunks: K1's chunked launches). Not a scaling result: both ranks share
    one card."""
    from llamavk_tpu_torch.models.llama import ModelConfig
    from llamavk_tpu_torch.models.loader import LLAMA_CONFIGS, regroup_fused, synthetic_params
    from llamavk_tpu_torch.parallel import multihost

    cfg = ModelConfig(**LLAMA_CONFIGS["7B"])
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as d:
        t0 = time.perf_counter()
        multihost.spawn(_parallel_rank, 2, (f"file://{d}/init", f"{d}/res", seed),
                        deadline_s=PAR_DEADLINE_S)
        ranks_s = time.perf_counter() - t0
        ranks = [torch.load(f"{d}/res.{r}") for r in range(2)]
    prompts = _par_prompts(seed, cfg.n_vocab)
    counts = dict.fromkeys(KERNEL_META, 0)
    result = {"backend": ranks[0]["backend"], "ranks_wall_s": ranks_s,
              "note": "two ranks share one card: not a scaling result"}
    for name, tp, b in (("tp", 2, 1), ("pp", 1, PP_BATCH)):
        got = ranks[0][name]
        if not all(torch.equal(got[k], ranks[1][name][k]) for k in ("logits", "tokens")):
            raise SystemExit(f"parallel_7b ({name}): the ranks' logits or tokens differ")
        whole = synthetic_params(cfg, seed=seed, device="cuda", tp=tp)
        whole = regroup_fused(whole, tp, 1)
        _reset_counts()
        if name == "tp":  # the chunked launches of the tp-packed weights run whole
            _reset_shapes()
        want = _single_teacher_forced(cfg, whole, prompts[:b], got["tokens"])
        single_counts = {k: n for k, n in _counts().items() if n}
        if name == "tp":
            single_shapes = _shapes()
        del whole
        torch.cuda.empty_cache()
        rel = _rel_err(got["logits"], want)
        if not (math.isfinite(rel) and rel <= LOGIT_REL_LIMIT):
            raise SystemExit(f"parallel_7b ({name}): logits {rel:.3g} of the largest "
                             f"single-device logit from it (limit {LOGIT_REL_LIMIT})")
        ties = _near_tie_steps(want, got["tokens"], f"parallel_7b ({name})")
        for c in (ranks[0][name]["counts"], ranks[1][name]["counts"], single_counts):
            for key, n in c.items():
                counts[key] += n
        result[name] = {
            "batch": b, "prompt_tokens": PAR_PROMPT, "decode_steps": got["tokens"].shape[0] - 1,
            "logit_rel_err": rel, "limit_rel": LOGIT_REL_LIMIT, "near_ties": ties,
            "ranks_bit_equal": True, "local_layers": got["local_layers"],
            "prefill_ms": [r[name]["prefill_ms"] for r in ranks],
            "decode_ms_per_step": [r[name]["decode_ms_per_step"] for r in ranks],
            "launches_per_rank": [r[name]["counts"] for r in ranks],
            "single_device_launches": single_counts,
        }
    per_rank_k2 = [sum(r["pp"]["counts"].get(f"attn_update_boff{route}", 0)
                       for route in ("", "_split", "_tc")) for r in ranks]
    want_k2 = PP_MICRO * ranks[0]["pp"]["local_layers"] * (1 + PP_STEPS)
    if per_rank_k2 != [want_k2, want_k2]:
        raise SystemExit(f"parallel_7b (pp): K2 batch_offset launches {per_rank_k2} per rank, "
                         f"not M x local layers x forwards = {want_k2}")
    _require("parallel_7b", counts, ("q4_gemv", "q4_gemm", "attn_update_split",
                                     "attn_update_tc", "attn_update_boff_split",
                                     "attn_update_boff_tc",
                                     "q4_gemv_chunks", "q4_gemm_chunks"))
    result["shape_rows"] = phase_serve_shapes(
        _rank_shapes(*(r[name]["shapes"] for r in ranks for name in ("tp", "pp")),
                     single_shapes), seed, 5, "parallel_7b")
    return result, counts


def _serve_tp_rank(rank: int, init: str, out: str, seed: int, bodies: list[dict],
                   device: str = "cuda", config: dict | None = None) -> None:
    """One of serve_7b_tp's two ranks on cuda:0, through the serve CLI's own
    rank code (`cli.serve.run_rank`): rank 0 a LlamaServer over the mesh
    (HTTP, the request queue) answering `bodies` at once, rank 1
    `follow_rank`; synthetic 7B packed for tp 2 in place of a checkpoint,
    8 slots, int8 KV. (`device` and `config` as `_parallel_rank`'s.)"""
    import torch.distributed as dist

    from llamavk_tpu_torch.cli.serve import run_rank
    from llamavk_tpu_torch.models.loader import synthetic_params

    torch.set_num_threads(4)
    cfg = _model_cfg(config)
    res = {}

    def load():
        whole = synthetic_params(cfg, seed=seed, device=device, tp=2)
        _reset_counts()
        _reset_shapes()
        return cfg, whole, _id_tokenizer(cfg.n_vocab)

    def serve(srv):
        torch.cuda.empty_cache()
        base, thread = _serve(srv)
        res.update(_load(srv, base, bodies))
        srv.shutdown()
        thread.join(timeout=30)
        res["backend"] = dist.get_backend()

    run_rank(rank, 2, init, load, _tp_bcfg(), serve, device, timeout_s=300)
    res["counts"] = {k: n for k, n in _counts().items() if n}
    res["shapes"] = _shapes()
    torch.save(res, f"{out}.{rank}")


def _rank_shapes(*shape_sets: dict) -> dict:
    """The shapes to hold against the plain versions after a phase of ranks:
    every shape of the given `_shapes()` results, a rank's local shapes
    (K1 at its weights' slices, attention at its H / tp heads) included,
    with their launches summed."""
    out = {key: {} for key in shape_sets[0]}
    for shapes in shape_sets:
        for key, counter in shapes.items():
            for shape, n in counter.items():
                out[key][shape] = out[key].get(shape, 0) + n
    return out


def _tp_bcfg():
    from llamavk_tpu_torch.runtime.batching import BatchConfig

    return BatchConfig(max_batch=TP_REQUESTS, n_ctx=N_CTX, block=8, kv_dtype="int8")


def phase_serve_7b_tp(seed: int) -> tuple[dict, dict]:
    """serve --tp 2's ranks (`_serve_tp_rank`) on synthetic 7B with int8 KV
    answering 8 concurrent greedy HTTP requests; their streams against the
    same model served by one rank (`--tp 1`: the tp-packed weights run
    whole, wo/w2 in 2 chunks), equal or parting at a near tie (`_split_at`);
    tok/s, ms per decode step, TTFT and the backend. Then every kernel
    against its plain version at each shape either rank launched it at
    (`_rank_shapes`: K1 at the weights' slices, K2 and K4 at 16 heads) and
    at the one-rank run's chunked K1 shapes."""
    from llamavk_tpu_torch.models.llama import ModelConfig
    from llamavk_tpu_torch.models.loader import LLAMA_CONFIGS, regroup_fused, synthetic_params
    from llamavk_tpu_torch.parallel import multihost

    cfg = ModelConfig(**LLAMA_CONFIGS["7B"])
    gen = torch.Generator().manual_seed(seed + 9)
    prompts = [torch.randint(3, cfg.n_vocab, (PAR_PROMPT,), generator=gen).tolist()
               for _ in range(TP_REQUESTS)]
    bodies = [dict(prompt=p, max_tokens=TP_TOKENS, temperature=0.0, ignore_eos=True)
              for p in prompts]
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as d:
        multihost.spawn(_serve_tp_rank, 2, (f"file://{d}/init", f"{d}/res", seed, bodies),
                        deadline_s=PAR_DEADLINE_S)
        ranks = [torch.load(f"{d}/res.{r}") for r in range(2)]
    load = ranks[0]
    _check_answers("serve_7b_tp", load["answers"], TP_TOKENS)
    whole = regroup_fused(synthetic_params(cfg, seed=seed, device="cuda", tp=2), 2, 1)
    _reset_counts()
    _reset_shapes()
    one = _greedy_streams(cfg, whole, _tp_bcfg(), prompts, TP_TOKENS)
    single_counts = {k: n for k, n in _counts().items() if n}
    shapes = _shapes()
    splits = [_split_at(cfg, whole, p, _ids(a["text"]), w, f"serve_7b_tp request {i}",
                        torch.int8, None)
              for i, (p, a, w) in enumerate(zip(prompts, load["answers"], one))]
    del whole
    torch.cuda.empty_cache()
    counts = dict.fromkeys(KERNEL_META, 0)
    for c in (ranks[0]["counts"], ranks[1]["counts"], single_counts):
        for key, n in c.items():
            counts[key] += n
    _require("serve_7b_tp", counts, ("q4_gemm", "attn_update_tc_i8", "decode_i8",
                                     "q4_gemm_chunks"))
    chunked = {"q4": {}, "q4_f32": {}, "q4_i8": {}, "attn": {}, "decode": {},
               "q4_modes": {k: n for k, n in shapes["q4_modes"].items() if "chunks" in k[0]}}
    chunked = _rank_shapes(chunked, ranks[0]["shapes"], ranks[1]["shapes"])
    result = {
        "backend": load["backend"], "requests": TP_REQUESTS, "max_tokens": TP_TOKENS,
        "streams_equal_to_tp1": sum(s is None for s in splits),
        "split_at_near_tie": [s for s in splits if s is not None],
        "tok_per_s": load["tok_per_s"], "decode_ms_per_step": load["decode_ms_per_step"],
        "ttft_ms_p50": load["ttft_ms_p50"], "wall_s": load["wall_s"],
        "launches_per_rank": [r["counts"] for r in ranks], "tp1_launches": single_counts,
        "note": "two ranks share one card: not a scaling result",
        "shape_rows": phase_serve_shapes(chunked, seed, 5, "serve_7b_tp"),
    }
    return result, counts


def _attn_samples(attn: dict) -> list[tuple[tuple, int]]:
    """The attention shapes to check, with their launches: every key, except
    that keys differing only in a host-int n_past (a decode loop's one per
    position) are checked at their least, median and largest n_past, and
    each sample carries a third of the group's launches."""
    groups: dict = {}
    for key, n in attn.items():
        groups.setdefault(key[:8] + (isinstance(key[8], int),) + key[9:], []).append((key, n))
    out = []
    for members in groups.values():
        members.sort(key=lambda kn: -1 if kn[0][8] is None else kn[0][8])
        picks = ({0, len(members) // 2, len(members) - 1} if len(members) > 3
                 else range(len(members)))
        total = sum(n for _, n in members)
        for i in sorted(picks):
            key, n = members[i]
            out.append((key, n if len(members) <= 3 else total // len(picks)))
    return sorted(out, key=lambda kn: str(kn[0]))


def phase_serve_shapes(shapes: dict, seed: int, reps: int, phase: str = "serve_7b") -> list[dict]:
    """Every kernel against its plain version at every shape a phase
    launched it at (`_shapes`): K1 and K5 at each (M, K, N), in each mode
    the launch key names (`q4_matmul.launch_key`; K5 over f32 scales
    `i8_f32`); K2 and K3 at
    each (B, T, S, block_k, cache type, n_past, page table width, straddle,
    mode), a vector n_past seeded per row, a decode loop's host-int n_past
    sampled (`_attn_samples`); K4 at each (B, S, block_k, cache type, page
    table width), n_past seeded per row. Paged shapes run through scrambled
    tables and are also held bit for bit against the flat kernels; ring
    shapes over the plane an engine leaves at that n_past (keep 32); prefix
    shapes over a seeded pool of the shape's entries and rows, prefix
    lengths seeded per row."""
    timer = Timer(reps)
    gen = torch.Generator(device="cuda").manual_seed(seed + 2)
    gen_cpu = torch.Generator().manual_seed(seed + 2)
    names = {kn: name for name, kn in ALL_K1_SHAPES.items()}
    rows = []

    def add(row, launches):
        row["launches_in_" + phase] = launches
        rows.append(row)
        emit({"phase": "serve_shape", **row})

    for m, k, n in sorted(shapes["q4"]):
        add(kernel_q4(timer, gen, names[(k, n)], m, True, plain_reps=2), shapes["q4"][(m, k, n)])
    for m, k, n in sorted(shapes["q4_f32"]):
        add(kernel_q4(timer, gen, names[(k, n)], m, True, plain_reps=2, f32_scales=True),
            shapes["q4_f32"][(m, k, n)])
    for m, k, n in sorted(shapes["q4_i8"]):
        add(kernel_q4_i8(timer, gen, names[(k, n)], m, True, plain_reps=2),
            shapes["q4_i8"][(m, k, n)])
    for key, m, k, n in sorted(shapes["q4_modes"]):
        parts = key.split("_")
        chunks = 2 if "chunks" in parts else 1  # the tp = 2 packing
        if parts[0] == "i8":  # K5 over f32 scales, or chunked
            row = kernel_q4_i8(timer, gen, names[(k, n)], m, True, plain_reps=2,
                               f32_scales="f32" in parts, chunks=chunks)
        else:
            row = kernel_q4(timer, gen, names[(k, n)], m, True, plain_reps=2,
                            f32_scales="f32" in parts, layout="lin" if "lin" in parts else "ilv",
                            dot="f32" if "dotf32" in parts else "bf16",
                            mul=torch.bfloat16 if "mulbf16" in parts else torch.float32,
                            chunks=chunks)
            if row["kernel"] != "q4_" + key:
                raise SystemExit(f"serve_shapes: {key} checked as {row['kernel']}")
        add(row, shapes["q4_modes"][(key, m, k, n)])
    for key, launches in _attn_samples(shapes["attn"]):
        path, b, t, h, s, d, bk, kind, n_past, maxlb, straddle, mode = key
        quant, f32 = kind == "int8", kind == "f32"
        flat = maxlb is None and (mode is None or mode[0] in ("boff", "nocommit"))
        if d != D or H % h or h != H and not flat:
            raise SystemExit(f"serve_shapes: attention at H={h} D={d} "
                             f"({mode or ('paged' if maxlb else 'flat')}), "
                             "not the 7B width or a tp rank's heads of a flat cache")
        cap = s * (maxlb or 1)
        if mode is not None and mode[0] == "ring":
            row = kernel_attn_ring(timer, gen, t, n_past, path == "update", quant, True, s=s,
                                   bk=bk)
            add(row, launches)
            continue
        if n_past is None:
            n_past = torch.randint(0, cap - t + 1, (b,), generator=gen_cpu).tolist()
        if mode is not None and mode[0] in ("boff", "nocommit"):  # (mode, B_cache, offset)
            row = kernel_attn_pp(timer, gen, path, b, t, n_past, mode[1], mode[2], quant, True,
                                 commit=int(mode[0] == "boff"), s=s, bk=bk, h=h)
        elif mode is not None:  # ("prefix", NP, Sp, pblock_k): seeded prefix lengths
            _, n_pool, sp, _ = mode
            plens = torch.randint(0, sp + 1, (b,), generator=gen_cpu).tolist()
            row = kernel_attn_prefix(timer, gen, gen_cpu, b, t, n_past, path == "update", quant,
                                     True, plens, sp, n_pool, s, bk=bk)
        elif maxlb is None:
            row = kernel_attn(timer, gen, t, n_past, path == "update", True, b, quant, s, bk, f32,
                              h)
        else:
            row = kernel_attn_paged(timer, gen, gen_cpu, t, n_past, path == "update", b, quant,
                                    cap, s, bk, main_path=True, straddle=straddle)
        add(row, launches)
    for key in sorted(shapes["decode"], key=str):
        b, h, s, d, bk, kind, maxlb, *pmode = key  # pmode: [("boff", B_cache, offset)]
        quant = kind == "int8"
        if d != D or H % h or h != H and maxlb is not None:
            raise SystemExit(f"serve_shapes: batched decode at H={h} D={d}, not the 7B width "
                             "or a tp rank's heads of a flat cache")
        if pmode:
            row = kernel_attn_pp(timer, gen, "decode", b, 1, _decode_npast(b, s, gen_cpu),
                                 pmode[0][1], pmode[0][2], quant, True, s=s, bk=bk, h=h)
        elif maxlb is None:
            row = kernel_decode(timer, gen, gen_cpu, b, quant, True, h, d, s, bk, kind == "f32")
        else:
            row = kernel_decode_paged(timer, gen, gen_cpu, b, quant, s * maxlb, s, bk,
                                      main_path=True)
        add(row, shapes["decode"][key])
    bad = [r["shape"] for r in rows if not r["ok"]]
    if bad:
        raise SystemExit(f"serve_shapes: kernels disagree with their plain versions at {bad}")
    return rows


def summary(rows: list[dict], counts: dict) -> dict:
    """One entry per kernel, at the main-path shape that costs it most (any
    shape where no main path of this run reached it at 7B width); the error
    is the largest over every shape it was checked at. Launches are summed
    over the main paths driven."""
    out = []
    for name, (source, replaces) in KERNEL_META.items():
        mine = [r for r in rows if r["kernel"] == name]
        if not mine:  # a run of some phases only
            continue
        worst = max([r for r in mine if r["main_path"]] or mine, key=lambda r: r["ms"])
        out.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": counts.get(name, 0), "max_abs_err": max(r["max_abs_err"] for r in mine),
            "ms": worst["ms"], "plain_ms": worst["plain_ms"], "bound_ms": worst["bound_ms"],
            "bound_by": worst["bound_by"], "library_ms": worst["library_ms"],
            "shape": worst["shape"],
        })
        if worst["library_ms"]:
            out[-1]["library_factor"] = worst["ms"] / worst["library_ms"]
    return {"kernels": out}


PHASES = ("env,build,kernels,probes,tiny_cli,tiny_compat,generate_7b,generate_7b_lookup,"
          "spec_7b_self,tiny_serve,serve_7b,serve_7b_paged,serve_7b_lookup,generate_7b_ring,"
          "serve_7b_shared,eval_7b_f32,generate_7b_modes,parallel_7b,serve_7b_tp")
# phases that run in a process of their own, under the environment a parent
# phase starts them with
CHILD_PHASES = {
    "lookup_i8_child": lambda seed: _lookup_cli_runs(seed)[0],  # generate_7b_lookup's i8 half
    "modes_f32_child": _modes_f32_child,  # generate_7b_modes under LLAMAVK_Q4_DOT=f32
    "modes_mul_child": _modes_mul_child,  # generate_7b_modes under LLAMAVK_Q4_MUL=bf16
}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default=PHASES)
    ap.add_argument("--reps", type=int, default=20, help="timed launches per kernel")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", help="also write every phase's result to this JSON file")
    ap.add_argument("--lookup-idle-tokens", default="16",
                    help="generate_7b_lookup's idle-share windows, in tokens, comma-separated")
    args = ap.parse_args()
    phases = args.phases.split(",")
    global LOOKUP_IDLE_TOKENS
    LOOKUP_IDLE_TOKENS = tuple(int(n) for n in args.lookup_idle_tokens.split(","))

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    import llamavk_tpu_torch  # noqa: F401  (fails outside a checkout of the repo)

    if len(phases) == 1 and phases[0] in CHILD_PHASES:
        t0 = time.perf_counter()
        result = CHILD_PHASES[phases[0]](args.seed)
        emit({**result, "child_seconds": round(time.perf_counter() - t0, 2)})
        return 0
    report: dict = {}
    t_start = time.perf_counter()

    seconds = report["phase_seconds"] = {}

    @contextlib.contextmanager
    def timed(name: str):
        t0 = time.perf_counter()
        yield
        seconds[name] = round(time.perf_counter() - t0, 2)
        emit({"phase_seconds": name, "seconds": seconds[name]})

    with timed("env"):
        env = phase_env()
    report["env"] = env
    emit({"phase": "env", **env})
    if "build" in phases:
        with timed("build"):
            report["build"] = phase_build()
        emit({"phase": "build", **report["build"]})
    rows: list[dict] = []
    if "kernels" in phases:
        with timed("kernels"):
            rows = phase_kernels(args.reps)
        report["kernels"] = rows
    elif "kernels_parallel" in phases:  # the parallel paths' rows alone: a short check
        with timed("kernels_parallel"):
            rows = kernels_parallel(Timer(args.reps), torch.Generator(device="cuda").manual_seed(0),
                                    torch.Generator().manual_seed(0))
        bad = [r["shape"] for r in rows if not r["ok"]]
        if bad:
            raise SystemExit(f"kernels disagree with their plain versions: {bad}")
        report["kernels"] = rows
    counts = dict.fromkeys(KERNEL_META, 0)  # launches summed over the main paths

    def add(path_counts: dict) -> None:
        for key, n in path_counts.items():
            if key not in KERNEL_META and n:
                raise SystemExit(f"launches of {key}, which KERNEL_META does not name")
            counts[key] = counts.get(key, 0) + n

    if "probes" in phases:
        with timed("probes"):
            report["probes"], path_counts, probe_rows = phase_probes(args.reps)
        add(path_counts)
        rows += probe_rows
        report["probe_rows"] = probe_rows
        emit({"phase": "probes", **report["probes"]})
    if "tiny_cli" in phases:
        (ROOT / "build").mkdir(exist_ok=True)
        with timed("tiny_cli"), tempfile.TemporaryDirectory(dir=ROOT / "build") as work:
            report["tiny_cli"] = phase_tiny_cli(Path(work))
        emit({"phase": "tiny_cli", **report["tiny_cli"]})

    if "tiny_compat" in phases:
        (ROOT / "build").mkdir(exist_ok=True)
        with timed("tiny_compat"), tempfile.TemporaryDirectory(dir=ROOT / "build") as work:
            report["tiny_compat"], path_counts = phase_tiny_compat(Path(work))
        add(path_counts)
        emit({"phase": "tiny_compat", **report["tiny_compat"]})

    if "generate_7b" in phases:
        with timed("generate_7b"):
            report["generate_7b"], path_counts = phase_generate_7b(args.seed)
        add(path_counts)
        emit({"phase": "generate_7b", **report["generate_7b"]})
    plain = None
    if "generate_7b_lookup" in phases:
        with timed("generate_7b_lookup"):
            report["generate_7b_lookup"], path_counts = phase_generate_7b_lookup(args.seed)
        add(path_counts)
        plain = report["generate_7b_lookup"]["bf16"].pop("plain_stream")
        report["generate_7b_lookup"]["i8"].pop("plain_stream")
        report["generate_7b_lookup_i8_shapes"] = report["generate_7b_lookup"]["i8"].pop(
            "shape_rows")
        rows += report["generate_7b_lookup_i8_shapes"]
        lookup_shapes = _shapes()
        emit({"phase": "generate_7b_lookup", **report["generate_7b_lookup"]})
    if "spec_7b_self" in phases:
        with timed("spec_7b_self"):
            report["spec_7b_self"], path_counts = phase_spec_7b_self(args.seed, plain)
        add(path_counts)
        emit({"phase": "spec_7b_self", **report["spec_7b_self"]})
    if "generate_7b_lookup" in phases:
        # every kernel at every shape the lookup, plain and draft-model runs
        # launched it at with the default dot (the i8 child checked its own)
        shapes = _shapes() if "spec_7b_self" in phases else lookup_shapes
        report["generate_7b_lookup"]["bf16"].update(_shape_report(shapes))
        with timed("generate_7b_lookup_shapes"):
            spec_rows = phase_serve_shapes(shapes, args.seed, max(5, args.reps // 4),
                                           "generate_7b_lookup")
        report["generate_7b_lookup_shapes"] = spec_rows
        rows += spec_rows
    if "tiny_serve" in phases:
        (ROOT / "build").mkdir(exist_ok=True)
        with timed("tiny_serve"), tempfile.TemporaryDirectory(dir=ROOT / "build") as work:
            report["tiny_serve"], path_counts = phase_tiny_serve(Path(work))
        add(path_counts)
        emit({"phase": "tiny_serve", **report["tiny_serve"]})
    for name, phase in (("generate_7b_ring", phase_generate_7b_ring),
                        ("generate_7b_modes", phase_generate_7b_modes),
                        ("parallel_7b", phase_parallel_7b), ("serve_7b_tp", phase_serve_7b_tp)):
        if name in phases:
            with timed(name):
                report[name], path_counts = phase(args.seed)
            add(path_counts)
            if "shape_rows" in report[name]:
                report[f"{name}_shapes"] = report[name].pop("shape_rows")
                rows += report[f"{name}_shapes"]
            emit({"phase": name, **report[name]})
    for name, phase in (("serve_7b", phase_serve_7b), ("serve_7b_paged", phase_serve_7b_paged),
                        ("serve_7b_lookup", phase_serve_7b_lookup),
                        ("serve_7b_shared", phase_serve_7b_shared),
                        ("eval_7b_f32", phase_eval_7b_f32)):
        if name in phases:
            with timed(name):
                report[name], path_counts, shapes = phase(args.seed)
            add(path_counts)
            emit({"phase": name, **report[name]})
            with timed(name + "_shapes"):
                serve_rows = phase_serve_shapes(shapes, args.seed, max(5, args.reps // 4), name)
            report[f"{name}_shapes"] = serve_rows
            rows += serve_rows
    emit({"phase_seconds": "all", "seconds": round(time.perf_counter() - t_start, 2)})
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
