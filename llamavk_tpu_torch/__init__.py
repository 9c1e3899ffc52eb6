"""llamavk_tpu_torch — the PyTorch / CUDA port of llamavk_tpu for NVIDIA Hopper.

The LLaMA Q4_0 engines of the JAX package beside it (single-stream
generation, continuous-batching serving over a flat or paged bf16 or int8 KV
cache, and prompt-lookup and draft-model speculation; the llama.h API with an
f32 cache under `f16_kv = false`; perplexity, embedding and the quantizer),
with their Pallas TPU
kernels rewritten by hand in CUDA C++ for
sm_90a (`csrc/`, built with nvcc on first use and bound with ctypes). Every
kernel has a plain PyTorch version beside it, which CPU tensors take.

Subpackages:
  formats   — GGML/GGMF/GGJT checkpoint IO, Q4 codecs, device repack (NumPy)
  models    — LLaMA config, forward pass, loader, synthetic params
  ops       — kernel wrappers + plain versions, norms, rope, int8 KV
              quantization, the nvcc build
  runtime   — decode engine, continuous-batching engine, page allocator,
              speculative engines, HTTP server, sampling
  cli       — generate, serve, perplexity, embedding, quantize
  compat    — the llama.h API (llama_init_from_file, llama_eval, ...)
  utils     — system_info
"""

__version__ = "0.1.0"
