"""llamavk_tpu_torch — the PyTorch / CUDA port of llamavk_tpu for NVIDIA Hopper.

The same single-stream LLaMA Q4_0 engine as the JAX package beside it, with
its Pallas TPU kernels rewritten by hand in CUDA C++ for sm_90a (`csrc/`,
built with nvcc on first use and bound with ctypes). Every kernel has a
plain PyTorch version beside it, which CPU tensors take.

Subpackages:
  formats   — GGML/GGMF/GGJT checkpoint IO, Q4 codecs, device repack (NumPy)
  models    — LLaMA config, forward pass, loader, synthetic params
  ops       — kernel wrappers + plain versions, norms, rope, the nvcc build
  runtime   — decode engine and sampling
  cli       — generate
"""

__version__ = "0.1.0"
