// The split-K sum of K1 (q4_matmul.cu: the GEMV's and the GEMM's) and of the
// probe kernels (probe_q4_unpack.cu, probe_q4_i8.cu):
// partial [splits, mn] -> out [mn], each element summed over the splits in
// split order (deterministic), in the accumulator type `Acc` (float, or int
// for an exact integer product), then converted once to `Out`.
#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

template <typename Acc, typename Out>
__global__ void split_sum_kernel(const Acc* __restrict__ partial, Out* __restrict__ out,
                                 int splits, int mn) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= mn) return;
  Acc sum = 0;
  for (int s = 0; s < splits; ++s) sum += partial[(size_t)s * mn + i];
  out[i] = static_cast<Out>(sum);
}

// One launch over mn elements on `st`.
template <typename Acc, typename Out>
inline void launch_split_sum(const Acc* partial, Out* out, int splits, int mn, cudaStream_t st) {
  split_sum_kernel<Acc, Out><<<(mn + 255) / 256, 256, 0, st>>>(partial, out, splits, mn);
}
