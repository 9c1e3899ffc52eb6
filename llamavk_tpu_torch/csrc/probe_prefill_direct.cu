// A one-launch prefill attention for Hopper (sm_90a): the probe of whether
// prefill needs K2's read-modify-write discipline.
//
// Replaces the TPU probe kernel `tools/bench_prefill_ownrows.py::kern_direct`
// :39 (P5): causal attention at n_past 0 whose program writes its own K/V
// rows straight into the cache and takes its own rows from the input, never
// reading them back. On the TPU the grid's t dimension runs in order, so a
// program there attends earlier blocks' rows from the cache that earlier
// programs wrote. GPU blocks run in no order, and no block may read rows
// another block of the same launch writes: here every key row, earlier
// blocks' included, comes from the input knew/vnew (n_past is 0, so the
// input holds every row a query sees), and the cache is only written. K2
// (csrc/flash_attn.cu) writes in one launch and attends in a second for the
// same reason.
//
// q, knew, vnew bf16 [B, H, T, D] (the probe's head-major blocks), out f32
// [B, H, T, D], the cache k, v bf16 [1, B, H, S, D] (layer 0), T <= S. Block
// (b*H + h, t0 / 8): its 8 query rows' K and V rows are copied into the cache
// (16-byte stores), then `attn::attend_block` (the first K2/K3 attention:
// one warp a query row, key tiles in shared memory, online softmax over KV
// blocks of `block_k` rows, the probabilities rounded to bf16 for the PV
// sum) runs over
// the input's rows [0, t0 + 8) of (b, h), seen as a one-head cache of T rows.
// What bounds it: bytes. At T = 512, h 32, d 128 it reads q, k and v (12.6
// MB) and writes the f32 output and the cache rows (16.8 MB), 8.8 us at
// 3.35 TB/s; the causal QK and PV products (2.1 GFLOP) would take 2.2 us on
// the tensor cores. It runs them on the CUDA cores, as K2 does.

#include "attn_common.cuh"

namespace {

template <int D>
__global__ void __launch_bounds__(attn::WARPS * 32)
prefill_direct_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ kn,
                      const __nv_bfloat16* __restrict__ vn, float* __restrict__ out,
                      __nv_bfloat16* __restrict__ kc, __nv_bfloat16* __restrict__ vc, int T,
                      int S, int block_k, float scale) {
  const int bh = blockIdx.x;  // b * H + h
  const int t0 = blockIdx.y * attn::WARPS;
  const int rows = min(attn::WARPS, T - t0);
  // 1. this block's rows into the cache, straight from the input
  constexpr int CH = D * 2 / 16;  // 16-byte chunks a row
  const size_t src = ((size_t)bh * T + t0) * D, dst = ((size_t)bh * S + t0) * D;
  for (int e = threadIdx.x; e < 2 * rows * CH; e += blockDim.x) {
    const int which = e / (rows * CH), i = e - which * rows * CH;
    const uint4* from = reinterpret_cast<const uint4*>((which ? vn : kn) + src) + i;
    uint4* to = reinterpret_cast<uint4*>((which ? vc : kc) + dst) + i;
    *to = __ldg(from);
  }
  // 2. attention over the input's rows [0, t0 + 8): every key from knew/vnew
  const attn::KVMap map{nullptr, 0, T};
  attn::attend_block<D, __nv_bfloat16>(q, kn, vn, nullptr, nullptr, out, bh, 0, t0, 0, T, 1,
                                       map, block_k, scale);
}

template <int D>
cudaError_t launch(const __nv_bfloat16* q, const __nv_bfloat16* kn, const __nv_bfloat16* vn,
                   float* out, __nv_bfloat16* kc, __nv_bfloat16* vc, int BH, int T, int S,
                   int block_k, float scale, cudaStream_t st) {
  static size_t dyn_done = 0;
  const size_t dyn = attn::dyn_smem(block_k);
  cudaError_t e = attn::allow_dyn_smem(prefill_direct_kernel<D>, dyn, dyn_done);
  if (e != cudaSuccess) return e;
  dim3 grid(BH, (T + attn::WARPS - 1) / attn::WARPS);
  prefill_direct_kernel<D><<<grid, attn::WARPS * 32, dyn, st>>>(
      q, kn, vn, out, kc, vc, T, S, block_k, scale);
  return cudaGetLastError();
}

}  // namespace

// q, k_new, v_new bf16 [B, H, T, D]; out f32 [B, H, T, D]; k_cache, v_cache
// bf16 [1, B, H, S, D], rows [0, T) of every (b, h) written; D 64 or 128,
// T <= S, block_k a multiple of 8; `scale` multiplies q (1/sqrt(D), as K2's
// wrapper passes it). Returns cudaGetLastError() after the launch.
extern "C" int prefill_direct_launch(const void* q, const void* k_new, const void* v_new,
                                     void* out, void* k_cache, void* v_cache, int B, int H,
                                     int T, int S, int D, int block_k, float scale,
                                     void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (T < 1 || T > S || block_k < 8 || block_k % 8) return (int)cudaErrorInvalidValue;
  auto qq = static_cast<const __nv_bfloat16*>(q);
  auto kn = static_cast<const __nv_bfloat16*>(k_new);
  auto vn = static_cast<const __nv_bfloat16*>(v_new);
  auto o = static_cast<float*>(out);
  auto kc = static_cast<__nv_bfloat16*>(k_cache);
  auto vc = static_cast<__nv_bfloat16*>(v_cache);
  if (D == 128) return (int)launch<128>(qq, kn, vn, o, kc, vc, B * H, T, S, block_k, scale, st);
  if (D == 64) return (int)launch<64>(qq, kn, vn, o, kc, vc, B * H, T, S, block_k, scale, st);
  return (int)cudaErrorInvalidValue;
}
