// Causal attention over the bf16 KV cache for Hopper (sm_90a), and the fused
// cache write that precedes it.
//
// Replaces two TPU kernels of llamavk_tpu/ops/flash_attn.py, in their bf16
// flat-cache mode:
//  * `_update_kernel` (:120, entry `flash_attention_update`): write T new
//    K/V rows at [n_past, n_past+T) of layer l, then attend;
//  * `_read_kernel` -> `_attend` (:474, :512, entry `flash_attention`):
//    attend over a cache that already holds the rows.
//
// The TPU update kernel runs its t-blocks in order on one core, so a t-block
// may read rows an earlier t-block just wrote. GPU blocks run in no order, so
// here the write is its own launch (`kv_write_kernel`) and the attention a
// second launch on the same stream: every row the attention reads is written
// before it starts. Written bytes are the bf16 rows the caller passes (the
// wrapper casts them exactly as flash_attn.py:1101-1103 does).
//
// Numerics (flash_attn.py:738-808): q is scaled by 1/sqrt(D) in f32 and
// rounded to bf16; scores are f32 sums of bf16 products; column j is visible
// to query row t iff j <= n_past + t, else its score is -1e30; the online
// max and sum run in f32 over KV blocks of exactly `block_k` rows (the block
// partition pins the accumulation order, as kv_block does in the reference);
// p is rounded to bf16 before the PV product; out = acc / l in f32. Blocks
// past a row's last visible column contribute exactly zero, so reading only
// up to the tile's last visible column does not change the result.
//
// What bounds it on an H100: decode (T = 1) reads the valid cache prefix of
// one layer (at most 2 * H * S * D * 2 bytes) and is bound by those bytes;
// prefill is bound by its operations (4 * T * S_visible * D per head). This
// first design uses CUDA cores only: a block owns 8 query rows of one
// (batch, head), one per warp; K and V arrive in 64-row shared tiles (rows
// padded so lane j reading key j is free of bank conflicts); lane j scores
// key j of the tile, then the warp's 32 lanes own D/32 output dims each for
// the PV sum. Tensor-core (wgmma) attention and split-KV decode are later
// work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int AT_WARPS = 8;
constexpr int KT = 64;  // keys per shared tile
constexpr float NEG = -1e30f;

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// k_new/v_new [B, T, H, D] bf16 -> cache layer [B, H, S, D] rows n_past[b] + t
__global__ void kv_write_kernel(const __nv_bfloat16* __restrict__ knew,
                                const __nv_bfloat16* __restrict__ vnew,
                                __nv_bfloat16* __restrict__ kc, __nv_bfloat16* __restrict__ vc,
                                const int* __restrict__ npast_vec, int npast_scalar,
                                int B, int T, int H, int S, int D) {
  const int chunks = D / 8;
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t total = (size_t)B * T * H * chunks;
  if (idx >= total) return;
  const int c = (int)(idx % chunks);
  size_t r = idx / chunks;
  const int h = (int)(r % H);
  r /= H;
  const int t = (int)(r % T);
  const int b = (int)(r / T);
  const int row = (npast_vec ? npast_vec[b] : npast_scalar) + t;
  if (row < 0 || row >= S) return;
  const size_t src = (((size_t)b * T + t) * H + h) * D + c * 8;
  const size_t dst = (((size_t)b * H + h) * S + row) * D + c * 8;
  *reinterpret_cast<uint4*>(kc + dst) = *reinterpret_cast<const uint4*>(knew + src);
  *reinterpret_cast<uint4*>(vc + dst) = *reinterpret_cast<const uint4*>(vnew + src);
}

template <int D>
__device__ __forceinline__ void load_tile(__nv_bfloat16* tile, const __nv_bfloat16* base,
                                          int j0, int nk) {
  constexpr int KSTR = D + 2;
  constexpr int CH = D / 8;
  for (int e = threadIdx.x; e < nk * CH; e += blockDim.x) {
    const int key = e / CH, c = (e - key * CH) * 8;
    const uint4 v = *reinterpret_cast<const uint4*>(base + (size_t)(j0 + key) * D + c);
    uint32_t* dst = reinterpret_cast<uint32_t*>(tile + key * KSTR + c);
    dst[0] = v.x;
    dst[1] = v.y;
    dst[2] = v.z;
    dst[3] = v.w;
  }
}

template <int D>
__global__ void __launch_bounds__(AT_WARPS * 32)
attn_kernel(const __nv_bfloat16* __restrict__ q,   // [B, T, H, D]
            const __nv_bfloat16* __restrict__ kc,  // cache layer [B, H, S, D]
            const __nv_bfloat16* __restrict__ vc,
            float* __restrict__ out,               // [B, T, H, D]
            const int* __restrict__ npast_vec, int npast_scalar,
            int T, int H, int S, int block_k, float scale) {
  constexpr int DPL = D / 32;  // output dims per lane
  constexpr int KSTR = D + 2;  // odd word stride: lane j reading key j is conflict-free
  __shared__ __align__(16) __nv_bfloat16 tile[KT * KSTR];
  __shared__ float q_s[AT_WARPS][D];
  extern __shared__ float sc_all[];  // [AT_WARPS][block_k] scores, then bf16(p)

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int h = blockIdx.y, b = blockIdx.z;
  const int t0 = blockIdx.x * AT_WARPS;
  const int t = t0 + warp;
  const bool active = t < T;
  const int np = npast_vec ? npast_vec[b] : npast_scalar;
  const int row_pos = np + t;
  const int t_last = min(T, t0 + AT_WARPS) - 1;
  const int limit = min(np + t_last + 1, S);  // columns any row of the block sees
  float* sc = sc_all + warp * block_k;

  if (active)
    for (int d = lane; d < D; d += 32)
      q_s[warp][d] = bf16_round(
          __bfloat162float(q[(((size_t)b * T + t) * H + h) * D + d]) * scale);

  const __nv_bfloat16* kbase = kc + ((size_t)b * H + h) * S * D;
  const __nv_bfloat16* vbase = vc + ((size_t)b * H + h) * S * D;
  float m = NEG, l = 0.f;
  float acc[DPL];
#pragma unroll
  for (int e = 0; e < DPL; ++e) acc[e] = 0.f;

  const int nblocks = (limit + block_k - 1) / block_k;
  for (int i = 0; i < nblocks; ++i) {
    const int kb0 = i * block_k;
    const int kb1 = min(kb0 + block_k, limit);
    // scores of this KV block
    for (int j0 = kb0; j0 < kb1; j0 += KT) {
      const int nk = min(KT, kb1 - j0);
      __syncthreads();
      load_tile<D>(tile, kbase, j0, nk);
      __syncthreads();
      if (active) {
        for (int kk = lane; kk < nk; kk += 32) {
          const __nv_bfloat162* kr = reinterpret_cast<const __nv_bfloat162*>(tile + kk * KSTR);
          float s = 0.f;
#pragma unroll 16
          for (int d2 = 0; d2 < D / 2; ++d2) {
            const float2 kf = __bfloat1622float2(kr[d2]);
            s = fmaf(q_s[warp][2 * d2], kf.x, s);
            s = fmaf(q_s[warp][2 * d2 + 1], kf.y, s);
          }
          const int col = j0 + kk;
          sc[col - kb0] = col <= row_pos ? s : NEG;
        }
      }
    }
    // online softmax update over the whole block
    if (active) {
      __syncwarp();
      const int nkb = kb1 - kb0;
      float bm = NEG;
      for (int j = lane; j < nkb; j += 32) bm = fmaxf(bm, sc[j]);
      const float m_new = fmaxf(m, warp_max(bm));
      const float alpha = expf(m - m_new);
      float ps = 0.f;
      for (int j = lane; j < nkb; j += 32) {
        const float p = expf(sc[j] - m_new);
        ps += p;
        sc[j] = bf16_round(p);
      }
      l = l * alpha + warp_sum(ps);
#pragma unroll
      for (int e = 0; e < DPL; ++e) acc[e] *= alpha;
      m = m_new;
      __syncwarp();
    }
    // PV over the block
    for (int j0 = kb0; j0 < kb1; j0 += KT) {
      const int nk = min(KT, kb1 - j0);
      __syncthreads();
      load_tile<D>(tile, vbase, j0, nk);
      __syncthreads();
      if (active) {
        const float* pj = sc + (j0 - kb0);
        for (int kk = 0; kk < nk; ++kk) {
          const float p = pj[kk];
          const __nv_bfloat162* vr =
              reinterpret_cast<const __nv_bfloat162*>(tile + kk * KSTR + lane * DPL);
#pragma unroll
          for (int e2 = 0; e2 < DPL / 2; ++e2) {
            const float2 vf = __bfloat1622float2(vr[e2]);
            acc[2 * e2] = fmaf(p, vf.x, acc[2 * e2]);
            acc[2 * e2 + 1] = fmaf(p, vf.y, acc[2 * e2 + 1]);
          }
        }
      }
    }
  }

  if (active) {
    float* o = out + (((size_t)b * T + t) * H + h) * D + lane * DPL;
#pragma unroll
    for (int e = 0; e < DPL; ++e) o[e] = acc[e] / l;
  }
}

template <int D>
cudaError_t launch_attn(const __nv_bfloat16* q, const __nv_bfloat16* kc,
                        const __nv_bfloat16* vc, float* out, const int* npast_vec,
                        int npast_scalar, int B, int T, int H, int S, int block_k,
                        float scale, cudaStream_t stream) {
  const size_t dyn = (size_t)AT_WARPS * block_k * sizeof(float);
  static size_t dyn_set = 0;
  if (dyn > 48 * 1024 - (KT * (D + 2) * 2 + AT_WARPS * D * 4) && dyn > dyn_set) {
    cudaError_t e = cudaFuncSetAttribute(attn_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dyn);
    if (e != cudaSuccess) return e;
    dyn_set = dyn;
  }
  dim3 grid((T + AT_WARPS - 1) / AT_WARPS, H, B);
  attn_kernel<D><<<grid, AT_WARPS * 32, dyn, stream>>>(q, kc, vc, out, npast_vec, npast_scalar,
                                                       T, H, S, block_k, scale);
  return cudaGetLastError();
}

cudaError_t attend(const void* q, const void* kc, const void* vc, void* out,
                   const int* npast_vec, int npast_scalar, int B, int T, int H, int S,
                   int D, int block_k, float scale, cudaStream_t st) {
  auto qq = static_cast<const __nv_bfloat16*>(q);
  auto kk = static_cast<const __nv_bfloat16*>(kc);
  auto vv = static_cast<const __nv_bfloat16*>(vc);
  auto oo = static_cast<float*>(out);
  if (D == 128)
    return launch_attn<128>(qq, kk, vv, oo, npast_vec, npast_scalar, B, T, H, S, block_k, scale, st);
  if (D == 64)
    return launch_attn<64>(qq, kk, vv, oo, npast_vec, npast_scalar, B, T, H, S, block_k, scale, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// Read path (K3). q bf16 [B, T, H, D]; k_cache/v_cache: one layer [B, H, S, D]
// bf16; out f32 [B, T, H, D]; n_past from npast_vec[B] (device) when it is not
// null, else npast_scalar. D in {64, 128}.
extern "C" int attn_read_launch(const void* q, const void* k_cache, const void* v_cache,
                                void* out, const void* npast_vec, int npast_scalar, int B,
                                int T, int H, int S, int D, int block_k, float scale,
                                void* stream) {
  if (block_k < 1 || S % block_k != 0) return (int)cudaErrorInvalidValue;
  return (int)attend(q, k_cache, v_cache, out, static_cast<const int*>(npast_vec),
                     npast_scalar, B, T, H, S, D, block_k, scale,
                     static_cast<cudaStream_t>(stream));
}

// Update path (K2): write k_new/v_new [B, T, H, D] bf16 into rows
// [n_past, n_past + T) of the cache layer, then attend (two launches).
extern "C" int attn_update_launch(const void* q, const void* k_new, const void* v_new,
                                  void* k_cache, void* v_cache, void* out,
                                  const void* npast_vec, int npast_scalar, int B, int T,
                                  int H, int S, int D, int block_k, float scale,
                                  void* stream) {
  if (block_k < 1 || S % block_k != 0 || D % 8 != 0) return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  auto npv = static_cast<const int*>(npast_vec);
  const size_t total = (size_t)B * T * H * (D / 8);
  kv_write_kernel<<<(unsigned)((total + 255) / 256), 256, 0, st>>>(
      static_cast<const __nv_bfloat16*>(k_new), static_cast<const __nv_bfloat16*>(v_new),
      static_cast<__nv_bfloat16*>(k_cache), static_cast<__nv_bfloat16*>(v_cache), npv,
      npast_scalar, B, T, H, S, D);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return (int)attend(q, k_cache, v_cache, out, npv, npast_scalar, B, T, H, S, D, block_k,
                     scale, st);
}
