// Fused Q4 dequantize + matmul for Hopper (sm_90a): y[m, n] = sum_k x[m, k] W[k, n].
//
// Replaces the TPU kernel `_kernel_q4` (llamavk_tpu/ops/q4_matmul.py:96, its
// ilv shift branch at :176-189 and its lin branch at :190-199) and its
// stacked twin `_kernel_q4_stacked`. A stacked layer arrives as a pointer
// offset into the [L, K/2, N] plane: no layer is ever copied.
//
// Weight layouts (one chunk), G = K/32 quantization groups:
//  * ilv: packed byte row p = m*G + g (m in 0..15) holds two signed nibbles:
//    the low one is the weight of original k = g*32 + m, the high one of
//    k = g*32 + m + 16; both scale by scales[g, n].
//  * lin: byte row r (0 <= r < K/2) holds k = r in its low nibble, scaled by
//    scales[r/32, n], and k = K/2 + r in its high nibble, scaled by
//    scales[G/2 + r/32, n] (formats/repack.py). K % 64 == 0.
// x is read at the original k in both, so no activation reorder is needed.
//
// Numerics (q4_matmul.py:114-121 there): x is bf16, products accumulate in
// f32, out is f32. The scale plane is bf16, or f32 (`perplexity --f32` loads
// it so): the kernels take the scale type as a template argument (`ST`).
// The weight w = q * s is formed in f32 and, by mode:
//  * default (LLAMAVK_Q4_DOT=bf16): rounded to bf16 for the dot;
//  * LLAMAVK_Q4_MUL=bf16 (`RS`): the scale is rounded to bf16 first, then w
//    to bf16 as above; with a bf16 scale plane this is the default kernel;
//  * LLAMAVK_Q4_DOT=f32 (`WF32`): w stays f32. The GEMV multiplies it as it
//    is. The GEMM splits it into bf16 parts, w = w0 + w1 (+ w2), and runs
//    one bf16 tensor-core pass per part into the same f32 accumulators:
//    each x * part product is exact in f32. q has <= 4 significant bits and
//    a bf16 scale 8, so two parts hold w exactly; an f32 scale's 24 bits
//    take a third part, which leaves at most 2^-27 |w| out.
//
// What bounds it on an H100:
//  * decode (M = 1): weight bytes. 7B decode reads ~3.7 GB of packed
//    nibbles + scales per token against 3.35 TB/s. Design: neighbouring
//    threads own neighbouring 4-column words of a packed row, so a warp reads
//    128 contiguous bytes; each thread issues its 16 row loads of a group
//    (lin: of half a 32-row unit) before using any; warps split the groups
//    (lin: the 32-row units) of the block's K range; x is staged once per
//    block in shared memory; K is also split across blocks (enough blocks to
//    fill 132 SMs) and the partial sums are added by a second,
//    deterministic pass in a fixed order (split_sum.cuh).
//  * M > 1: q4_gemm.cuh (the weight bytes at M <= 64, the tensor-core
//    operations above; `mma.sync` with the weights dequantized straight
//    into A fragments, a `cp.async` ring, split-K at M <= 64).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "q4_gemm.cuh"
#include "split_sum.cuh"

namespace {

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

__device__ __forceinline__ float bf16_bits_to_float(uint32_t bits16) {
  return __uint_as_float(bits16 << 16);
}

// the scales of 4 consecutive columns from `p` (16-byte aligned for f32)
__device__ __forceinline__ void load_scales4(const __nv_bfloat16* p, float* s) {
  const uint2 bits = __ldg(reinterpret_cast<const uint2*>(p));
  s[0] = bf16_bits_to_float(bits.x & 0xffffu);
  s[1] = bf16_bits_to_float(bits.x >> 16);
  s[2] = bf16_bits_to_float(bits.y & 0xffffu);
  s[3] = bf16_bits_to_float(bits.y >> 16);
}

__device__ __forceinline__ void load_scales4(const float* p, float* s) {
  const float4 v = __ldg(reinterpret_cast<const float4*>(p));
  s[0] = v.x;
  s[1] = v.y;
  s[2] = v.z;
  s[3] = v.w;
}

// the 4 scales of a GEMV thread, rounded to bf16 under LLAMAVK_Q4_MUL=bf16
template <typename ST, bool RS>
__device__ __forceinline__ void scales4(const ST* p, float* s) {
  load_scales4(p, s);
  if (RS) {
#pragma unroll
    for (int c = 0; c < 4; ++c) s[c] = bf16_round(s[c]);
  }
}

// the weight a nibble q contributes: bf16(q * s), or q * s under the f32 dot
template <bool WF32>
__device__ __forceinline__ float weight(int q, float s) {
  if (WF32) return __fmul_rn((float)q, s);
  return bf16_round((float)q * s);
}

__device__ __forceinline__ int nib_lo(int b) { return (int)(int8_t)(b << 4) >> 4; }
__device__ __forceinline__ int nib_hi(int b) { return b >> 4; }

// ---------------------------------------------------------------- decode GEMV
constexpr int GV_WARPS = 8;
constexpr int GV_COLS = 128;  // 32 lanes x 4 columns
constexpr int GV_SMEM = 40960;

// One K-split unit is a group (ilv: 16 packed rows, 32 x values) or a 32-row
// lin unit (32 packed rows; 32 x values from each half of K).
template <typename ST, bool LIN, bool RS, bool WF32>
__global__ void __launch_bounds__(GV_WARPS * 32)
q4_gemv_kernel(const __nv_bfloat16* __restrict__ x,   // [K]
               const int8_t* __restrict__ packed,     // [K/2, N]
               const ST* __restrict__ scales,         // [G, N] bf16 or f32
               float* __restrict__ out,               // [gridDim.y, N]
               int K, int N, int gps) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  float* red = reinterpret_cast<float*>(smem_raw);  // [GV_WARPS][GV_COLS], after x

  const int G = K / 32;
  const int U = LIN ? G / 2 : G;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int u_begin = blockIdx.y * gps;
  const int u_end = min(U, u_begin + gps);
  const int kw = (u_end - u_begin) * 32;  // x values of this block (lin: per half)
  const int n0 = blockIdx.x * GV_COLS + lane * 4;
  const bool col_ok = n0 < N;

  // stage x[u_begin*32 : u_end*32] (lin: and the same range of the second
  // half of K after it) in shared memory
  for (int i = threadIdx.x; i < kw; i += blockDim.x) xs[i] = x[u_begin * 32 + i];
  if (LIN)
    for (int i = threadIdx.x; i < kw; i += blockDim.x) xs[kw + i] = x[K / 2 + u_begin * 32 + i];
  __syncthreads();

  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  if (col_ok) {
    for (int u = u_begin + warp; u < u_end; u += GV_WARPS) {
      if (!LIN) {
        uint32_t words[16];
#pragma unroll
        for (int m = 0; m < 16; ++m)
          words[m] = __ldg(reinterpret_cast<const uint32_t*>(
              packed + (size_t)(m * G + u) * N + n0));
        float s[4];
        scales4<ST, RS>(scales + (size_t)u * N + n0, s);
        const __nv_bfloat16* xg = xs + (u - u_begin) * 32;
#pragma unroll
        for (int m = 0; m < 16; ++m) {
          const float xlo = __bfloat162float(xg[m]);
          const float xhi = __bfloat162float(xg[m + 16]);
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int b = (int)(int8_t)((words[m] >> (8 * c)) & 0xffu);
            acc[c] = fmaf(xlo, weight<WF32>(nib_lo(b), s[c]), acc[c]);
            acc[c] = fmaf(xhi, weight<WF32>(nib_hi(b), s[c]), acc[c]);
          }
        }
      } else {
        float s_lo[4], s_hi[4];
        scales4<ST, RS>(scales + (size_t)u * N + n0, s_lo);
        scales4<ST, RS>(scales + (size_t)(G / 2 + u) * N + n0, s_hi);
        const __nv_bfloat16* xl = xs + (u - u_begin) * 32;
        const __nv_bfloat16* xh = xl + kw;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          uint32_t words[16];
#pragma unroll
          for (int m = 0; m < 16; ++m)
            words[m] = __ldg(reinterpret_cast<const uint32_t*>(
                packed + (size_t)(u * 32 + h * 16 + m) * N + n0));
#pragma unroll
          for (int m = 0; m < 16; ++m) {
            const float xlo = __bfloat162float(xl[h * 16 + m]);
            const float xhi = __bfloat162float(xh[h * 16 + m]);
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              const int b = (int)(int8_t)((words[m] >> (8 * c)) & 0xffu);
              acc[c] = fmaf(xlo, weight<WF32>(nib_lo(b), s_lo[c]), acc[c]);
              acc[c] = fmaf(xhi, weight<WF32>(nib_hi(b), s_hi[c]), acc[c]);
            }
          }
        }
      }
    }
  }

  __syncthreads();  // x stage is dead: reuse it for the cross-warp reduction
#pragma unroll
  for (int c = 0; c < 4; ++c) red[warp * GV_COLS + lane * 4 + c] = acc[c];
  __syncthreads();
  for (int col = threadIdx.x; col < GV_COLS; col += blockDim.x) {
    const int n = blockIdx.x * GV_COLS + col;
    if (n >= N) continue;
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < GV_WARPS; ++w) sum += red[w * GV_COLS + col];
    out[(size_t)blockIdx.y * N + n] = sum;
  }
}

template <typename ST, bool LIN, bool RS, bool WF32>
cudaError_t launch_gemv(const __nv_bfloat16* x, const int8_t* packed,
                        const ST* scales, float* out, float* partial,
                        int K, int N, int ksplit, cudaStream_t stream) {
  const int U = LIN ? K / 64 : K / 32;
  const int gps = (U + ksplit - 1) / ksplit;
  const int splits = (U + gps - 1) / gps;
  const size_t smem_x = (size_t)gps * (LIN ? 64 : 32) * sizeof(__nv_bfloat16);
  const size_t smem_red = (size_t)GV_WARPS * GV_COLS * sizeof(float);
  const size_t smem = smem_x > smem_red ? smem_x : smem_red;
  if (smem > GV_SMEM) return cudaErrorInvalidValue;
  dim3 grid((N + GV_COLS - 1) / GV_COLS, splits);
  float* dst = splits == 1 ? out : partial;
  q4_gemv_kernel<ST, LIN, RS, WF32><<<grid, GV_WARPS * 32, smem, stream>>>(
      x, packed, scales, dst, K, N, gps);
  if (splits > 1) launch_split_sum<float, float>(partial, out, splits, N, stream);
  return cudaGetLastError();
}

template <typename ST, bool LIN, bool RS, bool WF32>
cudaError_t launch(const __nv_bfloat16* x, const int8_t* packed, const ST* scales, float* out,
                   float* partial, int M, int K, int N, int ksplit, cudaStream_t st) {
  if (M == 1) return launch_gemv<ST, LIN, RS, WF32>(x, packed, scales, out, partial, K, N,
                                                   ksplit, st);
  // the f32 dot's bf16 parts: two hold q * s exactly for a bf16 scale, three
  // for an f32 one
  constexpr int NP = WF32 ? (sizeof(ST) == 4 ? 3 : 2) : 1;
  return q4gemm::launch_gemm<ST, LIN, RS, NP>(x, packed, scales, out, partial, M, K, N, ksplit,
                                               st);
}

template <typename ST, bool LIN>
cudaError_t launch_mode(const __nv_bfloat16* x, const int8_t* packed, const void* scales,
                        float* out, float* partial, int M, int K, int N, int ksplit, bool rs,
                        bool wf32, cudaStream_t st) {
  auto s = static_cast<const ST*>(scales);
  if (wf32) return launch<ST, LIN, false, true>(x, packed, s, out, partial, M, K, N, ksplit, st);
  if constexpr (sizeof(ST) == 4) {  // a bf16 scale is already on the bf16 grid
    if (rs) return launch<ST, LIN, true, false>(x, packed, s, out, partial, M, K, N, ksplit, st);
  }
  return launch<ST, LIN, false, false>(x, packed, s, out, partial, M, K, N, ksplit, st);
}

}  // namespace

// Mode bits of q4_matmul_launch.
enum { Q4_SCALE_F32 = 1, Q4_LIN = 2, Q4_ROUND_SCALE = 4, Q4_W_F32 = 8 };

// x bf16 [M, K], packed int8 [K/2, N] (one chunk; ilv, or lin with
// Q4_LIN), scales [G, N] (bf16, or f32 with Q4_SCALE_F32), out f32 [M, N];
// partial f32 [ksplit, N] scratch for the decode split (M = 1).
// partial f32 [ksplit, M, N] scratch for the GEMM's split (M > 1).
// Q4_ROUND_SCALE rounds an f32 scale to bf16 (LLAMAVK_Q4_MUL=bf16);
// Q4_W_F32 keeps w = q * s in f32 (LLAMAVK_Q4_DOT=f32); not both.
// Requires K % 32 == 0 (lin: K % 64 == 0), N % 8 == 0 and 16-byte aligned
// pointers (checked by the Python wrapper). Returns cudaGetLastError()
// after the launches.
extern "C" int q4_matmul_launch(const void* x, const void* packed, const void* scales,
                                void* out, void* partial, int M, int K, int N,
                                int ksplit, int mode, void* stream) {
  auto xs = static_cast<const __nv_bfloat16*>(x);
  auto pk = static_cast<const int8_t*>(packed);
  auto o = static_cast<float*>(out);
  auto part = static_cast<float*>(partial);
  auto st = static_cast<cudaStream_t>(stream);
  const bool f32s = mode & Q4_SCALE_F32, lin = mode & Q4_LIN;
  const bool rs = mode & Q4_ROUND_SCALE, wf32 = mode & Q4_W_F32;
  if (K % 32 != 0 || N % 8 != 0 || M < 1 || ksplit < 1 || (lin && K % 64 != 0) ||
      (rs && wf32) || (mode & ~15))
    return (int)cudaErrorInvalidValue;
  if (f32s)
    return (int)(lin ? launch_mode<float, true>(xs, pk, scales, o, part, M, K, N, ksplit, rs,
                                                wf32, st)
                     : launch_mode<float, false>(xs, pk, scales, o, part, M, K, N, ksplit, rs,
                                                 wf32, st));
  return (int)(lin ? launch_mode<__nv_bfloat16, true>(xs, pk, scales, o, part, M, K, N, ksplit,
                                                      rs, wf32, st)
                   : launch_mode<__nv_bfloat16, false>(xs, pk, scales, o, part, M, K, N, ksplit,
                                                       rs, wf32, st));
}
