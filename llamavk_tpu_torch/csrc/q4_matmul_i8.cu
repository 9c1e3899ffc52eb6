// Q4_0 matmul with int8 activations for Hopper (sm_90a):
//   y[m, n] = sum_g (float(d[g, m, n]) * sx[m, g]) * s[g, n],
//   d[g, m, n] = sum_{i<32} xq[m, 32g + i] * w[32g + i, n]   (exact, int32).
//
// Replaces the TPU kernel `_kernel_q4_i8` (llamavk_tpu/ops/q4_matmul.py:226)
// and its stacked twin `_kernel_q4_i8_stacked` (:264), which the JAX package
// takes under LLAMAVK_Q4_DOT=i8 for decode-shaped batches (M <= 64). A
// stacked layer arrives as a pointer offset into the [L, K/2, N] plane.
//
// Two launches:
//  * `quantize_kernel`: one warp per (row, 32-block): amax by warp
//    reduction, sx = amax * f32(1/127) (1 for an all-zero block: the JAX
//    package's `amax / 127.0`, which XLA compiles as a multiplication by the
//    reciprocal), q = round-half-even(x / sx) (a true division) clipped to
//    +-127. xq [M, K] int8 in original k order, sx [M, G] f32.
//  * `i8_dot_kernel`: the group dot. Weight layout (ilv, one chunk): packed
//    byte row j*G + g (j < 16) holds the low nibble of original k = 32g + j
//    and the high nibble of k = 32g + 16 + j, both signed, both scaled by
//    s[g, n] (bf16, or f32 as `perplexity --f32` loads the scale plane: the
//    scale type is the template argument `ST`, and only the scale loads
//    differ, as `_kernel_q4_i8` reads s in its own type). Each thread owns
//    4 neighbouring columns (a warp reads 128 contiguous bytes of a packed
//    row), loads a group's 16 packed words
//    and its 4 scales, transposes the bytes with __byte_perm and
//    sign-extends the nibbles 4 at a time, so that each column holds its 32
//    weights as 8 int8x4 words; then for each of the block's (up to) 8 rows
//    d comes from 8 `dp4a` against the row's 32 int8 activations, read from
//    global memory as 2 16-byte loads (the same address for the whole warp).
//
// Float order: each output sums its groups in a fixed order whatever M is:
// warp w of a block sums the groups g0 + w, g0 + w + 8, ... of its K slice
// in that order, the block adds the 8 warps' sums in warp order, and the
// K slices (a split chosen from K and N alone) are added by a second
// launch in slice order. The multiplies and adds are __fmul_rn/__fadd_rn,
// so nothing is contracted into an FMA. A row of y is therefore bit-equal
// whether it is computed alone (M = 1) or among others (M = 4, 32).
//
// What bounds it on an H100: at M = 1-8 the weight bytes (K/2 * N packed +
// 2 * G * N scale bytes per call, 3.35 TB/s); int8 operations (2 M K N at
// 1,979 TOP/s) never come near. This first design runs on the CUDA cores
// (dp4a) and reads the weights once per block of 8 rows, so M = 32 reads
// them four times (from L2 where they stay); int8 tensor cores (mma.sync /
// wgmma) are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int QK = 32;
constexpr int WARPS = 8;   // K lanes of a block: warp w takes groups g0 + w + 8i
constexpr int COLS = 128;  // columns of a block: 32 lanes x 4
constexpr int ROWS = 8;    // rows of a block (gridDim.z covers M)

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// x bf16 [M, K] -> xq int8 [M, K], sx f32 [M, G]; one warp per 32-block
__global__ void quantize_kernel(const __nv_bfloat16* __restrict__ x, int8_t* __restrict__ xq,
                                float* __restrict__ sx, int blocks) {
  const int blk = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (blk >= blocks) return;
  const int lane = threadIdx.x & 31;
  const float v = __bfloat162float(x[(size_t)blk * QK + lane]);
  const float amax = warp_max(fabsf(v));
  const float s = amax > 0.f ? __fmul_rn(amax, 1.0f / 127.0f) : 1.0f;
  float q = rintf(__fdiv_rn(v, s));  // round half to even
  q = fminf(fmaxf(q, -127.f), 127.f);
  xq[(size_t)blk * QK + lane] = (int8_t)(int)q;
  if (lane == 0) sx[blk] = s;
}

// signed nibbles of 4 bytes (low or high halves) as 4 int8 lanes
__device__ __forceinline__ int nib_lo(uint32_t w) {
  return (int)__vsub4((w & 0x0F0F0F0Fu) ^ 0x08080808u, 0x08080808u);
}
__device__ __forceinline__ int nib_hi(uint32_t w) {
  return (int)__vsub4(((w >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u, 0x08080808u);
}

// the scales of 4 consecutive columns from `p` (16-byte aligned for f32)
__device__ __forceinline__ void load_scales4(const __nv_bfloat16* p, float* s) {
  const uint2 sb = __ldg(reinterpret_cast<const uint2*>(p));
  s[0] = __uint_as_float(sb.x << 16);
  s[1] = __uint_as_float(sb.x & 0xffff0000u);
  s[2] = __uint_as_float(sb.y << 16);
  s[3] = __uint_as_float(sb.y & 0xffff0000u);
}

__device__ __forceinline__ void load_scales4(const float* p, float* s) {
  const float4 v = __ldg(reinterpret_cast<const float4*>(p));
  s[0] = v.x;
  s[1] = v.y;
  s[2] = v.z;
  s[3] = v.w;
}

template <typename ST>
__global__ void __launch_bounds__(WARPS * 32)
i8_dot_kernel(const int8_t* __restrict__ xq,        // [M, K]
              const float* __restrict__ sx,         // [M, G]
              const int8_t* __restrict__ packed,    // [K/2, N]
              const ST* __restrict__ scales,        // [G, N] bf16 or f32
              float* __restrict__ out,              // [gridDim.y, M, N]
              int M, int K, int N, int gps) {
  __shared__ float red[WARPS][ROWS][COLS];
  const int G = K / QK;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g_begin = blockIdx.y * gps;
  const int g_end = min(G, g_begin + gps);
  const int m0 = blockIdx.z * ROWS;
  const int rows = min(ROWS, M - m0);
  const int n0 = blockIdx.x * COLS + lane * 4;
  const bool col_ok = n0 < N;

  float acc[ROWS][4];
#pragma unroll
  for (int r = 0; r < ROWS; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;

  if (col_ok) {
    for (int g = g_begin + warp; g < g_end; g += WARPS) {
      uint32_t words[16];
#pragma unroll
      for (int j = 0; j < 16; ++j)
        words[j] = __ldg(reinterpret_cast<const uint32_t*>(packed + (size_t)(j * G + g) * N + n0));
      float s[4];
      load_scales4(scales + (size_t)g * N + n0, s);
      // w[c][i]: elements 4i..4i+3 (i < 4, low nibbles of rows 4i..4i+3) and
      // 16 + 4(i-4).. (i >= 4, the high nibbles of the same rows) of column c
      int w[4][8];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const uint32_t a = words[4 * i], b = words[4 * i + 1];
        const uint32_t c2 = words[4 * i + 2], d = words[4 * i + 3];
        const uint32_t ab_lo = __byte_perm(a, b, 0x5140), ab_hi = __byte_perm(a, b, 0x7362);
        const uint32_t cd_lo = __byte_perm(c2, d, 0x5140), cd_hi = __byte_perm(c2, d, 0x7362);
        const uint32_t col[4] = {__byte_perm(ab_lo, cd_lo, 0x5410), __byte_perm(ab_lo, cd_lo, 0x7632),
                                 __byte_perm(ab_hi, cd_hi, 0x5410), __byte_perm(ab_hi, cd_hi, 0x7632)};
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          w[c][i] = nib_lo(col[c]);
          w[c][4 + i] = nib_hi(col[c]);
        }
      }
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        if (r < rows) {
          const size_t row = (size_t)(m0 + r);
          const int4* xr = reinterpret_cast<const int4*>(xq + row * K + (size_t)g * QK);
          const int4 x0 = __ldg(xr), x1 = __ldg(xr + 1);
          const int xv[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
          const float sxr = __ldg(sx + row * G + g);
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            int dsum = 0;
#pragma unroll
            for (int i = 0; i < 8; ++i) dsum = __dp4a(xv[i], w[c][i], dsum);
            acc[r][c] = __fadd_rn(acc[r][c], __fmul_rn(__fmul_rn((float)dsum, sxr), s[c]));
          }
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < ROWS; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) red[warp][r][lane * 4 + c] = acc[r][c];
  __syncthreads();
  for (int e = threadIdx.x; e < ROWS * COLS; e += blockDim.x) {
    const int r = e / COLS, col = e % COLS;
    const int n = blockIdx.x * COLS + col;
    if (r >= rows || n >= N) continue;
    float sum = 0.f;
#pragma unroll
    for (int wi = 0; wi < WARPS; ++wi) sum = __fadd_rn(sum, red[wi][r][col]);
    out[((size_t)blockIdx.y * M + m0 + r) * N + n] = sum;
  }
}

// partial [splits, M*N] -> out [M*N], summed in split order
__global__ void split_sum_kernel(const float* __restrict__ partial, float* __restrict__ out,
                                 int splits, int mn) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= mn) return;
  float sum = 0.f;
  for (int s = 0; s < splits; ++s) sum = __fadd_rn(sum, partial[(size_t)s * mn + i]);
  out[i] = sum;
}

}  // namespace

// x bf16 [M, K] -> xq int8 [M, K], sx f32 [M, K/32]. Returns cudaGetLastError().
extern "C" int q4_i8_quantize_launch(const void* x, void* xq, void* sx, int M, int K,
                                     void* stream) {
  if (M < 1 || K % QK != 0) return (int)cudaErrorInvalidValue;
  const int blocks = M * (K / QK);
  quantize_kernel<<<(blocks + 7) / 8, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<int8_t*>(xq), static_cast<float*>(sx),
      blocks);
  return (int)cudaGetLastError();
}

// xq int8 [M, K], sx f32 [M, G] (from q4_i8_quantize_launch), packed int8
// [K/2, N] (ilv, one chunk, Q4_0), scales [G, N] (bf16, or f32 when
// scale_f32 != 0) -> out f32 [M, N];
// partial f32 [ksplit, M, N] scratch when ksplit > 1. Requires K % 32 == 0,
// N % 8 == 0, 16-byte aligned pointers (checked by the Python wrapper).
extern "C" int q4_i8_matmul_launch(const void* xq, const void* sx, const void* packed,
                                   const void* scales, void* out, void* partial, int M, int K,
                                   int N, int ksplit, int scale_f32, void* stream) {
  if (M < 1 || K % QK != 0 || N % 8 != 0 || ksplit < 1) return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  const int G = K / QK;
  const int gps = (G + ksplit - 1) / ksplit;
  const int splits = (G + gps - 1) / gps;
  float* dst = splits == 1 ? static_cast<float*>(out) : static_cast<float*>(partial);
  dim3 grid((N + COLS - 1) / COLS, splits, (M + ROWS - 1) / ROWS);
  auto xqp = static_cast<const int8_t*>(xq);
  auto sxp = static_cast<const float*>(sx);
  auto pk = static_cast<const int8_t*>(packed);
  if (scale_f32)
    i8_dot_kernel<float><<<grid, WARPS * 32, 0, st>>>(
        xqp, sxp, pk, static_cast<const float*>(scales), dst, M, K, N, gps);
  else
    i8_dot_kernel<__nv_bfloat16><<<grid, WARPS * 32, 0, st>>>(
        xqp, sxp, pk, static_cast<const __nv_bfloat16*>(scales), dst, M, K, N, gps);
  if (splits > 1) {
    const int mn = M * N;
    split_sum_kernel<<<(mn + 255) / 256, 256, 0, st>>>(static_cast<const float*>(partial),
                                                       static_cast<float*>(out), splits, mn);
  }
  return (int)cudaGetLastError();
}
