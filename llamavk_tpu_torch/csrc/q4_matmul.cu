// Fused Q4 dequantize + matmul for Hopper (sm_90a): y[m, n] = sum_k x[m, k] W[k, n].
//
// Replaces the TPU kernel `_kernel_q4` (llamavk_tpu/ops/q4_matmul.py:96, its
// ilv shift branch at :176-189) and its stacked twin `_kernel_q4_stacked`.
// A stacked layer arrives as a pointer offset into the [L, K/2, N] plane: no
// layer is ever copied.
//
// Weight layout (ilv, one chunk): G = K/32 quantization groups. Packed byte
// row p = m*G + g (m in 0..15) holds two signed nibbles: the low one is the
// weight of original k = g*32 + m, the high one of k = g*32 + m + 16; both
// scale by scales[g, n]. x is read at the original k, so no activation
// reorder is needed.
//
// Numerics (the JAX package's defaults, q4_matmul.py:117-121): x is bf16,
// w = bf16(float(q) * float(scale)), products accumulate in f32, out is f32.
// The scale plane is bf16, or f32 (`perplexity --f32` loads it so,
// q4_matmul.py:120 there reads it as it is): the kernels take the scale
// type as a template argument (`ST`), and only the scale loads differ.
//
// What bounds it on an H100:
//  * decode (M = 1): weight bytes. 7B decode reads ~3.7 GB of packed
//    nibbles + scales per token against 3.35 TB/s. Design: neighbouring
//    threads own neighbouring 4-column words of a packed row, so a warp reads
//    128 contiguous bytes; each thread issues its 16 row loads of a group
//    before using any; warps split the groups of the block's K range; x is
//    staged once per block in shared memory; K is also split across blocks
//    (enough blocks to fill 132 SMs) and the partial sums are added by a
//    second, deterministic pass in a fixed order.
//  * prefill (M > 1): tensor-core operations (989 TFLOP/s bf16 dense).
//    Design: 64x128 output tiles, 64-deep k steps (two quantization groups);
//    the next step's global loads are in registers while the tensor cores
//    (WMMA bf16 16x16x16, f32 accumulate) work on the current shared tiles;
//    the weight tile is dequantized to bf16 on its way into shared memory.
//    wgmma/TMA are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

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

// ---------------------------------------------------------------- decode GEMV
constexpr int GV_WARPS = 8;
constexpr int GV_COLS = 128;  // 32 lanes x 4 columns
constexpr int GV_SMEM = 40960;

template <typename ST>
__global__ void __launch_bounds__(GV_WARPS * 32)
q4_gemv_kernel(const __nv_bfloat16* __restrict__ x,   // [K]
               const int8_t* __restrict__ packed,     // [K/2, N]
               const ST* __restrict__ scales,         // [G, N] bf16 or f32
               float* __restrict__ out,               // [gridDim.y, N]
               int K, int N, int gps) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [gps*32]
  float* red = reinterpret_cast<float*>(smem_raw);  // [GV_WARPS][GV_COLS], after x

  const int G = K / 32;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g_begin = blockIdx.y * gps;
  const int g_end = min(G, g_begin + gps);
  const int kw = (g_end - g_begin) * 32;  // k extent of this block
  const int n0 = blockIdx.x * GV_COLS + lane * 4;
  const bool col_ok = n0 < N;

  // stage x[g_begin*32 : g_end*32] in shared memory
  for (int i = threadIdx.x; i < kw; i += blockDim.x) xs[i] = x[g_begin * 32 + i];
  __syncthreads();

  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  if (col_ok) {
    for (int g = g_begin + warp; g < g_end; g += GV_WARPS) {
      uint32_t words[16];
#pragma unroll
      for (int m = 0; m < 16; ++m)
        words[m] = __ldg(reinterpret_cast<const uint32_t*>(
            packed + (size_t)(m * G + g) * N + n0));
      float s[4];
      load_scales4(scales + (size_t)g * N + n0, s);
      const __nv_bfloat16* xg = xs + (g - g_begin) * 32;
#pragma unroll
      for (int m = 0; m < 16; ++m) {
        const float xlo = __bfloat162float(xg[m]);
        const float xhi = __bfloat162float(xg[m + 16]);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int b = (int)(int8_t)((words[m] >> (8 * c)) & 0xffu);
          const float wlo = bf16_round((float)((int8_t)(b << 4) >> 4) * s[c]);
          const float whi = bf16_round((float)(b >> 4) * s[c]);
          acc[c] = fmaf(xlo, wlo, acc[c]);
          acc[c] = fmaf(xhi, whi, acc[c]);
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

// partial [splits, M*N] -> out [M*N], summed in split order (deterministic)
__global__ void splitk_reduce_kernel(const float* __restrict__ partial,
                                     float* __restrict__ out, int splits, int mn) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= mn) return;
  float sum = 0.f;
  for (int s = 0; s < splits; ++s) sum += partial[(size_t)s * mn + i];
  out[i] = sum;
}

template <typename ST>
cudaError_t launch_gemv(const __nv_bfloat16* x, const int8_t* packed,
                        const ST* scales, float* out, float* partial,
                        int K, int N, int ksplit, cudaStream_t stream) {
  const int G = K / 32;
  const int gps = (G + ksplit - 1) / ksplit;
  const int splits = (G + gps - 1) / gps;
  const size_t smem_x = (size_t)gps * 32 * sizeof(__nv_bfloat16);
  const size_t smem_red = (size_t)GV_WARPS * GV_COLS * sizeof(float);
  const size_t smem = smem_x > smem_red ? smem_x : smem_red;
  if (smem > GV_SMEM) return cudaErrorInvalidValue;
  dim3 grid((N + GV_COLS - 1) / GV_COLS, splits);
  float* dst = splits == 1 ? out : partial;
  q4_gemv_kernel<ST><<<grid, GV_WARPS * 32, smem, stream>>>(x, packed, scales, dst, K, N, gps);
  if (splits > 1)
    splitk_reduce_kernel<<<(N + 255) / 256, 256, 0, stream>>>(partial, out, splits, N);
  return cudaGetLastError();
}

// ------------------------------------------------------------- prefill GEMM
constexpr int BM = 64, BN = 128, BKT = 64;  // BKT = two quantization groups
constexpr int XS_LD = BKT + 8;   // bf16 elements, keeps WMMA rows 32-byte aligned
constexpr int WS_LD = BN + 8;

template <typename ST>
struct GemmRegs {
  static constexpr int SW = (int)sizeof(ST) / 2;  // 16-byte words of 8 scales
  uint4 xv[2];      // two 8-element x chunks
  uint2 pk[2];      // two 8-column packed words
  uint4 sc[2][SW];  // their 8 scales
};

// scale j (0..7) of 8 held in 16-byte words
__device__ __forceinline__ float scale_at(const uint4* w, int j, __nv_bfloat16) {
  const uint32_t sw[4] = {w[0].x, w[0].y, w[0].z, w[0].w};
  return bf16_bits_to_float((sw[j >> 1] >> (16 * (j & 1))) & 0xffffu);
}

__device__ __forceinline__ float scale_at(const uint4* w, int j, float) {
  const uint4 q = w[j >> 2];
  const uint32_t sw[4] = {q.x, q.y, q.z, q.w};
  return __uint_as_float(sw[j & 3]);
}

template <typename ST>
__device__ __forceinline__ void gemm_load(GemmRegs<ST>& rg, const __nv_bfloat16* x,
                                          const int8_t* packed, const ST* scales,
                                          int M, int K, int N, int G, int m_blk, int n_blk,
                                          int g0, int tid) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    // x tile [BM][BKT]: row r, 8-element chunk c
    const int r = (tid >> 3) + 32 * i, c = (tid & 7) * 8;
    const int m = m_blk + r, g = g0 + c / 32;
    rg.xv[i] = make_uint4(0, 0, 0, 0);
    if (m < M && g < G)
      rg.xv[i] = *reinterpret_cast<const uint4*>(x + (size_t)m * K + g0 * 32 + c);
    // packed tile: group gi = i, packed row mrow of that group, 8 columns
    const int mrow = tid >> 4, cc = (tid & 15) * 8;
    const int gw = g0 + i, n = n_blk + cc;
    rg.pk[i] = make_uint2(0, 0);
#pragma unroll
    for (int w = 0; w < GemmRegs<ST>::SW; ++w) rg.sc[i][w] = make_uint4(0, 0, 0, 0);
    if (gw < G && n < N) {
      rg.pk[i] = __ldg(reinterpret_cast<const uint2*>(packed + (size_t)(mrow * G + gw) * N + n));
#pragma unroll
      for (int w = 0; w < GemmRegs<ST>::SW; ++w)
        rg.sc[i][w] = __ldg(reinterpret_cast<const uint4*>(scales + (size_t)gw * N + n) + w);
    }
  }
}

template <typename ST>
__device__ __forceinline__ void gemm_store(const GemmRegs<ST>& rg, __nv_bfloat16* xs,
                                           __nv_bfloat16* ws, int tid) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = (tid >> 3) + 32 * i, c = (tid & 7) * 8;
    *reinterpret_cast<uint4*>(xs + r * XS_LD + c) = rg.xv[i];
    const int mrow = tid >> 4, cc = (tid & 15) * 8;
    const uint32_t pw[2] = {rg.pk[i].x, rg.pk[i].y};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int b = (int)(int8_t)((pw[j >> 2] >> (8 * (j & 3))) & 0xffu);
      const float s = scale_at(rg.sc[i], j, ST());
      ws[(32 * i + mrow) * WS_LD + cc + j] =
          __float2bfloat16((float)((int8_t)(b << 4) >> 4) * s);
      ws[(32 * i + mrow + 16) * WS_LD + cc + j] = __float2bfloat16((float)(b >> 4) * s);
    }
  }
}

template <typename ST>
__global__ void __launch_bounds__(256)
q4_gemm_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ packed,
               const ST* __restrict__ scales, float* __restrict__ out,
               int M, int K, int N) {
  using namespace nvcuda;
  __shared__ __align__(32) __nv_bfloat16 xs[BM * XS_LD];
  __shared__ __align__(32) __nv_bfloat16 ws[BKT * WS_LD];
  __shared__ __align__(32) float stage[8][16 * 16];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int m_blk = blockIdx.y * BM, n_blk = blockIdx.x * BN;
  const int G = K / 32;
  const int wm = warp >> 2, wn = warp & 3;  // warp tile: rows wm*32, cols wn*32

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  GemmRegs<ST> rg;
  gemm_load(rg, x, packed, scales, M, K, N, G, m_blk, n_blk, 0, tid);
  for (int g0 = 0; g0 < G; g0 += 2) {
    gemm_store(rg, xs, ws, tid);
    __syncthreads();
    if (g0 + 2 < G) gemm_load(rg, x, packed, scales, M, K, N, G, m_blk, n_blk, g0 + 2, tid);
#pragma unroll
    for (int kk = 0; kk < BKT; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], xs + (wm * 32 + i * 16) * XS_LD + kk, XS_LD);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], ws + kk * WS_LD + wn * 32 + j * 16, WS_LD);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(stage[warp], acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int m = m_blk + wm * 32 + i * 16 + (e >> 4);
        const int n = n_blk + wn * 32 + j * 16 + (e & 15);
        if (m < M && n < N) out[(size_t)m * N + n] = stage[warp][e];
      }
      __syncwarp();
    }
}

template <typename ST>
cudaError_t launch(const __nv_bfloat16* x, const int8_t* packed, const ST* scales, float* out,
                   float* partial, int M, int K, int N, int ksplit, cudaStream_t st) {
  if (M == 1) return launch_gemv(x, packed, scales, out, partial, K, N, ksplit, st);
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  q4_gemm_kernel<ST><<<grid, 256, 0, st>>>(x, packed, scales, out, M, K, N);
  return cudaGetLastError();
}

}  // namespace

// x bf16 [M, K], packed int8 [K/2, N] (ilv, one chunk), scales [G, N] (bf16,
// or f32 when scale_f32 != 0), out f32 [M, N]; partial f32 [ksplit, N]
// scratch for the decode split (M = 1).
// Requires K % 32 == 0, N % 8 == 0 and 16-byte aligned pointers (checked by
// the Python wrapper). Returns cudaGetLastError() after the launches.
extern "C" int q4_matmul_launch(const void* x, const void* packed, const void* scales,
                                void* out, void* partial, int M, int K, int N,
                                int ksplit, int scale_f32, void* stream) {
  auto xs = static_cast<const __nv_bfloat16*>(x);
  auto pk = static_cast<const int8_t*>(packed);
  auto o = static_cast<float*>(out);
  auto part = static_cast<float*>(partial);
  auto st = static_cast<cudaStream_t>(stream);
  if (K % 32 != 0 || N % 8 != 0 || M < 1 || ksplit < 1) return (int)cudaErrorInvalidValue;
  if (scale_f32)
    return (int)launch(xs, pk, static_cast<const float*>(scales), o, part, M, K, N, ksplit, st);
  return (int)launch(xs, pk, static_cast<const __nv_bfloat16*>(scales), o, part, M, K, N, ksplit,
                     st);
}
