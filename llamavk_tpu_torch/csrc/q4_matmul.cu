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
//    deterministic pass in a fixed order.
//  * prefill (M > 1): tensor-core operations (989 TFLOP/s bf16 dense; the
//    f32 dot takes two or three passes). Design: 64x128 output tiles, 64-deep
//    k steps (ilv: two quantization groups; lin: one 32-row unit, whose low
//    nibbles are 32 k of the first half and high nibbles 32 k of the
//    second); the next step's global loads are in registers while the tensor
//    cores (WMMA bf16 16x16x16, f32 accumulate) work on the current shared
//    tiles; the weight tile is dequantized to bf16 on its way into shared
//    memory. wgmma/TMA are later work.

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

// partial [splits, M*N] -> out [M*N], summed in split order (deterministic)
__global__ void splitk_reduce_kernel(const float* __restrict__ partial,
                                     float* __restrict__ out, int splits, int mn) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= mn) return;
  float sum = 0.f;
  for (int s = 0; s < splits; ++s) sum += partial[(size_t)s * mn + i];
  out[i] = sum;
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
  if (splits > 1)
    splitk_reduce_kernel<<<(N + 255) / 256, 256, 0, stream>>>(partial, out, splits, N);
  return cudaGetLastError();
}

// ------------------------------------------------------------- prefill GEMM
constexpr int BM = 64, BN = 128, BKT = 64;  // BKT: two ilv groups, or one lin unit
constexpr int XS_LD = BKT + 8;   // bf16 elements, keeps WMMA rows 32-byte aligned
constexpr int WS_LD = BN + 8;

template <typename ST>
struct GemmRegs {
  static constexpr int SW = (int)sizeof(ST) / 2;  // 16-byte words of 8 scales
  uint4 xv[2];      // two 8-element x chunks
  uint2 pk[2];      // two 8-column packed words
  uint4 sc[2][SW];  // 8 scales: ilv of group i; lin of the low (0) and high (1) half
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

// Step `st` of the k loop: ilv groups 2st, 2st+1; lin unit st (packed rows
// 32st..32st+31, k = 32st.. and K/2 + 32st..).
template <typename ST, bool LIN>
__device__ __forceinline__ void gemm_load(GemmRegs<ST>& rg, const __nv_bfloat16* x,
                                          const int8_t* packed, const ST* scales,
                                          int M, int K, int N, int G, int m_blk, int n_blk,
                                          int st, int tid) {
  const int n = n_blk + (tid & 15) * 8;
  const int mrow = tid >> 4;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    // x tile [BM][BKT]: row r, 8-element chunk c
    const int r = (tid >> 3) + 32 * i, c = (tid & 7) * 8;
    const int m = m_blk + r;
    rg.xv[i] = make_uint4(0, 0, 0, 0);
    if (LIN) {
      const int k = c < 32 ? st * 32 + c : K / 2 + st * 32 + c - 32;
      if (m < M) rg.xv[i] = *reinterpret_cast<const uint4*>(x + (size_t)m * K + k);
    } else if (m < M && 2 * st + c / 32 < G) {
      rg.xv[i] = *reinterpret_cast<const uint4*>(x + (size_t)m * K + st * 64 + c);
    }
    // packed tile: ilv row mrow of group 2st+i; lin row 32st + 16i + mrow
    const int gw = LIN ? st : 2 * st + i;
    const size_t row = LIN ? (size_t)(32 * st + 16 * i + mrow) : (size_t)(mrow * G + gw);
    rg.pk[i] = make_uint2(0, 0);
    if (gw < G && n < N) rg.pk[i] = __ldg(reinterpret_cast<const uint2*>(packed + row * N + n));
    // scales: ilv those of group 2st+i; lin the low (i = 0) and high (i = 1) halves'
    const int gs = LIN ? (i ? G / 2 + st : st) : gw;
#pragma unroll
    for (int w = 0; w < GemmRegs<ST>::SW; ++w) {
      rg.sc[i][w] = make_uint4(0, 0, 0, 0);
      if (gs < G && n < N)
        rg.sc[i][w] = __ldg(reinterpret_cast<const uint4*>(scales + (size_t)gs * N + n) + w);
    }
  }
}

// bf16 part p of w: w itself (NP = 1), else the p-th term of w0 + w1 (+ w2)
template <int NP>
__device__ __forceinline__ __nv_bfloat16 part(float w, int p) {
  if (NP == 1) return __float2bfloat16(w);
  __nv_bfloat16 h = __float2bfloat16(w);
  for (int i = 0; i < p; ++i) {
    w = __fsub_rn(w, __bfloat162float(h));
    h = __float2bfloat16(w);
  }
  return h;
}

template <typename ST, bool LIN, bool RS, int NP>
__device__ __forceinline__ void gemm_store(const GemmRegs<ST>& rg, __nv_bfloat16* xs,
                                           __nv_bfloat16* ws, int tid, int p) {
  const int mrow = tid >> 4, cc = (tid & 15) * 8;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (p == 0) {
      const int r = (tid >> 3) + 32 * i, c = (tid & 7) * 8;
      *reinterpret_cast<uint4*>(xs + r * XS_LD + c) = rg.xv[i];
    }
    const uint32_t pw[2] = {rg.pk[i].x, rg.pk[i].y};
    // ilv: group i's rows 32i + mrow (low) and 32i + mrow + 16 (high);
    // lin: rows 16i + mrow of the low half and 32 + 16i + mrow of the high
    const int lo_row = LIN ? 16 * i + mrow : 32 * i + mrow;
    const int hi_row = LIN ? 32 + 16 * i + mrow : 32 * i + mrow + 16;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int b = (int)(int8_t)((pw[j >> 2] >> (8 * (j & 3))) & 0xffu);
      float s_lo = scale_at(rg.sc[LIN ? 0 : i], j, ST());
      float s_hi = LIN ? scale_at(rg.sc[1], j, ST()) : s_lo;
      if (RS) {
        s_lo = bf16_round(s_lo);
        s_hi = bf16_round(s_hi);
      }
      const float w_lo = NP == 1 ? (float)nib_lo(b) * s_lo : __fmul_rn((float)nib_lo(b), s_lo);
      const float w_hi = NP == 1 ? (float)nib_hi(b) * s_hi : __fmul_rn((float)nib_hi(b), s_hi);
      ws[lo_row * WS_LD + cc + j] = part<NP>(w_lo, p);
      ws[hi_row * WS_LD + cc + j] = part<NP>(w_hi, p);
    }
  }
}

template <typename ST, bool LIN, bool RS, int NP>
__device__ __forceinline__ void q4_gemm_body(const __nv_bfloat16* __restrict__ x,
                                             const int8_t* __restrict__ packed,
                                             const ST* __restrict__ scales,
                                             float* __restrict__ out, int M, int K, int N) {
  using namespace nvcuda;
  __shared__ __align__(32) __nv_bfloat16 xs[BM * XS_LD];
  __shared__ __align__(32) __nv_bfloat16 ws[BKT * WS_LD];
  __shared__ __align__(32) float stage[8][16 * 16];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int m_blk = blockIdx.y * BM, n_blk = blockIdx.x * BN;
  const int G = K / 32;
  const int steps = LIN ? G / 2 : (G + 1) / 2;
  const int wm = warp >> 2, wn = warp & 3;  // warp tile: rows wm*32, cols wn*32

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  GemmRegs<ST> rg;
  gemm_load<ST, LIN>(rg, x, packed, scales, M, K, N, G, m_blk, n_blk, 0, tid);
  for (int st = 0; st < steps; ++st) {
    for (int p = 0; p < NP; ++p) {
      gemm_store<ST, LIN, RS, NP>(rg, xs, ws, tid, p);
      __syncthreads();
      if (p == NP - 1 && st + 1 < steps)
        gemm_load<ST, LIN>(rg, x, packed, scales, M, K, N, G, m_blk, n_blk, st + 1, tid);
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

template <typename ST, bool LIN, bool RS, int NP>
__global__ void __launch_bounds__(256)
q4_gemm_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ packed,
               const ST* __restrict__ scales, float* __restrict__ out, int M, int K, int N) {
  q4_gemm_body<ST, LIN, RS, NP>(x, packed, scales, out, M, K, N);
}

// The one-pass kernel over f32 scales, bounded to two blocks per SM (128
// registers a thread): left to itself the compiler gives it 130 registers,
// one block per SM and 1.33x the two-block time. Bounding the bf16-scale
// kernel so (from its own 97) cost it 10%, and the f32 dot's passes more.
// The bound has a kernel of its own: an explicit min-blocks of 1 is not the
// same as no bound to the compiler. One kernel templated on it (1 for the
// others) gave the bf16-scale GEMM 1.3-1.6x and the f32 dot's three passes
// 1.6-1.7x their unbounded time (NVIDIA H100 80GB HBM3, chip_smoke.py).
template <bool LIN, bool RS>
__global__ void __launch_bounds__(256, 2)
q4_gemm_f32s_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ packed,
                    const float* __restrict__ scales, float* __restrict__ out, int M, int K,
                    int N) {
  q4_gemm_body<float, LIN, RS, 1>(x, packed, scales, out, M, K, N);
}

template <typename ST, bool LIN, bool RS, bool WF32>
cudaError_t launch(const __nv_bfloat16* x, const int8_t* packed, const ST* scales, float* out,
                   float* partial, int M, int K, int N, int ksplit, cudaStream_t st) {
  if (M == 1) return launch_gemv<ST, LIN, RS, WF32>(x, packed, scales, out, partial, K, N,
                                                   ksplit, st);
  // the f32 dot's bf16 parts: two hold q * s exactly for a bf16 scale, three
  // for an f32 one
  constexpr int NP = WF32 ? (sizeof(ST) == 4 ? 3 : 2) : 1;
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  if constexpr (sizeof(ST) == 4 && NP == 1)
    q4_gemm_f32s_kernel<LIN, RS><<<grid, 256, 0, st>>>(x, packed, scales, out, M, K, N);
  else
    q4_gemm_kernel<ST, LIN, RS, NP><<<grid, 256, 0, st>>>(x, packed, scales, out, M, K, N);
  return cudaGetLastError();
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
