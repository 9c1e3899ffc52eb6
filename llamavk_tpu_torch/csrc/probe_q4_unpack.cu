// Probes of K1's inner loop for Hopper (sm_90a): which unpack of the 4-bit
// weights, and which weight storage, feeds a GEMV-class product fastest.
// y[m, n] = sum_k x[m, k] W[k, n] for M = 1..8 rows, bound by weight bytes.
//
// Replaces the TPU probe kernels of `tools/`:
//  * bench_unpack_trick.py `kernel_current` :33 and `kernel_trick` :52 (P1);
//  * bench_unpack2.py `kernel_cur` :45, `kernel_i8shift` :63, `kernel_int4`
//    :83, `kernel_bitcast4` :100 and `perm_probe.kern` :144 (P3);
//  * bench_i4_stacked.py `kernel_prod` :43 and `kernel_i4st` :71 (P4), with
//    the layer index read on the device (the TPU's scalar prefetch).
// They answer the TPU's questions on this card: the TPU probes counted VPU
// operations per weight; here the same unpacks run on the CUDA cores beside
// K1's own loads.
//
// Two weight storages, x bf16 [M, K] in original k order (as K1 reads it):
//  * the byte plane, K1's ilv layout [K/2, N] int8: byte row m*G + g holds
//    k = g*32 + m in its low nibble and k = g*32 + m + 16 in its high one,
//    both scaled by scales[g, n] (csrc/q4_matmul.cu). The TPU probes hold
//    the same bytes and take x in their activation order, the permutation
//    x_ilv[m*G + g] = x[g*32 + m], x_ilv[K/2 + m*G + g] = x[g*32 + m + 16];
//  * the int4 plane [G][4][N] of 32-bit words: word (g, j4, n) holds the
//    weights of column n at k = g*32 + 8*j4 + j in nibble j (bits 4j..4j+3).
//    One word is a quarter of a Q4 block of one column: one scale for its
//    8 weights, neighbouring lanes on neighbouring columns (a warp reads 128
//    contiguous bytes), and nibbles j and j + 4 sit 16 bits apart, so one
//    shift and one lop3 give two bf16 weights (the magic number below).
//    `repack_int4` in the Python module builds it from the byte plane.
//
// Unpacks of the byte plane, all giving bf16(f32(q) * s):
//  * SHIFT (K1's): each byte sign-extended, nibbles by 32-bit shifts,
//    converted to f32, times s, rounded to bf16.
//  * TRICK: the magic number on 32-bit words. (w >> sh) & 0x000f000f, xor
//    0x43084308 (one lop3), is two bf16 values 0x4300 | ((q ^ 8) & 15) =
//    136 + q, from the bytes of two columns; __hsub2 of 136 leaves q exactly,
//    and the scale multiplies as K1 does: __hmul2 for a bf16 scale (q * s is
//    exact in f32, so one bf16 rounding gives K1's weight), f32 then one
//    rounding for an f32 scale. The weights are bit-equal to SHIFT's. The
//    TPU probe folded the 136 into a bias term instead, which loses bits.
//  * I8SHIFT: four nibbles at a time by byte-SIMD, (n ^ 8) - 8 per byte
//    with __vsub4, then each byte converted and multiplied.
// `mul_bf16` rounds an f32 scale to bf16 before the multiply (the probes'
// bf16 multiply, K1's LLAMAVK_Q4_MUL=bf16); the product is then exact and
// one rounding gives the weight. The int4 plane takes TRICK's unpack.
// BITCAST4 is the int4 plane's kernel on the byte plane's bytes as they
// lie: no repack, so its weights are the byte plane's nibbles permuted
// (`probe_perm_launch` decodes that view; the Python module's
// `bitcast_perm` says which nibble lands where).
//
// Design (K1's GEMV, csrc/q4_matmul.cu): 8 warps a block and 128 columns
// (byte plane: 4 neighbouring columns a lane, one 32-bit word per packed
// row; int4 plane: columns lane + 32c, c < 4), warps striding over the
// groups of the block's K range, x of every row staged in shared memory,
// K split across blocks (two blocks per SM) and the partials summed in split
// order by a second launch. Products accumulate in f32 with fmaf in k order
// within a group.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "split_sum.cuh"

namespace {

constexpr int WARPS = 8;
constexpr int COLS = 128;
constexpr int SMEM = 40960;

enum { SHIFT = 0, TRICK = 1, I8SHIFT = 2, PLANE = 3 };

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

__device__ __forceinline__ float to_f32(__nv_bfloat16 s) { return __bfloat162float(s); }
__device__ __forceinline__ float to_f32(float s) { return s; }

// the scale of a weight as the multiply takes it
template <bool MULB, typename ST>
__device__ __forceinline__ float scale_of(ST s) {
  return MULB ? bf16_round(to_f32(s)) : to_f32(s);
}

__device__ __forceinline__ int nib_lo(int b) { return (int)(int8_t)(b << 4) >> 4; }
__device__ __forceinline__ int nib_hi(int b) { return b >> 4; }

// two bf16 weights q * s from the magic-number pair of `w >> sh` (low half
// first); `sa`, `sb` the scales of the two weights
template <bool BF16MUL>
__device__ __forceinline__ float2 magic_pair(uint32_t w, int sh, float sa, float sb) {
  const uint32_t bits = ((w >> sh) & 0x000f000fu) ^ 0x43084308u;
  __nv_bfloat162 q2 = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&bits),
                              __floats2bfloat162_rn(136.f, 136.f));
  if (BF16MUL) return __bfloat1622float2(__hmul2(q2, __floats2bfloat162_rn(sa, sb)));
  const float2 q = __bfloat1622float2(q2);
  return make_float2(bf16_round(q.x * sa), bf16_round(q.y * sb));
}

// The 8 weights of one byte-plane word (4 columns): lo[c] of k, hi[c] of
// k + 16, for column c of the word.
template <int UNPACK, bool BF16MUL>
__device__ __forceinline__ void unpack_word(uint32_t w, const float* s, float* lo, float* hi) {
  if constexpr (UNPACK == TRICK) {
    const float2 l02 = magic_pair<BF16MUL>(w, 0, s[0], s[2]);
    const float2 h02 = magic_pair<BF16MUL>(w, 4, s[0], s[2]);
    const float2 l13 = magic_pair<BF16MUL>(w, 8, s[1], s[3]);
    const float2 h13 = magic_pair<BF16MUL>(w, 12, s[1], s[3]);
    lo[0] = l02.x, lo[2] = l02.y, lo[1] = l13.x, lo[3] = l13.y;
    hi[0] = h02.x, hi[2] = h02.y, hi[1] = h13.x, hi[3] = h13.y;
  } else if constexpr (UNPACK == I8SHIFT) {
    const uint32_t lo4 = __vsub4((w & 0x0f0f0f0fu) ^ 0x08080808u, 0x08080808u);
    const uint32_t hi4 = __vsub4(((w >> 4) & 0x0f0f0f0fu) ^ 0x08080808u, 0x08080808u);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      lo[c] = bf16_round((float)(int8_t)(lo4 >> (8 * c)) * s[c]);
      hi[c] = bf16_round((float)(int8_t)(hi4 >> (8 * c)) * s[c]);
    }
  } else {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int b = (int)(int8_t)((w >> (8 * c)) & 0xffu);
      lo[c] = bf16_round((float)nib_lo(b) * s[c]);
      hi[c] = bf16_round((float)nib_hi(b) * s[c]);
    }
  }
}

// the 8 weights of one int4-plane word, k = 8*j4 + j and + 4 within the group
template <bool BF16MUL>
__device__ __forceinline__ void unpack_plane_word(uint32_t w, float s, float* wk) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 p = magic_pair<BF16MUL>(w, 4 * j, s, s);
    wk[j] = p.x;
    wk[j + 4] = p.y;
  }
}

// x rows [0, M) of k range [u_begin*32, +kw) into shared memory
__device__ __forceinline__ void stage_x(__nv_bfloat16* xs, const __nv_bfloat16* x, int M, int K,
                                        int k0, int kw) {
  for (int i = threadIdx.x; i < M * kw; i += blockDim.x) {
    const int r = i / kw, c = i - r * kw;
    xs[i] = x[(size_t)r * K + k0 + c];
  }
}

// The block's cross-warp sum of acc[r][c] for column col(c) of the block,
// written to dst[r * N + n] (dst: out, or this split's rows of partial).
template <int MAXM, typename ColOf>
__device__ __forceinline__ void block_sum(float (*acc)[4], float* red, float* dst, int M, int N,
                                          int n_blk, ColOf col) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();  // the x stage is dead: its shared memory takes the sums
#pragma unroll
  for (int r = 0; r < MAXM; ++r)
    if (r < M)
#pragma unroll
      for (int c = 0; c < 4; ++c) red[(warp * MAXM + r) * COLS + col(lane, c)] = acc[r][c];
  __syncthreads();
  for (int e = threadIdx.x; e < M * COLS; e += blockDim.x) {
    const int r = e / COLS, cl = e - r * COLS, n = n_blk + cl;
    if (n >= N) continue;
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) sum += red[(w * MAXM + r) * COLS + cl];
    dst[(size_t)r * N + n] = sum;
  }
}

// the byte plane: SHIFT, TRICK or I8SHIFT
template <typename ST, int UNPACK, bool MULB, int MAXM, bool STACKED>
__global__ void __launch_bounds__(WARPS * 32)
bytes_gemv_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ packed,
                  const ST* __restrict__ scales, const int* __restrict__ idx,
                  float* __restrict__ out, int M, int K, int N, int gps) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  float* red = reinterpret_cast<float*>(smem_raw);
  const int G = K / 32;
  if constexpr (STACKED) {  // the layer, read on the device
    const int layer = __ldg(idx);
    packed += (size_t)layer * (K / 2) * N;
    scales += (size_t)layer * G * N;
  }
  constexpr bool BF16MUL = MULB || sizeof(ST) == 2;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int u_begin = blockIdx.y * gps, u_end = min(G, u_begin + gps);
  const int kw = (u_end - u_begin) * 32;
  const int n0 = blockIdx.x * COLS + lane * 4;
  stage_x(xs, x, M, K, u_begin * 32, kw);
  __syncthreads();

  float acc[MAXM][4];
#pragma unroll
  for (int r = 0; r < MAXM; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
  if (n0 < N) {
    for (int u = u_begin + warp; u < u_end; u += WARPS) {
      uint32_t words[16];
#pragma unroll
      for (int m = 0; m < 16; ++m)
        words[m] = __ldg(reinterpret_cast<const uint32_t*>(packed + (size_t)(m * G + u) * N + n0));
      float s[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) s[c] = scale_of<MULB>(scales[(size_t)u * N + n0 + c]);
      const __nv_bfloat16* xg = xs + (u - u_begin) * 32;
#pragma unroll
      for (int m = 0; m < 16; ++m) {
        float lo[4], hi[4];
        unpack_word<UNPACK, BF16MUL>(words[m], s, lo, hi);
#pragma unroll
        for (int r = 0; r < MAXM; ++r) {
          if (r >= M) break;
          const float xlo = __bfloat162float(xg[r * kw + m]);
          const float xhi = __bfloat162float(xg[r * kw + m + 16]);
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            acc[r][c] = fmaf(xlo, lo[c], acc[r][c]);
            acc[r][c] = fmaf(xhi, hi[c], acc[r][c]);
          }
        }
      }
    }
  }
  block_sum<MAXM>(acc, red, out + (size_t)blockIdx.y * M * N, M, N, blockIdx.x * COLS,
                  [](int l, int c) { return l * 4 + c; });
}

// the int4 plane [(L,) G, 4, N] words: INT4 (and BITCAST4 on raw bytes)
template <typename ST, bool MULB, int MAXM, bool STACKED>
__global__ void __launch_bounds__(WARPS * 32)
plane_gemv_kernel(const __nv_bfloat16* __restrict__ x, const uint32_t* __restrict__ plane,
                  const ST* __restrict__ scales, const int* __restrict__ idx,
                  float* __restrict__ out, int M, int K, int N, int gps) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  float* red = reinterpret_cast<float*>(smem_raw);
  const int G = K / 32;
  if constexpr (STACKED) {
    const int layer = __ldg(idx);
    plane += (size_t)layer * G * 4 * N;
    scales += (size_t)layer * G * N;
  }
  constexpr bool BF16MUL = MULB || sizeof(ST) == 2;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int u_begin = blockIdx.y * gps, u_end = min(G, u_begin + gps);
  const int kw = (u_end - u_begin) * 32;
  const int n_blk = blockIdx.x * COLS;
  stage_x(xs, x, M, K, u_begin * 32, kw);
  __syncthreads();

  float acc[MAXM][4];
#pragma unroll
  for (int r = 0; r < MAXM; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
  for (int u = u_begin + warp; u < u_end; u += WARPS) {
    uint32_t words[4][4];
    float s[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int n = min(n_blk + lane + 32 * c, N - 1);  // a ragged column is computed, not kept
#pragma unroll
      for (int j4 = 0; j4 < 4; ++j4) words[c][j4] = __ldg(plane + ((size_t)u * 4 + j4) * N + n);
      s[c] = scale_of<MULB>(scales[(size_t)u * N + n]);
    }
    const __nv_bfloat16* xg = xs + (u - u_begin) * 32;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
#pragma unroll
      for (int j4 = 0; j4 < 4; ++j4) {
        float wk[8];
        unpack_plane_word<BF16MUL>(words[c][j4], s[c], wk);
#pragma unroll
        for (int r = 0; r < MAXM; ++r) {
          if (r >= M) break;
#pragma unroll
          for (int j = 0; j < 8; ++j)
            acc[r][c] = fmaf(__bfloat162float(xg[r * kw + 8 * j4 + j]), wk[j], acc[r][c]);
        }
      }
    }
  }
  block_sum<MAXM>(acc, red, out + (size_t)blockIdx.y * M * N, M, N, n_blk,
                  [](int l, int c) { return l + 32 * c; });
}

// The weights a variant's kernel multiplies, w bf16 [K, N] in k order: one
// thread a byte-plane word (4 columns of one packed row) or a plane word.
template <typename ST, int UNPACK, bool MULB>
__global__ void dequant_kernel(const void* __restrict__ plane, const ST* __restrict__ scales,
                               __nv_bfloat16* __restrict__ w, int K, int N) {
  constexpr bool BF16MUL = MULB || sizeof(ST) == 2;
  const int G = K / 32;
  const size_t words = UNPACK == PLANE ? (size_t)G * 4 * N : (size_t)(K / 2) * (N / 4);
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < words;
       i += (size_t)gridDim.x * blockDim.x) {
    if constexpr (UNPACK == PLANE) {
      const int n = (int)(i % N), gj = (int)(i / N), g = gj / 4, j4 = gj % 4;
      float wk[8];
      unpack_plane_word<BF16MUL>(static_cast<const uint32_t*>(plane)[i],
                                 scale_of<MULB>(scales[(size_t)g * N + n]), wk);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        w[(size_t)(g * 32 + 8 * j4 + j) * N + n] = __float2bfloat16(wk[j]);
    } else {
      const int row = (int)(i / (N / 4)), n0 = (int)(i % (N / 4)) * 4;
      const int m = row / G, g = row % G;
      float s[4], lo[4], hi[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) s[c] = scale_of<MULB>(scales[(size_t)g * N + n0 + c]);
      unpack_word<UNPACK, BF16MUL>(static_cast<const uint32_t*>(plane)[i], s, lo, hi);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        w[(size_t)(g * 32 + m) * N + n0 + c] = __float2bfloat16(lo[c]);
        w[(size_t)(g * 32 + m + 16) * N + n0 + c] = __float2bfloat16(hi[c]);
      }
    }
  }
}

// bytes [S, L] read as an int4 plane of K = 2S rows: out[k, n] the nibble
// the plane kernel takes for weight (k, n)
__global__ void perm_kernel(const uint32_t* __restrict__ words, float* __restrict__ out, int S,
                            int L) {
  const int G = 2 * S / 32;
  const size_t total = (size_t)G * 4 * L;
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x) {
    const int n = (int)(i % L), gj = (int)(i / L), g = gj / 4, j4 = gj % 4;
    const uint32_t w = words[i];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int q = (int)((w >> (4 * j)) & 15u);
      out[(size_t)(g * 32 + 8 * j4 + j) * L + n] = (float)(q >= 8 ? q - 16 : q);
    }
  }
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
  return smem > 48 * 1024
             ? cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem)
             : cudaSuccess;
}

template <typename ST, int UNPACK, bool MULB, int MAXM, bool STACKED>
cudaError_t launch(const __nv_bfloat16* x, const void* plane, const ST* scales, const int* idx,
                   float* out, float* partial, int M, int K, int N, int ksplit,
                   cudaStream_t st) {
  const int G = K / 32;
  const int gps = (G + ksplit - 1) / ksplit;
  const int splits = (G + gps - 1) / gps;
  const size_t smem_x = (size_t)M * gps * 32 * sizeof(__nv_bfloat16);
  const size_t smem_red = (size_t)WARPS * MAXM * COLS * sizeof(float);
  const size_t smem = smem_x > smem_red ? smem_x : smem_red;
  if (smem > SMEM) return cudaErrorInvalidValue;
  dim3 grid((N + COLS - 1) / COLS, splits);
  float* dst = splits == 1 ? out : partial;
  if constexpr (UNPACK == PLANE) {
    auto k = plane_gemv_kernel<ST, MULB, MAXM, STACKED>;
    cudaError_t e = allow_smem(k, smem);
    if (e != cudaSuccess) return e;
    k<<<grid, WARPS * 32, smem, st>>>(x, static_cast<const uint32_t*>(plane), scales, idx, dst,
                                      M, K, N, gps);
  } else {
    auto k = bytes_gemv_kernel<ST, UNPACK, MULB, MAXM, STACKED>;
    cudaError_t e = allow_smem(k, smem);
    if (e != cudaSuccess) return e;
    k<<<grid, WARPS * 32, smem, st>>>(x, static_cast<const int8_t*>(plane), scales, idx, dst, M,
                                      K, N, gps);
  }
  if (splits > 1)
    launch_split_sum(partial, out, splits, M * N, st);
  return cudaGetLastError();
}

template <typename ST, int UNPACK, bool MULB, bool STACKED = false>
cudaError_t launch_m(const __nv_bfloat16* x, const void* plane, const void* scales,
                     const int* idx, float* out, float* partial, int M, int K, int N, int ksplit,
                     cudaStream_t st) {
  auto s = static_cast<const ST*>(scales);
  if (M == 1)
    return launch<ST, UNPACK, MULB, 1, STACKED>(x, plane, s, idx, out, partial, M, K, N, ksplit,
                                                st);
  return launch<ST, UNPACK, MULB, 8, STACKED>(x, plane, s, idx, out, partial, M, K, N, ksplit,
                                              st);
}

}  // namespace

// Flag bits of the launchers.
enum { PR_SCALE_F32 = 1, PR_MUL_BF16 = 2, PR_STACKED = 4 };

// x bf16 [M, K] (1 <= M <= 8, original k order); plane: the byte plane
// int8 [K/2, N] (unpack 0 SHIFT, 1 TRICK, 2 I8SHIFT) or the int4 plane
// [G, 4, N] int32 words (unpack 3), [L, ...] with PR_STACKED, the layer
// then read from idx[0] on the device; scales [(L,) G, N] bf16, or f32 with
// PR_SCALE_F32; PR_MUL_BF16 rounds the scale to bf16 first; out f32 [M, N];
// partial f32 [ksplit, M, N]. The combinations the probes run: SHIFT and
// TRICK over bf16 scales (P1), SHIFT and I8SHIFT over f32 (P3; I8SHIFT also
// with PR_MUL_BF16), stacked SHIFT over f32 (P4), the int4 plane over f32
// with and without PR_MUL_BF16, stacked or not (P3, P4). Returns
// cudaGetLastError() after the launches, cudaErrorInvalidValue for another
// combination or shape (K % 32, N % 4, M in 1..8).
extern "C" int probe_unpack_launch(const void* x, const void* plane, const void* scales,
                                   const void* idx, void* out, void* partial, int M, int K, int N,
                                   int ksplit, int unpack, int flags, void* stream) {
  auto xs = static_cast<const __nv_bfloat16*>(x);
  auto ix = static_cast<const int*>(idx);
  auto o = static_cast<float*>(out);
  auto p = static_cast<float*>(partial);
  auto st = static_cast<cudaStream_t>(stream);
  const bool f32s = flags & PR_SCALE_F32, mulb = flags & PR_MUL_BF16;
  const bool stacked = flags & PR_STACKED;
  if (K % 32 || N % 4 || M < 1 || M > 8 || ksplit < 1 || (flags & ~7) || (stacked && !ix))
    return (int)cudaErrorInvalidValue;
  if (!f32s && !mulb && !stacked) {
    if (unpack == SHIFT)
      return (int)launch_m<__nv_bfloat16, SHIFT, false>(xs, plane, scales, ix, o, p, M, K, N,
                                                        ksplit, st);
    if (unpack == TRICK)
      return (int)launch_m<__nv_bfloat16, TRICK, false>(xs, plane, scales, ix, o, p, M, K, N,
                                                        ksplit, st);
    return (int)cudaErrorInvalidValue;
  }
  if (!f32s) return (int)cudaErrorInvalidValue;
  if (unpack == SHIFT && !mulb)
    return (int)(stacked ? launch_m<float, SHIFT, false, true>(xs, plane, scales, ix, o, p, M, K,
                                                               N, ksplit, st)
                         : launch_m<float, SHIFT, false>(xs, plane, scales, ix, o, p, M, K, N,
                                                         ksplit, st));
  if (unpack == I8SHIFT && !stacked)
    return (int)(mulb ? launch_m<float, I8SHIFT, true>(xs, plane, scales, ix, o, p, M, K, N,
                                                       ksplit, st)
                      : launch_m<float, I8SHIFT, false>(xs, plane, scales, ix, o, p, M, K, N,
                                                        ksplit, st));
  if (unpack == PLANE && stacked)
    return (int)(mulb ? launch_m<float, PLANE, true, true>(xs, plane, scales, ix, o, p, M, K, N,
                                                           ksplit, st)
                      : launch_m<float, PLANE, false, true>(xs, plane, scales, ix, o, p, M, K,
                                                            N, ksplit, st));
  if (unpack == PLANE)
    return (int)(mulb ? launch_m<float, PLANE, true>(xs, plane, scales, ix, o, p, M, K, N,
                                                     ksplit, st)
                      : launch_m<float, PLANE, false>(xs, plane, scales, ix, o, p, M, K, N,
                                                      ksplit, st));
  return (int)cudaErrorInvalidValue;
}

// The weights bf16 [K, N] (k order) that probe_unpack_launch's kernel of
// the same unpack and flags multiplies (not stacked): for holding TRICK's
// bit for bit against SHIFT's, and a plane against the bytes it came from.
extern "C" int probe_dequant_launch(const void* plane, const void* scales, void* w, int K, int N,
                                    int unpack, int flags, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  auto o = static_cast<__nv_bfloat16*>(w);
  if (K % 32 || N % 4 || (flags & ~3)) return (int)cudaErrorInvalidValue;
  const bool f32s = flags & PR_SCALE_F32, mulb = flags & PR_MUL_BF16;
  const int grid = 132 * 8;
  if (!f32s) {
    auto s = static_cast<const __nv_bfloat16*>(scales);
    if (mulb) return (int)cudaErrorInvalidValue;
    if (unpack == SHIFT) dequant_kernel<__nv_bfloat16, SHIFT, false><<<grid, 256, 0, st>>>(plane, s, o, K, N);
    else if (unpack == TRICK) dequant_kernel<__nv_bfloat16, TRICK, false><<<grid, 256, 0, st>>>(plane, s, o, K, N);
    else return (int)cudaErrorInvalidValue;
    return (int)cudaGetLastError();
  }
  auto s = static_cast<const float*>(scales);
  if (unpack == SHIFT && !mulb) dequant_kernel<float, SHIFT, false><<<grid, 256, 0, st>>>(plane, s, o, K, N);
  else if (unpack == I8SHIFT && !mulb) dequant_kernel<float, I8SHIFT, false><<<grid, 256, 0, st>>>(plane, s, o, K, N);
  else if (unpack == I8SHIFT) dequant_kernel<float, I8SHIFT, true><<<grid, 256, 0, st>>>(plane, s, o, K, N);
  else if (unpack == PLANE && !mulb) dequant_kernel<float, PLANE, false><<<grid, 256, 0, st>>>(plane, s, o, K, N);
  else if (unpack == PLANE) dequant_kernel<float, PLANE, true><<<grid, 256, 0, st>>>(plane, s, o, K, N);
  else return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// P3's permutation probe: bytes int8 [S, L] (S % 16 == 0) read as the int4
// plane of 2S rows, out f32 [2S, L] the signed nibble the plane kernel
// takes for each (k, n).
extern "C" int probe_perm_launch(const void* bytes, void* out, int S, int L, void* stream) {
  if (S % 16 || L < 1) return (int)cudaErrorInvalidValue;
  perm_kernel<<<64, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(bytes), static_cast<float*>(out), S, L);
  return (int)cudaGetLastError();
}
