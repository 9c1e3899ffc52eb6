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
//  * LLAMAVK_Q4_DOT=f32: w stays f32, fed to the tensor cores as NP bf16
//    parts (two over a bf16 scale, exact; three over an f32 one, within
//    2^-27 |w|), except in the GEMV over an f32 scale plane, which
//    multiplies the exact f32 w by fmaf on the CUDA cores.
// Both kernels form the weights with the helpers of q4_dequant.cuh (the
// GEMV with no conversion instruction), so their weights are the same bits
// in every mode.
//
// The decode GEMV (M = 1) on an H100 is bound by the weight bytes: 0.5625
// byte a weight (packed nibbles and a bf16 scale a group), 3.72 GB a 7B
// token against 3.35 TB/s. The kernel it replaced reached 16-34% of that
// bound. Measured on NVIDIA H100 80GB HBM3, 700.00 W (PERF.md §6): its
// loads alone, with the arithmetic cut to one add a word, took 66-75% of
// its time, and its arithmetic alone (a sign extension, an int-to-float
// conversion, an f32 multiply, an f32-bf16-f32 round trip and an fmaf a
// weight) 76-82%: both held it back, the conversions at a quarter of the
// FMA rate and the 4-byte loads (128 bytes a warp instruction); a second
// launch added its K splits.
// Design:
//  * Dequantization with no conversion instruction (q4_dequant.cuh): a
//    byte permute a column and pair of rows, one LOP3 (and a shift for the
//    high nibbles) a pair of weights, a bf16x2 subtract and multiply.
//  * The dot on `mma.sync` m16n8k16, bf16 in, f32 accumulators: the
//    dequantized weights are the A operand (16 output columns an MMA), x the
//    B operand (every B column the same x, so every lane's accumulators hold
//    its own columns' sums), one MMA a bf16 part of the weights. Only an
//    eighth of each MMA is used, and the tensor cores still have ~100x the
//    rate the bytes allow. `wgmma` buys nothing here: it needs its B operand
//    (x) from shared memory in 64-row warpgroup tiles and its A from
//    registers in the same fragments, and the work is bound by bytes, not by
//    the MMA rate. The f32 dot over an f32 scale plane would take three
//    parts (three MMAs and the parts' roundings a weight pair): measured at
//    1.3-3.0x the replaced kernel's time and 2.1-4.3x this one's (PERF.md
//    §6), it runs fmaf on the exact f32 w instead, each lane its own k, the
//    four lanes of a column added by shuffles.
//  * 16-byte streams: lane (g, t) of a warp (g = lane / 4, t = lane % 4)
//    loads columns 16 g .. 16 g + 15 of packed rows 2t, 2t + 1, 8 + 2t,
//    9 + 2t of a unit (16 packed rows, 32 k), 16 bytes a row, so each load
//    instruction reads four rows' 128 contiguous bytes; a warp covers 128
//    columns. The pair (k, k + 1) of an A register is the same nibble of two
//    neighbouring packed rows, and the B register the x pair at
//    (k, k + 1) in x's own order. The loads go one unit ahead of the
//    multiply straight into registers (ld.global.nc, L1::no_allocate): 32
//    accumulators and a unit in flight fill the 128 registers that let 4
//    blocks of 4 warps share an SM. A `cp.async` ring in shared memory was
//    slower (PERF.md §6).
//  * One launch a call: K is split into fixed ranges of whole units, the
//    count from (K, N) and the SM count (ops/q4_matmul.py::gemv_ksplit:
//    the most splits whose blocks all fit on the card at once); the warps
//    of a block split its range and add their sums in warp order in shared
//    memory; each block writes its partial, and the last block of a column
//    tile to arrive (a counter per tile: __threadfence, atomicAdd, set back
//    to 0 by that block) adds the partials in split order: deterministic,
//    no float atomics.
//  * M > 1: q4_gemm.cuh (the weight bytes at M <= 64, the tensor-core
//    operations above; `mma.sync` with the weights dequantized straight
//    into A fragments, a `cp.async` ring, split-K at M <= 64).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_ptx.cuh"
#include "q4_dequant.cuh"
#include "q4_gemm.cuh"

namespace {

namespace gemv {

using q4dq::Scale;

constexpr int WARPS = 4;       // a block's warps split its units
constexpr int THREADS = 32 * WARPS;
constexpr int MIN_BLOCKS = 4;  // blocks an SM: 128 registers a thread
constexpr int BN = 128;        // output columns a block (8 lane groups x 16)
constexpr int MAX_UPS = 256;   // units a split at most: an x stage of 16 KB

__device__ __forceinline__ uint4 ld_stream16(const void* p) {
  uint4 v;
  asm volatile("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p));
  return v;
}

__device__ __forceinline__ uint2 ld_stream8(const void* p) {
  uint2 v;
  asm volatile("ld.global.nc.L1::no_allocate.v2.u32 {%0, %1}, [%2];\n"
               : "=r"(v.x), "=r"(v.y)
               : "l"(p));
  return v;
}

__device__ __forceinline__ uint32_t word(const uint4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

// One unit's operands of a lane, in 16-byte chunks: its 16 columns of
// packed rows 2t, 2t + 1 (k step 0), 8 + 2t, 9 + 2t (k step 1) of the unit,
// then those columns' scales (lin: the low nibbles' row, then the high's).
template <typename ST, bool LIN>
struct Unit {
  static constexpr int SQ = (int)sizeof(ST);  // chunks of 16 scales
  static constexpr int CH = 4 + (LIN ? 2 : 1) * SQ;
  uint4 c[CH];
};

// Where a lane's chunks of its warp's units lie: packed row 8s + 2t + j of
// the unit at `pk` + (8s + j) `row` bytes, its scale chunk q at `sc` + 16q
// (lin: the high nibbles' row `hi` bytes on); `next` steps to the warp's
// next unit (WARPS units on). The lane reads `valid` of its 16 columns
// (past N: zero).
template <typename ST, bool LIN>
struct Cursor {
  const char* pk;
  const char* sc;
  size_t row, hi;
  int pk_step, sc_step, valid;

  __device__ __forceinline__ Cursor(const int8_t* packed, const ST* scales, int G, int N, int u,
                                    int n, int t, int valid_) {
    const int m0 = 2 * t;  // the lane's first row of a k step
    pk = reinterpret_cast<const char*>(packed + (size_t)(LIN ? 16 * u + m0 : m0 * G + u) * N + n);
    sc = reinterpret_cast<const char*>(scales + (size_t)(LIN ? u / 2 : u) * N + n);
    row = (size_t)(LIN ? 1 : G) * N;
    hi = (size_t)(G / 2) * N * sizeof(ST);
    pk_step = (LIN ? 16 * WARPS : WARPS) * N;
    sc_step = (LIN ? WARPS / 2 : WARPS) * N * (int)sizeof(ST);
    valid = valid_;
  }
  __device__ __forceinline__ void next() {
    pk += pk_step;
    sc += sc_step;
  }
  // chunk i's address and the bytes to read of its 16
  __device__ __forceinline__ const char* chunk(int i, int& bytes) const {
    constexpr int SQ = (int)sizeof(ST);
    if (i < 4) {
      bytes = valid;
      return pk + (size_t)(8 * (i >> 1) + (i & 1)) * row;
    }
    const int r = (i - 4) / SQ, q = (i - 4) % SQ;
    bytes = valid * SQ > 16 * q ? 16 : 0;
    return sc + (r ? hi : 0) + 16 * q;
  }
};

// A unit's chunks into registers. EDGE: a column tile past N, or packed
// rows only 8-byte aligned (N % 16 != 0): packed rows in 8-byte halves.
template <typename ST, bool LIN, bool EDGE>
__device__ __forceinline__ void load_unit(Unit<ST, LIN>& d, const Cursor<ST, LIN>& cur) {
#pragma unroll
  for (int i = 0; i < Unit<ST, LIN>::CH; ++i) {
    int bytes;
    const char* p = cur.chunk(i, bytes);
    if (!EDGE) {
      d.c[i] = ld_stream16(p);
      continue;
    }
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (i >= 4) {
      if (bytes) v = ld_stream16(p);
    } else {
      if (bytes >= 8) {
        const uint2 a = ld_stream8(p);
        v.x = a.x;
        v.y = a.y;
      }
      if (bytes >= 16) {
        const uint2 b = ld_stream8(p + 8);
        v.z = b.x;
        v.w = b.y;
      }
    }
    d.c[i] = v;
  }
}

// the scale of the lane's column j (0-15) from its scale chunks
template <typename ST, bool RS>
__device__ __forceinline__ Scale col_scale(const uint4* ch, int j) {
  if constexpr (sizeof(ST) == 2) {
    return q4dq::scale_bf16(word(ch[j >> 3], (j & 7) >> 1), j & 1);
  } else {
    return q4dq::scale_f32<RS, false>(__uint_as_float(word(ch[j >> 2], j & 3)));
  }
}

// The products of one unit (the block's j-th of nb). On the tensor cores:
// MMA i takes the lane's columns 2i, 2i + 1 as A rows g, g + 8, one MMA per
// bf16 part of the weights (the sums of a column's 16 k in every lane).
// Over f32 scales under the f32 dot (NP = 3): the exact f32 w = q * s by
// fmaf on the CUDA cores, each lane its own k into acc[i][0] (column 2i) and
// acc[i][2] (2i + 1).
template <typename ST, bool LIN, bool RS, int NP>
__device__ __forceinline__ void mma_unit(float (&acc)[8][4], const Unit<ST, LIN>& d,
                                         const __nv_bfloat16* xs, int j, int nb, int t) {
  constexpr int SQ = Unit<ST, LIN>::SQ;
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    // x at the k of the low nibbles of rows 8s + 2t, 8s + 2t + 1, and of
    // their high nibbles
    const int kl = (LIN ? 16 * j : 32 * j) + 8 * s + 2 * t;
    const int kh = LIN ? 16 * nb + kl : kl + 16;
    const uint32_t b0 = *reinterpret_cast<const uint32_t*>(xs + kl);
    const uint32_t b1 = *reinterpret_cast<const uint32_t*>(xs + kh);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const uint32_t wa = word(d.c[2 * s], i >> 1), wb = word(d.c[2 * s + 1], i >> 1);
      uint32_t lo0, hi0, lo1, hi1;
      q4dq::magic_pairs<false>(wa, wb, 2 * (i & 1), lo0, hi0);
      q4dq::magic_pairs<false>(wa, wb, 2 * (i & 1) + 1, lo1, hi1);
      const Scale sl0 = col_scale<ST, RS>(d.c + 4, 2 * i);
      const Scale sl1 = col_scale<ST, RS>(d.c + 4, 2 * i + 1);
      const Scale sh0 = LIN ? col_scale<ST, RS>(d.c + 4 + SQ, 2 * i) : sl0;
      const Scale sh1 = LIN ? col_scale<ST, RS>(d.c + 4 + SQ, 2 * i + 1) : sl1;
      if constexpr (NP == 3) {
        const float x[4] = {__uint_as_float(b0 << 16), __uint_as_float(b0 & 0xffff0000u),
                            __uint_as_float(b1 << 16), __uint_as_float(b1 & 0xffff0000u)};
        const uint32_t lo[2] = {lo0, lo1}, hi[2] = {hi0, hi1};
        const float sl[2] = {sl0.f, sl1.f}, sh[2] = {sh0.f, sh1.f};
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float q[4];
          q4dq::q_pair_f32(lo[h], q[0], q[1]);
          q4dq::q_pair_f32(hi[h], q[2], q[3]);
          float& a = acc[i][2 * h];
          a = fmaf(x[0], __fmul_rn(q[0], sl[h]), a);
          a = fmaf(x[1], __fmul_rn(q[1], sl[h]), a);
          a = fmaf(x[2], __fmul_rn(q[2], sh[h]), a);
          a = fmaf(x[3], __fmul_rn(q[3], sh[h]), a);
        }
      } else {
#pragma unroll
        for (int p = 0; p < NP; ++p) {
          const uint32_t a[4] = {q4dq::weight_pair<ST, RS, NP, false>(lo0, sl0, p),
                                 q4dq::weight_pair<ST, RS, NP, false>(lo1, sl1, p),
                                 q4dq::weight_pair<ST, RS, NP, false>(hi0, sh0, p),
                                 q4dq::weight_pair<ST, RS, NP, false>(hi1, sh1, p)};
          ptx::mma16816(acc[i], a, b0, b1);
        }
      }
    }
  }
}

// Block (column tile x, split y): units [y ups, (y + 1) ups) of columns
// [BN x, BN x + BN); warp w takes the range's units w, w + WARPS, ...
template <typename ST, bool LIN, bool RS, int NP, bool EDGE>
__device__ __forceinline__ void gemv_body(const __nv_bfloat16* __restrict__ x,
                                          const int8_t* __restrict__ packed,
                                          const ST* __restrict__ scales, float* __restrict__ out,
                                          float* __restrict__ partial, int* __restrict__ counters,
                                          int K, int N, int ups, uint8_t* smem) {
  using U = Unit<ST, LIN>;
  const int G = K / 32;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * BN;
  const int n = n0 + 16 * g;
  const int valid = max(0, min(16, N - n));
  const int u_begin = blockIdx.y * ups;
  const int nb = min(G, u_begin + ups) - u_begin;
  const int nu = nb > warp ? (nb - warp + WARPS - 1) / WARPS : 0;  // this warp's units
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem);
  float4* red = reinterpret_cast<float4*>(smem + 64 * ups);  // [WARPS][BN / 4]

  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;

  // the first unit's loads fly while x is staged
  Cursor<ST, LIN> cur(packed, scales, G, N, u_begin + warp, n, t, valid);
  U buf;
  if (nu > 0) load_unit<ST, LIN, EDGE>(buf, cur);
  cur.next();
  // x of the range: ilv 32 nb values from k = 32 u_begin; lin 16 nb from
  // 16 u_begin, then 16 nb from K/2 + 16 u_begin
  for (int i = tid; i < 4 * nb; i += THREADS) {
    const __nv_bfloat16* src =
        LIN ? (i < 2 * nb ? x + 16 * u_begin + 8 * i : x + K / 2 + 16 * u_begin + 8 * (i - 2 * nb))
            : x + 32 * u_begin + 8 * i;
    reinterpret_cast<uint4*>(xs)[i] = __ldg(reinterpret_cast<const uint4*>(src));
  }
  __syncthreads();

  // unit i + 1's loads fly while unit i is multiplied
  for (int i = 0; i < nu; ++i) {
    const U d = buf;
    if (i + 1 < nu) load_unit<ST, LIN, EDGE>(buf, cur);
    cur.next();
    mma_unit<ST, LIN, RS, NP>(acc, d, xs, warp + i * WARPS, nb, t);
  }

  if constexpr (NP == 3) {  // the fmaf path: add the four lanes t of a g
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; e += 2) {
        acc[i][e] += __shfl_xor_sync(0xffffffffu, acc[i][e], 1);
        acc[i][e] += __shfl_xor_sync(0xffffffffu, acc[i][e], 2);
      }
  }
  // lane (g, t) holds its 16 columns' sums (acc[i][0]: column 2i, acc[i][2]:
  // 2i + 1; the same in every t): it writes columns 4t .. 4t + 3 of them
  float4 mine = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int i = 0; i < 8; i += 2)
    if ((i >> 1) == t) mine = make_float4(acc[i][0], acc[i][2], acc[i + 1][0], acc[i + 1][2]);
  red[warp * (BN / 4) + 4 * g + t] = mine;
  __syncthreads();
  if (warp != 0) return;

  // warp 0: lane l adds columns 4l .. 4l + 3 over the warps, in warp order
  const int nc = n0 + 4 * lane;
  const bool ok = nc < N;
  float4 sum = red[lane];
#pragma unroll
  for (int w = 1; w < WARPS; ++w) {
    const float4 v = red[w * (BN / 4) + lane];
    sum.x += v.x;
    sum.y += v.y;
    sum.z += v.z;
    sum.w += v.w;
  }
  if (gridDim.y == 1) {
    if (ok) *reinterpret_cast<float4*>(out + nc) = sum;
    return;
  }
  if (ok) *reinterpret_cast<float4*>(partial + (size_t)blockIdx.y * N + nc) = sum;
  __threadfence();
  __syncwarp();
  int last = 0;
  if (lane == 0) last = atomicAdd(counters + blockIdx.x, 1) == (int)gridDim.y - 1;
  last = __shfl_sync(0xffffffffu, last, 0);
  if (!last) return;
  // the tile's last block: every split's partial, added in split order, the
  // loads of 8 splits in flight at once
  __threadfence();
  if (ok) {
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int y0 = 0; y0 < (int)gridDim.y; y0 += 8) {
      float4 v[8];
#pragma unroll
      for (int q = 0; q < 8; ++q)
        if (y0 + q < (int)gridDim.y)
          v[q] = __ldcg(reinterpret_cast<const float4*>(partial + (size_t)(y0 + q) * N + nc));
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        if (y0 + q >= (int)gridDim.y) break;
        if (y0 + q == 0) {
          s = v[q];
        } else {
          s.x += v[q].x;
          s.y += v[q].y;
          s.z += v[q].z;
          s.w += v[q].w;
        }
      }
    }
    *reinterpret_cast<float4*>(out + nc) = s;
  }
  if (lane == 0) counters[blockIdx.x] = 0;
}

template <typename ST, bool LIN, bool RS, int NP>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
q4_gemv_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ packed,
               const ST* __restrict__ scales, float* __restrict__ out,
               float* __restrict__ partial, int* __restrict__ counters, int K, int N, int ups) {
  extern __shared__ __align__(16) uint8_t smem[];
  if (N % 16 != 0 || (int)(blockIdx.x + 1) * BN > N)
    gemv_body<ST, LIN, RS, NP, true>(x, packed, scales, out, partial, counters, K, N, ups, smem);
  else
    gemv_body<ST, LIN, RS, NP, false>(x, packed, scales, out, partial, counters, K, N, ups,
                                      smem);
}

// y = x W at M = 1 in one launch: K in `ksplit` ranges of whole units
// (partial [splits, N] scratch and a zeroed counter per 128-column tile
// when there are several).
template <typename ST, bool LIN, bool RS, int NP>
cudaError_t launch(const __nv_bfloat16* x, const int8_t* packed, const ST* scales, float* out,
                   float* partial, int* counters, int K, int N, int ksplit, cudaStream_t st) {
  const int units = K / 32;
  const int ups = (units + ksplit - 1) / ksplit;
  const int splits = (units + ups - 1) / ups;
  if (ups > MAX_UPS || (splits > 1 && (partial == nullptr || counters == nullptr)))
    return cudaErrorInvalidValue;
  const int smem = 64 * ups + WARPS * BN * 4;  // x and the warps' sums: <= 18 KB
  dim3 grid((N + BN - 1) / BN, splits);
  q4_gemv_kernel<ST, LIN, RS, NP>
      <<<grid, THREADS, smem, st>>>(x, packed, scales, out, partial, counters, K, N, ups);
  ++q4gemm::launch_count();
  return cudaGetLastError();
}

}  // namespace gemv

template <typename ST, bool LIN, bool RS, bool WF32>
cudaError_t launch(const __nv_bfloat16* x, const int8_t* packed, const ST* scales, float* out,
                   float* partial, int* counters, int M, int K, int N, int ksplit,
                   cudaStream_t st) {
  // the f32 dot's bf16 parts: two hold q * s exactly for a bf16 scale, three
  // for an f32 one
  constexpr int NP = WF32 ? (sizeof(ST) == 4 ? 3 : 2) : 1;
  if (M == 1)
    return gemv::launch<ST, LIN, RS, NP>(x, packed, scales, out, partial, counters, K, N, ksplit,
                                         st);
  return q4gemm::launch_gemm<ST, LIN, RS, NP>(x, packed, scales, out, partial, M, K, N, ksplit,
                                               st);
}

template <typename ST, bool LIN>
cudaError_t launch_mode(const __nv_bfloat16* x, const int8_t* packed, const void* scales,
                        float* out, float* partial, int* counters, int M, int K, int N,
                        int ksplit, bool rs, bool wf32, cudaStream_t st) {
  auto s = static_cast<const ST*>(scales);
  if (wf32)
    return launch<ST, LIN, false, true>(x, packed, s, out, partial, counters, M, K, N, ksplit,
                                        st);
  if constexpr (sizeof(ST) == 4) {  // a bf16 scale is already on the bf16 grid
    if (rs)
      return launch<ST, LIN, true, false>(x, packed, s, out, partial, counters, M, K, N, ksplit,
                                          st);
  }
  return launch<ST, LIN, false, false>(x, packed, s, out, partial, counters, M, K, N, ksplit,
                                       st);
}

}  // namespace

// Mode bits of q4_matmul_launch.
enum { Q4_SCALE_F32 = 1, Q4_LIN = 2, Q4_ROUND_SCALE = 4, Q4_W_F32 = 8 };

// x bf16 [M, K], packed int8 [K/2, N] (one chunk; ilv, or lin with
// Q4_LIN), scales [G, N] (bf16, or f32 with Q4_SCALE_F32), out f32 [M, N].
// M = 1: partial f32 [splits, N] scratch and counters int32 [ceil(N/128)],
// zeroed (the kernel leaves them zeroed), for the K split; M > 1: partial
// f32 [ksplit, M, N] scratch for the GEMM's split (counters unused).
// Q4_ROUND_SCALE rounds an f32 scale to bf16 (LLAMAVK_Q4_MUL=bf16);
// Q4_W_F32 keeps w = q * s in f32 (LLAMAVK_Q4_DOT=f32); not both.
// Requires K % 32 == 0 (lin: K % 64 == 0), N % 8 == 0 and 16-byte aligned
// pointers (checked by the Python wrapper). Returns cudaGetLastError()
// after the launches.
extern "C" int q4_matmul_launch(const void* x, const void* packed, const void* scales,
                                void* out, void* partial, void* counters, int M, int K, int N,
                                int ksplit, int mode, void* stream) {
  auto xs = static_cast<const __nv_bfloat16*>(x);
  auto pk = static_cast<const int8_t*>(packed);
  auto o = static_cast<float*>(out);
  auto part = static_cast<float*>(partial);
  auto cnt = static_cast<int*>(counters);
  auto st = static_cast<cudaStream_t>(stream);
  const bool f32s = mode & Q4_SCALE_F32, lin = mode & Q4_LIN;
  const bool rs = mode & Q4_ROUND_SCALE, wf32 = mode & Q4_W_F32;
  if (K % 32 != 0 || N % 8 != 0 || M < 1 || ksplit < 1 || (lin && K % 64 != 0) ||
      (rs && wf32) || (mode & ~15))
    return (int)cudaErrorInvalidValue;
  if (f32s)
    return (int)(lin ? launch_mode<float, true>(xs, pk, scales, o, part, cnt, M, K, N, ksplit,
                                                rs, wf32, st)
                     : launch_mode<float, false>(xs, pk, scales, o, part, cnt, M, K, N, ksplit,
                                                 rs, wf32, st));
  return (int)(lin ? launch_mode<__nv_bfloat16, true>(xs, pk, scales, o, part, cnt, M, K, N,
                                                      ksplit, rs, wf32, st)
                   : launch_mode<__nv_bfloat16, false>(xs, pk, scales, o, part, cnt, M, K, N,
                                                       ksplit, rs, wf32, st));
}

// The kernel launches this library has made (q4gemm::launch_count): the
// GEMV's, the GEMM's and its split sums'.
extern "C" long q4_launch_count() { return q4gemm::launch_count().load(); }
