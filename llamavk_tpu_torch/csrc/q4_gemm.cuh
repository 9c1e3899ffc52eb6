// K1's GEMM (M >= 2) for Hopper (sm_90a), included by q4_matmul.cu:
// y[m, n] = sum_k x[m, k] W[k, n], W the packed Q4 weight of one chunk.
//
// Replaces the TPU kernel `_kernel_q4` (llamavk_tpu/ops/q4_matmul.py:96) at
// every M > 1, in every mode of q4_matmul.cu (ilv and lin layouts, bf16 and
// f32 scale planes, LLAMAVK_Q4_MUL=bf16, LLAMAVK_Q4_DOT=f32), and its
// stacked twin `_kernel_q4_stacked` by a pointer offset.
//
// What bounds it on an H100: at M <= 64 (serving decode, verify, lookup,
// small admissions) the weight bytes: 0.5625 B a weight against 3.35 TB/s,
// so the card must be filled with loads in flight; above (prefill,
// admission, perplexity) the operations, 2 M K N against 989 TFLOP/s of
// bf16 tensor cores, so the weights must reach the tensor cores with little
// arithmetic on the way.
//
// Design:
//  * The product runs transposed on `mma.sync` m16n8k16 (bf16 in, f32
//    accumulators): the weights are the A operand (16 output columns an
//    MMA), x the B operand (8 tokens an MMA), so the token side is sized to
//    M in steps of 8. A warp owns 32 output columns (two MMA row tiles) and
//    all the block's tokens; the warps of a block split its columns. Lane l
//    owns
//    columns 4 (l / 4) .. +3 of its warp's: A row tile i, row r (r + 8) is
//    column 4r + 2i (+ 1). So a lane's four columns of one packed row are
//    one 32-bit word, and its accumulators of one token are four
//    consecutive outputs: stores go out as float4, 128 bytes a token row
//    per warp, with no staging.
//  * A unit is 16 packed rows: ilv group g (rows m G + g; the low nibbles
//    k = 32g + m, the high ones 32g + 16 + m, one scale row), or lin rows
//    16u .. 16u + 15 (low nibbles k = 16u + m with scale row u / 2, high
//    nibbles K/2 + 16u + m with scale row G/2 + u/2). Its low nibbles are
//    one MMA k step over 16 consecutive k, its high nibbles a second: the
//    A fragment's pair (k, k + 1) is the same nibble of two neighbouring
//    packed rows, so x stays in its own k order and `ldmatrix` reads it as
//    the `.col` B operand.
//  * Dequantization straight into A fragments in registers
//    (q4_dequant.cuh, shared with the decode GEMV): a byte permute, a mask
//    and an xor to the bf16 136 + q, an exact bf16 subtract, `__hmul2` by a
//    bf16 scale (an f32 scale in f32, rounded once by F2FP);
//    LLAMAVK_Q4_DOT=f32 feeds bf16 parts w0 + w1 (+ w2) of the f32 q * s
//    (over a bf16 scale w1 by an exact `__hfma2`), one MMA pass each into
//    the same accumulators. No bf16 weight tile is written to shared
//    memory.
//  * A ring of `cp.async` stages (16 B copies; 8 B for packed rows when
//    N % 16 != 0) carries x, the packed bytes and the scales of 2 units
//    (64 k) a stage, so the next stages' loads fly while a stage is
//    dequantized and multiplied. Rows are padded (x to 72 bf16, packed
//    rows to 16 bytes past the block's columns), so `ldmatrix` rows and the
//    lanes' packed words fall in distinct banks.
//  * Two routes by M, the threshold fixed at M = 64 (`SMALL_M`; the tilings
//    `Small`, `Large` below):
//    - M <= 64: 256 columns and token tiles of 32 rows, 8 ceil(M/8) of them
//      multiplied; K is split across blocks, the split count a function of
//      (K, N) and the SM count alone (ops/q4_matmul.py::gemm_ksplit: about
//      two blocks an SM), so a row's float order does not depend on how
//      many rows share its batch; the partial sums add in split order
//      (split_sum.cuh).
//    - M > 64: 128 columns and token tiles of 128 rows, so each weight is
//      dequantized ceil(M / 128) times; K is split only where the grid is
//      smaller than the card.
//    wgmma with A from registers, TMA loads and a persistent schedule are
//    the next step, not this kernel.
//
// Numerics (q4_matmul.py:114-121 there): x is bf16, w = q * s formed in f32
// and rounded to bf16 (after the scale under LLAMAVK_Q4_MUL=bf16), the
// products accumulate in f32 on the tensor cores, out is f32. The k order
// of the sum differs from the TPU's; chip_smoke.py holds every shape to
// 2 K 2^-24 max_n sum_k |x w| of the plain version, and the dequantized
// weights bit for bit to `mode_weight`'s.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "mma_ptx.cuh"
#include "q4_dequant.cuh"
#include "split_sum.cuh"

namespace q4gemm {

using ptx::cp16;
using ptx::smem_addr;

constexpr int SMALL_M = 64;  // M <= SMALL_M: the split-K route

// The kernel launches of K1's library (q4_matmul.cu, the one source that
// includes this header): every `<<<>>>` of the GEMM, its split sum and the
// decode GEMV adds one, so a caller can count a call's launches.
namespace {
inline std::atomic<long>& launch_count() {
  static std::atomic<long> n{0};
  return n;
}
}  // namespace

// A route's tiling: WN warps along N (32 output columns each), UPS units
// (16 packed rows, 32 k) a stage, NTMAX n8 token tiles a block, STAGES
// stages in the cp.async ring.
template <int WN_, int UPS_, int NTMAX_, int STAGES_>
struct Cfg {
  static constexpr int WN = WN_, UPS = UPS_, NTMAX = NTMAX_, STAGES = STAGES_;
  static constexpr int THREADS = 32 * WN;
  static constexpr int BN = 32 * WN;           // output columns a block
  static constexpr int XLD = UPS * 32 + 8;     // bf16 elements of an x stage row (+ pad)
  static constexpr int PLD = BN + 16;          // bytes of a packed stage row (+ pad)
  static constexpr int X = 8 * NTMAX * XLD * 2;  // x [8 NTMAX][XLD] bf16
  static constexpr int P = UPS * 16 * PLD;       // packed [16 UPS][PLD] bytes
  template <typename ST>
  static constexpr int S = UPS * 2 * BN * (int)sizeof(ST);  // scales [UPS][lo, hi][BN]
  template <typename ST>
  static constexpr int BYTES = X + P + S<ST>;
};

// The two routes' tilings, chosen on the card (NVIDIA H100 80GB HBM3,
// 700.00 W; PERF.md) among 128, 256 or 512 columns and 32, 64 or 128
// tokens a block, 2 or 4 units a stage and 2-6 stages:
//  * M <= 64: 256 columns, 32 tokens (M = 33..64 takes two token tiles), 4
//    stages;
//  * M > 64: 128 columns, 128 tokens, 3 stages: each weight dequantized
//    ceil(M / 128) times; 512 columns at 64 tokens took ~5% less time.
using Small = Cfg<8, 2, 4, 4>;
using Large = Cfg<4, 2, 16, 3>;

using q4dq::Scale;

// two nibbles of a packed word as the bf16 pair 136 + q
__device__ __forceinline__ uint32_t magic(uint32_t v) { return q4dq::nibbles_to_magic<true>(v); }

// A fragments [k step: low, high nibbles][row tile][4] of one unit from the
// lane's packed words w[0..3] (rows 2t, 2t + 1, 2t + 8, 2t + 9 of the unit,
// t = lane % 4; byte c = column 4 (lane / 4) + c) and its columns' scales
// (lo: the low nibbles', hi: the high nibbles').
template <typename ST, bool RS, int NP>
__device__ __forceinline__ void dequant(uint32_t (&a)[2][2][4], const uint32_t (&w)[4],
                                        const Scale (&s_lo)[4], const Scale (&s_hi)[4], int p) {
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const uint32_t v01 = __byte_perm(w[0], w[1], q4dq::pair_sel(c));  // rows 2t, 2t + 1
    const uint32_t v89 = __byte_perm(w[2], w[3], q4dq::pair_sel(c));
    const int i = c >> 1, hh = c & 1;
    a[0][i][hh] = q4dq::weight_pair<ST, RS, NP, true>(magic(v01), s_lo[c], p);
    a[0][i][hh + 2] = q4dq::weight_pair<ST, RS, NP, true>(magic(v89), s_lo[c], p);
    a[1][i][hh] = q4dq::weight_pair<ST, RS, NP, true>(magic(v01 >> 4), s_hi[c], p);
    a[1][i][hh + 2] = q4dq::weight_pair<ST, RS, NP, true>(magic(v89 >> 4), s_hi[c], p);
  }
}

// the lane's 4 column scales from shared memory (an f32 plane's rounded to
// bf16 for the bf16 multiply under RS)
template <bool RS>
__device__ __forceinline__ void scales4(const __nv_bfloat16* p, Scale (&s)[4]) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
#pragma unroll
  for (int c = 0; c < 4; ++c) s[c] = q4dq::scale_bf16(c < 2 ? v.x : v.y, c & 1);
}

template <bool RS>
__device__ __forceinline__ void scales4(const float* p, Scale (&s)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  const float f[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int c = 0; c < 4; ++c) s[c] = q4dq::scale_f32<RS, true>(f[c]);
}

// One stage's copies: units [u0, u0 + UPS) (those < u_end) of the block's
// columns, and x's token rows [m_blk, m_blk + xrows) at their k; whatever
// lies outside the unit range, N or M is zero-filled.
template <typename C, typename ST, bool LIN>
__device__ __forceinline__ void load_stage(uint8_t* stage, const __nv_bfloat16* x,
                                           const int8_t* packed, const ST* scales, int M, int K,
                                           int N, int m_blk, int n_blk, int u0, int u_end,
                                           int xrows) {
  constexpr int UPS = C::UPS, BN = C::BN;
  const int G = K / 32;
  const uint32_t xs = smem_addr(stage), ps = xs + C::X, ss = ps + C::P;
  // a packed row starts 16-byte aligned when N % 16 == 0, else 8-byte.
  // Each thread keeps one 16-byte column chunk of the rows it copies.
  constexpr int PC = BN / 16;  // chunks a packed row
  static_assert(C::THREADS % PC == 0 && C::THREADS % (4 * UPS) == 0, "chunks per thread");
  const bool al16 = N % 16 == 0;
  {
    const int c = threadIdx.x % PC;
    const int n = n_blk + 16 * c;
    for (int row = threadIdx.x / PC; row < UPS * 16; row += C::THREADS / PC) {
      const int u = u0 + (row >> 4), rho = row & 15;
      const size_t grow = LIN ? (size_t)16 * u + rho : (size_t)rho * G + u;
      const uint32_t dst = ps + row * C::PLD + 16 * c;
      if (al16) {
        const bool ok = u < u_end && n < N;
        cp16(dst, ok ? packed + grow * N + n : packed, ok ? 16 : 0);
      } else {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const bool ok = u < u_end && n + 8 * h < N;
          ptx::cp8(dst + 8 * h, ok ? packed + grow * N + n + 8 * h : packed, ok ? 8 : 0);
        }
      }
    }
  }
  constexpr int PER = 16 / (int)sizeof(ST);  // scales a 16-byte chunk
  constexpr int ROWS = LIN ? 2 : 1;          // scale rows a unit: lo (and hi)
  for (int e = threadIdx.x; e < UPS * ROWS * (BN / PER); e += C::THREADS) {
    const int r = e / (BN / PER), c = e % (BN / PER);
    const int j = r / ROWS, h = r % ROWS;
    const int u = u0 + j;
    const int n = n_blk + PER * c;
    const bool ok = u < u_end && n < N;
    const int srow = LIN ? (h ? G / 2 + u / 2 : u / 2) : u;
    cp16(ss + ((j * 2 + h) * BN + PER * c) * (int)sizeof(ST),
         ok ? scales + (size_t)srow * N + n : scales, ok ? 16 : 0);
  }
  // x: 4 UPS chunks of 8 k a row. ilv: k 32 u0 + 8c; lin: the low halves'
  // k 16 u0 + 8c (c < 2 UPS), then the high halves' K/2 + 16 u0 + ...
  constexpr int XC = 4 * UPS;
  const int c = threadIdx.x % XC;
  const int cl = c % (2 * UPS);
  const int j = LIN ? cl >> 1 : c >> 2;
  const int k = LIN ? (c < 2 * UPS ? 0 : K / 2) + 16 * u0 + 8 * cl : 32 * u0 + 8 * c;
  const bool uok = u0 + j < u_end;
  const __nv_bfloat16* xk = x + (size_t)m_blk * K + k;
  for (int t = threadIdx.x / XC; t < xrows; t += C::THREADS / XC) {
    const bool ok = uok && m_blk + t < M;
    cp16(xs + (t * C::XLD + 8 * c) * 2, ok ? xk + (size_t)t * K : x, ok ? 16 : 0);
  }
}

// The MMAs of one unit j of a stage: the lane's words and scales from
// shared memory, dequantized per part p into A fragments, against nt n8
// tiles of x.
template <typename C, typename ST, bool LIN, bool RS, int NP>
__device__ __forceinline__ void unit_mma(float (&acc)[2][C::NTMAX][4], const uint8_t* stage,
                                         int j, int nt, int wn, int lane) {
  constexpr int NTMAX = C::NTMAX, PLD = C::PLD;
  const int g = lane >> 2, t = lane & 3;
  const uint8_t* pw = stage + C::X + (16 * j) * PLD + wn * 32 + 4 * g;
  uint32_t w[4];
  w[0] = *reinterpret_cast<const uint32_t*>(pw + (2 * t) * PLD);
  w[1] = *reinterpret_cast<const uint32_t*>(pw + (2 * t + 1) * PLD);
  w[2] = *reinterpret_cast<const uint32_t*>(pw + (2 * t + 8) * PLD);
  w[3] = *reinterpret_cast<const uint32_t*>(pw + (2 * t + 9) * PLD);
  const ST* sp = reinterpret_cast<const ST*>(stage + C::X + C::P) + (2 * j) * C::BN + wn * 32 +
                 4 * g;
  Scale s_lo[4], s_hi[4];
  scales4<RS>(sp, s_lo);
  scales4<RS>(LIN ? sp + C::BN : sp, s_hi);
  // x columns of the unit's low and high nibbles in the stage row
  const int kc[2] = {LIN ? 16 * j : 32 * j, LIN ? 16 * C::UPS + 16 * j : 32 * j + 16};
  const uint32_t xs = smem_addr(stage);
  const int q = lane >> 3;  // the ldmatrix tile whose row this lane addresses
#pragma unroll
  for (int p = 0; p < NP; ++p) {
    uint32_t a[2][2][4];
    dequant<ST, RS, NP>(a, w, s_lo, s_hi, p);
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
#pragma unroll
      for (int jp = 0; jp < NTMAX / 2; ++jp) {
        if (2 * jp < nt) {
          // tiles: n8 tile 2jp (k 0-7, 8-15), n8 tile 2jp + 1 (k 0-7, 8-15)
          const int row = 8 * (2 * jp + (q >> 1)) + (lane & 7);
          uint32_t b[4];
          ptx::ldsm4(b, xs + (row * C::XLD + kc[ks] + 8 * (q & 1)) * 2);
          ptx::mma16816(acc[0][2 * jp], a[ks][0], b[0], b[1]);
          ptx::mma16816(acc[1][2 * jp], a[ks][1], b[0], b[1]);
          if (2 * jp + 1 < nt) {
            ptx::mma16816(acc[0][2 * jp + 1], a[ks][0], b[2], b[3]);
            ptx::mma16816(acc[1][2 * jp + 1], a[ks][1], b[2], b[3]);
          }
        }
      }
    }
  }
}

// Block (column tile x, token tile y, K split z): units [z ups, (z + 1) ups)
// of columns [BN x, BN x + BN) and tokens [8 NTMAX y, ...), written to
// out + z M N (the partial sums of split z, or out itself for one split).
template <typename C, typename ST, bool LIN, bool RS, int NP>
__device__ __forceinline__ void gemm_body(const __nv_bfloat16* __restrict__ x,
                                          const int8_t* __restrict__ packed,
                                          const ST* __restrict__ scales, float* __restrict__ out,
                                          int M, int K, int N, int ups) {
  constexpr int NTMAX = C::NTMAX, STAGES = C::STAGES, UPS = C::UPS;
  constexpr int SB = C::template BYTES<ST>;
  extern __shared__ __align__(16) uint8_t smem[];
  const int wn = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_blk = blockIdx.x * C::BN;
  const int m_blk = blockIdx.y * 8 * NTMAX;
  const int nt = min(NTMAX, (M - m_blk + 7) / 8);
  const int u_begin = blockIdx.z * ups;
  const int u_end = min(K / 32, u_begin + ups);
  const int nst = (u_end - u_begin + UPS - 1) / UPS;

  float acc[2][NTMAX][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NTMAX; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nst)
      load_stage<C, ST, LIN>(smem + s * SB, x, packed, scales, M, K, N, m_blk, n_blk,
                             u_begin + s * UPS, u_end, 8 * nt);
    ptx::cp_commit();
  }
  for (int st = 0; st < nst; ++st) {
    ptx::cp_wait<STAGES - 2>();  // stage st has landed, for this thread
    __syncthreads();             // ... for every thread; stage st - 1 is consumed
    const int nx = st + STAGES - 1;
    if (nx < nst)
      load_stage<C, ST, LIN>(smem + (nx % STAGES) * SB, x, packed, scales, M, K, N, m_blk,
                             n_blk, u_begin + nx * UPS, u_end, 8 * nt);
    ptx::cp_commit();
    const uint8_t* stage = smem + (st % STAGES) * SB;
    const int u0 = u_begin + st * UPS;
#pragma unroll
    for (int j = 0; j < UPS; ++j)
      if (u0 + j < u_end) unit_mma<C, ST, LIN, RS, NP>(acc, stage, j, nt, wn, lane);
  }

  // token 8j + 2t + e of the tile holds columns 4g .. 4g + 3 of the warp's
  const int g = lane >> 2, t = lane & 3;
  const int n = n_blk + wn * 32 + 4 * g;
  if (n >= N) return;
  float* dst = out + (size_t)blockIdx.z * M * N;
#pragma unroll
  for (int j = 0; j < NTMAX; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int m = m_blk + 8 * j + 2 * t + e;
      if (j < nt && m < M)
        *reinterpret_cast<float4*>(dst + (size_t)m * N + n) =
            make_float4(acc[0][j][e], acc[0][j][2 + e], acc[1][j][e], acc[1][j][2 + e]);
    }
  }
}

template <typename C, typename ST, bool LIN, bool RS, int NP>
__global__ void __launch_bounds__(C::THREADS)
q4_gemm_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ packed,
               const ST* __restrict__ scales, float* __restrict__ out, int M, int K, int N,
               int ups) {
  gemm_body<C, ST, LIN, RS, NP>(x, packed, scales, out, M, K, N, ups);
}

// One launch of the route's kernel over `splits` K ranges of `ups` units.
template <typename C, typename ST, bool LIN, bool RS, int NP>
cudaError_t run(const __nv_bfloat16* x, const int8_t* packed, const ST* scales, float* dst,
                int M, int K, int N, int ups, int splits, cudaStream_t st) {
  constexpr int smem = C::STAGES * C::template BYTES<ST>;
  static bool allowed = false;
  auto kernel = q4_gemm_kernel<C, ST, LIN, RS, NP>;
  if (!allowed) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    allowed = true;
  }
  dim3 grid((N + C::BN - 1) / C::BN, (M + 8 * C::NTMAX - 1) / (8 * C::NTMAX), splits);
  kernel<<<grid, C::THREADS, smem, st>>>(x, packed, scales, dst, M, K, N, ups);
  ++launch_count();
  return cudaGetLastError();
}

// y = x W for M >= 2: the route by M, K split in `ksplit` ranges of whole
// units (partial [splits, M, N] scratch, summed in split order into out).
template <typename ST, bool LIN, bool RS, int NP>
cudaError_t launch_gemm(const __nv_bfloat16* x, const int8_t* packed, const ST* scales,
                        float* out, float* partial, int M, int K, int N, int ksplit,
                        cudaStream_t st) {
  const int U = K / 32;
  const int ups = (U + ksplit - 1) / ksplit;
  const int splits = (U + ups - 1) / ups;
  float* dst = splits == 1 ? out : partial;
  const cudaError_t e =
      M <= SMALL_M ? run<Small, ST, LIN, RS, NP>(x, packed, scales, dst, M, K, N, ups, splits, st)
                   : run<Large, ST, LIN, RS, NP>(x, packed, scales, dst, M, K, N, ups, splits, st);
  if (e != cudaSuccess || splits == 1) return e;
  launch_split_sum<float, float>(partial, out, splits, M * N, st);
  ++launch_count();
  return cudaGetLastError();
}

}  // namespace q4gemm
