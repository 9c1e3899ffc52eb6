// K5, the Q4_0 matmul with int8 activations, for Hopper (sm_90a):
//   y[m, n] = sum_g (float(d[g, m, n]) * sx[m, g]) * s[g, n],
//   d[g, m, n] = sum_{i<32} xq[m, 32g + i] * w[32g + i, n]   (exact, int32).
//
// Replaces the TPU kernel `_kernel_q4_i8` (llamavk_tpu/ops/q4_matmul.py:226)
// and its stacked twin `_kernel_q4_i8_stacked` (:264), which the JAX package
// takes under LLAMAVK_Q4_DOT=i8 for batches of up to 64 rows (decode,
// lookup verify, a batched decode step, a perplexity chunk of 64). A stacked
// layer arrives as a pointer offset into the [L, K/2, N] plane.
//
// Launches:
//  * `quantize_kernel`: one warp per (row, 32-block): amax by warp
//    reduction, sx = amax * f32(1/127) (1 for an all-zero block: the JAX
//    package's `amax / 127.0`, which XLA compiles as a multiplication by the
//    reciprocal), q = round-half-even(x / sx) (a true division) clipped to
//    +-127. xq [M, K] int8 in original k order, sx [M, G] f32.
//  * `i8_mma_kernel`: the group dot on the int8 tensor cores, then (K split
//    across blocks) the in-order split sum of split_sum.cuh.
//
// What bounds it on an H100: the weight bytes (K/2 * N packed + G * N scale
// bytes a call against 3.35 TB/s: 0.003-0.022 ms at the 7B shapes); the
// int8 operations (2 M K N at 1,979 TOP/s) stay under 0.01 ms even at
// M = 64. What a CUDA-core design pays instead is the arithmetic: 8 dp4a
// and the unpack of each weight once per 8 rows. Past M = 16 what is left
// is the fold: four f32 operations per output and group (M N G of them).
// Here:
//  * One `mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32` is one Q4_0
//    group: the weights are the A operand (16 output columns on the
//    instruction's M side), the tokens the B operand (8 a tile), so M = 1,
//    8, 32, 64 take 1, 1, 4, 8 token tiles. A warp owns 32 columns (two A
//    row tiles: row tile i, row r (r + 8) is column 4r + 2i (+ 1), as in
//    q4_gemm.cuh) and every token of the call, so each packed byte and
//    scale is unpacked once per call; the warps of a block split its
//    columns, blocks split N and K.
//  * The ilv layout fits the fragment: packed row j G + g (j < 16) holds
//    k = 32g + j in its low nibble and 32g + 16 + j in its high one, so lane
//    (gid, tig) takes a0 / a1 (k = 4 tig .. + 3) from the low nibbles of
//    packed rows 4 tig .. 4 tig + 3 and a2 / a3 (k = 16 + 4 tig ..) from the
//    high nibbles of the same four bytes. It reads one 32-bit word (its 4
//    columns) of each of those rows, transposes them with __byte_perm, and
//    places each nibble in the high half of its byte (a mask, and a shift
//    for the low nibbles): the signed byte 16 q. The B fragment is two
//    32-bit words of row-major xq (k = 32g + 4 tig .., 32g + 16 + 4 tig ..).
//    No widened weight tile is written to shared memory.
//  * The accumulator starts at the bits of 786432.0f, whose ulp is 1/16, so
//    the tensor core's int32 sum 16 d + bits(786432) read as a float is
//    786432 + d exactly (|d| <= 32 * 127 * 8), and one subtraction gives
//    float(d) with no integer-to-float conversion.
//  * A `cp.async` ring (STAGES stages of UPS groups: 16 packed rows of the
//    block's columns a group, their scales, xq's and sx's token rows) keeps
//    the next stages' loads in flight while a stage is multiplied. A
//    group's 16 packed rows lie G N bytes apart (rows j G + g), and a
//    stage's groups are neighbouring rows; each lands in its own padded
//    shared row, placed so that the four rows a lane reads fall in distinct
//    banks.
//
// Float order: each output element has one owner (a lane of one block of
// its K split), which folds its groups in ascending order,
// acc = acc + (float(d) * sx) * s with __fmul_rn/__fadd_rn (no FMA
// contraction), the plain version's `(d * sx) * s`. The K split is a
// function of (K, N) alone (ops/q4_matmul.py::ksplit_i8) and the split
// partials add in split order. The kernel variant (NT token tiles, chosen
// from M) changes none of it, so a row of y is bit-equal whether it is
// computed alone or among up to 64 rows.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_ptx.cuh"
#include "split_sum.cuh"

namespace {

using ptx::cp16;
using ptx::smem_addr;

constexpr int QK = 32;
constexpr int UPS = 4;               // groups a stage
constexpr int XLD = UPS * QK + 16;   // bytes an xq stage row: 4 words past 0 mod 32
constexpr uint32_t MAGIC = 0x49400000u;  // the bits of 786432.0f (ulp 1/16)
constexpr float MAGIC_F = 786432.0f;

// The variant with NT n8 token tiles over scales of type ST: WN warps of 32
// columns a block, a ring of STAGES stages, each stage packed
// [UPS][16][PLD] bytes, scales [UPS][BN], xq [8 NT][XLD] bytes and sx
// [UPS][8 NT] f32. Chosen on the card (NVIDIA H100 80GB HBM3, 700.00 W;
// PERF.md) among 128 or 256 columns and 2-6 stages of 4 or 8 groups: the
// time follows how close the grid comes to one full wave of resident
// blocks. At M <= 16, 128 columns and 3 stages (five or six blocks an SM
// at M <= 8); at M > 16, where the fold's f32 arithmetic dominates, 256
// columns and two blocks an SM, so that ksplit_i8's grid (about 264 blocks
// of 256 columns) is close to one wave.
template <typename ST, int NT>
struct Cfg {
  static constexpr int WN = NT >= 4 ? 8 : 4;
  static constexpr int STAGES = NT == 4 ? 4 : 3;
  static constexpr int THREADS = 32 * WN;
  static constexpr int BN = 32 * WN;       // output columns a block
  static constexpr int PLD = BN + 32;      // bytes a packed stage row: 8 words past 0 mod 32
  static constexpr int P = UPS * 16 * PLD;
  static constexpr int S = UPS * BN * (int)sizeof(ST);
  static constexpr int X = 8 * NT * XLD;
  static constexpr int SX = UPS * 8 * NT * 4;
  static constexpr int BYTES = P + S + X + SX;
};

// x bf16 [M, K] -> xq int8 [M, K], sx f32 [M, G]; one warp per 32-block
__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

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

// d = a b + c on the int8 tensor cores, every element of c the same value
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1, uint32_t c) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "r"(c));
}

// the 4 column scales at `p` as f32
__device__ __forceinline__ void scales4(const __nv_bfloat16* p, float (&s)[4]) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  s[0] = __uint_as_float(v.x << 16);
  s[1] = __uint_as_float(v.x & 0xffff0000u);
  s[2] = __uint_as_float(v.y << 16);
  s[3] = __uint_as_float(v.y & 0xffff0000u);
}

__device__ __forceinline__ void scales4(const float* p, float (&s)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  s[0] = v.x;
  s[1] = v.y;
  s[2] = v.z;
  s[3] = v.w;
}

// acc + (float(d) * sx) * s, d read off the magic-biased accumulator
__device__ __forceinline__ float fold(float acc, int d, float sx, float s) {
  const float df = __fsub_rn(__int_as_float(d), MAGIC_F);
  return __fadd_rn(acc, __fmul_rn(__fmul_rn(df, sx), s));
}

// One stage's copies: groups [g0, g0 + UPS) (those < g_end) of the block's
// columns [n_blk, n_blk + BN), and xq's and sx's rows m < M at those groups.
// Packed row j of stage group u lands on shared row 16u + 4 (j % 4) + j / 4;
// what lies past N or g_end is zero-filled, token rows past M are not
// copied (their sums are never stored).
template <typename ST, int NT>
__device__ __forceinline__ void load_stage(uint8_t* stage, const int8_t* xq, const float* sx,
                                           const int8_t* packed, const ST* scales, int M, int K,
                                           int N, int n_blk, int g0, int g_end) {
  using C = Cfg<ST, NT>;
  constexpr int BN = C::BN, PLD = C::PLD, THREADS = C::THREADS;
  const int G = K / QK;
  const uint32_t ps = smem_addr(stage), ss = ps + C::P, xs = ss + C::S, sxs = xs + C::X;
  // a packed row starts 16-byte aligned when N % 16 == 0, else 8-byte
  constexpr int PC = BN / 16;  // 16-byte chunks a packed row
  const bool al16 = N % 16 == 0;
  for (int e = threadIdx.x; e < UPS * 16 * PC; e += THREADS) {
    const int c = e % PC, row = e / PC;
    const int u = row >> 4, j = row & 15;
    const int g = g0 + u, n = n_blk + 16 * c;
    const uint32_t dst = ps + (16 * u + 4 * (j & 3) + (j >> 2)) * PLD + 16 * c;
    const int8_t* src = packed + ((size_t)j * G + g) * N + n;
    if (al16) {
      const bool ok = g < g_end && n < N;
      cp16(dst, ok ? src : packed, ok ? 16 : 0);
    } else {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const bool ok = g < g_end && n + 8 * h < N;
        ptx::cp8(dst + 8 * h, ok ? src + 8 * h : packed, ok ? 8 : 0);
      }
    }
  }
  constexpr int PER = 16 / (int)sizeof(ST);  // scales a 16-byte chunk
  for (int e = threadIdx.x; e < UPS * (BN / PER); e += THREADS) {
    const int u = e / (BN / PER), c = e % (BN / PER);
    const int g = g0 + u, n = n_blk + PER * c;
    const bool ok = g < g_end && n < N;
    cp16(ss + (u * BN + PER * c) * (int)sizeof(ST), ok ? scales + (size_t)g * N + n : scales,
         ok ? 16 : 0);
  }
  constexpr int XC = UPS * QK / 16;  // 16-byte chunks an xq stage row
  for (int e = threadIdx.x; e < 8 * NT * XC; e += THREADS) {
    const int t = e / XC, c = e % XC;
    if (t >= M) break;
    const bool ok = g0 + c / 2 < g_end;
    cp16(xs + t * XLD + 16 * c, ok ? xq + (size_t)t * K + (size_t)QK * g0 + 16 * c : xq,
         ok ? 16 : 0);
  }
  for (int e = threadIdx.x; e < UPS * 8 * NT; e += THREADS) {
    const int u = e / (8 * NT), t = e % (8 * NT);
    if (t < M && g0 + u < g_end) ptx::cp4(sxs + 4 * e, sx + (size_t)t * G + g0 + u, 4);
  }
}

// Group u of a stage for the warp's 32 columns and the nt token tiles:
// acc[t][e][c] is token 8t + 2 tig + e, column 4 gid + c of the warp's.
template <typename ST, int NT>
__device__ __forceinline__ void group_mma(float (&acc)[NT][2][4], const uint8_t* stage, int u,
                                          int nt, int warp, int lane) {
  using C = Cfg<ST, NT>;
  constexpr int PLD = C::PLD;
  const int gid = lane >> 2, tig = lane & 3;
  // packed rows 4 tig + r (bytes: columns 4 gid .. + 3) at shared rows 16u + 4r + tig
  const uint8_t* pw = stage + (16 * u + tig) * PLD + 32 * warp + 4 * gid;
  uint32_t w[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) w[r] = *reinterpret_cast<const uint32_t*>(pw + 4 * r * PLD);
  // col[c]: column 4 gid + c's bytes of rows 4 tig .. 4 tig + 3, in k order
  const uint32_t ab_lo = __byte_perm(w[0], w[1], 0x5140), ab_hi = __byte_perm(w[0], w[1], 0x7362);
  const uint32_t cd_lo = __byte_perm(w[2], w[3], 0x5140), cd_hi = __byte_perm(w[2], w[3], 0x7362);
  const uint32_t col[4] = {__byte_perm(ab_lo, cd_lo, 0x5410), __byte_perm(ab_lo, cd_lo, 0x7632),
                           __byte_perm(ab_hi, cd_hi, 0x5410), __byte_perm(ab_hi, cd_hi, 0x7632)};
  // A row tile i: rows gid (column 4 gid + 2i) and gid + 8 (4 gid + 2i + 1);
  // each nibble as the signed byte 16 q
  uint32_t a[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    a[i][0] = (col[2 * i] << 4) & 0xF0F0F0F0u;
    a[i][1] = (col[2 * i + 1] << 4) & 0xF0F0F0F0u;
    a[i][2] = col[2 * i] & 0xF0F0F0F0u;
    a[i][3] = col[2 * i + 1] & 0xF0F0F0F0u;
  }
  float s[4];
  scales4(reinterpret_cast<const ST*>(stage + C::P) + u * C::BN + 32 * warp + 4 * gid, s);
  const uint8_t* xb = stage + C::P + C::S + gid * XLD + QK * u + 4 * tig;
  const float* sxp =
      reinterpret_cast<const float*>(stage + C::P + C::S + C::X) + u * 8 * NT + 2 * tig;
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    if (t < nt) {
      const uint32_t b0 = *reinterpret_cast<const uint32_t*>(xb + 8 * t * XLD);
      const uint32_t b1 = *reinterpret_cast<const uint32_t*>(xb + 8 * t * XLD + 16);
      int d[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) mma_s8(d[i], a[i], b0, b1, MAGIC);
      const float2 sxv = *reinterpret_cast<const float2*>(sxp + 8 * t);
      const float sxe[2] = {sxv.x, sxv.y};
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          acc[t][e][2 * i] = fold(acc[t][e][2 * i], d[i][e], sxe[e], s[2 * i]);
          acc[t][e][2 * i + 1] = fold(acc[t][e][2 * i + 1], d[i][2 + e], sxe[e], s[2 * i + 1]);
        }
    }
  }
}

// Block (column tile x, K split y): groups [y gps, (y + 1) gps) of columns
// [BN x, BN x + BN) for all M rows, written to out + y M N (the partial sums
// of split y, or out itself for one split).
template <typename ST, int NT>
__global__ void __launch_bounds__(Cfg<ST, NT>::THREADS)
i8_mma_kernel(const int8_t* __restrict__ xq, const float* __restrict__ sx,
              const int8_t* __restrict__ packed, const ST* __restrict__ scales,
              float* __restrict__ out, int M, int K, int N, int gps) {
  using C = Cfg<ST, NT>;
  constexpr int STAGES = C::STAGES, SB = C::BYTES;
  extern __shared__ __align__(16) uint8_t smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_blk = blockIdx.x * C::BN;
  const int g_begin = blockIdx.y * gps;
  const int g_end = min(K / QK, g_begin + gps);
  const int nst = (g_end - g_begin + UPS - 1) / UPS;
  const int nt = (M + 7) / 8;

  float acc[NT][2][4];
#pragma unroll
  for (int t = 0; t < NT; ++t)
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[t][e][c] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nst)
      load_stage<ST, NT>(smem + s * SB, xq, sx, packed, scales, M, K, N, n_blk,
                         g_begin + s * UPS, g_end);
    ptx::cp_commit();
  }
  for (int st = 0; st < nst; ++st) {
    ptx::cp_wait<STAGES - 2>();  // stage st has landed, for this thread
    __syncthreads();             // ... for every thread; stage st - 1 is consumed
    const int nx = st + STAGES - 1;
    if (nx < nst)
      load_stage<ST, NT>(smem + (nx % STAGES) * SB, xq, sx, packed, scales, M, K, N, n_blk,
                         g_begin + nx * UPS, g_end);
    ptx::cp_commit();
    const uint8_t* stage = smem + (st % STAGES) * SB;
    const int g0 = g_begin + st * UPS;
    if (g0 + UPS <= g_end) {
#pragma unroll
      for (int u = 0; u < UPS; ++u) group_mma<ST, NT>(acc, stage, u, nt, warp, lane);
    } else {
      for (int u = 0; g0 + u < g_end; ++u) group_mma<ST, NT>(acc, stage, u, nt, warp, lane);
    }
  }

  const int n = n_blk + 32 * warp + 4 * (lane >> 2);
  if (n >= N) return;
  float* dst = out + (size_t)blockIdx.y * M * N;
  const int tig = lane & 3;
#pragma unroll
  for (int t = 0; t < NT; ++t)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int m = 8 * t + 2 * tig + e;
      if (t < nt && m < M)
        *reinterpret_cast<float4*>(dst + (size_t)m * N + n) =
            make_float4(acc[t][e][0], acc[t][e][1], acc[t][e][2], acc[t][e][3]);
    }
}

// One launch of the NT-tile variant over `splits` K ranges of `gps` groups.
template <typename ST, int NT>
cudaError_t run(const int8_t* xq, const float* sx, const int8_t* packed, const ST* scales,
                float* dst, int M, int K, int N, int gps, int splits, cudaStream_t st) {
  using C = Cfg<ST, NT>;
  constexpr int smem = C::STAGES * C::BYTES;
  static bool allowed = false;
  auto kernel = i8_mma_kernel<ST, NT>;
  if (!allowed) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    allowed = true;
  }
  dim3 grid((N + C::BN - 1) / C::BN, splits);
  kernel<<<grid, C::THREADS, smem, st>>>(xq, sx, packed, scales, dst, M, K, N, gps);
  return cudaGetLastError();
}

template <typename ST>
cudaError_t run_tiles(int tiles, const int8_t* xq, const float* sx, const int8_t* packed,
                      const ST* scales, float* dst, int M, int K, int N, int gps, int splits,
                      cudaStream_t st) {
  switch (tiles) {
    case 1: return run<ST, 1>(xq, sx, packed, scales, dst, M, K, N, gps, splits, st);
    case 2: return run<ST, 2>(xq, sx, packed, scales, dst, M, K, N, gps, splits, st);
    case 4: return run<ST, 4>(xq, sx, packed, scales, dst, M, K, N, gps, splits, st);
    default: return run<ST, 8>(xq, sx, packed, scales, dst, M, K, N, gps, splits, st);
  }
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
// scale_f32 != 0) -> out f32 [M, N], by the variant of `tiles` n8 token
// tiles (1, 2, 4 or 8; M <= 8 tiles); partial f32 [splits, M, N] scratch when
// the K split (`ksplit` ranges of whole groups) has more than one range.
// Requires K % 32 == 0, N % 8 == 0, 16-byte aligned pointers (checked by the
// Python wrapper).
extern "C" int q4_i8_matmul_launch(const void* xq, const void* sx, const void* packed,
                                   const void* scales, void* out, void* partial, int M, int K,
                                   int N, int ksplit, int tiles, int scale_f32, void* stream) {
  if (M < 1 || K % QK != 0 || N % 8 != 0 || ksplit < 1) return (int)cudaErrorInvalidValue;
  if ((tiles != 1 && tiles != 2 && tiles != 4 && tiles != 8) || M > 8 * tiles)
    return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  const int G = K / QK;
  const int gps = (G + ksplit - 1) / ksplit;
  const int splits = (G + gps - 1) / gps;
  float* dst = splits == 1 ? static_cast<float*>(out) : static_cast<float*>(partial);
  auto xqp = static_cast<const int8_t*>(xq);
  auto sxp = static_cast<const float*>(sx);
  auto pk = static_cast<const int8_t*>(packed);
  const cudaError_t e =
      scale_f32 ? run_tiles<float>(tiles, xqp, sxp, pk, static_cast<const float*>(scales), dst,
                                   M, K, N, gps, splits, st)
                : run_tiles<__nv_bfloat16>(tiles, xqp, sxp, pk,
                                           static_cast<const __nv_bfloat16*>(scales), dst, M, K,
                                           N, gps, splits, st);
  if (e != cudaSuccess || splits == 1) return (int)e;
  launch_split_sum<float, float>(static_cast<const float*>(partial), static_cast<float*>(out),
                                 splits, M * N, st);
  return (int)cudaGetLastError();
}
