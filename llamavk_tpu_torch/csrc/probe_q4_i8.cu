// Probes of the int8 tensor cores for Hopper (sm_90a): the precursor of K5's
// tensor-core group dot (csrc/q4_matmul_i8.cu).
//
// Replaces the TPU probe kernels `tools/bench_int8_mxu.py::kernel_i8_batched`
// :66 (P2, int8 and bf16 dots) and `tools/bench_unpack2.py::kernel_i8dot2d`
// :171 (P3). P2's `kernel_current` is K1 (csrc/q4_matmul.cu) on the same
// bytes in K1's layout.
//
// * The group dot (P2): y[b, n] = sum_g s[g, n] * sx[g, b] * D[g, b, n], with
//   D[g, b, n] = sum_j xq[g, b, j] * W[g*32 + j, n], exact in int32. xq int8
//   [G, 8, 32] (8 rows), the weights p int8 [G*16, N] in gm order (byte row
//   g*16 + m holds j = m in its low nibble and j = m + 16 in its high one),
//   s f32 [G, N], sx f32 [G, 8]; D is folded as (f32(D) * s) * sx, the JAX
//   probe's order, and summed over g in f32.
//   One `mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32` is one Q4 block of
//   16 columns for the 8 rows: N on the instruction's M side (16 columns a
//   warp) and the rows on its n = 8 side, so no row is padding. The bf16
//   variant runs the same structure on `m16n8k16` bf16 (two k steps a
//   block, the low and the high nibbles), whose f32 sums of small integers
//   are exact too.
// * i8dot2d (P3): out f32 [R, N] = f32(xq [R, K] int8 @ w8 [K, N] int8),
//   the sum exact in int32, on the same instruction, R a multiple of 8.
//
// What bounds them: weight bytes (K*N/2 packed bytes, or K*N int8 for
// i8dot2d) at M = 8; the int8 operations are 1/60 of a byte-bound time.
// Design: 8 warps a block, 128 columns; each step the block stages the weight
// bytes of a few k blocks (16-byte coalesced loads) transposed into shared
// memory, column-major, so that a lane's A fragment (4 consecutive k of one
// column) is one 32-bit read; the nibbles are sign-extended four at a time
// ((n ^ 8) - 8 with __vsub4); xq is read straight from global memory (L1).
// K splits across blocks and a second launch sums the splits in order.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "split_sum.cuh"

namespace {

constexpr int WARPS = 8;
constexpr int COLS = 128;
constexpr int GPS = 4;        // k blocks (groups) staged a step
constexpr int TLD = 16 + 4;   // bytes a column in the group dot's stage
constexpr int KS = 128;       // k staged a step by i8dot2d
constexpr int DLD = KS + 4;   // bytes a column in its stage

__device__ __forceinline__ uint32_t sext_lo4(uint32_t w) {
  return __vsub4((w & 0x0f0f0f0fu) ^ 0x08080808u, 0x08080808u);
}
__device__ __forceinline__ uint32_t sext_hi4(uint32_t w) {
  return __vsub4(((w >> 4) & 0x0f0f0f0fu) ^ 0x08080808u, 0x08080808u);
}

__device__ __forceinline__ void mma_s8(int* d, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// two signed bytes (the low 16 bits of `v`) as a bf16 pair, exactly
__device__ __forceinline__ uint32_t bf16x2_of_s8x2(uint32_t v) {
  const __nv_bfloat162 h = __floats2bfloat162_rn((float)(int8_t)(v & 0xffu),
                                                 (float)(int8_t)((v >> 8) & 0xffu));
  return *reinterpret_cast<const uint32_t*>(&h);
}

// 16 consecutive bytes of row `row` at column n0 of a [rows, N] int8 plane,
// stored transposed: stage[(c) * ld + row] for c < 16 (rows past the plane 0)
__device__ __forceinline__ void stage16(uint8_t* stage, int ld, int row_in_stage,
                                        const int8_t* plane, size_t row, int n0, bool ok) {
  uint4 v = make_uint4(0, 0, 0, 0);
  if (ok) v = __ldg(reinterpret_cast<const uint4*>(plane + row) + 0);
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int c = 0; c < 16; ++c) stage[(n0 + c) * ld + row_in_stage] = (w[c >> 2] >> (8 * (c & 3))) & 0xffu;
}

template <bool BF16>
__global__ void __launch_bounds__(WARPS * 32)
group_dot_kernel(const int8_t* __restrict__ xq, const int8_t* __restrict__ p,
                 const float* __restrict__ s, const float* __restrict__ sx,
                 float* __restrict__ out, int G, int N, int gpb) {
  __shared__ __align__(16) uint8_t stage[GPS][COLS * TLD];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int n_blk = blockIdx.x * COLS;
  const int g_begin = blockIdx.y * gpb, g_end = min(G, g_begin + gpb);
  const int nw = warp * 16;  // the warp's 16 columns in the block
  const int na = min(n_blk + nw + gid, N - 1), nb = min(n_blk + nw + gid + 8, N - 1);
  float acc[4] = {0.f, 0.f, 0.f, 0.f};  // (na, 2tig), (na, 2tig+1), (nb, 2tig), (nb, 2tig+1)

  for (int gs = g_begin; gs < g_end; gs += GPS) {
    __syncthreads();
    // GPS groups x 16 rows x 128 columns: 512 16-byte loads, 2 a thread
    for (int e = tid; e < GPS * 16 * 8; e += blockDim.x) {
      const int gi = e >> 7, row = (e >> 3) & 15, c16 = (e & 7) * 16;
      const int g = gs + gi, n = n_blk + c16;
      stage16(stage[gi], TLD, row, p, (size_t)(g * 16 + row) * N + n, c16, g < g_end && n < N);
    }
    __syncthreads();
    for (int gi = 0; gi < GPS && gs + gi < g_end; ++gi) {
      const int g = gs + gi;
      const uint8_t* st = stage[gi];
      const int8_t* xg = xq + ((size_t)g * 8 + gid) * 32;  // row gid of the block
      float d[4];
      if (!BF16) {
        // A: rows na / nb, k = 4tig..4tig+3 (low nibbles) and 16 + the same (high)
        const uint32_t w0 = *reinterpret_cast<const uint32_t*>(st + (nw + gid) * TLD + 4 * tig);
        const uint32_t w8 = *reinterpret_cast<const uint32_t*>(st + (nw + gid + 8) * TLD + 4 * tig);
        const uint32_t a[4] = {sext_lo4(w0), sext_lo4(w8), sext_hi4(w0), sext_hi4(w8)};
        const uint32_t b[2] = {__ldg(reinterpret_cast<const uint32_t*>(xg + 4 * tig)),
                               __ldg(reinterpret_cast<const uint32_t*>(xg + 16 + 4 * tig))};
        int di[4] = {0, 0, 0, 0};
        mma_s8(di, a, b);
#pragma unroll
        for (int i = 0; i < 4; ++i) d[i] = (float)di[i];
      } else {
        // A 16x16 per k step: (row, k = 2tig, 2tig+1) and (row, 8 + 2tig, +1)
        const uint16_t* ra = reinterpret_cast<const uint16_t*>(st + (nw + gid) * TLD);
        const uint16_t* rb = reinterpret_cast<const uint16_t*>(st + (nw + gid + 8) * TLD);
        const uint32_t pa0 = ra[tig], pa1 = ra[4 + tig], pb0 = rb[tig], pb1 = rb[4 + tig];
        const uint32_t x0 = __ldg(reinterpret_cast<const uint16_t*>(xg) + tig);
        const uint32_t x1 = __ldg(reinterpret_cast<const uint16_t*>(xg) + 4 + tig);
        const uint32_t x2 = __ldg(reinterpret_cast<const uint16_t*>(xg) + 8 + tig);
        const uint32_t x3 = __ldg(reinterpret_cast<const uint16_t*>(xg) + 12 + tig);
        const uint32_t alo[4] = {bf16x2_of_s8x2(sext_lo4(pa0)), bf16x2_of_s8x2(sext_lo4(pb0)),
                                 bf16x2_of_s8x2(sext_lo4(pa1)), bf16x2_of_s8x2(sext_lo4(pb1))};
        const uint32_t ahi[4] = {bf16x2_of_s8x2(sext_hi4(pa0)), bf16x2_of_s8x2(sext_hi4(pb0)),
                                 bf16x2_of_s8x2(sext_hi4(pa1)), bf16x2_of_s8x2(sext_hi4(pb1))};
        const uint32_t blo[2] = {bf16x2_of_s8x2(x0), bf16x2_of_s8x2(x1)};
        const uint32_t bhi[2] = {bf16x2_of_s8x2(x2), bf16x2_of_s8x2(x3)};
        d[0] = d[1] = d[2] = d[3] = 0.f;
        mma_bf16(d, alo, blo);
        mma_bf16(d, ahi, bhi);
      }
      const float sa = __ldg(s + (size_t)g * N + na), sb = __ldg(s + (size_t)g * N + nb);
      const float x0 = __ldg(sx + g * 8 + 2 * tig), x1 = __ldg(sx + g * 8 + 2 * tig + 1);
      acc[0] += __fmul_rn(__fmul_rn(d[0], sa), x0);
      acc[1] += __fmul_rn(__fmul_rn(d[1], sa), x1);
      acc[2] += __fmul_rn(__fmul_rn(d[2], sb), x0);
      acc[3] += __fmul_rn(__fmul_rn(d[3], sb), x1);
    }
  }
  float* o = out + (size_t)blockIdx.y * 8 * N;
  const int ca = n_blk + nw + gid, cb = ca + 8;
  if (ca < N) {
    o[(size_t)(2 * tig) * N + ca] = acc[0];
    o[(size_t)(2 * tig + 1) * N + ca] = acc[1];
  }
  if (cb < N) {
    o[(size_t)(2 * tig) * N + cb] = acc[2];
    o[(size_t)(2 * tig + 1) * N + cb] = acc[3];
  }
}

// i8dot2d: partial int32 [split, R, N] of k range [blockIdx.y * kpb, +kpb)
template <int RT>
__global__ void __launch_bounds__(WARPS * 32)
dot2d_kernel(const int8_t* __restrict__ xq, const int8_t* __restrict__ w8,
             int* __restrict__ out, int K, int N, int kpb) {
  __shared__ __align__(16) uint8_t stage[COLS * DLD];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int n_blk = blockIdx.x * COLS, nw = warp * 16;
  const int k_begin = blockIdx.y * kpb, k_end = min(K, k_begin + kpb);
  constexpr int R = RT * 8;
  int acc[RT][4];
#pragma unroll
  for (int t = 0; t < RT; ++t) acc[t][0] = acc[t][1] = acc[t][2] = acc[t][3] = 0;

  for (int k0 = k_begin; k0 < k_end; k0 += KS) {
    __syncthreads();
    for (int e = tid; e < KS * 8; e += blockDim.x) {  // KS rows x 8 chunks of 16 columns
      const int row = e >> 3, c16 = (e & 7) * 16, n = n_blk + c16;
      stage16(stage, DLD, row, w8, (size_t)(k0 + row) * N + n, c16, k0 + row < k_end && n < N);
    }
    __syncthreads();
    for (int kk = 0; kk < KS && k0 + kk < k_end; kk += 32) {
      const uint8_t* ca = stage + (nw + gid) * DLD + kk;
      const uint8_t* cb = stage + (nw + gid + 8) * DLD + kk;
      const uint32_t a[4] = {*reinterpret_cast<const uint32_t*>(ca + 4 * tig),
                             *reinterpret_cast<const uint32_t*>(cb + 4 * tig),
                             *reinterpret_cast<const uint32_t*>(ca + 16 + 4 * tig),
                             *reinterpret_cast<const uint32_t*>(cb + 16 + 4 * tig)};
#pragma unroll
      for (int t = 0; t < RT; ++t) {
        const int8_t* xr = xq + (size_t)(t * 8 + gid) * K + k0 + kk;
        const uint32_t b[2] = {__ldg(reinterpret_cast<const uint32_t*>(xr + 4 * tig)),
                               __ldg(reinterpret_cast<const uint32_t*>(xr + 16 + 4 * tig))};
        mma_s8(acc[t], a, b);
      }
    }
  }
  int* o = out + (size_t)blockIdx.y * R * N;
  const int ca = n_blk + nw + gid, cb = ca + 8;
#pragma unroll
  for (int t = 0; t < RT; ++t) {
    const int r0 = t * 8 + 2 * tig;
    if (ca < N) {
      o[(size_t)r0 * N + ca] = acc[t][0];
      o[(size_t)(r0 + 1) * N + ca] = acc[t][1];
    }
    if (cb < N) {
      o[(size_t)r0 * N + cb] = acc[t][2];
      o[(size_t)(r0 + 1) * N + cb] = acc[t][3];
    }
  }
}

}  // namespace

// The group dot: xq int8 [G, 8, 32], p int8 [G*16, N] (gm order), s f32
// [G, N], sx f32 [G, 8] -> out f32 [8, N]; partial f32 [ksplit, 8, N]
// scratch when ksplit > 1; bf16 != 0 takes the bf16 instruction. N % 16 == 0.
extern "C" int probe_group_dot_launch(const void* xq, const void* p, const void* s,
                                      const void* sx, void* out, void* partial, int G, int N,
                                      int ksplit, int bf16, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (G < 1 || N % 16 || ksplit < 1) return (int)cudaErrorInvalidValue;
  const int gpb = (G + ksplit - 1) / ksplit, splits = (G + gpb - 1) / gpb;
  float* dst = static_cast<float*>(splits == 1 ? out : partial);
  dim3 grid((N + COLS - 1) / COLS, splits);
  auto x = static_cast<const int8_t*>(xq);
  auto w = static_cast<const int8_t*>(p);
  auto sc = static_cast<const float*>(s);
  auto sxx = static_cast<const float*>(sx);
  if (bf16) group_dot_kernel<true><<<grid, WARPS * 32, 0, st>>>(x, w, sc, sxx, dst, G, N, gpb);
  else group_dot_kernel<false><<<grid, WARPS * 32, 0, st>>>(x, w, sc, sxx, dst, G, N, gpb);
  if (splits > 1)
    launch_split_sum(dst, static_cast<float*>(out), splits, 8 * N, st);
  return (int)cudaGetLastError();
}

// i8dot2d: xq int8 [R, K] (R in 8, 16, 24, 32), w8 int8 [K, N] -> out f32
// [R, N] = the exact int32 product converted once; partial int32 [ksplit,
// R, N] scratch. K % 32 == 0, N % 16 == 0.
extern "C" int probe_i8dot2d_launch(const void* xq, const void* w8, void* out, void* partial,
                                    int R, int K, int N, int ksplit, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (R % 8 || R < 8 || R > 32 || K % 32 || N % 16 || ksplit < 1)
    return (int)cudaErrorInvalidValue;
  int kpb = (K + ksplit - 1) / ksplit;
  kpb = (kpb + 31) / 32 * 32;
  const int splits = (K + kpb - 1) / kpb;
  dim3 grid((N + COLS - 1) / COLS, splits);
  auto x = static_cast<const int8_t*>(xq);
  auto w = static_cast<const int8_t*>(w8);
  auto p = static_cast<int*>(partial);
  switch (R / 8) {
    case 1: dot2d_kernel<1><<<grid, WARPS * 32, 0, st>>>(x, w, p, K, N, kpb); break;
    case 2: dot2d_kernel<2><<<grid, WARPS * 32, 0, st>>>(x, w, p, K, N, kpb); break;
    case 3: dot2d_kernel<3><<<grid, WARPS * 32, 0, st>>>(x, w, p, K, N, kpb); break;
    default: dot2d_kernel<4><<<grid, WARPS * 32, 0, st>>>(x, w, p, K, N, kpb); break;
  }
  launch_split_sum(p, static_cast<float*>(out), splits, R * N, st);
  return (int)cudaGetLastError();
}
