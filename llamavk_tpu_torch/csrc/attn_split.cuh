// Split-KV attention for Hopper at T from 1 to 15 query rows: K2 and K3 in
// every cache mode (flash_attn.cu's split route: decode steps, lookup and
// speculative verify rounds, short admission chunks and prompts) and K4
// (flash_decode.cu, T = 1), one launch each, the row writes of K2 and K4
// fused into it.
//
// What it replaces: `attend_block` (attn_common.cuh) at T from 1 to 15,
// where one block of 8 warps walked a (batch row, head)'s whole cache with
// one warp a query row (half the warps idle at T = 4), tiles loaded
// synchronously with two block barriers a 64-key tile (K loaded once for the
// scores and V again for PV), each lane summing a whole 128-element key dot
// alone and PV taking one key at a time. At B = 1 that grid was H = 32
// blocks on 132 SMs, and K2 wrote its rows in a launch of its own.
//
// What bounds it on an H100: the bytes of the visible rows, 2 * H * n * D
// elements (2 bytes bf16, 1 int8 plus 8 bytes of scales a row and head, 4
// f32) over 3.35 TB/s. The operations, 4 * H * D * (the visible rows of each
// query row), stay on the CUDA cores: at the main path's worst shape (B =
// 32, T = 4, int8, mean n_past ~256) ~0.5 GFLOP, ~8 us at 67 TFLOP/s, under
// its ~20 us byte bound (the tensor-core route takes T >= 16). Measured
// there, the scores' arithmetic with its int8 conversions and shuffles and
// the merge set the time, not the bytes (PERF.md, the split route at T > 1):
// `mma.sync` inside the split blocks is the next step. The design keeps as
// many of the bytes in flight as it can, on as many SMs as the rows allow:
//  * Splits. A (batch row, head) cuts its visible rows [0, limit) into
//    splits of `split_rows(block_k)` rows: 64 where 64 divides block_k,
//    else block_k (ops/flash_attn.py::split_rows); limit = min(n_past + T,
//    rows), or the whole ring unless bounded. It depends on block_k alone,
//    so a row's splits are the same in K2 and K4, flat and paged at
//    block_k = PS (block_k divides the page, so no split crosses one), for
//    a ring before its wrap and a flat cache, and for a prefix of length 0
//    and a flat cache. The shared-prefix mode cuts its pool rows [0, len)
//    by the pool's block (`pre.block_k`) the same way, ahead of the slot
//    splits. The grid is (split, head, batch row), sized by the rows a row
//    can address (S, MAXLB * PS, or the pool's rows and S); n_past is read
//    on the device, and a block past its row's last split exits at once.
//  * A block (4 warps) issues every 16-byte load of a split's K and V rows
//    (and int8 scales) up front, straight into registers (a 64-row tile; a
//    longer split walks more tiles). A key row is read by CH = 16-byte
//    chunks of consecutive lanes, so a warp's load covers 32 / CH whole rows
//    and the block's loads one contiguous stretch.
//  * T = 1 (NQ = 1, `split_pass`): each lane dots its chunk with q's (in
//    registers), and the row's CH lanes sum their dots by xor shuffles. The
//    split's max m, its sum l and acc[D] are summed over the lanes of a warp
//    by shuffles and over the warps in warp order.
//  * T from 2 to 15 (`split_pass_rows`; NQ = 4, 8 or 16, T rounded up, the
//    rows past T idle): one block serves every query row of its split, so
//    each K and V row is read from memory once for all of them. q * scale
//    sits in shared memory, [NQ][D] f32, staged once a block. K goes into
//    registers as above; V, and an int8 split's key and value scales, go
//    straight into shared memory by `cp.async`, in flight while the scores
//    are computed. For the scores a lane takes G = 4 query rows' chunks of
//    q into registers at a time, converts its key chunk to f32 once for the
//    four, dots it with each, and the row's CH lanes sum the four dots by a
//    reduce-scatter of xor shuffles (G - 1 + log2(CH / G) of them, not 4
//    log2(CH)), leaving each query's score in CH / G lanes. int8 rows go in
//    8-byte chunks here (16-byte ones hold 16 values a lane: the four rows'
//    q chunks alone took 64 registers, and the kernel 227, two blocks an
//    SM), and convert by a byte permute and one exact subtraction, full
//    rate, where I2F runs at an eighth of it. The scores go to shared
//    memory, [NQ][rows] f32 (dynamic). Warp w then owns query rows w, w + 4,
//    ...: the key scale, their max, p = exp(s - m) and l over the split's
//    rows. For PV warp w sums rows [16 w, 16 w + 16) of each 64-row V tile
//    for every query row, its lanes owning D / 32 output dims each, so a V
//    element is read and converted once a block (a warp owning query rows
//    instead converted every V element once a warp: at T = 4 two conversion
//    operations for each product); the four warps' sums meet in shared
//    memory and add in warp order. The kernels are held to 128 registers
//    (4 blocks an SM). `ptxas -v` for each instance is in PERF.md.
//  * A block computes one split, or two in turn (four at T > 1) where the
//    grid would hold PAIR_GRID blocks or more (B >= 8 at 7B's 8 splits and
//    32 heads): on the card the grid's block count, not the bytes, sets the
//    time there (fewer blocks: faster at B >= 8, slower at B = 1). The T = 1 int8
//    kernels are held to 80 registers (6 blocks an SM). Staging the
//    rows through shared memory by `cp.async`, a second register buffer
//    that loads the next split while one computes, and a persistent grid
//    striding over the (split, head, row) items all measured slower at T = 1
//    (PERF.md, the split-KV decode findings).
//  * Merge in the same launch: a split writes each query row's (m, l, acc)
//    to the workspace [B, H, T, nx, D + 2], fences, and counts itself on the
//    (b, h) counter (one for all T rows); the last to arrive merges every
//    query row's partials in ascending split order (at T > 1 all rows at
//    once, each thread a few (row, dim) elements), whatever order they
//    arrived in, writes out = acc / l and sets the counter back to 0. A
//    split whose rows are all masked for a query row (m = -1e30: empty or
//    future ring rows, or rows past that query's position) is skipped for
//    it, so it adds exactly nothing; a (b, h) with a single split writes its
//    outputs directly, with the bits the merge would give (l * 1 + 0 and
//    acc * 1 + 0 are exact).
//  * The fused write (K2 with commit, K4): query row t's new K and V rows go
//    to cache row wr + t (wr = n_past, or a ring's physical write row); the
//    block whose split holds that row writes it (int8: quantizes it and
//    stores its scale, `quantize_row`, one warp a row), passes a block
//    barrier, then reads it. No block reads a row that another block
//    writes, since a block reads only its own splits and a split never
//    crosses a page (page_straddle too). Rows are read through L2 only
//    (`__ldcg`, `cp.async.cg`): a block reads back its own write.
//
// Numerics: the rounding points of attn_common.cuh: q * scale in f32,
// rounded to bf16 for a bf16 or int8 cache (and for the pool pass over any
// slot type); a score is an f32 sum of q * k products, times the key's
// scale for int8, -1e30 where the key is not visible to the query row (col
// <= n_past + t, or a ring's 0 <= pos <= n_past + t); p = exp(s - m) (0
// where masked) counts into l before the value scale; p times the value
// scale is rounded to bf16 (bf16 and int8 caches) before the PV product.
// Every float operation whose order matters is an explicit intrinsic, so
// flash_attn.cu and flash_decode.cu, which both include this header, give
// bit-equal outputs at T = 1, and every mode's bit-equality holds at every
// T. The order differs from `attend_block`'s (a split's p is taken against
// the split's own max, rescaled in f32 by the merge; at T > 1 each score
// sums its lanes' dots in the reduce-scatter's order, and PV sums each
// warp's 16 rows of a tile in order, then the warps in order): one more
// order within the plain version's limit.

#pragma once

#include "attn_common.cuh"
#include "mma_ptx.cuh"

namespace attn {
namespace split {

constexpr int WARPS_S = 4;
constexpr int THREADS = WARPS_S * 32;
constexpr int TILE = 64;          // rows whose loads a block issues at once
constexpr int MAX_ROWS = 512;     // the largest split (block_k <= 512)
constexpr int MAX_SPLITS = 256;   // the largest grid of splits a (b, h) merges
constexpr int MAX_T = 16;         // query rows of the largest instance (NQ)
constexpr int G = 4;              // query rows whose q chunks a lane holds at once
// A grid of at least this many blocks of one split each takes two splits a
// block instead at T = 1, four at T > 1 (fewer, longer blocks: measured
// faster at B >= 8 of 7B's decode and at B = 32 of its verify rounds,
// slower at B = 1)
constexpr int PAIR_GRID = 2048;
// a ring row's position where it is empty: visible to no query row
constexpr int POS_NEVER = 0x7fffffff;

// blocks of a kernel an SM must hold. T = 1 int8: 6 caps them at 80
// registers (no spill; measured faster at B = 32 than ~100), where bf16 and
// f32 rows (and a prefix pool's bf16 pass) would spill. T > 1: 4 caps them
// at 128 (int8 at D = 128 took 168 uncapped, 3 blocks an SM; capped, a few
// bytes of stack, and measured faster at B = 32)
template <typename KV, int MODE, int NQ>
constexpr int min_blocks() {
  return NQ > 1 ? 4 : sizeof(KV) == 1 && MODE != MODE_PREFIX ? 6 : 1;
}

// rows of one split: 64 where 64 divides block_k, else block_k
__host__ __device__ __forceinline__ int split_rows(int block_k) {
  return block_k % 64 == 0 ? 64 : block_k;
}

__host__ __device__ __forceinline__ int ceil_div(int a, int b) { return (a + b - 1) / b; }

// how a lane reads a row of D elements of type KV: CH chunks of CB bytes
// (16, or 8: `Chunk`) of consecutive lanes a row, RPW rows a warp load, E
// elements a chunk, LPT loads a lane per 64-row tile
template <int D, typename KV, int CB = 16>
struct Lay {
  static constexpr int CH = D * (int)sizeof(KV) / CB;
  static constexpr int RPW = 32 / CH;
  static constexpr int E = CB / (int)sizeof(KV);
  static constexpr int ROUND = WARPS_S * RPW;
  static constexpr int LPT = TILE / ROUND;
  using Chunk = typename std::conditional<CB == 16, uint4, uint2>::type;
  static_assert(CH >= G && CH <= 32 && LPT >= 1, "row layout");
};

// The operands of one launch (a struct passed by value).
struct Args {
  const void* q;     // [B, T, H, D] QType<KV>
  const void* knew;  // [B, T, H, D] QType<KV>: the new rows (null: no write)
  const void* vnew;
  void* kc;          // one cache layer, addressed by `map`
  void* vc;
  float* ks;         // its f32 scale planes (int8), else null
  float* vs;
  float* out;        // [B, T, H, D] f32
  const int* npast_vec;  // [B], or null: npast_scalar
  int npast_scalar;
  const int* wrow_vec;   // [B] rows the new rows go to (n_past, or a ring's write rows)
  int wrow_scalar;
  int write;             // 1: write the new rows first
  KVMap map;
  int T;                 // query rows, 1 to MAX_T
  int H;
  int block_k;
  float scale;
  Ring ring;
  Prefix pre;
  float* ws;  // [B, H, T, nx, D + 2] partials (m, l, acc), workspace
  int* cnt;   // [B * H] arrival counters, 0 between launches
  int nx;     // splits in the grid: pool splits (npx) then slot splits
  int npx;        // set by `launch`
  int per_block;  // splits a block computes (1, 2 or 4), set by `launch`
  int rs;         // T > 1: a score row's floats in shared memory, set by `launch`
};

// the pool splits and slot splits in the grid of a call (the wrapper's
// ops/flash_attn.py::split_grid computes the same)
inline int grid_splits(int cap, int block_k, int pool_rows, int pool_block_k, int* npx) {
  *npx = pool_rows > 0 ? ceil_div(pool_rows, split_rows(pool_block_k)) : 0;
  return *npx + ceil_div(cap, split_rows(block_k));
}

__device__ __forceinline__ float chunk_dot(const float* qf, const uint4& raw, __nv_bfloat16) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&raw);
  float s = 0.f;
#pragma unroll
  for (int e2 = 0; e2 < 4; ++e2) {
    const float2 f = __bfloat1622float2(p[e2]);
    s = fmaf(qf[2 * e2], f.x, s);
    s = fmaf(qf[2 * e2 + 1], f.y, s);
  }
  return s;
}

__device__ __forceinline__ float chunk_dot(const float* qf, const uint4& raw, int8_t) {
  const char4* p = reinterpret_cast<const char4*>(&raw);
  float s = 0.f;
#pragma unroll
  for (int e4 = 0; e4 < 4; ++e4) {
    const char4 c = p[e4];
    s = fmaf(qf[4 * e4], (float)c.x, s);
    s = fmaf(qf[4 * e4 + 1], (float)c.y, s);
    s = fmaf(qf[4 * e4 + 2], (float)c.z, s);
    s = fmaf(qf[4 * e4 + 3], (float)c.w, s);
  }
  return s;
}

__device__ __forceinline__ float chunk_dot(const float* qf, const uint4& raw, float) {
  const float* p = reinterpret_cast<const float*>(&raw);
  float s = 0.f;
#pragma unroll
  for (int e = 0; e < 4; ++e) s = fmaf(qf[e], p[e], s);
  return s;
}

// acc[e] += p * v[e] over the chunk's elements
__device__ __forceinline__ void chunk_accum(float* acc, float p, const uint4& raw, __nv_bfloat16) {
  const __nv_bfloat162* v = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int e2 = 0; e2 < 4; ++e2) {
    const float2 f = __bfloat1622float2(v[e2]);
    acc[2 * e2] = fmaf(p, f.x, acc[2 * e2]);
    acc[2 * e2 + 1] = fmaf(p, f.y, acc[2 * e2 + 1]);
  }
}

__device__ __forceinline__ void chunk_accum(float* acc, float p, const uint4& raw, int8_t) {
  const int8_t* v = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
  for (int e = 0; e < 16; ++e) acc[e] = fmaf(p, (float)v[e], acc[e]);
}

__device__ __forceinline__ void chunk_accum(float* acc, float p, const uint4& raw, float) {
  const float* v = reinterpret_cast<const float*>(&raw);
#pragma unroll
  for (int e = 0; e < 4; ++e) acc[e] = fmaf(p, v[e], acc[e]);
}

// The shared memory of a split block
template <int D>
struct Smem {
  float sc[MAX_ROWS];        // the split's scores
  float red[WARPS_S][D];     // each warp's acc
  float red_m[WARPS_S];
  float red_l[WARPS_S];
  float part_m[MAX_SPLITS];  // the merge's view of the partials' m and l
  float part_l[MAX_SPLITS];
  int last;
};

// One split: rows [0, n) from kb/vb (int8: scales ksb/vsb, a row's at
// [j * H]), logical columns c0 + j, visible where vis(col). q is QT,
// scaled and rounded as RA rounds. Leaves m and l in every thread, and the
// split's acc[d] in thread d (d < D). Every load of a tile goes straight
// into registers, all issued before the first is used.
template <int D, typename KV, typename QT, typename RA, typename Vis>
__device__ __forceinline__ void split_pass(Smem<D>& sm, const QT* q, const KV* kb, const KV* vb,
                                           const float* ksb, const float* vsb, int H, int n,
                                           int c0, float scale, Vis vis, float& m_out,
                                           float& l_out, float& acc_out) {
  using L = Lay<D, KV>;
  constexpr bool QUANT = sizeof(KV) == 1;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane / L::CH, c = lane % L::CH;
  const int lrow = warp * L::RPW + g;  // the lane's row in a load round

  uint4 kr[L::LPT], vr[L::LPT];
  float ksr[L::LPT], vsr[L::LPT];
  // the loads of tile t0 (rows t0 + i * ROUND + lrow): 16-byte chunks of K
  // or V (zero past row n) and the int8 scales
  auto issue = [&](uint4* regs, const KV* base, const float* sbase, float* sdst, int t0) {
#pragma unroll
    for (int i = 0; i < L::LPT; ++i) {
      const int row = t0 + i * L::ROUND + lrow;
      const uint4* src = reinterpret_cast<const uint4*>(base + (size_t)min(row, n - 1) * D) + c;
      regs[i] = row < n ? __ldcg(src) : make_uint4(0u, 0u, 0u, 0u);
      if constexpr (QUANT) {
        if (row < n) sdst[i] = __ldcg(sbase + (size_t)row * H);
      }
    }
  };
  issue(kr, kb, ksb, ksr, 0);
  issue(vr, vb, vsb, vsr, 0);

  float qf[L::E];
  {
    const QT* qp = q + c * L::E;
#pragma unroll
    for (int e = 0; e < L::E; ++e) qf[e] = op_round<RA>(__fmul_rn(to_float(qp[e]), scale));
  }

  const int ntiles = ceil_div(n, TILE);
  float mx = NEG;
  for (int t = 0; t < ntiles; ++t) {
    const int t0 = t * TILE;
    if (t > 0) issue(kr, kb, ksb, ksr, t0);
#pragma unroll
    for (int i = 0; i < L::LPT; ++i) {
      if (t0 + i * L::ROUND >= n) break;  // the same for every lane
      const int row = t0 + i * L::ROUND + lrow;
      float s = chunk_dot(qf, kr[i], KV());
#pragma unroll
      for (int o = L::CH / 2; o > 0; o >>= 1)
        s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, o));
      if (row < n) {
        if constexpr (QUANT) s = __fmul_rn(s, ksr[i]);
        s = vis(c0 + row) ? s : NEG;
        if (c == 0) sm.sc[row] = s;
        mx = fmaxf(mx, s);
      }
    }
  }
  mx = warp_max(mx);
  if (lane == 0) sm.red_m[warp] = mx;
  __syncthreads();  // the scores and the warps' maxima
  float m = sm.red_m[0];
#pragma unroll
  for (int w = 1; w < WARPS_S; ++w) m = fmaxf(m, sm.red_m[w]);

  float acc[L::E];
#pragma unroll
  for (int e = 0; e < L::E; ++e) acc[e] = 0.f;
  float ls = 0.f;
  for (int t = 0; t < ntiles; ++t) {
    const int t0 = t * TILE;
    if (t > 0) issue(vr, vb, vsb, vsr, t0);
#pragma unroll
    for (int i = 0; i < L::LPT; ++i) {
      const int row = t0 + i * L::ROUND + lrow;
      if (row >= n) continue;
      const float s = sm.sc[row];
      if (s <= NEG * 0.5f) continue;  // masked: p = 0 adds nothing
      float p = expf(__fsub_rn(s, m));
      ls = __fadd_rn(ls, p);
      if constexpr (QUANT) p = __fmul_rn(p, vsr[i]);
      chunk_accum(acc, op_round<RA>(p), vr[i], KV());
    }
  }
  // over the warp's row groups (lanes CH apart hold the same chunk)
#pragma unroll
  for (int o = L::CH; o < 32; o <<= 1) {
    ls = __fadd_rn(ls, __shfl_xor_sync(0xffffffffu, ls, o));
#pragma unroll
    for (int e = 0; e < L::E; ++e)
      acc[e] = __fadd_rn(acc[e], __shfl_xor_sync(0xffffffffu, acc[e], o));
  }
  if (lane < L::CH) {
#pragma unroll
    for (int e = 0; e < L::E; ++e) sm.red[warp][c * L::E + e] = acc[e];
  }
  if (lane == 0) sm.red_l[warp] = ls;
  __syncthreads();
  float l = sm.red_l[0];
#pragma unroll
  for (int w = 1; w < WARPS_S; ++w) l = __fadd_rn(l, sm.red_l[w]);
  float a = 0.f;
  if (tid < D) {
    a = sm.red[0][tid];
#pragma unroll
    for (int w = 1; w < WARPS_S; ++w) a = __fadd_rn(a, sm.red[w][tid]);
  }
  m_out = m;
  l_out = l;
  acc_out = a;
}

// Byte K of a word of four int8 values whose sign bits are flipped (w ^
// 0x80808080), as a float, exactly: the byte under the exponent of 2^23,
// less 2^23 + 128. Two full-rate operations, where I2F runs at an eighth of
// the f32 rate.
template <int K>
__device__ __forceinline__ float i8_at(uint32_t x) {
  return __fsub_rn(__int_as_float((int)__byte_perm(x, 0x4B000000u, 0x7650 + K)), 8388736.f);
}

// the E elements of a chunk as floats
__device__ __forceinline__ void chunk_floats(const uint4& raw, float* f, __nv_bfloat16) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int e2 = 0; e2 < 4; ++e2) {
    const float2 x = __bfloat1622float2(p[e2]);
    f[2 * e2] = x.x;
    f[2 * e2 + 1] = x.y;
  }
}

__device__ __forceinline__ void chunk_floats(const uint2& raw, float* f, int8_t) {
  const uint32_t w[2] = {raw.x ^ 0x80808080u, raw.y ^ 0x80808080u};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    f[4 * i] = i8_at<0>(w[i]);
    f[4 * i + 1] = i8_at<1>(w[i]);
    f[4 * i + 2] = i8_at<2>(w[i]);
    f[4 * i + 3] = i8_at<3>(w[i]);
  }
}

__device__ __forceinline__ void chunk_floats(const uint4& raw, float* f, float) {
  f[0] = __uint_as_float(raw.x);
  f[1] = __uint_as_float(raw.y);
  f[2] = __uint_as_float(raw.z);
  f[3] = __uint_as_float(raw.w);
}

// elements [lane * DPL, lane * DPL + DPL) of a row in shared memory as
// floats (DPL = D / 32: 4 or 2), one vector load
template <int DPL>
__device__ __forceinline__ void lane_floats(const uint8_t* row, int lane, float* f,
                                            __nv_bfloat16) {
  if constexpr (DPL == 4) {
    const uint2 w = reinterpret_cast<const uint2*>(row)[lane];
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w.x));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w.y));
    f[0] = a.x, f[1] = a.y, f[2] = b.x, f[3] = b.y;
  } else {
    const uint32_t w = reinterpret_cast<const uint32_t*>(row)[lane];
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w));
    f[0] = a.x, f[1] = a.y;
  }
}

template <int DPL>
__device__ __forceinline__ void lane_floats(const uint8_t* row, int lane, float* f, int8_t) {
  if constexpr (DPL == 4) {
    const uint32_t w = reinterpret_cast<const uint32_t*>(row)[lane] ^ 0x80808080u;
    f[0] = i8_at<0>(w), f[1] = i8_at<1>(w), f[2] = i8_at<2>(w), f[3] = i8_at<3>(w);
  } else {
    const uint32_t w = (uint32_t)reinterpret_cast<const uint16_t*>(row)[lane] ^ 0x8080u;
    f[0] = i8_at<0>(w), f[1] = i8_at<1>(w);
  }
}

template <int DPL>
__device__ __forceinline__ void lane_floats(const uint8_t* row, int lane, float* f, float) {
  if constexpr (DPL == 4) {
    const float4 w = reinterpret_cast<const float4*>(row)[lane];
    f[0] = w.x, f[1] = w.y, f[2] = w.z, f[3] = w.w;
  } else {
    const float2 w = reinterpret_cast<const float2*>(row)[lane];
    f[0] = w.x, f[1] = w.y;
  }
}

// Sums each of the GN values s[] over the CH lanes of a key row (xor
// partners; c the lane's chunk) and leaves one sum a lane: query u = c /
// (CH / GN) of the group in s[0], u returned. The first log2(GN) steps halve
// the values a lane holds (it keeps one half and sends the other: GN - 1
// shuffles), the rest add its one value (log2(CH / GN) shuffles).
template <int GN, int CH>
__device__ __forceinline__ int reduce_scatter(float (&s)[GN], int c) {
  int u0 = 0;
#pragma unroll
  for (int k = GN / 2, o = CH / 2; k >= 1; k >>= 1, o >>= 1) {
    const bool up = c & o;
#pragma unroll
    for (int u = 0; u < k; ++u) {
      const float send = up ? s[u] : s[u + k];
      const float keep = up ? s[u + k] : s[u];
      s[u] = __fadd_rn(keep, __shfl_xor_sync(0xffffffffu, send, o));
    }
    if (up) u0 += k;
  }
#pragma unroll
  for (int o = CH / (2 * GN); o > 0; o >>= 1)
    s[0] = __fadd_rn(s[0], __shfl_xor_sync(0xffffffffu, s[0], o));
  return u0;
}

// The static shared memory of a block of NQ query rows (VB bytes a cached
// element: the slot cache's, or the bf16 pool's where that is more). The
// dynamic part follows (`RowsDyn`).
template <int D, int VB, int NQ>
struct SmemRows {
  float q[NQ][D];                        // q * scale, rounded as the pass rounds
  alignas(16) uint8_t v[TILE * D * VB];  // one tile of the split's V rows
  float m[NQ];                           // each query row's max and sum over the split
  float l[NQ];
  int last;
};

// The dynamic shared memory of a block of NQ query rows (floats): the
// scores, then p, [NQ][rs]; an int8 split's key and value scales [rs] each;
// each warp's PV sums [WARPS_S][T][D]. rs is a multiple of 4, so every part
// is 16-byte aligned.
struct RowsDyn {
  float* sc;
  float* ksc;
  float* vsc;
  float* red;
  __device__ RowsDyn(float* base, int nq, int rs)
      : sc(base), ksc(base + nq * rs), vsc(base + (nq + 1) * rs), red(base + (nq + 2) * rs) {}
  // red's floats also hold the merge's m, e and l (`merge_rows`)
  __host__ __device__ static size_t bytes(int nq, int rs, int T, int D, int nx) {
    const size_t red = (size_t)WARPS_S * T * D, ml = (size_t)(2 * nx + 1) * T;
    return ((size_t)(nq + 2) * rs + (red > ml ? red : ml)) * sizeof(float);
  }
};

// One split for T query rows (NQ >= T): rows [0, n) from kb/vb (int8:
// scales ksb/vsb, a row's at [j * H]), logical columns c0 + j; row j is
// visible to query row t where pos(c0 + j) <= np + t. Query row t at q + t
// * qstride, QT, scaled and rounded as RA rounds. Leaves each query row's m
// and l in sm.m, sm.l and its acc as the sum over the warps of dyn.red in
// warp order (`rows_acc`). stage_q: put q * scale into sm.q (else it is
// there, rounded as RA rounds). Every thread of the block calls it.
template <int D, typename KV, typename QT, typename RA, int NQ, typename SM, typename Pos>
__device__ __forceinline__ void split_pass_rows(SM& sm, const RowsDyn& dyn, int rs, const QT* q,
                                                size_t qstride, int T, const KV* kb,
                                                const KV* vb, const float* ksb,
                                                const float* vsb, int H, int n, int c0,
                                                float scale, int np, Pos pos, bool stage_q) {
  // int8 rows in 8-byte chunks: 16-byte ones would hold 16 values a lane,
  // and the G query rows' q chunks alone 64 registers
  using L = Lay<D, KV, sizeof(KV) == 1 ? 8 : 16>;
  using Chunk = typename L::Chunk;
  constexpr bool QUANT = sizeof(KV) == 1;
  constexpr int DPL = D / 32, SUB = L::CH / G, WROWS = TILE / WARPS_S;
  constexpr int ROWB = D * (int)sizeof(KV), CPR = ROWB / 16;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane / L::CH, c = lane % L::CH;
  const int lrow = warp * L::RPW + g;  // the lane's row in a load round

  Chunk kr[L::LPT];
  // the K loads of tile t0 (rows t0 + i * ROUND + lrow) into registers,
  // zero past row n
  auto load_k = [&](int t0) {
#pragma unroll
    for (int i = 0; i < L::LPT; ++i) {
      const int row = t0 + i * L::ROUND + lrow;
      const Chunk* src = reinterpret_cast<const Chunk*>(kb + (size_t)min(row, n - 1) * D) + c;
      kr[i] = row < n ? __ldcg(src) : Chunk{};
    }
  };
  // the V rows of tile t0 into sm.v by cp.async (zero past row n)
  auto copy_v = [&](int t0) {
    for (int i = tid; i < TILE * CPR; i += THREADS) {
      const int r = i / CPR, ch = i - r * CPR, row = t0 + r;
      ptx::cp16(ptx::smem_addr(sm.v + r * ROWB + ch * 16),
                reinterpret_cast<const uint8_t*>(vb + (size_t)min(row, n - 1) * D) + ch * 16,
                row < n ? 16 : 0);
    }
    ptx::cp_commit();
  };
  // __syncthreads first: an earlier pass of the block is done with shared
  // memory before any copy lands there
  __syncthreads();
  load_k(0);
  if constexpr (QUANT) {  // every row's scales (int8), in flight with the loads
    for (int j = tid; j < n; j += THREADS) {
      ptx::cp4(ptx::smem_addr(dyn.ksc + j), ksb + (size_t)j * H, 4);
      ptx::cp4(ptx::smem_addr(dyn.vsc + j), vsb + (size_t)j * H, 4);
    }
  }
  copy_v(0);

  if (stage_q) {  // else an earlier pass of the block left q as this one rounds it
    for (int i = tid; i < T * D; i += THREADS) {
      const int t = i / D, d = i - t * D;
      sm.q[t][d] = op_round<RA>(__fmul_rn(to_float(q[t * qstride + d]), scale));
    }
    __syncthreads();
  }

  // scores (before the key scale): a lane dots its key chunk with G query
  // rows' q chunks at a time
  const int ntiles = ceil_div(n, TILE);
  const int ngroups = ceil_div(T, G);
  for (int tile = 0; tile < ntiles; ++tile) {
    const int t0 = tile * TILE;
    if (tile > 0) load_k(t0);
    for (int gi = 0; gi < ngroups; ++gi) {
      float qf[G][L::E];  // this lane's chunk of query rows gi * G + u (the last past T)
#pragma unroll
      for (int u = 0; u < G; ++u) {
        const float* qr = sm.q[min(gi * G + u, T - 1)] + c * L::E;
#pragma unroll
        for (int e = 0; e < L::E; ++e) qf[u][e] = qr[e];
      }
#pragma unroll
      for (int i = 0; i < L::LPT; ++i) {
        if (t0 + i * L::ROUND >= n) break;  // the same for every lane
        const int row = t0 + i * L::ROUND + lrow;
        float kf[L::E];
        chunk_floats(kr[i], kf, KV());
        float s[G];
#pragma unroll
        for (int u = 0; u < G; ++u) {
          s[u] = 0.f;
#pragma unroll
          for (int e = 0; e < L::E; ++e) s[u] = fmaf(qf[u][e], kf[e], s[u]);
        }
        const int t = gi * G + reduce_scatter<G, L::CH>(s, c);
        if (row < n && c % SUB == 0 && t < T)
          dyn.sc[t * rs + row] = pos(c0 + row) <= np + t ? s[0] : NEG;
      }
    }
  }
  ptx::cp_wait_all();
  __syncthreads();  // every query row's scores, the scales and the first V tile

  // warp w: max, p and l of query rows w, w + 4, ... over the split's rows
  // (an int8 score times its key's scale first); p past row n (to a float4)
  // is 0
  const int n4 = (n + 3) & ~3;
  for (int t = warp; t < T; t += WARPS_S) {
    float* st = dyn.sc + t * rs;
    float mx = NEG;
    for (int j = lane; j < n; j += 32) {
      float x = st[j];
      if constexpr (QUANT) {
        if (x > NEG * 0.5f) st[j] = x = __fmul_rn(x, dyn.ksc[j]);
      }
      mx = fmaxf(mx, x);
    }
    mx = warp_max(mx);
    float ls = 0.f;
    for (int j = lane; j < n4; j += 32) {
      float p = 0.f;
      const float x = j < n ? st[j] : NEG;
      if (x > NEG * 0.5f) {  // masked: p = 0 adds nothing
        p = expf(__fsub_rn(x, mx));
        ls = __fadd_rn(ls, p);
        if constexpr (QUANT) p = __fmul_rn(p, dyn.vsc[j]);
        p = op_round<RA>(p);
      }
      st[j] = p;
    }
    ls = warp_sum(ls);
    if (lane == 0) {
      sm.m[t] = mx;
      sm.l[t] = ls;
    }
  }
  __syncthreads();  // every p

  // PV: warp w sums rows [w * 16, w * 16 + 16) of each V tile in order for
  // every query row, its lane `lane` owning dims [lane * DPL, lane * DPL +
  // DPL), so a V element is read and converted once a block
  float acc[NQ][DPL];
#pragma unroll
  for (int r = 0; r < NQ; ++r)
#pragma unroll
    for (int e = 0; e < DPL; ++e) acc[r][e] = 0.f;
  for (int tile = 0; tile < ntiles; ++tile) {
    const int t0 = tile * TILE;
    if (tile > 0) {
      __syncthreads();  // the last tile's PV is done with v
      copy_v(t0);
      ptx::cp_wait_all();
      __syncthreads();
    }
    const int j1 = min(warp * WROWS + WROWS, n - t0);
    for (int j = warp * WROWS; j < j1; j += 4) {
      float vf[4][DPL];  // rows j..j+3 (zero past row n, where p is 0 too)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) lane_floats<DPL>(sm.v + (j + jj) * ROWB, lane, vf[jj], KV());
#pragma unroll
      for (int r = 0; r < NQ; ++r) {
        if (r >= T) break;  // the same for every lane
        const float4 p = *reinterpret_cast<const float4*>(dyn.sc + r * rs + t0 + j);
#pragma unroll
        for (int e = 0; e < DPL; ++e) {
          acc[r][e] = fmaf(p.x, vf[0][e], acc[r][e]);
          acc[r][e] = fmaf(p.y, vf[1][e], acc[r][e]);
          acc[r][e] = fmaf(p.z, vf[2][e], acc[r][e]);
          acc[r][e] = fmaf(p.w, vf[3][e], acc[r][e]);
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < NQ; ++r) {
    if (r >= T) break;
#pragma unroll
    for (int e = 0; e < DPL; ++e) dyn.red[((size_t)warp * T + r) * D + lane * DPL + e] = acc[r][e];
  }
  __syncthreads();  // every warp's sums
}

// query row t's acc at dim d after `split_pass_rows`: the warps' sums in
// warp order
template <int D>
__device__ __forceinline__ float rows_acc(const RowsDyn& dyn, int T, int t, int d) {
  float a = dyn.red[(size_t)t * D + d];
#pragma unroll
  for (int w = 1; w < WARPS_S; ++w) a = __fadd_rn(a, dyn.red[((size_t)w * T + t) * D + d]);
  return a;
}

// Merges the partials ([T][nx][D + 2] at wsb; active(y): written in this
// launch) of every query row at once into out_row(t)[d], with
// `merge_splits`'s arithmetic for each element (t, d): the row's max M over
// the splits, then over the live splits (m > -1e30) in ascending order e =
// exp(m - M), l = fmaf(l_y, e, l), acc = fmaf(acc_y, e, acc), out = acc / l.
// A row's e and l are the same for its every d, so thread t computes them
// once; each element then takes one fmaf a split. ml: 2 T nx + T floats of
// shared memory. A thread takes elements tid + k THREADS, EG of them at a
// time with their loads of MB splits in flight together. Every thread of
// the block calls it.
template <int D, typename Act, typename Out>
__device__ __forceinline__ void merge_rows(const float* wsb, int nx, int T, Act active, float* ml,
                                           Out out_row) {
  constexpr int EG = 4, MB = 8;
  const int tid = threadIdx.x;
  float* pe = ml;                // [T][nx]: m, then e (-1: a split skipped)
  float* pl = ml + T * nx;       // [T][nx]: l
  float* lt = ml + 2 * T * nx;   // [T]: each row's l over the splits
  for (int i = tid; i < T * nx; i += THREADS) {
    const int t = i / nx, y = i - t * nx;
    float my = NEG, ly = 0.f;
    if (active(y)) {
      my = __ldcg(wsb + ((size_t)t * nx + y) * (D + 2));
      ly = __ldcg(wsb + ((size_t)t * nx + y) * (D + 2) + 1);
    }
    pe[i] = my;
    pl[i] = ly;
  }
  __syncthreads();
  for (int t = tid; t < T; t += THREADS) {
    float* et = pe + t * nx;
    float M = NEG;
    for (int y = 0; y < nx; ++y) M = fmaxf(M, et[y]);
    float Lm = 0.f;
    for (int y = 0; y < nx; ++y) {
      if (et[y] <= NEG * 0.5f) {  // inactive or all masked
        et[y] = -1.f;
        continue;
      }
      et[y] = expf(__fsub_rn(et[y], M));
      Lm = fmaf(pl[t * nx + y], et[y], Lm);
    }
    lt[t] = Lm;
  }
  __syncthreads();
  for (int i0 = tid; i0 < T * D; i0 += EG * THREADS) {
    float Am[EG];
#pragma unroll
    for (int k = 0; k < EG; ++k) Am[k] = 0.f;
    for (int y0 = 0; y0 < nx; y0 += MB) {
      float v[EG][MB];
#pragma unroll
      for (int k = 0; k < EG; ++k) {
        const int i = i0 + k * THREADS, t = i / D, d = i - t * D;
#pragma unroll
        for (int j = 0; j < MB; ++j) {
          const int y = y0 + j;
          v[k][j] = t < T && y < nx && pe[t * nx + y] >= 0.f
                        ? __ldcg(wsb + ((size_t)t * nx + y) * (D + 2) + 2 + d)
                        : 0.f;
        }
      }
#pragma unroll
      for (int k = 0; k < EG; ++k) {
        const int t = (i0 + k * THREADS) / D;
#pragma unroll
        for (int j = 0; j < MB; ++j) {
          const int y = y0 + j;
          if (t < T && y < nx && pe[t * nx + y] >= 0.f)
            Am[k] = fmaf(v[k][j], pe[t * nx + y], Am[k]);
        }
      }
    }
#pragma unroll
    for (int k = 0; k < EG; ++k) {
      const int i = i0 + k * THREADS, t = i / D, d = i - t * D;
      if (t < T) out_row(t)[d] = __fdiv_rn(Am[k], lt[t]);
    }
  }
}

// The new rows t < T of (b, h) whose cache rows wr + t (through the map)
// lie in grid splits [x0, x1): int8 rows quantized with their scales, one
// warp a row of K or V; bf16 and f32 rows copied in 16-byte chunks. Returns
// whether the block wrote any (the same in every thread).
template <int D, typename KV>
__device__ __forceinline__ bool write_new_rows(const Args& a, int b, int h, int wr, int T, int R,
                                               int x0, int x1) {
  const int H = a.H, cap = a.map.cap();
  auto mine = [&](int t) {
    const int row = wr + t;
    if (row < 0 || row >= cap) return false;
    const int xw = a.npx + row / R;  // the grid split that holds the row
    return xw >= x0 && xw < x1;
  };
  bool any = false;
  for (int t = 0; t < T; ++t) any = any || mine(t);
  if (!any) return false;
  KV* kc = static_cast<KV*>(a.kc);
  KV* vc = static_cast<KV*>(a.vc);
  if constexpr (sizeof(KV) == 1) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    auto kn = static_cast<const __nv_bfloat16*>(a.knew);
    auto vn = static_cast<const __nv_bfloat16*>(a.vnew);
    for (int j = warp; j < 2 * T; j += WARPS_S) {  // row t's K (j even) or V
      const int t = j >> 1;
      if (!mine(t)) continue;
      const int2 at = a.map.locate(b, wr + t);
      const size_t dst = a.map.data(at, h, H, D), sdst = a.map.scale(at, h, H);
      const size_t src = (((size_t)b * T + t) * H + h) * D;
      if (j & 1)
        quantize_row<D>(vn + src, vc + dst, a.vs + sdst, lane);
      else
        quantize_row<D>(kn + src, kc + dst, a.ks + sdst, lane);
    }
  } else {
    constexpr int CH = D * (int)sizeof(KV) / 16;
    auto kn = static_cast<const KV*>(a.knew);
    auto vn = static_cast<const KV*>(a.vnew);
    for (int i = threadIdx.x; i < 2 * T * CH; i += THREADS) {
      const int t = i / (2 * CH), k = i - t * 2 * CH;
      if (!mine(t)) continue;
      const size_t dst = a.map.data(a.map.locate(b, wr + t), h, H, D);
      const size_t src = (((size_t)b * T + t) * H + h) * D;
      if (k < CH)
        reinterpret_cast<uint4*>(kc + dst)[k] = reinterpret_cast<const uint4*>(kn + src)[k];
      else
        reinterpret_cast<uint4*>(vc + dst)[k - CH] =
            reinterpret_cast<const uint4*>(vn + src)[k - CH];
    }
  }
  return true;
}

// Merges one query row's partials ([nx][D + 2] at wsb; active(y): written
// in this launch) in ascending split order into out[0, D) (thread d owns
// dim d); part_m, part_l: shared memory of MAX_SPLITS floats each. Every
// thread of the block calls it.
template <int D, typename Act>
__device__ __forceinline__ void merge_splits(const float* wsb, int nx, Act active, float* part_m,
                                             float* part_l, float* out) {
  const int tid = threadIdx.x;
  // the first BATCH partials' acc load beside their m and l
  constexpr int BATCH = 8;  // partial loads in flight at once
  float v[BATCH];
#pragma unroll
  for (int j = 0; j < BATCH; ++j)
    v[j] = j < nx && tid < D && active(j) ? __ldcg(wsb + (size_t)j * (D + 2) + 2 + tid) : 0.f;
  for (int y = tid; y < nx; y += THREADS) {
    float my = NEG, ly = 0.f;
    if (active(y)) {
      my = __ldcg(wsb + (size_t)y * (D + 2));
      ly = __ldcg(wsb + (size_t)y * (D + 2) + 1);
    }
    part_m[y] = my;
    part_l[y] = ly;
  }
  __syncthreads();
  float M = NEG;
  for (int y = 0; y < nx; ++y) M = fmaxf(M, part_m[y]);
  float Lm = 0.f, Am = 0.f;
  for (int y0 = 0; y0 < nx; y0 += BATCH) {
    if (y0 > 0) {
#pragma unroll
      for (int j = 0; j < BATCH; ++j) {
        const int y = y0 + j;
        v[j] = y < nx && tid < D && part_m[y] > NEG * 0.5f
                   ? __ldcg(wsb + (size_t)y * (D + 2) + 2 + tid)
                   : 0.f;
      }
    }
#pragma unroll
    for (int j = 0; j < BATCH; ++j) {
      const int y = y0 + j;
      if (y >= nx || part_m[y] <= NEG * 0.5f) continue;  // inactive or all masked
      const float e = expf(__fsub_rn(part_m[y], M));
      Lm = fmaf(part_l[y], e, Lm);
      Am = fmaf(v[j], e, Am);
    }
  }
  if (tid < D) out[tid] = __fdiv_rn(Am, Lm);
}

// K2/K3 at T = 1 and K4: one block computes the active splits among [x0, x0
// + G) of one (b, h), in turn (G = `per_block`, which the launcher picks
// from the grid's size: a split's partial is the same whichever block
// computes it, so G changes no bit). A block that computed every active
// split of its (b, h) merges them without the counter.
template <int D, typename KV, int MODE>
__device__ __forceinline__ void split_one(const Args& a) {
  constexpr bool QUANT = sizeof(KV) == 1;
  __shared__ Smem<D> sm;
  const int h = blockIdx.y, b = blockIdx.z;
  const int x0 = blockIdx.x * a.per_block, x1 = min(x0 + a.per_block, a.nx);
  const int H = a.H, tid = threadIdx.x;
  const int np = a.npast_vec ? a.npast_vec[b] : a.npast_scalar;
  const int cap = a.map.cap();
  const int R = split_rows(a.block_k);
  // the slot rows any split reads: the whole ring unless bounded
  const int limit = MODE == MODE_RING && !a.ring.bounded ? cap : min(np + 1, cap);
  const int nsl = limit > 0 ? ceil_div(limit, R) : 0;
  int plen = 0, pr = 1, npl = 0;
  if constexpr (MODE == MODE_PREFIX) {
    plen = a.pre.len[b];
    pr = split_rows(a.pre.block_k);
    npl = plen > 0 ? ceil_div(plen, pr) : 0;
  }
  const size_t bh = (size_t)b * H + h;
  // grid split y: pool split y (y < npx), else slot split y - npx; the
  // active ones are the first npl and the first nsl of each
  auto active = [&](int y) { return y < a.npx ? y < npl : y - a.npx < nsl; };
  const int nact = npl + nsl;

  if (a.write && write_new_rows<D, KV>(a, b, h, a.wrow_vec ? a.wrow_vec[b] : a.wrow_scalar, 1, R,
                                       x0, x1))
    __syncthreads();  // the row is in the cache before any load reads it
  if (nact == 0) {
    if (x0 == 0 && tid < D) a.out[bh * D + tid] = __fdiv_rn(0.f, 0.f);
    return;
  }

  float* wsb = a.ws + bh * a.nx * (D + 2);
  int done = 0;
  for (int x = x0; x < x1; ++x) {
    if (!active(x)) continue;
    float m = NEG, l = 0.f, acc = 0.f;
    const bool pool = MODE == MODE_PREFIX && x < a.npx;
    if constexpr (MODE == MODE_PREFIX) {
      if (pool) {
        // the bf16 pool: q and p rounded to bf16 over any slot type
        const int r0 = x * pr;
        const size_t base = ((size_t)a.pre.id[b] * H + h) * a.pre.rows * D + (size_t)r0 * D;
        split_pass<D, __nv_bfloat16, QType<KV>, __nv_bfloat16>(
            sm, static_cast<const QType<KV>*>(a.q) + bh * D, a.pre.k + base, a.pre.v + base,
            nullptr, nullptr, H, min(r0 + pr, plen) - r0, r0, a.scale,
            [plen](int col) { return col < plen; }, m, l, acc);
      }
    }
    if (!pool) {
      const int r0 = (x - a.npx) * R;
      const int2 at = a.map.locate(b, r0);
      const size_t off = a.map.data(at, h, H, D);
      const KV* kb = static_cast<const KV*>(a.kc) + off;
      const KV* vb = static_cast<const KV*>(a.vc) + off;
      const float* ksb = QUANT ? a.ks + a.map.scale(at, h, H) : nullptr;
      const float* vsb = QUANT ? a.vs + a.map.scale(at, h, H) : nullptr;
      const int n = min(r0 + R, limit) - r0;
      auto qp = static_cast<const QType<KV>*>(a.q) + bh * D;
      if constexpr (MODE == MODE_RING) {
        const int* pos = a.ring.pos;
        const int nb = a.ring.nb;
        split_pass<D, KV, QType<KV>, KV>(sm, qp, kb, vb, ksb, vsb, H, n, r0, a.scale,
                                         [pos, nb, b, np](int col) {
                                           const int p = __ldg(pos + (size_t)col * nb + b);
                                           return p >= 0 && p <= np;
                                         },
                                         m, l, acc);
      } else {
        split_pass<D, KV, QType<KV>, KV>(sm, qp, kb, vb, ksb, vsb, H, n, r0, a.scale,
                                         [np](int col) { return col <= np; }, m, l, acc);
      }
    }
    if (nact == 1) {  // the row's only split: its output directly
      if (tid < D) a.out[bh * D + tid] = __fdiv_rn(acc, l);
      return;
    }
    float* mine = wsb + (size_t)x * (D + 2);
    if (tid < D) mine[2 + tid] = acc;
    if (tid == 0) {
      mine[0] = m;
      mine[1] = l;
    }
    ++done;
  }
  if (done == 0) return;
  __threadfence();
  __syncthreads();
  if (done < nact) {  // other blocks hold partials of (b, h): the last to arrive merges
    if (tid == 0) sm.last = atomicAdd(a.cnt + bh, done) + done == nact;
    __syncthreads();
    if (!sm.last) return;
    __threadfence();
  }
  // the last block of (b, h) merges every partial in ascending split order
  merge_splits<D>(wsb, a.nx, active, sm.part_m, sm.part_l, a.out + bh * D);
  if (done < nact && tid == 0) a.cnt[bh] = 0;
}

// K2/K3 at T from 2 to NQ: as `split_one`, every query row of (b, h) in
// one block a split (`split_pass_rows`), the T new rows written by the
// blocks whose splits hold them, each query row's partials merged in turn.
template <int D, typename KV, int MODE, int NQ>
__device__ __forceinline__ void split_many(const Args& a) {
  constexpr bool QUANT = sizeof(KV) == 1;
  // the bf16 pool's V tile over an int8 slot cache needs 2 bytes an element
  constexpr int VB = MODE == MODE_PREFIX && sizeof(KV) < 2 ? 2 : (int)sizeof(KV);
  __shared__ SmemRows<D, VB, NQ> sm;
  extern __shared__ __align__(16) float split_dyn[];
  const RowsDyn dyn(split_dyn, NQ, a.rs);
  const int h = blockIdx.y, b = blockIdx.z;
  const int x0 = blockIdx.x * a.per_block, x1 = min(x0 + a.per_block, a.nx);
  const int H = a.H, T = a.T, tid = threadIdx.x;
  const int np = a.npast_vec ? a.npast_vec[b] : a.npast_scalar;
  const int cap = a.map.cap();
  const int R = split_rows(a.block_k);
  // the slot rows any query row sees: the whole ring unless bounded
  const int limit = MODE == MODE_RING && !a.ring.bounded ? cap : min(np + T, cap);
  const int nsl = limit > 0 ? ceil_div(limit, R) : 0;
  int plen = 0, pr = 1, npl = 0;
  if constexpr (MODE == MODE_PREFIX) {
    plen = a.pre.len[b];
    pr = split_rows(a.pre.block_k);
    npl = plen > 0 ? ceil_div(plen, pr) : 0;
  }
  const size_t bh = (size_t)b * H + h;
  auto active = [&](int y) { return y < a.npx ? y < npl : y - a.npx < nsl; };
  const int nact = npl + nsl;
  auto out_row = [&](int t) { return a.out + (((size_t)b * T + t) * H + h) * D; };

  if (a.write && write_new_rows<D, KV>(a, b, h, a.wrow_vec ? a.wrow_vec[b] : a.wrow_scalar, T, R,
                                       x0, x1))
    __syncthreads();  // the rows are in the cache before any load reads them
  if (nact == 0) {
    if (x0 == 0)
      for (int i = tid; i < T * D; i += THREADS) out_row(i / D)[i % D] = __fdiv_rn(0.f, 0.f);
    return;
  }

  float* wsb = a.ws + bh * T * a.nx * (D + 2);  // [T, nx, D + 2]
  const size_t qstride = (size_t)H * D;
  auto qp = static_cast<const QType<KV>*>(a.q) + ((size_t)b * T * H + h) * D;
  // how sm.q holds q: -1 not yet, 0 rounded to bf16 (the pool pass, and the
  // slots of a bf16 or int8 cache), 1 in f32 (the slots of an f32 cache)
  constexpr int slot_q = std::is_same<KV, float>::value ? 1 : 0;
  int staged = -1;
  int done = 0;
  for (int x = x0; x < x1; ++x) {
    if (!active(x)) continue;
    const bool pool = MODE == MODE_PREFIX && x < a.npx;
    if constexpr (MODE == MODE_PREFIX) {
      if (pool) {
        // the bf16 pool, visible to every query row: q and p rounded to
        // bf16 over any slot type
        const int r0 = x * pr;
        const size_t base = ((size_t)a.pre.id[b] * H + h) * a.pre.rows * D + (size_t)r0 * D;
        split_pass_rows<D, __nv_bfloat16, QType<KV>, __nv_bfloat16, NQ>(
            sm, dyn, a.rs, qp, qstride, T, a.pre.k + base, a.pre.v + base, nullptr, nullptr,
            H, min(r0 + pr, plen) - r0, r0, a.scale, np, [](int) { return -POS_NEVER; },
            staged != 0);
        staged = 0;
      }
    }
    if (!pool) {
      const int r0 = (x - a.npx) * R;
      const int2 at = a.map.locate(b, r0);
      const size_t off = a.map.data(at, h, H, D);
      const KV* kb = static_cast<const KV*>(a.kc) + off;
      const KV* vb = static_cast<const KV*>(a.vc) + off;
      const float* ksb = QUANT ? a.ks + a.map.scale(at, h, H) : nullptr;
      const float* vsb = QUANT ? a.vs + a.map.scale(at, h, H) : nullptr;
      const int n = min(r0 + R, limit) - r0;
      if constexpr (MODE == MODE_RING) {
        const int* pos = a.ring.pos;
        const int nb = a.ring.nb;
        split_pass_rows<D, KV, QType<KV>, KV, NQ>(
            sm, dyn, a.rs, qp, qstride, T, kb, vb, ksb, vsb, H, n, r0, a.scale, np,
            [pos, nb, b](int col) {
              const int p = __ldg(pos + (size_t)col * nb + b);
              return p >= 0 ? p : POS_NEVER;
            },
            staged != slot_q);
      } else {
        split_pass_rows<D, KV, QType<KV>, KV, NQ>(sm, dyn, a.rs, qp, qstride, T, kb, vb, ksb,
                                                  vsb, H, n, r0, a.scale, np,
                                                  [](int col) { return col; }, staged != slot_q);
      }
      staged = slot_q;
    }
    if (nact == 1) {  // the row's only split: its outputs directly
      for (int i = tid; i < T * D; i += THREADS) {
        const int t = i / D, d = i - t * D;
        out_row(t)[d] = __fdiv_rn(rows_acc<D>(dyn, T, t, d), sm.l[t]);
      }
      return;
    }
    for (int i = tid; i < T * D; i += THREADS) {  // [T, nx, D + 2] partials
      const int t = i / D, d = i - t * D;
      wsb[((size_t)t * a.nx + x) * (D + 2) + 2 + d] = rows_acc<D>(dyn, T, t, d);
    }
    if (tid < T) {
      wsb[((size_t)tid * a.nx + x) * (D + 2)] = sm.m[tid];
      wsb[((size_t)tid * a.nx + x) * (D + 2) + 1] = sm.l[tid];
    }
    ++done;
  }
  if (done == 0) return;
  __threadfence();
  __syncthreads();
  if (done < nact) {  // other blocks hold partials of (b, h): the last to arrive merges
    if (tid == 0) sm.last = atomicAdd(a.cnt + bh, done) + done == nact;
    __syncthreads();
    if (!sm.last) return;
    __threadfence();
  }
  // the last block of (b, h) merges every query row's partials at once
  merge_rows<D>(wsb, a.nx, T, active, dyn.red, out_row);
  if (done < nact && tid == 0) a.cnt[bh] = 0;
}

template <int D, typename KV, int MODE, int NQ>
__global__ void __launch_bounds__(THREADS, (min_blocks<KV, MODE, NQ>())) split_kernel(const Args a) {
  if constexpr (NQ == 1)
    split_one<D, KV, MODE>(a);
  else
    split_many<D, KV, MODE, NQ>(a);
}

namespace {
// the dynamic shared memory allowed for an instance so far; internal
// linkage, where a static of the template `launch_d` would be one object
// shared by every library built from this header once they are loaded
template <int D, typename KV, int MODE, int NQ>
size_t& dyn_allowed() {
  static size_t n = 0;
  return n;
}
}  // namespace

template <int D, typename KV, int MODE, int NQ>
cudaError_t launch_d(const Args& a, int B, cudaStream_t st) {
  size_t dyn = 0;
  if constexpr (NQ > 1) {  // `RowsDyn`, above 48 KB with the static part at NQ = 16
    dyn = RowsDyn::bytes(NQ, a.rs, a.T, D, a.nx);
    const cudaError_t e =
        allow_dyn_smem(split_kernel<D, KV, MODE, NQ>, dyn, dyn_allowed<D, KV, MODE, NQ>());
    if (e != cudaSuccess) return e;
  }
  split_kernel<D, KV, MODE, NQ><<<dim3(ceil_div(a.nx, a.per_block), a.H, B), THREADS, dyn, st>>>(a);
  ++launch_count();
  return cudaGetLastError();
}

// the instance of a.T query rows: NQ = 1, or T rounded up to 4, 8 or 16
// (ROWS; K4 builds T = 1 only)
template <int D, typename KV, int MODE, bool ROWS>
cudaError_t launch_t(const Args& a, int B, cudaStream_t st) {
  if (a.T == 1) return launch_d<D, KV, MODE, 1>(a, B, st);
  if constexpr (ROWS) {
    if (a.T <= 4) return launch_d<D, KV, MODE, 4>(a, B, st);
    if (a.T <= 8) return launch_d<D, KV, MODE, 8>(a, B, st);
    return launch_d<D, KV, MODE, 16>(a, B, st);
  }
  return cudaErrorInvalidValue;
}

// One launch of the split route over a cache of type KV, D in {64, 128}, at
// a.T query rows (1 to MAX_T; 1 only without MODES): the ring or prefix
// mode by its operands (with MODES; else both refused). Sets `npx`,
// `per_block` and `rs`; refuses a split longer than MAX_ROWS, a grid of more
// than MAX_SPLITS splits, and an `nx` other than the call's shapes give (the
// wrapper sized the workspace by it).
template <typename KV, bool MODES>
cudaError_t launch(Args a, int B, int D, cudaStream_t st) {
  const int pool_rows = a.pre.k ? a.pre.rows : 0;
  const int cap = a.map.table ? a.map.maxlb * a.map.rows : a.map.rows;  // KVMap::cap()
  const int nx = grid_splits(cap, a.block_k, pool_rows, a.pre.block_k, &a.npx);
  a.per_block = (size_t)nx * a.H * B >= PAIR_GRID ? (a.T > 1 ? 4 : 2) : 1;
  const int pool_split = pool_rows ? split_rows(a.pre.block_k) : 0;
  const int rows = pool_split > split_rows(a.block_k) ? pool_split : split_rows(a.block_k);
  a.rs = (rows + 3) & ~3;
  if (nx != a.nx || nx > MAX_SPLITS || rows > MAX_ROWS || a.T < 1 || a.T > (MODES ? MAX_T : 1) ||
      !a.ws || !a.cnt || (!MODES && (a.ring.pos || a.pre.k)))
    return cudaErrorInvalidValue;
  if constexpr (MODES) {
    if (a.ring.pos)
      return D == 128 ? launch_t<128, KV, MODE_RING, true>(a, B, st)
           : D == 64  ? launch_t<64, KV, MODE_RING, true>(a, B, st)
                      : cudaErrorInvalidValue;
    if (a.pre.k)
      return D == 128 ? launch_t<128, KV, MODE_PREFIX, true>(a, B, st)
           : D == 64  ? launch_t<64, KV, MODE_PREFIX, true>(a, B, st)
                      : cudaErrorInvalidValue;
  }
  return D == 128 ? launch_t<128, KV, MODE_PLAIN, MODES>(a, B, st)
       : D == 64  ? launch_t<64, KV, MODE_PLAIN, MODES>(a, B, st)
                  : cudaErrorInvalidValue;
}

}  // namespace split
}  // namespace attn
