// Split-KV decode attention (T = 1) for Hopper: K2 and K3 at T = 1 in every
// cache mode (flash_attn.cu's split route) and K4 (flash_decode.cu), one
// launch each, the row write of K2 and K4 fused into it.
//
// What it replaces: `attend_block` (attn_common.cuh) at T = 1, where one
// block of 8 warps walked a (batch row, head)'s whole cache with one warp
// computing (one query row a warp), tiles loaded synchronously with two
// block barriers a 64-key tile, and each lane summing a whole 128-element
// key dot alone. At B = 1 that grid was H = 32 blocks on 132 SMs, and K2
// wrote its row in a launch of its own.
//
// What bounds it on an H100: the bytes of the visible rows, 2 * H * n * D
// elements (2 bytes bf16, 1 int8 plus 8 bytes of scales a row and head, 4
// f32) over 3.35 TB/s; 4 * H * n * D operations are ~1/64 of a bf16 byte's
// worth. So the design keeps as many of those bytes in flight as it can,
// on as many SMs as the rows allow:
//  * Splits. A (batch row, head) cuts its visible rows [0, limit) into
//    splits of `split_rows(block_k)` rows: 64 where 64 divides block_k,
//    else block_k (ops/flash_attn.py::split_rows). It depends on block_k
//    alone, so a row's splits are the same in K2 and K4, flat and paged at
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
//    and the block's loads one contiguous stretch; each lane dots its chunk
//    with q's (in registers), and the row's CH lanes sum their dots by xor
//    shuffles. The split's max m, its sum l and acc[D] are summed over the
//    lanes of a warp by shuffles and over the warps in warp order.
//  * A block computes one split, or two in turn where the grid would hold
//    PAIR_GRID blocks or more (B >= 8 at 7B's 8 splits and 32 heads): on
//    the card the grid's block count, not the bytes, sets the time there
//    (half the blocks: faster at B >= 8, slower at B = 1). The int8
//    kernels are held to 80 registers (6 blocks an SM). Staging the
//    rows through shared memory by `cp.async`, a second register buffer
//    that loads the next split while one computes, and a persistent grid
//    striding over the (split, head, row) items all measured slower
//    (PERF.md, the split-KV decode findings).
//  * Merge in the same launch: a split writes (m, l, acc) to the workspace,
//    fences, and counts itself on the (b, h) counter; the last to arrive
//    merges every partial of its (b, h) in ascending split order, whatever
//    order they arrived in, writes out = acc / l and sets the counter back
//    to 0. A split whose rows are all masked (m = -1e30: empty or future
//    ring rows) is skipped, so it adds exactly nothing; a row with a single
//    split writes its output directly, with the bits the merge would give
//    (l * 1 + 0 and acc * 1 + 0 are exact).
//  * The fused write (K2 with commit, K4): the block whose split holds the
//    written row (n_past, or a ring's physical write row) writes it
//    (int8: quantizes it and stores its scale, `quantize_row`), passes a
//    block barrier, then reads it. No other block reads that row. Rows are
//    read through L2 only (`__ldcg`): a block reads back its own write.
//
// Numerics: the rounding points of attn_common.cuh (:26-37 there): q * scale
// in f32, rounded to bf16 for a bf16 or int8 cache (and for the pool pass
// over any slot type); a score is an f32 sum of q * k products, times the
// key's scale for int8, -1e30 where the key is not visible; p = exp(s - m)
// (0 where masked) counts into l before the value scale; p times the value
// scale is rounded to bf16 (bf16 and int8 caches) before the PV product.
// Every float operation whose order matters is an explicit intrinsic, so
// flash_attn.cu and flash_decode.cu, which both include this header, give
// bit-equal outputs. The order differs from `attend_block`'s (a split's p
// is taken against the split's own max, rescaled in f32 by the merge): one
// more order within the plain version's limit.

#pragma once

#include "attn_common.cuh"

namespace attn {
namespace split {

constexpr int WARPS_S = 4;
constexpr int THREADS = WARPS_S * 32;
constexpr int TILE = 64;          // rows whose loads a block issues at once
constexpr int MAX_ROWS = 512;     // the largest split (block_k <= 512)
constexpr int MAX_SPLITS = 256;   // the largest grid of splits a (b, h) merges
// A grid of at least this many blocks of one split each takes two splits a
// block instead (fewer, longer blocks: measured faster at B >= 8 of 7B's
// decode, slower at B = 1)
constexpr int PAIR_GRID = 2048;

// blocks of an int8 kernel an SM must hold: 6 caps them at 80 registers (no
// spill; measured faster at B = 32 than ~100), where bf16 and f32 rows (and
// a prefix pool's bf16 pass) would spill
template <typename KV, int MODE>
constexpr int min_blocks() {
  return sizeof(KV) == 1 && MODE != MODE_PREFIX ? 6 : 1;
}

// rows of one split: 64 where 64 divides block_k, else block_k
__host__ __device__ __forceinline__ int split_rows(int block_k) {
  return block_k % 64 == 0 ? 64 : block_k;
}

__host__ __device__ __forceinline__ int ceil_div(int a, int b) { return (a + b - 1) / b; }

// how a lane reads a row of D elements of type KV: CH 16-byte chunks of
// consecutive lanes a row, RPW rows a warp load, E elements a chunk, LPT
// loads a lane per 64-row tile
template <int D, typename KV>
struct Lay {
  static constexpr int CH = D * (int)sizeof(KV) / 16;
  static constexpr int RPW = 32 / CH;
  static constexpr int E = 16 / (int)sizeof(KV);
  static constexpr int ROUND = WARPS_S * RPW;
  static constexpr int LPT = TILE / ROUND;
  static_assert(CH >= 1 && CH <= 32 && LPT >= 1, "row layout");
};

// The operands of one launch (a struct passed by value).
struct Args {
  const void* q;     // [B, 1, H, D] QType<KV>
  const void* knew;  // [B, 1, H, D] QType<KV>: the new rows (null: no write)
  const void* vnew;
  void* kc;          // one cache layer, addressed by `map`
  void* vc;
  float* ks;         // its f32 scale planes (int8), else null
  float* vs;
  float* out;        // [B, 1, H, D] f32
  const int* npast_vec;  // [B], or null: npast_scalar
  int npast_scalar;
  const int* wrow_vec;   // [B] rows the new rows go to (n_past, or a ring's write rows)
  int wrow_scalar;
  int write;             // 1: write the new rows first
  KVMap map;
  int H;
  int block_k;
  float scale;
  Ring ring;
  Prefix pre;
  float* ws;  // [B, H, nx, D + 2] partials (m, l, acc), workspace
  int* cnt;   // [B * H] arrival counters, 0 between launches
  int nx;     // splits in the grid: pool splits (npx) then slot splits
  int npx;        // set by `launch`
  int per_block;  // splits a block computes (1 or 2), set by `launch`
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

// the new row of (b, h) into cache row `row` (through the map): bf16 and f32
// rows copied in 16-byte chunks; int8 rows quantized, K by warp 0, V by
// warp 1, with their scales
template <int D, typename KV>
__device__ __forceinline__ void write_new_row(const Args& a, int b, int h, int row) {
  const int H = a.H;
  const int2 at = a.map.locate(b, row);
  const size_t dst = a.map.data(at, h, H, D);
  const size_t src = ((size_t)b * H + h) * D;
  KV* kc = static_cast<KV*>(a.kc);
  KV* vc = static_cast<KV*>(a.vc);
  if constexpr (sizeof(KV) == 1) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    auto kn = static_cast<const __nv_bfloat16*>(a.knew);
    auto vn = static_cast<const __nv_bfloat16*>(a.vnew);
    const size_t sdst = a.map.scale(at, h, H);
    if (warp == 0) quantize_row<D>(kn + src, kc + dst, a.ks + sdst, lane);
    if (warp == 1) quantize_row<D>(vn + src, vc + dst, a.vs + sdst, lane);
  } else {
    constexpr int CH = D * (int)sizeof(KV) / 16;
    static_assert(2 * CH <= THREADS, "a block copies both rows at once");
    auto kn = static_cast<const KV*>(a.knew);
    auto vn = static_cast<const KV*>(a.vnew);
    const int i = threadIdx.x;
    if (i < CH)
      reinterpret_cast<uint4*>(kc + dst)[i] = reinterpret_cast<const uint4*>(kn + src)[i];
    else if (i < 2 * CH)
      reinterpret_cast<uint4*>(vc + dst)[i - CH] =
          reinterpret_cast<const uint4*>(vn + src)[i - CH];
  }
}

// One block computes the active splits among [x0, x0 + G) of one (b, h), in
// turn (G = `per_block`, which the launcher picks from the grid's size: a
// split's partial is the same whichever block computes it, so G changes no
// bit). A block that computed every active split of its (b, h) merges them
// without the counter.
template <int D, typename KV, int MODE>
__global__ void __launch_bounds__(THREADS, (min_blocks<KV, MODE>())) split_kernel(const Args a) {
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

  if (a.write) {
    const int wr = a.wrow_vec ? a.wrow_vec[b] : a.wrow_scalar;
    const int xw = a.npx + wr / R;  // the grid split that holds the written row
    if (wr >= 0 && wr < cap && xw >= x0 && xw < x1) {
      write_new_row<D, KV>(a, b, h, wr);
      __syncthreads();  // the row is in the cache before any load reads it
    }
  }
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

  // the last block of (b, h) merges every partial in ascending split order;
  // the first BATCH partials' acc load beside their m and l
  constexpr int BATCH = 8;  // partial loads in flight at once
  float v[BATCH];
#pragma unroll
  for (int j = 0; j < BATCH; ++j)
    v[j] = j < a.nx && tid < D && active(j) ? __ldcg(wsb + (size_t)j * (D + 2) + 2 + tid) : 0.f;
  for (int y = tid; y < a.nx; y += THREADS) {
    float my = NEG, ly = 0.f;
    if (active(y)) {
      my = __ldcg(wsb + (size_t)y * (D + 2));
      ly = __ldcg(wsb + (size_t)y * (D + 2) + 1);
    }
    sm.part_m[y] = my;
    sm.part_l[y] = ly;
  }
  __syncthreads();
  float M = NEG;
  for (int y = 0; y < a.nx; ++y) M = fmaxf(M, sm.part_m[y]);
  float Lm = 0.f, Am = 0.f;
  for (int y0 = 0; y0 < a.nx; y0 += BATCH) {
    if (y0 > 0) {
#pragma unroll
      for (int j = 0; j < BATCH; ++j) {
        const int y = y0 + j;
        v[j] = y < a.nx && tid < D && sm.part_m[y] > NEG * 0.5f
                   ? __ldcg(wsb + (size_t)y * (D + 2) + 2 + tid)
                   : 0.f;
      }
    }
#pragma unroll
    for (int j = 0; j < BATCH; ++j) {
      const int y = y0 + j;
      if (y >= a.nx || sm.part_m[y] <= NEG * 0.5f) continue;  // inactive or all masked
      const float e = expf(__fsub_rn(sm.part_m[y], M));
      Lm = fmaf(sm.part_l[y], e, Lm);
      Am = fmaf(v[j], e, Am);
    }
  }
  if (tid < D) a.out[bh * D + tid] = __fdiv_rn(Am, Lm);
  if (done < nact && tid == 0) a.cnt[bh] = 0;
}

template <int D, typename KV, int MODE>
cudaError_t launch_d(const Args& a, int B, cudaStream_t st) {
  split_kernel<D, KV, MODE><<<dim3(ceil_div(a.nx, a.per_block), a.H, B), THREADS, 0, st>>>(a);
  ++launch_count();
  return cudaGetLastError();
}

// One launch of the split route over a cache of type KV, D in {64, 128}:
// the ring or prefix mode by its operands (with MODES; else both refused).
// Sets `npx`; refuses a split longer than MAX_ROWS, a grid of more than
// MAX_SPLITS splits, and an `nx` other than the call's shapes give (the
// wrapper sized the workspace by it).
template <typename KV, bool MODES>
cudaError_t launch(Args a, int B, int D, cudaStream_t st) {
  const int pool_rows = a.pre.k ? a.pre.rows : 0;
  const int cap = a.map.table ? a.map.maxlb * a.map.rows : a.map.rows;  // KVMap::cap()
  const int nx = grid_splits(cap, a.block_k, pool_rows, a.pre.block_k, &a.npx);
  a.per_block = (size_t)nx * a.H * B >= PAIR_GRID ? 2 : 1;
  if (nx != a.nx || nx > MAX_SPLITS || split_rows(a.block_k) > MAX_ROWS ||
      (pool_rows && split_rows(a.pre.block_k) > MAX_ROWS) || !a.ws || !a.cnt ||
      (!MODES && (a.ring.pos || a.pre.k)))
    return cudaErrorInvalidValue;
  if constexpr (MODES) {
    if (a.ring.pos)
      return D == 128 ? launch_d<128, KV, MODE_RING>(a, B, st)
           : D == 64  ? launch_d<64, KV, MODE_RING>(a, B, st)
                      : cudaErrorInvalidValue;
    if (a.pre.k)
      return D == 128 ? launch_d<128, KV, MODE_PREFIX>(a, B, st)
           : D == 64  ? launch_d<64, KV, MODE_PREFIX>(a, B, st)
                      : cudaErrorInvalidValue;
  }
  return D == 128 ? launch_d<128, KV, MODE_PLAIN>(a, B, st)
       : D == 64  ? launch_d<64, KV, MODE_PLAIN>(a, B, st)
                  : cudaErrorInvalidValue;
}

}  // namespace split
}  // namespace attn
