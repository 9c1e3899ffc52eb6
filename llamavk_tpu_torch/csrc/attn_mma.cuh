// Tensor-core attention of the K2/K3 kernels (flash_attn.cu) for prefill and
// admission chunks: bf16 or int8 caches at T >= MIN_T, every cache mode of
// `attend_block` (flat, paged, ring, prefix, and the flat pipeline modes).
// The CUDA-core `attend_block` (attn_common.cuh) keeps T < MIN_T and every
// f32 cache, and K4.
//
// What it replaces: the CUDA-core walk of `attend_block`, which gives a block
// 8 query rows (one a warp) and scores key by key with scalar fmaf, so each
// K/V tile is read from L2 once per 8 query rows and the 4 * T * S_visible *
// D products run on ~67 TFLOP/s of CUDA cores. A prefill is bound by those
// operations (989 TFLOP/s of bf16 tensor cores on an H100) long before its
// bytes; this design moves them onto `mma.sync`.
//
// Design (sm_90a; `mma.sync` m16n8k16 bf16 x bf16 -> f32, `ldmatrix`,
// `cp.async`):
//  * A block takes 64 query rows of one (b, h): 4 warps of 16 rows. q is
//    scaled by 1/sqrt(D) in f32 and rounded to bf16, exactly as
//    `attend_block` does, straight into each warp's A fragments (registers,
//    for the whole walk).
//  * Keys go in sub-tiles of min(64, block_k) rows. A sub-tile never crosses
//    a KV block (block_k divides the page, so never a page either): its
//    rows are contiguous from one `KVMap::locate`. K and V sub-tiles are
//    double-buffered in shared memory by `cp.async` (16 bytes a thread),
//    so sub-tile i + 1 loads while sub-tile i computes. bf16 rows are padded
//    to D + 8 elements, so the 8 row addresses of an `ldmatrix` fall in 8
//    different 4-bank groups. An int8 sub-tile lands as int8 (rows of D
//    bytes) and is widened to bf16 in shared memory before `ldmatrix`
//    (exact: int8 fits bf16); its k/v scales and a ring's positions land
//    beside it. Rows past the sub-tile's end are zero-filled and masked.
//  * S = Q K^T: K rows [key][d] are the `.col` B operand as `ldmatrix` reads
//    them. The scores stay in the accumulator registers.
//  * O += P V: the S accumulators, converted to bf16, are the A fragments of
//    P (the m16n8k16 C layout is the A layout of two n-tiles); V goes
//    through `ldmatrix.trans`.
//
// Numerics: the rounding points of `attend_block` (attn_common.cuh:26-37).
// A score is the f32 sum of exact bf16 x bf16 products (the tensor cores'
// f32 accumulation), times the key's scale (int8, `__fmul_rn`), then -1e30
// where the key is not visible; p = 0 for a masked score; l takes p before
// the value scale; p times the value scale is rounded to bf16 for the PV
// product; out = acc / l in f32. The online max and sum step once a
// sub-tile (FA2: a row's max reduced over the quad of lanes that hold it,
// each lane keeping a partial l of its own columns, summed over the quad at
// the end), so only the f32 summation order differs from `attend_block`.
//
// A warp skips a sub-tile, or its 16-key quarters, that no row of its own
// can see (flat, paged and prefix-slot causal masks; never a ring's): such
// keys have p = 0, so the skipped online step is exactly the identity
// (alpha = exp(0) = 1, l + 0, acc * 1 + 0). Every mode runs this code at the
// same T, so paged = flat at block_k = PS, ring = flat before a wrap, prefix
// = flat at prefix_len 0 and batch_offset = the offset rows alone hold bit
// for bit, as they do for `attend_block`.

#pragma once

#include "attn_common.cuh"
#include "mma_ptx.cuh"

namespace attn {
namespace mma {

constexpr int QT = 64;       // query rows per block
constexpr int WARPS_TC = 4;  // 16 query rows a warp
constexpr int THREADS = WARPS_TC * 32;
constexpr int KS = 64;      // keys per sub-tile, at most
constexpr int MIN_T = 16;   // the least T this route takes (ops/flash_attn.py::attn_route)

template <int D>
struct Geo {
  static constexpr int PROW = (D + 8) * 2;  // bytes of a padded bf16 row
  static constexpr int BF_TILE = KS * PROW;
  static constexpr int I8_TILE = KS * D;
};

// bytes of one K or V stage buffer: bf16 rows padded, or int8 rows of D
// bytes; a prefix pool's bf16 pre-pass shares the stages with int8 slots
template <int D, typename KV, int MODE>
constexpr int stage_bytes() {
  return sizeof(KV) == 1 && MODE != MODE_PREFIX ? Geo<D>::I8_TILE : Geo<D>::BF_TILE;
}

// dynamic shared memory of a block: 2 stages x (K, V), the widened int8
// tiles and the stages' scales (int8), the stages' ring positions (ring)
template <int D, typename KV, int MODE>
constexpr size_t smem_bytes() {
  return (size_t)4 * stage_bytes<D, KV, MODE>() +
         (sizeof(KV) == 1 ? (size_t)2 * Geo<D>::BF_TILE + 2 * 2 * KS * sizeof(float) : 0) +
         (MODE == MODE_RING ? (size_t)2 * KS * sizeof(int) : 0);
}

using ptx::cp16;
using ptx::cp4;
using ptx::cp_commit;
using ptx::cp_wait_all;
using ptx::ldsm4;
using ptx::ldsm4_t;
using ptx::mma16816;
using ptx::pack_bf16;
using ptx::smem_addr;

// rows [0, nk) of D elements of type E from src (row r at src + r * D) into
// a stage buffer whose rows are `srow` bytes apart; rows [nk, KS) zeroed
template <int D, typename E>
__device__ __forceinline__ void load_rows(uint8_t* tile, int srow, const E* src, int nk) {
  constexpr int RB = D * (int)sizeof(E);
  constexpr int CH = RB / 16;
  const uint32_t base = smem_addr(tile);
  const uint8_t* s = reinterpret_cast<const uint8_t*>(src);
  for (int e = threadIdx.x; e < KS * CH; e += THREADS) {
    const int r = e / CH, c = e - r * CH;
    const bool ok = r < nk;
    cp16(base + r * srow + c * 16, s + (ok ? (size_t)r * RB + c * 16 : 0), ok ? 16 : 0);
  }
}

// int8 rows [0, rows) of a stage buffer (D bytes a row) widened to bf16 in
// a padded tile
template <int D>
__device__ __forceinline__ void widen(uint8_t* dst, const uint8_t* src, int rows) {
  constexpr int CH = D / 16;
  for (int e = threadIdx.x; e < rows * CH; e += THREADS) {
    const int r = e / CH, c = e - r * CH;
    const int4 v = *reinterpret_cast<const int4*>(src + r * D + c * 16);
    const int8_t* x = reinterpret_cast<const int8_t*>(&v);
    uint32_t w[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) w[i] = pack_bf16((float)x[2 * i], (float)x[2 * i + 1]);
    uint4* o = reinterpret_cast<uint4*>(dst + r * Geo<D>::PROW + c * 32);
    o[0] = make_uint4(w[0], w[1], w[2], w[3]);
    o[1] = make_uint4(w[4], w[5], w[6], w[7]);
  }
}

// A warp's walk state: q's A fragments, the output accumulators, and per
// row (g, g + 8 of the warp's 16) the running max and this lane's partial l
template <int D>
struct Warp {
  uint32_t qf[D / 16][4];
  float o[D / 8][4];
  float m[2];
  float l[2];
  int rpos[2];  // the two rows' positions (logical in a ring, slot-local over a prefix)
  int last;     // the last key any row of the warp sees (causal masks)
  bool active;  // the warp holds a row < T
};

// Visibility of a sub-tile's keys: causal (col <= row position), a ring's
// position plane (0 <= pos <= row position), or all (a prefix pre-pass,
// whose sub-tiles end at prefix_len)
enum { VIS_CAUSAL = 0, VIS_RING = 1, VIS_ALL = 2 };

// One sub-tile of keys [j0, j0 + nk) in shared memory (kt/vt padded bf16
// tiles; ksc/vsc its scales when QUANT; pos its ring positions): scores,
// online softmax step, PV. `n` is the keys the warp must compute (the rest
// invisible to all its rows).
template <int D, bool QUANT, int VIS>
__device__ __forceinline__ void tile_step(Warp<D>& w, const uint8_t* kt, const uint8_t* vt,
                                          const float* ksc, const float* vsc, const int* pos,
                                          int j0, int nk, int n, int lane) {
  constexpr int PROW = Geo<D>::PROW;
  const int tig = lane & 3;
  float s[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
  const uint32_t kb = smem_addr(kt);
  {
    const int key = (lane & 7) + ((lane >> 4) << 3);
    const int dof = ((lane >> 3) & 1) * 8;
#pragma unroll
    for (int jp = 0; jp < 4; ++jp) {
      if (jp * 16 < n) {
#pragma unroll
        for (int ks = 0; ks < D / 16; ++ks) {
          uint32_t b[4];
          ldsm4(b, kb + (jp * 16 + key) * PROW + (ks * 16 + dof) * 2);
          mma16816(s[2 * jp], w.qf[ks], b[0], b[1]);
          mma16816(s[2 * jp + 1], w.qf[ks], b[2], b[3]);
        }
      }
    }
  }
  // scale, mask, the sub-tile's row max over the quad
  float mx[2] = {NEG, NEG};
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = j * 8 + tig * 2 + (e & 1);
      const int r = e >> 1;
      float v = s[j][e];
      if constexpr (QUANT) v = __fmul_rn(v, ksc[c]);
      bool vis = c < nk;
      if constexpr (VIS == VIS_CAUSAL) vis = vis && j0 + c <= w.rpos[r];
      if constexpr (VIS == VIS_RING) {
        const int p = pos[c];
        vis = vis && p >= 0 && p <= w.rpos[r];
      }
      v = vis ? v : NEG;
      s[j][e] = v;
      mx[r] = fmaxf(mx[r], v);
    }
  float alpha[2], ps[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(w.m[r], mx[r]);
    alpha[r] = expf(__fsub_rn(w.m[r], m_new));
    w.m[r] = m_new;
  }
  // p (0 where masked), its sum, times the value scale, as P's A fragments
  uint32_t pa[4][4];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    float p[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e >> 1;
      const float v = s[j][e];
      p[e] = v <= NEG * 0.5f ? 0.f : expf(__fsub_rn(v, w.m[r]));
      ps[r] = __fadd_rn(ps[r], p[e]);
      if constexpr (QUANT) p[e] = __fmul_rn(p[e], vsc[j * 8 + tig * 2 + (e & 1)]);
    }
    pa[j >> 1][(j & 1) * 2] = pack_bf16(p[0], p[1]);
    pa[j >> 1][(j & 1) * 2 + 1] = pack_bf16(p[2], p[3]);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) w.l[r] = fmaf(w.l[r], alpha[r], ps[r]);
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn) {
    w.o[dn][0] = __fmul_rn(w.o[dn][0], alpha[0]);
    w.o[dn][1] = __fmul_rn(w.o[dn][1], alpha[0]);
    w.o[dn][2] = __fmul_rn(w.o[dn][2], alpha[1]);
    w.o[dn][3] = __fmul_rn(w.o[dn][3], alpha[1]);
  }
  const uint32_t vb = smem_addr(vt);
  const int key = lane & 15;
  const int dof = (lane >> 4) * 8;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    if (kk * 16 < n) {
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t b[4];
        ldsm4_t(b, vb + (kk * 16 + key) * PROW + (dp * 16 + dof) * 2);
        mma16816(w.o[2 * dp], pa[kk], b[0], b[1]);
        mma16816(w.o[2 * dp + 1], pa[kk], b[2], b[3]);
      }
    }
  }
}

// The block's shared memory, carved from the dynamic buffer
template <int D, typename KV, int MODE>
struct Smem {
  static constexpr int ST = stage_bytes<D, KV, MODE>();
  uint8_t* stage;  // [2][K, V][ST]
  uint8_t* wide;   // [K, V][BF_TILE], int8 only
  float* sc;       // [2][K, V][KS], int8 only
  int* pos;        // [2][KS], ring only

  __device__ explicit Smem(uint8_t* buf) {
    uint8_t* p = buf + 4 * ST;
    stage = buf;
    wide = p;
    if (sizeof(KV) == 1) p += 2 * Geo<D>::BF_TILE;
    sc = reinterpret_cast<float*>(p);
    if (sizeof(KV) == 1) p += 2 * 2 * KS * sizeof(float);
    pos = reinterpret_cast<int*>(p);
  }
  __device__ uint8_t* buf(int st, int which) const { return stage + (st * 2 + which) * ST; }
};

// Rows of one sub-tile in device memory: K and V rows from k/v (row r at
// + r * D) and, int8, their scales (row r at + r * H)
template <typename E>
struct Rows {
  const E* k;
  const E* v;
  const float* ks;
  const float* vs;
};

// The walk over keys [0, limit) in KV blocks of bk rows, sub-tiles of
// min(KS, bk) rows, cache element type E (the prefix pool's pre-pass: bf16
// over any slot cache); `rows(j0)` addresses sub-tile j0's rows. Every
// thread of the block calls it.
template <int D, typename KV, int MODE, typename E, int VIS, typename RowsOf>
__device__ __forceinline__ void walk(const Smem<D, KV, MODE>& sm, Warp<D>& w, int limit, int bk,
                                     RowsOf rows_of, const Ring& ring, int b, int H, int lane) {
  constexpr bool QUANT = sizeof(E) == 1;
  if (limit <= 0) return;
  const int sub = min(KS, bk);
  const int per = (bk + sub - 1) / sub;
  const int nblk = (limit + bk - 1) / bk;
  const int n_sub = (nblk - 1) * per + (limit - (nblk - 1) * bk + sub - 1) / sub;
  const int srow = QUANT ? D : Geo<D>::PROW;
  auto tile = [&](int i, int& j0, int& nk) {
    const int blk = i / per;
    j0 = blk * bk + (i - blk * per) * sub;
    nk = min(sub, min(blk * bk + bk, limit) - j0);
  };
  auto issue = [&](int i) {
    const int st = i & 1;
    int j0, nk;
    tile(i, j0, nk);
    const Rows<E> r = rows_of(j0);
    load_rows<D, E>(sm.buf(st, 0), srow, r.k, nk);
    load_rows<D, E>(sm.buf(st, 1), srow, r.v, nk);
    if constexpr (QUANT) {
      const int x = threadIdx.x & (KS - 1), which = threadIdx.x / KS;  // THREADS = 2 * KS
      const bool ok = x < nk;
      const float* src = which ? r.vs : r.ks;
      cp4(smem_addr(sm.sc + (st * 2 + which) * KS + x), src + (ok ? (size_t)x * H : 0),
          ok ? 4 : 0);
    }
    if constexpr (VIS == VIS_RING) {
      if (threadIdx.x < KS) {
        const int x = threadIdx.x;
        const bool ok = x < nk;
        cp4(smem_addr(sm.pos + st * KS + x), ring.pos + (ok ? (size_t)(j0 + x) * ring.nb : 0) + b,
            ok ? 4 : 0);
      }
    }
    cp_commit();
  };
  __syncthreads();  // the previous walk's last sub-tile is done with the stages
  issue(0);
  for (int i = 0; i < n_sub; ++i) {
    cp_wait_all();
    __syncthreads();  // sub-tile i landed for all; every warp is done with sub-tile i - 1
    if (i + 1 < n_sub) issue(i + 1);
    int j0, nk;
    tile(i, j0, nk);
    const int st = i & 1;
    const uint8_t* kt = sm.buf(st, 0);
    const uint8_t* vt = sm.buf(st, 1);
    if constexpr (QUANT) {
      const int rows = min(KS, (nk + 15) & ~15);
      widen<D>(sm.wide, kt, rows);
      widen<D>(sm.wide + Geo<D>::BF_TILE, vt, rows);
      __syncthreads();
      kt = sm.wide;
      vt = sm.wide + Geo<D>::BF_TILE;
    }
    // the keys this warp computes: none for a warp past T, the causal
    // mask's visible prefix of the sub-tile, all of it in a ring
    int n = w.active ? nk : 0;
    if constexpr (VIS == VIS_CAUSAL) n = min(n, w.last - j0 + 1);
    if (n > 0)
      tile_step<D, QUANT, VIS>(w, kt, vt, QUANT ? sm.sc + st * 2 * KS : nullptr,
                               QUANT ? sm.sc + (st * 2 + 1) * KS : nullptr,
                               VIS == VIS_RING ? sm.pos + st * KS : nullptr, j0, nk, n, lane);
  }
}

// Attention of query rows [t0, t0 + 64) of (b, h) over one cache layer, on
// the tensor cores: `attend_block`'s operands and result (q bf16, out f32
// [B, T, H, D]), for a bf16 or int8 cache. Every thread of the block calls
// it.
template <int D, typename KV, int MODE>
__device__ __forceinline__ void attend_tc(uint8_t* smem, const __nv_bfloat16* q, const KV* kc,
                                          const KV* vc, const float* ks, const float* vs,
                                          float* out, int b, int h, int t0, int np, int T, int H,
                                          const KVMap& map, int block_k, float scale,
                                          const Ring& ring, const Prefix& pre) {
  static_assert(sizeof(KV) <= 2, "the tensor-core route takes bf16 or int8 caches");
  const Smem<D, KV, MODE> sm(smem);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int tw = t0 + warp * 16;  // the warp's first row
  Warp<D> w;
  w.active = tw < T;
  w.rpos[0] = np + tw + g;
  w.rpos[1] = np + tw + g + 8;
  w.last = np + min(tw + 15, T - 1);
  w.m[0] = w.m[1] = NEG;
  w.l[0] = w.l[1] = 0.f;
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) w.o[dn][e] = 0.f;
  // q * scale rounded to bf16, as A fragments: a0 row g, d 2 tig (+1); a1
  // row g + 8; a2, a3 the same rows at d + 8
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = tw + g + 8 * r;
    const __nv_bfloat16* qr = q + (((size_t)b * T + min(t, T - 1)) * H + h) * D;
#pragma unroll
    for (int kq = 0; kq < D / 16; ++kq)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float x0 = 0.f, x1 = 0.f;
        if (t < T) {
          const float2 v = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(qr + kq * 16 + half * 8 + tig * 2));
          x0 = __fmul_rn(v.x, scale);
          x1 = __fmul_rn(v.y, scale);
        }
        w.qf[kq][r + 2 * half] = pack_bf16(x0, x1);
      }
  }

  const int t_last = min(T, t0 + QT) - 1;
  // columns any row of the block sees (the whole ring unless bounded)
  const int limit = MODE == MODE_RING && !ring.bounded ? map.cap()
                                                       : min(np + t_last + 1, map.cap());
  if constexpr (MODE == MODE_PREFIX) {
    const int plen = pre.len[b];
    const size_t base = ((size_t)pre.id[b] * H + h) * pre.rows * D;
    const __nv_bfloat16* pk = pre.k + base;
    const __nv_bfloat16* pv = pre.v + base;
    walk<D, KV, MODE, __nv_bfloat16, VIS_ALL>(
        sm, w, plen, pre.block_k,
        [=](int j0) {
          return Rows<__nv_bfloat16>{pk + (size_t)j0 * D, pv + (size_t)j0 * D, nullptr, nullptr};
        },
        ring, b, H, lane);
  }
  auto cache_rows = [=](int j0) {
    const int2 at = map.locate(b, j0);
    const size_t off = map.data(at, h, H, D);
    const size_t soff = sizeof(KV) == 1 ? map.scale(at, h, H) : 0;
    return Rows<KV>{kc + off, vc + off, sizeof(KV) == 1 ? ks + soff : nullptr,
                    sizeof(KV) == 1 ? vs + soff : nullptr};
  };
  if constexpr (MODE == MODE_RING)
    walk<D, KV, MODE, KV, VIS_RING>(sm, w, limit, block_k, cache_rows, ring, b, H, lane);
  else
    walk<D, KV, MODE, KV, VIS_CAUSAL>(sm, w, limit, block_k, cache_rows, ring, b, H, lane);

  // l summed over the quad; out = acc / l for the warp's rows < T
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    w.l[r] = __fadd_rn(w.l[r], __shfl_xor_sync(0xffffffffu, w.l[r], 1));
    w.l[r] = __fadd_rn(w.l[r], __shfl_xor_sync(0xffffffffu, w.l[r], 2));
    const int t = tw + g + 8 * r;
    if (t < T) {
      float* orow = out + (((size_t)b * T + t) * H + h) * D;
#pragma unroll
      for (int dn = 0; dn < D / 8; ++dn)
        *reinterpret_cast<float2*>(orow + dn * 8 + tig * 2) =
            make_float2(__fdiv_rn(w.o[dn][2 * r], w.l[r]), __fdiv_rn(w.o[dn][2 * r + 1], w.l[r]));
    }
  }
}

}  // namespace mma
}  // namespace attn
