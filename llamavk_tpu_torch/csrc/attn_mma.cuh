// Tensor-core attention of the K2/K3 kernels (flash_attn.cu) for prefill and
// admission chunks: bf16, int8 and f32 caches at T >= MIN_T, every cache
// mode of `attend_block` (flat, paged, ring, prefix, and the flat pipeline
// modes). T from 1 to MIN_T - 1 and K4 take the split route
// (attn_split.cuh).
//
// What it replaces: the CUDA-core walk of `attend_block`, which gives a block
// 8 query rows (one a warp) and scores key by key with scalar fmaf, so each
// K/V tile is read from L2 once per 8 query rows and the 4 * T * S_visible *
// D products run on ~67 TFLOP/s of CUDA cores. A prefill is bound by those
// operations (989 TFLOP/s of bf16 tensor cores on an H100, 495 of TF32)
// long before its bytes; this design moves them onto `mma.sync`.
//
// Design, bf16 and int8 caches (sm_90a; `mma.sync` m16n8k16 bf16 x bf16 ->
// f32, `ldmatrix`, `cp.async`):
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
// Design, f32 caches (3xTF32; `mma.sync` m16n8k8 TF32 x TF32 -> f32). No
// tensor core takes an f32 operand, and one TF32 pass (2^-11 relative an
// operand) misses the f32 limit by ~30x, so each operand x is split into
// TF32 parts hi = rna(x), lo = rna(x - hi) and each product is three passes
// into one f32 accumulator, small terms first: lo*hi, hi*lo, hi*hi (what
// is dropped, lo*lo and the parts' roundings, is ~2^-21 of |x y|). The
// rounding is `cvt.rna.tf32.f32`'s, done in two integer operations
// (mma_ptx.cuh::tf32_rna; faster on the card than `cvt.rna`).
//  * The same block, warps and walk. q * 1/sqrt(D) stays f32 (never bf16)
//    in the warp's m16n8k8 A fragments, 4 a k-step (D / 2 registers); each
//    fragment is split into hi and lo where it is used, once a k-step of a
//    sub-tile (the S product runs k-steps outer), so hi and lo never both
//    live across the walk.
//  * Sub-tiles of min(32, block_k) keys, f32 rows padded to D + 4 floats
//    (a warp's 32-bit fragment reads fall in 32 different banks: K rows g
//    at column t, V rows 2t, 2t + 1 at column g), double-buffered by
//    `cp.async` under the bf16 path's rule (never across a KV block or a
//    page).
//    Once a sub-tile has landed, the block splits it in shared memory (hi
//    in place, lo into one more K and one more V tile), so a warp reads
//    each B fragment's parts with 32-bit shared loads (`ldmatrix` moves b16
//    tiles) and splits only q and p itself. Four stage buffers and the lo
//    tiles take 99 KB at D = 128, so two blocks fit an SM, as their
//    registers allow (255 a thread at D = 128, ptxas -v).
//  * Each k-step's three passes go pass by pass over the warp's independent
//    accumulators (the S tile's 4 n-tiles, 4 d tiles of O at a time), so no
//    `mma.sync` waits on the one before it; each accumulator still sums its
//    passes lo*hi, hi*lo, hi*hi in that order.
//  * O += P V with p in f32, split like the other operands. The m16n8k8 C
//    layout gives a lane keys (2t, 2t + 1) of each 8-key n-tile, where the
//    A fragment wants columns (t, t + 4): the k-step's keys are relabelled
//    (A column t is key 2t, column t + 4 key 2t + 1) and V's B fragment rows
//    read in the same order, so no shuffle moves p. The k-step then sums
//    its 8 keys in that order, in every mode alike.
//  * A prefix pool over f32 slots runs its bf16 pre-pass on the bf16 path
//    (q and p rounded to bf16, as `attend_block` and the JAX kernel do),
//    then the slots on the f32 path; the (m, l, acc) carry is one state.
//  * p = `__expf` (s - m) over an f32 cache (expf on the other paths):
//    faster on the card, and its error (a few ulps where p matters) stays
//    far inside the f32 limit.
//  * Blocks take their row tiles heaviest first (flash_attn.cu::tc_task).
//
// Numerics: the rounding points of `attend_block` (attn_common.cuh:26-40).
// A score is the f32 sum of exact bf16 x bf16 products (the tensor cores'
// f32 accumulation), times the key's scale (int8, `__fmul_rn`), then -1e30
// where the key is not visible; p = 0 for a masked score; l takes p before
// the value scale; p times the value scale is rounded to bf16 for the PV
// product; out = acc / l in f32. Over an f32 cache a product is the three
// TF32 passes' sum instead (within the f32 limit, 2^-12 of attention(q, k,
// |v|)), and nothing is rounded to bf16. The online max and sum step once a
// sub-tile (FA2: a row's max reduced over the quad of lanes that hold it,
// each lane keeping a partial l of its own columns, summed over the quad at
// the end), so only the f32 summation order differs from `attend_block`.
//
// A warp skips a sub-tile, or its 16-key quarters (f32: 8-key n-tiles),
// that no row of its own can see (flat, paged and prefix-slot causal masks;
// never a ring's): such keys have p = 0, so the skipped online step is
// exactly the identity (alpha = exp(0) = 1, l + 0, acc * 1 + 0). Every mode
// runs this code at the same T, so paged = flat at block_k = PS, ring = flat
// before a wrap, prefix = flat at prefix_len 0 and batch_offset = the
// offset rows alone hold bit for bit, as they do for `attend_block`.

#pragma once


#include "attn_common.cuh"
#include "mma_ptx.cuh"

namespace attn {
namespace mma {

constexpr int QT = 64;       // query rows per block
constexpr int WARPS_TC = 4;  // 16 query rows a warp
constexpr int THREADS = WARPS_TC * 32;
constexpr int KS = 64;      // keys per bf16 or int8 sub-tile, at most
constexpr int KS_F32 = 32;  // keys per f32 sub-tile, at most
constexpr int MIN_T = 16;   // the least T this route takes (ops/flash_attn.py::attn_route)

template <int D>
struct Geo {
  static constexpr int PROW = (D + 8) * 2;  // bytes of a padded bf16 row
  static constexpr int BF_TILE = KS * PROW;
  static constexpr int I8_TILE = KS * D;
  static constexpr int FROW = D + 4;  // floats of a padded f32 row
  static constexpr int F32_TILE = KS_F32 * FROW * 4;
};

// bytes of one K or V stage buffer: bf16 rows padded, int8 rows of D bytes,
// or f32 rows padded; a prefix pool's bf16 pre-pass shares the stages with
// int8 or f32 slots
template <int D, typename KV, int MODE>
constexpr int stage_bytes() {
  using G = Geo<D>;
  if (sizeof(KV) == 4)
    return MODE == MODE_PREFIX && G::BF_TILE > G::F32_TILE ? G::BF_TILE : G::F32_TILE;
  return sizeof(KV) == 1 && MODE != MODE_PREFIX ? G::I8_TILE : G::BF_TILE;
}

// dynamic shared memory of a block: 2 stages x (K, V), the widened int8
// tiles and the stages' scales (int8), the stages' ring positions (ring)
template <int D, typename KV, int MODE>
constexpr size_t smem_bytes() {
  return (size_t)4 * stage_bytes<D, KV, MODE>() +
         (sizeof(KV) == 1 ? (size_t)2 * Geo<D>::BF_TILE + 2 * 2 * KS * sizeof(float) : 0) +
         (sizeof(KV) == 4 ? (size_t)2 * Geo<D>::F32_TILE : 0) +
         (MODE == MODE_RING ? (size_t)2 * KS * sizeof(int) : 0);
}

using ptx::cp16;
using ptx::cp4;
using ptx::cp_commit;
using ptx::cp_wait_all;
using ptx::ldsm4;
using ptx::ldsm4_t;
using ptx::mma1688;
using ptx::mma16816;
using ptx::pack_bf16;
using ptx::smem_addr;
using ptx::split_tf32;

// rows [0, nk) of D elements of type E from src (row r at src + r * D) into
// a stage buffer whose rows are `srow` bytes apart; rows [nk, NS) zeroed
template <int D, typename E, int NS>
__device__ __forceinline__ void load_rows(uint8_t* tile, int srow, const E* src, int nk) {
  constexpr int RB = D * (int)sizeof(E);
  constexpr int CH = RB / 16;
  const uint32_t base = smem_addr(tile);
  const uint8_t* s = reinterpret_cast<const uint8_t*>(src);
  for (int e = threadIdx.x; e < NS * CH; e += THREADS) {
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

// A warp's walk state: the output accumulators, and per row (g, g + 8 of
// the warp's 16) the running max and this lane's partial l. q's A
// fragments are the walk's operand of their own: bf16 (`QBf16`) or f32
// (`QF32`), and a prefix pool over f32 slots walks with both in turn.
template <int D>
using QBf16 = uint32_t[D / 16][4];
template <int D>
using QF32 = float[D / 8][4];

template <int D>
struct Warp {
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

// Scores s[NT][4] of a sub-tile's NT 8-key n-tiles (C fragments: row g
// keys 2t, 2t + 1 in e = 0, 1, row g + 8 in e = 2, 3) times the key scales
// (QUANT), -1e30 where a key is not visible; the online max steps to the
// sub-tile's row max over the quad, and alpha = exp(m_old - m_new) of the
// warp's two rows
template <int D, int NT, bool QUANT, int VIS>
__device__ __forceinline__ void mask_max(Warp<D>& w, float (&s)[NT][4], const float* ksc,
                                         const int* pos, int j0, int nk, int tig,
                                         float (&alpha)[2]) {
  float mx[2] = {NEG, NEG};
#pragma unroll
  for (int j = 0; j < NT; ++j)
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
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(w.m[r], mx[r]);
    alpha[r] = expf(__fsub_rn(w.m[r], m_new));
    w.m[r] = m_new;
  }
}

// l = l * alpha + the sub-tile's p sums, and the accumulators times alpha
template <int D>
__device__ __forceinline__ void rescale(Warp<D>& w, const float (&alpha)[2], const float (&ps)[2]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) w.l[r] = fmaf(w.l[r], alpha[r], ps[r]);
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn) {
    w.o[dn][0] = __fmul_rn(w.o[dn][0], alpha[0]);
    w.o[dn][1] = __fmul_rn(w.o[dn][1], alpha[0]);
    w.o[dn][2] = __fmul_rn(w.o[dn][2], alpha[1]);
    w.o[dn][3] = __fmul_rn(w.o[dn][3], alpha[1]);
  }
}

// One sub-tile of keys [j0, j0 + nk) in shared memory (kt/vt padded bf16
// tiles; ksc/vsc its scales when QUANT; pos its ring positions): scores,
// online softmax step, PV. `n` is the keys the warp must compute (the rest
// invisible to all its rows).
template <int D, bool QUANT, int VIS>
__device__ __forceinline__ void tile_step(Warp<D>& w, const QBf16<D>& qf, const uint8_t* kt,
                                          const uint8_t* vt, const float* ksc, const float* vsc,
                                          const int* pos, int j0, int nk, int n, int lane) {
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
          mma16816(s[2 * jp], qf[ks], b[0], b[1]);
          mma16816(s[2 * jp + 1], qf[ks], b[2], b[3]);
        }
      }
    }
  }
  float alpha[2], ps[2] = {0.f, 0.f};
  mask_max<D, 8, QUANT, VIS>(w, s, ksc, pos, j0, nk, tig, alpha);
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
  rescale(w, alpha, ps);
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

// tile_step over an f32 sub-tile (kt/vt padded f32 tiles of KS_F32 rows;
// pos its ring positions) on 3xTF32 m16n8k8: each product lo*hi, hi*lo,
// then hi*hi into one accumulator. `n` as tile_step's, in 8-key n-tiles.
template <int D, int VIS>
__device__ __forceinline__ void tile_step_f32(Warp<D>& w, const QF32<D>& qx, const float* kt,
                                              const float* vt, const float* klo,
                                              const float* vlo, const int* pos, int j0, int nk,
                                              int n, int lane) {
  constexpr int FROW = Geo<D>::FROW;
  constexpr int NT = KS_F32 / 8;
  const int g = lane >> 2, tig = lane & 3;
  // a B fragment element's TF32 parts, from the sub-tile's hi (in place) and
  // lo tiles
  auto part = [&](const float* hi, const float* lo, int off, uint32_t& h, uint32_t& l) {
    h = __float_as_uint(hi[off]);
    l = __float_as_uint(lo[off]);
  };
  float s[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
  // S = Q K^T, k-steps outer: each q fragment split once a sub-tile; B
  // fragment b0 = K[key j * 8 + g][d t], b1 = the same key at d t + 4
#pragma unroll
  for (int ks = 0; ks < D / 8; ++ks) {
    uint32_t ah[4], al[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) split_tf32(qx[ks][e], ah[e], al[e]);
    uint32_t bh[NT][2], bl[NT][2];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      if (j * 8 < n) {
        const int off = (j * 8 + g) * FROW + ks * 8 + tig;
        part(kt, klo, off, bh[j][0], bl[j][0]);
        part(kt, klo, off + 4, bh[j][1], bl[j][1]);
      }
    }
#pragma unroll
    for (int j = 0; j < NT; ++j)
      if (j * 8 < n) mma1688(s[j], al, bh[j][0], bh[j][1]);
#pragma unroll
    for (int j = 0; j < NT; ++j)
      if (j * 8 < n) mma1688(s[j], ah, bl[j][0], bl[j][1]);
#pragma unroll
    for (int j = 0; j < NT; ++j)
      if (j * 8 < n) mma1688(s[j], ah, bh[j][0], bh[j][1]);
  }
  float alpha[2], ps[2] = {0.f, 0.f};
  mask_max<D, NT, false, VIS>(w, s, nullptr, pos, j0, nk, tig, alpha);
  // p (0 where masked) in f32, and its sum
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e >> 1;
      const float v = s[j][e];
      s[j][e] = v <= NEG * 0.5f ? 0.f : __expf(__fsub_rn(v, w.m[r]));
      ps[r] = __fadd_rn(ps[r], s[j][e]);
    }
  rescale(w, alpha, ps);
  // O += P V, one k-step an n-tile j of P with its keys relabelled: A column
  // t is key 2t (C element 0 of row g, 2 of row g + 8), column t + 4 key
  // 2t + 1 (elements 1, 3); B fragment b0 = V[key j * 8 + 2t][d g], b1 =
  // V[key j * 8 + 2t + 1][d g] of each 8-wide d tile
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    if (j * 8 < n) {
      uint32_t ph[4], pl[4];
      split_tf32(s[j][0], ph[0], pl[0]);
      split_tf32(s[j][2], ph[1], pl[1]);
      split_tf32(s[j][1], ph[2], pl[2]);
      split_tf32(s[j][3], ph[3], pl[3]);
      const int off = (j * 8 + 2 * tig) * FROW + g;
      constexpr int DC = 4;  // 8-wide d tiles a chunk
#pragma unroll
      for (int d0 = 0; d0 < D / 8; d0 += DC) {
        uint32_t bh[DC][2], bl[DC][2];
#pragma unroll
        for (int c = 0; c < DC; ++c) {
          part(vt, vlo, off + (d0 + c) * 8, bh[c][0], bl[c][0]);
          part(vt, vlo, off + FROW + (d0 + c) * 8, bh[c][1], bl[c][1]);
        }
#pragma unroll
        for (int c = 0; c < DC; ++c) mma1688(w.o[d0 + c], pl, bh[c][0], bh[c][1]);
#pragma unroll
        for (int c = 0; c < DC; ++c) mma1688(w.o[d0 + c], ph, bl[c][0], bl[c][1]);
#pragma unroll
        for (int c = 0; c < DC; ++c) mma1688(w.o[d0 + c], ph, bh[c][0], bh[c][1]);
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
  float* lo;       // [K, V][F32_TILE / 4], the current f32 sub-tile's lo parts
  int* pos;        // [2][KS], ring only

  __device__ explicit Smem(uint8_t* buf) {
    uint8_t* p = buf + 4 * ST;
    stage = buf;
    wide = p;
    if (sizeof(KV) == 1) p += 2 * Geo<D>::BF_TILE;
    sc = reinterpret_cast<float*>(p);
    if (sizeof(KV) == 1) p += 2 * 2 * KS * sizeof(float);
    lo = reinterpret_cast<float*>(p);
    if (sizeof(KV) == 4) p += 2 * Geo<D>::F32_TILE;
    pos = reinterpret_cast<int*>(p);
  }
  __device__ uint8_t* buf(int st, int which) const { return stage + (st * 2 + which) * ST; }
};

// f32 rows [0, rows) of a stage tile split into TF32 parts: hi in place,
// lo into `lo` (the same padded layout), 16 bytes a thread
template <int D>
__device__ __forceinline__ void split_tile(float* t, float* lo, int rows) {
  constexpr int FROW = Geo<D>::FROW, CH = D / 4;
  for (int e = threadIdx.x; e < rows * CH; e += THREADS) {
    const int r = e / CH, c = e - r * CH;
    float4* ph = reinterpret_cast<float4*>(t + r * FROW + c * 4);
    float4 x = *ph, h, l;
    uint32_t a, b;
    split_tf32(x.x, a, b);
    h.x = __uint_as_float(a), l.x = __uint_as_float(b);
    split_tf32(x.y, a, b);
    h.y = __uint_as_float(a), l.y = __uint_as_float(b);
    split_tf32(x.z, a, b);
    h.z = __uint_as_float(a), l.z = __uint_as_float(b);
    split_tf32(x.w, a, b);
    h.w = __uint_as_float(a), l.w = __uint_as_float(b);
    *ph = h;
    *reinterpret_cast<float4*>(lo + r * FROW + c * 4) = l;
  }
}

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
// min(KS, bk) rows (f32: min(KS_F32, bk)), cache element type E (the prefix
// pool's pre-pass: bf16 over any slot cache) with q's fragments qf of that
// type's path (QBf16, or QF32 for f32); `rows(j0)` addresses sub-tile j0's
// rows. Every thread of the block calls it.
template <int D, typename KV, int MODE, typename E, int VIS, typename QF, typename RowsOf>
__device__ __forceinline__ void walk(const Smem<D, KV, MODE>& sm, Warp<D>& w, const QF& qf,
                                     int limit, int bk, RowsOf rows_of, const Ring& ring, int b,
                                     int H, int lane) {
  constexpr bool QUANT = sizeof(E) == 1;
  constexpr bool F32 = sizeof(E) == 4;
  constexpr int NS = F32 ? KS_F32 : KS;  // the sub-tile's rows, at most
  if (limit <= 0) return;
  const int sub = min(NS, bk);
  const int per = (bk + sub - 1) / sub;
  const int nblk = (limit + bk - 1) / bk;
  const int n_sub = (nblk - 1) * per + (limit - (nblk - 1) * bk + sub - 1) / sub;
  const int srow = F32 ? Geo<D>::FROW * 4 : QUANT ? D : Geo<D>::PROW;
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
    load_rows<D, E, NS>(sm.buf(st, 0), srow, r.k, nk);
    load_rows<D, E, NS>(sm.buf(st, 1), srow, r.v, nk);
    if constexpr (QUANT) {
      const int x = threadIdx.x & (KS - 1), which = threadIdx.x / KS;  // THREADS = 2 * KS
      const bool ok = x < nk;
      const float* src = which ? r.vs : r.ks;
      cp4(smem_addr(sm.sc + (st * 2 + which) * KS + x), src + (ok ? (size_t)x * H : 0),
          ok ? 4 : 0);
    }
    if constexpr (VIS == VIS_RING) {
      if (threadIdx.x < NS) {
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
    if constexpr (F32) {  // rows past nk to the n-tile's end are zeros: their lo too
      const int rows = min(NS, (nk + 7) & ~7);
      split_tile<D>(reinterpret_cast<float*>(sm.buf(st, 0)), sm.lo, rows);
      split_tile<D>(reinterpret_cast<float*>(sm.buf(st, 1)), sm.lo + Geo<D>::F32_TILE / 4, rows);
      __syncthreads();
    }
    // the keys this warp computes: none for a warp past T, the causal
    // mask's visible prefix of the sub-tile, all of it in a ring
    int n = w.active ? nk : 0;
    if constexpr (VIS == VIS_CAUSAL) n = min(n, w.last - j0 + 1);
    const int* pos = VIS == VIS_RING ? sm.pos + st * KS : nullptr;
    if (n > 0) {
      if constexpr (F32)
        tile_step_f32<D, VIS>(w, qf, reinterpret_cast<const float*>(kt),
                              reinterpret_cast<const float*>(vt), sm.lo,
                              sm.lo + Geo<D>::F32_TILE / 4, pos, j0, nk, n, lane);
      else
        tile_step<D, QUANT, VIS>(w, qf, kt, vt, QUANT ? sm.sc + st * 2 * KS : nullptr,
                                 QUANT ? sm.sc + (st * 2 + 1) * KS : nullptr, pos, j0, nk, n,
                                 lane);
    }
  }
}

__device__ __forceinline__ float2 ld_f2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float2 ld_f2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

// q * scale rounded to bf16, as m16n8k16 A fragments of the warp's rows tw
// + g, tw + g + 8 (0 past T): a0 row g, d 2 tig (+1); a1 row g + 8; a2, a3
// the same rows at d + 8. q bf16, or f32 for a prefix pool over f32 slots.
template <int D, typename QE>
__device__ __forceinline__ void q_bf16(QBf16<D>& qf, const QE* q, int b, int h, int tw, int T,
                                       int H, float scale, int lane) {
  const int g = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = tw + g + 8 * r;
    const QE* qr = q + (((size_t)b * T + min(t, T - 1)) * H + h) * D;
#pragma unroll
    for (int kq = 0; kq < D / 16; ++kq)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float x0 = 0.f, x1 = 0.f;
        if (t < T) {
          const float2 v = ld_f2(qr + kq * 16 + half * 8 + tig * 2);
          x0 = __fmul_rn(v.x, scale);
          x1 = __fmul_rn(v.y, scale);
        }
        qf[kq][r + 2 * half] = pack_bf16(x0, x1);
      }
  }
}

// q * scale in f32, as m16n8k8 TF32 A fragments (split where they are
// used): a0 row g, d tig; a1 row g + 8; a2, a3 the same rows at d + 4
template <int D>
__device__ __forceinline__ void q_f32(QF32<D>& qx, const float* q, int b, int h, int tw, int T,
                                      int H, float scale, int lane) {
  const int g = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = tw + g + 8 * r;
    const float* qr = q + (((size_t)b * T + min(t, T - 1)) * H + h) * D;
#pragma unroll
    for (int ks = 0; ks < D / 8; ++ks)
#pragma unroll
      for (int half = 0; half < 2; ++half)
        qx[ks][r + 2 * half] = t < T ? __fmul_rn(qr[ks * 8 + half * 4 + tig], scale) : 0.f;
  }
}

// Attention of query rows [t0, t0 + 64) of (b, h) over one cache layer, on
// the tensor cores: `attend_block`'s operands and result (q QType<KV>, out
// f32 [B, T, H, D]), for a bf16, int8 or f32 cache. Every thread of the
// block calls it.
template <int D, typename KV, int MODE>
__device__ __forceinline__ void attend_tc(uint8_t* smem, const QType<KV>* q, const KV* kc,
                                          const KV* vc, const float* ks, const float* vs,
                                          float* out, int b, int h, int t0, int np, int T, int H,
                                          const KVMap& map, int block_k, float scale,
                                          const Ring& ring, const Prefix& pre) {
  constexpr bool F32 = std::is_same<KV, float>::value;
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

  const int t_last = min(T, t0 + QT) - 1;
  // columns any row of the block sees (the whole ring unless bounded)
  const int limit = MODE == MODE_RING && !ring.bounded ? map.cap()
                                                       : min(np + t_last + 1, map.cap());
  // the prefix pool's pre-pass: bf16 rows, q rounded to bf16 over any slot
  // type (an f32 slot cache included)
  auto prefix_pass = [&](const QBf16<D>& qf) {
    if constexpr (MODE == MODE_PREFIX) {
      const int plen = pre.len[b];
      const size_t base = ((size_t)pre.id[b] * H + h) * pre.rows * D;
      const __nv_bfloat16* pk = pre.k + base;
      const __nv_bfloat16* pv = pre.v + base;
      walk<D, KV, MODE, __nv_bfloat16, VIS_ALL>(
          sm, w, qf, plen, pre.block_k,
          [=](int j0) {
            return Rows<__nv_bfloat16>{pk + (size_t)j0 * D, pv + (size_t)j0 * D, nullptr,
                                       nullptr};
          },
          ring, b, H, lane);
    }
  };
  auto cache_pass = [&](const auto& qf) {
    auto cache_rows = [=](int j0) {
      const int2 at = map.locate(b, j0);
      const size_t off = map.data(at, h, H, D);
      const size_t soff = sizeof(KV) == 1 ? map.scale(at, h, H) : 0;
      return Rows<KV>{kc + off, vc + off, sizeof(KV) == 1 ? ks + soff : nullptr,
                      sizeof(KV) == 1 ? vs + soff : nullptr};
    };
    if constexpr (MODE == MODE_RING)
      walk<D, KV, MODE, KV, VIS_RING>(sm, w, qf, limit, block_k, cache_rows, ring, b, H, lane);
    else
      walk<D, KV, MODE, KV, VIS_CAUSAL>(sm, w, qf, limit, block_k, cache_rows, ring, b, H, lane);
  };
  if constexpr (F32) {
    if constexpr (MODE == MODE_PREFIX) {
      QBf16<D> qf;
      q_bf16<D>(qf, q, b, h, tw, T, H, scale, lane);
      prefix_pass(qf);
    }
    QF32<D> qx;  // loaded after the pre-pass: the two never live at once
    q_f32<D>(qx, q, b, h, tw, T, H, scale, lane);
    cache_pass(qx);
  } else {
    QBf16<D> qf;
    q_bf16<D>(qf, q, b, h, tw, T, H, scale, lane);
    prefix_pass(qf);
    cache_pass(qf);
  }

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
