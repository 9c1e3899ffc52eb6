// Shared attention code of the fused KV-write attention (flash_attn.cu, K2
// and K3), the batched decode attention (flash_decode.cu, K4) and the
// one-launch prefill probe (probe_prefill_direct.cu).
//
// `quantize_row` is the int8 row write of every route. `attend_block` is
// the first CUDA-core attention, which no production call takes any more (the
// split route of attn_split.cuh takes T from 1 to 15, the tensor cores T >=
// 16): it stays for K4's and K2/K3's route 0, by which chip_smoke.py times
// the replaced design beside the others in the same call, and for the
// probe. Every float operation whose order matters is an explicit intrinsic
// (`__fmul_rn`, `fmaf`, ...), so the compiler cannot contract them
// differently in two translation units.
//
// KV element types: `__nv_bfloat16` (bf16 cache, no scales), `int8_t`
// (int8 cache with one f32 scale per (position, head) row, scale planes
// [B, S, H] per layer, as ops/kv_quant.py lays them out) or `float` (f32
// cache, no scales). q is bf16 for a bf16 or int8 cache and f32
// for an f32 one (`QType`).
//
// Cache modes (`KVMap`): a flat layer [B, H, S, D], or a page pool layer
// [NP, H, PS, D] (scales [NP, PS, H]) read through a block table [B, MAXLB]
// (llamavk_tpu/ops/flash_attn.py:565-577 there, runtime/paged.py here).
// Paging changes only where a row is read from: the caller fits the KV
// block to divide the page, so each KV block lies in one page, its base is
// looked up once per block, and the rows inside it are contiguous as in a
// flat layer. Every float operation, and its order, is the same in both
// modes: a paged call equals a flat one with block_k = PS bit for bit.
//
// Numerics (flash_attn.py:738-808 there): q is scaled by 1/sqrt(D) in f32
// and rounded to bf16; a score is the f32 sum of bf16(q) * bf16(k) products
// (an int8 key converts to bf16 exactly), times the key row's k-scale for
// int8, then -1e30 where the key is past the query's position; the online
// max and sum run in f32 over KV blocks of exactly `block_k` rows; the sum
// l takes p before the v-scale; p is multiplied by the v-scale (int8) and
// rounded to bf16 for the PV product; out = acc / l. An f32 cache has no
// bf16 rounding point (the JAX kernel multiplies in the cache's own type,
// flash_attn.py:749, :798 there): q * scale stays f32 and p enters the PV
// product unrounded. On the split route (attn_split.cuh, T 1-15) and in
// `attend_block` a score is the f32 sum of f32 products; on the tensor-core
// route (attn_mma.cuh, T >= 16) each product, of the scores and of PV, is
// instead the sum of three TF32 passes over the operands' hi and lo parts
// (~2^-21 of the product), within the same f32 limit. The rounding is
// chosen by the KV type alone (`op_round`), so the bf16 and int8 code is
// the code it was. The split route rescales per split and merges in f32
// (attn_split.cuh), one more order within the same limits.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>

namespace attn {

// The kernel launches a library built from these sources has made: every
// `<<<>>>` of the attention kernels and their row writes adds one (read
// through flash_attn.cu's `attn_launch_count` and flash_decode.cu's
// `decode_launch_count`), so a caller can count a call's launches. Internal
// linkage: each library keeps its own count, where an inline function's
// static would be one object shared by both libraries once both are loaded.
namespace {
inline std::atomic<long>& launch_count() {
  static std::atomic<long> n{0};
  return n;
}
}  // namespace

constexpr int WARPS = 8;  // query rows per block, one per warp
constexpr int KT = 64;    // keys per shared tile
constexpr float NEG = -1e30f;

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// the query type of a KV type: f32 for an f32 cache, else bf16
template <typename KV>
using QType = typename std::conditional<std::is_same<KV, float>::value, float,
                                        __nv_bfloat16>::type;

__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_float(float v) { return v; }

// an operand of the products: rounded to bf16 for a bf16 or int8 cache,
// unrounded for an f32 one
template <typename KV>
__device__ __forceinline__ float op_round(float v) {
  if constexpr (std::is_same<KV, float>::value) return v;
  return bf16_round(v);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Bytes per key row in a shared tile: an odd number of 4-byte words, so 32
// lanes reading 32 consecutive rows hit 32 different banks.
template <int D, typename KV>
struct Row {
  static constexpr int BYTES = D * (int)sizeof(KV) + 4;
};

// Where a layer keeps logical row j of batch row b. Flat (table null): block
// b of a layer [B, H, S, D], row j. Paged: page table[b * maxlb + j / PS] of
// a pool layer [NP, H, PS, D], row j % PS. `rows` is S or PS.
struct KVMap {
  const int* table;  // [B, maxlb] int32 on the device, or null for a flat layer
  int maxlb;
  int rows;

  // logical rows a batch row can address
  __device__ __forceinline__ int cap() const { return table ? maxlb * rows : rows; }
  // (block, row in it) of logical row j of batch row b
  __device__ __forceinline__ int2 locate(int b, int j) const {
    if (!table) return make_int2(b, j);
    const int p = j / rows;
    return make_int2(__ldg(table + (size_t)b * maxlb + p), j - p * rows);
  }
  // element offset of that row of head h in a data layer [*, H, rows, D]
  __device__ __forceinline__ size_t data(int2 at, int h, int H, int D) const {
    return (((size_t)at.x * H + h) * rows + at.y) * D;
  }
  // offset of that row's scale of head h in a scale layer [*, rows, H]
  __device__ __forceinline__ size_t scale(int2 at, int h, int H) const {
    return ((size_t)at.x * rows + at.y) * H + h;
  }
};

// nk rows of D elements from base + j0 * D into the tile (16-byte global
// reads through L2 only: K4 reads rows its own block wrote in this launch).
template <int D, typename KV>
__device__ __forceinline__ void load_tile(uint8_t* tile, const KV* base, int j0, int nk) {
  constexpr int RB = Row<D, KV>::BYTES;
  constexpr int CH = D * (int)sizeof(KV) / 16;  // 16-byte chunks per row
  const uint8_t* src = reinterpret_cast<const uint8_t*>(base + (size_t)j0 * D);
  for (int e = threadIdx.x; e < nk * CH; e += blockDim.x) {
    const int key = e / CH, c = e - key * CH;
    const uint4 v = __ldcg(reinterpret_cast<const uint4*>(src + (size_t)key * D * sizeof(KV)) + c);
    uint32_t* dst = reinterpret_cast<uint32_t*>(tile + key * RB + c * 16);
    dst[0] = v.x;
    dst[1] = v.y;
    dst[2] = v.z;
    dst[3] = v.w;
  }
}

// q_s . key row, summed in order over d
template <int D>
__device__ __forceinline__ float key_dot(const float* q_s, const uint8_t* row, __nv_bfloat16) {
  const __nv_bfloat162* kr = reinterpret_cast<const __nv_bfloat162*>(row);
  float s = 0.f;
#pragma unroll 16
  for (int d2 = 0; d2 < D / 2; ++d2) {
    const float2 kf = __bfloat1622float2(kr[d2]);
    s = fmaf(q_s[2 * d2], kf.x, s);
    s = fmaf(q_s[2 * d2 + 1], kf.y, s);
  }
  return s;
}

template <int D>
__device__ __forceinline__ float key_dot(const float* q_s, const uint8_t* row, int8_t) {
  const char4* kr = reinterpret_cast<const char4*>(row);
  float s = 0.f;
#pragma unroll 8
  for (int d4 = 0; d4 < D / 4; ++d4) {
    const char4 c = kr[d4];
    s = fmaf(q_s[4 * d4], (float)c.x, s);
    s = fmaf(q_s[4 * d4 + 1], (float)c.y, s);
    s = fmaf(q_s[4 * d4 + 2], (float)c.z, s);
    s = fmaf(q_s[4 * d4 + 3], (float)c.w, s);
  }
  return s;
}

template <int D>
__device__ __forceinline__ float key_dot(const float* q_s, const uint8_t* row, float) {
  const float* kr = reinterpret_cast<const float*>(row);
  float s = 0.f;
#pragma unroll 16
  for (int d = 0; d < D; ++d) s = fmaf(q_s[d], kr[d], s);
  return s;
}

// acc[e] += p * v[lane * DPL + e] for this lane's DPL = D / 32 output dims
template <int D>
__device__ __forceinline__ void v_accum(float* acc, float p, const uint8_t* row, int lane,
                                        __nv_bfloat16) {
  constexpr int DPL = D / 32;
  const __nv_bfloat162* vr = reinterpret_cast<const __nv_bfloat162*>(row) + lane * (DPL / 2);
#pragma unroll
  for (int e2 = 0; e2 < DPL / 2; ++e2) {
    const float2 vf = __bfloat1622float2(vr[e2]);
    acc[2 * e2] = fmaf(p, vf.x, acc[2 * e2]);
    acc[2 * e2 + 1] = fmaf(p, vf.y, acc[2 * e2 + 1]);
  }
}

template <int D>
__device__ __forceinline__ void v_accum(float* acc, float p, const uint8_t* row, int lane, int8_t) {
  constexpr int DPL = D / 32;
  const int8_t* vr = reinterpret_cast<const int8_t*>(row) + lane * DPL;
#pragma unroll
  for (int e = 0; e < DPL; ++e) acc[e] = fmaf(p, (float)vr[e], acc[e]);
}

template <int D>
__device__ __forceinline__ void v_accum(float* acc, float p, const uint8_t* row, int lane, float) {
  constexpr int DPL = D / 32;
  const float* vr = reinterpret_cast<const float*>(row) + lane * DPL;
#pragma unroll
  for (int e = 0; e < DPL; ++e) acc[e] = fmaf(p, vr[e], acc[e]);
}

inline size_t dyn_smem(int block_k) { return (size_t)WARPS * block_k * sizeof(float); }

// Attention modes of the K2/K3 kernels beyond the flat and paged cache
// (llamavk_tpu/ops/flash_attn.py:512-808 there). K4 uses MODE_PLAIN only.
//  * MODE_RING, the history ring: a key row's logical position is pos[j * nb
//    + b] of the position plane [S, B] (-1 = empty), and row j is visible to
//    a query at logical position p iff 0 <= pos <= p (:763-778). The plane
//    is read, never written, here. Without `bounded` the whole ring is
//    scanned; with it the scan stops where the flat one would (:555-563),
//    which is exact while pos[r] >= r (rings the engine fills).
//  * MODE_PREFIX, the shared-prefix pool: before the slot loop, the block
//    walks rows [0, len[b]) of pool entry id[b] ([NP, H, rows, D] bf16 per
//    layer, KV blocks of `block_k` rows that divide `rows`), unmasked but for
//    col < len, and its (m, l, acc) carry flows into the slot loop, whose
//    n_past is the slot-local one (:643-735). The pool is bf16 whatever the
//    slot cache holds, so the pre-pass has its own bf16 tile (an f32 slot
//    cache lends it its own), and it rounds q to bf16 and p to bf16 over
//    every slot type, an f32 one included (flash_attn.py:697-713 there).
enum { MODE_PLAIN = 0, MODE_RING = 1, MODE_PREFIX = 2 };

struct Ring {
  const int* pos;  // [S, nb] int32 logical positions
  int nb;
  int bounded;
};

struct Prefix {
  const __nv_bfloat16* k;  // one layer of the pool [NP, H, rows, D]
  const __nv_bfloat16* v;
  const int* id;   // [B] pool entry of each batch row
  const int* len;  // [B] valid prefix rows
  int rows;
  int block_k;
};

// One KV block [kb0, kb1) of the online softmax, for the rows of a block of
// warps: scores (masked by `vis(col)`), the running max and sum, then the PV
// sum. kbase/vbase (and ksb/vsb, int8 only) address the block's first row.
// A score that is masked (-1e30) gets p = 0 (flash_attn.py:783-786 there): a
// block can be fully masked for a row while its running max is still -1e30
// (empty or future ring rows), and exp(0) would then count each such key
// once. Where the running max is finite the masked p is already exactly 0.
template <int D, typename KV, typename Vis>
__device__ __forceinline__ void online_block(uint8_t* tile, const float* qw, float* sc,
                                             const KV* kbase, const KV* vbase, const float* ksb,
                                             const float* vsb, int H, int kb0, int kb1,
                                             bool active, int lane, float& m, float& l,
                                             float* acc, Vis vis) {
  constexpr bool QUANT = sizeof(KV) == 1;
  constexpr int DPL = D / 32;
  constexpr int RB = Row<D, KV>::BYTES;
  // scores of this KV block: lane j scores keys j, j + 32, ... of a tile
  for (int j0 = kb0; j0 < kb1; j0 += KT) {
    const int nk = min(KT, kb1 - j0);
    __syncthreads();
    load_tile<D, KV>(tile, kbase, j0 - kb0, nk);
    __syncthreads();
    if (active) {
      for (int kk = lane; kk < nk; kk += 32) {
        float s = key_dot<D>(qw, tile + kk * RB, KV());
        const int col = j0 + kk;
        if constexpr (QUANT) s = __fmul_rn(s, __ldcg(ksb + (size_t)(col - kb0) * H));
        sc[col - kb0] = vis(col) ? s : NEG;
      }
    }
  }
  // online softmax update over the whole block
  if (active) {
    __syncwarp();
    const int nkb = kb1 - kb0;
    float bm = NEG;
    for (int j = lane; j < nkb; j += 32) bm = fmaxf(bm, sc[j]);
    const float m_new = fmaxf(m, warp_max(bm));
    const float alpha = expf(__fsub_rn(m, m_new));
    float ps = 0.f;
    for (int j = lane; j < nkb; j += 32) {
      const float s = sc[j];
      float p = s <= NEG * 0.5f ? 0.f : expf(__fsub_rn(s, m_new));
      ps = __fadd_rn(ps, p);
      if constexpr (QUANT) p = __fmul_rn(p, __ldcg(vsb + (size_t)j * H));
      sc[j] = op_round<KV>(p);
    }
    l = fmaf(l, alpha, warp_sum(ps));
#pragma unroll
    for (int e = 0; e < DPL; ++e) acc[e] = __fmul_rn(acc[e], alpha);
    m = m_new;
    __syncwarp();
  }
  // PV over the block, keys in order
  for (int j0 = kb0; j0 < kb1; j0 += KT) {
    const int nk = min(KT, kb1 - j0);
    __syncthreads();
    load_tile<D, KV>(tile, vbase, j0 - kb0, nk);
    __syncthreads();
    if (active) {
      const float* pj = sc + (j0 - kb0);
      for (int kk = 0; kk < nk; ++kk) v_accum<D>(acc, pj[kk], tile + kk * RB, lane, KV());
    }
  }
}

// Attention of query rows [t0, t0 + WARPS) of (b, h) over one cache layer.
// Every thread of the block calls it (it synchronises the block); warp w
// owns row t0 + w when that row is < T.
//   q    [B, T, H, D] QType<KV>     out [B, T, H, D] f32
//   kc/vc one layer, ks/vs its f32 scales (int8 only), addressed by `map`
//   np   the row's n_past: query t sits at position np + t (logical in a
//        ring, slot-local over a prefix)
// block_k divides map.rows, so no KV block crosses a page.
template <int D, typename KV, int MODE = MODE_PLAIN>
__device__ __forceinline__ void attend_block(const QType<KV>* q, const KV* kc, const KV* vc,
                                             const float* ks, const float* vs, float* out,
                                             int b, int h, int t0, int np, int T, int H,
                                             const KVMap& map, int block_k, float scale,
                                             const Ring& ring = Ring{},
                                             const Prefix& pre = Prefix{}) {
  constexpr bool QUANT = sizeof(KV) == 1;
  constexpr int DPL = D / 32;
  __shared__ __align__(16) uint8_t tile[KT * Row<D, KV>::BYTES];
  __shared__ float q_s[WARPS][D];
  extern __shared__ float sc_all[];  // [WARPS][block_k]: scores, then p (bf16(p) if it rounds)

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t = t0 + warp;
  const bool active = t < T;
  const int row_pos = np + t;
  const int t_last = min(T, t0 + WARPS) - 1;
  // columns any row of the block sees (the whole ring unless bounded)
  const int limit = MODE == MODE_RING && !ring.bounded ? map.cap()
                                                       : min(np + t_last + 1, map.cap());
  float* sc = sc_all + warp * block_k;

  // q * scale, rounded as the KV type R multiplies it, into the warp's row
  // (read after the block barrier that starts each KV tile)
  auto stage_q = [&](auto round_as) {
    using R = decltype(round_as);
    if (active)
      for (int d = lane; d < D; d += 32)
        q_s[warp][d] =
            op_round<R>(__fmul_rn(to_float(q[(((size_t)b * T + t) * H + h) * D + d]), scale));
  };
  // the bf16 pool's pre-pass rounds q to bf16 over any slot type
  // (flash_attn.py:697-713 there); the slots then take it as their type does
  if constexpr (MODE == MODE_PREFIX)
    stage_q(__nv_bfloat16());
  else
    stage_q(KV());

  float m = NEG, l = 0.f;
  float acc[DPL];
#pragma unroll
  for (int e = 0; e < DPL; ++e) acc[e] = 0.f;

  if constexpr (MODE == MODE_PREFIX) {
    // an f32 slot tile holds a bf16 pool tile: the pre-pass reuses it, as
    // the two would pass the 48 KB of static shared memory at D = 128
    constexpr bool SHARE = sizeof(KV) == 4;
    __shared__ __align__(16) uint8_t own[SHARE ? 16 : KT * Row<D, __nv_bfloat16>::BYTES];
    uint8_t* ptile = SHARE ? tile : own;
    const int plen = pre.len[b];
    const size_t base = ((size_t)pre.id[b] * H + h) * pre.rows * D;
    for (int kb0 = 0; kb0 < plen; kb0 += pre.block_k) {
      const int kb1 = min(kb0 + pre.block_k, plen);
      online_block<D, __nv_bfloat16>(ptile, q_s[warp], sc, pre.k + base + (size_t)kb0 * D,
                                     pre.v + base + (size_t)kb0 * D, nullptr, nullptr, H, kb0,
                                     kb1, active, lane, m, l, acc,
                                     [plen](int col) { return col < plen; });
    }
    if constexpr (SHARE) stage_q(KV());  // the f32 slots keep q unrounded (:749-753)
  }

  const int nblocks = (limit + block_k - 1) / block_k;
  for (int i = 0; i < nblocks; ++i) {
    const int kb0 = i * block_k;
    const int kb1 = min(kb0 + block_k, limit);
    // the block's rows are contiguous from its first: row kb0 + j of the
    // block at kbase + j * D, its scale at ksb[j * H]
    const int2 at = map.locate(b, kb0);
    const KV* kbase = kc + map.data(at, h, H, D);
    const KV* vbase = vc + map.data(at, h, H, D);
    const float* ksb = QUANT ? ks + map.scale(at, h, H) : nullptr;
    const float* vsb = QUANT ? vs + map.scale(at, h, H) : nullptr;
    if constexpr (MODE == MODE_RING) {
      const int* pos = ring.pos;
      const int nb = ring.nb;
      online_block<D, KV>(tile, q_s[warp], sc, kbase, vbase, ksb, vsb, H, kb0, kb1, active, lane,
                          m, l, acc, [pos, nb, b, row_pos](int col) {
                            const int p = __ldg(pos + (size_t)col * nb + b);
                            return p >= 0 && p <= row_pos;
                          });
    } else {
      online_block<D, KV>(tile, q_s[warp], sc, kbase, vbase, ksb, vsb, H, kb0, kb1, active, lane,
                          m, l, acc, [row_pos](int col) { return col <= row_pos; });
    }
  }

  if (active) {
    float* o = out + (((size_t)b * T + t) * H + h) * D + lane * DPL;
#pragma unroll
    for (int e = 0; e < DPL; ++e) o[e] = __fdiv_rn(acc[e], l);
  }
}

// One warp quantizes one row of D bf16 values (ops/kv_quant.py): scale =
// amax * f32(1/127), as XLA compiles the JAX package's amax / 127 (1 for an
// all-zero row), q = rint(x / scale) with a true division, clipped to
// +-127; rintf rounds half to even, as jnp.round does.
template <int D>
__device__ __forceinline__ void quantize_row(const __nv_bfloat16* src, int8_t* dst, float* sdst,
                                             int lane) {
  constexpr int E = D / 32;
  float x[E];
  float amax = 0.f;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    x[e] = __bfloat162float(src[lane * E + e]);
    amax = fmaxf(amax, fabsf(x[e]));
  }
  amax = warp_max(amax);
  const float s = amax > 0.f ? __fmul_rn(amax, 1.0f / 127.0f) : 1.f;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const float r = fminf(fmaxf(rintf(__fdiv_rn(x[e], s)), -127.f), 127.f);
    dst[lane * E + e] = (int8_t)r;
  }
  if (lane == 0) *sdst = s;
}

// Allows `dyn` bytes of dynamic shared memory for `kernel` (needed above
// 48 KB in all); `done` remembers the largest size already allowed.
template <typename K>
inline cudaError_t allow_dyn_smem(K kernel, size_t dyn, size_t& done) {
  if (dyn <= done) return cudaSuccess;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dyn);
  if (e == cudaSuccess) done = dyn;
  return e;
}

}  // namespace attn
