// Batched single-token decode attention for Hopper (sm_90a): insert each
// row's new K/V row into the cache, then attend, in one launch per layer;
// bf16 caches, int8 caches with per-row scales, and f32 caches, flat or
// paged (q and the new rows f32, nothing rounded to bf16, as
// flash_decode.py:326, :356 there multiply in the cache's type).
//
// Replaces the TPU kernel `_flat_kernel` of llamavk_tpu/ops/flash_decode.py
// (:67, entry `flash_decode_update` :380), flat and page-table modes. The TPU
// kernel runs one program over a flat (row, KV block) work list so that its
// DMA queue stays full across rows; row r owns ceil((n_past[r] + 1) /
// block_k) blocks. Here the grid is a (split, head, row) list instead: the
// split-KV decode kernel of attn_split.cuh, whose split blocks read a row's
// visible rows [0, n_past[b]] in splits of `split_rows(block_k)` rows, all
// loads in flight at once, and merge their partials in the same launch in
// ascending split order. The block whose split holds row n_past[b] first
// writes the new row (int8: quantized by one warp each for K and V, its
// scale written), passes a block barrier and reads it back; no other block
// reads that row, so no second launch is needed.
//
// K2 and K3 take the same kernel at T = 1 (flash_attn.cu's split route), so
// K4 and K2 at T = 1 give bit-equal outputs and caches at equal block_k:
// batched and single-stream decode streams stay comparable, as in the JAX
// package (flash_decode.py:23-26 there).
//
// Page-table mode (flash_decode.py:104-114, :261-273 there): the row of
// batch row b goes to page table[b][n_past / PS], row n_past % PS, and a
// split (which never crosses a page) is read from page table[b][split start
// / PS] (`attn::KVMap`). The serving engine's free slots keep decoding into
// the trash page 0, all at its row 0 in the same launch: those rows race and
// their outputs are garbage, which nothing reads; no live row maps page 0.
//
// `batch_offset` (flat only; the JAX kernel's operand of the same name,
// flash_decode.py:391 there) is the cache row of batch row 0: it offsets the
// layer's base pointers (data and int8 scales) before the launch, so B rows
// run against a wider [B_cache, H, S, D] layer.
//
// What bounds it on an H100: the bytes of every row's valid cache prefix,
// paged or not, sum_b (n_past[b] + 1) * H * D * 2 (K and V) times 2 bytes
// for bf16, 1 for int8 (plus 8 bytes of scales per row and head) or 4 for
// f32, and the new rows written (attn_split.cuh says what the design does
// about them). `route` 0 keeps the CUDA-core kernel (`attend_block`, one block of
// 8 warps per (head, row)) for one purpose: timing it beside the split
// route in the same call (ops/flash_decode.py reads `attn_route`, which
// sends T = 1 to the split route).

#include "attn_split.cuh"

namespace {

using attn::KVMap;
using attn::WARPS;

constexpr int ROUTE_SPLIT = 2;  // ops/flash_attn.py::ROUTE_CODES["split"]

template <int D, typename KV>
__global__ void __launch_bounds__(WARPS * 32)
decode_kernel(const attn::QType<KV>* __restrict__ q,     // [B, 1, H, D]
              const attn::QType<KV>* __restrict__ knew,  // [B, 1, H, D]
              const attn::QType<KV>* __restrict__ vnew, KV* kc, KV* vc, float* ks, float* vs,
              float* __restrict__ out, const int* __restrict__ npast_vec, int npast_scalar,
              KVMap map, int H, int block_k, float scale) {
  constexpr bool QUANT = sizeof(KV) == 1;
  const int h = blockIdx.x, b = blockIdx.y;
  const int np = npast_vec ? npast_vec[b] : npast_scalar;
  const size_t src = ((size_t)b * H + h) * D;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bool in_cache = np >= 0 && np < map.cap();
  const int2 at = in_cache ? map.locate(b, np) : make_int2(0, 0);
  const size_t dst = map.data(at, h, H, D);
  if constexpr (QUANT) {
    const size_t sdst = map.scale(at, h, H);
    if (in_cache && warp == 0) attn::quantize_row<D>(knew + src, kc + dst, ks + sdst, lane);
    if (in_cache && warp == 1) attn::quantize_row<D>(vnew + src, vc + dst, vs + sdst, lane);
  } else if (in_cache) {
    constexpr int CH = D * (int)sizeof(KV) / 16;  // 16-byte chunks of a bf16 or f32 row
    if (threadIdx.x < CH)
      reinterpret_cast<uint4*>(kc + dst)[threadIdx.x] =
          reinterpret_cast<const uint4*>(knew + src)[threadIdx.x];
    else if (threadIdx.x < 2 * CH)
      reinterpret_cast<uint4*>(vc + dst)[threadIdx.x - CH] =
          reinterpret_cast<const uint4*>(vnew + src)[threadIdx.x - CH];
  }
  __syncthreads();  // the row is in the cache before any tile load reads it
  attn::attend_block<D, KV>(q, kc, vc, ks, vs, out, b, h, 0, np, 1, H, map, block_k, scale);
}

template <int D, typename KV>
cudaError_t launch(const void* q, const void* kn, const void* vn, void* kc, void* vc, void* ks,
                   void* vs, void* out, const int* npv, int nps, KVMap map, int B, int H,
                   int block_k, float scale, cudaStream_t st) {
  static size_t dyn_done = 0;
  const size_t dyn = attn::dyn_smem(block_k);
  cudaError_t e = attn::allow_dyn_smem(decode_kernel<D, KV>, dyn, dyn_done);
  if (e != cudaSuccess) return e;
  decode_kernel<D, KV><<<dim3(H, B), WARPS * 32, dyn, st>>>(
      static_cast<const attn::QType<KV>*>(q), static_cast<const attn::QType<KV>*>(kn),
      static_cast<const attn::QType<KV>*>(vn), static_cast<KV*>(kc), static_cast<KV*>(vc),
      static_cast<float*>(ks), static_cast<float*>(vs), static_cast<float*>(out), npv, nps, map, H,
      block_k, scale);
  ++attn::launch_count();
  return cudaGetLastError();
}

template <typename KV>
cudaError_t dispatch(const void* q, const void* kn, const void* vn, void* kc, void* vc, void* ks,
                     void* vs, void* out, const int* npv, int nps, KVMap map, int B, int H, int D,
                     int block_k, float scale, cudaStream_t st) {
  if (D == 128)
    return launch<128, KV>(q, kn, vn, kc, vc, ks, vs, out, npv, nps, map, B, H, block_k, scale, st);
  if (D == 64)
    return launch<64, KV>(q, kn, vn, kc, vc, ks, vs, out, npv, nps, map, B, H, block_k, scale, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// q, k_new, v_new [B, 1, H, D], bf16 (f32 for an f32 cache); k_cache/v_cache
// one layer of type kv_kind (0 bf16, 1 int8, 2 f32), with k_scale/v_scale
// that layer's f32 scale planes for int8 (else null): flat [B, H, S, D] with
// scales [B, S, H] when page_table is null, else a pool
// [NP, H, S, D] with scales [NP, S, H] read through
// page_table [B, maxlb] (S the page's rows); out f32 [B, 1, H, D]; n_past
// from npast_vec[B] (device) when it is not null, else npast_scalar; every
// n_past below the rows a batch row addresses. D in {64, 128}; block_k
// divides S. batch_offset (flat only): the cache row of batch row 0.
// route: ROUTE_SPLIT (2), with split_ws [B, H, split_nx, D + 2] f32 and
// split_cnt [B * H] int32 zeros (attn_split.cuh), split_nx the splits a row
// can address; or 0, the CUDA-core kernel (timing only).
extern "C" int flash_decode_launch(const void* q, const void* k_new, const void* v_new,
                                   void* k_cache, void* v_cache, void* k_scale, void* v_scale,
                                   void* out, const void* npast_vec, int npast_scalar,
                                   const void* page_table, int maxlb, int B, int H, int S, int D,
                                   int block_k, float scale, int kv_kind, int batch_offset,
                                   int route, void* split_ws, void* split_cnt, int split_nx,
                                   void* stream) {
  if (block_k < 1 || S % block_k != 0) return (int)cudaErrorInvalidValue;
  if (page_table && maxlb < 1) return (int)cudaErrorInvalidValue;
  if (kv_kind < 0 || kv_kind > 2) return (int)cudaErrorInvalidValue;
  if (batch_offset < 0 || (batch_offset && page_table)) return (int)cudaErrorInvalidValue;
  if (route != 0 && route != ROUTE_SPLIT) return (int)cudaErrorInvalidValue;
  if (batch_offset) {
    const size_t el = kv_kind == 1 ? 1 : kv_kind == 2 ? 4 : 2;
    const size_t data = (size_t)batch_offset * H * S * D * el;
    k_cache = static_cast<char*>(k_cache) + data;
    v_cache = static_cast<char*>(v_cache) + data;
    if (k_scale) {
      k_scale = static_cast<float*>(k_scale) + (size_t)batch_offset * S * H;
      v_scale = static_cast<float*>(v_scale) + (size_t)batch_offset * S * H;
    }
  }
  auto npv = static_cast<const int*>(npast_vec);
  auto st = static_cast<cudaStream_t>(stream);
  const KVMap map{static_cast<const int*>(page_table), maxlb, S};
  if (route == ROUTE_SPLIT) {
    attn::split::Args a{};
    a.q = q;
    a.knew = k_new;
    a.vnew = v_new;
    a.kc = k_cache;
    a.vc = v_cache;
    a.ks = static_cast<float*>(kv_kind == 1 ? k_scale : nullptr);
    a.vs = static_cast<float*>(kv_kind == 1 ? v_scale : nullptr);
    a.out = static_cast<float*>(out);
    a.npast_vec = a.wrow_vec = npv;
    a.npast_scalar = a.wrow_scalar = npast_scalar;
    a.write = 1;
    a.map = map;
    a.T = 1;
    a.H = H;
    a.block_k = block_k;
    a.scale = scale;
    a.ws = static_cast<float*>(split_ws);
    a.cnt = static_cast<int*>(split_cnt);
    a.nx = split_nx;
    if (kv_kind == 1) return (int)attn::split::launch<int8_t, false>(a, B, D, st);
    if (kv_kind == 2) return (int)attn::split::launch<float, false>(a, B, D, st);
    return (int)attn::split::launch<__nv_bfloat16, false>(a, B, D, st);
  }
  if (kv_kind == 1)
    return (int)dispatch<int8_t>(q, k_new, v_new, k_cache, v_cache, k_scale, v_scale, out, npv,
                                 npast_scalar, map, B, H, D, block_k, scale, st);
  if (kv_kind == 2)
    return (int)dispatch<float>(q, k_new, v_new, k_cache, v_cache, nullptr, nullptr, out, npv,
                                npast_scalar, map, B, H, D, block_k, scale, st);
  return (int)dispatch<__nv_bfloat16>(q, k_new, v_new, k_cache, v_cache, nullptr, nullptr, out,
                                      npv, npast_scalar, map, B, H, D, block_k, scale, st);
}

// The kernel launches this library has made (`attn::launch_count`).
extern "C" long decode_launch_count() { return attn::launch_count().load(); }
