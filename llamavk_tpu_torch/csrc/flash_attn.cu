// Causal attention over the KV cache for Hopper (sm_90a), and the fused cache
// write that precedes it; bf16 caches, int8 caches with per-row scales, and
// f32 caches.
//
// Replaces two TPU kernels of llamavk_tpu/ops/flash_attn.py, in their flat
// and page-table cache modes, over bf16, int8 and f32 caches (an f32 cache:
// q and the new rows arrive as f32, and nothing is rounded to bf16, as the
// JAX kernels multiply in the cache's type, flash_attn.py:749, :798 there):
//  * `_update_kernel` (:120, entry `flash_attention_update`): write T new
//    K/V rows at [n_past, n_past+T) of layer l (int8: quantize each row and
//    write its scale), then attend;
//  * `_read_kernel` -> `_attend` (:474, :512, entry `flash_attention`):
//    attend over a cache that already holds the rows.
//
// The TPU update kernel runs its t-blocks in order on one core, so a t-block
// may read rows an earlier t-block just wrote. GPU blocks run in no order.
// On the split route (T from 1 to 15) the block whose split holds a new row
// writes it and then reads it, and no other block reads it (attn_split.cuh),
// so the write is fused into the one launch. On the tensor-core route (T >=
// 16) the write is its own launch (`kv_write_kernel`, or `kv_quant_kernel`
// for int8: one warp per (b, t, h) row, amax by warp reduction) and the
// attention a second launch on the same stream: every row the attention
// reads is written before it starts. Either way int8 rows are attended as
// their quantized values, read back from the cache.
//
// Page-table mode (`page_table` [B, MAXLB], the cache a pool layer
// [NP, H, PS, D], int8 scales [NP, PS, H]; the JAX kernel's `page_table`
// operand, flash_attn.py:1029-1039 there): each write looks up the page of
// its own row, so it writes exactly the rows [n_past, n_past + T) it owns,
// through the table, and nothing else; the attention reads KV block i of
// row b from page table[b][i * block_k / PS] (attn_common.cuh, `KVMap`).
// The table is read by every block from device memory: the TPU's scalar
// prefetch has no counterpart here.
//
// Ring mode (the JAX kernels' `kv_pos`/`write_row`, flash_attn.py:145-147,
// :191, :555-563, :763-786 there): the write lands row t at physical row
// write_row[b] + t while n_past stays the logical query position, and the
// attention masks by the position plane [S, B] (int32, compared as
// integers); bf16, int8 and f32 caches. Prefix mode (`prefix_k/v/id/len`,
// :643-735 there): the attention first walks the row's entry of the bf16
// shared-prefix pool, and n_past is the slot-local row; bf16, int8 and f32
// slots (the pool pass rounds q and p to bf16 over every slot type).
// Both are the MODE template argument of either route, so the flat and
// paged kernels keep their code.
//
// Pipeline-parallel modes (the JAX kernels' `batch_offset` and `commit`,
// flash_attn.py:827, :1018-1023, :275-291 there): `batch_offset` is the
// first cache row of the call's batch, so a microbatch of B rows runs
// against a full-batch flat cache [B_cache, H, S, D] without slicing it; here
// it offsets the cache base pointers (data and int8 scales) once, for the
// row-write launch and the attention launch alike. `commit` = 0 skips the
// row write: every cache byte stays as it was and the attention reads the
// unchanged rows, as the JAX kernel's idle pipeline hop does. Both are flat
// only (no page table, ring or prefix).
//
// The attention launch takes one of two routes, which the caller picks
// from T and the cache type alone (`route`; ops/flash_attn.py::attn_route):
//  * the split route, attn_split.cuh, for T from 1 to 15 over every cache
//    type and mode (decode steps, lookup and speculative verify rounds,
//    short admission chunks): the split-KV kernel shared with the batched
//    decode kernel (flash_decode.cu), so K4 and K2 at T = 1 give bit-equal
//    outputs and caches at equal block_k. A (batch row, head)'s visible rows
//    are cut into splits of `split_rows(block_k)` rows, a block each for
//    every query row of the call, their partials merged in the same launch
//    in ascending split order; the update's row writes are fused into the
//    launch (the block whose split holds a row writes it, then reads it), so
//    K2 at T 1-15 is one launch;
//  * the tensor-core route, `attn::mma::attend_tc` of attn_mma.cuh, for T >=
//    16 (prefill, admission chunks) over every cache type. A block owns 64
//    query rows (16 a warp); QK^T and PV run on `mma.sync` with the scores
//    in registers, over K/V sub-tiles double-buffered by `cp.async`: bf16
//    and int8 caches on m16n8k16 bf16 products, f32 caches on three m16n8k8
//    TF32 passes a product (each f32 operand split into TF32 hi and lo
//    parts), nothing rounded to bf16.
// A third, the CUDA-core route (`attn::attend_block` of attn_common.cuh, a
// block of 8 warps owning 8 query rows of one (batch, head)), is taken by
// no production call: it stays for timing the replaced design beside the
// others in the same call (chip_smoke.py's `cuda_core_ms`), at any T.
// Every route gives a paged call equal to a flat one at block_k = PS bit for
// bit, and keeps every mode's bit-equalities. Blocks past a row's last
// visible column contribute exactly zero, so reading only up to the tile's
// last visible column does not change the result. The CUDA-core and
// tensor-core routes write the rows of an update in a launch of their own
// first (`kv_write_kernel`, `kv_quant_kernel`).
//
// What bounds it on an H100: decode and verify (T 1-15) read the valid
// cache prefix of one layer, paged or not (2 * H * n_past * D bytes of int8,
// twice that of bf16, four times that of f32, plus 8 * n_past * H bytes of
// int8 scales), plus the new rows, and are bound by those bytes, which the
// split route spreads over (split, head, row) blocks with every load in
// flight, each block serving every query row;
// prefill is bound by its operations (4 * T * S_visible * D per head),
// which the tensor-core route puts on the tensor cores (an f32 cache: three
// TF32 passes, ~165 TFLOP/s of f32-accurate products at most, against 67 on
// the CUDA cores). wgmma/TMA attention is later work.

#include "attn_mma.cuh"
#include "attn_split.cuh"

namespace {

using attn::KVMap;
using attn::WARPS;

// k_new/v_new row t of batch row b lands at cache row wrow[b] + t (wrow is
// n_past, or the ring's physical write row)
__device__ __forceinline__ int write_row(const int* wrow_vec, int wrow_scalar, int b, int t) {
  return (wrow_vec ? wrow_vec[b] : wrow_scalar) + t;
}

// k_new/v_new [B, T, H, D] -> cache layer rows wrow[b] + t (through
// `map`), in the cache's type E (bf16 or f32), 16 bytes per thread
template <typename E>
__global__ void kv_write_kernel(const E* __restrict__ knew, const E* __restrict__ vnew,
                                E* __restrict__ kc, E* __restrict__ vc,
                                const int* __restrict__ wrow_vec, int wrow_scalar, KVMap map,
                                int B, int T, int H, int D) {
  constexpr int PER = 16 / (int)sizeof(E);  // elements per 16-byte chunk
  const int chunks = D / PER;
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t total = (size_t)B * T * H * chunks;
  if (idx >= total) return;
  const int c = (int)(idx % chunks);
  size_t r = idx / chunks;
  const int h = (int)(r % H);
  r /= H;
  const int t = (int)(r % T);
  const int b = (int)(r / T);
  const int row = write_row(wrow_vec, wrow_scalar, b, t);
  if (row < 0 || row >= map.cap()) return;
  const size_t src = (((size_t)b * T + t) * H + h) * D + c * PER;
  const size_t dst = map.data(map.locate(b, row), h, H, D) + c * PER;
  *reinterpret_cast<uint4*>(kc + dst) = *reinterpret_cast<const uint4*>(knew + src);
  *reinterpret_cast<uint4*>(vc + dst) = *reinterpret_cast<const uint4*>(vnew + src);
}

// k_new/v_new [B, T, H, D] bf16 -> int8 cache layer rows and their f32
// scales (through `map`); one warp per (b, t, h) row
template <int D>
__global__ void __launch_bounds__(WARPS * 32)
kv_quant_kernel(const __nv_bfloat16* __restrict__ knew, const __nv_bfloat16* __restrict__ vnew,
                int8_t* __restrict__ kc, int8_t* __restrict__ vc, float* __restrict__ ks,
                float* __restrict__ vs, const int* __restrict__ wrow_vec, int wrow_scalar,
                KVMap map, int B, int T, int H) {
  const size_t r = (size_t)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (r >= (size_t)B * T * H) return;
  const int lane = threadIdx.x & 31;
  const int h = (int)(r % H);
  const int t = (int)((r / H) % T);
  const int b = (int)(r / ((size_t)H * T));
  const int row = write_row(wrow_vec, wrow_scalar, b, t);
  if (row < 0 || row >= map.cap()) return;
  const int2 at = map.locate(b, row);
  const size_t dst = map.data(at, h, H, D);
  const size_t sdst = map.scale(at, h, H);
  attn::quantize_row<D>(knew + r * D, kc + dst, ks + sdst, lane);
  attn::quantize_row<D>(vnew + r * D, vc + dst, vs + sdst, lane);
}

template <int D, typename KV, int MODE>
__global__ void __launch_bounds__(WARPS * 32)
attn_kernel(const attn::QType<KV>* __restrict__ q, const KV* kc, const KV* vc, const float* ks,
            const float* vs, float* __restrict__ out, const int* __restrict__ npast_vec,
            int npast_scalar, KVMap map, int T, int H, int block_k, float scale, attn::Ring ring,
            attn::Prefix pre) {
  const int b = blockIdx.z;
  const int np = npast_vec ? npast_vec[b] : npast_scalar;
  attn::attend_block<D, KV, MODE>(q, kc, vc, ks, vs, out, b, blockIdx.y, blockIdx.x * WARPS, np,
                                  T, H, map, block_k, scale, ring, pre);
}

// The task (row tile x, head, batch row) of a tensor-core block. bf16 and
// int8 caches keep the grid's order (x fastest). Over an f32 cache a row
// tile's work grows with x (the causal mask's visible columns), and the
// blocks are long (two fit an SM), so they take their tasks heaviest x
// first. Where the grid fits in two blocks an SM, the blocks past the first
// `nsm` (the scheduler deals blocks out one an SM in index order) take the
// rest in reverse, so an SM's second block is one of the lightest tiles
// left; a larger grid keeps heaviest first throughout. The order moves no
// result, only which SM computes it, and only the time (faster on the card
// for the f32 prefills of chip_smoke.py's kernels phase).
template <typename KV>
__device__ __forceinline__ int3 tc_task(int nsm) {
  if (!std::is_same<KV, float>::value) return make_int3(blockIdx.x, blockIdx.y, blockIdx.z);
  const int hb = gridDim.y * gridDim.z, n = gridDim.x * hb;
  int k = blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z);
  if (k >= nsm && n <= 2 * nsm) k = n - 1 - (k - nsm);
  return make_int3(gridDim.x - 1 - k / hb, (k % hb) % gridDim.y, (k % hb) / gridDim.y);
}

// The tensor-core route: 64 query rows a block (attn_mma.cuh)
template <int D, typename KV, int MODE>
__global__ void __launch_bounds__(attn::mma::THREADS)
attn_tc_kernel(const attn::QType<KV>* __restrict__ q, const KV* kc, const KV* vc, const float* ks,
               const float* vs, float* __restrict__ out, const int* __restrict__ npast_vec,
               int npast_scalar, KVMap map, int T, int H, int block_k, float scale,
               attn::Ring ring, attn::Prefix pre, int nsm) {
  extern __shared__ __align__(16) uint8_t tc_smem[];
  const int3 task = tc_task<KV>(nsm);
  const int b = task.z;
  const int np = npast_vec ? npast_vec[b] : npast_scalar;
  attn::mma::attend_tc<D, KV, MODE>(tc_smem, q, kc, vc, ks, vs, out, b, task.y,
                                    task.x * attn::mma::QT, np, T, H, map, block_k, scale,
                                    ring, pre);
}

// the SMs of the current device (read once)
inline int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  }
  return n;
}

template <int D, typename KV, int MODE>
cudaError_t launch_tc(const void* q, const void* kc, const void* vc, const float* ks,
                      const float* vs, void* out, const int* npast_vec, int npast_scalar,
                      KVMap map, int B, int T, int H, int block_k, float scale,
                      const attn::Ring& ring, const attn::Prefix& pre, cudaStream_t stream) {
  static size_t dyn_done = 0;
  constexpr size_t dyn = attn::mma::smem_bytes<D, KV, MODE>();
  cudaError_t e = attn::allow_dyn_smem(attn_tc_kernel<D, KV, MODE>, dyn, dyn_done);
  if (e != cudaSuccess) return e;
  dim3 grid((T + attn::mma::QT - 1) / attn::mma::QT, H, B);
  attn_tc_kernel<D, KV, MODE><<<grid, attn::mma::THREADS, dyn, stream>>>(
      static_cast<const attn::QType<KV>*>(q), static_cast<const KV*>(kc),
      static_cast<const KV*>(vc), ks, vs, static_cast<float*>(out), npast_vec, npast_scalar,
      map, T, H, block_k, scale, ring, pre, sm_count());
  ++attn::launch_count();
  return cudaGetLastError();
}

template <int D, typename KV, int MODE>
cudaError_t launch_attn(const void* q, const void* kc, const void* vc, const float* ks,
                        const float* vs, void* out, const int* npast_vec, int npast_scalar,
                        KVMap map, int B, int T, int H, int block_k, float scale,
                        const attn::Ring& ring, const attn::Prefix& pre, cudaStream_t stream) {
  static size_t dyn_done = 0;
  const size_t dyn = attn::dyn_smem(block_k);
  cudaError_t e = attn::allow_dyn_smem(attn_kernel<D, KV, MODE>, dyn, dyn_done);
  if (e != cudaSuccess) return e;
  dim3 grid((T + WARPS - 1) / WARPS, H, B);
  attn_kernel<D, KV, MODE><<<grid, WARPS * 32, dyn, stream>>>(
      static_cast<const attn::QType<KV>*>(q), static_cast<const KV*>(kc),
      static_cast<const KV*>(vc), ks, vs, static_cast<float*>(out), npast_vec, npast_scalar, map,
      T, H, block_k, scale, ring, pre);
  ++attn::launch_count();
  return cudaGetLastError();
}

// The attention launches of the K2/K3 routes (`route`, checked by the
// caller: the tensor-core route at T >= 16 only, the split route at T 1-15
// only; the split route launches through `split_route`)
enum { ROUTE_CUDA_CORE = 0, ROUTE_TENSOR_CORE = 1, ROUTE_SPLIT = 2 };

template <int D, typename KV, int MODE>
cudaError_t launch_route(int route, const void* q, const void* kc, const void* vc,
                         const float* ks, const float* vs, void* out, const int* npast_vec,
                         int npast_scalar, KVMap map, int B, int T, int H, int block_k,
                         float scale, const attn::Ring& ring, const attn::Prefix& pre,
                         cudaStream_t st) {
  if (route == ROUTE_TENSOR_CORE)
    return launch_tc<D, KV, MODE>(q, kc, vc, ks, vs, out, npast_vec, npast_scalar, map, B, T, H,
                                  block_k, scale, ring, pre, st);
  return launch_attn<D, KV, MODE>(q, kc, vc, ks, vs, out, npast_vec, npast_scalar, map, B, T, H,
                                  block_k, scale, ring, pre, st);
}

template <int D, typename KV>
cudaError_t launch_mode(int route, const void* q, const void* kc, const void* vc,
                        const float* ks, const float* vs, void* out, const int* npast_vec,
                        int npast_scalar, KVMap map, int B, int T, int H, int block_k,
                        float scale, const attn::Ring& ring, const attn::Prefix& pre,
                        cudaStream_t st) {
  if (ring.pos)
    return launch_route<D, KV, attn::MODE_RING>(route, q, kc, vc, ks, vs, out, npast_vec,
                                                npast_scalar, map, B, T, H, block_k, scale, ring,
                                                pre, st);
  if (pre.k)
    return launch_route<D, KV, attn::MODE_PREFIX>(route, q, kc, vc, ks, vs, out, npast_vec,
                                                  npast_scalar, map, B, T, H, block_k, scale,
                                                  ring, pre, st);
  return launch_route<D, KV, attn::MODE_PLAIN>(route, q, kc, vc, ks, vs, out, npast_vec,
                                               npast_scalar, map, B, T, H, block_k, scale, ring,
                                               pre, st);
}

template <typename KV>
cudaError_t attend(int route, const void* q, const void* kc, const void* vc, const void* ks,
                   const void* vs, void* out, const int* npast_vec, int npast_scalar, KVMap map,
                   int B, int T, int H, int D, int block_k, float scale, const attn::Ring& ring,
                   const attn::Prefix& pre, cudaStream_t st) {
  auto kss = static_cast<const float*>(ks);
  auto vss = static_cast<const float*>(vs);
  if (D == 128)
    return launch_mode<128, KV>(route, q, kc, vc, kss, vss, out, npast_vec, npast_scalar, map, B,
                                T, H, block_k, scale, ring, pre, st);
  if (D == 64)
    return launch_mode<64, KV>(route, q, kc, vc, kss, vss, out, npast_vec, npast_scalar, map, B,
                               T, H, block_k, scale, ring, pre, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// The ring and prefix operands of a call (null pointers: the mode is off).
// pos [S, B] int32 ring positions, ring_bounded the ragged scan bound;
// wrow_vec [B] (device) or wrow_scalar: the ring's physical write rows, used
// by the update path in place of n_past when has_wrow; pk/pv one layer of the
// bf16 prefix pool [NP, H, sp, D], pid/plen [B] int32, pblock_k dividing sp.
struct AttnModes {
  const void* pos;
  int ring_bounded;
  const void* wrow_vec;
  int wrow_scalar;
  int has_wrow;
  const void* pk;
  const void* pv;
  const void* pid;
  const void* plen;
  int sp;
  int pblock_k;
};

namespace {

// the device-side mode operands of `modes` (which may be null)
cudaError_t mode_args(const AttnModes* modes, int B, attn::Ring& ring, attn::Prefix& pre) {
  ring = attn::Ring{};
  pre = attn::Prefix{};
  if (!modes) return cudaSuccess;
  if (modes->pos) ring = attn::Ring{static_cast<const int*>(modes->pos), B, modes->ring_bounded};
  if (modes->pk) {
    if (!modes->pv || !modes->pid || !modes->plen || modes->pblock_k < 1 ||
        modes->sp % modes->pblock_k != 0 || ring.pos)
      return cudaErrorInvalidValue;
    pre = attn::Prefix{static_cast<const __nv_bfloat16*>(modes->pk),
                       static_cast<const __nv_bfloat16*>(modes->pv),
                       static_cast<const int*>(modes->pid), static_cast<const int*>(modes->plen),
                       modes->sp, modes->pblock_k};
  }
  return cudaSuccess;
}

}  // namespace

// Cache types of the C interface (`kv_kind`).
enum { KV_BF16 = 0, KV_INT8 = 1, KV_F32 = 2 };

namespace {

// the cache layer's base pointers moved to batch row `batch_offset` of a
// flat [B_cache, H, S, D] layer (scales [B_cache, S, H])
template <typename P, typename SP>
void offset_batch(P& kc, P& vc, SP& ks, SP& vs, int batch_offset, int kv_kind, int H, int S,
                  int D) {
  const size_t el = kv_kind == KV_INT8 ? 1 : kv_kind == KV_F32 ? 4 : 2;
  const size_t data = (size_t)batch_offset * H * S * D * el;
  kc = reinterpret_cast<P>(reinterpret_cast<uintptr_t>(kc) + data);
  vc = reinterpret_cast<P>(reinterpret_cast<uintptr_t>(vc) + data);
  if (ks) {
    const size_t sc = (size_t)batch_offset * S * H * sizeof(float);
    ks = reinterpret_cast<SP>(reinterpret_cast<uintptr_t>(ks) + sc);
    vs = reinterpret_cast<SP>(reinterpret_cast<uintptr_t>(vs) + sc);
  }
}

}  // namespace

namespace {

// a route the C interfaces take for a call at T (every cache type)
bool route_ok(int route, int T) {
  if (route == ROUTE_SPLIT) return T >= 1 && T < attn::mma::MIN_T;
  if (route == ROUTE_TENSOR_CORE) return T >= attn::mma::MIN_T;
  return route == ROUTE_CUDA_CORE;
}

// The split route's one launch at T from 1 to 15 (attn_split.cuh): with
// `write`, new row t of k_new/v_new goes to row wrv[b] + t (or wrs + t)
// first; split_ws/split_cnt the partials and counters, split_nx the splits a
// row can address.
int split_route(const void* q, const void* k_new, const void* v_new, const void* kc,
                const void* vc, const void* ks, const void* vs, void* out, const int* npv,
                int nps, const int* wrv, int wrs, int write, const KVMap& map, int B, int T,
                int H, int D, int block_k, float scale, int kv_kind, const attn::Ring& ring,
                const attn::Prefix& pre, void* split_ws, void* split_cnt, int split_nx,
                cudaStream_t st) {
  attn::split::Args a{};
  a.q = q;
  a.knew = k_new;
  a.vnew = v_new;
  a.kc = const_cast<void*>(kc);
  a.vc = const_cast<void*>(vc);
  a.ks = kv_kind == KV_INT8 ? static_cast<float*>(const_cast<void*>(ks)) : nullptr;
  a.vs = kv_kind == KV_INT8 ? static_cast<float*>(const_cast<void*>(vs)) : nullptr;
  a.out = static_cast<float*>(out);
  a.npast_vec = npv;
  a.npast_scalar = nps;
  a.wrow_vec = wrv;
  a.wrow_scalar = wrs;
  a.write = write;
  a.map = map;
  a.T = T;
  a.H = H;
  a.block_k = block_k;
  a.scale = scale;
  a.ring = ring;
  a.pre = pre;
  a.ws = static_cast<float*>(split_ws);
  a.cnt = static_cast<int*>(split_cnt);
  a.nx = split_nx;
  if (kv_kind == KV_INT8) return (int)attn::split::launch<int8_t, true>(a, B, D, st);
  if (kv_kind == KV_F32) return (int)attn::split::launch<float, true>(a, B, D, st);
  return (int)attn::split::launch<__nv_bfloat16, true>(a, B, D, st);
}

}  // namespace

// Read path (K3). q [B, T, H, D], bf16 (f32 for an f32 cache); k_cache/v_cache:
// one layer of type kv_kind, with k_scale/v_scale that layer's f32 scale
// planes for int8 (else null): flat [B, H, S, D] with scales [B, S, H] when page_table is
// null, else a pool [NP, H, S, D] with scales [NP, S, H] read through
// page_table [B, maxlb] (S the page's rows); out f32 [B, T, H, D]; n_past
// from npast_vec[B] (device) when it is not null, else npast_scalar; `modes`
// (or null) the ring or prefix operands, on a flat cache only; every cache
// type takes every mode. D in {64, 128}; block_k divides S.
// batch_offset (flat, no ring or prefix) is the cache row of batch row 0:
// the flat layer pointers address a [B_cache, ...] layer with
// B_cache >= batch_offset + B. route: ROUTE_CUDA_CORE, ROUTE_TENSOR_CORE
// at T >= 16, or ROUTE_SPLIT at T 1-15 (refused otherwise), with split_ws [B, H, T, split_nx, D + 2] f32 and split_cnt
// [B * H] int32 zeros (null on the other routes), split_nx the pool's and
// the cache's splits a row can address (attn_split.cuh).
extern "C" int attn_read_launch(const void* q, const void* k_cache, const void* v_cache,
                                const void* k_scale, const void* v_scale, void* out,
                                const void* npast_vec, int npast_scalar, const void* page_table,
                                int maxlb, int B, int T, int H, int S, int D, int block_k,
                                float scale, int kv_kind, int batch_offset,
                                const AttnModes* modes, int route, void* split_ws,
                                void* split_cnt, int split_nx, void* stream) {
  if (block_k < 1 || S % block_k != 0) return (int)cudaErrorInvalidValue;
  if (kv_kind < KV_BF16 || kv_kind > KV_F32) return (int)cudaErrorInvalidValue;
  if (!route_ok(route, T)) return (int)cudaErrorInvalidValue;
  if (page_table && maxlb < 1) return (int)cudaErrorInvalidValue;
  attn::Ring ring;
  attn::Prefix pre;
  cudaError_t e = mode_args(modes, B, ring, pre);
  if (e != cudaSuccess) return (int)e;
  if (page_table && (ring.pos || pre.k)) return (int)cudaErrorInvalidValue;
  if (batch_offset < 0 || (batch_offset && (page_table || ring.pos || pre.k)))
    return (int)cudaErrorInvalidValue;
  if (batch_offset) offset_batch(k_cache, v_cache, k_scale, v_scale, batch_offset, kv_kind, H, S, D);
  auto npv = static_cast<const int*>(npast_vec);
  auto st = static_cast<cudaStream_t>(stream);
  const KVMap map{static_cast<const int*>(page_table), maxlb, S};
  if (route == ROUTE_SPLIT)
    return split_route(q, nullptr, nullptr, k_cache, v_cache, k_scale, v_scale, out, npv,
                       npast_scalar, nullptr, 0, 0, map, B, T, H, D, block_k, scale, kv_kind,
                       ring, pre, split_ws, split_cnt, split_nx, st);
  if (kv_kind == KV_INT8)
    return (int)attend<int8_t>(route, q, k_cache, v_cache, k_scale, v_scale, out, npv,
                               npast_scalar, map, B, T, H, D, block_k, scale, ring, pre, st);
  if (kv_kind == KV_F32)
    return (int)attend<float>(route, q, k_cache, v_cache, nullptr, nullptr, out, npv,
                              npast_scalar, map, B, T, H, D, block_k, scale, ring, pre, st);
  return (int)attend<__nv_bfloat16>(route, q, k_cache, v_cache, nullptr, nullptr, out, npv,
                                    npast_scalar, map, B, T, H, D, block_k, scale, ring, pre, st);
}

// Update path (K2): write k_new/v_new [B, T, H, D] (bf16; f32 for an f32
// cache) into rows [n_past, n_past + T) of the cache layer (int8: quantized,
// with their scales; paged: through the table; ring: rows [write_row,
// write_row + T)), then attend by `route`, as the read path: one launch on
// the split route (T 1-15), two on the others. batch_offset as the read
// path's; commit = 0 writes nothing and attends over the unchanged cache
// (one launch).
extern "C" int attn_update_launch(const void* q, const void* k_new, const void* v_new,
                                  void* k_cache, void* v_cache, void* k_scale, void* v_scale,
                                  void* out, const void* npast_vec, int npast_scalar,
                                  const void* page_table, int maxlb, int B, int T, int H, int S,
                                  int D, int block_k, float scale, int kv_kind, int batch_offset,
                                  int commit, const AttnModes* modes, int route,
                                  void* split_ws, void* split_cnt, int split_nx, void* stream) {
  if (block_k < 1 || S % block_k != 0 || (D != 64 && D != 128)) return (int)cudaErrorInvalidValue;
  if (kv_kind < KV_BF16 || kv_kind > KV_F32) return (int)cudaErrorInvalidValue;
  if (!route_ok(route, T)) return (int)cudaErrorInvalidValue;
  if (page_table && maxlb < 1) return (int)cudaErrorInvalidValue;
  if (batch_offset < 0 || (batch_offset && (page_table || (modes && (modes->pos || modes->pk)))))
    return (int)cudaErrorInvalidValue;
  if (batch_offset) offset_batch(k_cache, v_cache, k_scale, v_scale, batch_offset, kv_kind, H, S, D);
  if (!commit)
    return attn_read_launch(q, k_cache, v_cache, k_scale, v_scale, out, npast_vec, npast_scalar,
                            page_table, maxlb, B, T, H, S, D, block_k, scale, kv_kind, 0, modes,
                            route, split_ws, split_cnt, split_nx, stream);
  auto st = static_cast<cudaStream_t>(stream);
  const bool ring_write = modes && modes->has_wrow;
  auto wrv = static_cast<const int*>(ring_write ? modes->wrow_vec : npast_vec);
  const int wrs = ring_write ? modes->wrow_scalar : npast_scalar;
  const KVMap map{static_cast<const int*>(page_table), maxlb, S};
  if (route == ROUTE_SPLIT) {  // the write and the attention in one launch
    attn::Ring ring;
    attn::Prefix pre;
    cudaError_t e = mode_args(modes, B, ring, pre);
    if (e != cudaSuccess) return (int)e;
    if (page_table && (ring.pos || pre.k)) return (int)cudaErrorInvalidValue;
    return split_route(q, k_new, v_new, k_cache, v_cache, k_scale, v_scale, out,
                       static_cast<const int*>(npast_vec), npast_scalar, wrv, wrs, 1, map, B, T,
                       H, D, block_k, scale, kv_kind, ring, pre, split_ws, split_cnt, split_nx,
                       st);
  }
  auto kn = static_cast<const __nv_bfloat16*>(k_new);
  auto vn = static_cast<const __nv_bfloat16*>(v_new);
  if (kv_kind == KV_INT8) {
    const size_t rows = (size_t)B * T * H;
    const unsigned grid = (unsigned)((rows + WARPS - 1) / WARPS);
    auto kq = static_cast<int8_t*>(k_cache);
    auto vq = static_cast<int8_t*>(v_cache);
    auto ksp = static_cast<float*>(k_scale);
    auto vsp = static_cast<float*>(v_scale);
    if (D == 128)
      kv_quant_kernel<128><<<grid, WARPS * 32, 0, st>>>(kn, vn, kq, vq, ksp, vsp, wrv, wrs, map,
                                                        B, T, H);
    else
      kv_quant_kernel<64><<<grid, WARPS * 32, 0, st>>>(kn, vn, kq, vq, ksp, vsp, wrv, wrs, map,
                                                       B, T, H);
  } else if (kv_kind == KV_F32) {
    const size_t total = (size_t)B * T * H * (D / 4);
    kv_write_kernel<float><<<(unsigned)((total + 255) / 256), 256, 0, st>>>(
        static_cast<const float*>(k_new), static_cast<const float*>(v_new),
        static_cast<float*>(k_cache), static_cast<float*>(v_cache), wrv, wrs, map, B, T, H, D);
  } else {
    const size_t total = (size_t)B * T * H * (D / 8);
    kv_write_kernel<__nv_bfloat16><<<(unsigned)((total + 255) / 256), 256, 0, st>>>(
        kn, vn, static_cast<__nv_bfloat16*>(k_cache), static_cast<__nv_bfloat16*>(v_cache), wrv,
        wrs, map, B, T, H, D);
  }
  ++attn::launch_count();
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return attn_read_launch(q, k_cache, v_cache, k_scale, v_scale, out, npast_vec, npast_scalar,
                          page_table, maxlb, B, T, H, S, D, block_k, scale, kv_kind, 0, modes,
                          route, nullptr, nullptr, 0, stream);
}

// The kernel launches this library has made (`attn::launch_count`).
extern "C" long attn_launch_count() { return attn::launch_count().load(); }
