// B4's mma engine: one-token attention over the paged KV pool for Hopper
// (sm_90a), bf16 pages and query, in one launch.
//
// Replaces, for bf16 pages with G = H/Hkv <= 16 and D in {64, 128, 256}:
// src/repro/kernels/flash_decode.py, flash_decode_paged_pallas /
// _paged_kernel (grid (B*Hkv, max_pages), one physical page per sequential
// grid step through the scalar-prefetched page table, online softmax over
// the G query heads of a kv head).  f32 and int8 pages stay on the SIMT
// kernel (flash_decode_paged.cu + decode_combine.cuh);
// core/geometry.py:decode_engine chooses.
//
// What bounds it on the H100: bytes.  A decode step reads every live K/V
// row of every sequence once for 4G FLOP per row element (G = 8 for
// gemma_2b's MQA).  The SIMT kernel split the KV axis into ~66 slices of one
// 16-position chunk each, loaded K/V as scalar 2-byte values widened to f32
// in shared memory, read the page table once per element, ran QK^T as one
// warp per (head, position) pair and wrote 2048 f32 partials per slice for
// a second launch to read back.  Here:
//
// - Grid (slices, B*Hkv): one CTA per (sequence, kv head, KV slice); the
//   slices of a row are one thread-block cluster of at most 8.  The split
//   is core/geometry.py:decode_kv_split of the table's width in pages; a
//   slice is a run of whole pages of the table.
// - One producer thread walks the slice's pages, reads each page-table
//   entry once and skips unmapped (-1) pages and pages wholly past seq_len
//   or before the window.  Each live page is one stage per 16 positions:
//   the page's K and V rows of this kv head (16 rows x D bf16 each) land by
//   TMA in the stage ring of decode_mma.cuh.  The maps are 3-D over
//   (positions of the pool, Hkv, D), so one box is 16 rows x 64 columns of
//   one kv head: D/64 boxes each for K and V per stage.  The tile's mask
//   sees the rows below seq_len, inside the window and inside the page.
// - The consumers (QK^T and PV on mma.sync, the online softmax, masked V
//   rows zeroed) and the merge (in the CTA, then over the cluster through
//   distributed shared memory, O / l written in bf16) are decode_mma.cuh's,
//   shared with B6's mma engine (flash_decode_mma.cu).  No partials in
//   device memory, no second launch, no atomics: bit-equal from call to
//   call.
#include "decode_mma.cuh"

namespace {

using dmma::BOX;
using dmma::MAX_SPLIT;
using dmma::THREADS;
using dmma::TILE;

// A 3-D bf16 tensor map over a page pool (positions, Hkv, D) with box
// (16 positions, 1 head, 64 columns), 128-byte swizzle, zero fill past the
// pool's last position.
inline int make_pool_map(CUtensorMap* map, const void* pages, long rows,
                         int Hkv, int D) {
  wg::EncodeTiled fn = wg::encode_tiled();
  if (fn == nullptr) return wg::ENTRY_ERROR;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(Hkv),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(D) * 2,
                                 static_cast<cuuint64_t>(Hkv) * D * 2};
  const cuuint32_t box[3] = {64, 1, TILE};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                        const_cast<void*>(pages), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : wg::ENCODE_ERROR + static_cast<int>(r);
}

// The positions [lo, hi) the mask lets through, and the slice's tiles: a
// tile is (page j of the table row, 16-row block t of the page), live when
// the page is mapped and the tile's positions meet [lo, hi).  The producer
// and the consumers walk the same tiles in the same order.
struct Slice {
  const int* row;  // the sequence's page-table row
  int j0, j1;      // table columns of this slice
  int page, tiles_per_page, lo, hi;

  __device__ __forceinline__ int rows(int t) const {
    return min(TILE, page - TILE * t);
  }
  __device__ __forceinline__ bool live(int j, int t) const {
    const int p0 = j * page + TILE * t;
    return p0 < hi && p0 + rows(t) > lo;
  }
  // Bit r: row r of tile (j, t) lies inside the page and [lo, hi), so
  // the bits [r0, r1).
  __device__ __forceinline__ uint32_t mask(int j, int t) const {
    const int p0 = j * page + TILE * t;
    const int r0 = max(0, lo - p0), r1 = min(rows(t), hi - p0);
    return r1 > r0 ? ((1u << (r1 - r0)) - 1) << r0 : 0u;
  }
};

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
    paged_decode_mma_kernel(const __grid_constant__ CUtensorMap tmk,
                            const __grid_constant__ CUtensorMap tmv,
                            const __nv_bfloat16* q, const int* page_table,
                            const int* seq_lens, __nv_bfloat16* out, int H,
                            int Hkv, int page, int maxp, int window,
                            int has_softcap, float softcap, float scale,
                            int pages_per_split) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const dmma::Smem<D> sm(smem_raw);
  const int rank = blockIdx.x;
  const int bh = blockIdx.y, b = bh / Hkv, kvh = bh % Hkv;
  const int G = H / Hkv;
  const int tid = threadIdx.x, lane = tid & 31;
  const int warp = __shfl_sync(0xffffffffu, tid / 32, 0);

  const int seq_len = seq_lens[b];
  Slice sl;
  sl.row = page_table + static_cast<long>(b) * maxp;
  sl.j0 = rank * pages_per_split;
  sl.j1 = min(maxp, sl.j0 + pages_per_split);
  sl.page = page;
  sl.tiles_per_page = (page + TILE - 1) / TILE;
  sl.hi = min(seq_len, maxp * page);
  sl.lo = window >= 0 ? max(0, seq_len - window) : 0;
  sm.init();

  const long rows0 = (static_cast<long>(b) * H + kvh * G) * D;
  if (warp == dmma::WARPS) {
    // The producer: one thread arms each stage and issues its boxes.
    if (lane == 0) {
      dmma::prefetch_map(&tmk);
      dmma::prefetch_map(&tmv);
      int i = 0;
      for (int j = sl.j0; j < sl.j1; ++j) {
        const int phys = __ldg(sl.row + j);
        if (phys < 0) continue;
        for (int t = 0; t < sl.tiles_per_page; ++t) {
          if (!sl.live(j, t)) continue;
          const int row0 = phys * page + TILE * t;
          sm.produce(i++, sl.mask(j, t),
                     [&](unsigned char* ks, unsigned char* vs,
                         uint64_t* bar) {
#pragma unroll
                       for (int p = 0; p < D / 64; ++p) {
                         wg::tma_load_3d(ks + p * BOX, &tmk, bar, 64 * p,
                                         kvh, row0);
                         wg::tma_load_3d(vs + p * BOX, &tmv, bar, 64 * p,
                                         kvh, row0);
                       }
                     });
        }
      }
    }
  } else {
    // The slice's live tiles, counted the producer's way.
    int count = 0;
    for (int jb = sl.j0; jb < sl.j1; jb += 32) {
      const int j = jb + lane;
      if (j < sl.j1 && __ldg(sl.row + j) >= 0)
        for (int t = 0; t < sl.tiles_per_page; ++t) count += sl.live(j, t);
    }
    const int n_items = __reduce_add_sync(0xffffffffu, count);
    dmma::consume<D>(sm, q + rows0, G, n_items, warp, scale, has_softcap,
                     softcap);
  }
  dmma::merge_cluster<D>(sm, out + rows0, G);
}

template <int D>
int launch(const void* q, const void* kp, const void* vp, long pool_rows,
           const int* table, const int* lens, void* out, int B, int H,
           int Hkv, int page, int maxp, int window, int has_softcap,
           float softcap, float scale, int n_split, int pages_per_split,
           cudaStream_t st) {
  CUtensorMap tmk, tmv;
  int e = make_pool_map(&tmk, kp, pool_rows, Hkv, D);
  if (e == 0) e = make_pool_map(&tmv, vp, pool_rows, Hkv, D);
  if (e != 0) return e;
  return wg::launch_cluster<paged_decode_mma_kernel<D>>(
      dim3(n_split, B * Hkv), THREADS, n_split, dmma::Layout<D>::SMEM, st,
      tmk, tmv, static_cast<const __nv_bfloat16*>(q), table, lens,
      static_cast<__nv_bfloat16*>(out), H, Hkv, page, maxp, window,
      has_softcap, softcap, scale, pages_per_split);
}

}  // namespace

// q (B, H, D) bf16; k_pages / v_pages (P, page, Hkv, D) bf16; page_table
// (B, maxp) int32; seq_lens (B,) int32; out (B, H, D) bf16.  Every pointer
// 16-byte aligned.  Slice s of a row covers the table columns
// [s * pages_per_split, (s + 1) * pages_per_split).
extern "C" int flash_decode_paged_mma_launch(
    const void* q, const void* k_pages, const void* v_pages, int n_pages,
    const void* page_table, const void* seq_lens, void* out, int B, int H,
    int Hkv, int D, int page, int maxp, int window, int has_softcap,
    float softcap, float scale, int n_split, int pages_per_split,
    void* stream) {
  if (B <= 0 || Hkv <= 0 || H % Hkv != 0 || H / Hkv > 16 || page <= 0 ||
      n_pages <= 0 ||
      maxp <= 0 || n_split < 1 || n_split > MAX_SPLIT ||
      pages_per_split <= 0 ||
      static_cast<long>(n_split) * pages_per_split < maxp)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* table = static_cast<const int*>(page_table);
  const int* lens = static_cast<const int*>(seq_lens);
  const long pool_rows = static_cast<long>(n_pages) * page;
#define ARGS                                                               \
  q, k_pages, v_pages, pool_rows, table, lens, out, B, H, Hkv, page, maxp, \
      window, has_softcap, softcap, scale, n_split, pages_per_split, st
  switch (D) {
    case 64: return launch<64>(ARGS);
    case 128: return launch<128>(ARGS);
    case 256: return launch<256>(ARGS);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef ARGS
}
