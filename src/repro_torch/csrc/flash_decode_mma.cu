// B6's mma engine: one-token attention over a flat or ring KV cache for
// Hopper (sm_90a), bf16 cache and query, in one launch.
//
// Replaces, for a bf16 cache with G = H/Hkv <= 16, D in {64, 128, 256} and
// strides TMA can take: src/repro/kernels/flash_decode.py,
// flash_decode_pallas / _kernel (grid (B*Hkv, S/bkv), the kv axis walked
// sequentially with the online-softmax carry in VMEM scratch, positions
// supplied as data: the ring cache's slot -> absolute-position map, -1 for
// an unwritten slot).  f32 caches and the rest stay on the SIMT kernel
// (flash_decode.cu + decode_combine.cuh); core/geometry.py:
// flat_decode_engine chooses.
//
// What bounds it on the H100: bytes.  A decode step reads every visible
// K/V row of the cache once for 4G FLOP per row element (G = 16 for
// recurrentgemma_9b's MQA): at 4 slots x a 2048-slot ring x D = 256 in
// bf16 that is 8.4 MB, ~2.5 us at 3.35 TB/s.  The SIMT kernel loaded K/V
// as scalar 2-byte values widened to f32 in shared memory, ran QK^T as one
// warp per (head, slot) pair and wrote G*D f32 partials from each of ~66
// slices for a second launch to merge.  Here B4's mma engine
// (decode_mma.cuh) runs with another source of tiles:
//
// - Grid (slices, B*Hkv): one CTA per (sequence, kv head, KV slice); the
//   slices of a row are one thread-block cluster of
//   core/geometry.py:decode_kv_split(B*Hkv, ceil(S/16)) CTAs, each a run of
//   whole 16-slot tiles of the cache.
// - The producer warp reads the kv_positions of 16 tiles at a time, all
//   loads in flight together, and ballots their visibility two tiles a
//   ballot: kvpos >= 0, kvpos <= q_pos and, with a window,
//   kvpos > q_pos - window.  One thread skips a tile with no
//   visible slot and TMAs the K and V rows of a live one into the stage
//   ring, its 16-bit mask beside it.  The ring's slot order is not
//   position order; nothing here assumes it is.
// - The cache is read in its stored layout, through its strides: the maps
//   are 4-D over (D, slots, Hkv, B) with box (64, 16, 1, 1) and the
//   view's own strides, so the serving ring's (B, L, Hkv, D)
//   storage seen as (B, Hkv, L, D) and a contiguous (B, Hkv, S, D) cache
//   both load without a copy.  The slot axis is an axis of its own: a box
//   never crosses into the next sequence, and TMA zero-fills past S.
// - The consumers and the merge are decode_mma.cuh's: V rows the mask
//   drops (kvpos < 0 among them) are zeroed before P V, so an unwritten
//   slot never reaches O, as the Pallas kernel's contract says; an empty
//   row gives zeros.  No partials in device memory, no second launch, no
//   atomics: bit-equal from call to call.
#include "decode_mma.cuh"

namespace {

using dmma::BOX;
using dmma::MAX_SPLIT;
using dmma::THREADS;
using dmma::TILE;

// 4-D TMA load of one box at (c0 innermost, c1, c2, c3).
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(
          wg::smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(wg::smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// A 4-D bf16 tensor map over a (B, Hkv, S, D) view with element strides
// (sb, sh, ss) and a contiguous D axis, listed innermost first as (D, S,
// Hkv, B): box 16 slots x 64 columns of one (sequence, kv head), 128-byte
// swizzle, zero fill outside.  An axis of one element takes the stride of
// a packed layout (its own is never used, and need not be a multiple of
// 16 bytes); every other stride is a positive multiple of 16 bytes (the
// wrapper's `aligned`).
inline int make_cache_map(CUtensorMap* map, const void* base, int B,
                          int Hkv, int S, int D, long sb, long sh, long ss) {
  wg::EncodeTiled fn = wg::encode_tiled();
  if (fn == nullptr) return wg::ENTRY_ERROR;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(Hkv),
                              static_cast<cuuint64_t>(B)};
  const long stride[3] = {ss, sh, sb};
  cuuint64_t strides[3];
  cuuint64_t packed = static_cast<cuuint64_t>(D) * 2;
  for (int i = 0; i < 3; ++i) {
    strides[i] = dims[i + 1] == 1 ? packed
                                  : static_cast<cuuint64_t>(stride[i]) * 2;
    packed = strides[i] * dims[i + 1];
  }
  const cuuint32_t box[4] = {64, TILE, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                        const_cast<void*>(base), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : wg::ENCODE_ERROR + static_cast<int>(r);
}

// Ballots whose kv_positions loads are in flight together: one batch of
// 2 * BATCH tiles covers a slice of the serving ring (16 tiles).
constexpr int BATCH = 8;

// Which slots of a sequence's cache the query sees.  The producer and the
// consumers ballot the same tiles the same way.
struct Visible {
  const int* pos;  // the sequence's kv_positions
  int S, q_pos, window, t1;

  // both[j], bits 0-15: the slots of tile t + 2j seen; bits 16-31: those
  // of tile t + 2j + 1 (none past the slice's last tile t1 or past S).  A
  // whole warp calls; every load is issued before the first ballot.
  __device__ __forceinline__ void ballots(int t, int lane,
                                          uint32_t (&both)[BATCH]) const {
    int p[BATCH];
#pragma unroll
    for (int j = 0; j < BATCH; ++j) {
      const int tile = t + 2 * j + (lane >> 4);
      const int slot = (t + 2 * j) * TILE + lane;
      p[j] = tile < t1 && slot < S ? __ldg(pos + slot) : -1;
    }
#pragma unroll
    for (int j = 0; j < BATCH; ++j) {
      const bool v = p[j] >= 0 && p[j] <= q_pos &&
                     (window < 0 || p[j] > q_pos - window);
      both[j] = __ballot_sync(0xffffffffu, v);
    }
  }
};

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
    flat_decode_mma_kernel(const __grid_constant__ CUtensorMap tmk,
                           const __grid_constant__ CUtensorMap tmv,
                           const __nv_bfloat16* q, const int* kv_pos,
                           const int* q_pos, __nv_bfloat16* out, int H,
                           int Hkv, int S, int window, int has_softcap,
                           float softcap, float scale, int tiles_per_split) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const dmma::Smem<D> sm(smem_raw);
  const int rank = blockIdx.x;
  const int bh = blockIdx.y, b = bh / Hkv, kvh = bh % Hkv;
  const int G = H / Hkv;
  const int tid = threadIdx.x, lane = tid & 31;
  const int warp = __shfl_sync(0xffffffffu, tid / 32, 0);

  const int t0 = rank * tiles_per_split;
  Visible vis;
  vis.pos = kv_pos + static_cast<long>(b) * S;
  vis.S = S;
  vis.q_pos = q_pos[b];
  vis.window = window;
  vis.t1 = min((S + TILE - 1) / TILE, t0 + tiles_per_split);
  sm.init();

  const long rows0 = (static_cast<long>(b) * H + kvh * G) * D;
  if (warp == dmma::WARPS) {
    // The producer: the warp ballots 16 tiles at a time, one thread arms
    // a stage for each live tile and issues its boxes.
    if (lane == 0) {
      dmma::prefetch_map(&tmk);
      dmma::prefetch_map(&tmv);
    }
    int i = 0;
    for (int t = t0; t < vis.t1; t += 2 * BATCH) {
      uint32_t both[BATCH];
      vis.ballots(t, lane, both);
      if (lane == 0) {
        for (int j = 0; j < 2 * BATCH; ++j) {
          const uint32_t seen = (both[j / 2] >> (TILE * (j % 2))) & dmma::ALL;
          if (seen == 0) continue;
          const int slot = (t + j) * TILE;
          sm.produce(i++, seen,
                     [&](unsigned char* ks, unsigned char* vs,
                         uint64_t* bar) {
#pragma unroll
                       for (int p = 0; p < D / 64; ++p) {
                         tma_load_4d(ks + p * BOX, &tmk, bar, 64 * p, slot,
                                     kvh, b);
                         tma_load_4d(vs + p * BOX, &tmv, bar, 64 * p, slot,
                                     kvh, b);
                       }
                     });
        }
      }
      __syncwarp();
    }
  } else {
    // The slice's live tiles, counted the producer's way.
    int n_items = 0;
    for (int t = t0; t < vis.t1; t += 2 * BATCH) {
      uint32_t both[BATCH];
      vis.ballots(t, lane, both);
#pragma unroll
      for (int j = 0; j < BATCH; ++j)
        n_items += ((both[j] & dmma::ALL) != 0) + ((both[j] >> TILE) != 0);
    }
    dmma::consume<D>(sm, q + rows0, G, n_items, warp, scale, has_softcap,
                     softcap);
  }
  dmma::merge_cluster<D>(sm, out + rows0, G);
}

template <int D>
int launch(const void* q, const void* k, const void* v, long k_sb,
           long k_sh, long k_ss, long v_sb, long v_sh, long v_ss,
           const int* kv_pos, const int* q_pos, void* out, int B, int H,
           int Hkv, int S, int window, int has_softcap, float softcap,
           float scale, int n_split, int tiles_per_split, cudaStream_t st) {
  CUtensorMap tmk, tmv;
  int e = make_cache_map(&tmk, k, B, Hkv, S, D, k_sb, k_sh, k_ss);
  if (e == 0) e = make_cache_map(&tmv, v, B, Hkv, S, D, v_sb, v_sh, v_ss);
  if (e != 0) return e;
  return wg::launch_cluster<flat_decode_mma_kernel<D>>(
      dim3(n_split, B * Hkv), THREADS, n_split, dmma::Layout<D>::SMEM, st,
      tmk, tmv, static_cast<const __nv_bfloat16*>(q), kv_pos,
      q_pos, static_cast<__nv_bfloat16*>(out), H, Hkv, S, window,
      has_softcap, softcap, scale, tiles_per_split);
}

}  // namespace

// q (B, H, D) bf16 contiguous; k / v (B, Hkv, S, D) bf16 in any layout
// whose D axis is contiguous, given by element strides (b, h, s), each a
// multiple of 8 where its axis has more than one element, the bases
// 16-byte aligned; kv_pos (B, S) and q_pos (B,) int32; out (B, H, D) bf16.
// Slice s of a row covers the 16-slot tiles [s * tiles_per_split,
// (s + 1) * tiles_per_split).
extern "C" int flash_decode_mma_launch(
    const void* q, const void* k, const void* v, long k_sb, long k_sh,
    long k_ss, long v_sb, long v_sh, long v_ss, const void* kv_pos,
    const void* q_pos, void* out, int B, int H, int Hkv, int D, int S,
    int window, int has_softcap, float softcap, float scale, int n_split,
    int tiles_per_split, void* stream) {
  if (B <= 0 || Hkv <= 0 || S <= 0 || H % Hkv != 0 || H / Hkv > 16 ||
      n_split < 1 || n_split > MAX_SPLIT || tiles_per_split <= 0 ||
      static_cast<long>(n_split) * tiles_per_split * TILE < S)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* kp = static_cast<const int*>(kv_pos);
  const int* qp = static_cast<const int*>(q_pos);
#define ARGS                                                              \
  q, k, v, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, kp, qp, out, B, H, Hkv, S, \
      window, has_softcap, softcap, scale, n_split, tiles_per_split, st
  switch (D) {
    case 64: return launch<64>(ARGS);
    case 128: return launch<128>(ARGS);
    case 256: return launch<256>(ARGS);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef ARGS
}
