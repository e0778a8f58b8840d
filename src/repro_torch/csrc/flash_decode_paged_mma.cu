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
//   TMA in a ring of STAGES stages, completion counted on the stage's
//   mbarrier.  The maps are 3-D over (positions of the pool, Hkv, D), so
//   one box is 16 rows x 64 columns of one kv head: D/64 boxes each for K
//   and V per stage, in the 128-byte swizzle, which puts the 8 rows an
//   ldmatrix reads in 8 different bank groups.
// - Four consumer warps take the stages in turn (stage i to warp i % 4),
//   each with its own online softmax over the G query heads, padded to the
//   16 rows of an m16n8k16 A fragment (rows >= G are zeros, never written):
//   S = Q K^T on mma.sync with Q and K read by ldmatrix; the mask
//   (position < seq_len, inside the window; unmapped pages never load),
//   the scale and the softcap of the SIMT kernel on the f32 accumulators;
//   P rounded to bf16 passes from the S accumulators to the A fragment in
//   registers, and O += P V on mma.sync with V read by ldmatrix.trans.  O
//   (16 x D f32) stays in registers.  V rows the mask drops are zeroed in
//   shared memory first, so stale or unwritten rows never reach O.
// - The four warps' (m, l, O) of every CTA go to its idle ring and are
//   merged there, in warp order, into the CTA's state; after a cluster
//   barrier, each rank merges a share of the G x D outputs over the ranks
//   in order through distributed shared memory, four outputs per remote
//   load, and writes O / l in bf16 (0 where l = 0: an empty row gives
//   zeros).  No partials in device memory, no second launch, no atomics:
//   bit-equal from call to call.  A second cluster barrier keeps every
//   CTA's shared memory alive until the last remote read.
#include "wgmma_mainloop.cuh"

namespace {

constexpr int WARPS = 4;                    // consumer warps
constexpr int THREADS = WARPS * 32 + 32;    // + the producer warp
constexpr int TILE = 16;                    // positions per stage
constexpr int STAGES = 8;
constexpr int MAX_SPLIT = 8;
constexpr float NEG_INF = -1e30f;

constexpr int BOX = TILE * 128;             // 16 rows x 64 bf16, bytes

template <int D>
struct Layout {
  static constexpr int PANELS = D / 64;               // boxes per tile
  static constexpr int TILE_BYTES = PANELS * BOX;
  static constexpr int STAGE = 2 * TILE_BYTES;        // K, then V
  static constexpr int RING = STAGES * STAGE;         // 1024-aligned
  static constexpr int ROW = 2 * D + 16;              // padded Q row
  static constexpr int Q = RING;                      // 16 x ROW
  static constexpr int BARS = Q + TILE * ROW;         // full, empty
  static constexpr int META = BARS + 2 * STAGES * 8;  // (pos0, rows)
  static constexpr int SMEM = 1024 + META + 2 * STAGES * 4;
  // The merge over the ring: per warp m[16], l[16], O[16][D] f32, then
  // the CTA's O[16][D], m[16], l[16].
  static_assert((WARPS + 1) * (32 + TILE * D) * 4 <= RING,
                "no room to merge");
};

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

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void mma_16816(float* d, const uint32_t* a,
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four floats of cluster CTA `rank`'s shared memory at the (16-byte
// aligned) address of `local` in ours.
__device__ __forceinline__ float4 ld_cluster_v4(const float* local,
                                                uint32_t rank) {
  uint32_t remote;
  float4 v;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(wg::smem_u32(local)), "r"(rank));
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(remote));
  return v;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
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
  using L = Layout<D>;
  constexpr int ROW = L::ROW;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (wg::smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* ring = smem;
  unsigned char* qs = smem + L::Q;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::BARS);
  uint64_t* empty = full + STAGES;
  int* meta = reinterpret_cast<int*>(smem + L::META);
  // Over the ring once the loop is done: each warp's (m, l, O), then the
  // CTA's merged state.
  float* pw_m = reinterpret_cast<float*>(ring);
  float* pw_l = pw_m + WARPS * TILE;
  float* pw_o = pw_l + WARPS * TILE;
  float* cta_o = pw_o + WARPS * TILE * D;
  float* cta_m = cta_o + TILE * D;
  float* cta_l = cta_m + TILE;

  const int S = gridDim.x, rank = blockIdx.x;
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

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      wg::mbar_init(&full[s], 1);
      wg::mbar_init(&empty[s], 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == WARPS) {
    // The producer: one thread arms each stage and issues its boxes.
    if (lane == 0) {
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                       reinterpret_cast<uint64_t>(&tmk))
                   : "memory");
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                       reinterpret_cast<uint64_t>(&tmv))
                   : "memory");
      int i = 0;
      for (int j = sl.j0; j < sl.j1; ++j) {
        const int phys = __ldg(sl.row + j);
        if (phys < 0) continue;
        for (int t = 0; t < sl.tiles_per_page; ++t) {
          if (!sl.live(j, t)) continue;
          const int s = i % STAGES;
          wg::mbar_wait(&empty[s], ((i / STAGES) & 1) ^ 1);
          meta[2 * s] = j * page + TILE * t;
          meta[2 * s + 1] = sl.rows(t);
          wg::mbar_expect_tx(&full[s], L::STAGE);
          unsigned char* st = ring + s * L::STAGE;
          const int row0 = phys * page + TILE * t;
#pragma unroll
          for (int p = 0; p < L::PANELS; ++p) {
            wg::tma_load_3d(st + p * BOX, &tmk, &full[s], 64 * p, kvh, row0);
            wg::tma_load_3d(st + L::TILE_BYTES + p * BOX, &tmv, &full[s],
                            64 * p, kvh, row0);
          }
          ++i;
        }
      }
    }
  } else {
    const int gid = lane >> 2, tq = lane & 3;
    // The slice's live tiles, counted the producer's way.
    int count = 0;
    for (int jb = sl.j0; jb < sl.j1; jb += 32) {
      const int j = jb + lane;
      if (j < sl.j1 && __ldg(sl.row + j) >= 0)
        for (int t = 0; t < sl.tiles_per_page; ++t) count += sl.live(j, t);
    }
    const int n_items = __reduce_add_sync(0xffffffffu, count);
    // The G query rows into shared memory, rows G..15 zero.
    for (int e = tid; e < TILE * D / 8; e += WARPS * 32) {
      const int g = e / (D / 8), c = e % (D / 8);
      uint4 v = make_uint4(0, 0, 0, 0);
      if (g < G)
        v = __ldg(reinterpret_cast<const uint4*>(
                      q + (static_cast<long>(b) * H + kvh * G + g) * D) +
                  c);
      *reinterpret_cast<uint4*>(qs + g * ROW + c * 16) = v;
    }
    wg::consumer_sync<WARPS * 32>();

    // ldmatrix lane addresses.  Q (A, m16k16): matrices (rows 0-7 | 8-15)
    // x (k 0-7 | 8-15), rows first.  K (B, non-transposed: stored [pos][d]
    // = [n][k]): (pos 0-7, d 0-7), (pos 0-7, d 8-15), (pos 8-15, d 0-7),
    // (pos 8-15, d 8-15).  V (B, transposed: stored [pos][d] = [k][n]):
    // (pos 0-7 | 8-15) x (d 0-7 | 8-15), positions first.  K and V sit in
    // 64-column boxes of 16 rows x 128 bytes whose 16-byte chunk c of row
    // r is stored at chunk c ^ (r % 8); r % 8 is the lane's row mr.
    const int mi = lane >> 3, mr = lane & 7;
    const uint32_t q_addr =
        wg::smem_u32(qs) + (mr + 8 * (mi & 1)) * ROW + (mi >> 1) * 16;
    const uint32_t k_row = (mr + 8 * (mi >> 1)) * 128;
    const uint32_t v_row = (mr + 8 * (mi & 1)) * 128;
    const auto chunk = [&](int c) -> uint32_t {
      return static_cast<uint32_t>((c ^ mr) << 4);
    };

    float o[D / 8][4];
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) o[n][c] = 0.0f;
    float m_run[2] = {NEG_INF, NEG_INF}, l_run[2] = {0.0f, 0.0f};

    for (int i = warp; i < n_items; i += WARPS) {
      const int s = i % STAGES;
      wg::mbar_wait(&full[s], (i / STAGES) & 1);
      const int p0 = meta[2 * s], nrows = meta[2 * s + 1];
      unsigned char* kst = ring + s * L::STAGE;
      unsigned char* vst = kst + L::TILE_BYTES;
      const bool edge = nrows < TILE || p0 < sl.lo || p0 + TILE > sl.hi;
      if (edge) {
        // Zero the V rows the mask drops (unwritten or stale memory, or
        // rows past the page) before they meet P: 8 chunks of 16 bytes per
        // row of each box.
        for (int e = lane; e < L::PANELS * TILE * 8; e += 32) {
          const int r = (e >> 3) % TILE, pos = p0 + r;
          if (r >= nrows || pos < sl.lo || pos >= sl.hi)
            *reinterpret_cast<uint4*>(vst + (e >> 3) * 128 + (e & 7) * 16) =
                make_uint4(0, 0, 0, 0);
        }
        __syncwarp();
      }
      // S = Q K^T: 16 query rows x 16 positions, two n8 tiles.
      float sacc[2][4] = {{0.0f, 0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f, 0.0f}};
      const uint32_t kbase = wg::smem_u32(kst) + k_row;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t a[4], kb[4];
        ldsm_x4(a, q_addr + kk * 32);
        ldsm_x4(kb, kbase + (kk >> 2) * BOX +
                        chunk(2 * (kk & 3) + (mi & 1)));
        mma_16816(sacc[0], a, kb[0], kb[1]);
        mma_16816(sacc[1], a, kb[2], kb[3]);
      }
      // Mask, scale, softcap; the online softmax of rows gid and gid + 8
      // (each quad of lanes holds one row pair's 16 positions).
      float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int r = 8 * nt + 2 * tq + (c & 1), pos = p0 + r;
          float x = sacc[nt][c] * scale;
          if (has_softcap) x = softcap * tanhf(x / softcap);
          const bool valid = r < nrows && pos >= sl.lo && pos < sl.hi;
          sacc[nt][c] = valid ? x : NEG_INF;
          mx[c >> 1] = fmaxf(mx[c >> 1], sacc[nt][c]);
        }
      float alpha[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        const float m_new = fmaxf(m_run[h], mx[h]);
        alpha[h] = expf(m_run[h] - m_new);
        m_run[h] = m_new;
        l_run[h] *= alpha[h];
      }
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float x = sacc[nt][c];
          const float p = x > 0.5f * NEG_INF ? expf(x - m_run[c >> 1])
                                             : 0.0f;
          sacc[nt][c] = p;
          l_run[c >> 1] += p;
        }
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        o[n][0] *= alpha[0];
        o[n][1] *= alpha[0];
        o[n][2] *= alpha[1];
        o[n][3] *= alpha[1];
      }
      // P (bf16) from the S accumulators into the A fragment: k 0-7 from
      // the first n8 tile, k 8-15 from the second.
      uint32_t pa[4];
      pa[0] = pack_bf16(sacc[0][0], sacc[0][1]);
      pa[1] = pack_bf16(sacc[0][2], sacc[0][3]);
      pa[2] = pack_bf16(sacc[1][0], sacc[1][1]);
      pa[3] = pack_bf16(sacc[1][2], sacc[1][3]);
      const uint32_t vbase = wg::smem_u32(vst) + v_row;
#pragma unroll
      for (int dt = 0; dt < D / 16; ++dt) {
        uint32_t vb[4];
        ldsm_x4_trans(vb, vbase + (dt >> 2) * BOX +
                              chunk(2 * (dt & 3) + (mi >> 1)));
        mma_16816(o[2 * dt], pa, vb[0], vb[1]);
        mma_16816(o[2 * dt + 1], pa, vb[2], vb[3]);
      }
      // The zeroed rows were ordinary stores; the next copy into this
      // stage is the async proxy's.
      if (edge) wg::fence_proxy_async();
      __syncwarp();
      if (lane == 0) wg::mbar_arrive(&empty[s]);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l_run[h] += __shfl_xor_sync(0xffffffffu, l_run[h], 1);
      l_run[h] += __shfl_xor_sync(0xffffffffu, l_run[h], 2);
    }
    // Every warp is done with the ring (every copy into it has been
    // waited for): the warps' states go where the stages were.
    wg::consumer_sync<WARPS * 32>();
    float* po = pw_o + warp * TILE * D;
    if (tq == 0) {
      pw_m[warp * TILE + gid] = m_run[0];
      pw_m[warp * TILE + gid + 8] = m_run[1];
      pw_l[warp * TILE + gid] = l_run[0];
      pw_l[warp * TILE + gid + 8] = l_run[1];
    }
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const int c = 8 * n + 2 * tq;
      *reinterpret_cast<float2*>(po + gid * D + c) =
          make_float2(o[n][0], o[n][1]);
      *reinterpret_cast<float2*>(po + (gid + 8) * D + c) =
          make_float2(o[n][2], o[n][3]);
    }
    wg::consumer_sync<WARPS * 32>();
    // The CTA's state: the four warps' merged in warp order, four outputs
    // per thread at a time, from this CTA's own shared memory.
    for (int e4 = tid; e4 < G * D / 4; e4 += WARPS * 32) {
      const int g = 4 * e4 / D, d = 4 * e4 % D;
      float m = NEG_INF;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) m = fmaxf(m, pw_m[w * TILE + g]);
      float l = 0.0f;
      float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
      for (int w = 0; w < WARPS; ++w) {
        const float wt = expf(pw_m[w * TILE + g] - m);
        const float4 v =
            *reinterpret_cast<const float4*>(pw_o + (w * TILE + g) * D + d);
        l += wt * pw_l[w * TILE + g];
        acc.x += wt * v.x;
        acc.y += wt * v.y;
        acc.z += wt * v.z;
        acc.w += wt * v.w;
      }
      *reinterpret_cast<float4*>(cta_o + g * D + d) = acc;
      if (d == 0) {
        cta_m[g] = m;
        cta_l[g] = l;
      }
    }
  }

  // Every CTA's state is in place: rank r merges every S-th run of THREADS
  // groups of four outputs from the r-th on, over the ranks in order,
  // through distributed shared memory.
  wg::cluster_arrive();
  wg::cluster_wait();
  for (int e4 = rank * THREADS + tid; e4 < G * D / 4; e4 += S * THREADS) {
    const int g = 4 * e4 / D, d = 4 * e4 % D;
    float mv[MAX_SPLIT];
    float m = NEG_INF;
#pragma unroll
    for (int r = 0; r < MAX_SPLIT; ++r) {
      mv[r] = r < S ? wg::ld_cluster(cta_m + g, r) : NEG_INF;
      m = fmaxf(m, mv[r]);
    }
    float l = 0.0f;
    float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
    for (int r = 0; r < MAX_SPLIT; ++r) {
      if (r < S) {
        const float wt = expf(mv[r] - m);
        const float4 v = ld_cluster_v4(cta_o + g * D + d, r);
        l += wt * wg::ld_cluster(cta_l + g, r);
        acc.x += wt * v.x;
        acc.y += wt * v.y;
        acc.z += wt * v.z;
        acc.w += wt * v.w;
      }
    }
    const float inv = l == 0.0f ? 0.0f : 1.0f / l;
    __nv_bfloat162 pair[2] = {__floats2bfloat162_rn(acc.x * inv,
                                                    acc.y * inv),
                              __floats2bfloat162_rn(acc.z * inv,
                                                    acc.w * inv)};
    *reinterpret_cast<uint2*>(
        out + (static_cast<long>(b) * H + kvh * G + g) * D + d) =
        *reinterpret_cast<const uint2*>(pair);
  }
  // This CTA has read the others' states; no CTA leaves while another may
  // still read its own.
  wg::cluster_arrive();
  wg::cluster_wait();
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
      dim3(n_split, B * Hkv), THREADS, n_split, Layout<D>::SMEM, st, tmk,
      tmv, static_cast<const __nv_bfloat16*>(q), table, lens,
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
