// The mma engine of one-token decode attention for Hopper (sm_90a), shared
// by B4 (flash_decode_paged_mma.cu: tiles from a page table) and B6
// (flash_decode_mma.cu: tiles of a flat or ring cache).  A kernel supplies
// the tiles; this header does the rest:
//
// - A CTA is one (sequence, kv head, KV slice); the slices of a row are one
//   thread-block cluster of at most MAX_SPLIT.  One producer thread arms a
//   ring of STAGES stages, each the K and V rows of 16 cache positions (16
//   rows x D bf16 each, landed by TMA in 64-column boxes in the 128-byte
//   swizzle, which puts the 8 rows an ldmatrix reads in 8 different bank
//   groups), completion counted on the stage's mbarrier, and stores the
//   tile's 16-bit visibility mask (bit r: row r is seen) beside it.
// - Four consumer warps take the stages in turn (stage i to warp i % 4),
//   each with its own online softmax over the G query heads, padded to the
//   16 rows of an m16n8k16 A fragment (rows >= G are zeros, never written):
//   S = Q K^T on mma.sync with Q and K read by ldmatrix; the mask, the
//   scale and the softcap on the f32 accumulators; P rounded to bf16 passes
//   from the S accumulators to the A fragment in registers, and O += P V on
//   mma.sync with V read by ldmatrix.trans.  O (16 x D f32) stays in
//   registers.  V rows the mask drops are zeroed in shared memory first,
//   so stale or unwritten rows never reach O.
// - The four warps' (m, l, O) of every CTA go to its idle ring and are
//   merged there, in warp order, into the CTA's state; after a cluster
//   barrier, each rank merges a share of the G x D outputs over the ranks
//   in order through distributed shared memory, four outputs per remote
//   load, and writes O / l in bf16 (0 where l = 0: an empty row gives
//   zeros).  No partials in device memory, no second launch, no atomics:
//   bit-equal from call to call.  A second cluster barrier keeps every
//   CTA's shared memory alive until the last remote read.
#pragma once

#include "wgmma_mainloop.cuh"

namespace dmma {

constexpr int WARPS = 4;                    // consumer warps
constexpr int THREADS = WARPS * 32 + 32;    // + the producer warp
constexpr int TILE = 16;                    // positions per stage
constexpr int STAGES = 8;
constexpr int MAX_SPLIT = 8;
constexpr uint32_t ALL = (1u << TILE) - 1;  // a tile whose rows are all seen
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
  static constexpr int MASKS = BARS + 2 * STAGES * 8;
  static constexpr int SMEM = 1024 + MASKS + STAGES * 4;
  // The merge over the ring: per warp m[16], l[16], O[16][D] f32, then
  // the CTA's O[16][D], m[16], l[16].
  static_assert((WARPS + 1) * (32 + TILE * D) * 4 <= RING,
                "no room to merge");
};

// A CTA's shared memory, carved from the dynamic allocation at a 1024-byte
// boundary (the 128-byte swizzle's period).
template <int D>
struct Smem {
  using L = Layout<D>;
  unsigned char* ring;
  unsigned char* qs;
  uint64_t* full;
  uint64_t* empty;
  uint32_t* mask;
  // Over the ring once the loop is done: each warp's (m, l, O), then the
  // CTA's merged state.
  float *pw_m, *pw_l, *pw_o, *cta_o, *cta_m, *cta_l;

  __device__ __forceinline__ explicit Smem(unsigned char* raw) {
    unsigned char* s = raw + ((1024 - (wg::smem_u32(raw) & 1023)) & 1023);
    ring = s;
    qs = s + L::Q;
    full = reinterpret_cast<uint64_t*>(s + L::BARS);
    empty = full + STAGES;
    mask = reinterpret_cast<uint32_t*>(s + L::MASKS);
    pw_m = reinterpret_cast<float*>(ring);
    pw_l = pw_m + WARPS * TILE;
    pw_o = pw_l + WARPS * TILE;
    cta_o = pw_o + WARPS * TILE * D;
    cta_m = cta_o + TILE * D;
    cta_l = cta_m + TILE;
  }

  // Thread 0 sets up the stage barriers; every thread waits for it.
  __device__ __forceinline__ void init() const {
    if (threadIdx.x == 0) {
#pragma unroll
      for (int s = 0; s < STAGES; ++s) {
        wg::mbar_init(&full[s], 1);
        wg::mbar_init(&empty[s], 1);
      }
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
  }

  // The producer's step i: wait for its stage to be free, store the
  // tile's mask, arm the stage for its bytes, and let `load(k, v, bar)`
  // issue the K and V boxes into it.
  template <class Load>
  __device__ __forceinline__ void produce(int i, uint32_t m,
                                          Load load) const {
    const int s = i % STAGES;
    wg::mbar_wait(&empty[s], ((i / STAGES) & 1) ^ 1);
    mask[s] = m;
    wg::mbar_expect_tx(&full[s], L::STAGE);
    unsigned char* st = ring + s * L::STAGE;
    load(st, st + L::TILE_BYTES, &full[s]);
  }
};

__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map))
               : "memory");
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

// The consumer warps' whole part: the G query rows `qg` (contiguous, D
// each, 16-byte aligned) into shared memory, the slice's `n_items` stages
// in turn, and the four warps' states merged into the CTA's.  `warp` is
// the shfl-broadcast warp index (< WARPS), so no mma sits in a branch the
// compiler thinks divergent.
template <int D>
__device__ __forceinline__ void consume(const Smem<D>& sm,
                                        const __nv_bfloat16* qg, int G,
                                        int n_items, int warp, float scale,
                                        int has_softcap, float softcap) {
  using L = Layout<D>;
  constexpr int ROW = L::ROW;
  const int tid = threadIdx.x, lane = tid & 31;
  const int gid = lane >> 2, tq = lane & 3;
  // The G query rows into shared memory, rows G..15 zero.
  for (int e = tid; e < TILE * D / 8; e += WARPS * 32) {
    const int g = e / (D / 8), c = e % (D / 8);
    uint4 v = make_uint4(0, 0, 0, 0);
    if (g < G)
      v = __ldg(reinterpret_cast<const uint4*>(qg + static_cast<long>(g) * D) +
                c);
    *reinterpret_cast<uint4*>(sm.qs + g * ROW + c * 16) = v;
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
      wg::smem_u32(sm.qs) + (mr + 8 * (mi & 1)) * ROW + (mi >> 1) * 16;
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
    wg::mbar_wait(&sm.full[s], (i / STAGES) & 1);
    const uint32_t seen = sm.mask[s];
    unsigned char* kst = sm.ring + s * L::STAGE;
    unsigned char* vst = kst + L::TILE_BYTES;
    const bool edge = seen != ALL;
    if (edge) {
      // Zero the V rows the mask drops (unwritten or stale memory, or
      // rows past the cache) before they meet P: 8 chunks of 16 bytes per
      // row of each box.
      for (int e = lane; e < L::PANELS * TILE * 8; e += 32) {
        const int r = (e >> 3) % TILE;
        if (!((seen >> r) & 1))
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
      ldsm_x4(kb, kbase + (kk >> 2) * BOX + chunk(2 * (kk & 3) + (mi & 1)));
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
        const int r = 8 * nt + 2 * tq + (c & 1);
        float x = sacc[nt][c] * scale;
        if (has_softcap) x = softcap * tanhf(x / softcap);
        const bool valid = (seen >> r) & 1;
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
        const float p = x > 0.5f * NEG_INF ? expf(x - m_run[c >> 1]) : 0.0f;
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
      ldsm_x4_trans(vb,
                    vbase + (dt >> 2) * BOX + chunk(2 * (dt & 3) + (mi >> 1)));
      mma_16816(o[2 * dt], pa, vb[0], vb[1]);
      mma_16816(o[2 * dt + 1], pa, vb[2], vb[3]);
    }
    // The zeroed rows were ordinary stores; the next copy into this
    // stage is the async proxy's.
    if (edge) wg::fence_proxy_async();
    __syncwarp();
    if (lane == 0) wg::mbar_arrive(&sm.empty[s]);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l_run[h] += __shfl_xor_sync(0xffffffffu, l_run[h], 1);
    l_run[h] += __shfl_xor_sync(0xffffffffu, l_run[h], 2);
  }
  // Every warp is done with the ring (every copy into it has been
  // waited for): the warps' states go where the stages were.
  wg::consumer_sync<WARPS * 32>();
  float* po = sm.pw_o + warp * TILE * D;
  if (tq == 0) {
    sm.pw_m[warp * TILE + gid] = m_run[0];
    sm.pw_m[warp * TILE + gid + 8] = m_run[1];
    sm.pw_l[warp * TILE + gid] = l_run[0];
    sm.pw_l[warp * TILE + gid + 8] = l_run[1];
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
    for (int w = 0; w < WARPS; ++w) m = fmaxf(m, sm.pw_m[w * TILE + g]);
    float l = 0.0f;
    float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float wt = expf(sm.pw_m[w * TILE + g] - m);
      const float4 v =
          *reinterpret_cast<const float4*>(sm.pw_o + (w * TILE + g) * D + d);
      l += wt * sm.pw_l[w * TILE + g];
      acc.x += wt * v.x;
      acc.y += wt * v.y;
      acc.z += wt * v.z;
      acc.w += wt * v.w;
    }
    *reinterpret_cast<float4*>(sm.cta_o + g * D + d) = acc;
    if (d == 0) {
      sm.cta_m[g] = m;
      sm.cta_l[g] = l;
    }
  }
}

// Every thread of every CTA of the cluster, once the consumers are done:
// rank r merges every S-th run of THREADS groups of four outputs from the
// r-th on, over the ranks in order, through distributed shared memory, and
// writes the G rows `og` (contiguous, D each) in bf16.
template <int D>
__device__ __forceinline__ void merge_cluster(const Smem<D>& sm,
                                              __nv_bfloat16* og, int G) {
  const int S = gridDim.x, rank = blockIdx.x, tid = threadIdx.x;
  wg::cluster_arrive();
  wg::cluster_wait();
  for (int e4 = rank * THREADS + tid; e4 < G * D / 4; e4 += S * THREADS) {
    const int g = 4 * e4 / D, d = 4 * e4 % D;
    float mv[MAX_SPLIT];
    float m = NEG_INF;
#pragma unroll
    for (int r = 0; r < MAX_SPLIT; ++r) {
      mv[r] = r < S ? wg::ld_cluster(sm.cta_m + g, r) : NEG_INF;
      m = fmaxf(m, mv[r]);
    }
    float l = 0.0f;
    float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
    for (int r = 0; r < MAX_SPLIT; ++r) {
      if (r < S) {
        const float wt = expf(mv[r] - m);
        const float4 v = ld_cluster_v4(sm.cta_o + g * D + d, r);
        l += wt * wg::ld_cluster(sm.cta_l + g, r);
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
    *reinterpret_cast<uint2*>(og + static_cast<long>(g) * D + d) =
        *reinterpret_cast<const uint2*>(pair);
  }
  // This CTA has read the others' states; no CTA leaves while another may
  // still read its own.
  wg::cluster_arrive();
  wg::cluster_wait();
}

}  // namespace dmma
