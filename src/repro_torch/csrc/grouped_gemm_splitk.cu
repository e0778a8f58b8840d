// B3's split-K engine: the decode group's grouped GEMM for Hopper (sm_90a).
//
// Replaces, for bf16 operands with an f32 accumulator and at most 16 rows:
// src/repro/kernels/grouped_gemm.py, grouped_gemm_pallas / _kernel
// (x (G, C, K) @ w (G, K, N) -> (G, C, N), the epilogue -- no C, no bias --
// on each member's accumulator).  Everything else stays on the tile loop
// (grouped_gemm.cu); core/geometry.py:grouped_engine chooses.
//
// What bounds it on the H100: bytes.  The decode q/k/v group (C = 4 slots,
// K = d_model, members 2048/256/256 wide for gemma_2b, 4096/256/256 for
// recurrentgemma_9b) reads every live weight byte once for 2C FLOP per
// byte.  The tile loop gave each of its 20 live 16 x 128 tiles one block
// walking K in 64 dependent steps, with no load in flight across steps:
// ~0.1 TB/s.  This kernel spreads the weight over every SM and keeps the
// loads in flight:
//
// - Grid (slices, live tiles): one CTA per (128-column live tile, K slice).
//   core/geometry.py:grouped_split picks the fewest slices (up to 4)
//   that give live tiles x slices >= the SM count -- 4 x 20 tiles for
//   gemma_2b's group, 4 x 36 for recurrentgemma_9b's --, up to 8 where x's
//   slice would not fit, each a multiple of a 64-row stage deep; tiles
//   wholly past a member's width are not in the grid and read no weight.
// - The CTAs of one tile are one thread-block cluster (cudaLaunchKernelEx,
//   cluster dimension = slices along x, so the cluster rank is the slice).
// - Weights: one producer warp streams the slice through a ring of 4
//   stages by TMA (a 3-D map over (G, K, N), so a box never reads into
//   the next member and rows past K come back as zeros); one stage is a
//   64 x 128 tile as two 64 x 64 panels in the 128-byte swizzle, 16 KB, so
//   64 KB of weight loads stay in flight per CTA.  A panel wholly past the
//   member's width is not loaded.
// - x: the C <= 16 rows are the A operand of mma.sync.m16n8k16 (bf16 ->
//   f32).  The consumers copy the CTA's slice of them (C x depth, through
//   x's group stride, 0 for the broadcast x) into shared memory once,
//   with independent loads, before the first stage lands: read per stage
//   from global memory instead, each stage waited one L2 round trip.
//   Rows >= C are zeros in registers, never stored or read.  The slice
//   is at most 128 KB (geometry.grouped_max_depth).  mma.sync and not
//   wgmma: wgmma needs 64 rows, 16x the work at C = 4, and the tensor
//   cores are idle here either way.
// - W: four consumer warps, 32 columns each, read their B fragments with
//   ldmatrix.trans from the swizzled (K, N) row-major panels: the swizzle
//   makes the 8 rows of each 8 x 8 matrix hit 8 different bank groups.
// - Reduction: each CTA leaves its f32 partial (16 x 128) in its idle
//   ring; after a cluster barrier, rank r takes every S-th run of
//   THREADS elements from the r-th on, sums each over the ranks in rank
//   order 0..S-1 through distributed shared memory, applies the epilogue
//   (alpha, softcap, activation) and writes them.  One launch, no
//   atomics, the same sum order on every call: the output is bit-equal
//   from call to call.  A second cluster barrier keeps every CTA's
//   shared memory alive until the last read.
// - Widths: columns at or past a member's width come back as zeros: the
//   straddling tile writes them in the reduction, and the tiles wholly in
//   the padding are zeroed by the clusters in turn (cluster y takes the
//   padding tiles p with p % live tiles == y) while their first stages
//   load.
#include "epilogue.cuh"
#include "wgmma_mainloop.cuh"

namespace {

constexpr int BN = 128;                  // output columns of one tile
constexpr int BK = 64;                   // K rows of one stage
constexpr int STAGES = 4;
constexpr int CONSUMERS = 128;           // 4 warps x 32 columns
constexpr int THREADS = CONSUMERS + 32;  // + the producer warp
constexpr int PANEL = BK * 64 * 2;       // 64 x 64 bf16
constexpr int STAGE_BYTES = 2 * PANEL;
constexpr int MAX_M = 16;
constexpr int MAX_SPLIT = 8;
constexpr int MAX_WIDTHS = 8;
// The ring (which holds the f32 partial once the loop is done), the
// barriers; then the x slice, M rows of depth + 8 bf16 (the pad puts the 8
// rows a fragment load reads in 8 different bank groups).
constexpr int SMEM_FIXED = 1024 + STAGES * STAGE_BYTES + 16 * STAGES;
static_assert(MAX_M * BN * 4 <= STAGES * STAGE_BYTES, "no room for the sum");
constexpr int X_PAD = 8;

struct Widths {
  int count;
  int w[MAX_WIDTHS];
};

__device__ __forceinline__ int live_width(const Widths& wd, int g, int N) {
  return g < wd.count ? min(wd.w[g], N) : N;
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

__global__ void __launch_bounds__(THREADS, 1)
    grouped_splitk_kernel(const __grid_constant__ CUtensorMap tmw,
                          const unsigned short* X, long sx, long ldx, int G,
                          int M, int N, int K, int depth, Epi epi,
                          Widths wd) {
  extern __shared__ __align__(1024) unsigned char smem[];
  unsigned char* ring =
      smem + ((1024 - (wg::smem_u32(smem) & 1023)) & 1023);
  float* part = reinterpret_cast<float*>(ring);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + STAGES * STAGE_BYTES);
  uint64_t* empty = full + STAGES;
  unsigned short* xs = reinterpret_cast<unsigned short*>(empty + STAGES);
  const int ldxs = depth + X_PAD;
  const int S = gridDim.x, rank = blockIdx.x, T = gridDim.y;
  const int tid = threadIdx.x, lane = tid & 31;
  const int warp = __shfl_sync(0xffffffffu, tid / 32, 0);

  // This cluster's live tile: (member g, first column n0); none when the
  // grid carries one cluster for a group with no live column.
  int g = -1, n0 = 0, n_live = 0;
  {
    int t = blockIdx.y;
    for (int i = 0; i < G; ++i) {
      const int live = live_width(wd, i, N);
      const int tiles = (live + BN - 1) / BN;
      if (t < tiles) {
        g = i, n0 = t * BN, n_live = live;
        break;
      }
      t -= tiles;
    }
  }
  const int k0 = rank * depth;
  const int nst = g < 0 ? 0 : (min(depth, K - k0) + BK - 1) / BK;
  const bool two_panels = n0 + 64 < n_live;

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      wg::mbar_init(&full[s], 1);
      wg::mbar_init(&empty[s], CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == CONSUMERS / 32) {
    // The producer: one thread keeps up to STAGES stages in flight.
    if (lane == 0) {
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                       reinterpret_cast<uint64_t>(&tmw))
                   : "memory");
      for (int kb = 0; kb < nst; ++kb) {
        const int s = kb % STAGES;
        wg::mbar_wait(&empty[s], ((kb / STAGES) & 1) ^ 1);
        unsigned char* st = ring + s * STAGE_BYTES;
        wg::mbar_expect_tx(&full[s], two_panels ? STAGE_BYTES : PANEL);
        wg::tma_load_3d(st, &tmw, &full[s], n0, k0 + kb * BK, g);
        if (two_panels)
          wg::tma_load_3d(st + PANEL, &tmw, &full[s], n0 + 64, k0 + kb * BK,
                          g);
      }
    }
  } else {
    // A consumer warp: columns [32 warp, 32 warp + 32) of the tile, as
    // four m16n8 accumulators (c0, c1: row gid; c2, c3: row gid + 8).
    const int gid = lane >> 2, tq = lane & 3;
    // The tiles wholly past a member's width: zeros, written while the
    // first stages are in flight, shared out over the clusters (the p-th
    // padding tile, counted over the members in order, goes to cluster
    // p % T) and their ranks.
    const int ntile = (N + BN - 1) / BN;
    for (int p = blockIdx.y;; p += T) {
      int i = 0, t = p, first = 0;
      for (; i < G; ++i) {
        first = (live_width(wd, i, N) + BN - 1) / BN;
        if (t < ntile - first) break;
        t -= ntile - first;
      }
      if (i == G) break;
      const long o_base = static_cast<long>(i) * M * N;
      for (int e = rank * CONSUMERS + tid; e < M * BN;
           e += S * CONSUMERS) {
        const int r = e / BN, gc = (first + t) * BN + e % BN;
        if (gc < N)
          store_from_f32(epi.out, o_base + static_cast<long>(r) * N + gc,
                         epi.out_type, 0.0f);
      }
    }
    // This slice of x's M rows into shared memory once, zeros past K: the
    // loads are independent, so the slice costs one L2 round trip,
    // overlapped with the first stages' TMA loads.
    if (nst > 0) {
      const unsigned short* xg = X + static_cast<long>(g) * sx;
      for (int r = 0; r < M; ++r)
        for (int c = tid; c < depth; c += CONSUMERS)
          xs[r * ldxs + c] =
              k0 + c < K ? __ldg(xg + static_cast<long>(r) * ldx + k0 + c)
                         : static_cast<unsigned short>(0);
    }
    wg::consumer_sync<CONSUMERS>();
    const unsigned short* x0 = xs + gid * ldxs;
    const unsigned short* x1 = xs + (gid + 8) * ldxs;
    const bool v0 = gid < M, v1 = gid + 8 < M;
    const bool live = n0 + 32 * warp < n_live;
    // ldmatrix row addresses: lanes 0-7 / 8-15 / 16-23 / 24-31 give the
    // rows of the four 8 x 8 matrices (k 0-7 | 8-15) x (n 0-7 | 8-15) of a
    // k16 x n16 block; the 128-byte swizzle XORs the 16-byte chunk with
    // the row's index in its 8-row atom, which is lane & 7 at every k16.
    uint32_t off[2];
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const int n = 32 * warp + 16 * p + 8 * (lane >> 4);
      const int krow = (lane & 7) + 8 * ((lane >> 3) & 1);
      off[p] = (n >> 6) * PANEL + krow * 128 +
               ((((n & 63) >> 3) ^ (lane & 7)) << 4);
    }
    float acc[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[j][i] = 0.0f;
    for (int kb = 0; kb < nst; ++kb) {
      const int s = kb % STAGES;
      wg::mbar_wait(&full[s], (kb / STAGES) & 1);
      if (live) {
        const uint32_t base = wg::smem_u32(ring + s * STAGE_BYTES);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          // A: rows gid and gid + 8, K pairs 2tq and 2tq + 8.
          const int kx = kb * BK + kk * 16 + 2 * tq;
          uint32_t a[4];
          a[0] = v0 ? *reinterpret_cast<const uint32_t*>(x0 + kx) : 0u;
          a[1] = v1 ? *reinterpret_cast<const uint32_t*>(x1 + kx) : 0u;
          a[2] = v0 ? *reinterpret_cast<const uint32_t*>(x0 + kx + 8) : 0u;
          a[3] = v1 ? *reinterpret_cast<const uint32_t*>(x1 + kx + 8) : 0u;
          uint32_t b0[4], b1[4];
          ldsm_x4_trans(b0, base + off[0] + kk * 16 * 128);
          ldsm_x4_trans(b1, base + off[1] + kk * 16 * 128);
          mma_16816(acc[0], a, b0[0], b0[1]);
          mma_16816(acc[1], a, b0[2], b0[3]);
          mma_16816(acc[2], a, b1[0], b1[1]);
          mma_16816(acc[3], a, b1[2], b1[3]);
        }
      }
      wg::mbar_arrive(&empty[s]);
    }
    // Every warp is done with the ring (and every load into it has
    // landed): the partial goes where the stages were.
    wg::consumer_sync<CONSUMERS>();
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = 32 * warp + 8 * j + 2 * tq;
      part[gid * BN + c] = acc[j][0];
      part[gid * BN + c + 1] = acc[j][1];
      part[(gid + 8) * BN + c] = acc[j][2];
      part[(gid + 8) * BN + c + 1] = acc[j][3];
    }
  }

  // Every partial of the cluster is in place.
  wg::cluster_arrive();
  wg::cluster_wait();
  if (g >= 0) {
    const long o_base = static_cast<long>(g) * M * N;
    for (int e = rank * THREADS + tid; e < M * BN; e += S * THREADS) {
      const int r = e / BN, gc = n0 + e % BN;
      if (gc >= N) continue;
      float p[MAX_SPLIT];
#pragma unroll
      for (int q = 0; q < MAX_SPLIT; ++q)
        p[q] = q < S ? wg::ld_cluster(part + e, q) : 0.0f;
      float v = 0.0f;
#pragma unroll
      for (int q = 0; q < MAX_SPLIT; ++q) v += p[q];
      store_from_f32(epi.out, o_base + static_cast<long>(r) * N + gc,
                     epi.out_type,
                     gc < n_live ? apply_epi<false>(v, r, gc, epi) : 0.0f);
    }
  }
  // This CTA has read the others' partials; no CTA leaves while another
  // may still read its partial.
  wg::cluster_arrive();
  wg::cluster_wait();
}

}  // namespace

extern "C" int grouped_gemm_splitk_launch(
    const void* x, const void* w, void* out, int G, int M, int N, int K,
    long sx, long ldx, int out_type, int n_split, int depth, int n_tiles,
    float alpha, int has_softcap, float softcap, int act, int n_widths,
    const int* widths, void* stream) {
  if (G <= 0 || M <= 0 || M > MAX_M || N <= 0 || N % 8 != 0 || K <= 0 ||
      n_split < 1 || n_split > MAX_SPLIT || depth <= 0 || depth % BK != 0 ||
      static_cast<long>(n_split - 1) * depth >= K ||
      static_cast<long>(n_split) * depth < K || n_tiles < 1 ||
      n_widths < 0 || n_widths > MAX_WIDTHS ||
      (out_type != DT_F32 && out_type != DT_BF16))
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tmw;
  const int e = wg::make_map_3d(&tmw, w, N, K, G, 64, BK);
  if (e != 0) return e;
  Epi epi{alpha, 0.0f, nullptr, 0, nullptr, softcap, has_softcap, act, out,
          N, out_type};
  Widths wd{n_widths, {}};
  for (int i = 0; i < n_widths; ++i) wd.w[i] = widths[i];
  const int smem = SMEM_FIXED + M * (depth + X_PAD) * 2;
  if (smem > wg::SMEM_LIMIT) return static_cast<int>(cudaErrorInvalidValue);
  static bool sized = false;
  if (!sized) {
    const cudaError_t ce = cudaFuncSetAttribute(
        grouped_splitk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        wg::SMEM_LIMIT);
    if (ce != cudaSuccess) return static_cast<int>(ce);
    sized = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_split, n_tiles, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = n_split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t le = cudaLaunchKernelEx(
      &cfg, grouped_splitk_kernel, tmw,
      static_cast<const unsigned short*>(x), sx, ldx, G, M, N, K, depth, epi,
      wd);
  if (le != cudaSuccess) return static_cast<int>(le);
  return static_cast<int>(cudaGetLastError());
}
