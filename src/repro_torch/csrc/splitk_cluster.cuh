// The cluster split-K mainloop for GEMMs of at most 16 rows (sm_90a), shared
// by grouped_gemm_splitk.cu (B3's decode group) and splitk_gemm_cluster.cu
// (B2's decode GEMMs).  Each kernel keeps its own grid mapping, weight map
// and epilogue; this header holds what they have in common.
//
// What bounds these GEMMs on the H100: bytes.  At M <= 16 rows a weight
// byte feeds 2M FLOP, so the kernel is a stream of the weight through the
// SMs, and what matters is keeping every SM's loads in flight:
//
// - One CTA per (128-column output tile, K slice); the slices of a tile are
//   one thread-block cluster (cluster dimension = slices along grid x, so
//   the cluster rank is the slice), at most 8 CTAs (the portable cluster).
// - Weights: one producer warp streams the slice through a ring of STAGES
//   stages by TMA; one stage is a 64 x 128 tile as two 64 x 64 panels in
//   the 128-byte swizzle, 16 KB, so 64 KB of weight loads stay in flight
//   per CTA.  The kernel's Load functor issues one panel's TMA load (a 2-D
//   or 3-D map: rows past K come back as zeros); a panel wholly past the
//   tile's live columns is not loaded.
// - x: the M <= 16 rows are the A operand of mma.sync.m16n8k16 (bf16 ->
//   f32).  The consumers copy the CTA's slice of them (M x depth) into
//   shared memory once, with independent 16-byte loads, while the first
//   stages land: read per stage from global memory instead, each stage
//   waited one L2 round trip.  Rows >= M are zeros in registers, never
//   stored or read.  The slice is at most GROUPED_X_BYTES
//   (core/geometry.py), 128 KB, each row padded by 16 bytes.
//   mma.sync and not wgmma: wgmma needs 64 rows, 16x the work at M = 4,
//   and the tensor cores are idle here either way.
// - W: four consumer warps, 32 columns each, read their B fragments with
//   ldmatrix.trans from the swizzled (K, N) row-major panels: the swizzle
//   makes the 8 rows of each 8 x 8 matrix hit 8 different bank groups.
// - bf16acc (BF16ACC): a bf16 accumulator emulated per slice, as B1's wgmma
//   mainloop emulates one: a second register set holds the f32 partial of
//   the current `rbk`-deep K block, counted from the slice's first row
//   (rbk a multiple of 16, so a boundary can fall inside a 64-deep stage);
//   where a block ends -- or the slice's live rows do -- the running sum
//   becomes bf16_round(acc + bf16_round(part)).  The slices' bf16 partials
//   are then summed in f32 in rank order and the sum rounded to bf16 once
//   (reduce<true>): the reference's split-K contract under bf16acc
//   (bf16 partials per slice, their sum, src/repro/kernels/splitk_gemm.py).
//   The f32 path (BF16ACC false) compiles to the loop without it.
// - int8 (S8): int8 operands, an int32 accumulator, the identity epilogue
//   (the quantized decode GEMMs).  A stage holds 128 K rows of 128 int8
//   columns, one 128 x 128 TMA box of the same 16 KB (the same 128-byte
//   swizzled rows) as a bf16 stage, so the same 64 KB of weight stay in
//   flight while the kernel moves half the bytes.  x's rows are the A
//   operand of mma.sync.m16n8k32 (s8 x s8 -> s32) from shared memory,
//   rows >= M zeros in registers, as for bf16.  The weight is read as it
//   lies, (K, N) row-major: m16n8k32 wants four consecutive K of one column
//   in each B register, and sm_90 has no 8-bit transposing ldmatrix.  So
//   ldmatrix.trans.b16 reads the panel as 16-bit pairs of columns: a lane
//   gets two K rows x two columns from each 8 x 8 matrix.  The row
//   addresses a matrix is given pick the K rows {0, 1, 4, 5, 10, 11, 14,
//   15} (and those XOR 2 for its partner) of a 16-row step, so a byte
//   permute (prmt) of a matrix and its partner gives each lane the four
//   rows 4tq .. 4tq + 3 of one column, what the A operand holds; the 8
//   rows of every matrix still sit in 8 different 16-byte chunks of the
//   swizzle, so the loads stay free of bank conflicts, as many per stage
//   as bf16's.  A warp's 32 columns come out as four n8 tiles with their
//   columns interleaved (tile t holds columns 16 (t / 2) + 2 n + t % 2);
//   the partial's store maps them back.  The slices' int32 partials are
//   summed in rank order (reduce<.., true>): integer sums are exact, so
//   any split gives the bits of one int32 dot product per output.
// - Reduction (reduce()): each CTA leaves its f32 partial (16 x 128) in its
//   idle ring; after a cluster barrier, rank r takes every S-th run of
//   THREADS elements from the r-th on, sums each over the ranks in rank
//   order 0..S-1 through distributed shared memory and hands the sum to the
//   kernel's Store functor, which applies its epilogue and writes.  One
//   launch, no atomics, the same sum order on every call: the output is
//   bit-equal from call to call.  A second cluster barrier keeps every
//   CTA's shared memory alive until the last read.
#pragma once

#include <type_traits>

#include "wgmma_mainloop.cuh"

namespace skc {

constexpr int BN = 128;                  // output columns of one tile
constexpr int BK = 64;                   // K rows of one bf16 stage
constexpr int BK_S8 = 128;               // K rows of one int8 stage
constexpr int STAGES = 4;
constexpr int CONSUMERS = 128;           // 4 warps x 32 columns
constexpr int THREADS = CONSUMERS + 32;  // + the producer warp
constexpr int PANEL = BK * 64 * 2;       // 64 x 64 bf16
constexpr int STAGE_BYTES = 2 * PANEL;
static_assert(BK_S8 * BN == STAGE_BYTES, "an int8 stage is a bf16 stage's "
              "bytes");
constexpr int MAX_M = 16;
constexpr int MAX_SPLIT = 8;
// The ring (which holds the f32 or int32 partial once the loop is done),
// the barriers; then the x slice, M rows of depth elements + 16 bytes (the
// pad puts the 8 rows a fragment load reads in 8 different bank groups).
constexpr int SMEM_FIXED = 1024 + STAGES * STAGE_BYTES + 16 * STAGES;
static_assert(MAX_M * BN * 4 <= STAGES * STAGE_BYTES, "no room for the sum");
constexpr int X_PAD_BYTES = 16;

// Dynamic shared memory for m rows of a depth-deep slice of x whose
// elements are elem_bytes wide (bf16 2, int8 1).
inline int smem_bytes(int m, int depth, int elem_bytes = 2) {
  return SMEM_FIXED + m * (depth * elem_bytes + X_PAD_BYTES);
}

// The carve of the dynamic shared memory: the 1024-aligned ring, the
// partial over it, the barriers, the x slice.
struct Smem {
  unsigned char* ring;
  float* part;
  uint64_t* full;
  uint64_t* empty;
  unsigned short* xs;
};

__device__ __forceinline__ Smem carve(unsigned char* smem) {
  Smem s;
  s.ring = smem + ((1024 - (wg::smem_u32(smem) & 1023)) & 1023);
  s.part = reinterpret_cast<float*>(s.ring);
  s.full = reinterpret_cast<uint64_t*>(s.ring + STAGES * STAGE_BYTES);
  s.empty = s.full + STAGES;
  s.xs = reinterpret_cast<unsigned short*>(s.empty + STAGES);
  return s;
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

// int8 x int8 -> int32, no saturation: the launchers refuse K past
// wg::S8_MAX_K, below which no sum leaves the int32 range.
__device__ __forceinline__ void mma_16832_s8(int* d, const uint32_t* a,
                                             uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// An int of cluster CTA `rank`'s shared memory at the address of `local`
// in ours (distributed shared memory), as wg::ld_cluster reads a float.
__device__ __forceinline__ int ld_cluster_s32(const int* local,
                                              uint32_t rank) {
  uint32_t remote;
  int v;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(wg::smem_u32(local)), "r"(rank));
  asm volatile("ld.shared::cluster.s32 %0, [%1];\n" : "=r"(v) : "r"(remote));
  return v;
}

// One CTA's slice: x rows [0, M) (row stride ldx elements) times the
// weight rows [k0, k0 + nst * KD) of the tile's columns [n0, n0 + BN), of
// which those below n_live are live; KD is BK (bf16) or BK_S8 (S8).  Every
// thread of the CTA calls it.
// load(dst, bar, column, k row) issues one TMA box -- a 64 x 64 bf16
// panel, or the whole 128 x 128 int8 stage -- through `map` (prefetched
// once by the producer); the consumers call side() (work that overlaps the
// first stages' loads) before they copy x.
// BF16ACC rounds the running sum once per rbk-deep block of the slice.
// On return the CTA's partial is in sm.part (f32; bf16 values under
// BF16ACC; int32 under S8).
template <bool BF16ACC, bool S8, class Load, class Side>
__device__ __forceinline__ void mainloop(
    const Smem& sm, const CUtensorMap* map, const void* xg_, long ldx, int M,
    int K, int k0, int depth, int nst, int n0, int n_live, int rbk,
    const Load& load, const Side& side) {
  static_assert(!(BF16ACC && S8), "int8 accumulates in int32");
  // x's element type (bytes are bytes), the elements of a 16-byte vector,
  // and K rows per stage.
  using XT = typename std::conditional<S8, unsigned char,
                                       unsigned short>::type;
  constexpr int XV = 16 / sizeof(XT);
  constexpr int KD = S8 ? BK_S8 : BK;
  const XT* xg = static_cast<const XT*>(xg_);
  const int ldxs = depth + X_PAD_BYTES / static_cast<int>(sizeof(XT));
  const int tid = threadIdx.x, lane = tid & 31;
  const int warp = __shfl_sync(0xffffffffu, tid / 32, 0);
  const bool two_panels = n0 + 64 < n_live;

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      wg::mbar_init(&sm.full[s], 1);
      wg::mbar_init(&sm.empty[s], CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == CONSUMERS / 32) {
    // The producer: one thread keeps up to STAGES stages in flight.
    if (lane == 0) {
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                       reinterpret_cast<uint64_t>(map))
                   : "memory");
      for (int kb = 0; kb < nst; ++kb) {
        const int s = kb % STAGES;
        wg::mbar_wait(&sm.empty[s], ((kb / STAGES) & 1) ^ 1);
        unsigned char* st = sm.ring + s * STAGE_BYTES;
        if constexpr (S8) {
          wg::mbar_expect_tx(&sm.full[s], STAGE_BYTES);
          load(st, &sm.full[s], n0, k0 + kb * KD);
        } else {
          wg::mbar_expect_tx(&sm.full[s], two_panels ? STAGE_BYTES : PANEL);
          load(st, &sm.full[s], n0, k0 + kb * BK);
          if (two_panels)
            load(st + PANEL, &sm.full[s], n0 + 64, k0 + kb * BK);
        }
      }
    }
    return;
  }
  // A consumer warp: columns [32 warp, 32 warp + 32) of the tile, as four
  // m16n8 accumulators (c0, c1: row gid; c2, c3: row gid + 8).
  const int gid = lane >> 2, tq = lane & 3;
  side();
  // This slice of x's M rows into shared memory once, zeros past K,
  // overlapped with the first stages' TMA loads: 16 bytes a load where the
  // rows are 16-byte aligned, four loads in flight a thread.
  XT* xs = reinterpret_cast<XT*>(sm.xs);
  if (nst > 0) {
    const bool vec = ((reinterpret_cast<uintptr_t>(xg) |
                       (ldx * static_cast<long>(sizeof(XT)))) & 15) == 0;
    if (vec) {
      const int chunks = depth / XV;
#pragma unroll 4
      for (int e = tid; e < M * chunks; e += CONSUMERS) {
        const int r = e / chunks, c = XV * (e % chunks);
        const XT* src = xg + static_cast<long>(r) * ldx + k0 + c;
        uint4 v = make_uint4(0, 0, 0, 0);
        if (k0 + c + XV <= K) {
          v = __ldg(reinterpret_cast<const uint4*>(src));
        } else {
          __align__(16) XT t[XV];
#pragma unroll
          for (int i = 0; i < XV; ++i)
            t[i] = k0 + c + i < K ? __ldg(src + i) : static_cast<XT>(0);
          v = *reinterpret_cast<const uint4*>(t);
        }
        *reinterpret_cast<uint4*>(xs + r * ldxs + c) = v;
      }
    } else {
      for (int r = 0; r < M; ++r)
        for (int c = tid; c < depth; c += CONSUMERS)
          xs[r * ldxs + c] =
              k0 + c < K ? __ldg(xg + static_cast<long>(r) * ldx + k0 + c)
                         : static_cast<XT>(0);
    }
  }
  wg::consumer_sync<CONSUMERS>();
  const XT* x0 = xs + gid * ldxs;
  const XT* x1 = xs + (gid + 8) * ldxs;
  const bool v0 = gid < M, v1 = gid + 8 < M;
  const bool live = n0 + 32 * warp < n_live;
  if constexpr (S8) {
    // ldmatrix row addresses: lanes 8q .. 8q + 7 give the rows of matrix q
    // of a 16-row step: K rows R[j] = {0, 1, 4, 5, 10, 11, 14, 15}[j],
    // XOR 2 for odd q, of the warp's bytes [0, 16) (q < 2) or [16, 32); the
    // 128-byte swizzle XORs the 16-byte chunk with the row's index in its
    // 8-row atom.  A lane then holds, from matrix q, K rows R[2 tq] and
    // R[2 tq + 1] of columns 2 gid and 2 gid + 1 (+ 16 for q >= 2): with
    // its partner q ^ 1, the rows 4tq .. 4tq + 3.
    const int j = lane & 7, q = lane >> 3;
    const int krow = (4 * (j >> 1) + (j & 1) + 2 * ((j >> 2) & 1)) ^
                     (2 * (q & 1));
    const uint32_t off =
        krow * 128 + (((2 * warp + (q >> 1)) ^ (krow & 7)) << 4);
    // The byte permutes that put K rows 4tq .. 4tq + 3 in order: even
    // columns take bytes 0 and 2 of each pair register, odd ones 1 and 3;
    // for tq >= 2 the partner (odd q) holds the first two rows.
    const uint32_t sel_even = tq < 2 ? 0x6420u : 0x2064u;
    const uint32_t sel_odd = tq < 2 ? 0x7531u : 0x3175u;
    int acc[4][4];
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[t][i] = 0;
    for (int kb = 0; kb < nst; ++kb) {
      const int s = kb % STAGES;
      wg::mbar_wait(&sm.full[s], (kb / STAGES) & 1);
      if (live) {
        const uint32_t base = wg::smem_u32(sm.ring + s * STAGE_BYTES) + off;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          // A: rows gid and gid + 8, K quads 4tq and 4tq + 16.
          const int kx = kb * BK_S8 + kk * 32 + 4 * tq;
          uint32_t a[4];
          a[0] = v0 ? *reinterpret_cast<const uint32_t*>(x0 + kx) : 0u;
          a[1] = v1 ? *reinterpret_cast<const uint32_t*>(x1 + kx) : 0u;
          a[2] = v0 ? *reinterpret_cast<const uint32_t*>(x0 + kx + 16) : 0u;
          a[3] = v1 ? *reinterpret_cast<const uint32_t*>(x1 + kx + 16) : 0u;
          uint32_t h0[4], h1[4];
          ldsm_x4_trans(h0, base + kk * 32 * 128);
          ldsm_x4_trans(h1, base + (kk * 32 + 16) * 128);
#pragma unroll
          for (int t = 0; t < 4; ++t) {
            const int p = 2 * (t >> 1);
            const uint32_t sel = (t & 1) ? sel_odd : sel_even;
            mma_16832_s8(acc[t], a, __byte_perm(h0[p], h0[p + 1], sel),
                         __byte_perm(h1[p], h1[p + 1], sel));
          }
        }
      }
      wg::mbar_arrive(&sm.empty[s]);
    }
    wg::consumer_sync<CONSUMERS>();
    // Tile t's column n is the warp's column 16 (t / 2) + 2 n + t % 2.
    int* part = reinterpret_cast<int*>(sm.part);
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = gid + 8 * (i >> 1);
        const int c = 32 * warp + 16 * (t >> 1) + 4 * tq + 2 * (i & 1) +
                      (t & 1);
        part[r * BN + c] = acc[t][i];
      }
  } else {
    // ldmatrix row addresses: lanes 0-7 / 8-15 / 16-23 / 24-31 give the
    // rows of the four 8 x 8 matrices (k 0-7 | 8-15) x (n 0-7 | 8-15) of a
    // k16 x n16 block; the 128-byte swizzle XORs the 16-byte chunk with the
    // row's index in its 8-row atom, which is lane & 7 at every k16.
    uint32_t off[2];
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const int n = 32 * warp + 16 * p + 8 * (lane >> 4);
      const int krow = (lane & 7) + 8 * ((lane >> 3) & 1);
      off[p] = (n >> 6) * PANEL + krow * 128 +
               ((((n & 63) >> 3) ^ (lane & 7)) << 4);
    }
    // acc: the running sum; part: the f32 partial of the current rbk-deep
    // block (BF16ACC only; unused, and dropped by the compiler, otherwise).
    float acc[4][4], part[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[j][i] = part[j][i] = 0.0f;
    // The slice's live K rows (BF16ACC: the last block ends there), and the
    // rows left in the current block (a countdown, not a modulo: the fold
    // test is on every k16 step).
    const int klen = min(depth, K - k0);
    int left = rbk;
    for (int kb = 0; kb < nst; ++kb) {
      const int s = kb % STAGES;
      wg::mbar_wait(&sm.full[s], (kb / STAGES) & 1);
      if (live) {
        const uint32_t base = wg::smem_u32(sm.ring + s * STAGE_BYTES);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          // A: rows gid and gid + 8, K pairs 2tq and 2tq + 8.
          const int kx = kb * BK + kk * 16 + 2 * tq;
          if constexpr (BF16ACC) {
            if (kb * BK + kk * 16 >= klen) break;  // the last block is folded
          }
          uint32_t a[4];
          a[0] = v0 ? *reinterpret_cast<const uint32_t*>(x0 + kx) : 0u;
          a[1] = v1 ? *reinterpret_cast<const uint32_t*>(x1 + kx) : 0u;
          a[2] = v0 ? *reinterpret_cast<const uint32_t*>(x0 + kx + 8) : 0u;
          a[3] = v1 ? *reinterpret_cast<const uint32_t*>(x1 + kx + 8) : 0u;
          uint32_t b0[4], b1[4];
          ldsm_x4_trans(b0, base + off[0] + kk * 16 * 128);
          ldsm_x4_trans(b1, base + off[1] + kk * 16 * 128);
          if constexpr (BF16ACC) {
            mma_16816(part[0], a, b0[0], b0[1]);
            mma_16816(part[1], a, b0[2], b0[3]);
            mma_16816(part[2], a, b1[0], b1[1]);
            mma_16816(part[3], a, b1[2], b1[3]);
            left -= 16;
            if (left == 0 || kb * BK + kk * 16 + 16 >= klen) {
#pragma unroll
              for (int j = 0; j < 4; ++j)
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                  acc[j][i] = bf16_round(acc[j][i] + bf16_round(part[j][i]));
                  part[j][i] = 0.0f;
                }
              left = rbk;
            }
          } else {
            mma_16816(acc[0], a, b0[0], b0[1]);
            mma_16816(acc[1], a, b0[2], b0[3]);
            mma_16816(acc[2], a, b1[0], b1[1]);
            mma_16816(acc[3], a, b1[2], b1[3]);
          }
        }
      }
      wg::mbar_arrive(&sm.empty[s]);
    }
    // Every warp is done with the ring (and every load into it has landed):
    // the partial goes where the stages were.
    wg::consumer_sync<CONSUMERS>();
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = 32 * warp + 8 * j + 2 * tq;
      sm.part[gid * BN + c] = acc[j][0];
      sm.part[gid * BN + c + 1] = acc[j][1];
      sm.part[(gid + 8) * BN + c] = acc[j][2];
      sm.part[(gid + 8) * BN + c + 1] = acc[j][3];
    }
  }
}

// The cluster's reduction: after every CTA's partial is in place, rank r
// sums its share of the tile's M x BN elements (columns below n_cols only)
// over the ranks in rank order and calls store(row, column in the tile,
// sum); BF16ACC rounds the sum to bf16 once; S8 sums int32 partials into
// an int32 (exact).  Every thread of every CTA of the cluster calls it;
// `active` false takes part in the barriers only.
template <bool BF16ACC, bool S8, class Store>
__device__ __forceinline__ void reduce(const Smem& sm, int M, int n_cols,
                                       bool active, const Store& store) {
  const int S = gridDim.x, rank = blockIdx.x, tid = threadIdx.x;
  // Every partial of the cluster is in place.
  wg::cluster_arrive();
  wg::cluster_wait();
  if (active) {
    for (int e = rank * THREADS + tid; e < M * BN; e += S * THREADS) {
      const int r = e / BN, c = e % BN;
      if (c >= n_cols) continue;
      if constexpr (S8) {
        const int* part = reinterpret_cast<const int*>(sm.part);
        int p[MAX_SPLIT];
#pragma unroll
        for (int q = 0; q < MAX_SPLIT; ++q)
          p[q] = q < S ? ld_cluster_s32(part + e, q) : 0;
        int v = 0;
#pragma unroll
        for (int q = 0; q < MAX_SPLIT; ++q) v += p[q];
        store(r, c, v);
      } else {
        float p[MAX_SPLIT];
#pragma unroll
        for (int q = 0; q < MAX_SPLIT; ++q)
          p[q] = q < S ? wg::ld_cluster(sm.part + e, q) : 0.0f;
        float v = 0.0f;
#pragma unroll
        for (int q = 0; q < MAX_SPLIT; ++q) v += p[q];
        store(r, c, BF16ACC ? bf16_round(v) : v);
      }
    }
  }
  // This CTA has read the others' partials; no CTA leaves while another
  // may still read its partial.
  wg::cluster_arrive();
  wg::cluster_wait();
}

}  // namespace skc
