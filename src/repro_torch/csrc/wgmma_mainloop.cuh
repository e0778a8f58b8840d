// The Hopper GEMM mainloop shared by mte_gemm.cu (B1), rigid_gemm.cu
// (B8 stage 1) and grouped_gemm_wgmma.cu (B3 past 16 rows, through
// gemm_tile with the member's index on its 3-D tensor maps): TMA loads
// into a ring of shared-memory stages, mbarrier
// hand-off between one producer warp and the consumer warpgroups, and
// wgmma with the f32 accumulator in registers.  sm_90a only.  Its PTX
// wrappers (TMA, mbarriers, wgmma, cluster barriers and distributed
// shared memory) and its cluster launch also serve the cluster kernels
// of B2, B3 and B4 and flash_attention_wgmma.cu (B5).
//
// - Block: BM/64 consumer warpgroups (each owns 64 rows of the BM x BN
//   output tile) and one producer warp, BM/64 * 128 + 32 threads, one
//   block per output tile (no persistence, no clusters).  blockIdx.x walks
//   M, so the blocks in flight share B's column panel and read it once
//   from device memory.
// - K is walked 64 deep (WK): one stage holds a BM x 64 A tile and a
//   64 x BN B tile, both in the 128-byte swizzle TMA writes and wgmma
//   reads.  STAGES = min(5, what fits in 227 KB).  The producer waits for
//   a stage's `empty` barrier, arms its `full` barrier with the stage's
//   bytes and issues the TMA loads; the consumers wait on `full`, run four
//   m64nBNk16 wgmmas from shared-memory descriptors, and arrive on
//   `empty` once those wgmmas have retired (one wgmma group stays in
//   flight while the next stage's is issued).
// - A is (M, K) row-major: K-major.  B is (K, N) row-major on the main
//   path: MN-major, read through wgmma's transpose bit, loaded as BN/64
//   panels of 64 x 64; or (N, K) row-major when TRANS_B (Formula 3):
//   K-major, loaded as one BN x 64 box.
// - Ragged edges: TMA fills every element outside the tensor with zero,
//   so ragged M, N and K need no masking in the loop; the epilogue skips
//   rows and columns past M and N.  TMA needs 16-byte aligned base
//   addresses and row strides: K and N multiples of 8 (the wrappers'
//   engine choice, core/geometry.py:gemm_engine).
// - bf16acc (BF16ACC): a second register set holds the partial of the
//   current `rbk`-deep K block (started with wgmma's scale-d = 0); at the
//   k16 step where a block ends (rbk is a multiple of 32, so a boundary
//   can fall inside a 64-deep stage) the wgmmas are drained and the
//   running sum becomes bf16_round(acc + bf16_round(part)) -- the
//   contract of gemm_tile.cuh's tile_wmma.
// - The accumulator never goes to device memory: once the loop is done
//   the consumers stage it through the idle ring in shared memory, and the
//   caller's Store functor gets (row, column, four f32 values of columns
//   c .. c + 3) from a rolled loop -- one copy of the epilogue's code,
//   one aligned vector write per four outputs.  (An epilogue unrolled
//   over every accumulator register makes a kernel of ~20k instructions
//   that stalls on instruction fetch.)
//
// Tensor maps are encoded on the host for every launch
// (cuTensorMapEncodeTiled, reached through cudaGetDriverEntryPoint, so
// the library needs no -lcuda) and passed as __grid_constant__ params.
#pragma once

#include <cuda.h>

#include "common.cuh"

namespace wg {

constexpr int WK = 64;                   // K depth of one stage
constexpr int SMEM_LIMIT = 227 * 1024;   // dynamic shared memory per block
constexpr int PANEL = WK * 64 * 2;       // one 64 x 64 bf16 B panel, bytes

template <int BM, int BN>
struct Cfg {
  static_assert(BM == 64 || BM == 128, "BM is 64 or 128");
  static_assert(BN == 64 || BN == 128 || BN == 256, "BN is 64, 128, 256");
  static constexpr int CONSUMERS = BM / 64;          // warpgroups
  static constexpr int THREADS = CONSUMERS * 128 + 32;
  static constexpr int A_BYTES = BM * WK * 2;
  static constexpr int B_BYTES = WK * BN * 2;
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  static constexpr int FIT = (SMEM_LIMIT - 2048) / STAGE_BYTES;
  static constexpr int STAGES = FIT < 5 ? FIT : 5;
  // 1 KB of slack to align the ring to the 1024-byte swizzle atom, then
  // the ring, then the full and empty barriers.
  static constexpr int SMEM = 1024 + STAGES * STAGE_BYTES + 16 * STAGES;
  static_assert(STAGES >= 3 && SMEM <= SMEM_LIMIT, "stage ring too big");
};

// ---- PTX wrappers -----------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// Spin until the phase of parity `parity` has completed.  The loop lives
// inside the asm, so the compiler sees no divergent branch around the
// wgmmas that follow.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// 2-D TMA load of one box at (c0 innermost, c1) into shared memory; its
// bytes are counted on `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

// 3-D TMA load of one box at (c0 innermost, c1, c2), for the kernels
// whose boxes must not cross from one matrix of a batch into the next
// (B3's split-K engine, B5's wgmma engine): rows past the middle
// dimension are filled with zeros, not read from the next matrix.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

// Order this thread's ordinary shared-memory writes before later reads by
// the async proxy (wgmma operands written by the threads themselves).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Thread-block cluster barrier, in two halves (arrive with release
// semantics, wait with acquire), usable from divergent code.
__device__ __forceinline__ void cluster_arrive() {
  __syncwarp();
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

// A float of cluster CTA `rank`'s shared memory at the address of `local`
// in ours (distributed shared memory).  No memory clobber: the cluster
// barriers around the reads order them, and a batch of them can be in
// flight at once.
__device__ __forceinline__ float ld_cluster(const float* local,
                                            uint32_t rank) {
  uint32_t remote;
  float v;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(smem_u32(local)), "r"(rank));
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n" : "=f"(v) : "r"(remote));
  return v;
}

// A shared-memory matrix descriptor for the 128-byte swizzle: start
// address, leading and stride byte offsets (all >> 4), layout type 1.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// A barrier over the consumer warpgroups only (the producer warp has
// left): named barrier 1.
template <int THREADS>
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(THREADS) : "memory");
}

// Keep the compiler from moving register reads or writes of an
// accumulator across the asynchronous wgmmas that own it.
template <int R>
__device__ __forceinline__ void fence_regs(float* d) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// wgmma.mma_async m64nNk16, bf16 x bf16 -> f32, A and B from shared
// memory; TB = 1 reads B MN-major (the transpose bit), 0 K-major.
template <int N, int TB>
struct Mma;

template <int TB>
struct Mma<64, TB> {
  __device__ __forceinline__ static void run(float* d, uint64_t da,
                                             uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 0, %35;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(scale_d), "n"(TB));
  }
};

template <int TB>
struct Mma<128, TB> {
  __device__ __forceinline__ static void run(float* d, uint64_t da,
                                             uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
        "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
        "%60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, 0, %67;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
          "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
          "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "r"(scale_d), "n"(TB));
  }
};

template <int TB>
struct Mma<256, TB> {
  __device__ __forceinline__ static void run(float* d, uint64_t da,
                                             uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
        "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
        "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
        "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
        "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
        "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, "
        "%120, %121, %122, %123, %124, %125, %126, %127"
        "}, %128, %129, p, 1, 1, 0, %131;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
          "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
          "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
          "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
          "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
          "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
          "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
          "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
          "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
          "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
          "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
          "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
          "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
          "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
          "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
          "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
        : "l"(da), "l"(db), "r"(scale_d), "n"(TB));
  }
};


// ---- the kernel ------------------------------------------------------------

// One BM x BN output tile at (m0, n0) over all of K, run by the whole
// block (Cfg::THREADS threads, Cfg::SMEM bytes of dynamic shared memory).
// `za` and `zb` are the batch index of A's and B's tensor maps where they
// are 3-D (a grouped GEMM's members: a box never crosses into the next
// matrix, so each member's K tail loads zeros), or -1 for a 2-D map.
template <int BM, int BN, bool TRANS_B, bool BF16ACC, class Store>
__device__ __forceinline__ void gemm_tile(const CUtensorMap* tma,
                                          const CUtensorMap* tmb, int K,
                                          int rbk, const Store& store,
                                          int m0, int n0, int za, int zb) {
  using C = Cfg<BM, BN>;
  constexpr int S = C::STAGES;
  constexpr int R = BN / 2;  // accumulator registers per thread
  extern __shared__ __align__(1024) unsigned char wg_smem[];
  unsigned char* ring =
      wg_smem + ((1024 - (smem_u32(wg_smem) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + S * C::STAGE_BYTES);
  uint64_t* empty = full + S;
  const int nk = (K + WK - 1) / WK;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], C::CONSUMERS * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // The role of this thread's warpgroup, broadcast from lane 0 so the
  // compiler knows it is uniform across the warp (wgmma must not sit in
  // a branch it thinks divergent, or ptxas serializes it).
  const int g = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (g == C::CONSUMERS) {
    // The producer warp: one thread keeps up to S stages of loads in
    // flight.  A stage is free once every consumer thread arrived on its
    // `empty` barrier; on the first round the parity trick lets it pass.
    if (threadIdx.x == C::CONSUMERS * 128) {
      for (int kb = 0; kb < nk; ++kb) {
        const int s = kb % S;
        mbar_wait(&empty[s], ((kb / S) & 1) ^ 1);
        unsigned char* sa = ring + s * C::STAGE_BYTES;
        unsigned char* sb = sa + C::A_BYTES;
        mbar_expect_tx(&full[s], C::STAGE_BYTES);
        if (za < 0)
          tma_load(sa, tma, &full[s], kb * WK, m0);
        else
          tma_load_3d(sa, tma, &full[s], kb * WK, m0, za);
        if constexpr (TRANS_B) {
          if (zb < 0)
            tma_load(sb, tmb, &full[s], kb * WK, n0);
          else
            tma_load_3d(sb, tmb, &full[s], kb * WK, n0, zb);
        } else {
#pragma unroll
          for (int p = 0; p < BN / 64; ++p) {
            if (zb < 0)
              tma_load(sb + p * PANEL, tmb, &full[s], n0 + 64 * p, kb * WK);
            else
              tma_load_3d(sb + p * PANEL, tmb, &full[s], n0 + 64 * p,
                          kb * WK, zb);
          }
        }
      }
    }
    return;
  }

  // A consumer warpgroup: rows [64 * g, 64 * g + 64) of the tile.
  float acc[R];
  float part[BF16ACC ? R : 1];
#pragma unroll
  for (int i = 0; i < R; ++i) acc[i] = 0.0f;
  for (int kb = 0; kb < nk; ++kb) {
    const int s = kb % S;
    mbar_wait(&full[s], (kb / S) & 1);
    const uint32_t a0 = smem_u32(ring + s * C::STAGE_BYTES) + g * 64 * 128;
    const uint32_t b0 = smem_u32(ring + s * C::STAGE_BYTES + C::A_BYTES);
    if constexpr (BF16ACC) fence_regs<R>(part);
    else fence_regs<R>(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < WK / 16; ++kk) {
      const int k = kb * WK + kk * 16;  // first K index of this step
      // A: K-major, 8-row atoms 1024 B apart, +32 B per k16 step.  B:
      // K-major likewise, or MN-major (64-column panels PANEL bytes
      // apart, 8-row atoms 1024 B apart, +2048 B per k16 step).
      const uint64_t da = desc(a0 + kk * 32, 16, 1024);
      const uint64_t db = TRANS_B ? desc(b0 + kk * 32, 16, 1024)
                                  : desc(b0 + kk * 2048, PANEL, 1024);
      if constexpr (BF16ACC) {
        if (k >= K) break;  // the last K block is folded: stop
        Mma<BN, TRANS_B ? 0 : 1>::run(part, da, db, k % rbk != 0);
        if ((k + 16) % rbk == 0 || k + 16 >= K) {
          // The K block ends here: drain, fold, and start a new partial.
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs<R>(part);
#pragma unroll
          for (int i = 0; i < R; ++i)
            acc[i] = bf16_round(acc[i] + bf16_round(part[i]));
          fence_regs<R>(part);
          wgmma_fence();
        }
      } else {
        Mma<BN, TRANS_B ? 0 : 1>::run(acc, da, db, 1);
      }
    }
    wgmma_commit();
    if constexpr (BF16ACC) {
      wgmma_wait<0>();
      mbar_arrive(&empty[s]);
    } else {
      // Keep this stage's group in flight; the previous one has retired,
      // so its stage goes back to the producer.
      fence_regs<R>(acc);
      wgmma_wait<1>();
      if (kb > 0) mbar_arrive(&empty[(kb - 1) % S]);
    }
  }
  wgmma_wait<0>();
  fence_regs<R>(acc);

  // The epilogue.  Every load has landed and, past this barrier, every
  // consumer's wgmmas have retired, so the ring is idle: the accumulator
  // tile is staged there (f32, rows padded by 8 words, which makes the
  // float2 writes below free of bank conflicts) and then walked by all
  // consumer threads four columns at a time, so the caller's Store runs
  // from one copy of its code and writes full, aligned vectors.
  consumer_sync<C::CONSUMERS * 128>();
  constexpr int LDT = BN + 8;
  static_assert(BM * LDT * 4 <= S * C::STAGE_BYTES, "no room to stage");
  float* tile = reinterpret_cast<float*>(ring);
  {
    // Accumulator layout of m64nNk16: warp w of the warpgroup holds rows
    // 16w + lane/4 (+8); register 4j + 2h + c is column 8j + 2(lane%4) + c
    // of row half h.
    const int lane = threadIdx.x & 31, warp = (threadIdx.x & 127) >> 5;
    float* row = tile + (g * 64 + warp * 16 + (lane >> 2)) * LDT +
                 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float2*>(row + 8 * h * LDT + 8 * j) =
            make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
  }
  consumer_sync<C::CONSUMERS * 128>();
  constexpr int V = BN / 4;
#pragma unroll 1
  for (int i = threadIdx.x; i < BM * V; i += C::CONSUMERS * 128) {
    const int r = i / V, c = (i % V) * 4;
    store(m0 + r, n0 + c,
          *reinterpret_cast<const float4*>(tile + r * LDT + c));
  }
}

template <int BM, int BN, bool TRANS_B, bool BF16ACC, class Store>
__global__ void __launch_bounds__(Cfg<BM, BN>::THREADS, 1)
    gemm_kernel(const __grid_constant__ CUtensorMap tma,
                const __grid_constant__ CUtensorMap tmb, int K, int rbk,
                Store store) {
  gemm_tile<BM, BN, TRANS_B, BF16ACC>(&tma, &tmb, K, rbk, store,
                                      blockIdx.x * BM, blockIdx.y * BN, -1,
                                      -1);
}

// ---- host side -------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// Error codes past every cudaError_t: 1000 + the CUresult of a failed
// cuTensorMapEncodeTiled, 2000 when the entry point cannot be found.
constexpr int ENCODE_ERROR = 1000, ENTRY_ERROR = 2000;

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                     cudaEnableDefault, &q);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                            &q);
#endif
    if (q == cudaDriverEntryPointSuccess && p != nullptr)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 2-D bf16 tensor map over a row-major (outer, inner) matrix with row
// stride `ld` elements, box (box_outer, box_inner), 128-byte swizzle,
// zero fill outside the matrix.
inline int make_map(CUtensorMap* map, const void* ptr, long inner,
                    long outer, long ld, int box_inner, int box_outer) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return ENTRY_ERROR;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(inner),
                              static_cast<cuuint64_t>(outer)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(ld) * 2};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_inner),
                             static_cast<cuuint32_t>(box_outer)};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                        const_cast<void*>(ptr), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ENCODE_ERROR + static_cast<int>(r);
}

// A 3-D bf16 tensor map over `batch` row-major (outer, inner) matrices,
// row stride `ld` elements and matrix stride `batch_ld` (0: `inner` and
// `outer * inner`, the matrices packed), box (1, box_outer, box_inner),
// 128-byte swizzle, zero fill outside.
inline int make_map_3d(CUtensorMap* map, const void* ptr, long inner,
                       long outer, long batch, int box_inner,
                       int box_outer, long ld = 0, long batch_ld = 0) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return ENTRY_ERROR;
  if (ld == 0) ld = inner;
  if (batch_ld == 0) batch_ld = ld * outer;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(inner),
                              static_cast<cuuint64_t>(outer),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(ld) * 2,
                                 static_cast<cuuint64_t>(batch_ld) * 2};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(box_inner),
                             static_cast<cuuint32_t>(box_outer), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                        const_cast<void*>(ptr), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ENCODE_ERROR + static_cast<int>(r);
}

// Launch the mainloop over A (M, K) and B ((K, N), or (N, K) when
// TRANS_B), both bf16 with row strides lda and ldb; returns the launch's
// cudaError_t (or one of the codes above).
template <int BM, int BN, bool TRANS_B, bool BF16ACC, class Store>
int launch(const void* a, const void* b, int M, int N, int K, long lda,
           long ldb, int rbk, const Store& store, cudaStream_t st) {
  using C = Cfg<BM, BN>;
  if (rbk <= 0 || rbk % 32 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap ta, tb;
  int e = make_map(&ta, a, K, M, lda, WK, BM);
  if (e == 0)
    e = TRANS_B ? make_map(&tb, b, K, N, ldb, WK, BN)
                : make_map(&tb, b, N, K, ldb, 64, WK);
  if (e != 0) return e;
  auto kernel = gemm_kernel<BM, BN, TRANS_B, BF16ACC, Store>;
  static bool sized = false;
  if (!sized) {
    const cudaError_t ce = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    if (ce != cudaSuccess) return static_cast<int>(ce);
    sized = true;
  }
  const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN);
  kernel<<<grid, C::THREADS, C::SMEM, st>>>(ta, tb, K, rbk, store);
  return static_cast<int>(cudaGetLastError());
}

// Launch KERNEL on `grid` blocks of `threads` in thread-block clusters of
// `cluster` blocks along x, with `smem` bytes of dynamic shared memory
// (the kernel's limit is raised to SMEM_LIMIT at its first launch);
// returns the launch's cudaError_t.  Serves the cluster kernels of B2, B3
// (splitk_cluster.cuh) and B4 (flash_decode_paged_mma.cu).
template <auto KERNEL, class... Args>
int launch_cluster(dim3 grid, int threads, int cluster, int smem,
                   cudaStream_t stream, Args... args) {
  static bool sized = false;
  if (!sized) {
    const cudaError_t ce = cudaFuncSetAttribute(
        KERNEL, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);
    if (ce != cudaSuccess) return static_cast<int>(ce);
    sized = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t le = cudaLaunchKernelEx(&cfg, KERNEL, args...);
  if (le != cudaSuccess) return static_cast<int>(le);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace wg
