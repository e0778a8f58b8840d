// The f32 GEMM mainloop built for Hopper's FP32 lanes, shared by
// mte_gemm.cu (B1, counter "mte_gemm_simt") and splitk_gemm.cu (B2,
// counter "splitk_gemm_simt").
//
// Serves: src/repro/kernels/mte_gemm.py:114 / :161 (mte_gemm_pallas) and
// src/repro/kernels/splitk_gemm.py:60 / :91 (mte_gemm_splitk_pallas) on
// f32 operands -- on the port's main path, every GEMM of the training
// backward (the parameters are f32, so the promoted operands are too).
//
// What bounds it: f32 FMAs at 67 TFLOP/s (no TF32: the reference's f32
// backward rounds no operand).  A 4096-token training step's backward
// GEMMs do 2-275 GFLOP each at 512-4096 FLOP per byte of device memory,
// far above the f32 ridge (20 FLOP/B), so the FMA lanes are the bound.
// gemm_tile.cuh's tile_simt is held to an eighth of them by shared memory:
// each of its threads reads one word of A and one of B for every FMA,
// and shared memory delivers 32 words a clock per SM against 128 FMA
// lanes.  The design moves the limit back to the lanes:
//
// - Block tile BM x BN = 128 x 128 (or 128 x 64 where the wide grid
//   underfills the SMs), 256 threads as a 16 x 16 grid.  Each thread
//   holds an (BM/16) x (BN/16) micro-tile of accumulators in registers,
//   as 4 x 4 sub-tiles 64 rows and 64 columns apart, so that per k step
//   it reads its A and B values as conflict-free 16-byte vectors (a warp
//   covers 4 x 8 threads: 4 distinct A vectors and 8 contiguous B
//   vectors): 16 words for 64 FMAs at 128 x 128.
// - Shared memory holds both operands K-outer, [BK][BM + 4] and
//   [BK][BN + 4], in a ring of STAGES stages of BK = 16 rows.
//   An operand contiguous along M or N (B (K, N) row-major: the
//   recompute and dB) arrives by 16-byte cp.async straight into the
//   ring, STAGES - 1 stages ahead.  An operand contiguous along K (A
//   always; B (N, K) row-major in dA, read in place) is loaded as 16-byte
//   vectors into registers one stage ahead and stored transposed after
//   the stage's FMAs.  One barrier per stage.
// - Order of the sum: each output is one FMA chain over k from k_begin
//   upward, starting at zero -- tile_simt's order, so an unsplit GEMM is
//   bit-equal to the tile loop's (K past the end loads zeros, whose
//   FMAs add +0).
// - Blocks walk the output tiles in groups of GROUP_M tile rows, so the
//   blocks in flight share A's row panels and B's column panels in L2.
// - The epilogue (epilogue.cuh's apply_epi) runs from registers and
//   writes each output once, four columns to a 16-byte vector where N,
//   the output's stride and its address allow.  The identity epilogue
//   into f32 (every backward GEMM, B2's partials) stores the
//   accumulators as they are, which is apply_epi's result at alpha 1.
//
// Requirements (core/geometry.py's engine rule, the launchers check
// them): f32 operands, K and N multiples of 4, 16-byte aligned operand
// bases and row strides, K slices starting at multiples of 4.
#pragma once

#include "common.cuh"
#include "epilogue.cuh"

// Internal linkage: B1's and B2's libraries each hold their own kernels
// and their own `sized` flag (a function-local static of a template with
// external linkage is one symbol across every library the process loads,
// so the second library's kernel would never get its shared-memory limit).
namespace simt {
namespace {

constexpr int THREADS = 256;
constexpr int BK = 16;        // K rows of one stage
constexpr int STAGES = 4;     // depth of the shared-memory ring
constexpr int PAD = 4;        // floats past each K-outer row
constexpr int GROUP_M = 8;    // tile rows a group of blocks walks together

// Blocks an SM should hold: two (128 registers a thread) when B arrives by
// cp.async; one when both operands pass through registers (B (N, K)),
// where the compiler's longer schedule beat a second block on an H100.
constexpr int min_blocks(bool trans_b) { return trans_b ? 1 : 2; }

template <int BM, int BN>
struct Tile {
  static_assert(BM == 128 && (BN == 128 || BN == 64), "compiled tiles");
  static constexpr int RM = BM / 64;   // 4-row sub-tiles of a thread
  static constexpr int RN = BN / 64;   // 4-column sub-tiles of a thread
  static constexpr int LDA = BM + PAD;
  static constexpr int LDB = BN + PAD;
  static constexpr int A_STAGE = BK * LDA;   // floats
  static constexpr int B_STAGE = BK * LDB;
  static constexpr int SMEM_BYTES =
      STAGES * (A_STAGE + B_STAGE) * static_cast<int>(sizeof(float));
};

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  const unsigned s =
      static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int bytes = valid ? 16 : 0;   // 0: fill the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// An operand contiguous along K: rows [r0, r0 + R) of X (row stride ld),
// K columns [k0, k0 + BK), loaded as 16-byte vectors (four lanes cover a
// row's 64 bytes) into registers, then stored transposed into a
// [BK][R + PAD] stage.  Rows at or past r_lim and K at or past k_end load
// zeros.
template <int R>
struct KMajor {
  static constexpr int PER = R * BK / 4 / THREADS;
  static_assert(PER * THREADS * 4 == R * BK, "whole vectors per thread");
  float4 v[PER];

  __device__ __forceinline__ void load(const float* X, long ld, int r0,
                                       int r_lim, int k0, int k_end) {
#pragma unroll
    for (int p = 0; p < PER; ++p) {
      const int c = threadIdx.x + p * THREADS;
      const int kq = c % (BK / 4), r = c / (BK / 4);
      const int gr = r0 + r, gk = k0 + kq * 4;
      v[p] = (gr < r_lim && gk < k_end)
                 ? __ldg(reinterpret_cast<const float4*>(
                       X + static_cast<long>(gr) * ld + gk))
                 : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }

  __device__ __forceinline__ void store(float* s) const {
#pragma unroll
    for (int p = 0; p < PER; ++p) {
      const int c = threadIdx.x + p * THREADS;
      const int kq = c % (BK / 4), r = c / (BK / 4);
      float* d = s + kq * 4 * (R + PAD) + r;
      d[0] = v[p].x;
      d[R + PAD] = v[p].y;
      d[2 * (R + PAD)] = v[p].z;
      d[3 * (R + PAD)] = v[p].w;
    }
  }
};

// An operand contiguous along N: K rows [k0, k0 + BK) and columns
// [n0, n0 + C) of B (row stride ldb) by cp.async into a [BK][C + PAD]
// stage; K at or past k_end and columns at or past N fill zeros.
template <int C>
__device__ __forceinline__ void load_nmajor(float* s, const float* B,
                                            long ldb, int k0, int k_end,
                                            int n0, int N) {
  constexpr int VPR = C / 4;
  constexpr int PER = BK * VPR / THREADS;
  static_assert(PER * THREADS == BK * VPR, "whole vectors per thread");
#pragma unroll
  for (int p = 0; p < PER; ++p) {
    const int c = threadIdx.x + p * THREADS;
    const int kr = c / VPR, col = (c % VPR) * 4;
    const int gk = k0 + kr, gn = n0 + col;
    const bool valid = gk < k_end && gn < N;
    cp_async16(s + kr * (C + PAD) + col,
               valid ? B + static_cast<long>(gk) * ldb + gn : B, valid);
  }
}

// The thread's place in the 16 x 16 grid: a warp covers 4 rows of 8.
__device__ __forceinline__ int thread_row() {
  return (threadIdx.x / 64) * 4 + (threadIdx.x % 32) / 8;
}
__device__ __forceinline__ int thread_col() {
  return ((threadIdx.x / 32) % 2) * 8 + threadIdx.x % 8;
}

// The FMAs of one stage: for each of its BK rows, the thread's A and B
// vectors, then one FMA per accumulator.
template <int BM, int BN>
__device__ __forceinline__ void compute_stage(
    const float* sA, const float* sB,
    float (&acc)[Tile<BM, BN>::RM * 4][Tile<BM, BN>::RN * 4], int ty,
    int tx) {
  using T = Tile<BM, BN>;
#pragma unroll
  for (int kk = 0; kk < BK; ++kk) {
    float a[T::RM * 4], b[T::RN * 4];
#pragma unroll
    for (int i = 0; i < T::RM; ++i) {
      const float4 v = *reinterpret_cast<const float4*>(
          sA + kk * T::LDA + i * 64 + ty * 4);
      a[i * 4] = v.x, a[i * 4 + 1] = v.y, a[i * 4 + 2] = v.z,
      a[i * 4 + 3] = v.w;
    }
#pragma unroll
    for (int j = 0; j < T::RN; ++j) {
      const float4 v = *reinterpret_cast<const float4*>(
          sB + kk * T::LDB + j * 64 + tx * 4);
      b[j * 4] = v.x, b[j * 4 + 1] = v.y, b[j * 4 + 2] = v.z,
      b[j * 4 + 3] = v.w;
    }
#pragma unroll
    for (int r = 0; r < T::RM * 4; ++r)
#pragma unroll
      for (int c = 0; c < T::RN * 4; ++c)
        acc[r][c] = fmaf(a[r], b[c], acc[r][c]);
  }
}

// The mainloop over the K range [k_begin, k_end) of the tile at (m0, n0):
// A (M, K) row-major; B (K, N) row-major, or (N, K) row-major when
// TRANS_B.  `smem` holds the ring (Tile::SMEM_BYTES).
template <int BM, int BN, bool TRANS_B>
__device__ __forceinline__ void mainloop(
    float* smem, const float* A, long lda, const float* B, long ldb, int M,
    int N, int m0, int n0, int k_begin, int k_end,
    float (&acc)[Tile<BM, BN>::RM * 4][Tile<BM, BN>::RN * 4]) {
  using T = Tile<BM, BN>;
  float* sA = smem;
  float* sB = smem + STAGES * T::A_STAGE;
  const int ty = thread_row(), tx = thread_col();
  const int nk = (k_end - k_begin + BK - 1) / BK;
  KMajor<BM> ra;
  KMajor<BN> rb;   // used when TRANS_B

  // Prologue: the direct operand's first STAGES - 1 stages in flight (one
  // commit group per stage, empty or not, so the wait below counts
  // stages), the K-major operands' first stage stored.
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (!TRANS_B && s < nk)
      load_nmajor<BN>(sB + s * T::B_STAGE, B, ldb, k_begin + s * BK, k_end,
                      n0, N);
    cp_async_commit();
  }
  if (nk > 0) {
    ra.load(A, lda, m0, M, k_begin, k_end);
    if (TRANS_B) rb.load(B, ldb, n0, N, k_begin, k_end);
    ra.store(sA);
    if (TRANS_B) rb.store(sB);
  }

  for (int t = 0; t < nk; ++t) {
    cp_async_wait<STAGES - 2>();   // this thread's copies of stage t
    __syncthreads();               // everyone's stage t; stage t-1 done
    const int fill = t + STAGES - 1;
    if (!TRANS_B && fill < nk)
      load_nmajor<BN>(sB + (fill % STAGES) * T::B_STAGE, B, ldb,
                      k_begin + fill * BK, k_end, n0, N);
    cp_async_commit();
    const bool next = t + 1 < nk;
    if (next) {
      const int k1 = k_begin + (t + 1) * BK;
      ra.load(A, lda, m0, M, k1, k_end);
      if (TRANS_B) rb.load(B, ldb, n0, N, k1, k_end);
    }
    const int slot = t % STAGES;
    compute_stage<BM, BN>(sA + slot * T::A_STAGE, sB + slot * T::B_STAGE,
                          acc, ty, tx);
    if (next) {
      // Slot t+1 last held stage t+1-STAGES, which every thread finished
      // before this iteration's barrier.
      const int nslot = (t + 1) % STAGES;
      ra.store(sA + nslot * T::A_STAGE);
      if (TRANS_B) rb.store(sB + nslot * T::B_STAGE);
    }
  }
  cp_async_wait<0>();
}

// The epilogue of four outputs (r, c .. c + 3) and their one write; kept
// out of line so that the unrolled walk over the accumulators stays small.
__device__ __noinline__ void store4(const Epi& epi, int r, int c, int N,
                                    bool vec, float v0, float v1, float v2,
                                    float v3) {
  float x[4] = {v0, v1, v2, v3};
  const long o = static_cast<long>(r) * epi.ldo + c;
  if (vec && epi.out_type != DT_I32) {
#pragma unroll
    for (int e = 0; e < 4; ++e) x[e] = apply_epi<false>(x[e], r, c + e, epi);
    if (epi.out_type == DT_BF16) {
      const __nv_bfloat162 pair[2] = {__floats2bfloat162_rn(x[0], x[1]),
                                      __floats2bfloat162_rn(x[2], x[3])};
      *reinterpret_cast<uint2*>(static_cast<__nv_bfloat16*>(epi.out) + o) =
          *reinterpret_cast<const uint2*>(pair);
    } else {
      *reinterpret_cast<float4*>(static_cast<float*>(epi.out) + o) =
          make_float4(x[0], x[1], x[2], x[3]);
    }
    return;
  }
  for (int e = 0; e < 4 && c + e < N; ++e)
    store_from_f32(epi.out, o + e, epi.out_type,
                   apply_epi<false>(x[e], r, c + e, epi));
}

template <int BM, int BN, bool TRANS_B>
__global__ void __launch_bounds__(THREADS, min_blocks(TRANS_B))
    gemm_kernel(const float* A, long lda, const float* B, long ldb, int M,
                int N, int K, int k_per_split, Epi epi, long split_stride,
                int vec, int identity) {
  using T = Tile<BM, BN>;
  extern __shared__ float4 smem4[];
  // Tile order: groups of GROUP_M tile rows, column-major inside a group.
  const int tiles_m = (M + BM - 1) / BM, tiles_n = (N + BN - 1) / BN;
  const int per_group = GROUP_M * tiles_n;
  const int group = blockIdx.x / per_group;
  const int first = group * GROUP_M;
  const int rows = min(tiles_m - first, GROUP_M);
  const int in_group = blockIdx.x % per_group;
  const int m0 = (first + in_group % rows) * BM;
  const int n0 = (in_group / rows) * BN;
  const int k_begin = min(static_cast<int>(blockIdx.z) * k_per_split, K);
  const int k_end = min(k_begin + k_per_split, K);

  float acc[T::RM * 4][T::RN * 4];
#pragma unroll
  for (int r = 0; r < T::RM * 4; ++r)
#pragma unroll
    for (int c = 0; c < T::RN * 4; ++c) acc[r][c] = 0.0f;
  mainloop<BM, BN, TRANS_B>(reinterpret_cast<float*>(smem4), A, lda, B, ldb,
                            M, N, m0, n0, k_begin, k_end, acc);

  if (split_stride)   // B2: slice z's f32 partial
    epi.out = static_cast<float*>(epi.out) + blockIdx.z * split_stride;
  const int ty = thread_row(), tx = thread_col();
#pragma unroll
  for (int i = 0; i < T::RM; ++i)
#pragma unroll
    for (int ii = 0; ii < 4; ++ii) {
      const int r = m0 + i * 64 + ty * 4 + ii;
      if (r >= M) continue;
#pragma unroll
      for (int j = 0; j < T::RN; ++j) {
        const int c = n0 + j * 64 + tx * 4;
        if (c >= N) continue;
        const float* v = &acc[i * 4 + ii][j * 4];
        if (identity && vec) {
          *reinterpret_cast<float4*>(static_cast<float*>(epi.out) +
                                     static_cast<long>(r) * epi.ldo + c) =
              make_float4(v[0], v[1], v[2], v[3]);
        } else {
          store4(epi, r, c, N, vec, v[0], v[1], v[2], v[3]);
        }
      }
    }
}

// Launch one GEMM (n_split = 1, split_stride = 0) or the n_split K slices
// of k_per_split rows, slice z writing its f32 partial at out + z *
// split_stride.  Returns the launch's cudaError_t; cudaErrorInvalidValue
// for operands the engine does not take.
template <int BM, int BN, bool TRANS_B>
int launch(const float* A, long lda, const float* B, long ldb, int M, int N,
           int K, int n_split, int k_per_split, const Epi& epi,
           long split_stride, cudaStream_t st) {
  using T = Tile<BM, BN>;
  const auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  if (M <= 0 || N <= 0 || K <= 0 || n_split <= 0 || k_per_split <= 0 ||
      K % 4 != 0 || N % 4 != 0 || k_per_split % 4 != 0 || lda % 4 != 0 ||
      ldb % 4 != 0 || !aligned(A) || !aligned(B))
    return static_cast<int>(cudaErrorInvalidValue);
  static bool sized = false;
  if (!sized) {
    const cudaError_t ce = cudaFuncSetAttribute(
        gemm_kernel<BM, BN, TRANS_B>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM_BYTES);
    if (ce != cudaSuccess) return static_cast<int>(ce);
    sized = true;
  }
  const int out_bytes = epi.out_type == DT_BF16 ? 2 : 4;
  const int vec = epi.ldo % 4 == 0 &&
                  reinterpret_cast<uintptr_t>(epi.out) % (4 * out_bytes) == 0;
  const int identity = epi.alpha == 1.0f && epi.beta == 0.0f &&
                       epi.bias == nullptr && !epi.has_softcap &&
                       epi.act == 0 && epi.out_type == DT_F32;
  const dim3 grid(((M + BM - 1) / BM) * ((N + BN - 1) / BN), 1, n_split);
  gemm_kernel<BM, BN, TRANS_B><<<grid, THREADS, T::SMEM_BYTES, st>>>(
      A, lda, B, ldb, M, N, K, k_per_split, epi, split_stride, vec,
      identity);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace simt
