// The GEMM block tile shared by mte_gemm.cu (B1) and splitk_gemm.cu (B2).
//
// One thread block of 128 threads computes a BM x BN tile of A @ B over the
// K range [k_begin, k_end), 32 deep at a time through shared memory, and
// leaves the accumulator tile staged in shared memory (`stage`, f32 or
// int32 words) for the caller's epilogue.
//
// - Operands: A (M, K) row-major; B (K, N) row-major, or (N, K) row-major
//   when TRANS_B (the Formula-3 layout), transposed while it is loaded so
//   the shared B tile is always [BK][BN].
// - Bounds: every element outside M, N or [k_begin, k_end) is loaded as 0
//   for BOTH operands (0 * NaN would be NaN), so ragged M/N/K and the
//   K slices of split-K need no separate masking.
// - Engines: bf16 operands go through the tensor cores (wmma 16x16x16,
//   f32 accumulate); f32 operands run SIMT FMAs in full f32 (no TF32);
//   int8 operands run SIMT integer multiply-adds into int32.
// - bf16acc (BF16ACC): Hopper has no bf16 accumulator, so the running sum
//   is kept in f32 registers holding bf16-representable values: each
//   `rbk`-deep K block's f32 partial is rounded to bf16, added, and the sum
//   rounded to bf16 again -- the arithmetic of a bf16 accumulator tile that
//   is `+=`-ed once per K block.
#pragma once

#include <mma.h>

#include "common.cuh"

namespace gemm {

constexpr int THREADS = 128;
constexpr int BK = 32;

template <typename T>
struct Zero {
  __device__ static T v() { return T(0); }
};
template <>
struct Zero<__nv_bfloat16> {
  __device__ static __nv_bfloat16 v() { return __float2bfloat16_rn(0.0f); }
};

template <typename T>
struct Vec {
  static constexpr int N = 16 / sizeof(T);  // elements per 16-byte load
};

// Shared-memory tiles for one block.  Rows are padded by one 16-byte
// vector: keeps vector stores aligned and spreads banks.
template <typename T, int BM, int BN>
struct Smem {
  static constexpr int LDA = BK + Vec<T>::N;
  static constexpr int LDB = BN + Vec<T>::N;
  static constexpr int LDS = BN + 4;
  __align__(128) T a[BM * LDA];
  __align__(128) T b[BK * LDB];
  __align__(128) float stage[BM * LDS];  // f32 or int32 words
};

// Load a ROWS x COLS tile of a row-major matrix (leading dim ld) starting
// at (r0, c0) into dst (leading dim ldd); elements at or past (r_lim,
// c_lim) are zero.  Full, aligned 16-byte chunks load as one vector.
template <typename T, int ROWS, int COLS>
__device__ __forceinline__ void load_tile(T* dst, int ldd, const T* src,
                                          long ld, int r0, int c0,
                                          int r_lim, int c_lim) {
  constexpr int V = Vec<T>::N;
  constexpr int CHUNKS = ROWS * COLS / V;
  for (int ch = threadIdx.x; ch < CHUNKS; ch += THREADS) {
    const int r = ch / (COLS / V);
    const int c = (ch % (COLS / V)) * V;
    const int gr = r0 + r, gc = c0 + c;
    T* d = dst + r * ldd + c;
    const T* s = src + gr * ld + gc;
    if (gr < r_lim && gc + V <= c_lim &&
        (reinterpret_cast<uintptr_t>(s) & 15) == 0) {
      *reinterpret_cast<uint4*>(d) = *reinterpret_cast<const uint4*>(s);
    } else {
#pragma unroll
      for (int v = 0; v < V; ++v)
        d[v] = (gr < r_lim && gc + v < c_lim) ? s[v] : Zero<T>::v();
    }
  }
}

// Load B^T: B is (N, K) row-major; the tile [BK][BN] takes rows n0.. and
// columns k0.. of it, transposed.  Used only for the Formula-3 layout.
template <typename T, int BN>
__device__ __forceinline__ void load_tile_t(T* dst, int ldd, const T* src,
                                            long ld, int k0, int n0,
                                            int k_lim, int n_lim) {
  for (int e = threadIdx.x; e < BK * BN; e += THREADS) {
    const int n = e / BK, kk = e % BK;
    const int gn = n0 + n, gk = k0 + kk;
    dst[kk * ldd + n] = (gn < n_lim && gk < k_lim) ? src[gn * ld + gk]
                                                   : Zero<T>::v();
  }
}

template <typename T, int BM, int BN, bool TRANS_B>
__device__ __forceinline__ void load_stage(Smem<T, BM, BN>& sm, const T* A,
                                           long lda, const T* B, long ldb,
                                           int M, int N, int m0, int n0,
                                           int k0, int k_end) {
  load_tile<T, BM, BK>(sm.a, Smem<T, BM, BN>::LDA, A, lda, m0, k0, M, k_end);
  if (TRANS_B)
    load_tile_t<T, BN>(sm.b, Smem<T, BM, BN>::LDB, B, ldb, k0, n0, k_end, N);
  else
    load_tile<T, BK, BN>(sm.b, Smem<T, BM, BN>::LDB, B, ldb, k0, n0, k_end,
                         N);
}

// ---- SIMT engine (f32 x f32 -> f32, int8 x int8 -> int32) ---------------
template <typename T, typename Acc, int BM, int BN, bool TRANS_B>
__device__ void tile_simt(Smem<T, BM, BN>& sm, const T* A, long lda,
                          const T* B, long ldb, int M, int N, int m0, int n0,
                          int k_begin, int k_end) {
  constexpr int PER = BM * BN / THREADS;
  Acc acc[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) acc[i] = Acc(0);
  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    load_stage<T, BM, BN, TRANS_B>(sm, A, lda, B, ldb, M, N, m0, n0, k0,
                                   k_end);
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        const int e = threadIdx.x + i * THREADS;
        const int r = e / BN, c = e % BN;
        acc[i] += Acc(sm.a[r * Smem<T, BM, BN>::LDA + kk]) *
                  Acc(sm.b[kk * Smem<T, BM, BN>::LDB + c]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int e = threadIdx.x + i * THREADS;
    const int r = e / BN, c = e % BN;
    reinterpret_cast<Acc*>(sm.stage)[r * Smem<T, BM, BN>::LDS + c] = acc[i];
  }
  __syncthreads();
}

// ---- tensor-core engine (bf16 x bf16 -> f32, optionally bf16acc) ---------
template <int BM, int BN, bool TRANS_B, bool BF16ACC>
__device__ void tile_wmma(Smem<__nv_bfloat16, BM, BN>& sm,
                          const __nv_bfloat16* A, long lda,
                          const __nv_bfloat16* B, long ldb, int M, int N,
                          int m0, int n0, int k_begin, int k_end, int rbk) {
  using namespace nvcuda;
  using S = Smem<__nv_bfloat16, BM, BN>;
  constexpr int WARPS_M = BM >= 32 ? BM / 32 : 1;
  constexpr int WARPS_N = (THREADS / 32) / WARPS_M;
  constexpr int WM = BM / WARPS_M, WN = BN / WARPS_N;
  constexpr int FM = WM / 16, FN = WN / 16;
  const int warp = threadIdx.x / 32;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[FM][FN];
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> part[FM][FN];
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) {
      wmma::fill_fragment(acc[i][j], 0.0f);
      if (BF16ACC) wmma::fill_fragment(part[i][j], 0.0f);
    }

  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    load_stage<__nv_bfloat16, BM, BN, TRANS_B>(sm, A, lda, B, ldb, M, N, m0,
                                               n0, k0, k_end);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> fa[FM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> fb[FN];
#pragma unroll
      for (int i = 0; i < FM; ++i)
        wmma::load_matrix_sync(fa[i], sm.a + (wm * WM + i * 16) * S::LDA + kk,
                               S::LDA);
#pragma unroll
      for (int j = 0; j < FN; ++j)
        wmma::load_matrix_sync(fb[j], sm.b + kk * S::LDB + wn * WN + j * 16,
                               S::LDB);
#pragma unroll
      for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int j = 0; j < FN; ++j) {
          if (BF16ACC)
            wmma::mma_sync(part[i][j], fa[i], fb[j], part[i][j]);
          else
            wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
        }
    }
    __syncthreads();
    if (BF16ACC && ((k0 + BK) % rbk == 0 || k0 + BK >= k_end)) {
#pragma unroll
      for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int j = 0; j < FN; ++j) {
#pragma unroll
          for (int t = 0; t < acc[i][j].num_elements; ++t)
            acc[i][j].x[t] =
                bf16_round(acc[i][j].x[t] + bf16_round(part[i][j].x[t]));
          wmma::fill_fragment(part[i][j], 0.0f);
        }
    }
  }
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j)
      wmma::store_matrix_sync(
          sm.stage + (wm * WM + i * 16) * S::LDS + wn * WN + j * 16,
          acc[i][j], S::LDS, wmma::mem_row_major);
  __syncthreads();
}

}  // namespace gemm

// Dispatch a templated launcher over the runtime (type, tile, layout,
// accumulator) choice.  LAUNCH(T, ACC, BM, BN, TRANS, ENGINE, BF16ACC) must
// be a macro in the including file that launches the kernel and returns.
// Returns cudaErrorInvalidValue for a combination no kernel covers.
#define GEMM_DISPATCH(in_type, bm, bn, trans_b, bf16acc, LAUNCH)             \
  do {                                                                      \
    const bool skinny = (bm) == 16 && (bn) == 128;                          \
    const bool large = (bm) == 64 && (bn) == 64;                            \
    if (!skinny && !large) return (int)cudaErrorInvalidValue;               \
    if ((in_type) == DT_BF16) {                                             \
      if (skinny) {                                                         \
        if (trans_b) {                                                      \
          if (bf16acc) LAUNCH(__nv_bfloat16, float, 16, 128, true, 1, true); \
          LAUNCH(__nv_bfloat16, float, 16, 128, true, 1, false);            \
        }                                                                   \
        if (bf16acc) LAUNCH(__nv_bfloat16, float, 16, 128, false, 1, true);  \
        LAUNCH(__nv_bfloat16, float, 16, 128, false, 1, false);             \
      }                                                                     \
      if (trans_b) {                                                        \
        if (bf16acc) LAUNCH(__nv_bfloat16, float, 64, 64, true, 1, true);    \
        LAUNCH(__nv_bfloat16, float, 64, 64, true, 1, false);               \
      }                                                                     \
      if (bf16acc) LAUNCH(__nv_bfloat16, float, 64, 64, false, 1, true);     \
      LAUNCH(__nv_bfloat16, float, 64, 64, false, 1, false);                \
    }                                                                       \
    if ((bf16acc)) return (int)cudaErrorInvalidValue;                       \
    if ((in_type) == DT_F32) {                                              \
      if (skinny) {                                                         \
        if (trans_b) LAUNCH(float, float, 16, 128, true, 0, false);         \
        LAUNCH(float, float, 16, 128, false, 0, false);                     \
      }                                                                     \
      if (trans_b) LAUNCH(float, float, 64, 64, true, 0, false);            \
      LAUNCH(float, float, 64, 64, false, 0, false);                        \
    }                                                                       \
    if ((in_type) == DT_I8) {                                               \
      if (skinny) {                                                         \
        if (trans_b) LAUNCH(int8_t, int32_t, 16, 128, true, 0, false);      \
        LAUNCH(int8_t, int32_t, 16, 128, false, 0, false);                  \
      }                                                                     \
      if (trans_b) LAUNCH(int8_t, int32_t, 64, 64, true, 0, false);         \
      LAUNCH(int8_t, int32_t, 64, 64, false, 0, false);                     \
    }                                                                       \
    return (int)cudaErrorInvalidValue;                                      \
  } while (0)
