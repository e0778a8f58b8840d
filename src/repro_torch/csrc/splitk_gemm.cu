// B2: split-K GEMM partials for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/splitk_gemm.py, mte_gemm_splitk_pallas /
// _kernel (K cut into n_split slices on the TPU grid, each slice's partial
// accumulator written to an (n_split, M, N) buffer; the sum over slices and
// the epilogue run outside the kernel).
//
// What bounds it on the H100: the decode projections it serves (M = the
// 4 serving slots, K 2048 or 16384, N 256..16384, bf16) read every weight
// byte once for ~4 FLOP per byte -- pure HBM bandwidth.  With 16x128 tiles
// their (M, N) grid is at most 128 blocks, fewer than the 132 SMs, so one
// block per tile would leave SMs idle and each busy SM cannot pull its
// share of 3.35 TB/s alone.  The design: a third grid axis over K slices
// (grid = tiles x n_split) puts enough blocks in flight to keep every SM
// streaming weights; each block runs the same tile loop as B1
// (gemm_tile.cuh) over its slice and writes its raw partial in the
// accumulator dtype (f32, int32 for int8, bf16 for bf16acc).  No atomics:
// the reduction over slices is a separate deterministic pass in the
// wrapper, so a run always gives the same bits.  K slices past the true K
// load nothing and write zeros.
//
// f32 operands with more than 16 rows, K and N multiples of 4 and a tile
// of 128 x 128 or 128 x 64 (core/geometry.py:splitk_engine's "simt") run
// the slices on simt_f32_mainloop.cuh instead (splitk_gemm_simt_launch,
// counter "splitk_gemm_simt"): the training backward's dB of a narrow
// weight (gemma_2b's k/v, 2048 x 256 x 4096), whose output tiles alone
// would leave most of the 132 SMs idle.  Bounded by f32 FMAs at 67
// TFLOP/s; each slice is the same FMA chain over its K rows as the tile
// loop's, written as an f32 partial, and the sum over slices stays the
// wrapper's deterministic pass.
#include "gemm_tile.cuh"
#include "simt_f32_mainloop.cuh"

namespace {

template <typename T, typename Acc, int BM, int BN, bool TRANS, int ENGINE,
          bool BF16ACC>
__global__ void __launch_bounds__(gemm::THREADS)
    splitk_gemm_kernel(const T* A, long lda, const T* B, long ldb, int M,
                       int N, int K, int k_per_split, int rbk, void* partials,
                       int part_type) {
  __shared__ gemm::Smem<T, BM, BN> sm;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int s = blockIdx.z;
  const int k_begin = min(s * k_per_split, K);
  const int k_end = min(k_begin + k_per_split, K);
  if constexpr (ENGINE == 1)
    gemm::tile_wmma<BM, BN, TRANS, BF16ACC>(sm, A, lda, B, ldb, M, N, m0, n0,
                                            k_begin, k_end, rbk);
  else
    gemm::tile_simt<T, Acc, BM, BN, TRANS>(sm, A, lda, B, ldb, M, N, m0, n0,
                                           k_begin, k_end);
  constexpr int LDS = gemm::Smem<T, BM, BN>::LDS;
  const long base = static_cast<long>(s) * M * N;
  for (int e = threadIdx.x; e < BM * BN; e += gemm::THREADS) {
    const int r = e / BN, c = e % BN;
    const long gr = m0 + r, gc = n0 + c;
    if (gr >= M || gc >= N) continue;
    const long o = base + gr * N + gc;
    if (part_type == DT_I32)
      static_cast<int32_t*>(partials)[o] =
          reinterpret_cast<const int32_t*>(sm.stage)[r * LDS + c];
    else
      store_from_f32(partials, o, part_type, sm.stage[r * LDS + c]);
  }
}

}  // namespace

extern "C" int splitk_gemm_launch(const void* a, const void* b,
                                  void* partials, int M, int N, int K,
                                  long lda, long ldb, int in_type,
                                  int part_type, int bf16acc, int bm, int bn,
                                  int rbk, int n_split, int k_per_split,
                                  void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || n_split <= 0 || rbk <= 0 ||
      rbk % gemm::BK != 0 || k_per_split % rbk != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int trans_b = 0;
#define LAUNCH(T, ACC, BM_, BN_, TR, ENG, BA)                                  \
  {                                                                           \
    dim3 grid((N + BN_ - 1) / BN_, (M + BM_ - 1) / BM_, n_split);              \
    splitk_gemm_kernel<T, ACC, BM_, BN_, TR, ENG, BA>                          \
        <<<grid, gemm::THREADS, 0, st>>>(                                     \
            static_cast<const T*>(a), lda, static_cast<const T*>(b), ldb, M,  \
            N, K, k_per_split, rbk, partials, part_type);                     \
    return (int)cudaGetLastError();                                           \
  }
  GEMM_DISPATCH(in_type, bm, bn, trans_b, bf16acc, LAUNCH);
#undef LAUNCH
}

extern "C" int splitk_gemm_simt_launch(const void* a, const void* b,
                                       void* partials, int M, int N, int K,
                                       long lda, long ldb, int bm, int bn,
                                       int n_split, int k_per_split,
                                       void* stream) {
  // The identity epilogue into f32: slice z's partial at partials + z*M*N.
  Epi epi{1.0f, 0.0f, nullptr, 0, nullptr, 0.0f, 0, 0, partials, N, DT_F32};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* A = static_cast<const float*>(a);
  const float* B = static_cast<const float*>(b);
  const long stride = static_cast<long>(M) * N;
  if (bm == 128 && bn == 128)
    return simt::launch<128, 128, false>(A, lda, B, ldb, M, N, K, n_split,
                                         k_per_split, epi, stride, st);
  if (bm == 128 && bn == 64)
    return simt::launch<128, 64, false>(A, lda, B, ldb, M, N, K, n_split,
                                        k_per_split, epi, stride, st);
  return (int)cudaErrorInvalidValue;
}
