// B1: the MTE GEMM with its fused epilogue, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/mte_gemm.py, mte_gemm_pallas / _gemm_kernel
// (the TPU kernel keeps a (bm, bn) accumulator in VMEM over a sequential
// K grid axis and applies alpha/beta*C/bias/softcap/activation on the last
// K step).
//
// What bounds it on the H100: the prefill projections it serves (M = the
// 512-token chunk, N up to 16384, K 2048 to 16384, bf16) carry ~60-250
// FLOP per byte of device memory -- near the bf16 ridge (~295 FLOP/B), so
// the tensor-core rate is the bound; inside the card, what feeds the
// tensor cores is the operand traffic from L2 into each SM's shared
// memory, which falls as the tile grows.
//
// Two engines, chosen by core/geometry.py:gemm_engine (a pure function of
// the operand type, the accumulator, the tile and the alignment of K and
// N -- never a fallback):
//
// 1. mte_gemm_wgmma_launch (counter "mte_gemm_wgmma"): bf16 operands with
//    an f32 or bf16acc accumulator, K and N multiples of 8, a tile of
//    BM in {64, 128} x BN in {64, 128, 256} (bf16acc: BN <= 128, its two
//    register sets).  The mainloop of wgmma_mainloop.cuh: TMA loads 64
//    deep in K into a ring of 3-5 shared-memory stages, one producer warp
//    and BM/64 consumer warpgroups handing stages over through mbarriers,
//    wgmma with the accumulator in registers.  The epilogue (EpiStore)
//    runs on the accumulator staged through the idle ring in shared
//    memory and writes out_dtype once, four columns per vector; the
//    accumulator never goes to device memory, as in the TPU kernel.  The
//    tile follows the shape (the plan cache prices each by tile waves on
//    the SMs and by operand traffic): that is the MTE thesis.
//    mte_gemm_wgmma_s8_launch (counter "mte_gemm_wgmma_s8"): int8
//    operands with the int32 accumulator past 16 rows, K a multiple of 16
//    and N of 8, at the same tiles.  The same mainloop with 128-deep
//    int8 stages (the same 128-byte rows) and m64nBNk32 s8 wgmmas; both
//    operands K-major, so B comes as (N, K) (the wrapper makes that copy
//    of a (K, N) B).  The int32 sums are stored exactly, as raw words,
//    and the epilogue is the identity: the dequantize and the caller's
//    epilogue run outside, in kernels/ops.py, as in the TPU kernel's
//    int8 route (src/repro/kernels/autodiff.py).  Bound at the prefill
//    projections by the int8 tensor-core rate (1979 TOPS) and by the
//    int32 output's bytes, which are 4x the bf16 output's.
// 2. mte_gemm_launch (counter "mte_gemm"): the tile loop of gemm_tile.cuh,
//    one 128-thread block per 64x64 (or 16x128 for M <= 16) tile walking K
//    32 deep with synchronous loads -- wmma for bf16, SIMT f32 for fp32
//    (no TF32), SIMT int8 -> int32.  It serves what the others cannot
//    take: M <= 16, int8 with K not a multiple of 16, fp32 off the SIMT
//    engine's tiles and alignment, and strides TMA cannot take.  Not
//    pipelined: the tensor cores wait on every stage.
//
// 3. mte_gemm_simt_launch (counter "mte_gemm_simt"): f32 operands with
//    more than 16 rows, K and N multiples of 4, a tile of 128 x 128 or
//    128 x 64, 16-byte aligned operands.  The mainloop of
//    simt_f32_mainloop.cuh: f32 FMAs (no TF32) bounded by the FP32 lanes
//    (67 TFLOP/s), not by shared memory as the tile loop is: 8 x 8
//    accumulators a thread read as 16-byte vectors from a K-outer ring,
//    B (K, N) by cp.async, A and a transposed B (N, K) through registers
//    one stage ahead, the epilogue from registers.  Each output is the
//    tile loop's FMA chain, so an unsplit GEMM is bit-equal to it.  It
//    runs the training backward (every GEMM of which is f32).
//
// Accumulators: f32 (fp32 and bf16 operands), int32 (int8 operands, whose
// dequantize and epilogue run outside the kernel, so the epilogue must be
// the identity), or bf16acc emulated in f32 registers (each rbk-deep K
// block's partial rounded to bf16 and added to a bf16-rounded sum).
// Under bf16acc every epilogue step is rounded to bf16, as a bf16
// accumulator tile's element-wise arithmetic is.
#include <type_traits>

#include "epilogue.cuh"
#include "gemm_tile.cuh"
#include "simt_f32_mainloop.cuh"
#include "wgmma_mainloop.cuh"

namespace {

template <typename T, typename Acc, int BM, int BN, bool TRANS, int ENGINE,
          bool BF16ACC>
__global__ void __launch_bounds__(gemm::THREADS)
    mte_gemm_kernel(const T* A, long lda, const T* B, long ldb, int M, int N,
                    int K, int rbk, Epi epi) {
  __shared__ gemm::Smem<T, BM, BN> sm;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  if constexpr (ENGINE == 1)
    gemm::tile_wmma<BM, BN, TRANS, BF16ACC>(sm, A, lda, B, ldb, M, N, m0, n0,
                                            0, K, rbk);
  else
    gemm::tile_simt<T, Acc, BM, BN, TRANS>(sm, A, lda, B, ldb, M, N, m0, n0,
                                           0, K);
  constexpr int LDS = gemm::Smem<T, BM, BN>::LDS;
  for (int e = threadIdx.x; e < BM * BN; e += gemm::THREADS) {
    const int r = e / BN, c = e % BN;
    const long gr = m0 + r, gc = n0 + c;
    if (gr >= M || gc >= N) continue;
    const long o = gr * epi.ldo + gc;
    if constexpr (std::is_floating_point<Acc>::value) {
      const float v = sm.stage[r * LDS + c];
      store_from_f32(epi.out, o, epi.out_type,
                     apply_epi<BF16ACC>(v, gr, gc, epi));
    } else {
      const int32_t v = reinterpret_cast<const int32_t*>(sm.stage)[r * LDS + c];
      if (epi.out_type == DT_I32)
        static_cast<int32_t*>(epi.out)[o] = v;
      else
        store_from_f32(epi.out, o, epi.out_type, static_cast<float>(v));
    }
  }
}

}  // namespace

extern "C" int mte_gemm_launch(const void* a, const void* b, const void* c,
                               const void* bias, void* out, int M, int N,
                               int K, long lda, long ldb, long ldc, long ldo,
                               int in_type, int out_type, int bf16acc, int bm,
                               int bn, int rbk, int trans_b, float alpha,
                               float beta, int has_softcap, float softcap,
                               int act, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || rbk <= 0 || rbk % gemm::BK != 0)
    return (int)cudaErrorInvalidValue;
  Epi epi{alpha, beta, static_cast<const float*>(c), ldc,
          static_cast<const float*>(bias), softcap, has_softcap, act, out,
          ldo, out_type};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define LAUNCH(T, ACC, BM_, BN_, TR, ENG, BA)                                  \
  {                                                                           \
    dim3 grid((N + BN_ - 1) / BN_, (M + BM_ - 1) / BM_);                       \
    mte_gemm_kernel<T, ACC, BM_, BN_, TR, ENG, BA>                             \
        <<<grid, gemm::THREADS, 0, st>>>(static_cast<const T*>(a), lda,        \
                                         static_cast<const T*>(b), ldb, M, N, \
                                         K, rbk, epi);                        \
    return (int)cudaGetLastError();                                           \
  }
  GEMM_DISPATCH(in_type, bm, bn, trans_b, bf16acc, LAUNCH);
#undef LAUNCH
}

namespace {

// The fused epilogue on four accumulator values (columns c .. c + 3 of
// row r, staged by the mainloop), then the one write of the output.
template <bool BF16ACC>
struct EpiStore {
  Epi epi;
  int M, N;
  __device__ __forceinline__ void operator()(int r, int c, float4 v) const {
    if (r >= M || c >= N) return;  // N % 8 == 0: c < N covers c + 3
    float x[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) x[e] = apply_epi<BF16ACC>(x[e], r, c + e, epi);
    const long o = static_cast<long>(r) * epi.ldo + c;  // a multiple of 4
    if (epi.out_type == DT_BF16) {
      const __nv_bfloat162 pair[2] = {__floats2bfloat162_rn(x[0], x[1]),
                                      __floats2bfloat162_rn(x[2], x[3])};
      *reinterpret_cast<uint2*>(static_cast<__nv_bfloat16*>(epi.out) + o) =
          *reinterpret_cast<const uint2*>(pair);
    } else if (epi.out_type == DT_F32) {
      *reinterpret_cast<float4*>(static_cast<float*>(epi.out) + o) =
          make_float4(x[0], x[1], x[2], x[3]);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        store_from_f32(epi.out, o + e, epi.out_type, x[e]);
    }
  }
};

}  // namespace

extern "C" int mte_gemm_wgmma_launch(const void* a, const void* b,
                                     const void* c, const void* bias,
                                     void* out, int M, int N, int K,
                                     long lda, long ldb, long ldc, long ldo,
                                     int out_type, int bf16acc, int bm,
                                     int bn, int rbk, int trans_b,
                                     float alpha, float beta,
                                     int has_softcap, float softcap,
                                     int act, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % 8 != 0 || N % 8 != 0 ||
      lda % 8 != 0 || ldb % 8 != 0 || ldo % 4 != 0 ||
      reinterpret_cast<uintptr_t>(a) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(b) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  Epi epi{alpha, beta, static_cast<const float*>(c), ldc,
          static_cast<const float*>(bias), softcap, has_softcap, act, out,
          ldo, out_type};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define WG_LAUNCH(BM_, BN_, TR, BA)                                       \
  return wg::launch<BM_, BN_, TR, BA>(a, b, M, N, K, lda, ldb, rbk,       \
                                      EpiStore<BA>{epi, M, N}, st)
#define WG_TILE(BM_, BN_, ACC16)                                          \
  if (bm == BM_ && bn == BN_) {                                           \
    if (trans_b) {                                                        \
      if (bf16acc && ACC16) WG_LAUNCH(BM_, BN_, true, ACC16);             \
      if (!bf16acc) WG_LAUNCH(BM_, BN_, true, false);                     \
    } else {                                                              \
      if (bf16acc && ACC16) WG_LAUNCH(BM_, BN_, false, ACC16);            \
      if (!bf16acc) WG_LAUNCH(BM_, BN_, false, false);                    \
    }                                                                     \
    return (int)cudaErrorInvalidValue;                                    \
  }
  WG_TILE(64, 64, true)
  WG_TILE(64, 128, true)
  WG_TILE(64, 256, false)
  WG_TILE(128, 64, true)
  WG_TILE(128, 128, true)
  WG_TILE(128, 256, false)
#undef WG_TILE
#undef WG_LAUNCH
  return (int)cudaErrorInvalidValue;
}

namespace {

// The int32 accumulator of four columns c .. c + 3 of row r, stored as it
// is (one aligned 16-byte write; N % 8 == 0, ldo % 4 == 0).
struct S8Store {
  int32_t* out;
  int M, N;
  long ldo;
  __device__ __forceinline__ void operator()(int r, int c, int4 v) const {
    if (r >= M || c >= N) return;
    *reinterpret_cast<int4*>(out + static_cast<long>(r) * ldo + c) = v;
  }
};

}  // namespace

extern "C" int mte_gemm_wgmma_s8_launch(const void* a, const void* b,
                                        void* out, int M, int N, int K,
                                        long lda, long ldb, long ldo,
                                        int bm, int bn, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % 16 != 0 || N % 8 != 0 ||
      lda % 16 != 0 || ldb % 16 != 0 || ldo % 4 != 0 ||
      reinterpret_cast<uintptr_t>(a) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(b) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const S8Store store{static_cast<int32_t*>(out), M, N, ldo};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define S8_TILE(BM_, BN_)                                                 \
  if (bm == BM_ && bn == BN_)                                             \
    return wg::launch_s8<BM_, BN_>(a, b, M, N, K, lda, ldb, store, st);
  S8_TILE(64, 64)
  S8_TILE(64, 128)
  S8_TILE(64, 256)
  S8_TILE(128, 64)
  S8_TILE(128, 128)
  S8_TILE(128, 256)
#undef S8_TILE
  return (int)cudaErrorInvalidValue;
}

extern "C" int mte_gemm_simt_launch(const void* a, const void* b,
                                    const void* c, const void* bias,
                                    void* out, int M, int N, int K, long lda,
                                    long ldb, long ldc, long ldo,
                                    int out_type, int bm, int bn,
                                    int trans_b, float alpha, float beta,
                                    int has_softcap, float softcap, int act,
                                    void* stream) {
  Epi epi{alpha, beta, static_cast<const float*>(c), ldc,
          static_cast<const float*>(bias), softcap, has_softcap, act, out,
          ldo, out_type};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* A = static_cast<const float*>(a);
  const float* B = static_cast<const float*>(b);
#define SIMT_LAUNCH(BM_, BN_)                                             \
  if (bm == BM_ && bn == BN_)                                             \
    return trans_b ? simt::launch<BM_, BN_, true>(A, lda, B, ldb, M, N,   \
                                                  K, 1, K, epi, 0, st)    \
                   : simt::launch<BM_, BN_, false>(A, lda, B, ldb, M, N,  \
                                                   K, 1, K, epi, 0, st);
  SIMT_LAUNCH(128, 128)
  SIMT_LAUNCH(128, 64)
#undef SIMT_LAUNCH
  return (int)cudaErrorInvalidValue;
}
