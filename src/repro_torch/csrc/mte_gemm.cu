// B1: the MTE GEMM with its fused epilogue, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/mte_gemm.py, mte_gemm_pallas / _gemm_kernel
// (the TPU kernel keeps a (bm, bn) accumulator in VMEM over a sequential
// K grid axis and applies alpha/beta*C/bias/softcap/activation on the last
// K step).
//
// What bounds it on the H100: the prefill projections it serves (M = the
// 512-token chunk, N up to 16384, K 2048 or 16384, bf16) carry ~60-250
// FLOP per byte -- near the bf16 ridge (~295 FLOP/B), so the tensor-core
// rate is the bound.  The design: one 128-thread block per output tile
// (64x64, or 16x128 when M <= 16) loops over K inside the block (the TPU's
// sequential grid axis becomes an in-block loop), feeds bf16 tiles to the
// tensor cores through wmma with f32 accumulators in registers, and
// applies the whole epilogue to the accumulator staged in shared memory
// before the single write of the output -- the accumulator never goes to
// device memory.  No TMA/wgmma pipeline yet: this is the simple kernel
// that is right; the fast one is later work.
//
// Accumulators: f32 (fp32 and bf16 operands), int32 (int8 operands, whose
// dequantize and epilogue run outside the kernel, so the epilogue must be
// the identity), or bf16acc emulated in f32 registers (gemm_tile.cuh).
// Under bf16acc every epilogue step is rounded to bf16, as a bf16
// accumulator tile's element-wise arithmetic is.
#include <type_traits>

#include "gemm_tile.cuh"

namespace {

struct Epi {
  float alpha, beta;
  const float* c;     // (M, ldc) f32, already cast to the accumulator dtype
  long ldc;
  const float* bias;  // (N,) f32 or nullptr
  float softcap;
  int has_softcap;
  int act;            // 0 none, 1 relu, 2 gelu (tanh), 3 silu, 4 tanh
  void* out;
  long ldo;
  int out_type;
};

__device__ __forceinline__ float act_fn(float x, int act) {
  switch (act) {
    case 1: return fmaxf(x, 0.0f);
    case 2: return 0.5f * x *
                   (1.0f + tanhf(0.7978845608028654f *
                                 (x + 0.044715f * x * x * x)));
    case 3: return x / (1.0f + expf(-x));
    case 4: return tanhf(x);
    default: return x;
  }
}

template <bool R>
__device__ __forceinline__ float rnd(float x) {
  return R ? bf16_round(x) : x;
}

template <bool R>
__device__ __forceinline__ float apply_epi(float v, long r, long c,
                                           const Epi& e) {
  float x = rnd<R>(e.alpha * v);
  if (e.beta != 0.0f) x = rnd<R>(x + rnd<R>(e.beta * e.c[r * e.ldc + c]));
  if (e.bias != nullptr) x = rnd<R>(x + e.bias[c]);
  if (e.has_softcap)
    x = rnd<R>(e.softcap * rnd<R>(tanhf(rnd<R>(x / e.softcap))));
  if (e.act) x = rnd<R>(act_fn(x, e.act));
  return x;
}

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
