// B2's cluster engine: the split-K decode GEMM for Hopper (sm_90a), in one
// launch.
//
// Replaces, for bf16 operands with an f32 or a bf16 (bf16acc) accumulator,
// and for int8 operands with their int32 accumulator, at most 16 rows:
// src/repro/kernels/splitk_gemm.py, mte_gemm_splitk_pallas / _kernel (K
// cut into n_split slices on the TPU grid, each slice's partial in the
// accumulator dtype written to an (n_split, M, N) buffer, then the sum
// over slices and the epilogue outside the kernel, so beta * C and the
// bias join once; under int8 int32 partials, summed, the identity
// epilogue).  fp32 and M > 16 stay on the tile loop or the SIMT engine
// (splitk_gemm.cu); core/geometry.py:splitk_engine chooses.
//
// What bounds it on the H100: bytes.  The decode projections (M = the 4
// serving slots; gemma_2b's o 2048 x 2048, gate and up 2048 x 16384, down
// 16384 x 2048) read every weight byte once for 2M FLOP per byte.  The tile
// loop ran 16 x 128 tiles with no load in flight across its K steps, made
// a round trip through device memory with n_split x M x N f32 partials,
// and left the sum, the epilogue and the cast to 2-3 more PyTorch launches.
// This kernel runs B3's cluster split-K mainloop (splitk_cluster.cuh: a
// 4-stage TMA ring per CTA, x's slice in shared memory, mma.sync, the
// partials summed in rank order through distributed shared memory) at
// G = 1, and puts the rest in the same launch:
//
// - Grid (slices, N / 128 tiles); core/geometry.py:splitk_cluster_split
//   picks the slices (the plan's split_k is the tile loop's, not this).
// - The weight (K, N) row-major through a 2-D TMA map; rows past K and
//   columns past N come back as zeros, so a ragged K needs no mask.
// - The reduction rank applies the whole epilogue in f32, in the order of
//   Epilogue.apply (core/epilogue.py): alpha, then beta * C (C read in its
//   own dtype, f32 or bf16), then the bias (row or column; f32 or bf16),
//   softcap and activation, and writes out_dtype once.  No partials in
//   device memory, no atomics; the same sum order on every call, so the
//   output is bit-equal from call to call.
// - bf16acc: each slice keeps a bf16 running sum, rounded once per
//   rbk-deep block of the slice, the slices' sum is rounded to bf16 once
//   (splitk_cluster.cuh), and every epilogue step is rounded to bf16,
//   C and the bias read as bf16 values (epilogue.cuh's R = true), as
//   Epilogue.apply computes on a bf16 accumulator.
// - int8 (splitk_gemm_cluster_s8_launch): the mainloop's S8 path (int8
//   stages of 128 K rows, the (K, N) weight read as it lies, no K-major
//   copy), the slices' int32 partials summed exactly and written as the
//   int32 accumulator; the caller dequantizes and applies the epilogue, as
//   JAX's int8 route does outside its kernel.  Half the bf16 bytes, so the
//   weight's stream takes half the time at the same bytes per second.
#include "epilogue.cuh"
#include "splitk_cluster.cuh"

namespace {

struct SplitkEpi {
  float alpha, beta;
  const void* c;      // (M, ldc) in c_type, or nullptr when beta == 0
  long ldc;
  int c_type;
  const void* bias;   // (N,) or (M,) in bias_type, or nullptr
  int bias_type;
  int bias_col;       // 1: one bias per row of the output (bias_axis "col")
  float softcap;
  int has_softcap;
  int act;
  void* out;
  long ldo;
  int out_type;
};

// The epilogue of one reduced sum v; R (bf16acc) rounds every step and the
// C and bias operands to bf16.
template <bool R>
__device__ __forceinline__ float splitk_epi(float v, long r, long c,
                                            const SplitkEpi& e) {
  float x = rnd<R>(e.alpha * v);
  if (e.beta != 0.0f)
    x = rnd<R>(x + rnd<R>(e.beta *
                          rnd<R>(load_as_f32(e.c, r * e.ldc + c,
                                             e.c_type))));
  if (e.bias != nullptr)
    x = rnd<R>(x + rnd<R>(load_as_f32(e.bias, e.bias_col ? r : c,
                                      e.bias_type)));
  if (e.has_softcap)
    x = rnd<R>(e.softcap * rnd<R>(tanhf(rnd<R>(x / e.softcap))));
  if (e.act) x = rnd<R>(act_fn(x, e.act));
  return x;
}

template <bool BF16ACC>
__global__ void __launch_bounds__(skc::THREADS, 1)
    splitk_cluster_kernel(const __grid_constant__ CUtensorMap tmw,
                          const unsigned short* A, long lda, int M, int N,
                          int K, int depth, int rbk, SplitkEpi epi) {
  extern __shared__ __align__(1024) unsigned char smem[];
  const skc::Smem sm = skc::carve(smem);
  const int n0 = blockIdx.y * skc::BN;
  const int k0 = blockIdx.x * depth;
  const int nst = (min(depth, K - k0) + skc::BK - 1) / skc::BK;
  const auto load = [&](void* dst, uint64_t* bar, int col, int krow) {
    wg::tma_load(dst, &tmw, bar, col, krow);
  };
  skc::mainloop<BF16ACC, false>(sm, &tmw, A, lda, M, K, k0, depth, nst, n0,
                                N, rbk, load, [] {});
  skc::reduce<BF16ACC, false>(sm, M, N - n0, true, [&](int r, int c,
                                                        float v) {
    const long gc = n0 + c;
    store_from_f32(epi.out, r * epi.ldo + gc, epi.out_type,
                   splitk_epi<BF16ACC>(v, r, gc, epi));
  });
}

// The int8 kernel: a (M, K) int8, the weight's int8 map, out (M, N) int32.
__global__ void __launch_bounds__(skc::THREADS, 1)
    splitk_cluster_s8_kernel(const __grid_constant__ CUtensorMap tmw,
                             const signed char* A, long lda, int M, int N,
                             int K, int depth, int* out) {
  extern __shared__ __align__(1024) unsigned char smem[];
  const skc::Smem sm = skc::carve(smem);
  const int n0 = blockIdx.y * skc::BN;
  const int k0 = blockIdx.x * depth;
  const int nst = (min(depth, K - k0) + skc::BK_S8 - 1) / skc::BK_S8;
  const auto load = [&](void* dst, uint64_t* bar, int col, int krow) {
    wg::tma_load(dst, &tmw, bar, col, krow);
  };
  skc::mainloop<false, true>(sm, &tmw, A, lda, M, K, k0, depth, nst, n0, N,
                             0, load, [] {});
  skc::reduce<false, true>(sm, M, N - n0, true, [&](int r, int c, int v) {
    out[static_cast<long>(r) * N + n0 + c] = v;
  });
}

}  // namespace

// a (M, K) bf16, row stride lda; w (K, N) bf16 row-major, N % 8 == 0 and a
// 16-byte aligned base (TMA); c (M, ldc) and bias in their type codes (or
// null); out (M, N) f32 or bf16.  K is cut into n_split slices of `depth`
// rows (a multiple of 64; the last may be short).  bf16acc: a bf16
// accumulator, rounded once per rbk-deep block (a multiple of 16) of each
// slice; rbk is not read otherwise.
extern "C" int splitk_gemm_cluster_launch(
    const void* a, const void* w, const void* c, const void* bias, void* out,
    int M, int N, int K, long lda, long ldc, int c_type, int bias_type,
    int bias_col, int out_type, int n_split, int depth, int bf16acc, int rbk,
    float alpha, float beta, int has_softcap, float softcap, int act,
    void* stream) {
  if (M <= 0 || M > skc::MAX_M || N <= 0 || N % 8 != 0 || K <= 0 ||
      n_split < 1 || n_split > skc::MAX_SPLIT || depth <= 0 ||
      (bf16acc && (rbk <= 0 || rbk % 16 != 0)) ||
      depth % skc::BK != 0 || static_cast<long>(n_split - 1) * depth >= K ||
      static_cast<long>(n_split) * depth < K ||
      (beta != 0.0f && c == nullptr) ||
      (c_type != DT_F32 && c_type != DT_BF16) ||
      (bias_type != DT_F32 && bias_type != DT_BF16) ||
      (out_type != DT_F32 && out_type != DT_BF16))
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tmw;
  const int e = wg::make_map(&tmw, w, N, K, N, 64, skc::BK);
  if (e != 0) return e;
  const SplitkEpi epi{alpha,   beta,        c,   ldc, c_type,
                      bias,    bias_type,   bias_col, softcap,
                      has_softcap, act, out, N,   out_type};
  const int smem = skc::smem_bytes(M, depth);
  if (smem > wg::SMEM_LIMIT) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(n_split, (N + skc::BN - 1) / skc::BN);
  const auto* a16 = static_cast<const unsigned short*>(a);
  const auto st = static_cast<cudaStream_t>(stream);
  if (bf16acc)
    return wg::launch_cluster<splitk_cluster_kernel<true>>(
        grid, skc::THREADS, n_split, smem, st, tmw, a16, lda, M, N, K, depth,
        rbk, epi);
  return wg::launch_cluster<splitk_cluster_kernel<false>>(
      grid, skc::THREADS, n_split, smem, st, tmw, a16, lda, M, N, K, depth,
      rbk, epi);
}

// a (M, K) int8, row stride lda; w (K, N) int8 row-major, N % 16 == 0 and
// a 16-byte aligned base (TMA's 16-byte rows); out (M, N) int32, the exact
// a @ w.  K is cut into n_split slices of `depth` rows (a multiple of 128;
// the last may be short); K past wg::S8_MAX_K is refused (an int32 sum
// could overflow).
extern "C" int splitk_gemm_cluster_s8_launch(const void* a, const void* w,
                                             void* out, int M, int N, int K,
                                             long lda, int n_split,
                                             int depth, void* stream) {
  if (M <= 0 || M > skc::MAX_M || N <= 0 || N % 16 != 0 || K <= 0 ||
      K > wg::S8_MAX_K || n_split < 1 || n_split > skc::MAX_SPLIT ||
      depth <= 0 || depth % skc::BK_S8 != 0 ||
      static_cast<long>(n_split - 1) * depth >= K ||
      static_cast<long>(n_split) * depth < K)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tmw;
  const int e = wg::make_map(&tmw, w, N, K, N, skc::BN, skc::BK_S8, 1);
  if (e != 0) return e;
  const int smem = skc::smem_bytes(M, depth, 1);
  if (smem > wg::SMEM_LIMIT) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(n_split, (N + skc::BN - 1) / skc::BN);
  return wg::launch_cluster<splitk_cluster_s8_kernel>(
      grid, skc::THREADS, n_split, smem, static_cast<cudaStream_t>(stream),
      tmw, static_cast<const signed char*>(a), lda, M, N, K, depth,
      static_cast<int*>(out));
}
