// B8: the rigid AMX-style baseline for Hopper (sm_90a) -- two kernels.
//
// Replaces: src/repro/kernels/rigid_gemm.py, rigid_gemm_pallas (B1's
// pallas_call at a fixed 128x128x128 block geometry with the identity
// epilogue, the raw accumulator written to HBM) and epilogue_pass_pallas /
// _epilogue_kernel (a separate element-wise kernel that reads the
// accumulator back and applies alpha, beta*C, bias, softcap and the
// activation).  The paper's two AMX defects are kept on purpose (S II-C,
// S II-D): the tile does not adapt to the shape, and the epilogue does not
// ride the accumulator registers but takes a round trip through memory.
//
// Stage 1 runs ONE tile, 128 x 128 outputs per block with a 128-deep K
// block, whatever M, N and K are -- a decode GEMV with M = 4 still pays a
// 128-row tile's MMAs.  It writes the raw accumulator -- f32 for
// fp32/bf16 operands (a rigid ISA has no narrow accumulator, so bf16acc
// runs f32 here, as in JAX), int32 for int8 -- to device memory.  The JAX
// kernel writes the int8 route's accumulator through f32 (exact only
// below 2^24); this one keeps int32.  Two engines, as for B1
// (core/geometry.py:gemm_engine), so that MTE against rigid compares the
// ISAs' flexibility at equal mainloop quality:
//
// - rigid_gemm_wgmma_launch (counter "rigid_gemm_wgmma"): bf16 operands
//   with K and N multiples of 8 -- B1's TMA + mbarrier + wgmma mainloop
//   (wgmma_mainloop.cuh) at the 128 x 128 tile, the 128-deep K block
//   walked as two 64-deep TMA stages (that changes the loads, not the
//   arithmetic); AccStore writes the f32 accumulator the mainloop staged
//   in shared memory.
// - rigid_gemm_launch (counter "rigid_gemm"): B1's tile loop
//   (gemm_tile.cuh) at the 128 x 128 tile, the K block walked as four
//   32-deep shared-memory stages, for f32, int8 and what TMA cannot take.
//   A block takes 86 KB (bf16), 103 KB (f32) or 78 KB (int8) of shared
//   memory, most of it the accumulator staging tile: above the 48 KB
//   default, so the launch raises the limit with cudaFuncSetAttribute.
//
// Stage 2 (epilogue_pass_kernel): one thread per output element, grid
// stride; reads the f32 accumulator (and C, and the bias) back from device
// memory, applies the epilogue in Epilogue.apply's order (epilogue.cuh) and
// writes out_dtype.  An identity epilogue skips stage 2 (the wrapper casts
// the accumulator instead), as rigid_gemm_pallas does.
//
// What bounds it on the H100: the product's tensor-core rate and its
// operand traffic, as for B1, plus the accumulator's write and read (8
// bytes per output element), a second launch, and the 128-row tile's
// padding when M is small -- the costs the comparison with the MTE route
// is meant to show.
#include <type_traits>

#include "epilogue.cuh"
#include "gemm_tile.cuh"
#include "wgmma_mainloop.cuh"

namespace {

constexpr int RM = 128, RN = 128, RK = 128;

template <typename T, typename Acc, int ENGINE>
__global__ void __launch_bounds__(gemm::THREADS)
    rigid_gemm_kernel(const T* A, long lda, const T* B, long ldb, int M,
                      int N, int K, Acc* acc) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  auto& sm = *reinterpret_cast<gemm::Smem<T, RM, RN>*>(smem_raw);
  const int m0 = blockIdx.y * RM, n0 = blockIdx.x * RN;
  if constexpr (ENGINE == 1)
    gemm::tile_wmma<RM, RN, false, false>(sm, A, lda, B, ldb, M, N, m0, n0,
                                          0, K, gemm::BK);
  else
    gemm::tile_simt<T, Acc, RM, RN, false>(sm, A, lda, B, ldb, M, N, m0, n0,
                                           0, K);
  constexpr int LDS = gemm::Smem<T, RM, RN>::LDS;
  for (int e = threadIdx.x; e < RM * RN; e += gemm::THREADS) {
    const int r = e / RN, c = e % RN;
    const long gr = m0 + r, gc = n0 + c;
    if (gr >= M || gc >= N) continue;
    acc[gr * N + gc] = reinterpret_cast<const Acc*>(sm.stage)[r * LDS + c];
  }
}

template <typename T, typename Acc, int ENGINE>
int launch_rigid(const void* a, const void* b, void* acc, int M, int N,
                 int K, long lda, long ldb, cudaStream_t st) {
  const int smem = static_cast<int>(sizeof(gemm::Smem<T, RM, RN>));
  cudaError_t e = cudaFuncSetAttribute(
      rigid_gemm_kernel<T, Acc, ENGINE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid((N + RN - 1) / RN, (M + RM - 1) / RM);
  rigid_gemm_kernel<T, Acc, ENGINE><<<grid, gemm::THREADS, smem, st>>>(
      static_cast<const T*>(a), lda, static_cast<const T*>(b), ldb, M, N, K,
      static_cast<Acc*>(acc));
  return static_cast<int>(cudaGetLastError());
}

// Stage 1 on the wgmma engine: the raw f32 accumulator, four columns at
// a time from the mainloop's staged tile, to device memory.
struct AccStore {
  float* acc;
  int M, N;
  __device__ __forceinline__ void operator()(int r, int c, float4 v) const {
    if (r >= M || c >= N) return;  // N % 8 == 0: c < N covers c + 3
    *reinterpret_cast<float4*>(acc + static_cast<long>(r) * N + c) = v;
  }
};

__global__ void __launch_bounds__(256)
    epilogue_pass_kernel(const float* acc, long M, long N, Epi epi) {
  const long total = M * N;
  for (long i = blockIdx.x * static_cast<long>(blockDim.x) + threadIdx.x;
       i < total; i += static_cast<long>(gridDim.x) * blockDim.x) {
    const long r = i / N, c = i % N;
    store_from_f32(epi.out, r * epi.ldo + c, epi.out_type,
                   apply_epi<false>(acc[i], r, c, epi));
  }
}

}  // namespace

extern "C" int rigid_gemm_launch(const void* a, const void* b, void* acc,
                                 int M, int N, int K, long lda, long ldb,
                                 int in_type, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (in_type) {
    case DT_BF16:
      return launch_rigid<__nv_bfloat16, float, 1>(a, b, acc, M, N, K, lda,
                                                   ldb, st);
    case DT_F32:
      return launch_rigid<float, float, 0>(a, b, acc, M, N, K, lda, ldb, st);
    case DT_I8:
      return launch_rigid<int8_t, int32_t, 0>(a, b, acc, M, N, K, lda, ldb,
                                              st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" int rigid_gemm_wgmma_launch(const void* a, const void* b,
                                       void* acc, int M, int N, int K,
                                       long lda, long ldb, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % 8 != 0 || N % 8 != 0 ||
      lda % 8 != 0 || ldb % 8 != 0 ||
      reinterpret_cast<uintptr_t>(a) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(b) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  return wg::launch<RM, RN, false, false>(
      a, b, M, N, K, lda, ldb, RK, AccStore{static_cast<float*>(acc), M, N},
      static_cast<cudaStream_t>(stream));
}

extern "C" int epilogue_pass_launch(const void* acc, const void* c,
                                    const void* bias, void* out, long M,
                                    long N, long ldc, float alpha, float beta,
                                    int has_softcap, float softcap, int act,
                                    int out_type, void* stream) {
  if (M <= 0 || N <= 0) return (int)cudaErrorInvalidValue;
  Epi epi{alpha, beta, static_cast<const float*>(c), ldc,
          static_cast<const float*>(bias), softcap, has_softcap, act, out, N,
          out_type};
  const long blocks = (M * N + 255) / 256;
  const int grid = static_cast<int>(blocks < 132 * 16 ? blocks : 132 * 16);
  epilogue_pass_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(acc), M, N, epi);
  return (int)cudaGetLastError();
}
