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
// below 2^24); this one keeps int32.  Three engines, as for B1
// (core/geometry.py:gemm_engine), so that MTE against rigid compares the
// ISAs' flexibility at equal mainloop quality:
//
// - rigid_gemm_wgmma_launch (counter "rigid_gemm_wgmma"): bf16 operands
//   with K and N multiples of 8 -- B1's TMA + mbarrier + wgmma mainloop
//   (wgmma_mainloop.cuh) at the 128 x 128 tile, the 128-deep K block
//   walked as two 64-deep TMA stages (that changes the loads, not the
//   arithmetic); AccStore writes the f32 accumulator the mainloop staged
//   in shared memory.
// - rigid_gemm_wgmma_s8_launch (counter "rigid_gemm_wgmma_s8"): int8
//   operands with K a multiple of 16 and N of 8 (TMA's 16-byte rows of the
//   K-major operands), K up to S8_MAX_K, at every M -- the s8 path of the
//   same mainloop (wg::launch_s8, B1's int8 entry) at the 128 x 128 tile;
//   one 128-deep int8 stage is the rigid K block.  B comes K-major, (N, K)
//   row-major (PTX has no transpose bit for .s8; the wrapper copies a
//   (K, N) B first, as B1's does).  Rows past M and the K tail are TMA's
//   zeros (a 4-row decode GEMV pays the 128-row tile, as the rigid tile
//   does by design); S8Store writes the raw int32 accumulator, exact past
//   2^24.
//   No split-K: a 4 x 2048 x 16384 GEMV runs 16 CTAs, each 16384 deep --
//   the rigid handicap.
// - rigid_gemm_simt_launch (counter "rigid_gemm_simt"): f32 operands with
//   K and N multiples of 4, at every M -- B1's SIMT f32 mainloop
//   (simt_f32_mainloop.cuh) at the 128 x 128 tile, the 128-deep K block
//   walked as eight 16-deep stages of its cp.async ring (that changes the
//   loads, not the arithmetic); the identity epilogue stores the raw f32
//   accumulator from registers.  Each output is the tile loop's FMA chain
//   from k = 0, so the engine is bit-equal to rigid_gemm_launch at every
//   shape, M <= 16 included.  It carries the f32 backward GEMMs of
//   training under the rigid policy.
// - rigid_gemm_launch (counter "rigid_gemm"): B1's tile loop
//   (gemm_tile.cuh) at the 128 x 128 tile, the K block walked as four
//   32-deep shared-memory stages, for what no pipelined engine takes
//   (int8 with K % 16 != 0 or N % 8 != 0, f32 with K or N not a multiple
//   of 4).
//   A block takes 86 KB (bf16), 103 KB (f32) or 78 KB (int8) of shared
//   memory, most of it the accumulator staging tile: above the 48 KB
//   default, so the launch raises the limit with cudaFuncSetAttribute.
//
// Stage 2 (epilogue_pass_kernel) reads the f32 accumulator (and C, and the
// bias) back from device memory, applies the epilogue per element in
// Epilogue.apply's order (the arithmetic of apply_epi<false> in
// epilogue.cuh, which B1 fuses) and writes out_dtype.  It is bound by bytes
// (4 read and 2 or 4 written per element, 4 more read with C) and, for the
// tanh-gelu, close to bound by instruction issue, so what feeds it is
// lean: a 2-D grid (column blocks x rows, rows strided past 65535) with
// row and column from 32-bit block arithmetic, no division per element;
// each thread takes 8 consecutive columns of a row with two 16-byte
// streaming loads of the accumulator (two more of C, two of the bias
// once) issued before first use, and one 16-byte store of 8 bf16 outputs
// (two of f32) -- 2 columns where the pass is too small to fill the card
// so (launch_pass).  Rows whose N, leading dimensions or pointers are not
// 16-byte aligned take a scalar path in the same kernel.  An identity
// epilogue skips stage 2 (the wrapper casts the accumulator instead), as
// rigid_gemm_pallas does.
//
// What bounds it on the H100: the product's tensor-core rate and its
// operand traffic, as for B1, plus the accumulator's write and read (8
// bytes per output element), a second launch, and the 128-row tile's
// padding when M is small -- the costs the comparison with the MTE route
// is meant to show.
#include <climits>
#include <type_traits>

#include "epilogue.cuh"
#include "gemm_tile.cuh"
#include "simt_f32_mainloop.cuh"
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

// Stage 1 on the wgmma engine's s8 path: the raw int32 accumulator, four
// columns at a time, to device memory as it is.  Not shared with
// mte_gemm.cu's: a Store in this file's anonymous namespace keeps
// wg::launch_s8's instantiation, and its function-local `static bool
// sized`, private to this library (one shared across two libraries would
// leave the second kernel without its shared-memory limit).
struct S8Store {
  int32_t* acc;
  int M, N;
  __device__ __forceinline__ void operator()(int r, int c, int4 v) const {
    if (r >= M || c >= N) return;  // N % 8 == 0: c < N covers c + 3
    *reinterpret_cast<int4*>(acc + static_cast<long>(r) * N + c) = v;
  }
};

constexpr int PASS_THREADS = 128;

// COLS (2 or 8) consecutive floats from p (aligned to 4 * COLS bytes),
// streamed.
template <int COLS>
__device__ __forceinline__ void load_cols(float (&x)[COLS], const float* p) {
  static_assert(COLS == 2 || COLS == 8, "2 or 8 columns a thread");
  if constexpr (COLS == 8) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float4 v = __ldcs(reinterpret_cast<const float4*>(p) + i);
      x[4 * i] = v.x, x[4 * i + 1] = v.y, x[4 * i + 2] = v.z;
      x[4 * i + 3] = v.w;
    }
  } else {
    const float2 v = __ldcs(reinterpret_cast<const float2*>(p));
    x[0] = v.x, x[1] = v.y;
  }
}

template <int COLS>
__device__ __forceinline__ void store_cols(float* p, const float (&y)[COLS]) {
  if constexpr (COLS == 8) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
      __stcs(reinterpret_cast<float4*>(p) + i,
             make_float4(y[4 * i], y[4 * i + 1], y[4 * i + 2], y[4 * i + 3]));
  } else {
    __stcs(reinterpret_cast<float2*>(p), make_float2(y[0], y[1]));
  }
}

// COLS bf16 outputs as one store of 2 * COLS bytes.
template <int COLS>
__device__ __forceinline__ void store_cols(__nv_bfloat16* p,
                                           const float (&y)[COLS]) {
  uint32_t h[COLS / 2];
#pragma unroll
  for (int j = 0; j < COLS / 2; ++j) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(y[2 * j], y[2 * j + 1]);
    h[j] = *reinterpret_cast<const uint32_t*>(&v);
  }
  if constexpr (COLS == 8)
    __stcs(reinterpret_cast<uint4*>(p), make_uint4(h[0], h[1], h[2], h[3]));
  else
    __stcs(reinterpret_cast<unsigned int*>(p), h[0]);
}

// Block (x, y): columns [PASS_THREADS * COLS * x, ...) of rows y,
// y + gridDim.y, ...; each thread COLS consecutive columns of a row, every
// load of which is issued before its first use.  `vec`: N, ldc, ldo and
// every pointer allow 16-byte accesses; otherwise (and at a row's ragged
// end) scalar loads and stores.
template <typename TOut, int COLS>
__global__ void __launch_bounds__(PASS_THREADS)
    epilogue_pass_kernel(const float* acc, int M, int N, Epi epi, int vec) {
  const int c0 = (blockIdx.x * PASS_THREADS + threadIdx.x) * COLS;
  if (c0 >= N) return;
  TOut* out = static_cast<TOut*>(epi.out);
  const bool full = vec && c0 + COLS <= N;
  const int n = min(COLS, N - c0);
  float bv[COLS] = {};
  if (epi.bias != nullptr) {
    if (full) {
      load_cols<COLS>(bv, epi.bias + c0);
    } else {
#pragma unroll
      for (int j = 0; j < COLS; ++j)
        if (j < n) bv[j] = epi.bias[c0 + j];
    }
  }
  for (int r = blockIdx.y; r < M; r += gridDim.y) {
    const float* a = acc + static_cast<long>(r) * N + c0;
    const float* c = epi.c + r * epi.ldc + c0;
    TOut* o = out + r * epi.ldo + c0;
    float x[COLS] = {}, cv[COLS] = {}, y[COLS];
    if (full) {
      load_cols<COLS>(x, a);
      if (epi.beta != 0.0f) load_cols<COLS>(cv, c);
    } else {
#pragma unroll
      for (int j = 0; j < COLS; ++j)
        if (j < n) {
          x[j] = a[j];
          if (epi.beta != 0.0f) cv[j] = c[j];
        }
    }
#pragma unroll
    for (int j = 0; j < COLS; ++j)
      y[j] = apply_epi_at<false>(x[j], cv[j], bv[j], epi);
    if (full) {
      store_cols<COLS>(o, y);
    } else {
#pragma unroll
      for (int j = 0; j < COLS; ++j)
        if (j < n) o[j] = from_f32<TOut>(y[j]);
    }
  }
}

template <typename TOut, int COLS>
int launch_pass(const float* acc, int M, int N, const Epi& epi,
                cudaStream_t st) {
  const auto a16 = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const int vec = N % 8 == 0 && epi.ldc % 8 == 0 && epi.ldo % 8 == 0 &&
                  a16(acc) && a16(epi.c) && a16(epi.bias) && a16(epi.out);
  const dim3 grid((N + PASS_THREADS * COLS - 1) / (PASS_THREADS * COLS),
                  M < 65535 ? M : 65535);
  epilogue_pass_kernel<TOut, COLS><<<grid, PASS_THREADS, 0, st>>>(
      acc, M, N, epi, vec);
  return static_cast<int>(cudaGetLastError());
}

// Columns a thread takes: 8 (two 16-byte loads in flight, the fewest
// instructions per byte) where that grid still puts at least 4 blocks on
// every SM; else 2, so that a small pass (a decode GEMV's, 4 rows) spreads
// over more of the card with less code per thread: inside a decode step,
// between the step's other kernels, such a pass ran slower at 8 columns a
// thread than the one-element-a-thread pass before it, though not when
// timed alone (PERF.md, Findings).
template <typename TOut>
int launch_pass(const float* acc, int M, int N, const Epi& epi,
                cudaStream_t st) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const long blocks8 = static_cast<long>((N + PASS_THREADS * 8 - 1) /
                                         (PASS_THREADS * 8)) * M;
  return blocks8 >= 4L * sms ? launch_pass<TOut, 8>(acc, M, N, epi, st)
                             : launch_pass<TOut, 2>(acc, M, N, epi, st);
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

// b is (N, K) row-major (K-major); acc is (M, N) int32.  Refuses K past
// S8_MAX_K (launch_s8) and anything TMA or the 16-byte store cannot take.
extern "C" int rigid_gemm_wgmma_s8_launch(const void* a, const void* b,
                                          void* acc, int M, int N, int K,
                                          long lda, long ldb, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % 16 != 0 || N % 8 != 0 ||
      lda % 16 != 0 || ldb % 16 != 0 ||
      reinterpret_cast<uintptr_t>(a) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(b) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(acc) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  return wg::launch_s8<RM, RN>(a, b, M, N, K, lda, ldb,
                               S8Store{static_cast<int32_t*>(acc), M, N},
                               static_cast<cudaStream_t>(stream));
}

extern "C" int rigid_gemm_simt_launch(const void* a, const void* b,
                                      void* acc, int M, int N, int K,
                                      long lda, long ldb, void* stream) {
  if (reinterpret_cast<uintptr_t>(acc) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  // The identity epilogue into f32: simt::launch stores the accumulators
  // as they are (N % 4 == 0, a 16-byte aligned output).
  const Epi epi{1.0f, 0.0f, nullptr, 0, nullptr, 0.0f, 0, 0, acc, N, DT_F32};
  return simt::launch<RM, RN, false>(
      static_cast<const float*>(a), lda, static_cast<const float*>(b), ldb,
      M, N, K, 1, K, epi, 0, static_cast<cudaStream_t>(stream));
}

extern "C" int epilogue_pass_launch(const void* acc, const void* c,
                                    const void* bias, void* out, long M,
                                    long N, long ldc, float alpha, float beta,
                                    int has_softcap, float softcap, int act,
                                    int out_type, void* stream) {
  if (M <= 0 || N <= 0 || M > INT_MAX || N > INT_MAX)
    return (int)cudaErrorInvalidValue;
  Epi epi{alpha, beta, static_cast<const float*>(c), ldc,
          static_cast<const float*>(bias), softcap, has_softcap, act, out, N,
          out_type};
  const float* a = static_cast<const float*>(acc);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (out_type) {
    case DT_F32: return launch_pass<float>(a, M, N, epi, st);
    case DT_BF16: return launch_pass<__nv_bfloat16>(a, M, N, epi, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
