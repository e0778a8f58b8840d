// B3: the grouped GEMM for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/grouped_gemm.py, grouped_gemm_pallas /
// _kernel (x (G, C, K) @ w (G, K, N) -> (G, C, N) on a (G, gm, gn, gk)
// grid; the accumulator tile stays in VMEM across the K loop, the K tail of
// both operands is masked, and the epilogue -- no C, no bias -- runs on the
// last K step).
//
// What bounds it on the H100: the decode q/k/v group it serves (G = 3,
// C = 4 slots, K = 2048, N = 2048 after padding k/v up to q's width, bf16)
// reads every weight byte once for ~4 FLOP per byte -- HBM bandwidth; the
// prefill gate+up group (C = 512, N = 16384) sits near the bf16 ridge --
// tensor-core rate.  The design: B1's tile loop (gemm_tile.cuh) with the
// group index on the grid (blockIdx.z): one 128-thread block per (group,
// output tile), K walked inside the block 32 deep at a time with both
// operands' K tails loaded as zeros, and the epilogue applied to the staged
// accumulator before the single write of the output.
//
// - x may be shared by the whole group: the wrapper passes x's group stride
//   (0 for the graph programs' broadcast x, torch's expand), so the shared
//   rows are read through the same pointer by every group -- no copy.
// - A member whose true width is below N (k/v padded to q's width): every
//   output column at or past the width is written as zero, and a tile that
//   lies wholly there reads no operand, so the padded columns cost no
//   weight traffic.  Up to MAX_WIDTHS members carry a width; the rest use
//   N.
// - Accumulators: f32 (fp32 and bf16 operands), int32 (int8 operands; the
//   epilogue must be the identity, the dequantize runs outside), or bf16acc
//   emulated as in B1 (each rbk-deep block's partial rounded to bf16 and
//   added to a bf16-rounded running sum; every epilogue step rounded).
// The tile loop serves what B3's other engines leave it: int8, fp32 at
// C <= 16 and unaligned shapes (the bf16 decode group runs the cluster
// split-K kernel, grouped_gemm_splitk.cu; bf16 past 16 rows the wgmma
// mainloop, grouped_gemm_wgmma.cu).
//
// grouped_gemm_simt_launch (counter "grouped_gemm_simt"): f32 operands
// past 16 rows with K and N multiples of 4 at a 128 x 128 or 128 x 64
// tile -- GroupedGemm's backward, where C is the token count (dx = dacc @
// w^T, dw = x^T @ dacc: 2-550 GFLOP at hundreds of FLOP per byte, bound by
// the FP32 lanes).  The mainloop of simt_f32_mainloop.cuh (8 x 8
// accumulators a thread over a 16-deep cp.async ring, the tile loop's FMA
// chain from k = 0, so bit-equal to it) with the group index on the grid
// (blockIdx.z), x read through its group stride (0 when shared), the
// widths as above, and the epilogue from registers.
#include <type_traits>

#include "epilogue.cuh"
#include "gemm_tile.cuh"
#include "simt_f32_mainloop.cuh"

namespace {

constexpr int MAX_WIDTHS = 8;

struct Widths {
  int count;
  int w[MAX_WIDTHS];
};

template <typename T, typename Acc, int BM, int BN, int ENGINE, bool BF16ACC>
__global__ void __launch_bounds__(gemm::THREADS)
    grouped_gemm_kernel(const T* X, long sx, long ldx, const T* W, int M,
                        int N, int K, int rbk, Epi epi, Widths widths) {
  __shared__ gemm::Smem<T, BM, BN> sm;
  const int g = blockIdx.z;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const long o_base = static_cast<long>(g) * M * N;
  const int n_live = g < widths.count ? min(widths.w[g], N) : N;
  if (n0 >= n_live) {
    // Wholly in this member's padding: the caller drops these columns.
    for (int e = threadIdx.x; e < BM * BN; e += gemm::THREADS) {
      const long gr = m0 + e / BN, gc = n0 + e % BN;
      if (gr < M && gc < N)
        store_from_f32(epi.out, o_base + gr * N + gc, epi.out_type, 0.0f);
    }
    return;
  }
  const T* A = X + g * sx;
  const T* B = W + static_cast<long>(g) * K * N;
  if constexpr (ENGINE == 1)
    gemm::tile_wmma<BM, BN, false, BF16ACC>(sm, A, ldx, B, N, M, N, m0, n0,
                                            0, K, rbk);
  else
    gemm::tile_simt<T, Acc, BM, BN, false>(sm, A, ldx, B, N, M, N, m0, n0, 0,
                                           K);
  constexpr int LDS = gemm::Smem<T, BM, BN>::LDS;
  for (int e = threadIdx.x; e < BM * BN; e += gemm::THREADS) {
    const int r = e / BN, c = e % BN;
    const long gr = m0 + r, gc = n0 + c;
    if (gr >= M || gc >= N) continue;
    const long o = o_base + gr * N + gc;
    if (gc >= n_live) {
      // Past this member's width inside a straddling tile: zeros too.
      store_from_f32(epi.out, o, epi.out_type, 0.0f);
    } else if constexpr (std::is_floating_point<Acc>::value) {
      store_from_f32(epi.out, o, epi.out_type,
                     apply_epi<BF16ACC>(sm.stage[r * LDS + c], gr, gc, epi));
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

extern "C" int grouped_gemm_launch(const void* x, const void* w, void* out,
                                   int G, int M, int N, int K, long sx,
                                   long ldx, int in_type, int out_type,
                                   int bf16acc, int bm, int bn, int rbk,
                                   float alpha, int has_softcap,
                                   float softcap, int act, int n_widths,
                                   const int* widths, void* stream) {
  if (G <= 0 || M <= 0 || N <= 0 || K <= 0 || rbk <= 0 ||
      rbk % gemm::BK != 0 || n_widths < 0 || n_widths > MAX_WIDTHS)
    return (int)cudaErrorInvalidValue;
  Epi epi{alpha, 0.0f, nullptr, 0, nullptr, softcap, has_softcap, act, out,
          N, out_type};
  Widths wd{n_widths, {}};
  for (int i = 0; i < n_widths; ++i) wd.w[i] = widths[i];
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool skinny = bm == 16 && bn == 128;
  const bool large = bm == 64 && bn == 64;
  if (!skinny && !large) return (int)cudaErrorInvalidValue;
#define LAUNCH(T, ACC, BM_, BN_, ENG, BA)                                     \
  {                                                                          \
    dim3 grid((N + BN_ - 1) / BN_, (M + BM_ - 1) / BM_, G);                   \
    grouped_gemm_kernel<T, ACC, BM_, BN_, ENG, BA><<<grid, gemm::THREADS, 0,  \
                                                     st>>>(                  \
        static_cast<const T*>(x), sx, ldx, static_cast<const T*>(w), M, N, K, \
        rbk, epi, wd);                                                       \
    return (int)cudaGetLastError();                                          \
  }
  if (in_type == DT_BF16) {
    if (skinny) {
      if (bf16acc) LAUNCH(__nv_bfloat16, float, 16, 128, 1, true);
      LAUNCH(__nv_bfloat16, float, 16, 128, 1, false);
    }
    if (bf16acc) LAUNCH(__nv_bfloat16, float, 64, 64, 1, true);
    LAUNCH(__nv_bfloat16, float, 64, 64, 1, false);
  }
  if (bf16acc) return (int)cudaErrorInvalidValue;
  if (in_type == DT_F32) {
    if (skinny) LAUNCH(float, float, 16, 128, 0, false);
    LAUNCH(float, float, 64, 64, 0, false);
  }
  if (in_type == DT_I8) {
    if (skinny) LAUNCH(int8_t, int32_t, 16, 128, 0, false);
    LAUNCH(int8_t, int32_t, 64, 64, 0, false);
  }
#undef LAUNCH
  return (int)cudaErrorInvalidValue;
}

namespace {

// The SIMT f32 engine over the group: block (x, z) is output tile x (in
// the GROUP_M order of simt::gemm_kernel) of member z.
template <int BM, int BN>
__global__ void __launch_bounds__(simt::THREADS, simt::min_blocks(false))
    grouped_simt_kernel(const float* X, long sx, long ldx, const float* W,
                        int M, int N, int K, Epi epi, Widths widths,
                        int vec) {
  using T = simt::Tile<BM, BN>;
  extern __shared__ float4 smem4[];
  const int g = blockIdx.z;
  const int tiles_m = (M + BM - 1) / BM, tiles_n = (N + BN - 1) / BN;
  const int per_group = simt::GROUP_M * tiles_n;
  const int first = (blockIdx.x / per_group) * simt::GROUP_M;
  const int rows = min(tiles_m - first, simt::GROUP_M);
  const int in_group = blockIdx.x % per_group;
  const int m0 = (first + in_group % rows) * BM;
  const int n0 = (in_group / rows) * BN;
  const long o_base = static_cast<long>(g) * M * N;
  const int n_live = g < widths.count ? min(widths.w[g], N) : N;
  if (n0 >= n_live) {
    // Wholly in this member's padding: zeros, no operand read.
    for (int e = threadIdx.x; e < BM * BN; e += simt::THREADS) {
      const long gr = m0 + e / BN, gc = n0 + e % BN;
      if (gr < M && gc < N)
        store_from_f32(epi.out, o_base + gr * N + gc, epi.out_type, 0.0f);
    }
    return;
  }
  float acc[T::RM * 4][T::RN * 4];
#pragma unroll
  for (int r = 0; r < T::RM * 4; ++r)
#pragma unroll
    for (int c = 0; c < T::RN * 4; ++c) acc[r][c] = 0.0f;
  simt::mainloop<BM, BN, false>(reinterpret_cast<float*>(smem4), X + g * sx,
                                ldx, W + static_cast<long>(g) * K * N, N, M,
                                N, m0, n0, 0, K, acc);
  const int ty = simt::thread_row(), tx = simt::thread_col();
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
        float x[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          x[e] = c + e < n_live
                     ? apply_epi<false>(acc[i * 4 + ii][j * 4 + e], r, c + e,
                                        epi)
                     : 0.0f;
        const long o = o_base + static_cast<long>(r) * N + c;
        if (vec && epi.out_type == DT_F32) {
          *reinterpret_cast<float4*>(static_cast<float*>(epi.out) + o) =
              make_float4(x[0], x[1], x[2], x[3]);
        } else if (vec) {
          const __nv_bfloat162 pair[2] = {__floats2bfloat162_rn(x[0], x[1]),
                                          __floats2bfloat162_rn(x[2], x[3])};
          *reinterpret_cast<uint2*>(static_cast<__nv_bfloat16*>(epi.out) +
                                    o) = *reinterpret_cast<const uint2*>(pair);
        } else {
          for (int e = 0; e < 4 && c + e < N; ++e)
            store_from_f32(epi.out, o + e, epi.out_type, x[e]);
        }
      }
    }
}

template <int BM, int BN>
int launch_grouped_simt(const float* x, long sx, long ldx, const float* w,
                        int G, int M, int N, int K, const Epi& epi,
                        const Widths& wd, cudaStream_t st) {
  using T = simt::Tile<BM, BN>;
  static bool sized = false;
  if (!sized) {
    const cudaError_t ce = cudaFuncSetAttribute(
        grouped_simt_kernel<BM, BN>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM_BYTES);
    if (ce != cudaSuccess) return static_cast<int>(ce);
    sized = true;
  }
  // N % 4 == 0 here; 16-byte (f32) or 8-byte (bf16) stores of four
  // columns need an aligned output.
  const int out_bytes = epi.out_type == DT_BF16 ? 2 : 4;
  const int vec =
      reinterpret_cast<uintptr_t>(epi.out) % (4 * out_bytes) == 0;
  const dim3 grid(((M + BM - 1) / BM) * ((N + BN - 1) / BN), 1, G);
  grouped_simt_kernel<BM, BN><<<grid, simt::THREADS, T::SMEM_BYTES, st>>>(
      x, sx, ldx, w, M, N, K, epi, wd, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int grouped_gemm_simt_launch(const void* x, const void* w,
                                        void* out, int G, int M, int N,
                                        int K, long sx, long ldx,
                                        int out_type, int bm, int bn,
                                        float alpha, int has_softcap,
                                        float softcap, int act, int n_widths,
                                        const int* widths, void* stream) {
  const auto a16 = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  if (G <= 0 || G > 65535 || M <= 0 || N <= 0 || K <= 0 || K % 4 != 0 ||
      N % 4 != 0 || sx % 4 != 0 || ldx % 4 != 0 || !a16(x) || !a16(w) ||
      n_widths < 0 || n_widths > MAX_WIDTHS ||
      (out_type != DT_F32 && out_type != DT_BF16))
    return (int)cudaErrorInvalidValue;
  Epi epi{alpha, 0.0f, nullptr, 0, nullptr, softcap, has_softcap, act, out,
          N, out_type};
  Widths wd{n_widths, {}};
  for (int i = 0; i < n_widths; ++i) wd.w[i] = widths[i];
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* X = static_cast<const float*>(x);
  const float* W = static_cast<const float*>(w);
  if (bm == 128 && bn == 128)
    return launch_grouped_simt<128, 128>(X, sx, ldx, W, G, M, N, K, epi, wd,
                                         st);
  if (bm == 128 && bn == 64)
    return launch_grouped_simt<128, 64>(X, sx, ldx, W, G, M, N, K, epi, wd,
                                        st);
  return (int)cudaErrorInvalidValue;
}
