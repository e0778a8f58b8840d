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
// No TMA/wgmma pipeline yet and no split-K: at decode only 3 x 16 output
// tiles exist (20 of them outside the padding) for 132 SMs.
#include <type_traits>

#include "epilogue.cuh"
#include "gemm_tile.cuh"

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
