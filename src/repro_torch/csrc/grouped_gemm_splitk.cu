// B3's split-K engine: the decode group's grouped GEMM for Hopper (sm_90a).
//
// Replaces, for bf16 operands with an f32 or a bf16 (bf16acc) accumulator,
// and for int8 operands with their int32 accumulator (identity epilogue),
// at most 16 rows: src/repro/kernels/grouped_gemm.py, grouped_gemm_pallas
// / _kernel (x (G, C, K) @ w (G, K, N) -> (G, C, N), the epilogue -- no C,
// no bias -- on each member's accumulator).
// Everything else stays on the tile loop (grouped_gemm.cu);
// core/geometry.py:grouped_engine chooses.  Under bf16acc the reference
// rounds its running sum once per K block in K order over the whole of K;
// here each slice does so over its own K rows and the slices' bf16
// partials are summed in f32 and rounded once (splitk_cluster.cuh), as
// the reference's split-K kernel does -- a deliberate difference, held to
// the reference within bf16 tolerance -- and the epilogue rounds every
// step to bf16 (epilogue.cuh's R = true).
//
// What bounds it on the H100: bytes.  The decode q/k/v group (C = 4 slots,
// K = d_model, members 2048/256/256 wide for gemma_2b, 4096/256/256 for
// recurrentgemma_9b) reads every live weight byte once for 2C FLOP per
// byte.  The tile loop gave each of its 20 live 16 x 128 tiles one block
// walking K in 64 dependent steps, with no load in flight across steps:
// ~0.1 TB/s.  This kernel runs the cluster split-K mainloop of
// splitk_cluster.cuh (TMA ring, x slice in shared memory, mma.sync, the
// rank-ordered reduction through distributed shared memory), which says
// how it keeps the loads in flight; what is B3's own:
//
// - Grid (slices, live tiles): core/geometry.py:grouped_split picks the
//   fewest slices (up to 4) that give live tiles x slices >= the SM count
//   -- 4 x 20 tiles for gemma_2b's group, 4 x 36 for recurrentgemma_9b's
//   --, up to 8 where x's slice would not fit, each a multiple of a 64-row
//   stage deep; tiles wholly past a member's width are not in the grid and
//   read no weight.
// - Weights through a 3-D map over (G, K, N), so a box never reads into
//   the next member and rows past K come back as zeros; x through its
//   group stride (0 for the broadcast x).
// - The epilogue (alpha, softcap, activation) on each reduced sum.
// - int8 (grouped_gemm_splitk_s8_launch): the mainloop's S8 path (128-row
//   int8 stages of w (G, K, N) as it lies, no K-major copy), the slices'
//   int32 partials summed exactly, the int32 accumulator written; the
//   caller dequantizes, as JAX's int8 route does outside its kernel.
// - Widths: columns at or past a member's width come back as zeros: the
//   straddling tile writes them in the reduction, and the tiles wholly in
//   the padding are zeroed by the clusters in turn (cluster y takes the
//   padding tiles p with p % live tiles == y) while their first stages
//   load.
#include "epilogue.cuh"
#include "splitk_cluster.cuh"

namespace {

using skc::BN;
using skc::CONSUMERS;
constexpr int MAX_WIDTHS = 8;

struct Widths {
  int count;
  int w[MAX_WIDTHS];
};

__device__ __forceinline__ int live_width(const Widths& wd, int g, int N) {
  return g < wd.count ? min(wd.w[g], N) : N;
}

// X: bf16, or int8 under S8 (group stride sx and row stride ldx in
// elements); S8 writes the int32 sums to epi.out.
template <bool BF16ACC, bool S8>
__global__ void __launch_bounds__(skc::THREADS, 1)
    grouped_splitk_kernel(const __grid_constant__ CUtensorMap tmw,
                          const void* X, long sx, long ldx, int G, int M,
                          int N, int K, int depth, int rbk, Epi epi,
                          Widths wd) {
  constexpr int KD = S8 ? skc::BK_S8 : skc::BK;
  extern __shared__ __align__(1024) unsigned char smem[];
  const skc::Smem sm = skc::carve(smem);
  const int S = gridDim.x, rank = blockIdx.x, T = gridDim.y;
  const int tid = threadIdx.x;

  // This cluster's live tile: (member g, first column n0); none when the
  // grid carries one cluster for a group with no live column.
  int g = -1, n0 = 0, n_live = 0;
  {
    int t = blockIdx.y;
    for (int i = 0; i < G; ++i) {
      const int live = live_width(wd, i, N);
      const int tiles = (live + BN - 1) / BN;
      if (t < tiles) {
        g = i, n0 = t * BN, n_live = live;
        break;
      }
      t -= tiles;
    }
  }
  const int k0 = rank * depth;
  const int nst = g < 0 ? 0 : (min(depth, K - k0) + KD - 1) / KD;

  // The tiles wholly past a member's width: zeros, written while the first
  // stages are in flight, shared out over the clusters (the p-th padding
  // tile, counted over the members in order, goes to cluster p % T) and
  // their ranks.
  const auto zero_padding = [&]() {
    const int ntile = (N + BN - 1) / BN;
    for (int p = blockIdx.y;; p += T) {
      int i = 0, t = p, first = 0;
      for (; i < G; ++i) {
        first = (live_width(wd, i, N) + BN - 1) / BN;
        if (t < ntile - first) break;
        t -= ntile - first;
      }
      if (i == G) break;
      const long o_base = static_cast<long>(i) * M * N;
      for (int e = rank * CONSUMERS + tid; e < M * BN;
           e += S * CONSUMERS) {
        const int r = e / BN, gc = (first + t) * BN + e % BN;
        if (gc < N)
          store_from_f32(epi.out, o_base + static_cast<long>(r) * N + gc,
                         epi.out_type, 0.0f);
      }
    }
  };
  const auto load = [&](void* dst, uint64_t* bar, int col, int krow) {
    wg::tma_load_3d(dst, &tmw, bar, col, krow, g);
  };
  const long o_base = static_cast<long>(max(g, 0)) * M * N;
  if constexpr (S8) {
    skc::mainloop<false, true>(
        sm, &tmw, static_cast<const signed char*>(X) + max(g, 0) * sx, ldx,
        M, K, k0, depth, nst, n0, n_live, 0, load, zero_padding);
    skc::reduce<false, true>(sm, M, N - n0, g >= 0, [&](int r, int c,
                                                        int v) {
      const int gc = n0 + c;
      static_cast<int*>(epi.out)[o_base + static_cast<long>(r) * N + gc] =
          gc < n_live ? v : 0;
    });
  } else {
    skc::mainloop<BF16ACC, false>(
        sm, &tmw,
        static_cast<const unsigned short*>(X) +
            static_cast<long>(max(g, 0)) * sx,
        ldx, M, K, k0, depth, nst, n0, n_live, rbk, load, zero_padding);
    skc::reduce<BF16ACC, false>(sm, M, N - n0, g >= 0, [&](int r, int c,
                                                           float v) {
      const int gc = n0 + c;
      store_from_f32(epi.out, o_base + static_cast<long>(r) * N + gc,
                     epi.out_type,
                     gc < n_live ? apply_epi<BF16ACC>(v, r, gc, epi) : 0.0f);
    });
  }
}

}  // namespace

// bf16acc: a bf16 accumulator, rounded once per rbk-deep block (a multiple
// of 16) of each slice, alpha and softcap already bf16 values; rbk is not
// read otherwise.
extern "C" int grouped_gemm_splitk_launch(
    const void* x, const void* w, void* out, int G, int M, int N, int K,
    long sx, long ldx, int out_type, int n_split, int depth, int n_tiles,
    int bf16acc, int rbk, float alpha, int has_softcap, float softcap,
    int act, int n_widths, const int* widths, void* stream) {
  if (G <= 0 || M <= 0 || M > skc::MAX_M || N <= 0 || N % 8 != 0 ||
      K <= 0 || n_split < 1 || n_split > skc::MAX_SPLIT || depth <= 0 ||
      (bf16acc && (rbk <= 0 || rbk % 16 != 0)) ||
      depth % skc::BK != 0 || static_cast<long>(n_split - 1) * depth >= K ||
      static_cast<long>(n_split) * depth < K || n_tiles < 1 ||
      n_widths < 0 || n_widths > MAX_WIDTHS ||
      (out_type != DT_F32 && out_type != DT_BF16))
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tmw;
  const int e = wg::make_map_3d(&tmw, w, N, K, G, 64, skc::BK);
  if (e != 0) return e;
  Epi epi{alpha, 0.0f, nullptr, 0, nullptr, softcap, has_softcap, act, out,
          N, out_type};
  Widths wd{n_widths, {}};
  for (int i = 0; i < n_widths; ++i) wd.w[i] = widths[i];
  const int smem = skc::smem_bytes(M, depth);
  if (smem > wg::SMEM_LIMIT) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(n_split, n_tiles);
  const auto st = static_cast<cudaStream_t>(stream);
  if (bf16acc)
    return wg::launch_cluster<grouped_splitk_kernel<true, false>>(
        grid, skc::THREADS, n_split, smem, st, tmw, x, sx, ldx, G, M, N, K,
        depth, rbk, epi, wd);
  return wg::launch_cluster<grouped_splitk_kernel<false, false>>(
      grid, skc::THREADS, n_split, smem, st, tmw, x, sx, ldx, G, M, N, K,
      depth, rbk, epi, wd);
}

// int8: x (G, C, K) int8 through its group and row strides, w (G, K, N)
// int8 packed, N % 16 == 0 (TMA's 16-byte rows); out (G, C, N) int32, the
// exact x @ w with the columns past each member's width zero.  depth is a
// multiple of 128; K past wg::S8_MAX_K is refused (an int32 sum could
// overflow).
extern "C" int grouped_gemm_splitk_s8_launch(
    const void* x, const void* w, void* out, int G, int M, int N, int K,
    long sx, long ldx, int n_split, int depth, int n_tiles, int n_widths,
    const int* widths, void* stream) {
  if (G <= 0 || M <= 0 || M > skc::MAX_M || N <= 0 || N % 16 != 0 ||
      K <= 0 || K > wg::S8_MAX_K || n_split < 1 ||
      n_split > skc::MAX_SPLIT || depth <= 0 || depth % skc::BK_S8 != 0 ||
      static_cast<long>(n_split - 1) * depth >= K ||
      static_cast<long>(n_split) * depth < K || n_tiles < 1 ||
      n_widths < 0 || n_widths > MAX_WIDTHS)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tmw;
  const int e = wg::make_map_3d(&tmw, w, N, K, G, BN, skc::BK_S8, 0, 0, 1);
  if (e != 0) return e;
  Epi epi{1.0f, 0.0f, nullptr, 0, nullptr, 0.0f, 0, 0, out, N, DT_I32};
  Widths wd{n_widths, {}};
  for (int i = 0; i < n_widths; ++i) wd.w[i] = widths[i];
  const int smem = skc::smem_bytes(M, depth, 1);
  if (smem > wg::SMEM_LIMIT) return static_cast<int>(cudaErrorInvalidValue);
  return wg::launch_cluster<grouped_splitk_kernel<false, true>>(
      dim3(n_split, n_tiles), skc::THREADS, n_split, smem,
      static_cast<cudaStream_t>(stream), tmw, x, sx, ldx, G, M, N, K, depth,
      0, epi, wd);
}
