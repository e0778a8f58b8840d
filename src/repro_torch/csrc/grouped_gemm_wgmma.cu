// B3 past 16 rows on Hopper (sm_90a): the grouped GEMM on B1's TMA +
// mbarrier + wgmma mainloop (wgmma_mainloop.cuh), counter
// "grouped_gemm_wgmma".
//
// Replaces: src/repro/kernels/grouped_gemm.py, grouped_gemm_pallas /
// _kernel (x (G, C, K) @ w (G, K, N) -> (G, C, N) on a (G, gm, gn, gk)
// grid; the accumulator tile stays in VMEM across the K loop, the K tail
// of both operands is masked, and the epilogue -- no C, no bias -- runs on
// the last K step), for bf16 operands with C > 16: the prefill chunk's
// sibling projections (gate+up, q/k/v) when the graph programs group them,
// the MoE experts (each its own x), core/conv.py, and GroupedGemm's
// backward in bf16.  The decode group (C <= 16) runs the cluster split-K
// kernel (grouped_gemm_splitk.cu); f32 the SIMT f32 mainloop and int8 and
// unaligned shapes the tile loop (grouped_gemm.cu).
//
// What bounds it on the H100: the prefill gate+up group (C = 512, K =
// 2048, N = 16384, two members) does 69 GFLOP at ~240 FLOP per byte of
// device memory, near the bf16 ridge (~295): the tensor-core rate, fed
// from L2 -- B1's regime.  The design is B1's, one launch for the group:
//
// - The group index is on the grid (blockIdx.z); blockIdx.x walks M and
//   blockIdx.y N, so the blocks in flight share a member's column panel.
//   Every member's tiles fill one grid: two gate-sized members make one
//   launch of twice B1's blocks.
// - w (G, K, N) goes through a 3-D tensor map: a box never crosses into
//   the next member's rows, so each member's K tail loads zeros at its own
//   bound (a flat (G*K, N) map would read the next member's first rows).
// - x goes through a 2-D map when its group stride is 0 (the graph
//   programs' broadcast expand: every member reads the one (C, K) matrix,
//   no copy), and through a 3-D map with its row and group strides when
//   each member has its own x (the MoE experts).
// - The epilogue (alpha, softcap, activation; no C, no bias) runs on the
//   accumulator staged by the mainloop and writes out_dtype once, four
//   columns a vector.
// - widths: a tile wholly past its member's width issues no loads and
//   stores zeros; the columns past the width inside a straddling tile come
//   back as zeros.  Up to MAX_WIDTHS members carry a width; the rest use N.
// - bf16acc: the running sum is rounded to bf16 once per rbk rows of K in
//   K order (the mainloop's second register set), as B1's wgmma engine;
//   every epilogue step is rounded.
//
// Requirements (core/geometry.py:grouped_engine; the launcher checks
// them): K and N multiples of 8, 16-byte aligned x and w, x's row and
// group strides multiples of 8 elements.
#include "epilogue.cuh"
#include "wgmma_mainloop.cuh"

namespace {

constexpr int MAX_WIDTHS = 8;

struct Widths {
  int count;
  int w[MAX_WIDTHS];
};

// The epilogue of four columns c .. c + 3 of row r of one member, and
// their one write; columns at or past the member's width are zeros.
template <bool BF16ACC>
struct GroupStore {
  Epi epi;
  int M, N, n_live;
  long base;  // the member's first output element
  __device__ __forceinline__ void operator()(int r, int c, float4 v) const {
    if (r >= M || c >= N) return;  // N % 8 == 0: c < N covers c + 3
    float x[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int e = 0; e < 4; ++e)
      x[e] = c + e < n_live ? apply_epi<BF16ACC>(x[e], r, c + e, epi) : 0.0f;
    const long o = base + static_cast<long>(r) * N + c;  // a multiple of 4
    if (epi.out_type == DT_BF16) {
      const __nv_bfloat162 pair[2] = {__floats2bfloat162_rn(x[0], x[1]),
                                      __floats2bfloat162_rn(x[2], x[3])};
      *reinterpret_cast<uint2*>(static_cast<__nv_bfloat16*>(epi.out) + o) =
          *reinterpret_cast<const uint2*>(pair);
    } else {
      *reinterpret_cast<float4*>(static_cast<float*>(epi.out) + o) =
          make_float4(x[0], x[1], x[2], x[3]);
    }
  }
};

template <int BM, int BN, bool BF16ACC>
__global__ void __launch_bounds__(wg::Cfg<BM, BN>::THREADS, 1)
    grouped_wgmma_kernel(const __grid_constant__ CUtensorMap tmx,
                         const __grid_constant__ CUtensorMap tmw, int M,
                         int N, int K, int rbk, int x3d, Epi epi,
                         Widths widths) {
  const int g = blockIdx.z;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int n_live = g < widths.count ? min(widths.w[g], N) : N;
  const GroupStore<BF16ACC> store{epi, M, N, n_live,
                                  static_cast<long>(g) * M * N};
  if (n0 >= n_live) {
    // Wholly in this member's padding: zeros, no operand read.
    for (int e = threadIdx.x; e < BM * BN; e += wg::Cfg<BM, BN>::THREADS) {
      const long gr = m0 + e / BN, gc = n0 + e % BN;
      if (gr < M && gc < N)
        store_from_f32(epi.out, store.base + gr * N + gc, epi.out_type,
                       0.0f);
    }
    return;
  }
  wg::gemm_tile<BM, BN, false, BF16ACC>(&tmx, &tmw, K, rbk, store, m0, n0,
                                        x3d ? g : -1, g);
}

template <int BM, int BN, bool BF16ACC>
int launch_grouped(const void* x, const void* w, int G, int M, int N, int K,
                   long sx, long ldx, int rbk, const Epi& epi,
                   const Widths& wd, cudaStream_t st) {
  using C = wg::Cfg<BM, BN>;
  CUtensorMap tmx, tmw;
  int e = sx == 0
              ? wg::make_map(&tmx, x, K, M, ldx, wg::WK, BM)
              : wg::make_map_3d(&tmx, x, K, M, G, wg::WK, BM, ldx, sx);
  if (e == 0) e = wg::make_map_3d(&tmw, w, N, K, G, 64, wg::WK);
  if (e != 0) return e;
  auto kernel = grouped_wgmma_kernel<BM, BN, BF16ACC>;
  // This library's own flag (internal linkage): the shared-memory limit is
  // raised once for each of its kernels.
  static bool sized = false;
  if (!sized) {
    const cudaError_t ce = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    if (ce != cudaSuccess) return static_cast<int>(ce);
    sized = true;
  }
  const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN, G);
  kernel<<<grid, C::THREADS, C::SMEM, st>>>(tmx, tmw, M, N, K, rbk, sx != 0,
                                            epi, wd);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int grouped_gemm_wgmma_launch(const void* x, const void* w,
                                         void* out, int G, int M, int N,
                                         int K, long sx, long ldx,
                                         int out_type, int bf16acc, int bm,
                                         int bn, int rbk, float alpha,
                                         int has_softcap, float softcap,
                                         int act, int n_widths,
                                         const int* widths, void* stream) {
  const auto a16 = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  if (G <= 0 || G > 65535 || M <= 0 || N <= 0 || K <= 0 || K % 8 != 0 ||
      N % 8 != 0 || sx % 8 != 0 || ldx % 8 != 0 || !a16(x) || !a16(w) ||
      !a16(out) || rbk <= 0 || rbk % 32 != 0 || n_widths < 0 ||
      n_widths > MAX_WIDTHS || (out_type != DT_F32 && out_type != DT_BF16))
    return (int)cudaErrorInvalidValue;
  Epi epi{alpha, 0.0f, nullptr, 0, nullptr, softcap, has_softcap, act, out,
          N, out_type};
  Widths wd{n_widths, {}};
  for (int i = 0; i < n_widths; ++i) wd.w[i] = widths[i];
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define GW_LAUNCH(BM_, BN_, BA)                                              \
  return launch_grouped<BM_, BN_, BA>(x, w, G, M, N, K, sx, ldx, rbk, epi,  \
                                      wd, st)
#define GW_TILE(BM_, BN_, ACC16)                                             \
  if (bm == BM_ && bn == BN_) {                                              \
    if (bf16acc && ACC16) GW_LAUNCH(BM_, BN_, ACC16);                        \
    if (!bf16acc) GW_LAUNCH(BM_, BN_, false);                                \
    return (int)cudaErrorInvalidValue;                                       \
  }
  GW_TILE(64, 64, true)
  GW_TILE(64, 128, true)
  GW_TILE(64, 256, false)
  GW_TILE(128, 64, true)
  GW_TILE(128, 128, true)
  GW_TILE(128, 256, false)
#undef GW_TILE
#undef GW_LAUNCH
  return (int)cudaErrorInvalidValue;
}
