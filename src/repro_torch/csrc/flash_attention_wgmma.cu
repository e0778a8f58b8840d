// B5's wgmma engine: blocked (flash) attention on TMA + wgmma for Hopper
// (sm_90a), bf16 at head dims 64, 128 and 256.
//
// Replaces, for bf16 q/k/v at those head dims:
// src/repro/kernels/flash_attention.py, flash_attention_pallas /
// _attn_kernel (grid (B*H, q blocks, kv blocks) with the kv axis walked in
// order, online softmax carried in VMEM scratch, right-aligned queries,
// causal / window / softcap masks, wholly masked kv blocks skipped, GQA by
// an index fold).  fp32 and other head dims stay on the SIMT kernel
// (flash_attention.cu); core/geometry.py:attention_engine chooses.
//
// What bounds it on the H100: operations.  A prefill chunk (512 queries of
// 8 heads against 512-1024 positions, D = 256) does ~4*D FLOP per visible
// (query, key) pair for 2*D bytes per key read -- hundreds of FLOP per
// byte.  The SIMT kernel ran them as f32 FMAs at ~5 TFLOP/s; here both
// products run on the tensor cores:
//
// - Block: one CTA per (batch*head, 64-query tile): one consumer
//   warpgroup (128 threads) and one producer warp.  The producer's one
//   thread loads Q once (D/64 boxes of 64 x 64) and then K and V in
//   64-row tiles into a 2-stage ring, each tile D/64 boxes, all by TMA in
//   the 128-byte swizzle, each with its own mbarrier (K's product starts
//   before V lands); the consumers free a stage after its PV product.  At
//   D = 256: Q 32 KB + 2 x (32 + 32) KB + P 8 KB = 168 KB.  The maps are
//   3-D over (batch*heads, S, D), so a box never reads into the next head
//   and rows past Sq or Skv come back as zeros.
// - S = Q K^T: wgmma m64n64k16, D/16 of them, Q as A (K-major) and the K
//   tile as a K-major B (B1's TRANS_B layout).  S stays in registers
//   (32 f32 a thread).
// - Softmax in registers: scale, softcap (tanh), and the masks -- only on
//   kv tiles that the causal diagonal, the window edge or a ragged Skv
//   cross -- then the online update; a row's max and sum are taken across
//   the four threads that hold it (shuffles).  Masked entries are -inf,
//   the running max starts at -1e30, so a fully masked row keeps l = 0 and
//   returns zeros.
// - P is rounded to bf16 and staged in shared memory (8 KB, the 128-byte
//   swizzle written by hand), so O += P V is one more shared-memory wgmma:
//   m64nDk16 with the (kv, D) row-major V tile as an MN-major B through
//   the transpose bit (B1's main-path B).  Deviation from the JAX
//   kernel, which keeps P in f32 for PV: P is bf16 here (the row sum l is
//   taken over the same rounded P).
// - O stays in registers (64 x D f32: D/2 a thread, 128 at D = 256) until
//   it is divided by l and written as bf16.
// - The kv loop starts and stops where the masks allow (as the SIMT
//   kernel).  GQA: a query head reads kv head h / (H / Hkv) by index; two
//   heads of one kv group do not share a ring yet (L2 absorbs the re-read).
// - kv split: a prefill chunk's grid, (batch*heads) x (query tiles), is 64
//   CTAs for gemma_2b on 132 SMs, and under the causal mask the last
//   query tile walks twice the kv tiles of the first.  With kv_split = 2
//   (core/geometry.py:attention_kv_split, where twice the grid still fits
//   the card) the two CTAs of a cluster take the two halves of a query
//   tile's kv tiles, and rank 1 hands its (m, l, O) to rank 0 through
//   distributed shared memory, which merges them as decode_combine.cuh
//   does and writes the tile: one launch, a fixed merge order.
// - Not yet: loads overlapping the softmax beyond the 2-stage ring, two
//   consumer warpgroups, P from registers.
#include <math_constants.h>

#include "wgmma_mainloop.cuh"

namespace {

constexpr int BQ = 64;                  // queries of one CTA
constexpr int BKV = 64;                 // keys of one kv tile
constexpr int CONSUMERS = 128;
constexpr int THREADS = CONSUMERS + 32;
constexpr int BOX = 64 * 64 * 2;        // one 64 x 64 bf16 TMA box
constexpr int STAGES = 2;
constexpr float M_INIT = -1e30f;

template <int D>
struct AttnCfg {
  static_assert(D == 64 || D == 128 || D == 256, "D is 64, 128 or 256");
  static constexpr int CH = D / 64;               // 64-wide chunks of D
  static constexpr int TILE = CH * BOX;           // Q, or one K or V tile
  static constexpr int SMEM =
      1024 + TILE + STAGES * 2 * TILE + BOX + 8 * (1 + 3 * STAGES);
  static_assert(SMEM <= wg::SMEM_LIMIT, "shared memory");
};

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
    flash_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       __nv_bfloat16* out, int H, int Hkv, int Sq, int Skv,
                       int causal, int window, int has_softcap,
                       float softcap, float scale, int kv_split) {
  using C = AttnCfg<D>;
  extern __shared__ __align__(1024) unsigned char smem[];
  unsigned char* qs = smem + ((1024 - (wg::smem_u32(smem) & 1023)) & 1023);
  unsigned char* kvs = qs + C::TILE;  // stage s: K, then V
  unsigned char* ps = kvs + STAGES * 2 * C::TILE;
  uint64_t* qfull = reinterpret_cast<uint64_t*>(ps + BOX);
  uint64_t* kfull = qfull + 1;
  uint64_t* vfull = kfull + STAGES;
  uint64_t* empty = vfull + STAGES;

  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int kvb = b * Hkv + h / (H / Hkv);
  const int q0 = blockIdx.y * BQ, offs = Skv - Sq;
  const int q_first = q0 + offs, q_last = min(q0 + BQ, Sq) - 1 + offs;
  const int kv_hi = causal ? min(Skv, q_last + 1) : Skv;
  const int kv_lo = window >= 0 ? max(0, q_first - window + 1) : 0;
  const int nt_all = kv_hi > kv_lo ? (kv_hi + BKV - 1) / BKV - kv_lo / BKV
                                   : 0;
  // Under a kv split, cluster rank z walks the z-th part of those tiles.
  const int rank = blockIdx.z, per = (nt_all + kv_split - 1) / kv_split;
  const int t_lo = kv_lo / BKV + rank * per;
  const int nt = max(0, min(per, nt_all - rank * per));

  if (threadIdx.x == 0) {
    wg::mbar_init(qfull, 1);
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      wg::mbar_init(&kfull[s], 1);
      wg::mbar_init(&vfull[s], 1);
      wg::mbar_init(&empty[s], CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int warp = __shfl_sync(0xffffffffu, threadIdx.x / 32, 0);
  if (warp == CONSUMERS / 32) {
    if (threadIdx.x == CONSUMERS) {
      wg::mbar_expect_tx(qfull, C::TILE);
#pragma unroll
      for (int c = 0; c < C::CH; ++c)
        wg::tma_load_3d(qs + c * BOX, &tq, qfull, 64 * c, q0, bh);
      for (int it = 0; it < nt; ++it) {
        const int s = it % STAGES;
        const int j0 = (t_lo + it) * BKV;
        wg::mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
        unsigned char* ks = kvs + s * 2 * C::TILE;
        wg::mbar_expect_tx(&kfull[s], C::TILE);
#pragma unroll
        for (int c = 0; c < C::CH; ++c)
          wg::tma_load_3d(ks + c * BOX, &tk, &kfull[s], 64 * c, j0, kvb);
        wg::mbar_expect_tx(&vfull[s], C::TILE);
#pragma unroll
        for (int c = 0; c < C::CH; ++c)
          wg::tma_load_3d(ks + C::TILE + c * BOX, &tv, &vfull[s], 64 * c, j0,
                          kvb);
      }
    }
    if (kv_split > 1) {  // the merge's two cluster barriers
      wg::cluster_arrive();
      wg::cluster_wait();
      wg::cluster_arrive();
      wg::cluster_wait();
    }
    return;
  }

  // The consumer warpgroup.  Accumulator layout of m64nNk16: warp w holds
  // rows 16w + lane/4 (+8); register 4j + 2h + c is column 8j + 2(lane%4)
  // + c of row half h.
  const int lane = threadIdx.x & 31, gid = lane >> 2, tq4 = lane & 3;
  constexpr int R = D / 2;
  float o[R];
#pragma unroll
  for (int i = 0; i < R; ++i) o[i] = 0.0f;
  float m[2] = {M_INIT, M_INIT}, l[2] = {0.0f, 0.0f};
  const uint32_t qa = wg::smem_u32(qs), pa = wg::smem_u32(ps);
  wg::mbar_wait(qfull, 0);

  for (int it = 0; it < nt; ++it) {
    const int s = it % STAGES;
    const uint32_t par = (it / STAGES) & 1;
    const int j0 = (t_lo + it) * BKV;
    const uint32_t ka = wg::smem_u32(kvs + s * 2 * C::TILE);
    const uint32_t va = ka + C::TILE;

    // S = Q K^T.
    float sacc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sacc[i] = 0.0f;
    wg::mbar_wait(&kfull[s], par);
    wg::fence_regs<32>(sacc);
    wg::wgmma_fence();
#pragma unroll
    for (int c = 0; c < C::CH; ++c)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wg::Mma<64, 0>::run(sacc, wg::desc(qa + c * BOX + kk * 32, 16, 1024),
                            wg::desc(ka + c * BOX + kk * 32, 16, 1024),
                            (c | kk) != 0);
    wg::wgmma_commit();
    wg::wgmma_wait<0>();
    wg::fence_regs<32>(sacc);

    // Scale, softcap, masks, and the tile's row max.
    const bool edge = j0 + BKV > Skv ||
                      (causal && j0 + BKV - 1 > q_first) ||
                      (window >= 0 && j0 <= q_last - window);
    float mt[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int hh = (i >> 1) & 1;
      float x = sacc[i] * scale;
      if (has_softcap) x = softcap * tanhf(x / softcap);
      if (edge) {
        const int q_pos = q0 + 16 * warp + gid + 8 * hh + offs;
        const int kv = j0 + 8 * (i >> 2) + 2 * tq4 + (i & 1);
        const bool ok = kv < Skv && (!causal || kv <= q_pos) &&
                        (window < 0 || kv > q_pos - window);
        if (!ok) x = -CUDART_INF_F;
      }
      sacc[i] = x;
      mt[hh] = fmaxf(mt[hh], x);
    }
    float alpha[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      mt[hh] = fmaxf(mt[hh], __shfl_xor_sync(0xffffffffu, mt[hh], 1));
      mt[hh] = fmaxf(mt[hh], __shfl_xor_sync(0xffffffffu, mt[hh], 2));
      const float m_new = fmaxf(m[hh], mt[hh]);
      alpha[hh] = __expf(m[hh] - m_new);
      m[hh] = m_new;
    }

    // P = exp(S - m) in bf16 into shared memory, in the 128-byte swizzle
    // wgmma reads (16-byte chunk j of row r at chunk j ^ (r % 8)).  The
    // previous tile's PV product has retired in every warp before any
    // warp overwrites P.
    wg::consumer_sync<CONSUMERS>();
    float rs[2] = {0.0f, 0.0f};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int i = 4 * j + 2 * hh;
        const __nv_bfloat162 pb = __floats2bfloat162_rn(
            __expf(sacc[i] - m[hh]), __expf(sacc[i + 1] - m[hh]));
        rs[hh] += __low2float(pb) + __high2float(pb);
        const int row = 16 * warp + gid + 8 * hh;
        *reinterpret_cast<__nv_bfloat162*>(
            ps + row * 128 + ((j ^ (row & 7)) << 4) + 4 * tq4) = pb;
      }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      rs[hh] += __shfl_xor_sync(0xffffffffu, rs[hh], 1);
      rs[hh] += __shfl_xor_sync(0xffffffffu, rs[hh], 2);
      l[hh] = alpha[hh] * l[hh] + rs[hh];
    }
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) o[4 * j + c] *= alpha[c >> 1];
    wg::fence_proxy_async();
    wg::consumer_sync<CONSUMERS>();

    // O += P V.
    wg::mbar_wait(&vfull[s], par);
    wg::fence_regs<R>(o);
    wg::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wg::Mma<D, 1>::run(o, wg::desc(pa + kk * 32, 16, 1024),
                         wg::desc(va + kk * 2048, BOX, 1024), 1);
    wg::wgmma_commit();
    wg::wgmma_wait<0>();
    wg::fence_regs<R>(o);
    wg::mbar_arrive(&empty[s]);
  }

  if (kv_split > 1) {
    // Merge the two halves' (m, l, O), as decode_combine.cuh does, through
    // distributed shared memory: rank 1 leaves them in its idle K/V ring
    // (thread-major, so the reads are conflict-free), rank 0 reads them
    // after a cluster barrier and writes the output.
    float* xch = reinterpret_cast<float*>(kvs);
    const int tid = threadIdx.x;
    wg::consumer_sync<CONSUMERS>();  // every warp is done with the ring
    if (rank == 1) {
#pragma unroll
      for (int i = 0; i < R; ++i) xch[i * CONSUMERS + tid] = o[i];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        xch[(R + hh) * CONSUMERS + tid] = m[hh];
        xch[(R + 2 + hh) * CONSUMERS + tid] = l[hh];
      }
    }
    wg::cluster_arrive();
    wg::cluster_wait();
    if (rank == 1) {
      wg::cluster_arrive();
      wg::cluster_wait();
      return;
    }
    float a0[2], a1[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const float m1 = wg::ld_cluster(xch + (R + hh) * CONSUMERS + tid, 1);
      const float l1 =
          wg::ld_cluster(xch + (R + 2 + hh) * CONSUMERS + tid, 1);
      const float m_new = fmaxf(m[hh], m1);
      a0[hh] = __expf(m[hh] - m_new);
      a1[hh] = __expf(m1 - m_new);
      l[hh] = a0[hh] * l[hh] + a1[hh] * l1;
    }
#pragma unroll
    for (int i0 = 0; i0 < R; i0 += 16) {
      float t[16];
#pragma unroll
      for (int i = 0; i < 16; ++i)
        t[i] = wg::ld_cluster(xch + (i0 + i) * CONSUMERS + tid, 1);
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int hh = ((i0 + i) >> 1) & 1;
        o[i0 + i] = o[i0 + i] * a0[hh] + t[i] * a1[hh];
      }
    }
    wg::cluster_arrive();  // rank 1 may leave once the wait below is met
  }

  const long obase = static_cast<long>(bh) * Sq;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int qrow = q0 + 16 * warp + gid + 8 * hh;
    if (qrow >= Sq) continue;
    const float inv = l[hh] == 0.0f ? 0.0f : 1.0f / l[hh];
    __nv_bfloat16* orow = out + (obase + qrow) * D + 2 * tq4;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) =
          __floats2bfloat162_rn(o[4 * j + 2 * hh] * inv,
                                o[4 * j + 2 * hh + 1] * inv);
  }
  if (kv_split > 1) wg::cluster_wait();
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int H, int Hkv, int Sq, int Skv, int causal, int window,
           int has_softcap, float softcap, float scale, int kv_split,
           cudaStream_t st) {
  using C = AttnCfg<D>;
  CUtensorMap tq, tk, tv;
  int e = wg::make_map_3d(&tq, q, D, Sq, static_cast<long>(B) * H, 64, BQ);
  if (e == 0)
    e = wg::make_map_3d(&tk, k, D, Skv, static_cast<long>(B) * Hkv, 64, BKV);
  if (e == 0)
    e = wg::make_map_3d(&tv, v, D, Skv, static_cast<long>(B) * Hkv, 64, BKV);
  if (e != 0) return e;
  auto kernel = flash_wgmma_kernel<D>;
  static bool sized = false;
  if (!sized) {
    const cudaError_t ce = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    if (ce != cudaSuccess) return static_cast<int>(ce);
    sized = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * H, (Sq + BQ - 1) / BQ, kv_split);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = C::SMEM;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = kv_split;
  cfg.attrs = attr;
  cfg.numAttrs = kv_split > 1 ? 1 : 0;
  const cudaError_t le = cudaLaunchKernelEx(
      &cfg, kernel, tq, tk, tv, static_cast<__nv_bfloat16*>(out), H, Hkv, Sq,
      Skv, causal, window, has_softcap, softcap, scale, kv_split);
  if (le != cudaSuccess) return static_cast<int>(le);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int flash_attention_wgmma_launch(const void* q, const void* k,
                                            const void* v, void* out, int B,
                                            int H, int Hkv, int Sq, int Skv,
                                            int D, int causal, int window,
                                            int has_softcap, float softcap,
                                            float scale, int kv_split,
                                            void* stream) {
  if (B <= 0 || Sq <= 0 || Skv <= 0 || Sq > Skv || Hkv <= 0 ||
      H % Hkv != 0 || kv_split < 1 || kv_split > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return launch<64>(q, k, v, out, B, H, Hkv, Sq, Skv, causal, window,
                        has_softcap, softcap, scale, kv_split, st);
    case 128:
      return launch<128>(q, k, v, out, B, H, Hkv, Sq, Skv, causal, window,
                         has_softcap, softcap, scale, kv_split, st);
    case 256:
      return launch<256>(q, k, v, out, B, H, Hkv, Sq, Skv, causal, window,
                         has_softcap, softcap, scale, kv_split, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
