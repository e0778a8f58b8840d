// B4: one-token attention over the paged KV pool, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/flash_decode.py, flash_decode_paged_pallas /
// _paged_kernel (grid (B*Hkv, max_pages), one physical page per sequential
// grid step through the scalar-prefetched page table, online softmax over
// the G = H/Hkv query heads of a kv head in VMEM scratch).
//
// What bounds it on the H100: bytes.  Each decode step reads every live KV
// element of every sequence once and does 2 FLOP per element per query
// head (G = 8 for gemma_2b's MQA) -- ~4 FLOP/B in bf16.  The design:
// - Every block processes all G query heads of one (sequence, kv head)
//   against each K/V row it loads, so a page is read from device memory
//   once, not once per query head.
// - The sequence's KV axis is split across blocks (grid = B*Hkv x
//   n_split): with 4 slots and one kv head, one block per (sequence, kv
//   head) would keep 4 of 132 SMs busy walking ~65 chunks in order.  Each
//   block walks its slice 16 logical positions at a time with an online
//   softmax and writes its partial (max, denominator, accumulator); a
//   second small kernel merges the slices of a (sequence, kv head).
// - Each block reads its own page-table row.  Only positions the mask
//   can reach are loaded (the sequence's length; the window when there is
//   one): a slice wholly outside writes an empty partial.  A -1 table
//   entry clamps to page 0 and is masked.  int8 pages are dequantized in
//   the kernel with their (page, slot, head) scale.  A row whose softmax
//   denominator is 0 returns zeros.
// - The TPU's 8-sublane head-group pad and 128-lane softmax scratch are
//   gone: running max and sum live in shared memory per head, the output
//   accumulator in registers.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int CH = 16;      // logical positions per chunk
constexpr int MAXE = 16;    // accumulator elements per thread: G*D <= 4096
constexpr float NEG_INF = -1e30f;

// One (sequence, kv head, KV slice): partial softmax state over the slice.
template <typename TKV>
__global__ void __launch_bounds__(THREADS)
    paged_decode_split_kernel(const void* q, int q_type, const TKV* k_pages,
                              const TKV* v_pages, const float* k_scale,
                              const float* v_scale, const int* page_table,
                              const int* seq_lens, float* part_m,
                              float* part_l, float* part_acc, int H, int Hkv,
                              int D, int page, int maxp, int window,
                              int has_softcap, float softcap, float scale,
                              int chunks_per_split) {
  extern __shared__ float smem[];
  const int G = H / Hkv;
  float* qs = smem;                 // [G][D]
  float* ks = qs + G * D;           // [CH][D]
  float* vs = ks + CH * D;          // [CH][D]
  float* ps = vs + CH * D;          // [G][CH]
  float* ms = ps + G * CH;          // [G] running max
  float* ls = ms + G;               // [G] running denominator
  float* as = ls + G;               // [G] this chunk's rescale

  const int bh = blockIdx.x, split = blockIdx.y, n_split = gridDim.y;
  const int b = bh / Hkv, kvh = bh % Hkv;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int* row = page_table + static_cast<long>(b) * maxp;

  for (int e = tid; e < G * D; e += THREADS)
    qs[e] = load_as_f32(q, (static_cast<long>(b) * H + kvh * G) * D + e,
                        q_type);
  for (int g = tid; g < G; g += THREADS) {
    ms[g] = NEG_INF;
    ls[g] = 0.0f;
  }
  float acc[MAXE];
#pragma unroll
  for (int i = 0; i < MAXE; ++i) acc[i] = 0.0f;

  const int seq_len = seq_lens[b];
  const int hi = min(min(seq_len, maxp * page),
                     (split + 1) * chunks_per_split * CH);
  const int lo = max(window >= 0 ? max(0, seq_len - window) : 0,
                     split * chunks_per_split * CH);
  __syncthreads();

  for (int c0 = (lo / CH) * CH; c0 < hi; c0 += CH) {
    // Gather this chunk's K/V rows (dequantized, f32); masked rows are 0.
    for (int e = tid; e < CH * D; e += THREADS) {
      const int s = e / D, d = e % D;
      const int pos = c0 + s;
      float kv = 0.0f, vv = 0.0f;
      if (pos >= lo && pos < hi) {
        const int phys = row[pos / page];
        if (phys >= 0) {
          const long slot =
              (static_cast<long>(phys) * page + pos % page) * Hkv + kvh;
          kv = to_f32(k_pages[slot * D + d]);
          vv = to_f32(v_pages[slot * D + d]);
          if (k_scale != nullptr) {
            kv *= k_scale[slot];
            vv *= v_scale[slot];
          }
        }
      }
      ks[e] = kv;
      vs[e] = vv;
    }
    __syncthreads();
    // Logits for every (head, position) pair: one warp per pair.
    for (int pr = warp; pr < G * CH; pr += WARPS) {
      const int g = pr / CH, s = pr % CH;
      float dot = 0.0f;
      for (int d = lane; d < D; d += 32) dot += qs[g * D + d] * ks[s * D + d];
      dot = warp_sum(dot);
      if (lane == 0) {
        float logit = dot * scale;
        if (has_softcap) logit = softcap * tanhf(logit / softcap);
        ps[g * CH + s] = logit;
      }
    }
    __syncthreads();
    // Online-softmax update per head.
    for (int g = warp; g < G; g += WARPS) {
      const int pos = c0 + lane;
      bool valid = lane < CH && pos >= lo && pos < hi;
      if (valid) valid = row[pos / page] >= 0;
      const float logit = valid ? ps[g * CH + lane] : NEG_INF;
      const float m_prev = ms[g];
      const float m_new = fmaxf(m_prev, warp_max(logit));
      const float p = valid ? expf(logit - m_new) : 0.0f;
      const float sum = warp_sum(p);
      if (lane < CH) ps[g * CH + lane] = p;
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        as[g] = alpha;
        ls[g] = alpha * ls[g] + sum;
        ms[g] = m_new;
      }
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < MAXE; ++i) {
      const int e = tid + i * THREADS;
      if (e < G * D) {
        const int g = e / D, d = e % D;
        float a = acc[i] * as[g];
#pragma unroll
        for (int s = 0; s < CH; ++s) a += ps[g * CH + s] * vs[s * D + d];
        acc[i] = a;
      }
    }
    __syncthreads();
  }
  const long part = static_cast<long>(bh) * n_split + split;
#pragma unroll
  for (int i = 0; i < MAXE; ++i) {
    const int e = tid + i * THREADS;
    if (e < G * D) part_acc[part * G * D + e] = acc[i];
  }
  for (int g = tid; g < G; g += THREADS) {
    part_m[part * G + g] = ms[g];
    part_l[part * G + g] = ls[g];
  }
}

// Merge the KV slices of one (sequence, kv head) and write the output:
// one thread per output element, THREADS of them per block (grid = B*Hkv x
// the G*D elements in blocks of THREADS).
__global__ void __launch_bounds__(THREADS)
    paged_decode_combine_kernel(const float* part_m, const float* part_l,
                                const float* part_acc, void* out,
                                int out_type, int H, int Hkv, int D,
                                int n_split) {
  const int bh = blockIdx.x;
  const int b = bh / Hkv, kvh = bh % Hkv;
  const int G = H / Hkv;
  const long base = static_cast<long>(bh) * n_split;
  const int e = blockIdx.y * THREADS + threadIdx.x;
  if (e < G * D) {
    const int g = e / D;
    float m = NEG_INF;
    for (int s = 0; s < n_split; ++s)
      m = fmaxf(m, part_m[(base + s) * G + g]);
    float l = 0.0f, a = 0.0f;
    for (int s = 0; s < n_split; ++s) {
      const float w = expf(part_m[(base + s) * G + g] - m);
      l += w * part_l[(base + s) * G + g];
      a += w * part_acc[(base + s) * G * D + e];
    }
    store_from_f32(out, (static_cast<long>(b) * H + kvh * G) * D + e,
                   out_type, a / (l == 0.0f ? 1.0f : l));
  }
}

template <typename TKV>
int launch(const void* q, int q_type, const void* kp, const void* vp,
           const float* ksc, const float* vsc, const int* table,
           const int* lens, float* part_m, float* part_l, float* part_acc,
           void* out, int B, int H, int Hkv, int D, int page, int maxp,
           int window, int has_softcap, float softcap, float scale,
           int n_split, int chunks_per_split, cudaStream_t st) {
  const int G = H / Hkv;
  const size_t smem = sizeof(float) * (G * D + 2 * CH * D + G * CH + 3 * G);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        paged_decode_split_kernel<TKV>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  paged_decode_split_kernel<TKV><<<dim3(B * Hkv, n_split), THREADS, smem,
                                   st>>>(
      q, q_type, static_cast<const TKV*>(kp), static_cast<const TKV*>(vp),
      ksc, vsc, table, lens, part_m, part_l, part_acc, H, Hkv, D, page, maxp,
      window, has_softcap, softcap, scale, chunks_per_split);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 merge_grid(B * Hkv, (G * D + THREADS - 1) / THREADS);
  paged_decode_combine_kernel<<<merge_grid, THREADS, 0, st>>>(
      part_m, part_l, part_acc, out, q_type, H, Hkv, D, n_split);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// part_m / part_l: (B*Hkv, n_split, G) f32; part_acc: (B*Hkv, n_split,
// G*D) f32 -- scratch the wrapper allocates.  Split s covers logical
// positions [s*chunks_per_split*16, (s+1)*chunks_per_split*16).
extern "C" int flash_decode_paged_launch(
    const void* q, int q_type, const void* k_pages, const void* v_pages,
    int kv_type, const void* k_scale, const void* v_scale,
    const void* page_table, const void* seq_lens, void* part_m,
    void* part_l, void* part_acc, void* out, int B, int H, int Hkv, int D,
    int page, int maxp, int window, int has_softcap, float softcap,
    float scale, int n_split, int chunks_per_split, void* stream) {
  if (B <= 0 || Hkv <= 0 || H % Hkv != 0 ||
      (H / Hkv) * D > MAXE * THREADS || n_split <= 0 ||
      chunks_per_split <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* ksc = static_cast<const float*>(k_scale);
  const float* vsc = static_cast<const float*>(v_scale);
  const int* table = static_cast<const int*>(page_table);
  const int* lens = static_cast<const int*>(seq_lens);
  float* pm = static_cast<float*>(part_m);
  float* pl = static_cast<float*>(part_l);
  float* pa = static_cast<float*>(part_acc);
#define ARGS                                                              \
  q, q_type, k_pages, v_pages, ksc, vsc, table, lens, pm, pl, pa, out, B, \
      H, Hkv, D, page, maxp, window, has_softcap, softcap, scale, n_split, \
      chunks_per_split, st
  switch (kv_type) {
    case DT_F32: return launch<float>(ARGS);
    case DT_BF16: return launch<__nv_bfloat16>(ARGS);
    case DT_I8: return launch<int8_t>(ARGS);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef ARGS
}
