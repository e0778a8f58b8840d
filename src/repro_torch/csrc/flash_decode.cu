// B6: one-token attention over a flat or ring KV cache, for Hopper
// (sm_90a).
//
// Replaces: src/repro/kernels/flash_decode.py, flash_decode_pallas /
// _kernel (grid (B*Hkv, S/bkv), the kv axis walked sequentially with the
// online-softmax carry in VMEM scratch, positions supplied as data: the
// ring cache's slot -> absolute-position map, -1 for an unwritten slot).
//
// What bounds it on the H100: bytes.  A decode step reads every K/V row of
// the cache once and does 2 FLOP per element per query head (G = 16 for
// recurrentgemma_9b's MQA): at 4 slots x a 2048-slot ring x D = 256 in
// bf16 it reads 8.4 MB, ~2.5 us at 3.35 TB/s.  The design is B4's
// (flash_decode_paged.cu):
// - Every block processes all G query heads of one (sequence, kv head)
//   against each K/V row it loads, so a row is read once, not G times.
// - The KV axis is split across blocks (grid = B*Hkv x n_split, about two
//   blocks per SM in all); each block walks its slice 16 slots at a time
//   with an online softmax and writes its partial state, and the merge
//   pass of decode_combine.cuh writes the output.
// - The cache is read in its stored layout through strides: the serving
//   ring is (B, L, Hkv, D), handed over as its (B, Hkv, L, D) view, so no
//   copy of the cache is made per layer per step.  Only D must be
//   contiguous.
// - The mask is kvpos >= 0, kvpos <= q_pos and, with a window,
//   kvpos > q_pos - window; the softcap applies before it.  A masked slot
//   loads neither K nor V (both read as 0), so an unwritten slot's V can
//   never reach the output, as the Pallas kernel zeroes V rows with
//   kvpos < 0.  A chunk with no visible slot is skipped whole.  A row
//   whose denominator is 0 returns zeros.
// - The TPU's 8-sublane head-group pad, 128-lane softmax scratch and
//   128-multiple kv blocks are gone.
#include "decode_combine.cuh"

namespace {

constexpr int THREADS = decode::THREADS;
constexpr int WARPS = THREADS / 32;
constexpr int CH = 16;      // cache slots per chunk
constexpr int MAXE = 16;    // accumulator elements per thread: G*D <= 4096
constexpr float NEG_INF = decode::NEG_INF;

struct Strides {
  long b, h, s;             // element strides of k or v; D is contiguous
};

// One (sequence, kv head, KV slice): partial softmax state over the slice.
template <typename TKV>
__global__ void __launch_bounds__(THREADS)
    flat_decode_split_kernel(const void* q, int q_type, const TKV* k,
                             const TKV* v, Strides ks_, Strides vs_,
                             const int* kv_pos, const int* q_pos,
                             float* part_m, float* part_l, float* part_acc,
                             int H, int Hkv, int D, int S, int window,
                             int has_softcap, float softcap, float scale,
                             int chunks_per_split) {
  extern __shared__ float smem[];
  const int G = H / Hkv;
  float* qs = smem;                 // [G][D]
  float* kt = qs + G * D;           // [CH][D]
  float* vt = kt + CH * D;          // [CH][D]
  float* ps = vt + CH * D;          // [G][CH]
  float* ms = ps + G * CH;          // [G] running max
  float* ls = ms + G;               // [G] running denominator
  float* as = ls + G;               // [G] this chunk's rescale
  __shared__ int visible[CH];

  const int bh = blockIdx.x, split = blockIdx.y, n_split = gridDim.y;
  const int b = bh / Hkv, kvh = bh % Hkv;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int* row_pos = kv_pos + static_cast<long>(b) * S;
  const TKV* kb = k + b * ks_.b + kvh * ks_.h;
  const TKV* vb = v + b * vs_.b + kvh * vs_.h;

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

  const int qp = q_pos[b];
  const int lo = split * chunks_per_split * CH;
  const int hi = min(S, (split + 1) * chunks_per_split * CH);
  __syncthreads();

  for (int c0 = lo; c0 < hi; c0 += CH) {
    bool vis = false;
    if (tid < CH && c0 + tid < hi) {
      const int kp = row_pos[c0 + tid];
      vis = kp >= 0 && kp <= qp && (window < 0 || kp > qp - window);
    }
    if (tid < CH) visible[tid] = vis;
    if (!__syncthreads_or(vis)) continue;   // nothing visible: skip
    // Gather this chunk's K/V rows (f32); rows not visible read as 0.
    for (int e = tid; e < CH * D; e += THREADS) {
      const int s = e / D, d = e % D;
      float kv = 0.0f, vv = 0.0f;
      if (visible[s]) {
        kv = to_f32(kb[(c0 + s) * ks_.s + d]);
        vv = to_f32(vb[(c0 + s) * vs_.s + d]);
      }
      kt[e] = kv;
      vt[e] = vv;
    }
    __syncthreads();
    // Logits for every (head, slot) pair: one warp per pair.
    for (int pr = warp; pr < G * CH; pr += WARPS) {
      const int g = pr / CH, s = pr % CH;
      float dot = 0.0f;
      for (int d = lane; d < D; d += 32) dot += qs[g * D + d] * kt[s * D + d];
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
      const bool valid = lane < CH && visible[lane];
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
        for (int s = 0; s < CH; ++s) a += ps[g * CH + s] * vt[s * D + d];
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

template <typename TKV>
int launch(const void* q, int q_type, const void* k, const void* v,
           Strides ks_, Strides vs_, const int* kv_pos, const int* q_pos,
           float* part_m, float* part_l, float* part_acc, void* out, int B,
           int H, int Hkv, int D, int S, int window, int has_softcap,
           float softcap, float scale, int n_split, int chunks_per_split,
           cudaStream_t st) {
  const int G = H / Hkv;
  const size_t smem = sizeof(float) * (G * D + 2 * CH * D + G * CH + 3 * G);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        flat_decode_split_kernel<TKV>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  flat_decode_split_kernel<TKV><<<dim3(B * Hkv, n_split), THREADS, smem,
                                  st>>>(
      q, q_type, static_cast<const TKV*>(k), static_cast<const TKV*>(v), ks_,
      vs_, kv_pos, q_pos, part_m, part_l, part_acc, H, Hkv, D, S, window,
      has_softcap, softcap, scale, chunks_per_split);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  return decode::launch_combine(part_m, part_l, part_acc, out, q_type, B, H,
                                Hkv, D, n_split, st);
}

}  // namespace

// q (B, H, D) contiguous; k / v (B, Hkv, S, D) in any layout whose D axis
// is contiguous, given by element strides (b, h, s); kv_pos (B, S) and
// q_pos (B,) int32.  part_m / part_l: (B*Hkv, n_split, G) f32; part_acc:
// (B*Hkv, n_split, G*D) f32 -- scratch the wrapper allocates.  Split s
// covers cache slots [s*chunks_per_split*16, (s+1)*chunks_per_split*16).
extern "C" int flash_decode_launch(
    const void* q, int q_type, const void* k, const void* v, int kv_type,
    long k_sb, long k_sh, long k_ss, long v_sb, long v_sh, long v_ss,
    const void* kv_pos, const void* q_pos, void* part_m, void* part_l,
    void* part_acc, void* out, int B, int H, int Hkv, int D, int S,
    int window, int has_softcap, float softcap, float scale, int n_split,
    int chunks_per_split, void* stream) {
  if (B <= 0 || Hkv <= 0 || S <= 0 || H % Hkv != 0 ||
      (H / Hkv) * D > MAXE * THREADS || n_split <= 0 ||
      chunks_per_split <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Strides ks_{k_sb, k_sh, k_ss}, vs_{v_sb, v_sh, v_ss};
  const int* kp = static_cast<const int*>(kv_pos);
  const int* qp = static_cast<const int*>(q_pos);
  float* pm = static_cast<float*>(part_m);
  float* pl = static_cast<float*>(part_l);
  float* pa = static_cast<float*>(part_acc);
#define ARGS                                                               \
  q, q_type, k, v, ks_, vs_, kp, qp, pm, pl, pa, out, B, H, Hkv, D, S,     \
      window, has_softcap, softcap, scale, n_split, chunks_per_split, st
  switch (kv_type) {
    case DT_F32: return launch<float>(ARGS);
    case DT_BF16: return launch<__nv_bfloat16>(ARGS);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef ARGS
}
