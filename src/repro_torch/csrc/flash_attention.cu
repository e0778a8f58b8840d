// B5: blocked (flash) attention for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/flash_attention.py, flash_attention_pallas /
// _attn_kernel (grid (B*H, q blocks, kv blocks) with the kv axis walked in
// order, online softmax carried in VMEM scratch, right-aligned queries,
// causal / window / softcap masks, wholly masked kv blocks skipped, GQA by
// an index fold).
//
// What bounds it on the H100: operations.  The prefill chunks it serves
// (512 queries of 8 heads against 512-1024 cached positions, D = 256) do
// ~2*Sq*Skv*D FLOP per head for Sq*D + Skv*D elements read -- hundreds of
// FLOP per byte, far above the ridge.  This first kernel runs those
// FLOPs as f32 FMAs on the SIMT cores (67 TFLOP/s), not on the tensor
// cores; moving QK^T and PV to wgmma is later work.  The design: one
// 256-thread block per (batch*head, 16-query tile) loops over 32-row kv
// blocks inside the block (the TPU's sequential kv grid axis), starting
// and stopping at the first and last block the causal and window masks
// can reach.  Queries are right-aligned (q_pos = row + Skv - Sq).  A query
// head reads the K/V of kv head h / (H / Hkv) -- GQA folded by index,
// never by repeating K/V.  K and V rows past Skv load as 0.  Shared rows
// of Q and K are padded by one word so the QK^T dot products read
// conflict-free.  At D = 256 the tiles need ~84 KB of shared memory, above
// the 48 KB default: the launch raises the limit with cudaFuncSetAttribute
// and reports a refused launch through cudaGetLastError.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int BQ = 16;
constexpr int BKV = 32;
constexpr int MAXD = 256;
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ bool visible(int kv_pos, int q_pos, int skv,
                                        int causal, int window) {
  bool ok = kv_pos < skv;
  if (causal) ok = ok && kv_pos <= q_pos;
  if (window >= 0) ok = ok && kv_pos > q_pos - window;
  return ok;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    flash_attention_kernel(const T* q, const T* k, const T* v, T* out, int H,
                           int Hkv, int Sq, int Skv, int D, int causal,
                           int window, int has_softcap, float softcap,
                           float scale) {
  extern __shared__ float smem[];
  const int LQ = D + 1;
  float* qs = smem;                  // [BQ][D+1]
  float* ks = qs + BQ * LQ;          // [BKV][D+1]
  float* vs = ks + BKV * LQ;         // [BKV][D]
  float* ps = vs + BKV * D;          // [BQ][BKV]
  float* ms = ps + BQ * BKV;         // [BQ]
  float* ls = ms + BQ;               // [BQ]
  float* as = ls + BQ;               // [BQ]

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int kvh = h / (H / Hkv);
  const int q0 = blockIdx.y * BQ;
  const int offs = Skv - Sq;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const long qbase = (static_cast<long>(bh) * Sq) * D;
  const long kvbase = (static_cast<long>(b) * Hkv + kvh) * Skv * D;

  for (int e = tid; e < BQ * D; e += THREADS) {
    const int r = e / D, d = e % D;
    qs[r * LQ + d] = (q0 + r < Sq) ? to_f32(q[qbase + (q0 + r) * D + d])
                                   : 0.0f;
  }
  for (int r = tid; r < BQ; r += THREADS) {
    ms[r] = NEG_INF;
    ls[r] = 0.0f;
  }
  float acc[BQ];
#pragma unroll
  for (int r = 0; r < BQ; ++r) acc[r] = 0.0f;

  const int q_first = q0 + offs;
  const int q_last = min(q0 + BQ, Sq) - 1 + offs;
  const int kv_hi = causal ? min(Skv, q_last + 1) : Skv;
  const int kv_lo = window >= 0 ? max(0, q_first - window + 1) : 0;
  __syncthreads();

  for (int j0 = (kv_lo / BKV) * BKV; j0 < kv_hi; j0 += BKV) {
    for (int e = tid; e < BKV * D; e += THREADS) {
      const int r = e / D, d = e % D;
      const bool in = j0 + r < Skv;
      const long g = kvbase + static_cast<long>(j0 + r) * D + d;
      ks[r * LQ + d] = in ? to_f32(k[g]) : 0.0f;
      vs[r * D + d] = in ? to_f32(v[g]) : 0.0f;
    }
    __syncthreads();
    {
      const int i = tid / 16;
      for (int j = tid % 16; j < BKV; j += 16) {
        float dot = 0.0f;
        for (int d = 0; d < D; ++d) dot += qs[i * LQ + d] * ks[j * LQ + d];
        float logit = dot * scale;
        if (has_softcap) logit = softcap * tanhf(logit / softcap);
        ps[i * BKV + j] = logit;
      }
    }
    __syncthreads();
    for (int i = warp; i < BQ; i += WARPS) {
      const int q_pos = q0 + i + offs;
      const bool ok = (q0 + i < Sq) &&
                      visible(j0 + lane, q_pos, Skv, causal, window);
      const float logit = ok ? ps[i * BKV + lane] : NEG_INF;
      const float m_prev = ms[i];
      const float m_new = fmaxf(m_prev, warp_max(logit));
      const float p = ok ? expf(logit - m_new) : 0.0f;
      const float sum = warp_sum(p);
      ps[i * BKV + lane] = p;
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        as[i] = alpha;
        ls[i] = alpha * ls[i] + sum;
        ms[i] = m_new;
      }
    }
    __syncthreads();
    if (tid < D) {
#pragma unroll
      for (int i = 0; i < BQ; ++i) {
        float a = acc[i] * as[i];
#pragma unroll 8
        for (int j = 0; j < BKV; ++j) a += ps[i * BKV + j] * vs[j * D + tid];
        acc[i] = a;
      }
    }
    __syncthreads();
  }
  if (tid < D) {
#pragma unroll
    for (int i = 0; i < BQ; ++i) {
      if (q0 + i >= Sq) break;
      const float l = ls[i] == 0.0f ? 1.0f : ls[i];
      out[qbase + (q0 + i) * D + tid] = from_f32<T>(acc[i] / l);
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int H, int Hkv, int Sq, int Skv, int D, int causal, int window,
           int has_softcap, float softcap, float scale, cudaStream_t st) {
  const size_t smem = sizeof(float) *
      (BQ * (D + 1) + BKV * (D + 1) + BKV * D + BQ * BKV + 3 * BQ);
  cudaError_t e = cudaFuncSetAttribute(
      flash_attention_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid(B * H, (Sq + BQ - 1) / BQ);
  flash_attention_kernel<T><<<grid, THREADS, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), H, Hkv, Sq, Skv, D,
      causal, window, has_softcap, softcap, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int dtype,
                                      int B, int H, int Hkv, int Sq, int Skv,
                                      int D, int causal, int window,
                                      int has_softcap, float softcap,
                                      float scale, void* stream) {
  if (B <= 0 || Sq <= 0 || Skv <= 0 || Sq > Skv || D <= 0 || D > MAXD ||
      Hkv <= 0 || H % Hkv != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == DT_BF16)
    return launch<__nv_bfloat16>(q, k, v, out, B, H, Hkv, Sq, Skv, D, causal,
                                 window, has_softcap, softcap, scale, st);
  if (dtype == DT_F32)
    return launch<float>(q, k, v, out, B, H, Hkv, Sq, Skv, D, causal, window,
                         has_softcap, softcap, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
