// The merge pass shared by the one-token attention kernels (B4, B6).
//
// Both split a sequence's KV axis across blocks; each block leaves a
// partial softmax state per query head -- running max m, denominator l and
// the unnormalised accumulator (G*D values) -- and this kernel merges the
// slices of one (sequence, kv head) and writes the output: one thread per
// output element (grid = B*Hkv x the G*D elements in blocks of THREADS).
// A row whose merged denominator is 0 returns zeros.
#pragma once

#include "common.cuh"

namespace decode {

constexpr int THREADS = 256;
constexpr float NEG_INF = -1e30f;

// part_m / part_l: (B*Hkv, n_split, G); part_acc: (B*Hkv, n_split, G*D).
__global__ void __launch_bounds__(THREADS)
    combine_kernel(const float* part_m, const float* part_l,
                   const float* part_acc, void* out, int out_type, int H,
                   int Hkv, int D, int n_split) {
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

inline int launch_combine(const float* part_m, const float* part_l,
                          const float* part_acc, void* out, int out_type,
                          int B, int H, int Hkv, int D, int n_split,
                          cudaStream_t st) {
  const int G = H / Hkv;
  const dim3 grid(B * Hkv, (G * D + THREADS - 1) / THREADS);
  combine_kernel<<<grid, THREADS, 0, st>>>(part_m, part_l, part_acc, out,
                                           out_type, H, Hkv, D, n_split);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace decode
