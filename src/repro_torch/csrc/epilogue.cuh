// The GEMM epilogue of the paper's "vector processing mode" (S III-C4), shared
// by mte_gemm.cu (B1, fused on the staged accumulator), grouped_gemm.cu (B3,
// fused on the last K step) and rigid_gemm.cu (B8's separate element-wise
// pass over an accumulator read back from device memory).
//
// Order, as Epilogue.apply in core/epilogue.py: alpha * acc, + beta * C,
// + bias (row), softcap, activation.  gelu is the tanh approximation.
// Under bf16acc (R = true) every step is rounded to bf16, as a bf16
// accumulator tile's element-wise arithmetic is.
#pragma once

#include "common.cuh"

struct Epi {
  float alpha, beta;
  const float* c;     // (M, ldc) f32, already cast to the accumulator dtype
  long ldc;
  const float* bias;  // (N,) f32 or nullptr
  float softcap;
  int has_softcap;
  int act;            // 0 none, 1 relu, 2 gelu (tanh), 3 silu, 4 tanh
  void* out;
  long ldo;
  int out_type;
};

__device__ __forceinline__ float act_fn(float x, int act) {
  switch (act) {
    case 1: return fmaxf(x, 0.0f);
    case 2: return 0.5f * x *
                   (1.0f + tanhf(0.7978845608028654f *
                                 (x + 0.044715f * x * x * x)));
    case 3: return x / (1.0f + expf(-x));
    case 4: return tanhf(x);
    default: return x;
  }
}

template <bool R>
__device__ __forceinline__ float rnd(float x) {
  return R ? bf16_round(x) : x;
}

// The epilogue of one accumulator element v, given its element `cv` of C
// (used only when beta != 0) and of the bias `bv` (only with a bias).
template <bool R>
__device__ __forceinline__ float apply_epi_at(float v, float cv, float bv,
                                              const Epi& e) {
  float x = rnd<R>(e.alpha * v);
  if (e.beta != 0.0f) x = rnd<R>(x + rnd<R>(e.beta * cv));
  if (e.bias != nullptr) x = rnd<R>(x + bv);
  if (e.has_softcap)
    x = rnd<R>(e.softcap * rnd<R>(tanhf(rnd<R>(x / e.softcap))));
  if (e.act) x = rnd<R>(act_fn(x, e.act));
  return x;
}

template <bool R>
__device__ __forceinline__ float apply_epi(float v, long r, long c,
                                           const Epi& e) {
  const float cv = e.beta != 0.0f ? e.c[r * e.ldc + c] : 0.0f;
  const float bv = e.bias != nullptr ? e.bias[c] : 0.0f;
  return apply_epi_at<R>(v, cv, bv, e);
}
