// Shared helpers for the repro_torch CUDA kernels (sm_90a).
//
// Every kernel library is built on its own by kernels/build.py with a
// plain C interface; each includes this header once, which exports
// repro_cuda_error_string() so the Python side can name a failed launch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Element type codes shared with the Python wrappers.
enum DType { DT_F32 = 0, DT_BF16 = 1, DT_I8 = 2, DT_I32 = 3 };

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(int8_t x) {
  return static_cast<float>(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Load element i of a buffer of element type `dt` as f32.
__device__ __forceinline__ float load_as_f32(const void* p, long i, int dt) {
  switch (dt) {
    case DT_BF16: return __bfloat162float(
        static_cast<const __nv_bfloat16*>(p)[i]);
    case DT_I8: return static_cast<float>(static_cast<const int8_t*>(p)[i]);
    case DT_I32: return static_cast<float>(static_cast<const int32_t*>(p)[i]);
    default: return static_cast<const float*>(p)[i];
  }
}

__device__ __forceinline__ void store_from_f32(void* p, long i, int dt,
                                               float v) {
  switch (dt) {
    case DT_BF16:
      static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16_rn(v);
      break;
    case DT_I32:
      static_cast<int32_t*>(p)[i] = static_cast<int32_t>(v);
      break;
    default:
      static_cast<float*>(p)[i] = v;
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
