// B7's direct engine: the RG-LRU linear recurrence h_t = a_t * h_{t-1} +
// b_t from an initial state h_{-1} = h0 (zero without one), for Hopper
// (sm_90a).  It takes what the staged engine (rglru_scan_staged.cu) does
// not: W not a multiple of 4 and bases not 16-byte aligned
// (core/geometry.py:scan_engine).
//
// Replaces: src/repro/kernels/rglru_scan.py, rglru_scan_pallas / _kernel
// (grid (B, S/64) with the sequence axis sequential, the hidden state
// carried across grid steps in VMEM scratch, each 64-step chunk unrolled
// as element-wise FMAs on vector registers; a ragged tail padded with
// identity steps a = 1, b = 0).
//
// What bounds it on the H100: bytes.  Each step reads a_t and b_t and
// writes h_t (12 bytes of f32 per element, 2 FLOP): at the serving
// prefill's (1, 512, 4096) it moves 25.2 MB, ~7.5 us at 3.35 TB/s.  The
// design:
// - One thread per (batch, channel) walks the whole sequence and carries
//   h in a register; neighbouring threads take neighbouring channels, so
//   every load and store of a step is coalesced across the contiguous W
//   axis.  The loads of a_t and b_t do not depend on h: each group of
//   STEPS = 16 steps issues all of its loads into registers before its
//   first multiply-add.  Left to an unrolled loop, ptxas let the first
//   multiply-add (which waits on its load) go ahead of the group's last
//   loads whenever h did not start as the constant 0, so those loads left
//   one memory latency later and the kernel ran ~9% slower once it took
//   h0 (seen in cuobjdump -sass of the two builds).
// - There is no padding: the loop stops at S.  The TPU's 64-step chunks
//   and identity steps are a layout choice of the Pallas kernel, not part
//   of what it computes.
// - The product and the sum are rounded separately (__fmul_rn, __fadd_rn,
//   never contracted into one FMA), so the kernel gives the plain
//   version's numbers bit for bit.
// - Parallelism is B * W threads: 4096 at the serving shape, 64 blocks of
//   64 threads on 64 of the 132 SMs, latency-bound and far from the byte
//   bound.  The staged engine fills the card with slabs of channels and
//   keeps the loads in flight in shared memory.
#include "common.cuh"

namespace {

constexpr int THREADS = 64;
constexpr int STEPS = 16;  // steps whose loads leave together

__global__ void __launch_bounds__(THREADS)
    rglru_scan_kernel(const float* __restrict__ a,
                      const float* __restrict__ b,
                      const float* __restrict__ h0, float* __restrict__ h_out,
                      int S, int W) {
  const int w = blockIdx.x * THREADS + threadIdx.x;
  if (w >= W) return;
  const long base = static_cast<long>(blockIdx.y) * S * W + w;
  float h = h0 != nullptr ? h0[static_cast<long>(blockIdx.y) * W + w] : 0.0f;
  int t = 0;
  for (; t + STEPS <= S; t += STEPS) {
    float av[STEPS], bv[STEPS];
#pragma unroll
    for (int k = 0; k < STEPS; ++k) {
      const long i = base + static_cast<long>(t + k) * W;
      av[k] = a[i];
      bv[k] = b[i];
    }
#pragma unroll
    for (int k = 0; k < STEPS; ++k) {
      h = __fadd_rn(__fmul_rn(av[k], h), bv[k]);
      h_out[base + static_cast<long>(t + k) * W] = h;
    }
  }
  for (; t < S; ++t) {
    const long i = base + static_cast<long>(t) * W;
    h = __fadd_rn(__fmul_rn(a[i], h), b[i]);
    h_out[i] = h;
  }
}

}  // namespace

// a, b, h: (B, S, W) f32, contiguous; h0: (B, W) f32 contiguous, or null
// for a zero initial state.
extern "C" int rglru_scan_launch(const void* a, const void* b, const void* h0,
                                 void* h, int B, int S, int W, void* stream) {
  if (B <= 0 || S <= 0 || W <= 0 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((W + THREADS - 1) / THREADS, B);
  rglru_scan_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<const float*>(h0), static_cast<float*>(h), S, W);
  return static_cast<int>(cudaGetLastError());
}
