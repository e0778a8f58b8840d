// B7's staged engine: the RG-LRU linear recurrence h_t = a_t * h_{t-1} +
// b_t from an initial state h_{-1} = h0 (zero without one), for Hopper
// (sm_90a).
//
// Replaces: src/repro/kernels/rglru_scan.py, rglru_scan_pallas / _kernel
// (grid (B, S/64) with the sequence axis sequential, the hidden state
// carried across grid steps in VMEM scratch, each 64-step chunk unrolled
// as element-wise FMAs on vector registers), and the fold of the carried
// state that src/repro/models/rglru.py adds after it on a resumed chunk
// (h += exp(cumsum(log a)) * h0): a scan that starts from h0 computes the
// same h in the same pass.
//
// What bounds it on the H100: bytes, and at short S the recurrence's own
// chain.  Each step reads a_t and b_t and writes h_t (12 bytes of f32 per
// element, 2 FLOP): at the serving prefill's (1, 512, 4096) it moves
// 25.2 MB, ~7.5 us at 3.35 TB/s.  At ~1 us of memory latency the card
// needs ~25 KB in flight on every SM to stream at that rate; one thread
// per channel with its loads in registers (rglru_scan.cu) keeps ~4 KB in
// flight on 64 SMs.  The design:
// - Parallelism: a block (one warp) owns one batch row and a slab of
//   SLAB = 32 consecutive channels: (W / SLAB) x B blocks, 128 at the
//   serving shape.  Slabs of 16 (256 blocks) ran 3-5% slower there on an
//   H100: twice the TMA boxes for the same bytes.
// - Bytes in flight: a and b come into shared memory in spans of SPAN = 64
//   steps, a ring of STAGES = 4 spans (16 KB each), each
//   span one TMA box of SLAB x SPAN from a 3-D tensor map over (W, S, B)
//   per operand, its bytes counted on the stage's mbarrier.  All four
//   spans are issued at the start, and each consumed stage is refilled
//   with the span four ahead, so three to four spans (48-64 KB) are in
//   flight per block.  TMA needs a 16-byte aligned base
//   and row stride: W a multiple of 4 (the engine choice,
//   core/geometry.py:scan_engine).  One bulk copy per step row (no tensor
//   map) and h staged in shared memory for a TMA store both ran slower.
// - Spans cover any S: TMA fills a box's rows past S and channels past W
//   with zeros (and counts them in the box's bytes); the recurrence walks
//   and stores only the span's rows and the slab's channels.  Nothing is
//   padded in device memory.
// - The recurrence stays sequential along S, one lane per channel, h in a
//   register, reading the staged span from shared memory (consecutive
//   lanes on consecutive words: no bank conflicts).  The product and the
//   sum are rounded separately (__fmul_rn, __fadd_rn, never contracted
//   into one FMA), so the engine gives the plain version's numbers bit
//   for bit, with or without h0.  Its chain of S dependent multiply-adds
//   per channel sets a floor that, at S = 512, is most of the kernel's
//   time; a two-level scan over S would lift it and give up bit-equality.
// - Stores: each step's h_t leaves as one coalesced row of the slab (128
//   bytes from one warp's store).
#include "wgmma_mainloop.cuh"

namespace {

constexpr int SLAB = 32;     // channels a block
constexpr int SPAN = 64;     // steps per stage
constexpr int STAGES = 4;    // stages in the ring
constexpr int THREADS = 32;  // one warp a block: a lane per channel
constexpr int STAGE_FLOATS = 2 * SPAN * SLAB;  // a's span, b's span
constexpr int SMEM = STAGES * STAGE_FLOATS * 4 + STAGES * 8;

// Arm stage `span % STAGES` with the bytes of span `span` (two whole
// boxes: TMA counts the zeros it fills past S and W) and issue its two
// loads.  Lane 0 only.
__device__ __forceinline__ void issue_span(float* ring, uint64_t* full,
                                           const CUtensorMap* ta,
                                           const CUtensorMap* tb, int span,
                                           int w0) {
  const int stage = span % STAGES;
  float* sa = ring + stage * STAGE_FLOATS;
  wg::mbar_expect_tx(&full[stage], STAGE_FLOATS * 4);
  wg::tma_load_3d(sa, ta, &full[stage], w0, span * SPAN, blockIdx.y);
  wg::tma_load_3d(sa + SPAN * SLAB, tb, &full[stage], w0, span * SPAN,
                  blockIdx.y);
}

__global__ void __launch_bounds__(THREADS)
    rglru_scan_staged_kernel(const __grid_constant__ CUtensorMap ta,
                             const __grid_constant__ CUtensorMap tb,
                             const float* __restrict__ h0,
                             float* __restrict__ h_out, int S, int W) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* ring = reinterpret_cast<float*>(smem);
  uint64_t* full = reinterpret_cast<uint64_t*>(
      smem + STAGES * STAGE_FLOATS * 4);
  const int lane = threadIdx.x;
  const int w0 = blockIdx.x * SLAB;
  const int width = min(SLAB, W - w0);          // channels of this slab
  const long base = static_cast<long>(blockIdx.y) * S * W + w0;
  const int spans = (S + SPAN - 1) / SPAN;

  if (lane == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) wg::mbar_init(&full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncwarp();
  if (lane == 0)
    for (int span = 0; span < min(STAGES, spans); ++span)
      issue_span(ring, full, &ta, &tb, span, w0);

  const bool mine = lane < width;
  float h = 0.0f;
  if (h0 != nullptr && mine)
    h = h0[static_cast<long>(blockIdx.y) * W + w0 + lane];
  float* out = h_out + base + lane;
  for (int span = 0; span < spans; ++span) {
    const int stage = span % STAGES;
    const int rows = min(SPAN, S - span * SPAN);
    wg::mbar_wait(&full[stage], (span / STAGES) & 1);
    const float* sa = ring + stage * STAGE_FLOATS + lane;
    const float* sb = sa + SPAN * SLAB;
    if (mine) {
      if (rows == SPAN) {
#pragma unroll 16
        for (int r = 0; r < SPAN; ++r) {
          h = __fadd_rn(__fmul_rn(sa[r * SLAB], h), sb[r * SLAB]);
          out[static_cast<long>(r) * W] = h;
        }
      } else {
        for (int r = 0; r < rows; ++r) {
          h = __fadd_rn(__fmul_rn(sa[r * SLAB], h), sb[r * SLAB]);
          out[static_cast<long>(r) * W] = h;
        }
      }
    }
    out += static_cast<long>(SPAN) * W;
    // Every lane has read the stage: order those reads before the TMA
    // loads (the async proxy) that refill it.
    wg::fence_proxy_async();
    __syncwarp();
    if (lane == 0 && span + STAGES < spans)
      issue_span(ring, full, &ta, &tb, span + STAGES, w0);
  }
}

// A 3-D f32 tensor map over a contiguous (B, S, W) tensor, box
// (SLAB, SPAN, 1), no swizzle, zero fill outside.
int make_map(CUtensorMap* map, const void* ptr, int B, int S, int W) {
  const wg::EncodeTiled fn = wg::encode_tiled();
  if (fn == nullptr) return wg::ENTRY_ERROR;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(W),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(W) * 4,
                                 static_cast<cuuint64_t>(S) * W * 4};
  const cuuint32_t box[3] = {SLAB, SPAN, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3,
                        const_cast<void*>(ptr), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_NONE,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : wg::ENCODE_ERROR + static_cast<int>(r);
}

}  // namespace

// a, b, h: (B, S, W) f32, contiguous, a and b 16-byte aligned, W a
// multiple of 4; h0: (B, W) f32 contiguous, or null for a zero initial
// state.  Returns the launch's cudaError_t, or one of wgmma_mainloop.cuh's
// tensor-map codes.
extern "C" int rglru_scan_staged_launch(const void* a, const void* b,
                                        const void* h0, void* h, int B,
                                        int S, int W, void* stream) {
  const auto misaligned = [](const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15) != 0;
  };
  if (B <= 0 || S <= 0 || W <= 0 || B > 65535 || W % 4 != 0 ||
      misaligned(a) || misaligned(b))
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap ta, tb;
  int e = make_map(&ta, a, B, S, W);
  if (e == 0) e = make_map(&tb, b, B, S, W);
  if (e != 0) return e;
  static bool sized = false;
  if (!sized) {
    const cudaError_t ce = cudaFuncSetAttribute(
        rglru_scan_staged_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (ce != cudaSuccess) return static_cast<int>(ce);
    sized = true;
  }
  const dim3 grid((W + SLAB - 1) / SLAB, B);
  rglru_scan_staged_kernel<<<grid, THREADS, SMEM,
                             static_cast<cudaStream_t>(stream)>>>(
      ta, tb, static_cast<const float*>(h0), static_cast<float*>(h), S, W);
  return static_cast<int>(cudaGetLastError());
}
