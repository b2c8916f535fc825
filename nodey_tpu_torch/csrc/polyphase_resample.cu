// Rational polyphase resampler for Hopper (sm_90a), FP32 on the CUDA cores.
//
// Replaces nodey_tpu/ops/pallas_resample.py::apply_filter_bank_grouped_pallas,
// the TPU's grouped Pallas kernel. Both compute
//
//     y[c, g*L + p] = sum_{w < W} x[c, g*M + w] * bank[p, w]
//
// over the already padded input x [C, nx] and the [L, W] bank (W = M + taps
// - 1). The TPU kernel grouped R output cycles per row and zero-embedded the
// bank to [Wp, R*L] only so that its lane widths were multiples of 128; on
// this card that grouping would cost R*L*Wp / (R*L*W) more MACs (640 vs 178
// per output for 44.1 -> 48 kHz), so this kernel computes the ungrouped sum.
//
// What bounds it: about 2*W flops per output sample (356 for 44.1 -> 48 kHz)
// against 4 bytes in and 4 bytes out, so it is FFMA-bound, far above the
// card's bytes-per-flop line. The design keeps every operand on chip:
//   * one CTA takes a tile of `tile_g` output groups of one channel and a
//     tile of 32 phases (one lane per phase);
//   * it stages the input span those groups read, (tile_g - 1)*M + W floats,
//     into shared memory with coalesced loads, so the overlapping patch rows
//     the TPU kernel built in VMEM are never written to device memory;
//   * it stages its 32 phases of the bank transposed ([W][32]), so a warp
//     reads 32 consecutive floats per tap (no bank conflicts), while the
//     input value a tap reads is one broadcast address for the whole warp;
//   * each thread accumulates 8 groups of its phase in registers with FFMA,
//     in tap order, and a warp stores 32 consecutive outputs per group.
// No tensor cores and no TF32: each phase has only `taps` non-zero weights,
// and per-phase tap support and 3xTF32 wgmma are later work.
//
// C interface (loaded with ctypes): nodey_polyphase_resample launches on the
// given stream and returns cudaGetLastError(); it never synchronizes and
// allocates nothing.

#include <cuda_runtime.h>

namespace {

constexpr int kPhases = 32;          // phases per CTA: one lane each
constexpr int kWarps = 8;
constexpr int kThreads = kPhases * kWarps;
constexpr int kGroupsPerThread = 8;  // register accumulators per thread

__global__ void __launch_bounds__(kThreads)
polyphase_resample_kernel(const float* __restrict__ x,
                          const float* __restrict__ bank,
                          float* __restrict__ y,
                          int nx, int groups, int phases, int m, int w_taps,
                          int tile_g) {
  extern __shared__ float smem[];
  float* bank_t = smem;                       // [w_taps][kPhases]
  float* xs = smem + w_taps * kPhases;        // [(tile_g - 1) * m + w_taps]

  const int c = blockIdx.z;
  const int p0 = blockIdx.y * kPhases;
  const long long g0 = static_cast<long long>(blockIdx.x) * tile_g;
  const float* xc = x + static_cast<long long>(c) * nx;
  float* yc = y + static_cast<long long>(c) * groups * phases;

  // The bank tile, read row by row (coalesced) and stored transposed.
  for (int i = threadIdx.x; i < kPhases * w_taps; i += kThreads) {
    const int pl = i / w_taps;
    const int w = i - pl * w_taps;
    const int p = p0 + pl;
    bank_t[w * kPhases + pl] =
        p < phases ? bank[static_cast<long long>(p) * w_taps + w] : 0.0f;
  }
  // The input span of this tile. The wrapper pads x to cover every window
  // of groups < `groups`; the last tile's span may run past nx only for
  // groups it does not store, and those reads are masked to zero.
  const int span = (tile_g - 1) * m + w_taps;
  const long long base = g0 * m;
  for (int i = threadIdx.x; i < span; i += kThreads) {
    const long long j = base + i;
    xs[i] = j < nx ? xc[j] : 0.0f;
  }
  __syncthreads();

  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int p = p0 + lane;
  for (int gb = warp * kGroupsPerThread; gb < tile_g;
       gb += kWarps * kGroupsPerThread) {
    float acc[kGroupsPerThread];
#pragma unroll
    for (int k = 0; k < kGroupsPerThread; ++k) acc[k] = 0.0f;
    const float* xw = xs + gb * m;
    for (int w = 0; w < w_taps; ++w) {
      const float b = bank_t[w * kPhases + lane];
#pragma unroll
      for (int k = 0; k < kGroupsPerThread; ++k) {
        acc[k] = fmaf(xw[k * m + w], b, acc[k]);
      }
    }
    if (p < phases) {
#pragma unroll
      for (int k = 0; k < kGroupsPerThread; ++k) {
        const long long g = g0 + gb + k;
        if (g < groups) yc[g * phases + p] = acc[k];
      }
    }
  }
}

}  // namespace

extern "C" {

// Shared memory bytes one CTA needs for a tile of `tile_g` groups.
long long nodey_polyphase_smem_bytes(int m, int w_taps, int tile_g) {
  return static_cast<long long>(sizeof(float)) *
         (static_cast<long long>(w_taps) * kPhases +
          static_cast<long long>(tile_g - 1) * m + w_taps);
}

// x [channels, nx], bank [phases, w_taps], y [channels, groups * phases]:
// all float32, contiguous, on the current device. tile_g must be a positive
// multiple of 8. Returns a cudaError_t (0 on a clean launch).
int nodey_polyphase_resample(const float* x, const float* bank, float* y,
                             int channels, int nx, int groups, int phases,
                             int m, int w_taps, int tile_g, void* stream) {
  const long long smem = nodey_polyphase_smem_bytes(m, w_taps, tile_g);
  cudaError_t err = cudaFuncSetAttribute(
      polyphase_resample_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((groups + tile_g - 1) / tile_g,
                  (phases + kPhases - 1) / kPhases, channels);
  polyphase_resample_kernel<<<grid, kThreads, static_cast<size_t>(smem),
                              static_cast<cudaStream_t>(stream)>>>(
      x, bank, y, nx, groups, phases, m, w_taps, tile_g);
  return static_cast<int>(cudaGetLastError());
}

const char* nodey_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
