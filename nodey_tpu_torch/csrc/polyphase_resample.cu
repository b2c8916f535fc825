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
// this card that grouping would cost R*L*Wp / (R*L*W) more MACs, so this
// kernel computes the ungrouped sum, and only over each phase's taps.
//
// The tap support. Phase p of the bank has non-zero weights only in a short
// run of columns (32 of 178 at 44.1 -> 48 kHz, 42 of 676 at 635/504, 36 of
// 195 at 48 -> 44.1). The host derives the support from the bank's own zeros
// (ops/resample.py::bank_support) for blocks of B = 4 consecutive phases:
// block b reads the T columns [off_b, off_b + T), and compact[b][t][r] is
// bank[b*B + r][off_b + t]. The kernel sums, for each output,
//
//     y[c, g*L + b*B + r] = sum_{t < T} x[c, g*M + off_b + t] * compact[b][t][r]
//
// in increasing t with FFMA into one float. That is the dense sum with only
// exact zeros left out: fmaf(x, 0, +0) is +0 and acc + x*0 is acc for finite
// x, so for finite input the output is bitwise the dense tap-order sum (up to
// the sign of a zero). Non-finite input: the dense sum turns an inf or NaN
// sample into NaN across the whole W-wide window of every output that reads
// it, this sum only across the T columns of the blocks that read it (the JAX
// kernel is dense). Decoded audio is always finite.
//
// What bounds it: 2*T flops per output sample against 8 bytes of device
// memory, and shared-memory loads: one thread per phase would issue one
// per multiply-add (summing the dense window instead, with the input value
// broadcast, puts 5.6x to 16x of the FFMAs on zeros, and at 635/504 a
// [676][32] bank tile takes 168 KB of shared memory, one CTA per SM). The
// design:
//   * a CTA takes 32 phases (8 blocks) and 32 * GPT consecutive output
//     groups of one channel; lanes run over groups, warps over phase blocks;
//   * each group's input row [g*M + off_min, g*M + off_min + row_used) is
//     copied into shared memory with cp.async, every copy of a thread in
//     flight at once (row_used = the widest offset spread of a 32-phase
//     tile + T, computed once per bank on the host, so every block's window
//     of every group is in its row), at an odd row stride: the 32 lanes of
//     a warp read 32 rows at the same column, 32 distinct banks, whatever M
//     is (M = 160 at 48 -> 44.1 kHz would be a 32-way conflict in one
//     contiguous span);
//   * the compact bank tile [8][T][4] is staged as it lies in device
//     memory, and a warp reads one (t, block) entry for all lanes: a
//     broadcast, one 16-byte load;
//   * register tile: each thread holds GPT groups x 4 phases; per tap it
//     loads GPT input values and one bank vector and issues 4*GPT FFMAs, so
//     one input value feeds the 4 phases of its block (GPT = 4: 5 shared
//     loads per 16 FFMAs). A block's window is the union of its phases'
//     supports, so T grows by about 3*M/L zero columns (~10%). One phase
//     per thread (5 loads per 4 FFMAs) measured 17-30% slower (PERF.md);
//   * the [32*GPT][32] output tile goes through shared memory (row stride 33)
//     and leaves as 32 consecutive phases per group: coalesced stores.
// Shared memory at 635/504 with GPT = 4: ~68 KB, three CTAs per SM.
// No tensor cores and no TF32: a 3xTF32 wgmma form is later work.
//
// C interface (loaded with ctypes): nodey_polyphase_resample launches on the
// given stream and returns cudaGetLastError(); it never synchronizes and
// allocates nothing.

#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kTilePhases = 32;              // phases per CTA, one per lane
constexpr int kBlock = 4;                    // phases per thread (a block)
constexpr int kBlocks = kTilePhases / kBlock;  // phase blocks per CTA
constexpr int kOutLd = kTilePhases + 1;      // output tile row stride (odd)

// Copy 4 bytes from device to shared memory asynchronously (no registers;
// every thread keeps all of its copies in flight at once).
__device__ __forceinline__ void cp_async_f32(float* dst, const float* src) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(addr),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

template <int GPT>
__global__ void __launch_bounds__(kThreads)
polyphase_support_kernel(const float* __restrict__ x,
                         const float* __restrict__ compact,
                         const int* __restrict__ offsets,
                         float* __restrict__ y, int nx, long long groups,
                         int phases, int n_blocks, int m, int taps,
                         int row_used, int row_ld) {
  constexpr int kGroups = 32 * GPT;          // output groups per CTA
  extern __shared__ float4 smem4[];
  float* bank_s = reinterpret_cast<float*>(smem4);   // [kBlocks][taps][4]
  float* rows = bank_s + kBlocks * taps * kBlock;    // [kGroups][row_ld]
  float* out_s = rows + kGroups * row_ld;            // [kGroups][kOutLd]
  __shared__ int off_s[kBlocks];
  __shared__ int base_s;

  const int n_ptiles = (n_blocks + kBlocks - 1) / kBlocks;
  const int b0 = (blockIdx.x % n_ptiles) * kBlocks;
  const long long g0 = static_cast<long long>(blockIdx.x / n_ptiles) * kGroups;
  const int c = blockIdx.y;
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;

  if (threadIdx.x < kBlocks) {
    const int b = b0 + threadIdx.x;
    off_s[threadIdx.x] = b < n_blocks ? offsets[b] : INT_MAX;
  }
  // The bank tile: blocks b0 .. b0 + kBlocks - 1 lie contiguous.
  const long long bank_first = static_cast<long long>(b0) * taps * kBlock;
  const long long bank_total =
      static_cast<long long>(n_blocks) * taps * kBlock;
  for (int i = threadIdx.x; i < kBlocks * taps * kBlock; i += kThreads) {
    if (bank_first + i < bank_total) {
      cp_async_f32(bank_s + i, compact + bank_first + i);
    } else {
      bank_s[i] = 0.0f;
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int lo = INT_MAX;
    for (int i = 0; i < kBlocks; ++i) lo = min(lo, off_s[i]);
    base_s = lo;
  }
  __syncthreads();
  const int base = base_s;

  // Row i: x[c, (g0 + i)*m + base + j], j < row_used. The wrapper pads x to
  // cover every window of groups < `groups`; rows of the last tile may run
  // past nx only for groups it does not store, and those reads are zero.
  const float* xc = x + static_cast<long long>(c) * nx;
  for (int i = warp; i < kGroups; i += kWarps) {
    const long long start = (g0 + i) * m + base;
    for (int j = lane; j < row_used; j += 32) {
      const long long k = start + j;
      if (k < nx) {
        cp_async_f32(rows + i * row_ld + j, xc + k);
      } else {
        rows[i * row_ld + j] = 0.0f;
      }
    }
  }
  cp_async_wait_all();
  __syncthreads();

  for (int bl = warp; bl < kBlocks && b0 + bl < n_blocks; bl += kWarps) {
    const float* xr = rows + lane * row_ld + (off_s[bl] - base);
    const float4* bk = reinterpret_cast<const float4*>(bank_s) + bl * taps;
    float acc[GPT][kBlock];
#pragma unroll
    for (int j = 0; j < GPT; ++j) {
#pragma unroll
      for (int r = 0; r < kBlock; ++r) acc[j][r] = 0.0f;
    }
#pragma unroll 4
    for (int t = 0; t < taps; ++t) {
      const float4 q = bk[t];
      const float bv[kBlock] = {q.x, q.y, q.z, q.w};
#pragma unroll
      for (int j = 0; j < GPT; ++j) {
        const float xv = xr[j * 32 * row_ld + t];
#pragma unroll
        for (int r = 0; r < kBlock; ++r) {
          acc[j][r] = fmaf(xv, bv[r], acc[j][r]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < GPT; ++j) {
#pragma unroll
      for (int r = 0; r < kBlock; ++r) {
        out_s[(lane + 32 * j) * kOutLd + bl * kBlock + r] = acc[j][r];
      }
    }
  }
  __syncthreads();

  float* yc = y + static_cast<long long>(c) * groups * phases;
  const int p = b0 * kBlock + lane;
  for (int i = warp; i < kGroups; i += kWarps) {
    const long long g = g0 + i;
    if (g < groups && p < phases) yc[g * phases + p] = out_s[i * kOutLd + lane];
  }
}

template <int GPT>
long long smem_bytes(int taps, int row_ld) {
  return static_cast<long long>(sizeof(float)) *
         (static_cast<long long>(kTilePhases) * taps +
          32LL * GPT * (row_ld + kOutLd));
}

template <int GPT>
int launch(const float* x, const float* compact, const int* offsets, float* y,
           int channels, int nx, long long groups, int phases, int n_blocks,
           int m, int taps, int row_used, int row_ld, cudaStream_t stream) {
  const long long smem = smem_bytes<GPT>(taps, row_ld);
  cudaError_t err = cudaFuncSetAttribute(
      polyphase_support_kernel<GPT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long n_ptiles = (n_blocks + kBlocks - 1) / kBlocks;
  const long long n_gtiles = (groups + 32LL * GPT - 1) / (32LL * GPT);
  const dim3 grid(static_cast<unsigned>(n_ptiles * n_gtiles), channels);
  polyphase_support_kernel<GPT><<<grid, kThreads, static_cast<size_t>(smem),
                                  stream>>>(
      x, compact, offsets, y, nx, groups, phases, n_blocks, m, taps, row_used,
      row_ld);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Shared memory bytes one CTA needs; -1 for a gpt not built.
long long nodey_polyphase_smem_bytes(int gpt, int taps, int row_ld) {
  if (gpt == 4) return smem_bytes<4>(taps, row_ld);
  if (gpt == 1) return smem_bytes<1>(taps, row_ld);
  return -1;
}

// x [channels, nx], compact [n_blocks, taps, 4], offsets [n_blocks] int32,
// y [channels, groups * phases]: contiguous, on the current device. Block b
// covers phases 4b .. 4b + 3; row_used >= every 32-phase tile's offset
// spread + taps, row_ld odd and >= row_used; gpt (groups per lane) 1 or 4.
// Returns a cudaError_t (0 on a clean launch).
int nodey_polyphase_resample(const float* x, const float* compact,
                             const int* offsets, float* y, int channels,
                             int nx, long long groups, int phases,
                             int n_blocks, int m, int taps, int gpt,
                             int row_used, int row_ld, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (gpt == 4)
    return launch<4>(x, compact, offsets, y, channels, nx, groups, phases,
                     n_blocks, m, taps, row_used, row_ld, s);
  if (gpt == 1)
    return launch<1>(x, compact, offsets, y, channels, nx, groups, phases,
                     n_blocks, m, taps, row_used, row_ld, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* nodey_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
