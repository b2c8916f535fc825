// Phase-vocoder identity lock for Hopper (sm_90a), FP32 on the CUDA cores.
//
// Replaces nodey_tpu/ops/pallas_lock.py::lock_to_peaks_pallas (kernel body
// _lock_tile), which the phase vocoder's option paths (onset reset,
// formant pre-warp) reach through ops/pv.py::lock_phases. It computes, for
// every frame row of the [C, K, B] planes, the identity lock of pv_lock.cuh:
// peaks over +-2 bins, each other bin re-phased rigidly with its nearest
// peak.
//
// Design. The lock runs along the bin axis and rows are independent, so one
// CTA of 256 threads takes one row: it stages the row's four inputs (4 * B
// floats, 16 KB at B = 1025) in shared memory with coalesced loads, finds
// each bin's nearest peaks with one max-scan and one suffix min-scan
// (pv_lock.cuh), reads the chosen peak's values by index and writes the two
// locked planes with coalesced stores. Nothing but the planes touches device
// memory. The TPU kernel's 128-lane padding of the bin axis and its 64-row
// tiles existed for VMEM's layout and have no counterpart here.
//
// What bounds it: bytes. Four [C, K, B] float32 planes in and two out: at
// the config-4 pitch stage (C = 2, K = 35,460, B = 1025) 1.74 GB, 0.52 ms
// at 3.35 TB/s; per bin ~40 operations (the compares, the scans, one
// cosf/sinf pair and the rotation), well under the FP32 rate. One row per
// CTA keeps 8 CTAs (2048 threads) on each SM; finding the peaks costs nine
// block barriers per row, which is the first thing to fold into registers
// (a warp per row) when the kernel is made fast.
//
// C interface (loaded with ctypes): nodey_pv_lock launches on the given
// stream and returns cudaGetLastError(); it never synchronizes and
// allocates nothing.

#include <cuda_runtime.h>

#include "pv_lock.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
pv_lock_kernel(const float* __restrict__ cphi, const float* __restrict__ sphi,
               const float* __restrict__ ph, const float* __restrict__ mag,
               float* __restrict__ oc, float* __restrict__ os, int bins) {
  extern __shared__ float smem[];
  float* s_mag = smem;
  float* s_c = s_mag + bins;
  float* s_s = s_c + bins;
  float* s_ph = s_s + bins;
  int* left = reinterpret_cast<int*>(s_ph + bins);
  int* right = left + bins;
  __shared__ int tmp[kThreads / 32];

  const long long base = static_cast<long long>(blockIdx.x) * bins;
  for (int b = threadIdx.x; b < bins; b += kThreads) {
    s_mag[b] = mag[base + b];
    s_c[b] = cphi[base + b];
    s_s[b] = sphi[base + b];
    s_ph[b] = ph[base + b];
  }
  nodey_pv::find_peaks<kThreads>(s_mag, bins, left, right, tmp);
  for (int b = threadIdx.x; b < bins; b += kThreads) {
    float c, s;
    nodey_pv::lock_bin(b, s_c, s_s, s_ph, left, right, &c, &s);
    oc[base + b] = c;
    os[base + b] = s;
  }
}

}  // namespace

extern "C" {

// Shared memory bytes of one CTA: four float rows and two int rows.
long long nodey_pv_lock_smem_bytes(int bins) {
  return 6LL * 4 * bins;
}

// cphi, sphi, ph, mag, oc, os: [rows, bins] float32, contiguous, on the
// current device. Returns a cudaError_t (0 on a clean launch).
int nodey_pv_lock(const float* cphi, const float* sphi, const float* ph,
                  const float* mag, float* oc, float* os, int rows, int bins,
                  void* stream) {
  const long long smem = nodey_pv_lock_smem_bytes(bins);
  cudaError_t err = cudaFuncSetAttribute(
      pv_lock_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  pv_lock_kernel<<<rows, kThreads, static_cast<size_t>(smem),
                   static_cast<cudaStream_t>(stream)>>>(cphi, sphi, ph, mag,
                                                        oc, os, bins);
  return static_cast<int>(cudaGetLastError());
}

const char* nodey_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
