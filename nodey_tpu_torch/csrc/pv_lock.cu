// Phase-vocoder identity lock for Hopper (sm_90a), FP32 on the CUDA cores.
//
// Replaces nodey_tpu/ops/pallas_lock.py::lock_to_peaks_pallas (kernel body
// _lock_tile), which the phase vocoder's chunk step (ops/pv.py::
// pv_stream_step, once per stage step with frames) and its option paths
// (onset reset, formant pre-warp) reach through ops/pv.py::lock_phases. It
// computes, for every frame row of the [C, K, B] planes, the identity lock
// of pv_lock.cuh: peaks over +-2 bins, each other bin re-phased rigidly with
// its nearest peak.
//
// Design. Rows are independent and the lock runs along the bin axis, so a
// warp owns a row and a CTA holds four warps, each with its own row; nothing
// on a row's path waits for another warp (no block barrier, only
// __syncwarp). A warp walks its row in word steps of 32 bins, lane l on bin
// 32 j + l of step j, in groups of steps (kFlagGroup, then kGroup) whose
// loads go out one group ahead:
//   1. the peak flags: each lane holds its bin's magnitude, takes the +-2
//      neighbours from the other lanes by shuffle (lanes 0-1 and 30-31 from
//      the previous and next step's values), and __ballot_sync gives word j
//      of the row's peak flags;
//   2. scan_words gives each word the last peak up to it and the first from
//      it, and nearest_peaks each bin its left and right peak with a masked
//      __clz / __ffs;
//   3. the lock: lane l's own cos, sin and phase come with coalesced loads,
//      which also bring the lines that hold the chosen peak's values (a peak
//      is near, so those reads mostly hit L1); lock_phasor rotates without a
//      branch, and the two locked planes go out with coalesced stores.
// The rows are 4 * B bytes, not 16-byte aligned, so every access is a
// 4-byte one, 32 neighbouring floats a warp instruction. Only the words and
// their scan live in shared memory (3 * 4 bytes a word, 0.4 KB a row at B =
// 1025); registers (62 a thread) hold 32 rows an SM. The same three lock
// functions run in the fused phase-path kernel's locked apply pass
// (pv_phase_path.cu). The word count is a template parameter: the
// instantiations cover the rows of pv_params' n_fft 512 to 8192 (9, 17, 33,
// 65 and 129 words for B = 257 to 4097), and a row takes the smallest with at
// least ceil(B / 32) words (its words past the row stay 0), so any B from 1
// to 4097 runs.
//
// Why this layout (PERF.md §6): a first draft that staged a row's
// four planes in shared memory (16.8 KB a row) held 12 rows an SM, too few
// to hide its latencies; a second that staged the magnitudes alone (4.5 KB,
// 49 rows) waited in its lock loop on each group's loads. Both were slower
// than the parent's CTA-a-row kernel. Loading the own values a group ahead
// made the warp-a-row kernel faster than the parent's; more rows an SM did
// not (staged magnitudes in front of this lock loop, or the peaks' cos and
// sin gathered instead of loaded, were slower), nor did deeper groups,
// which cost registers and so rows.
//
// What bounds it: bytes. Four [C, K, B] float32 planes in and two out: at
// the streamed PV's chunk shapes [2, 1,894, 1025] and [2, 1,207, 1025]
// 93.2 and 59.4 MB (0.0278 and 0.0177 ms at 3.35 TB/s), at the offline
// config-4 pitch stage [2, 35,460, 1025] 1.74 GB (0.52 ms). Per bin ~60
// instructions (the peak test, the word lookups, the sine and cosine and
// the rotation), under the instruction rate at that byte rate.
//
// C interface (loaded with ctypes): nodey_pv_lock launches on the given
// stream and returns cudaGetLastError(); it never synchronizes and
// allocates nothing.

#include <cuda_runtime.h>

#include "pv_lock.cuh"

namespace {

using nodey_pv::kFull;

constexpr int kRowsPerCta = 4;  // warps a CTA, a row each
constexpr int kMaxBins = 4097;  // rows of 129 words
constexpr int kFlagGroup = 8;   // word steps whose magnitudes load together
constexpr int kGroup = 4;       // word steps whose own values load together

template <int kWords>
__global__ void __launch_bounds__(kRowsPerCta * 32)
pv_lock_kernel(const float* __restrict__ cphi, const float* __restrict__ sphi,
               const float* __restrict__ ph, const float* __restrict__ mag,
               float* __restrict__ oc, float* __restrict__ os, int rows,
               int bins) {
  __shared__ unsigned s_words[kRowsPerCta][kWords];
  __shared__ int s_last[kRowsPerCta][kWords];
  __shared__ int s_first[kRowsPerCta][kWords];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long row =
      static_cast<long long>(blockIdx.x) * kRowsPerCta + warp;
  if (row >= rows) return;  // the last CTA's spare warps
  unsigned* words = s_words[warp];
  int* last = s_last[warp];
  int* first = s_first[warp];
  const long long base = row * bins;
  const float* row_mag = mag + base;
  const float* row_c = cphi + base;
  const float* row_s = sphi + base;
  const float* row_ph = ph + base;
  const int nw = (bins + 31) >> 5;
  for (int j = nw + lane; j < kWords; j += 32) words[j] = 0u;

  // 1. Peak flags. Bins past the row's ends count as -1.
  auto mag_at = [&](int j) {
    const int b = 32 * j + lane;
    return b < bins ? __ldg(row_mag + b) : -1.0f;
  };
  float prev = -1.0f, cur[kFlagGroup], next[kFlagGroup];
#pragma unroll
  for (int i = 0; i < kFlagGroup; ++i) cur[i] = mag_at(i);
  for (int j0 = 0; j0 < nw; j0 += kFlagGroup) {
#pragma unroll
    for (int i = 0; i < kFlagGroup; ++i) {
      next[i] = mag_at(j0 + kFlagGroup + i);
    }
#pragma unroll
    for (int i = 0; i < kFlagGroup; ++i) {
      const int j = j0 + i;
      if (j < nw) {
        // Lane l reads bin b - 1 from lane l - 1, whose value is its bin's,
        // or for l = 0 lane 31's of the previous step; the same for b - 2
        // (lanes 30, 31) and, from the next step, b + 1 and b + 2.
        const float m = cur[i];
        const float up = i + 1 < kFlagGroup ? cur[i + 1] : next[0];
        const float below1 =
            __shfl_sync(kFull, lane == 31 ? prev : m, (lane + 31) & 31);
        const float below2 =
            __shfl_sync(kFull, lane >= 30 ? prev : m, (lane + 30) & 31);
        const float above1 =
            __shfl_sync(kFull, lane == 0 ? up : m, (lane + 1) & 31);
        const float above2 =
            __shfl_sync(kFull, lane <= 1 ? up : m, (lane + 2) & 31);
        const int b = 32 * j + lane;
        // nodey_pv::is_peak's test.
        const unsigned peaks = __ballot_sync(
            kFull, b < bins && m > below1 && m >= above1 && m > below2 &&
                       m >= above2);
        if (lane == 0) words[j] = peaks;
        prev = m;
      }
    }
#pragma unroll
    for (int i = 0; i < kFlagGroup; ++i) cur[i] = next[i];
  }
  __syncwarp();
  // 2. Each word's nearest peaks.
  nodey_pv::scan_words<kWords>(words, last, first);
  __syncwarp();

  // 3. The lock, the next group's own values loaded while this one locks.
  float c[kGroup], s[kGroup], p[kGroup], nc[kGroup], ns[kGroup], np[kGroup];
  auto own_at = [&](int j0, float* cc, float* ss, float* pp) {
#pragma unroll
    for (int i = 0; i < kGroup; ++i) {
      const int b = 32 * (j0 + i) + lane;
      cc[i] = b < bins ? __ldg(row_c + b) : 0.0f;
      ss[i] = b < bins ? __ldg(row_s + b) : 0.0f;
      pp[i] = b < bins ? __ldg(row_ph + b) : 0.0f;
    }
  };
  own_at(0, c, s, p);
  for (int j0 = 0; j0 < nw; j0 += kGroup) {
    own_at(j0 + kGroup, nc, ns, np);
#pragma unroll
    for (int i = 0; i < kGroup; ++i) {
      const int b = 32 * (j0 + i) + lane;
      if (b < bins) {
        int left, right;
        nodey_pv::nearest_peaks<kWords>(b, words, last, first, left, right);
        float lc, ls;
        nodey_pv::lock_phasor<true>(b, left, right, c[i], s[i], p[i], row_c,
                                    row_s, row_ph, lc, ls);
        oc[base + b] = lc;
        os[base + b] = ls;
      }
    }
#pragma unroll
    for (int i = 0; i < kGroup; ++i) {
      c[i] = nc[i];
      s[i] = ns[i];
      p[i] = np[i];
    }
  }
}

// The word count of the instantiation for rows of `bins` bins, or 0 for a
// row the kernel does not take.
int lock_words(int bins) {
  if (bins < 1 || bins > kMaxBins) return 0;
  for (int words : {9, 17, 33, 65, 129}) {
    if (32 * words >= bins) return words;
  }
  return 0;
}

template <int kWords>
cudaError_t launch(const float* cphi, const float* sphi, const float* ph,
                   const float* mag, float* oc, float* os, int rows, int bins,
                   cudaStream_t stream) {
  const int ctas = (rows + kRowsPerCta - 1) / kRowsPerCta;
  pv_lock_kernel<kWords><<<ctas, 32 * kRowsPerCta, 0, stream>>>(
      cphi, sphi, ph, mag, oc, os, rows, bins);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Rows (warps) a CTA for rows of `bins` bins, or 0 for a row the kernel
// does not take (bins outside 1..4097).
int nodey_pv_lock_rows_per_cta(int bins) {
  return lock_words(bins) ? kRowsPerCta : 0;
}

// cphi, sphi, ph, mag, oc, os: [rows, bins] float32, contiguous, on the
// current device. Returns a cudaError_t (0 on a clean launch).
int nodey_pv_lock(const float* cphi, const float* sphi, const float* ph,
                  const float* mag, float* oc, float* os, int rows, int bins,
                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (lock_words(bins)) {
    case 9:
      return launch<9>(cphi, sphi, ph, mag, oc, os, rows, bins, s);
    case 17:
      return launch<17>(cphi, sphi, ph, mag, oc, os, rows, bins, s);
    case 33:
      return launch<33>(cphi, sphi, ph, mag, oc, os, rows, bins, s);
    case 65:
      return launch<65>(cphi, sphi, ph, mag, oc, os, rows, bins, s);
    case 129:
      return launch<129>(cphi, sphi, ph, mag, oc, os, rows, bins, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* nodey_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
