// Identity phase lock of one frame row, shared by the standalone lock kernel
// (pv_lock.cu) and the fused phase-path kernel (pv_phase_path.cu), as the
// TPU's phase kernel reuses nodey_tpu/ops/pallas_lock.py::_lock_tile.
//
// A row holds B bins in shared memory: magnitudes, synthesis phasors
// (cos, sin) and analysis phases. A bin is a peak when its magnitude is
// > the bins 1 and 2 below and >= the bins 1 and 2 above (-1 beyond the
// row's ends). Every other bin adopts the nearer of the last peak at or
// before it and the first peak at or after it (the earlier one on a tie)
// and is re-phased rigidly with it:
//
//   phasor[b] <- phasor[p] * e^{i (ph[b] - ph[p])}.
//
// A row without peaks keeps its own phasors. The TPU kernel finds the two
// peaks with forward and reverse "last valid" doubling scans that carry the
// peak's values; here the nearest peak on the left is an inclusive max-scan
// of (peak ? b : -1) along the row, the one on the right a suffix min-scan
// of (peak ? b : INT_MAX), and the peak's values are read from shared memory
// by index. The last-valid combine only selects seed values, so both find
// the same peaks and the decisions are bitwise equal.
//
// Numbers: the rotation rounds each product and the difference on its own
// (__fmul_rn, __fsub_rn, __fadd_rn), and uses the IEEE cosf/sinf, as the
// plain PyTorch version (ops/pv.py::_lock_to_peaks) does on the card.

#pragma once

#include <climits>

namespace nodey_pv {

// Inclusive scan (max, or min when kMin) of a[0..n) in shared memory, from
// the left, or from the right when `reverse`. Each of the NT threads scans
// one contiguous chunk serially; the chunk totals are scanned across warps
// through `tmp` [NT / 32]. Starts and ends with a block barrier.
template <int NT, bool kMin>
__device__ __forceinline__ void block_scan(int* a, int n, bool reverse,
                                           int* tmp) {
  const int identity = kMin ? INT_MAX : -1;
  auto op = [](int x, int y) { return kMin ? min(x, y) : max(x, y); };
  const int per = (n + NT - 1) / NT;
  const int lo = threadIdx.x * per;
  const int hi = min(lo + per, n);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  __syncthreads();
  int acc = identity;
  for (int i = lo; i < hi; ++i) {
    const int p = reverse ? n - 1 - i : i;
    acc = op(acc, a[p]);
    a[p] = acc;
  }
  int incl = acc;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl = op(incl, v);
  }
  if (lane == 31) tmp[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int v = lane < NT / 32 ? tmp[lane] : identity;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, v, off);
      if (lane >= off) v = op(v, u);
    }
    if (lane < NT / 32) tmp[lane] = v;
  }
  __syncthreads();
  int before = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) before = identity;
  const int prefix = op(warp > 0 ? tmp[warp - 1] : identity, before);
  for (int i = lo; i < hi; ++i) {
    const int p = reverse ? n - 1 - i : i;
    a[p] = op(prefix, a[p]);
  }
  __syncthreads();
}

__device__ __forceinline__ float mag_at(const float* mag, int b, int n) {
  return (b >= 0 && b < n) ? mag[b] : -1.0f;
}

__device__ __forceinline__ bool is_peak(const float* mag, int b, int n) {
  const float m = mag[b];
  return m > mag_at(mag, b - 1, n) && m >= mag_at(mag, b + 1, n) &&
         m > mag_at(mag, b - 2, n) && m >= mag_at(mag, b + 2, n);
}

// Find each bin's nearest peaks: left[b] = the last peak <= b (or -1),
// right[b] = the first peak >= b (or INT_MAX). Starts with a block barrier,
// so `mag` may be written just before the call; ends with one.
template <int NT>
__device__ __forceinline__ void find_peaks(const float* mag, int n, int* left,
                                           int* right, int* tmp) {
  __syncthreads();
  for (int b = threadIdx.x; b < n; b += NT) {
    const bool peak = is_peak(mag, b, n);
    left[b] = peak ? b : -1;
    right[b] = peak ? b : INT_MAX;
  }
  block_scan<NT, false>(left, n, false, tmp);
  block_scan<NT, true>(right, n, true, tmp);
}

// The locked phasor of bin b, after find_peaks.
__device__ __forceinline__ void lock_bin(int b, const float* cphi,
                                         const float* sphi, const float* ph,
                                         const int* left, const int* right,
                                         float* oc, float* os) {
  const int prev = left[b];
  if (prev == b) {  // a peak keeps its phasor
    *oc = cphi[b];
    *os = sphi[b];
    return;
  }
  const int next = right[b];
  const bool has_next = next != INT_MAX;
  int p = b;  // no peak in the row: the bin's own values
  if (prev >= 0 && (!has_next || b - prev <= next - b)) {
    p = prev;
  } else if (has_next) {
    p = next;
  }
  const float cp = cphi[p], sp = sphi[p];
  const float d = __fsub_rn(ph[b], ph[p]);
  const float cd = cosf(d), sd = sinf(d);
  *oc = __fsub_rn(__fmul_rn(cp, cd), __fmul_rn(sp, sd));
  *os = __fadd_rn(__fmul_rn(cp, sd), __fmul_rn(sp, cd));
}

}  // namespace nodey_pv
