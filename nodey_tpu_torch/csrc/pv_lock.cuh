// Identity phase lock of one frame row, shared by the standalone lock kernel
// (pv_lock.cu) and the fused phase-path kernel (pv_phase_path.cu), as the
// TPU's phase kernel reuses nodey_tpu/ops/pallas_lock.py::_lock_tile.
//
// A row holds B bins: magnitudes, synthesis phasors (cos, sin) and analysis
// phases. A bin is a peak when its magnitude is > the bins 1 and 2 below and
// >= the bins 1 and 2 above (-1 beyond the row's ends). Every other bin
// adopts the nearer of the last peak at or before it and the first peak at
// or after it (the earlier one on a tie) and is re-phased rigidly with it:
//
//   phasor[b] <- phasor[p] * e^{i (ph[b] - ph[p])}.
//
// A row without peaks keeps its own phasors. The TPU kernel finds the two
// peaks with forward and reverse "last valid" doubling scans that carry the
// peak's values. Here a warp ballots the peak flags of 32 bins into one word
// (bit b & 31 of word b >> 5), scans the row's words (scan_words) and finds
// each bin's nearest peaks with a masked __clz / __ffs in its own word
// (nearest_peaks); the peak's values are read by index (from the staged
// frame row in the phase path, from the planes in the standalone lock).
// The last-valid combine only selects seed values, so both find the same
// peaks and the decisions are bitwise equal.
//
// Numbers: the rotation rounds each product and the difference on its own
// (__fmul_rn, __fsub_rn, __fadd_rn), and takes the IEEE sine and cosine
// (cosf and sinf, or sincosf: the same bits), as the plain PyTorch version
// (ops/pv.py::_lock_to_peaks) does on the card.

#pragma once

#include <climits>

namespace nodey_pv {

constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float mag_at(const float* mag, int b, int n) {
  return (b >= 0 && b < n) ? mag[b] : -1.0f;
}

__device__ __forceinline__ bool is_peak(const float* mag, int b, int n) {
  const float m = mag[b];
  return m > mag_at(mag, b - 1, n) && m >= mag_at(mag, b + 1, n) &&
         m > mag_at(mag, b - 2, n) && m >= mag_at(mag, b + 2, n);
}

// Each warp, for every word w of the row's peak flags: the last peak in
// words [0, w] (last[w], or -1) and the first in words [w, kWords)
// (first[w], or INT_MAX). Lane i scans words [i*kChunk, (i+1)*kChunk)
// serially, then the lanes' totals are scanned with shuffles.
template <int kWords>
__device__ __forceinline__ void scan_words(const unsigned* words, int* last,
                                           int* first) {
  constexpr int kChunk = (kWords + 31) / 32;
  const int lane = threadIdx.x & 31;
  unsigned m[kChunk];
  int lo[kChunk], hi[kChunk];
  int acc = -1;
#pragma unroll
  for (int i = 0; i < kChunk; ++i) {
    const int w = lane * kChunk + i;
    m[i] = w < kWords ? words[w] : 0u;
    if (m[i]) acc = 32 * w + 31 - __clz(m[i]);
    lo[i] = acc;
  }
  int acc_hi = INT_MAX;
#pragma unroll
  for (int i = kChunk - 1; i >= 0; --i) {
    if (m[i]) acc_hi = 32 * (lane * kChunk + i) + __ffs(m[i]) - 1;
    hi[i] = acc_hi;
  }
  int up = acc, down = acc_hi;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int u = __shfl_up_sync(kFull, up, off);
    const int d = __shfl_down_sync(kFull, down, off);
    if (lane >= off) up = max(up, u);
    if (lane + off < 32) down = min(down, d);
  }
  int before = __shfl_up_sync(kFull, up, 1);
  int after = __shfl_down_sync(kFull, down, 1);
  if (lane == 0) before = -1;
  if (lane == 31) after = INT_MAX;
#pragma unroll
  for (int i = 0; i < kChunk; ++i) {
    const int w = lane * kChunk + i;
    if (w < kWords) {
      last[w] = max(before, lo[i]);
      first[w] = min(after, hi[i]);
    }
  }
}

// Bin b's nearest peaks from the row's words and this warp's scan of them:
// left, the last peak at or before b (or -1), and right, the first at or
// after it (or INT_MAX).
template <int kWords>
__device__ __forceinline__ void nearest_peaks(int b, const unsigned* words,
                                              const int* last,
                                              const int* first, int& left,
                                              int& right) {
  const int w = b >> 5, bit = b & 31;
  const unsigned m = words[w];
  const int before = last[max(w - 1, 0)];
  const int after = first[min(w + 1, kWords - 1)];
  const unsigned at_or_below = m & (kFull >> (31 - bit));
  const unsigned at_or_above = m & (kFull << bit);
  left = at_or_below ? 32 * w + 31 - __clz(at_or_below)
                     : w > 0 ? before : -1;
  right = at_or_above ? 32 * w + __ffs(at_or_above) - 1
                      : w + 1 < kWords ? after : INT_MAX;
}

// The locked phasor (oc, os) of bin b, whose own phasor is (c_b, s_b) and
// phase ph_b, given its nearest peaks (nearest_peaks): a peak keeps its
// phasor; otherwise the nearer peak (the earlier on a tie), or with none
// the bin's own values, rotated by d = ph_b - ph_p. No branches, so that a
// thread's bins interleave.
//
// kAnyPhase: the phases may be any floats (the standalone lock's inputs),
// so cosf and sinf take their full range (the Payne-Hanek reduction past
// |d| = 105,615, NaN for a NaN or infinite d), as torch.cos and torch.sin
// do. Without it the caller's phases come from atan2f (the phase path):
// |d| <= 2 pi for finite phases, so sincosf keeps to its fast path; a NaN
// d comes from a NaN bin at b or p, whose NaN reaches the phase path's
// output through mag or (cp, sp) either way.
template <bool kAnyPhase = false>
__device__ __forceinline__ void lock_phasor(int b, int left, int right,
                                            float c_b, float s_b, float ph_b,
                                            const float* row_c,
                                            const float* row_s,
                                            const float* row_ph, float& oc,
                                            float& os) {
  const bool has_next = right != INT_MAX;
  const bool use_prev = left >= 0 && (!has_next || b - left <= right - b);
  const int p = use_prev ? left : has_next ? right : b;
  const float cp = row_c[p], sp = row_s[p];
  const float d = __fsub_rn(ph_b, row_ph[p]);
  float sd, cd;
  if constexpr (kAnyPhase) {
    cd = cosf(d);
    sd = sinf(d);
  } else {
    const float x = fabsf(d) < 105615.0f ? d : 0.0f;
    __builtin_assume(fabsf(x) < 105615.0f);
    sincosf(x, &sd, &cd);
  }
  const float rc = __fsub_rn(__fmul_rn(cp, cd), __fmul_rn(sp, sd));
  const float rs = __fadd_rn(__fmul_rn(cp, sd), __fmul_rn(sp, cd));
  oc = left == b ? c_b : rc;
  os = left == b ? s_b : rs;
}

}  // namespace nodey_pv
