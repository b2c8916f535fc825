// Phase-vocoder phase path for Hopper (sm_90a), FP32 on the CUDA cores.
//
// Replaces nodey_tpu/ops/pallas_phase.py::phase_path_pallas (kernel
// _phase_kernel), the main path of the phase vocoder between its analysis
// and synthesis GEMMs. From the forward-DFT planes re, im [C, K, B] and the
// integer analysis hops dpos [K] it computes, per channel c, frame k, bin b:
//
//   mag = sqrt(re^2 + im^2),  ph = atan2(im, re)
//   adv[k] = ph[0]                                            (k = 0)
//          = omega_hop[b] + wrap(ph[k] - ph[k-1] - omega_dpos[k, b])
//                           * hop_over_dpos[k]                (k > 0)
//   phasor[k] = prod_{j <= k} e^{i adv[j]}       (the prefix along frames)
//   (ry, iy) = mag * lock(phasor)  or  mag * phasor  without the lock,
//
// with omega_dpos = ((b*dpos) & (n_fft-1)) * 2pi/n_fft (n_fft a power of
// two) and the lock of pv_lock.cuh. The wrapper builds the per-frame
// hop_over_dpos [K] = float32(hop / dpos) and the per-bin omega_hop [B] =
// float32(((b*hop) mod n_fft) * 2pi/n_fft) on the host, the values the
// plain version uses, so no element divides or takes a remainder.
//
// Design. The TPU kernel walks (channel, 64-frame tile) grid steps in order
// and carries the running phasor and the previous frame's phase from tile
// to tile in VMEM scratch. CUDA blocks run in no order, so the prefix is
// split into three launches over the same 64-frame tiles:
//   1. totals: one thread per (channel, tile, bin) multiplies its tile's
//      advances together (re-computing the phase of the frame before the
//      tile from re and im) and writes the tile's total phasor;
//   2. carry:  one thread per (channel, bin) turns the tile totals into
//      the exclusive product of the tiles before each tile;
//   3. apply:  one CTA per (channel, tile) walks its frames in order from
//      its carry. Its 512 main threads own bins j*512 + t (two each at
//      B = 1025: a warp holds 32 neighbouring bins of each slot), and one
//      more warp owns the top bin, so no main warp walks a third. Each
//      bin's running phasor and previous phase stay in registers, the next
//      frame's re and im are loaded before this one is computed, and a
//      lane hands out the tile's hops by shuffle. Without the lock nothing
//      is shared. With it, the frame row (mag, ph, phasor) goes to one of
//      two shared buffers; after one barrier each warp ballots its bins'
//      peak flags into a word per 32 bins, and after a second each warp
//      scans the words (shuffles) for the last peak at or before and the
//      first at or after each word, so a bin finds its nearest peaks with a
//      masked __clz / __ffs and locks without a branch (lock_phasor): a
//      thread's two bins interleave. Two barriers a frame (the parent's
//      block scans took ten).
// re and im are read twice (passes 1 and 3) plus one frame row per tile;
// the tile totals (2 * C * K/T * B floats) are the only other traffic.
//
// Waves. A CTA walks its frames in series, so a last wave of apply CTAs
// that is mostly empty costs nearly a full one. Two CTAs fit an SM at
// B = 1025 (264 on 132 SMs): config 4's K = 35,460 takes 2 x 555 CTAs,
// 4.2 waves, and K = 22,520 2 x 352, 2.7 waves. Tiles of 54 and 57 frames
// would fill whole waves (5 and 3; 7% off the apply pass, PERF.md §6), but
// the tile length sets how the prefix is associated, and config 4's
// second PV stage turns on the last bits of the first stage's planes. So
// every grid keeps 64-frame tiles: one association at every shape, the
// one the 10 s excerpt of chip_smoke.py's phase 10 holds end to end.
//
// What bounds it: bytes. re and im in, ry and iy out: at the config-4
// pitch stage (C = 2, K = 35,460, B = 1025) 1.16 GB, 0.347 ms at 3.35 TB/s.
// This kernel moves 1.5x that (the second read) and does two atan2f, two
// sincosf and, with the lock, a third per bin, so the CUDA cores and the
// latency of those chains bound it: the apply pass holds 1088 threads an
// SM (56 registers each), two bins each. A single read of re and im does
// not fit: a CTA would hold a tile's state until its carry arrived
// (ROADMAP).
//
// Numbers. The plain PyTorch version (ops/pv.py::phase_path_plain) is held
// to the same roundings where it matters for decisions: the magnitude by
// __fmul_rn/__fadd_rn and IEEE sqrtf (so peak decisions are bitwise
// equal), atan2f/cosf/sinf (the CUDA math library torch calls; sincosf
// gives cosf's and sinf's bits), the wrap's turns as IEEE division and
// rintf (round half to even, as torch.round) give them (turns_of). The
// advance's multiply-adds are float32 FMAs (see advance()). Only the prefix is associated otherwise (serial
// within a tile and across tiles, where the plain version doubles), so the
// planes agree to float32 round-off.
//
// C interface (loaded with ctypes): nodey_pv_phase_path launches the three
// kernels on the given stream and returns the first cudaGetLastError() that
// is not cudaSuccess; it never synchronizes and allocates nothing.

#include <cuda_runtime.h>

#include <climits>

#include "pv_lock.cuh"

namespace {

constexpr int kTile = 64;          // frames per tile
constexpr int kLaneThreads = 128;  // pass 1: one thread per bin
// Pass 2: one warp a CTA, so its C * B / 32 warps spread over as many SMs,
// each with 16 tiles' loads in flight (the loop's unroll).
constexpr int kCarryThreads = 32;
constexpr float kTwoPiF = 6.28318530717958647692f;
constexpr float kTurn1 = 0x1.921fb8p+1f;  // see turns_of
constexpr float kTurn2 = 0x1.2d97c8p+3f;
constexpr float kTurn3 = 0x1.f6a7a6p+3f;
using nodey_pv::kFull;

struct Geometry {
  int channels, frames, bins, tiles;  // tiles: of kTile frames
  int mask;                                 // n_fft - 1
  float neg_scale;                          // -float32(2*pi / n_fft)
};

// z <- z * (c, s), each product and sum rounded on its own.
__device__ __forceinline__ void cmul(float& zc, float& zs, float c, float s) {
  const float nc = __fsub_rn(__fmul_rn(zc, c), __fmul_rn(zs, s));
  const float ns = __fadd_rn(__fmul_rn(zc, s), __fmul_rn(zs, c));
  zc = nc;
  zs = ns;
}

// rintf(__fdiv_rn(dphi, 2pi_f)) (IEEE division, ties to even) for
// |dphi| < 7 pi, without the division: that quotient never falls as |dphi|
// grows and is odd in dphi, so its rounding is the count of the thresholds
// kTurn1..3 at or below |dphi|, with dphi's sign (-0 for a small negative
// dphi, as rintf). kTurnM is the least float whose quotient rounds to M
// (tests/test_torch_pv_phase_tables.py holds each and the float below it).
// The advance's |dphi| < 4 pi + 2^-20: |ph - ph_prev| <= 2pi_f and the
// bin term is below 2pi_f. A NaN dphi gives +-0 turns and a NaN wrap.
__device__ __forceinline__ float turns_of(float dphi) {
  const float a = fabsf(dphi);
  const float n = (a >= kTurn1 ? 1.0f : 0.0f) + (a >= kTurn2 ? 1.0f : 0.0f) +
                  (a >= kTurn3 ? 1.0f : 0.0f);
  return copysignf(n, dphi);
}

// The phase advance of frame k > 0 at bin b: dpos = the frame's hop, hod =
// hop_over_dpos[k] and oh = omega_hop[b]. Each multiply-add is one float32
// FMA, rounded once, as the JAX package's compiled XLA computes it. The
// plain version rounds the exact value to float64 first: the two differ only
// where that rounding lands on a float32 tie. The wrap's never does: with
// turns != 0, |dphi| >= pi, so dphi and turns*2pi_f are multiples of 2^-22
// below 2^6 and their difference is exact in float64.
__device__ __forceinline__ float advance(float ph, float ph_prev, int b,
                                         int dpos, float hod, float oh,
                                         const Geometry& g) {
  const float omega_dpos = static_cast<float>((b * dpos) & g.mask);
  const float dphi = __fmaf_rn(omega_dpos, g.neg_scale, __fsub_rn(ph, ph_prev));
  const float wrapped = __fmaf_rn(turns_of(dphi), -kTwoPiF, dphi);
  return __fmaf_rn(wrapped, hod, oh);
}

// The analysis phase of frame k - 1 at bin b (0 before the first frame,
// where it is not used).
__device__ __forceinline__ float phase_before(const float* re, const float* im,
                                              int k, int b, int bins) {
  if (k == 0) return 0.0f;
  const long long i = static_cast<long long>(k - 1) * bins + b;
  return atan2f(im[i], re[i]);
}

// Pass 1: each tile's product of advances.
__global__ void __launch_bounds__(kLaneThreads)
pv_phase_totals_kernel(const float* __restrict__ re,
                       const float* __restrict__ im,
                       const int* __restrict__ dpos,
                       const float* __restrict__ hop_over_dpos,
                       const float* __restrict__ omega_hop,
                       float* __restrict__ tot_c, float* __restrict__ tot_s,
                       Geometry g) {
  const int b = blockIdx.x * kLaneThreads + threadIdx.x;
  if (b >= g.bins) return;
  const int t = blockIdx.y;
  const int c = blockIdx.z;
  const long long plane = static_cast<long long>(c) * g.frames * g.bins;
  const float* re_c = re + plane;
  const float* im_c = im + plane;
  const int k0 = t * kTile;
  const int k1 = min(k0 + kTile, g.frames);
  const float oh = omega_hop[b];
  float ph_prev = phase_before(re_c, im_c, k0, b, g.bins);
  float pc = 1.0f, ps = 0.0f;
#pragma unroll 4
  for (int k = k0; k < k1; ++k) {
    const long long i = static_cast<long long>(k) * g.bins + b;
    const float ph = atan2f(im_c[i], re_c[i]);
    // Frame 0 seeds the prefix with its absolute analysis phase.
    const float adv = k == 0 ? ph
        : advance(ph, ph_prev, b, dpos[k], hop_over_dpos[k], oh, g);
    float sa, ca;
    sincosf(adv, &sa, &ca);
    cmul(pc, ps, ca, sa);
    ph_prev = ph;
  }
  const long long o = (static_cast<long long>(c) * g.tiles + t) * g.bins + b;
  tot_c[o] = pc;
  tot_s[o] = ps;
}

// Pass 2: the exclusive product of the tile totals along the tiles.
__global__ void __launch_bounds__(kCarryThreads)
pv_phase_carry_kernel(const float* __restrict__ tot_c,
                      const float* __restrict__ tot_s,
                      float* __restrict__ car_c, float* __restrict__ car_s,
                      Geometry g) {
  const int i = blockIdx.x * kCarryThreads + threadIdx.x;
  if (i >= g.channels * g.bins) return;
  const int c = i / g.bins;
  const int b = i - c * g.bins;
  float cc = 1.0f, cs = 0.0f;
#pragma unroll 16
  for (int t = 0; t < g.tiles; ++t) {
    const long long o = (static_cast<long long>(c) * g.tiles + t) * g.bins + b;
    const float tc = tot_c[o];
    const float ts = tot_s[o];
    car_c[o] = cc;
    car_s[o] = cs;
    cmul(cc, cs, tc, ts);
  }
}

// One bin of frame k from its re and im: the magnitude and phase, with the
// running phasor and the previous phase advanced in place.
__device__ __forceinline__ void step_bin(float r, float m, int k, int b,
                                         int dpos, float hod, float oh,
                                         const Geometry& g, float& run_c,
                                         float& run_s, float& prev,
                                         float& mag, float& ph) {
  mag = sqrtf(__fadd_rn(__fmul_rn(r, r), __fmul_rn(m, m)));
  ph = atan2f(m, r);
  // Frame 0 seeds the prefix with its absolute analysis phase.
  const float adv = k == 0 ? ph : advance(ph, prev, b, dpos, hod, oh, g);
  float sa, ca;
  sincosf(adv, &sa, &ca);
  cmul(run_c, run_s, ca, sa);
  prev = ph;
}

// The apply pass's rows: B = JM*NT + 1 bins (n_fft a power of two). NT
// main threads own bins j*NT + t (j < JM); one more warp, the top warp,
// owns the top bin JM*NT in its lane 0, so no main warp walks an extra bin.
// Words of peak flags: one per 32 bins, the top bin's last.
__host__ __device__ constexpr int apply_words(int nt, int jm) {
  return jm * nt / 32 + 1;
}

// Shared memory of the locked apply pass: two frame rows (mag, ph, cos,
// sin; frame k uses row k & 1), the row's peak words, and each warp's scan
// of them.
__host__ __device__ constexpr long long apply_smem_bytes(int nt, int jm,
                                                         int bins) {
  return 2LL * 4 * bins * 4 +
         apply_words(nt, jm) * 4LL * (1 + 2 * (nt / 32 + 1));
}

// CTAs an SM is to hold: two up to 1025 bins (two of 512 + 32 threads at
// config 4's B = 1025), one above.
__host__ __device__ constexpr int apply_min_ctas(int jm) {
  return jm <= 2 ? 2 : 1;
}

// Pass 3: one CTA per (channel, tile) walks the tile's frames in order.
template <int NT, int JM, bool kLock>
__global__ void __launch_bounds__(NT + 32, apply_min_ctas(JM))
pv_phase_apply_kernel(const float* __restrict__ re,
                      const float* __restrict__ im,
                      const int* __restrict__ dpos,
                      const float* __restrict__ hop_over_dpos,
                      const float* __restrict__ omega_hop,
                      const float* __restrict__ car_c,
                      const float* __restrict__ car_s, float* __restrict__ ry,
                      float* __restrict__ iy, Geometry g) {
  constexpr int kWarps = NT / 32;  // main warps; warp kWarps is the top warp
  constexpr int kWords = apply_words(NT, JM);
  extern __shared__ float smem[];
  const int bins = g.bins;
  const int top = bins - 1;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const bool top_warp = warp == kWarps;
  unsigned* words = reinterpret_cast<unsigned*>(smem + 8 * bins);
  int* last = reinterpret_cast<int*>(words + kWords) + warp * 2 * kWords;
  int* first = last + kWords;
  // Slot j of this thread: bin j*NT + tid, or the top bin (top warp, lane
  // 0, slot 0 only).
  auto live = [&](int j) { return !top_warp || (j == 0 && lane == 0); };
  auto bin_of = [&](int j) { return top_warp ? top : j * NT + tid; };

  const int t = blockIdx.x;
  const int c = blockIdx.y;
  const long long plane = static_cast<long long>(c) * g.frames * bins;
  const float* re_c = re + plane;
  const float* im_c = im + plane;
  float* ry_c = ry + plane;
  float* iy_c = iy + plane;
  const int k0 = t * kTile;
  const int k1 = min(k0 + kTile, g.frames);
  // The tile's hops and hop/dpos, two frames a lane, shuffled out per frame.
  int dp_lo = 1, dp_hi = 1;
  float hod_lo = 0.0f, hod_hi = 0.0f;
  if (k0 + lane < k1) {
    dp_lo = dpos[k0 + lane];
    hod_lo = hop_over_dpos[k0 + lane];
  }
  if (k0 + 32 + lane < k1) {
    dp_hi = dpos[k0 + 32 + lane];
    hod_hi = hop_over_dpos[k0 + 32 + lane];
  }

  float run_c[JM], run_s[JM], prev[JM], oh[JM], cur_r[JM], cur_i[JM];
#pragma unroll
  for (int j = 0; j < JM; ++j) {
    run_c[j] = 1.0f, run_s[j] = 0.0f, prev[j] = 0.0f, oh[j] = 0.0f;
    cur_r[j] = 0.0f, cur_i[j] = 0.0f;
    if (live(j)) {
      const int b = bin_of(j);
      const long long o = (static_cast<long long>(c) * g.tiles + t) * bins + b;
      run_c[j] = car_c[o];
      run_s[j] = car_s[o];
      prev[j] = phase_before(re_c, im_c, k0, b, bins);
      oh[j] = omega_hop[b];
      cur_r[j] = re_c[static_cast<long long>(k0) * bins + b];
      cur_i[j] = im_c[static_cast<long long>(k0) * bins + b];
    }
  }
  for (int k = k0; k < k1; ++k) {
    const long long row = static_cast<long long>(k) * bins;
    // The next frame's loads go out before this frame is computed.
    float nxt_r[JM], nxt_i[JM];
    const bool more = k + 1 < k1;
#pragma unroll
    for (int j = 0; j < JM; ++j) {
      nxt_r[j] = 0.0f, nxt_i[j] = 0.0f;
      if (more && live(j)) {
        nxt_r[j] = re_c[row + bins + bin_of(j)];
        nxt_i[j] = im_c[row + bins + bin_of(j)];
      }
    }
    const int i = k - k0;
    const int dp = __shfl_sync(kFull, i < 32 ? dp_lo : dp_hi, i & 31);
    const float hod = __shfl_sync(kFull, i < 32 ? hod_lo : hod_hi, i & 31);
    float* row_mag = smem + (k & 1) * 4 * bins;
    float* row_ph = row_mag + bins;
    float* row_c = row_ph + bins;
    float* row_s = row_c + bins;
    float mag[JM], ph[JM];
#pragma unroll
    for (int j = 0; j < JM; ++j) {
      mag[j] = 0.0f, ph[j] = 0.0f;
      if (!live(j)) continue;
      const int b = bin_of(j);
      step_bin(cur_r[j], cur_i[j], k, b, dp, hod, oh[j], g, run_c[j],
               run_s[j], prev[j], mag[j], ph[j]);
      if (kLock) {
        row_mag[b] = mag[j];
        row_ph[b] = ph[j];
        row_c[b] = run_c[j];
        row_s[b] = run_s[j];
      } else {
        ry_c[row + b] = __fmul_rn(mag[j], run_c[j]);
        iy_c[row + b] = __fmul_rn(mag[j], run_s[j]);
      }
    }
    if (kLock) {
      // The row is staged (the other buffer was last read two frames ago,
      // before the previous frame's barriers).
      __syncthreads();
      if (top_warp) {
        const unsigned peaks = __ballot_sync(
            kFull, lane == 0 && nodey_pv::is_peak(row_mag, top, bins));
        if (lane == 0) words[kWords - 1] = peaks;
      } else {
#pragma unroll
        for (int j = 0; j < JM; ++j) {
          const unsigned peaks = __ballot_sync(
              kFull, nodey_pv::is_peak(row_mag, bin_of(j), bins));
          if (lane == 0) words[j * kWarps + warp] = peaks;
        }
      }
      __syncthreads();  // every word is in
      nodey_pv::scan_words<kWords>(words, last, first);
      __syncwarp();
      if (!top_warp) {
#pragma unroll
        for (int j = 0; j < JM; ++j) {
          const int b = bin_of(j);
          int left, right;
          nodey_pv::nearest_peaks<kWords>(b, words, last, first, left,
                                          right);
          float oc, os;
          nodey_pv::lock_phasor(b, left, right, run_c[j], run_s[j], ph[j],
                                row_c, row_s, row_ph, oc, os);
          ry_c[row + b] = __fmul_rn(mag[j], oc);
          iy_c[row + b] = __fmul_rn(mag[j], os);
        }
      } else if (lane == 0) {
        int left, right;
        nodey_pv::nearest_peaks<kWords>(top, words, last, first, left,
                                        right);
        float oc, os;
        nodey_pv::lock_phasor(top, left, right, run_c[0], run_s[0], ph[0],
                              row_c, row_s, row_ph, oc, os);
        ry_c[row + top] = __fmul_rn(mag[0], oc);
        iy_c[row + top] = __fmul_rn(mag[0], os);
      }
    }
#pragma unroll
    for (int j = 0; j < JM; ++j) {
      cur_r[j] = nxt_r[j];
      cur_i[j] = nxt_i[j];
    }
  }
}

// The apply pass's CTA shape for rows of `bins` = 2^m + 1 bins, those of
// pv_params' n_fft (512 to 8192): (main threads, bins a main thread), or
// (0, 0) for another count.
struct ApplyShape {
  int nt, jm;
};

ApplyShape apply_shape(int bins) {
  const int main = bins - 1;
  if (main < 256 || main > 4096 || (main & (main - 1)) != 0) return {0, 0};
  return main == 256 ? ApplyShape{256, 1} : ApplyShape{512, main / 512};
}

template <int NT, int JM, bool kLock>
cudaError_t launch_apply(const float* re, const float* im, const int* dpos,
                         const float* hod, const float* omega_hop,
                         const float* car_c, const float* car_s, float* ry,
                         float* iy, const Geometry& g, cudaStream_t stream) {
  const int smem = kLock ? static_cast<int>(apply_smem_bytes(NT, JM, g.bins))
                         : 0;
  auto* kernel = &pv_phase_apply_kernel<NT, JM, kLock>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(g.tiles, g.channels), NT + 32, smem, stream>>>(
      re, im, dpos, hod, omega_hop, car_c, car_s, ry, iy, g);
  return cudaGetLastError();
}

template <bool kLock>
cudaError_t dispatch_apply(const float* re, const float* im, const int* dpos,
                           const float* hod, const float* omega_hop,
                           const float* car_c, const float* car_s, float* ry,
                           float* iy, const Geometry& g, cudaStream_t stream) {
  const ApplyShape shape = apply_shape(g.bins);
#define NODEY_PV_APPLY(NT_, JM_)                                           \
  if (shape.nt == NT_ && shape.jm == JM_)                                  \
    return launch_apply<NT_, JM_, kLock>(re, im, dpos, hod, omega_hop,     \
                                         car_c, car_s, ry, iy, g, stream);
  NODEY_PV_APPLY(256, 1)
  NODEY_PV_APPLY(512, 1)
  NODEY_PV_APPLY(512, 2)
  NODEY_PV_APPLY(512, 4)
  NODEY_PV_APPLY(512, 8)
#undef NODEY_PV_APPLY
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Scratch floats: the tile totals and the carries, 4 * C * tiles * B.
long long nodey_pv_phase_scratch_floats(int channels, int frames, int bins) {
  const long long tiles = (frames + kTile - 1) / kTile;
  return 4LL * channels * tiles * bins;
}

// Dynamic shared memory of the apply pass for rows of `bins` (0 without the
// lock), or -1 for a row the apply pass does not take (bins = 2^m + 1,
// 257 <= bins <= 4097).
long long nodey_pv_phase_smem_bytes(int bins, int lock) {
  const ApplyShape shape = apply_shape(bins);
  if (shape.nt == 0) return -1;
  return lock ? apply_smem_bytes(shape.nt, shape.jm, bins) : 0;
}

// re, im, ry, iy: [channels, frames, bins] float32; dpos: [frames] int32,
// hop_over_dpos: [frames] float32 (entry 0 of both unused); omega_hop:
// [bins] float32; scratch: nodey_pv_phase_scratch_floats floats. All
// contiguous, on the current device. n_fft is a power of two and scale_f =
// float32(2*pi / n_fft). Returns a cudaError_t (0 on a clean launch).
int nodey_pv_phase_path(const float* re, const float* im, const int* dpos,
                        const float* hop_over_dpos, const float* omega_hop,
                        float* ry, float* iy, float* scratch, int channels,
                        int frames, int bins, int n_fft, int lock,
                        float scale_f, void* stream) {
  Geometry g;
  g.channels = channels;
  g.frames = frames;
  g.bins = bins;
  g.tiles = (frames + kTile - 1) / kTile;
  g.mask = n_fft - 1;
  g.neg_scale = -scale_f;
  const long long plane = static_cast<long long>(channels) * g.tiles * bins;
  float* tot_c = scratch;
  float* tot_s = tot_c + plane;
  float* car_c = tot_s + plane;
  float* car_s = car_c + plane;
  cudaStream_t s = static_cast<cudaStream_t>(stream);

  const int lane_blocks = (bins + kLaneThreads - 1) / kLaneThreads;
  pv_phase_totals_kernel<<<dim3(lane_blocks, g.tiles, channels), kLaneThreads,
                           0, s>>>(re, im, dpos, hop_over_dpos, omega_hop,
                                   tot_c, tot_s, g);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int carry_blocks =
      (channels * bins + kCarryThreads - 1) / kCarryThreads;
  pv_phase_carry_kernel<<<carry_blocks, kCarryThreads, 0, s>>>(
      tot_c, tot_s, car_c, car_s, g);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = lock ? dispatch_apply<true>(re, im, dpos, hop_over_dpos, omega_hop,
                                    car_c, car_s, ry, iy, g, s)
             : dispatch_apply<false>(re, im, dpos, hop_over_dpos, omega_hop,
                                     car_c, car_s, ry, iy, g, s);
  return static_cast<int>(err);
}

const char* nodey_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
