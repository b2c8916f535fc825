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
//                           * hop / dpos[k]                   (k > 0)
//   phasor[k] = prod_{j <= k} e^{i adv[j]}       (the prefix along frames)
//   (ry, iy) = mag * lock(phasor)  or  mag * phasor  without the lock,
//
// with omega_dpos = ((b*dpos) mod n_fft) * 2pi/n_fft in int32 first,
// omega_hop = ((b*hop) mod n_fft) * 2pi/n_fft, and the lock of pv_lock.cuh.
//
// Design. The TPU kernel walks (channel, 64-frame tile) grid steps in order
// and carries the running phasor and the previous frame's phase from tile
// to tile in VMEM scratch. CUDA blocks run in no order, so the prefix is
// split into three launches over 64-frame tiles:
//   1. totals: one thread per (channel, tile, bin) multiplies its tile's
//      advances together (re-computing the phase of the frame before the
//      tile from re and im) and writes the tile's total phasor;
//   2. carry:  one thread per (channel, bin) turns the tile totals into
//      the exclusive product of the tiles before each tile;
//   3. apply:  one CTA per (channel, tile) walks its frames in order from
//      its carry, each thread owning a fixed set of bins (running phasor and
//      previous phase in shared memory); with the lock, each frame row is
//      staged in shared memory, locked whole (pv_lock.cuh) and written.
// re and im are read twice (passes 1 and 3) plus one frame row per tile;
// the tile totals (2 * C * K/64 * B floats) are the only other traffic.
//
// What bounds it: bytes. re and im in, ry and iy out: at the config-4
// pitch stage (C = 2, K = 35,460, B = 1025) 1.16 GB, 0.347 ms at 3.35 TB/s.
// This kernel moves 1.5x that (the second read), and does two atan2f and
// two cosf/sinf pairs per bin, so ~100 FP32 operations per element; a
// single read of re and im (a decoupled look-back over the tiles),
// register-blocked rows and a batch axis are later work.
//
// Numbers. The plain PyTorch version (ops/pv.py::phase_path_plain) is held
// to the same roundings where it matters for decisions: the magnitude by
// __fmul_rn/__fadd_rn and IEEE sqrtf (so peak decisions are bitwise
// equal), atan2f/cosf/sinf (the CUDA math library torch calls), the wrap by
// IEEE division and rintf (round half to even, as torch.round), and the
// two multiply-adds of the advance fused (computed in double, where the
// float products are exact, as the plain version does). Only the prefix is
// associated otherwise (serial within a tile and across tiles, where the
// plain version doubles), so the planes agree to float32 round-off.
//
// C interface (loaded with ctypes): nodey_pv_phase_path launches the three
// kernels on the given stream and returns the first cudaGetLastError() that
// is not cudaSuccess; it never synchronizes and allocates nothing.

#include <cuda_runtime.h>

#include "pv_lock.cuh"

namespace {

constexpr int kTile = 64;          // frames per tile
constexpr int kApplyThreads = 256;
constexpr int kLaneThreads = 128;  // passes 1 and 2: one thread per bin
constexpr float kTwoPiF = 6.28318530717958647692f;

struct Geometry {
  int channels, frames, bins, tiles, hop, n_fft;
  float scale_f;       // float32(2*pi / n_fft)
  double omega_scale;  // 2*pi / n_fft
};

// z <- z * (c, s), each product and sum rounded on its own.
__device__ __forceinline__ void cmul(float& zc, float& zs, float c, float s) {
  const float nc = __fsub_rn(__fmul_rn(zc, c), __fmul_rn(zs, s));
  const float ns = __fadd_rn(__fmul_rn(zc, s), __fmul_rn(zs, c));
  zc = nc;
  zs = ns;
}

// a*b + c rounded once to float32: the float32 product is exact in double.
__device__ __forceinline__ float fused(float a, float b, float c) {
  return __double2float_rn(__fma_rn(static_cast<double>(a),
                                    static_cast<double>(b),
                                    static_cast<double>(c)));
}

// The phase advance of frame k > 0 at bin b (dpos = the frame's hop).
__device__ __forceinline__ float advance(float ph, float ph_prev, int dpos,
                                         int b, const Geometry& g) {
  const float omega_dpos = static_cast<float>((b * dpos) % g.n_fft);
  const float dphi = fused(omega_dpos, -g.scale_f, __fsub_rn(ph, ph_prev));
  const float turns = rintf(__fdiv_rn(dphi, kTwoPiF));
  const float wrapped = fused(turns, -kTwoPiF, dphi);
  const float hop_over_dpos = __double2float_rn(
      static_cast<double>(g.hop) / static_cast<double>(dpos));
  const float omega_hop = __double2float_rn(
      static_cast<double>((b * g.hop) % g.n_fft) * g.omega_scale);
  return fused(wrapped, hop_over_dpos, omega_hop);
}

__device__ __forceinline__ float frame_advance(float ph, float ph_prev, int k,
                                               const int* dpos, int b,
                                               const Geometry& g) {
  // Frame 0 seeds the prefix with its absolute analysis phase.
  return k == 0 ? ph : advance(ph, ph_prev, dpos[k], b, g);
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
                       const int* __restrict__ dpos, float* __restrict__ tot_c,
                       float* __restrict__ tot_s, Geometry g) {
  const int b = blockIdx.x * kLaneThreads + threadIdx.x;
  if (b >= g.bins) return;
  const int t = blockIdx.y;
  const int c = blockIdx.z;
  const long long plane = static_cast<long long>(c) * g.frames * g.bins;
  const float* re_c = re + plane;
  const float* im_c = im + plane;
  const int k0 = t * kTile;
  const int k1 = min(k0 + kTile, g.frames);
  float ph_prev = phase_before(re_c, im_c, k0, b, g.bins);
  float pc = 1.0f, ps = 0.0f;
  for (int k = k0; k < k1; ++k) {
    const long long i = static_cast<long long>(k) * g.bins + b;
    const float ph = atan2f(im_c[i], re_c[i]);
    const float adv = frame_advance(ph, ph_prev, k, dpos, b, g);
    cmul(pc, ps, cosf(adv), sinf(adv));
    ph_prev = ph;
  }
  const long long o = (static_cast<long long>(c) * g.tiles + t) * g.bins + b;
  tot_c[o] = pc;
  tot_s[o] = ps;
}

// Pass 2: the exclusive product of the tile totals along the tiles.
__global__ void __launch_bounds__(kLaneThreads)
pv_phase_carry_kernel(const float* __restrict__ tot_c,
                      const float* __restrict__ tot_s,
                      float* __restrict__ car_c, float* __restrict__ car_s,
                      Geometry g) {
  const int i = blockIdx.x * kLaneThreads + threadIdx.x;
  if (i >= g.channels * g.bins) return;
  const int c = i / g.bins;
  const int b = i - c * g.bins;
  float cc = 1.0f, cs = 0.0f;
#pragma unroll 8
  for (int t = 0; t < g.tiles; ++t) {
    const long long o = (static_cast<long long>(c) * g.tiles + t) * g.bins + b;
    const float tc = tot_c[o];
    const float ts = tot_s[o];
    car_c[o] = cc;
    car_s[o] = cs;
    cmul(cc, cs, tc, ts);
  }
}

// Pass 3: one CTA per (channel, tile) walks the tile's frames in order.
template <bool kLock>
__global__ void __launch_bounds__(kApplyThreads)
pv_phase_apply_kernel(const float* __restrict__ re,
                      const float* __restrict__ im,
                      const int* __restrict__ dpos,
                      const float* __restrict__ car_c,
                      const float* __restrict__ car_s, float* __restrict__ ry,
                      float* __restrict__ iy, Geometry g) {
  extern __shared__ float smem[];
  const int bins = g.bins;
  float* run_c = smem;            // each bin's running phasor ...
  float* run_s = run_c + bins;
  float* run_ph = run_s + bins;   // ... and previous analysis phase
  float* row_mag = run_ph + bins; // the current frame row, for the lock
  float* row_ph = row_mag + bins;
  float* row_c = row_ph + bins;
  float* row_s = row_c + bins;
  int* left = reinterpret_cast<int*>(row_s + bins);
  int* right = left + bins;
  __shared__ int tmp[kApplyThreads / 32];

  const int t = blockIdx.x;
  const int c = blockIdx.y;
  const long long plane = static_cast<long long>(c) * g.frames * bins;
  const float* re_c = re + plane;
  const float* im_c = im + plane;
  float* ry_c = ry + plane;
  float* iy_c = iy + plane;
  const int k0 = t * kTile;
  const int k1 = min(k0 + kTile, g.frames);
  for (int b = threadIdx.x; b < bins; b += kApplyThreads) {
    const long long o = (static_cast<long long>(c) * g.tiles + t) * bins + b;
    run_c[b] = car_c[o];
    run_s[b] = car_s[o];
    run_ph[b] = phase_before(re_c, im_c, k0, b, bins);
  }
  for (int k = k0; k < k1; ++k) {
    const long long row = static_cast<long long>(k) * bins;
    // Each thread owns bins b = threadIdx.x (mod kApplyThreads): its running
    // state needs no barrier.
    for (int b = threadIdx.x; b < bins; b += kApplyThreads) {
      const float r = re_c[row + b];
      const float m = im_c[row + b];
      const float mag = sqrtf(__fadd_rn(__fmul_rn(r, r), __fmul_rn(m, m)));
      const float ph = atan2f(m, r);
      const float adv = frame_advance(ph, run_ph[b], k, dpos, b, g);
      float pc = run_c[b], ps = run_s[b];
      cmul(pc, ps, cosf(adv), sinf(adv));
      run_c[b] = pc;
      run_s[b] = ps;
      run_ph[b] = ph;
      if (kLock) {
        row_mag[b] = mag;
        row_ph[b] = ph;
        row_c[b] = pc;
        row_s[b] = ps;
      } else {
        ry_c[row + b] = __fmul_rn(mag, pc);
        iy_c[row + b] = __fmul_rn(mag, ps);
      }
    }
    if (kLock) {
      nodey_pv::find_peaks<kApplyThreads>(row_mag, bins, left, right, tmp);
      for (int b = threadIdx.x; b < bins; b += kApplyThreads) {
        float oc, os;
        nodey_pv::lock_bin(b, row_c, row_s, row_ph, left, right, &oc, &os);
        ry_c[row + b] = __fmul_rn(row_mag[b], oc);
        iy_c[row + b] = __fmul_rn(row_mag[b], os);
      }
      __syncthreads();  // the row is consumed before the next one is staged
    }
  }
}

template <bool kLock>
cudaError_t launch_apply(const float* re, const float* im, const int* dpos,
                         const float* car_c, const float* car_s, float* ry,
                         float* iy, const Geometry& g, cudaStream_t stream) {
  const int smem = 9 * 4 * g.bins;  // seven float rows, two int rows
  auto* kernel = &pv_phase_apply_kernel<kLock>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(g.tiles, g.channels), kApplyThreads, smem, stream>>>(
      re, im, dpos, car_c, car_s, ry, iy, g);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Scratch floats: the tile totals and the carries, 4 * C * tiles * B.
long long nodey_pv_phase_scratch_floats(int channels, int frames, int bins) {
  const long long tiles = (frames + kTile - 1) / kTile;
  return 4LL * channels * tiles * bins;
}

// re, im, ry, iy: [channels, frames, bins] float32; dpos: [frames] int32
// (dpos[0] unused); scratch: nodey_pv_phase_scratch_floats floats. All
// contiguous, on the current device. Returns a cudaError_t (0 on a clean
// launch).
int nodey_pv_phase_path(const float* re, const float* im, const int* dpos,
                        float* ry, float* iy, float* scratch, int channels,
                        int frames, int bins, int hop, int n_fft, int lock,
                        float scale_f, double omega_scale, void* stream) {
  Geometry g;
  g.channels = channels;
  g.frames = frames;
  g.bins = bins;
  g.tiles = (frames + kTile - 1) / kTile;
  g.hop = hop;
  g.n_fft = n_fft;
  g.scale_f = scale_f;
  g.omega_scale = omega_scale;
  const long long plane = static_cast<long long>(channels) * g.tiles * bins;
  float* tot_c = scratch;
  float* tot_s = tot_c + plane;
  float* car_c = tot_s + plane;
  float* car_s = car_c + plane;
  cudaStream_t s = static_cast<cudaStream_t>(stream);

  const int lane_blocks = (bins + kLaneThreads - 1) / kLaneThreads;
  pv_phase_totals_kernel<<<dim3(lane_blocks, g.tiles, channels), kLaneThreads,
                           0, s>>>(re, im, dpos, tot_c, tot_s, g);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int carry_blocks = (channels * bins + kLaneThreads - 1) / kLaneThreads;
  pv_phase_carry_kernel<<<carry_blocks, kLaneThreads, 0, s>>>(
      tot_c, tot_s, car_c, car_s, g);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = lock ? launch_apply<true>(re, im, dpos, car_c, car_s, ry, iy, g, s)
             : launch_apply<false>(re, im, dpos, car_c, car_s, ry, iy, g, s);
  return static_cast<int>(err);
}

const char* nodey_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
