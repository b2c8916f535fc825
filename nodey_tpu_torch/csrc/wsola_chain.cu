// WSOLA greedy splice chain for Hopper (sm_90a), FP32 on the CUDA cores.
//
// Replaces nodey_tpu/ops/pallas_wsola.py::_wsola_chain_pallas_impl with
// emit_audio=True, the TPU's serial-chain kernel, through both of its
// entries: the offline one (wsola_chain_assemble_pallas, pallas_wsola.py:360)
// and the chunk one of the streaming WSOLA step (wsola_chunk_chain_pallas,
// :408, with its k0_base and head_override). Both compute, for frames
// i = 0 .. K-1 with window position pos(i) = frame_pos(k0 + i) - base,
// frame_pos(k) = (k*num + den/2) / den, and the previous realized tail
// [C, overlap] (frame 0: `head`):
//
//   score[b] = (sum_{c,v} tail[c][v] * w[c][b+v])
//              * rsqrt(sum_{c,v} w[c][b+v]^2 + 1e-9),   b = 0 .. seek
//   bs[k]    = the first b with the largest score
//   body[c][k*stride + j] = tail[c][j]*fade_out[j] + seg[c][j]*fade_in[j]
//                           (j < overlap), else seg[c][j]  (j < stride)
//   next tail = seg[c][stride .. stride+overlap),  seg = w[c][bs[k] ..]
//
// where w is the window x[c][pos(i) .. pos(i) + seek + seq) and bs[i],
// body's i-th stride belong to frame i. Offline, k0 = base = 0 and `head` is
// x's first `overlap` samples. A chunk step passes the FIFO snapshot x whose
// column 0 is input sample `base`, the first frame k0 it has not yet emitted,
// and the tail it carried from the previous step; the kernel also writes the
// tail realized after its last frame to `tail_out` (the next step's head).
// The TPU entry runs a fixed k_cap frames and masks the ones that are not
// ready; here the wrapper launches exactly the ready frames.
//
// Design. Each frame depends on the previous frame's choice, so the chain
// is serial: one CTA per clip loops over all K frames. What the TPU kernel
// did for Mosaic (the 128-lane DMA superset window, the 3-slot rotation, the
// 16-sublane pre-shifted window) has no counterpart here. Per frame:
//   * the window positions do not depend on the data (only the splice
//     does), so frame k+1's window is copied into shared memory with
//     cp.async while frame k is scored: two window buffers, double-buffered;
//   * the realized tail [C, overlap] stays in shared memory across frames;
//   * the seek+1 candidates are spread over the block's threads (one
//     candidate per thread, 721 of 768 threads at 48 kHz); each sums its
//     correlation and its energy directly, channel by channel, in tap order;
//   * a block-wide argmax keeps the lowest index on ties (and ranks NaN
//     above every number, as np.argmax and torch.argmax do);
//   * bs[k] and the frame's [C, stride] output are written straight to
//     device memory (the fused assembly).
//
// What bounds it: 2*C*overlap*(seek+1) multiply-adds per frame (1.1M at
// 48 kHz stereo, correlation and energy), all on ONE SM, with one shared
// load per multiply-add (the tail value is a broadcast). A chunk launch is
// the same serial chain over one step's ready frames: at most k_cap, 633 and
// 405 at config 4's two stages with 16 s chunks. The whole card would do the
// same work ~132x faster; splitting a frame's candidates over a
// thread-block cluster and computing every frame's energies in a parallel
// prologue (they do not depend on the chain) are later work.
//
// Numbers. The score is corr * (1 / sqrtf(energy + 1e-9f)) with IEEE sqrtf
// and IEEE division, not rsqrtf: rsqrtf is approximate (2 ulp), while this
// form is what torch.rsqrt computes for float32 on the CPU, so a score
// differs from the plain version's only by the order of its sums. The fade
// and blend use __fdiv_rn / __fmul_rn / __fadd_rn (no contraction into FMA),
// the plain version's separate roundings, so given equal decisions the
// emitted audio is bitwise the plain version's.
//
// C interface (loaded with ctypes): nodey_wsola_chain, the one entry of
// both, launches on the given stream and returns cudaGetLastError(); it
// never synchronizes and allocates nothing.

#include <cuda_runtime.h>

#include <climits>
#include <cmath>

namespace {

constexpr int kThreads = 768;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ void cp_async_f32(float* dst, const float* src) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(addr),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most one group (the newest) of this thread's copies is
// still in flight.
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ long long frame_pos(long long k, long long num,
                                               long long den) {
  return (k * num + den / 2) / den;
}

// True when (a, ia) ranks before (b, ib): NaN first, then the larger score,
// then the lower index.
__device__ __forceinline__ bool ranks_before(float a, int ia, float b,
                                             int ib) {
  const bool a_nan = isnan(a), b_nan = isnan(b);
  if (a_nan != b_nan) return a_nan;
  if (!a_nan && a != b) return a > b;
  return ia < ib;
}

// Copy the window [channels][win] at column `pos` of x (row stride `ld`)
// into `buf` (no wait).
__device__ __forceinline__ void stage_window(float* buf, const float* x,
                                             long long ld, int channels,
                                             long long pos, int win) {
  for (int i = threadIdx.x; i < channels * win; i += kThreads) {
    const int c = i / win;
    const int j = i - c * win;
    cp_async_f32(buf + i, x + c * ld + pos + j);
  }
}

__global__ void __launch_bounds__(kThreads)
wsola_chain_kernel(const float* __restrict__ x, const float* __restrict__ head,
                   int* __restrict__ bs, float* __restrict__ body,
                   float* __restrict__ tail_out, int channels, long long ld,
                   int frames, long long k0, long long base, long long num,
                   long long den, int seq, int seek, int overlap) {
  extern __shared__ float smem[];
  const int win = seek + seq;
  const int stride = seq - overlap;
  const int n_cand = seek + 1;
  float* tail = smem;                              // [channels][overlap]
  float* windows = tail + channels * overlap;      // 2 x [channels][win]
  float* red_score = windows + 2 * channels * win; // [kWarps]
  int* red_idx = reinterpret_cast<int*>(red_score + kWarps);  // [kWarps]
  int* chosen = red_idx + kWarps;                              // [1]
  const long long body_ld = static_cast<long long>(frames) * stride;
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;

  for (int i = threadIdx.x; i < channels * overlap; i += kThreads) {
    tail[i] = head[i];
  }
  stage_window(windows, x, ld, channels, frame_pos(k0, num, den) - base, win);
  cp_async_commit();

  for (int k = 0; k < frames; ++k) {
    float* w = windows + (k & 1) * channels * win;
    if (k + 1 < frames) {
      stage_window(windows + ((k + 1) & 1) * channels * win, x, ld, channels,
                   frame_pos(k0 + k + 1, num, den) - base, win);
    }
    cp_async_commit();  // possibly empty: keeps the group count uniform
    cp_async_wait_one();
    __syncthreads();  // window k and the tail are visible to every thread

    // Score this thread's candidates; keep the best.
    float best_score = -INFINITY;
    int best_idx = INT_MAX;
    for (int b = threadIdx.x; b < n_cand; b += kThreads) {
      float corr = 0.0f;
      float energy = 0.0f;
      for (int c = 0; c < channels; ++c) {
        const float* wc = w + c * win + b;
        const float* tc = tail + c * overlap;
#pragma unroll 8
        for (int v = 0; v < overlap; ++v) {
          const float s = wc[v];
          corr = fmaf(tc[v], s, corr);
          energy = __fadd_rn(energy, __fmul_rn(s, s));
        }
      }
      const float score = corr * (1.0f / sqrtf(energy + 1e-9f));
      if (ranks_before(score, b, best_score, best_idx)) {
        best_score = score;
        best_idx = b;
      }
    }
    // Block-wide argmax: within each warp, then across warps.
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float s = __shfl_down_sync(0xffffffffu, best_score, off);
      const int i = __shfl_down_sync(0xffffffffu, best_idx, off);
      if (ranks_before(s, i, best_score, best_idx)) {
        best_score = s;
        best_idx = i;
      }
    }
    if (lane == 0) {
      red_score[warp] = best_score;
      red_idx[warp] = best_idx;
    }
    __syncthreads();
    if (warp == 0) {
      best_score = lane < kWarps ? red_score[lane] : -INFINITY;
      best_idx = lane < kWarps ? red_idx[lane] : INT_MAX;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float s = __shfl_down_sync(0xffffffffu, best_score, off);
        const int i = __shfl_down_sync(0xffffffffu, best_idx, off);
        if (ranks_before(s, i, best_score, best_idx)) {
          best_score = s;
          best_idx = i;
        }
      }
      if (lane == 0) {
        *chosen = best_idx;
        bs[k] = best_idx;
      }
    }
    __syncthreads();
    const int b = *chosen;

    // Emit this frame's stride of audio from the chosen segment.
    for (int i = threadIdx.x; i < channels * stride; i += kThreads) {
      const int c = i / stride;
      const int j = i - c * stride;
      const float s = w[c * win + b + j];
      float out = s;
      if (j < overlap) {
        const float fade_in =
            __fdiv_rn(__fadd_rn(static_cast<float>(j), 0.5f),
                      static_cast<float>(overlap));
        const float fade_out = __fsub_rn(1.0f, fade_in);
        out = __fadd_rn(__fmul_rn(tail[c * overlap + j], fade_out),
                        __fmul_rn(s, fade_in));
      }
      body[c * body_ld + static_cast<long long>(k) * stride + j] = out;
    }
    __syncthreads();  // every read of the old tail is done
    for (int i = threadIdx.x; i < channels * overlap; i += kThreads) {
      const int c = i / overlap;
      const int j = i - c * overlap;
      tail[i] = w[c * win + b + stride + j];
    }
    __syncthreads();  // the new tail is set; buffer k&1 may be refilled
  }
  for (int i = threadIdx.x; i < channels * overlap; i += kThreads) {
    tail_out[i] = tail[i];
  }
}

long long smem_bytes(int channels, int win, int overlap) {
  return static_cast<long long>(sizeof(float)) *
             (static_cast<long long>(channels) * overlap +
              2LL * channels * win + kWarps) +
         static_cast<long long>(sizeof(int)) * (kWarps + 1);
}

}  // namespace

extern "C" {

// Shared memory bytes of one CTA: the tail, two windows, the argmax scratch.
long long nodey_wsola_smem_bytes(int channels, int win, int overlap) {
  return smem_bytes(channels, win, overlap);
}

// Frame i reads x's columns from frame_pos(k0 + i) - base (every window
// inside the row); x's rows are `ld` floats apart, each row's samples
// contiguous. head and tail_out [channels, overlap], bs [frames] int32,
// body [channels, frames * (seq - overlap)], all on the current device.
// Offline: k0 = base = 0, ld = nx. Returns a cudaError_t (0 on a clean
// launch).
int nodey_wsola_chain(const float* x, const float* head, int* bs, float* body,
                      float* tail_out, int channels, long long ld, int frames,
                      long long k0, long long base, long long num,
                      long long den, int seq, int seek, int overlap,
                      void* stream) {
  const long long smem = smem_bytes(channels, seek + seq, overlap);
  cudaError_t err = cudaFuncSetAttribute(
      wsola_chain_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  wsola_chain_kernel<<<1, kThreads, static_cast<size_t>(smem),
                       static_cast<cudaStream_t>(stream)>>>(
      x, head, bs, body, tail_out, channels, ld, frames, k0, base, num, den,
      seq, seek, overlap);
  return static_cast<int>(cudaGetLastError());
}

const char* nodey_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
