// Step-cost probes for Hopper (sm_90a): the fixed cost of one step of a
// serial loop inside one CTA.
//
// Replaces the TPU's grid-step probes: bench.py::_wsola_step_overhead's
// `bare` (:979, pallas_call :984) and `dma` (:994, pallas_call :1022), and
// tools/ab_wsola_fps.py's bare_grid (:42, pallas_call :47) and dma_grid (:60,
// pallas_call :82). A TPU grid runs in order on one core, and those kernels
// timed one grid step of the serial WSOLA chain's shape. Here the chain
// (csrc/wsola_chain.cu) is one CTA of 768 threads looping over its frames,
// so each probe is one CTA of 768 threads looping over K steps:
//
//   bare: a block barrier and the store of an [8, 128] block (x + 1, x read
//         once) per step, to out[k] (out [K, 8, 128], bench.py's form) or to
//         one fixed block (out [8, 128], the tool's form);
//   dma:  per step the window x[:, s : s + span] of x [2, N],
//         s = (k*128) mod limit, limit = ((N - span) / 128) * 128, copied
//         into shared memory with cp.async (4-byte copies, as the chain
//         kernel stages its windows), then 128 columns of it stored. Ring
//         form (bench.py): three slots, step k+1's copy in flight while step
//         k waits for its own, out[k] = window[:, :128] + 1 (out
//         [K, 2, 128]). Pair form (the tool): two copies of the window per
//         step into the two halves of slot k % 2, both waited, out =
//         window[:, :128] (out [2, 128], the last step's).
//
// What bounds them: neither bytes nor operations (a few KB and no
// arithmetic per step) but per-step latency: a barrier and a store, and for
// dma the round trip of the copy. The K-slope (t(2K) - t(K)) / K of a probe
// is the floor under one frame of the serial chain kernel.
//
// C interface (loaded with ctypes): each entry launches on the given stream
// and returns cudaGetLastError(); none synchronizes or allocates.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 768;  // csrc/wsola_chain.cu's block
constexpr int kBlock = 8 * 128;
constexpr int kCols = 128;

__device__ __forceinline__ void cp_async_f32(float* dst, const float* src) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(addr),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__global__ void __launch_bounds__(kThreads)
bare_kernel(const float* __restrict__ x, float* __restrict__ out, int steps,
            int per_step) {
  const int i0 = threadIdx.x;
  const int i1 = threadIdx.x + kThreads;
  const float v0 = x[i0] + 1.0f;
  const float v1 = i1 < kBlock ? x[i1] + 1.0f : 0.0f;
  for (int k = 0; k < steps; ++k) {
    __syncthreads();
    float* o = out + (per_step ? static_cast<long long>(k) * kBlock : 0LL);
    o[i0] = v0;
    if (i1 < kBlock) o[i1] = v1;
  }
}

// Copy the window [2][span] at column `start` of x (row stride `ld`) into
// `dst` (no wait).
__device__ __forceinline__ void stage(float* dst, const float* x, long long ld,
                                      int span, long long start) {
  for (int i = threadIdx.x; i < 2 * span; i += kThreads) {
    const int c = i / span;
    const int j = i - c * span;
    cp_async_f32(dst + i, x + c * ld + start + j);
  }
}

__global__ void __launch_bounds__(kThreads)
dma_kernel(const float* __restrict__ x, long long ld, int steps, int span,
           long long limit, int ring, float* __restrict__ out) {
  extern __shared__ float win[];  // ring: 3 x [2][span]; pair: 2 x 2 x [2][span]
  const int window = 2 * span;
  if (ring) {
    stage(win, x, ld, span, 0);
    cp_async_commit();
    for (int k = 0; k < steps; ++k) {
      if (k + 1 < steps) {
        stage(win + ((k + 1) % 3) * window, x, ld, span,
              (static_cast<long long>(k + 1) * kCols) % limit);
      }
      cp_async_commit();  // possibly empty: keeps the group count uniform
      cp_async_wait_one();
      __syncthreads();  // window k is visible; slot (k+2) % 3 is free
      const float* w = win + (k % 3) * window;
      for (int i = threadIdx.x; i < 2 * kCols; i += kThreads) {
        const int c = i / kCols;
        out[static_cast<long long>(k) * 2 * kCols + i] =
            w[c * span + i - c * kCols] + 1.0f;
      }
    }
  } else {
    for (int k = 0; k < steps; ++k) {
      const long long start = (static_cast<long long>(k) * kCols) % limit;
      float* w = win + (k % 2) * 2 * window;
      stage(w, x, ld, span, start);
      stage(w + window, x, ld, span, start);
      cp_async_commit();
      cp_async_wait_all();
      __syncthreads();  // both copies are visible; slot (k+1) % 2 is free
      for (int i = threadIdx.x; i < 2 * kCols; i += kThreads) {
        const int c = i / kCols;
        out[i] = w[c * span + i - c * kCols];
      }
    }
  }
}

long long dma_smem(int span, int ring) {
  return static_cast<long long>(sizeof(float)) * 2 * span * (ring ? 3 : 4);
}

}  // namespace

extern "C" {

// x float32 [8, 128]; out [steps, 8, 128] (per_step) or [8, 128].
int nodey_step_probe_bare(const float* x, float* out, int steps, int per_step,
                          void* stream) {
  bare_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, out, steps, per_step);
  return static_cast<int>(cudaGetLastError());
}

// Shared memory bytes of the dma probe.
long long nodey_step_probe_dma_smem_bytes(int span, int ring) {
  return dma_smem(span, ring);
}

// x float32 [2, N], rows `ld` floats apart; 128 <= span, 128 <= limit,
// limit + span <= N. out [steps, 2, 128] (ring) or [2, 128].
int nodey_step_probe_dma(const float* x, long long ld, int steps, int span,
                         long long limit, int ring, float* out,
                         void* stream) {
  const long long smem = dma_smem(span, ring);
  cudaError_t err = cudaFuncSetAttribute(
      dma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dma_kernel<<<1, kThreads, static_cast<size_t>(smem),
               static_cast<cudaStream_t>(stream)>>>(x, ld, steps, span, limit,
                                                    ring, out);
  return static_cast<int>(cudaGetLastError());
}

const char* nodey_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
