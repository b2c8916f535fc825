// Step-cost probes for Hopper (sm_90a): the fixed cost of one step of a
// serial loop inside one CTA.
//
// Replaces the TPU's grid-step probes: bench.py::_wsola_step_overhead's
// `bare` (:979, pallas_call :984) and `dma` (:994, pallas_call :1022), and
// tools/ab_wsola_fps.py's bare_grid (:42, pallas_call :47) and dma_grid (:60,
// pallas_call :82). A TPU grid runs in order on one core, and those kernels
// timed one grid step of the serial WSOLA chain's shape; the `dma` ones time
// the TPU's DMA engine (pltpu.make_async_copy on DMA semaphores). Here the
// chain (csrc/wsola_chain.cu) is one CTA of 768 threads looping over its
// frames, so each probe is one CTA of 768 threads looping over K steps, with
// one CTA barrier a step, the chain's:
//
//   bare: a barrier and the store of an [8, 128] block (x + 1, x read once)
//         per step, to out[k] (out [K, 8, 128], bench.py's form) or to one
//         fixed block (out [8, 128], the tool's form). 256 threads store 16
//         bytes each; the other 512 only meet the barrier.
//   dma:  per step the window x[:, s : s + span] of x [2, N],
//         s = (k*128) mod limit, limit = ((N - span) / 128) * 128, copied
//         into shared memory by the Tensor Memory Accelerator, Hopper's
//         counterpart of make_async_copy: one elected thread issues a 1-D
//         bulk copy (cp.async.bulk) per row of the window, and the copies
//         complete on the slot's mbarrier, armed with arrive.expect_tx for
//         the window's bytes; every thread waits on it with
//         try_wait.parity. Then 64 threads store its first 128 columns,
//         16 bytes each. Ring form (bench.py): three slots, step k+1's copy
//         issued before step k waits for its own, out[k] = window[:, :128]
//         + 1 (out [K, 2, 128]). Pair form (the tool): two copies of the
//         window per step into the two halves of slot k % 2, both on that
//         slot's mbarrier, out = window[:, :128] (out [2, 128], the last
//         step's).
//
// The parent of this design copied each window with 4-byte cp.async from
// all 768 threads, an integer division each, then cp.async.wait_group and
// the barrier: Ampere's load path, about 0.84 us a step. A bulk copy costs
// one instruction of one thread, and the window's bytes arrive on the
// mbarrier without occupying the other threads' issue slots.
//
// What bounds them: neither bytes nor operations (a few KB and no
// arithmetic per step) but the latency of a serial step: the barrier of 24
// warps, and for dma the mbarrier wait on a TMA round trip from L2 (the
// windows overlap from step to step, so after the first ones they are read
// from L2). The K-slope (t(2K) - t(K)) / K of a probe is the floor under
// one frame of the serial chain kernel. The ring's prefetch hides at most
// one step of the round trip; the pair form waits for its copies whole.
//
// What the design does not cover: every window here starts at a multiple
// of 128 floats (512 bytes), so a 1-D bulk copy, which needs 16-byte
// aligned addresses and sizes, takes it whole. The chain's own windows
// start at any sample; they would need the tensor-map form of the TMA
// (cp.async.bulk.tensor), whose boxes are at most 256 elements a
// dimension, and so several boxes a window. That redesign is the chain's.
//
// C interface (loaded with ctypes): each entry launches on the given stream
// and returns cudaGetLastError(); none synchronizes or allocates. x, out,
// the row stride and span must keep every bulk copy 16-byte aligned (the
// wrapper checks).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 768;  // csrc/wsola_chain.cu's block
constexpr int kBlock4 = 8 * 128 / 4;  // the bare block in float4s
constexpr int kCols = 128;
constexpr int kOut4 = 2 * kCols / 4;  // a dma output row pair in float4s
constexpr int kRingSlots = 3;
constexpr int kPairSlots = 2;

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// The one arrival of the barrier's phase, expecting `bytes` from the TMA.
__device__ __forceinline__ void mbar_expect(unsigned long long* bar,
                                            unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Wait until the barrier's phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(unsigned long long* bar,
                                          unsigned parity) {
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

// TMA bulk copy of `bytes` (a multiple of 16; both addresses 16-byte
// aligned) into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load(float* dst, const float* src,
                                         unsigned bytes,
                                         unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__global__ void __launch_bounds__(kThreads)
bare_kernel(const float4* __restrict__ x, float4* __restrict__ out, int steps,
            int per_step) {
  const int t = threadIdx.x;
  float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (t < kBlock4) {
    v = x[t];
    v.x += 1.0f;
    v.y += 1.0f;
    v.z += 1.0f;
    v.w += 1.0f;
  }
  for (int k = 0; k < steps; ++k) {
    __syncthreads();
    if (t < kBlock4) {
      out[(per_step ? static_cast<long long>(k) * kBlock4 : 0LL) + t] = v;
    }
  }
}

// Thread 0 arms `bar` for `copies` windows [2][span] and issues their row
// copies from column `start` of x (rows `ld` floats apart) into dst, window
// after window.
__device__ __forceinline__ void issue_windows(float* dst, const float* x,
                                              long long ld, int span,
                                              long long start, int copies,
                                              unsigned long long* bar) {
  const unsigned row_bytes = 4u * static_cast<unsigned>(span);
  mbar_expect(bar, 2u * copies * row_bytes);
  for (int w = 0; w < copies; ++w) {
    for (int c = 0; c < 2; ++c) {
      tma_load(dst + (2 * w + c) * span, x + c * ld + start, row_bytes, bar);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
dma_kernel(const float* __restrict__ x, long long ld, int steps, int span,
           long long limit, int ring, float* __restrict__ out) {
  // ring: 3 slots of [2][span]; pair: 2 slots of 2 x [2][span]; then one
  // mbarrier a slot.
  extern __shared__ __align__(16) float win[];
  const int slots = ring ? kRingSlots : kPairSlots;
  const int copies = ring ? 1 : 2;
  const int slot_len = 2 * copies * span;
  unsigned long long* full =
      reinterpret_cast<unsigned long long*>(win + slots * slot_len);
  const int t = threadIdx.x;
  // Output thread t < 64 moves columns 4*(t % 32) .. +3 of row t / 32.
  const int src4 = (t / 32) * span + 4 * (t % 32);
  if (t == 0) {
    for (int i = 0; i < slots; ++i) mbar_init(&full[i]);
    mbar_init_fence();
    if (ring) issue_windows(win, x, ld, span, 0, 1, &full[0]);
  }
  for (int k = 0; k < steps; ++k) {
    // The chain's barrier. It is also all the ring needs: the slot that
    // thread 0 refills now (slot (k+1) % 3 of the ring, slot k % 2 of the
    // pair) was last read at step k - 2, and its mbarrier last waited on
    // there; every thread has left that step before it arrives here, so the
    // copy cannot overwrite a window in use nor the arming overtake a wait.
    // At k == 0 it also publishes the mbarriers' initialization.
    __syncthreads();
    const int slot = ring ? k % kRingSlots : k % kPairSlots;
    if (t == 0) {
      if (ring) {
        if (k + 1 < steps) {
          const int next = (k + 1) % kRingSlots;
          issue_windows(win + next * slot_len, x, ld, span,
                        (static_cast<long long>(k + 1) * kCols) % limit, 1,
                        &full[next]);
        }
      } else {
        issue_windows(win + slot * slot_len, x, ld, span,
                      (static_cast<long long>(k) * kCols) % limit, 2,
                      &full[slot]);
      }
    }
    // Use n = k / slots of this slot completes its barrier's phase n.
    mbar_wait(&full[slot], static_cast<unsigned>(k / slots) & 1u);
    if (t < kOut4) {
      float4 v = *reinterpret_cast<const float4*>(win + slot * slot_len +
                                                  src4);
      if (ring) {
        v.x += 1.0f;
        v.y += 1.0f;
        v.z += 1.0f;
        v.w += 1.0f;
        reinterpret_cast<float4*>(out)[static_cast<long long>(k) * kOut4 +
                                       t] = v;
      } else {
        reinterpret_cast<float4*>(out)[t] = v;
      }
    }
  }
}

long long dma_smem(int span, int ring) {
  const long long slots = ring ? kRingSlots : kPairSlots;
  const long long floats = slots * 2 * (ring ? 1 : 2) * span;
  return static_cast<long long>(sizeof(float)) * floats +
         slots * static_cast<long long>(sizeof(unsigned long long));
}

}  // namespace

extern "C" {

// x float32 [8, 128], 16-byte aligned; out [steps, 8, 128] (per_step) or
// [8, 128].
int nodey_step_probe_bare(const float* x, float* out, int steps, int per_step,
                          void* stream) {
  bare_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(x), reinterpret_cast<float4*>(out),
      steps, per_step);
  return static_cast<int>(cudaGetLastError());
}

// Shared memory bytes of the dma probe.
long long nodey_step_probe_dma_smem_bytes(int span, int ring) {
  return dma_smem(span, ring);
}

// x float32 [2, N], 16-byte aligned, rows `ld` floats apart (ld % 4 == 0);
// 128 <= span, span % 4 == 0, 128 <= limit, limit + span <= N. out
// [steps, 2, 128] (ring) or [2, 128].
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
