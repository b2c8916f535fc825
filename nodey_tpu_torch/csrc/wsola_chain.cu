// WSOLA greedy splice chain for Hopper (sm_90a), FP32 on the CUDA cores:
// the chain kernel and its energy prologue.
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
// ready; here the wrapper launches exactly the ready frames, in blocks of at
// most a few thousand frames (ops/cuda_wsola.py), each block's head the
// previous block's tail_out.
//
// A batch of clips (CompiledGraph.run_batch). Each clip is its own chain,
// and its score sums over the clip's channels, so clips cannot fold into
// the channel axis as they do in the resampler and the PV kernels. Both
// kernels take a clip count and per-clip strides instead: the chain runs
// one CTA per clip (blockIdx.x), each the serial loop below on its own SM,
// so B clips take about the time of one where B single renders would take
// B times as long (the TPU package runs vmapped clips one after another
// through lax.map, pallas_wsola.py:331-357); the prologue's grid is
// (frames, clips). A block of frames is one launch of each whatever B is.
// One clip (the streaming chunk entry) is clips = 1 with strides 0.
//
// The energy prologue (wsola_energy_kernel). The normalizer rsqrt(energy[b])
// depends only on the frame's window position, never on the chain's choices,
// so it leaves the serial path: a parallel kernel over all SMs (one CTA per
// frame) writes inv[i][b] = 1 / sqrtf(energy(i, b) + 1e-9f) for the frames
// of one launch, [frames, seek + 1]. It serves the port's counterpart of
// _wsola_chain_pallas_impl and has no Pallas kernel of its own (the TPU
// kernel sums energies inside its serial loop). 2*C*overlap*(seek+1) flops a
// frame, ~0.1 ms for 4096 frames at 48 kHz stereo across the card.
//
// The chain kernel. Each frame depends on the previous frame's choice, so
// the chain is serial: one CTA loops over the launch's frames. What the TPU
// kernel did for Mosaic (the 128-lane DMA superset window, the 3-slot
// rotation, the 16-sublane pre-shifted window) has no counterpart here. Per
// frame:
//   * the window positions do not depend on the data (only the splice
//     does), so frame k+1's window and its inv row are copied into shared
//     memory with cp.async while frame k is scored (double-buffered);
//   * the realized tail [C, overlap] stays in shared memory across frames;
//   * register tile: each thread holds kCand = 6 consecutive candidates
//     b0 .. b0+5 (b0 = 6*thread). Per tap it loads one new window value and
//     the tail value (a broadcast), two taps per 8-byte load, into a ring of
//     8 registers whose slot is the value's column mod 8 (the loop is
//     unrolled over the ring's period, so no value is moved), and issues 6
//     FFMAs: 7 instructions a tap, where one candidate a thread (with its
//     energy) takes 2 shared loads a multiply-add. The loads run two steps
//     (4 taps) ahead of their FFMAs;
//   * 121 scoring threads at 48 kHz: 4 warps, one per SM sub-partition,
//     each issuing 6 independent FFMA chains (the FFMA latency needs 4);
//     the CTA has 512 threads, so the copies, the emit and the tail carry
//     are spread wide, and those loops divide nothing (per-element integer
//     divisions there would cost more than the scoring, with only 4 warps
//     to hide them);
//   * score = corr * inv[k][b]; a block-wide argmax keeps the lowest index
//     on ties (and ranks NaN above every number, as np.argmax and
//     torch.argmax do);
//   * bs[k] and the frame's [C, stride] output are written straight to
//     device memory (the fused assembly).
//
// What bounds it: the frame loop is serial and runs on ONE SM. Per frame
// C*overlap*(seek+1) FFMAs (553 k at 48 kHz stereo), 4.6 k cycles of FFMA
// issue on the SM's four sub-partitions, with the window loads taking most
// of the SM's shared-memory bandwidth; each candidate's sum is a chain of
// C*overlap dependent FFMAs (768, ~3 k cycles at 4 cycles each), a latency
// floor per frame. Around the scoring, each frame pays its 4-byte copies'
// issue, a 64-bit frame_pos division, two argmax levels and four barriers.
// Splitting a frame's candidates over a thread-block cluster would divide
// the issue time, not that floor.
//
// Numbers: the bitwise invariant. Every candidate's score keeps one exact
// arithmetic: the correlation summed channel by channel, in tap order,
// with fmaf into one float; the energy in the same order with
// __fmul_rn / __fadd_rn (no contraction); score = corr * (1.0f / sqrtf(energy
// + 1e-9f)) with IEEE sqrtf and IEEE division, never rsqrtf (approximate);
// the build must not use --use_fast_math. No candidate's sum is split over
// threads, taps or channels. So the splices do not depend on the register
// tile, and equal those of the score-table kernel
// (csrc/wsola_score_table.cu), which sums in the same order. The fade and
// blend use __fdiv_rn / __fmul_rn / __fadd_rn, the plain version's separate
// roundings, so given equal decisions the emitted audio is bitwise the plain
// version's.
//
// C interface (loaded with ctypes): nodey_wsola_energy and nodey_wsola_chain
// launch on the given stream and return cudaGetLastError(); they never
// synchronize and allocate nothing.

#include <cuda_runtime.h>

#include <climits>
#include <cmath>

namespace {

constexpr int kCand = 6;        // candidates per thread (register tile)
constexpr int kRing = 8;        // ring of window values: kCand + 2
constexpr int kMaxThreads = 1024;
constexpr int kMaxWarps = kMaxThreads / 32;
// Threads of the chain's CTA: the scoring threads (cand_threads) do the
// per-candidate sums; all of them copy, emit and carry the tail.
constexpr int kChainThreads = 512;

__host__ __device__ __forceinline__ int round_up(int n, int q) {
  return (n + q - 1) / q * q;
}

// Threads of either kernel: one per kCand candidates, whole warps.
__host__ __device__ __forceinline__ int cand_threads(int n_cand) {
  return round_up((n_cand + kCand - 1) / kCand, 32);
}

// Columns `slide` may read past the last candidate's last tap (its
// prefetch); values there are never used.
constexpr int kPrefetch = kCand + 6;

// Row stride of a staged window of `cols` columns: a multiple of 4 floats,
// with room for the prefetch past the last candidate's taps.
__host__ __device__ __forceinline__ int staged_ld(int cols) {
  return round_up(cols + kPrefetch, 4);
}

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

__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

// The correlation's per-tap step: acc = fmaf(tail[v], w, acc).
struct Corr {
  const float* tail;
  __device__ __forceinline__ float value(float s) const { return s; }
  // The tail values of taps v and v + 1.
  __device__ __forceinline__ float2 taps(int v) const { return ld2(tail + v); }
  __device__ __forceinline__ float apply(float acc, float t, float s) const {
    return fmaf(t, s, acc);
  }
  __device__ __forceinline__ float apply_at(float acc, int v, float s) const {
    return fmaf(tail[v], s, acc);
  }
};

// The energy's per-tap step: acc = acc + s*s, two separate roundings.
struct Energy {
  __device__ __forceinline__ float value(float s) const {
    return __fmul_rn(s, s);
  }
  __device__ __forceinline__ float2 taps(int) const {
    return make_float2(0.0f, 0.0f);
  }
  __device__ __forceinline__ float apply(float acc, float, float q) const {
    return __fadd_rn(acc, q);
  }
  __device__ __forceinline__ float apply_at(float acc, int, float q) const {
    return __fadd_rn(acc, q);
  }
};

// One step of two taps (tap and tap + 1) of `slide`. Its two new window
// values w[tap + 6 .. tap + 7] and its tail values were loaded two steps
// earlier (pw[0], pt[0]); it puts the window values in the ring (slot =
// column mod 8), loads those of the step two ahead, and for each tap and
// candidate r folds w[tap + j + r] into acc[r].
template <int S, class Op>
__device__ __forceinline__ void slide_step(const float* w, int tap,
                                           float (&q)[kRing],
                                           float (&acc)[kCand], const Op& op,
                                           float2 (&pw)[2], float2 (&pt)[2]) {
  q[(2 * S + 6) % kRing] = op.value(pw[0].x);
  q[(2 * S + 7) % kRing] = op.value(pw[0].y);
  const float2 t = pt[0];
  pw[0] = pw[1];
  pt[0] = pt[1];
  pw[1] = ld2(w + tap + 4 + kCand);
  pt[1] = op.taps(tap + 4);
#pragma unroll
  for (int j = 0; j < 2; ++j) {
#pragma unroll
    for (int r = 0; r < kCand; ++r) {
      acc[r] = op.apply(acc[r], j == 0 ? t.x : t.y,
                        q[(2 * S + j + r) % kRing]);
    }
  }
}

// acc[r] folds, for taps v = 0 .. n-1 in order, the value w[v + r] (w: this
// thread's first candidate's column of one staged row, 8-byte aligned, with
// kPrefetch readable columns past the last candidate's last tap). Shared
// loads run two steps (4 taps) ahead of the FFMAs that use them: with one
// warp per SM sub-partition nothing else hides their latency.
template <class Op>
__device__ __forceinline__ void slide(const float* w, int n,
                                      float (&acc)[kCand], const Op& op) {
  float q[kRing];
#pragma unroll
  for (int i = 0; i < kCand; i += 2) {
    const float2 a = ld2(w + i);
    q[i] = op.value(a.x);
    q[i + 1] = op.value(a.y);
  }
  int v = 0;
  if (n >= kRing) {
    float2 pw[2] = {ld2(w + kCand), ld2(w + 2 + kCand)};
    float2 pt[2] = {op.taps(0), op.taps(2)};
    for (; v + kRing <= n; v += kRing) {
      slide_step<0>(w, v, q, acc, op, pw, pt);
      slide_step<1>(w, v + 2, q, acc, op, pw, pt);
      slide_step<2>(w, v + 4, q, acc, op, pw, pt);
      slide_step<3>(w, v + 6, q, acc, op, pw, pt);
    }
  }
  for (; v < n; ++v) {
#pragma unroll
    for (int r = 0; r < kCand; ++r) {
      acc[r] = op.apply_at(acc[r], v, op.value(w[v + r]));
    }
  }
}

__global__ void __launch_bounds__(kMaxThreads)
wsola_energy_kernel(const float* __restrict__ x, long long ld, int channels,
                    long long k0, long long base, long long num,
                    long long den, int seek, int overlap,
                    float* __restrict__ inv, long long x_clip,
                    long long inv_clip) {
  extern __shared__ float4 smem4[];
  x += blockIdx.y * x_clip;
  inv += blockIdx.y * inv_clip;
  float* rows = reinterpret_cast<float*>(smem4);   // [channels][row_ld]
  const int n_cand = seek + 1;
  const int span = seek + overlap;
  const int row_ld = staged_ld(span);
  const int i = blockIdx.x;
  const long long pos = frame_pos(k0 + i, num, den) - base;
  for (int c = 0; c < channels; ++c) {
    for (int j = threadIdx.x; j < row_ld; j += blockDim.x) {
      rows[c * row_ld + j] = j < span ? x[c * ld + pos + j] : 0.0f;
    }
  }
  __syncthreads();
  const int b0 = kCand * threadIdx.x;
  if (b0 >= n_cand) return;
  float energy[kCand];
#pragma unroll
  for (int r = 0; r < kCand; ++r) energy[r] = 0.0f;
  for (int c = 0; c < channels; ++c) {
    slide(rows + c * row_ld + b0, overlap, energy, Energy{});
  }
  float* out = inv + static_cast<long long>(i) * n_cand;
#pragma unroll
  for (int r = 0; r < kCand; ++r) {
    if (b0 + r < n_cand) out[b0 + r] = 1.0f / sqrtf(energy[r] + 1e-9f);
  }
}

struct ChainLayout {
  int win, win_ld, tail_ld;
  __host__ __device__ ChainLayout(int seq, int seek, int overlap)
      : win(seek + seq), win_ld(staged_ld(seek + seq)),
        tail_ld(round_up(overlap, 4)) {}
};

__host__ __device__ __forceinline__ int chain_threads(int n_cand) {
  const int scoring = cand_threads(n_cand);
  return scoring > kChainThreads ? scoring : kChainThreads;
}

// Copy frame i's window [channels][win] (at column pos of x, row stride ld)
// and its inv row into `buf` / `inv_buf` (no wait).
__device__ __forceinline__ void stage_frame(float* buf, float* inv_buf,
                                            const float* x, long long ld,
                                            const float* inv_row, int channels,
                                            long long pos, int win,
                                            int win_ld, int n_cand) {
  for (int c = 0; c < channels; ++c) {
    for (int j = threadIdx.x; j < win; j += blockDim.x) {
      cp_async_f32(buf + c * win_ld + j, x + c * ld + pos + j);
    }
  }
  for (int b = threadIdx.x; b < n_cand; b += blockDim.x) {
    cp_async_f32(inv_buf + b, inv_row + b);
  }
}

// One CTA an SM (minBlocksPerSM 1): with the clip offsets below, ptxas
// otherwise holds the kernel to 32 registers (room for 2,048 threads an
// SM), and the serial loop slows; chip_smoke.py's build phase prints the
// registers and phase 8 the time a frame (PERF.md, row 4 of the kernels).
__global__ void __launch_bounds__(kMaxThreads, 1)
wsola_chain_kernel(const float* __restrict__ x, const float* head,
                   const float* __restrict__ inv, int* __restrict__ bs,
                   float* __restrict__ body, long long body_ld,
                   float* tail_out, int channels, long long ld, int frames,
                   long long k0, long long base, long long num, long long den,
                   int seq, int seek, int overlap, long long x_clip,
                   long long inv_clip, long long bs_clip,
                   long long body_clip) {
  // head may alias tail_out (a block walk passes the previous block's tail
  // as its head): it is read once before the frame loop, written after it.
  extern __shared__ float4 smem4[];
  {
    // This CTA's clip: its input rows, inv rows, splices, body and tail.
    const long long clip = blockIdx.x;
    const long long tail_clip = static_cast<long long>(channels) * overlap;
    x += clip * x_clip;
    head += clip * tail_clip;
    tail_out += clip * tail_clip;
    inv += clip * inv_clip;
    bs += clip * bs_clip;
    body += clip * body_clip;
  }
  const ChainLayout lay(seq, seek, overlap);
  const int stride = seq - overlap;
  const int n_cand = seek + 1;
  const int inv_ld = round_up(n_cand, 4);
  float* tail = reinterpret_cast<float*>(smem4);          // [C][tail_ld]
  float* fade_in = tail + channels * lay.tail_ld;          // [tail_ld]
  float* fade_out = fade_in + lay.tail_ld;                 // [tail_ld]
  float* windows = fade_out + lay.tail_ld;                 // 2 x [C][win_ld]
  float* invs = windows + 2 * channels * lay.win_ld;       // 2 x [inv_ld]
  float* red_score = invs + 2 * inv_ld;                    // [kMaxWarps]
  int* red_idx = reinterpret_cast<int*>(red_score + kMaxWarps);
  int* chosen = red_idx + kMaxWarps;                       // [1]
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int n_warps = blockDim.x / 32;
  const int b0 = kCand * threadIdx.x;

  for (int c = 0; c < channels; ++c) {
    for (int j = threadIdx.x; j < overlap; j += blockDim.x) {
      tail[c * lay.tail_ld + j] = head[c * overlap + j];
    }
  }
  for (int j = threadIdx.x; j < overlap; j += blockDim.x) {
    fade_in[j] = __fdiv_rn(__fadd_rn(static_cast<float>(j), 0.5f),
                           static_cast<float>(overlap));
    fade_out[j] = __fsub_rn(1.0f, fade_in[j]);
  }
  stage_frame(windows, invs, x, ld, inv, channels,
              frame_pos(k0, num, den) - base, lay.win, lay.win_ld, n_cand);
  cp_async_commit();

  for (int k = 0; k < frames; ++k) {
    float* w = windows + (k & 1) * channels * lay.win_ld;
    const float* iv = invs + (k & 1) * inv_ld;
    if (k + 1 < frames) {
      stage_frame(windows + ((k + 1) & 1) * channels * lay.win_ld,
                  invs + ((k + 1) & 1) * inv_ld, x, ld,
                  inv + static_cast<long long>(k + 1) * n_cand, channels,
                  frame_pos(k0 + k + 1, num, den) - base, lay.win,
                  lay.win_ld, n_cand);
    }
    cp_async_commit();  // possibly empty: keeps the group count uniform
    cp_async_wait_one();
    __syncthreads();  // window k, its inv row and the tail are visible

    // Score this thread's candidates; keep the best.
    float best_score = -INFINITY;
    int best_idx = INT_MAX;
    if (b0 < n_cand) {
      float corr[kCand];
#pragma unroll
      for (int r = 0; r < kCand; ++r) corr[r] = 0.0f;
      for (int c = 0; c < channels; ++c) {
        slide(w + c * lay.win_ld + b0, overlap, corr,
              Corr{tail + c * lay.tail_ld});
      }
#pragma unroll
      for (int r = 0; r < kCand; ++r) {
        const int b = b0 + r;
        if (b < n_cand) {
          const float score = corr[r] * iv[b];
          if (ranks_before(score, b, best_score, best_idx)) {
            best_score = score;
            best_idx = b;
          }
        }
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
      best_score = lane < n_warps ? red_score[lane] : -INFINITY;
      best_idx = lane < n_warps ? red_idx[lane] : INT_MAX;
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
    for (int c = 0; c < channels; ++c) {
      const float* seg = w + c * lay.win_ld + b;
      const float* tc = tail + c * lay.tail_ld;
      float* out = body + c * body_ld + static_cast<long long>(k) * stride;
      for (int j = threadIdx.x; j < stride; j += blockDim.x) {
        const float s = seg[j];
        out[j] = j < overlap ? __fadd_rn(__fmul_rn(tc[j], fade_out[j]),
                                         __fmul_rn(s, fade_in[j]))
                             : s;
      }
    }
    __syncthreads();  // every read of the old tail is done
    for (int c = 0; c < channels; ++c) {
      for (int j = threadIdx.x; j < overlap; j += blockDim.x) {
        tail[c * lay.tail_ld + j] = w[c * lay.win_ld + b + stride + j];
      }
    }
    __syncthreads();  // the new tail is set; buffer k&1 may be refilled
  }
  for (int c = 0; c < channels; ++c) {
    for (int j = threadIdx.x; j < overlap; j += blockDim.x) {
      tail_out[c * overlap + j] = tail[c * lay.tail_ld + j];
    }
  }
}

long long chain_smem_bytes(int channels, int seq, int seek, int overlap) {
  const ChainLayout lay(seq, seek, overlap);
  return static_cast<long long>(sizeof(float)) *
             (static_cast<long long>(channels + 2) * lay.tail_ld +
              2LL * channels * lay.win_ld + 2LL * round_up(seek + 1, 4) +
              kMaxWarps) +
         static_cast<long long>(sizeof(int)) * (kMaxWarps + 1);
}

long long energy_smem_bytes(int channels, int seek, int overlap) {
  return static_cast<long long>(sizeof(float)) * channels *
         staged_ld(seek + overlap);
}

}  // namespace

extern "C" {

// Shared memory bytes of one CTA: the chain's (the tail, two windows, two
// inv rows, the argmax scratch) or the prologue's (one frame's rows).
long long nodey_wsola_smem_bytes(int channels, int seq, int seek,
                                 int overlap) {
  return chain_smem_bytes(channels, seq, seek, overlap);
}

long long nodey_wsola_energy_smem_bytes(int channels, int seek, int overlap) {
  return energy_smem_bytes(channels, seek, overlap);
}

// Threads of one CTA of the chain kernel for seek + 1 candidates.
int nodey_wsola_threads(int seek) { return chain_threads(seek + 1); }

// inv [frames, seek + 1]: row i of frame k0 + i, read from x's columns from
// frame_pos(k0 + i) - base (x's rows `ld` floats apart, each window inside
// its row). For `clips` clips, clip j's rows start x_clip floats after clip
// j-1's and its inv rows inv_clip floats after (one clip: strides unused).
// One CTA per frame and clip. Returns a cudaError_t.
int nodey_wsola_energy(const float* x, long long ld, int channels, int frames,
                       long long k0, long long base, long long num,
                       long long den, int seek, int overlap, float* inv,
                       int clips, long long x_clip, long long inv_clip,
                       void* stream) {
  const long long smem = energy_smem_bytes(channels, seek, overlap);
  cudaError_t err = cudaFuncSetAttribute(
      wsola_energy_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  wsola_energy_kernel<<<dim3(frames, clips), cand_threads(seek + 1),
                        static_cast<size_t>(smem),
                        static_cast<cudaStream_t>(stream)>>>(
      x, ld, channels, k0, base, num, den, seek, overlap, inv, x_clip,
      inv_clip);
  return static_cast<int>(cudaGetLastError());
}

// Frame i reads x's columns from frame_pos(k0 + i) - base (every window
// inside the row) and inv's row i (nodey_wsola_energy's output for the same
// frames); x's rows are `ld` floats apart, each row's samples contiguous.
// head and tail_out [channels, overlap] (they may be one buffer), bs
// [frames] int32, body rows `body_ld` floats apart, frame i's stride at
// column i * (seq - overlap); all on the current device. Offline: k0 = base
// = 0, ld = nx. For `clips` clips (one CTA each), clip j's x, inv, bs and
// body start x_clip, inv_clip, bs_clip and body_clip elements after clip
// j-1's, and its head and tail_out channels * overlap floats after (one
// clip: strides unused). Returns a cudaError_t (0 on a clean launch).
int nodey_wsola_chain(const float* x, const float* head, const float* inv,
                      int* bs, float* body, long long body_ld,
                      float* tail_out, int channels, long long ld, int frames,
                      long long k0, long long base, long long num,
                      long long den, int seq, int seek, int overlap,
                      int clips, long long x_clip, long long inv_clip,
                      long long bs_clip, long long body_clip, void* stream) {
  const long long smem = chain_smem_bytes(channels, seq, seek, overlap);
  cudaError_t err = cudaFuncSetAttribute(
      wsola_chain_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  wsola_chain_kernel<<<clips, chain_threads(seek + 1),
                       static_cast<size_t>(smem),
                       static_cast<cudaStream_t>(stream)>>>(
      x, head, inv, bs, body, body_ld, tail_out, channels, ld, frames, k0,
      base, num, den, seq, seek, overlap, x_clip, inv_clip, bs_clip,
      body_clip);
  return static_cast<int>(cudaGetLastError());
}

const char* nodey_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
