// WSOLA score table and its walk for Hopper (sm_90a), FP32 on the CUDA cores.
//
// Replaces nodey_tpu/ops/pallas_wsola.py::wsola_score_table (:71, its
// pallas_call at :259), the TPU's parallel formulation of the WSOLA splice
// chain, and the lax.scan walk of its consumer splice_offsets (:307-325).
// For frames k = 0 .. K-1 at window position pos(k) = frame_pos(k) =
// (k*num + den/2) / den, candidates b = 0 .. seek of frame k and tail rows
// p = 0 .. seek (the tail that frame k-1's choice p would realize,
// x[c][pos(k-1) + stride + p ..], stride = seq - overlap):
//
//   corr[k][p][b]  = sum_{c,v} x[c][pos(k-1) + stride + p + v] * x[c][pos(k) + b + v]
//   score[k][p][b] = corr * (1 / sqrt(sum_{c,v} x[c][pos(k) + b + v]^2 + 1e-9))
//   F[k][p]        = the first b with the largest score
//
// with v = 0 .. overlap-1; frame 0 scores the head x[c][0 .. overlap) in
// place of every tail row. The walk b_k = F[k][b_{k-1}], b_{-1} = 0, gives
// the greedy chain's splice offsets. F is int32 [K, seek+1], rows and entries
// in real order: the TPU's permuted 128-lane row layout has no counterpart.
//
// Design. Every frame is independent, so the grid is (groups of
// frames_per_cta frames, tiles of 64 tail rows); a CTA loops over its frames
// (the TPU's frames_per_step). Per frame it stages in shared memory the
// candidate window C x (seek + overlap) and its tile's tail span
// C x (63 + overlap), zero-padded, computes each candidate's inverse norm
// once, then the tile's 64 x (seek+1) dot products. Both operands are Hankel
// (row p is x[s + p ..]), so each thread holds an 8 x 8 register tile of
// (p, b) pairs and per step of the inner sum loads one new tail value and one
// new candidate value, shifting the others along: 64 FMAs per two shared
// loads. A warp is 4 row groups x 8 candidate groups, so its loads touch few
// banks (a 2-way conflict on the candidates). The argmax of each row is kept
// in registers over the thread's candidates, then reduced across the warp by
// shuffles and across warps through shared memory, ranking NaN first, then
// the larger score, then the lower index (np.argmax's and torch.argmax's
// first maximum), so ties go to the lowest real candidate index.
//
// What bounds it: C*(seek+1)^2*overlap multiply-adds per frame, 399.2M at
// 48 kHz stereo (798.5 MFLOP): it is bound by FP32 operations, 11.9 ms per
// 1000 frames at the card's 67 TFLOP/s; the bytes (the clip once, the table
// once) are ~1000x less. Rows and candidates are padded to multiples of 64
// and 256 (768 of 721 each at 48 kHz), so ~13% of the FMAs fall on padding.
// A 3xTF32 wgmma formulation on the Hankel operands is later work (plain
// TF32 is not allowed on the audio path).
//
// Numbers. Each (p, b) pair sums channel by channel in tap order with fmaf
// into one float, each energy with __fmul_rn / __fadd_rn, and the score is
// corr * (1.0f / sqrtf(energy + 1e-9f)): the arithmetic with which
// csrc/wsola_chain.cu scores its one realized tail. So F[k][b_{k-1}] is
// bitwise the chain kernel's choice for frame k, and the walk reproduces its
// splices.
//
// The walk b_k = F[k][b_{k-1}] is K dependent loads. One thread doing them
// in order waits on L2 for each (~0.18 us a frame on the H100), so the walk
// composes instead, in three launches (the phase path's totals / carry /
// apply, csrc/pv_phase_path.cu):
//   1. maps:  K is cut into segments of `seg` frames, one CTA each (the
//      wrapper takes seg ~ K / SMs, so one wave fills the card). Thread 0
//      streams the segment's rows through a ring of 4 stages of 16 rows in
//      shared memory, one TMA bulk copy a stage (the ragged ends of an
//      unaligned stage, up to 3 ints each, by plain loads), and thread p
//      steps start p through them: every start's path through the segment
//      is a chain of shared-memory loads. Every 8 frames and at the
//      segment's end it writes where each start stands (`part`,
//      [segs][ceil(seg / 8)][ld]); the last of these is the segment's map.
//      Bound by bytes: the table read once (34.1 MB at K = 11,820, 0.0102
//      ms at 3.35 TB/s) and the checkpoints, an eighth of that, written.
//   2. carry: start_s = map_{s-1}[start_{s-1}] from start_0 = 0 is segs
//      dependent steps. One CTA staging every map for them would be bound
//      by one SM's load rate, so the maps are composed at a second level
//      instead: CTA g stages ~sqrt(segs) maps and thread p follows start p
//      through them, writing each prefix; the last CTA to finish (an
//      atomic count) carries across the groups' last prefixes and looks
//      every segment's start up. Bound by latency: two stagings of
//      ~sqrt(segs) maps and the count.
//   3. emit:  one thread per 8 frames of a segment looks its start up (the
//      segment's start, then the checkpoint) and walks its 8 rows in
//      global memory. Bound by latency: 10 dependent loads a thread.
// Passes 2 and 3 are launched as programmatic dependents of the pass before
// (griddepcontrol.wait), so their launch overlaps its end.
// An entry outside [0, n_cand) stops the walk: that frame and every later
// one are -1 (a start that meets one stands at -1, and -1 leads only to
// -1). So the splices are bitwise those of the walk in order. The table
// stays on the card (no copy to the host, no sync).
//
// C interface (loaded with ctypes): each entry launches on the given stream
// and returns cudaGetLastError(); none synchronizes or allocates.

#include <cuda_runtime.h>

#include <algorithm>
#include <climits>
#include <cmath>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerThread = 8;
constexpr int kCandsPerThread = 8;
constexpr int kRowGroups = 8;    // 2 warp rows x 4 lane rows
constexpr int kCandGroups = 32;  // 4 warp columns x 8 lane columns
constexpr int kTileRows = kRowGroups * kRowsPerThread;     // 64
constexpr int kPassCands = kCandGroups * kCandsPerThread;  // 256
constexpr int kWarpColumns = 4;

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

__device__ __forceinline__ void take_if_before(float s, int i, float& best,
                                               int& best_i) {
  if (ranks_before(s, i, best, best_i)) {
    best = s;
    best_i = i;
  }
}

__host__ __device__ inline int passes_of(int seek) {
  return (seek + 1 + kPassCands - 1) / kPassCands;
}

// Per channel: the candidate window padded to whole passes, the tile's tail
// span.
__host__ __device__ inline int cand_width(int seek, int overlap) {
  return passes_of(seek) * kPassCands + overlap;
}

__host__ __device__ inline int tail_width(int overlap) {
  return kTileRows + overlap;
}

long long smem_bytes(int channels, int seek, int overlap) {
  const long long floats =
      static_cast<long long>(channels) *
          (cand_width(seek, overlap) + tail_width(overlap)) +
      static_cast<long long>(passes_of(seek)) * kPassCands +
      kWarpColumns * kTileRows;
  return static_cast<long long>(sizeof(float)) * floats +
         static_cast<long long>(sizeof(int)) * kWarpColumns * kTileRows;
}

__global__ void __launch_bounds__(kThreads)
score_table_kernel(const float* __restrict__ x, long long ld, int channels,
                   int frames, int frames_per_cta, long long num,
                   long long den, int seq, int seek, int overlap,
                   int* __restrict__ table) {
  extern __shared__ float smem[];
  const int n_cand = seek + 1;
  const int stride = seq - overlap;
  const int span = seek + overlap;  // samples a frame's candidates read
  const int padded_cands = passes_of(seek) * kPassCands;
  const int cand_w = cand_width(seek, overlap);
  const int tail_w = tail_width(overlap);
  float* cand = smem;                                  // [channels][cand_w]
  float* tail = cand + channels * cand_w;              // [channels][tail_w]
  float* inv_norm = tail + channels * tail_w;          // [padded_cands]
  float* red_score = inv_norm + padded_cands;          // [4][kTileRows]
  int* red_idx = reinterpret_cast<int*>(red_score + kWarpColumns * kTileRows);

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int row_group = (warp / kWarpColumns) * 4 + lane / 8;     // 0 .. 7
  const int col_group = (warp % kWarpColumns) * 8 + lane % 8;     // 0 .. 31
  const int p0 = blockIdx.y * kTileRows;

  for (int f = 0; f < frames_per_cta; ++f) {
    const long long k = static_cast<long long>(blockIdx.x) * frames_per_cta + f;
    if (k >= frames) break;
    int* row_out = table + k * n_cand;
    const long long pos = frame_pos(k, num, den);
    __syncthreads();  // the previous frame's reads of shared memory are done
    for (int i = tid; i < channels * cand_w; i += kThreads) {
      const int c = i / cand_w;
      const int j = i - c * cand_w;
      cand[i] = j < span ? x[c * ld + pos + j] : 0.0f;
    }
    if (k == 0) {
      // The head, x[c][0 .. overlap), is frame 0's tail for every row.
      for (int i = tid; i < channels * tail_w; i += kThreads) {
        const int c = i / tail_w;
        const int j = i - c * tail_w;
        tail[i] = j < overlap ? x[c * ld + j] : 0.0f;
      }
    } else {
      const long long start = frame_pos(k - 1, num, den) + stride + p0;
      for (int i = tid; i < channels * tail_w; i += kThreads) {
        const int c = i / tail_w;
        const int j = i - c * tail_w;
        tail[i] = p0 + j < span ? x[c * ld + start + j] : 0.0f;
      }
    }
    __syncthreads();
    for (int b = tid; b < padded_cands; b += kThreads) {
      float inv = 0.0f;
      if (b < n_cand) {
        float energy = 0.0f;
        for (int c = 0; c < channels; ++c) {
          const float* wc = cand + c * cand_w + b;
          for (int v = 0; v < overlap; ++v) {
            energy = __fadd_rn(energy, __fmul_rn(wc[v], wc[v]));
          }
        }
        inv = 1.0f / sqrtf(energy + 1e-9f);
      }
      inv_norm[b] = inv;
    }
    __syncthreads();

    if (k == 0) {
      // One row, the head's, written to every row of the tile.
      float best = -INFINITY;
      int best_i = INT_MAX;
      for (int b = tid; b < n_cand; b += kThreads) {
        float corr = 0.0f;
        for (int c = 0; c < channels; ++c) {
          const float* tc = tail + c * tail_w;
          const float* wc = cand + c * cand_w + b;
          for (int v = 0; v < overlap; ++v) corr = fmaf(tc[v], wc[v], corr);
        }
        take_if_before(corr * inv_norm[b], b, best, best_i);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        take_if_before(__shfl_xor_sync(0xffffffffu, best, off),
                       __shfl_xor_sync(0xffffffffu, best_i, off), best,
                       best_i);
      }
      if (lane == 0) {
        red_score[warp] = best;
        red_idx[warp] = best_i;
      }
      __syncthreads();
      if (warp == 0) {
        best = lane < kWarps ? red_score[lane] : -INFINITY;
        best_i = lane < kWarps ? red_idx[lane] : INT_MAX;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          take_if_before(__shfl_xor_sync(0xffffffffu, best, off),
                         __shfl_xor_sync(0xffffffffu, best_i, off), best,
                         best_i);
        }
        for (int r = lane; r < kTileRows; r += 32) {
          if (p0 + r < n_cand) row_out[p0 + r] = best_i;
        }
      }
      continue;
    }

    // This thread's 8 rows p0 + row_group*8 + i against its 8 candidates
    // b0 + j of each pass; best score and index per row.
    float best[kRowsPerThread];
    int best_i[kRowsPerThread];
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      best[i] = -INFINITY;
      best_i[i] = INT_MAX;
    }
    const float* tail_rows = tail + row_group * kRowsPerThread;
    for (int b0 = col_group * kCandsPerThread; b0 < padded_cands;
         b0 += kPassCands) {
      float acc[kRowsPerThread][kCandsPerThread];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) {
#pragma unroll
        for (int j = 0; j < kCandsPerThread; ++j) acc[i][j] = 0.0f;
      }
      for (int c = 0; c < channels; ++c) {
        const float* tc = tail_rows + c * tail_w;
        const float* wc = cand + c * cand_w + b0;
        // t[i] = tc[i + v], w[j] = wc[j + v] at step v.
        float t[kRowsPerThread];
        float w[kCandsPerThread];
#pragma unroll
        for (int i = 0; i < kRowsPerThread - 1; ++i) t[i] = tc[i];
#pragma unroll
        for (int j = 0; j < kCandsPerThread - 1; ++j) w[j] = wc[j];
#pragma unroll 8
        for (int v = 0; v < overlap; ++v) {
          t[kRowsPerThread - 1] = tc[v + kRowsPerThread - 1];
          w[kCandsPerThread - 1] = wc[v + kCandsPerThread - 1];
#pragma unroll
          for (int i = 0; i < kRowsPerThread; ++i) {
#pragma unroll
            for (int j = 0; j < kCandsPerThread; ++j) {
              acc[i][j] = fmaf(t[i], w[j], acc[i][j]);
            }
          }
#pragma unroll
          for (int i = 0; i < kRowsPerThread - 1; ++i) t[i] = t[i + 1];
#pragma unroll
          for (int j = 0; j < kCandsPerThread - 1; ++j) w[j] = w[j + 1];
        }
      }
#pragma unroll
      for (int j = 0; j < kCandsPerThread; ++j) {
        const int b = b0 + j;
        if (b < n_cand) {
          const float inv = inv_norm[b];
#pragma unroll
          for (int i = 0; i < kRowsPerThread; ++i) {
            take_if_before(acc[i][j] * inv, b, best[i], best_i[i]);
          }
        }
      }
    }
    // Across the 8 candidate groups of a warp (lanes that share lane / 8),
    // then across the 4 warp columns.
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
#pragma unroll
      for (int off = 1; off < 8; off <<= 1) {
        take_if_before(__shfl_xor_sync(0xffffffffu, best[i], off),
                       __shfl_xor_sync(0xffffffffu, best_i[i], off), best[i],
                       best_i[i]);
      }
    }
    if (lane % 8 == 0) {
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) {
        const int r = row_group * kRowsPerThread + i;
        red_score[(warp % kWarpColumns) * kTileRows + r] = best[i];
        red_idx[(warp % kWarpColumns) * kTileRows + r] = best_i[i];
      }
    }
    __syncthreads();
    if (tid < kTileRows && p0 + tid < n_cand) {
      float s = red_score[tid];
      int b = red_idx[tid];
      for (int col = 1; col < kWarpColumns; ++col) {
        take_if_before(red_score[col * kTileRows + tid],
                       red_idx[col * kTileRows + tid], s, b);
      }
      row_out[p0 + tid] = b;
    }
  }
}

// -- The walk ---------------------------------------------------------------

// A block's shared memory (232,448 bytes on the card) less 64 bytes for its
// static variables.
constexpr int kSmemInts = (232448 - 64) / 4;
constexpr int kWalkStages = 4;         // the maps pass's ring of stages
constexpr int kWalkStageRows = 16;     // table rows a stage holds
constexpr int kWalkEmitFrames = 8;     // frames an emit thread walks
constexpr int kWalkMaxThreads = 1024;
constexpr int kEmitThreads = 128;

__host__ __device__ inline int round4(int v) { return (v + 3) & ~3; }

// Checkpoints a segment of seg frames writes: one every kWalkEmitFrames
// frames and one at its end (its map).
__host__ __device__ inline int walk_bounds(int seg) {
  return (seg + kWalkEmitFrames - 1) / kWalkEmitFrames;
}

// Ints of a maps-pass stage: its rows, shifted by up to 3 ints so that they
// sit at the source's offset modulo 16 bytes.
__host__ __device__ inline int stage_len(int n_cand, int stage_rows) {
  return round4(stage_rows * n_cand) + 4;
}

// Shared ints of a maps-pass CTA: the starts' state row and the ring.
__host__ __device__ inline int maps_smem_ints(int n_cand, int stage_rows) {
  return round4(n_cand) + kWalkStages * stage_len(n_cand, stage_rows);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async_16(int* dst, const int* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" :::
                   "memory");
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

// A kernel launched by launch_dependent waits here for the kernel before
// it on the stream to finish and its writes to be visible.
__device__ __forceinline__ void wait_for_previous_kernel() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// TMA bulk copy of `bytes` (a multiple of 16; both addresses 16-byte
// aligned) into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load(int* dst, const int* src,
                                         unsigned bytes,
                                         unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// The block copies `maps` rows of ld ints (16-byte aligned, ld % 4 == 0)
// from src, `stride` ints apart, into dst, and waits for them.
__device__ __forceinline__ void stage_maps(int* dst, const int* src,
                                           long long stride, int maps,
                                           int ld) {
  const int vecs = ld / 4;
  for (int v = threadIdx.x; v < maps * vecs; v += blockDim.x) {
    const int i = v / vecs;
    const int w = 4 * (v - i * vecs);
    cp_async_16(dst + i * ld + w, src + i * stride + w);
  }
  cp_async_wait_all();
  __syncthreads();
}

// Pass 1. Segment s = blockIdx.x holds frames s*seg .. min(K, s*seg + seg).
// part[s][j][p]: where start p stands after min((j+1)*8, seg) of its frames,
// -1 once it has met an entry outside [0, n_cand). Thread 0 keeps the ring
// full: each stage's 16-byte aligned body by one TMA bulk copy, its ragged
// ends (up to 3 ints each) by plain loads.
__global__ void __launch_bounds__(kWalkMaxThreads)
wsola_walk_maps_kernel(const int* __restrict__ table, int n_cand, int frames,
                       int seg, int stage_rows, int ld,
                       int* __restrict__ part, int* __restrict__ counter) {
  extern __shared__ __align__(16) int walk_smem[];
  __shared__ __align__(8) unsigned long long full[kWalkStages];
  int* state = walk_smem;       // [ld]
  int* ring = walk_smem + ld;   // [kWalkStages][stage_len]
  const int slot_len = stage_len(n_cand, stage_rows);
  const int n_bounds = walk_bounds(seg);
  const long long row0 = static_cast<long long>(blockIdx.x) * seg;
  const int rows = static_cast<int>(
      min(static_cast<long long>(seg), frames - row0));
  const int stages = (rows + stage_rows - 1) / stage_rows;
  const int* seg_rows = table + row0 * n_cand;
  int* seg_part = part + static_cast<long long>(blockIdx.x) * n_bounds * ld;

  // Stage c's rows sit in its slot at their source's offset mod 16 bytes.
  auto lead_of = [&](int c) {
    const int* src = seg_rows + static_cast<long long>(c) * stage_rows * n_cand;
    return static_cast<int>((reinterpret_cast<unsigned long long>(src) & 15) /
                            4);
  };
  auto stage = [&](int c) {  // thread 0
    const int r0 = c * stage_rows;
    const int count = min(stage_rows, rows - r0) * n_cand;
    const int* src = seg_rows + static_cast<long long>(r0) * n_cand;
    const int lead = lead_of(c);
    int* dst = ring + (c % kWalkStages) * slot_len + lead;
    const int head = min(count, (4 - lead) & 3);
    const int body = (count - head) & ~3;
    mbar_expect(&full[c % kWalkStages], 4u * body);
    if (body > 0) {
      tma_load(dst + head, src + head, 4u * body, &full[c % kWalkStages]);
    }
    for (int i = 0; i < head; ++i) dst[i] = src[i];
    for (int i = head + body; i < count; ++i) dst[i] = src[i];
  };
  if (threadIdx.x == 0) {
    if (blockIdx.x == 0) *counter = 0;  // the carry pass's
    for (int i = 0; i < kWalkStages; ++i) mbar_init(&full[i]);
    mbar_init_fence();
    for (int c = 0; c < kWalkStages - 1 && c < stages; ++c) stage(c);
  }
  for (int p = threadIdx.x; p < n_cand; p += blockDim.x) state[p] = p;
  __syncthreads();
  for (int c = 0; c < stages; ++c) {
    // Stage c + 3 refills the slot of stage c - 1, which every thread left
    // at the last barrier; its ragged ends are seen after the barriers to
    // come, its body through its mbarrier.
    if (threadIdx.x == 0 && c + kWalkStages - 1 < stages) {
      stage(c + kWalkStages - 1);
    }
    mbar_wait(&full[c % kWalkStages], (c / kWalkStages) & 1);
    const int* staged = ring + (c % kWalkStages) * slot_len + lead_of(c);
    const int r0 = c * stage_rows;
    const int n_rows = min(stage_rows, rows - r0);
    for (int p = threadIdx.x; p < n_cand; p += blockDim.x) {
      int b = state[p];
      for (int i = 0; i < n_rows; ++i) {
        if (b >= 0) {
          b = staged[i * n_cand + b];
          if (static_cast<unsigned>(b) >= static_cast<unsigned>(n_cand)) {
            b = -1;
          }
        }
        const int done = r0 + i + 1;
        if (done % kWalkEmitFrames == 0 || done == seg) {
          seg_part[static_cast<long long>((done - 1) / kWalkEmitFrames) * ld +
                   p] = b;
        }
      }
      state[p] = b;
    }
    __syncthreads();
  }
}

// Pass 2. Map m, part[m][n_bounds - 1], carries segment m's start to
// segment m + 1's. CTA g composes maps g*group .. (its last), staged in
// shared memory, and writes prefix[m][p]: where start p of segment g*group
// stands after maps g*group .. m. The last CTA to finish carries across the
// groups, gstarts[0] = 0, gstarts[g+1] = prefix[(g+1)*group - 1][gstarts[g]]
// (-1 stays -1), and writes every segment's start: starts[s] =
// prefix[s-1][gstarts[(s-1) / group]] for s = 1 .. n_maps.
__global__ void __launch_bounds__(kWalkMaxThreads)
wsola_walk_carry_kernel(const int* __restrict__ part, int n_maps,
                        int n_bounds, int n_cand, int ld, int group,
                        int chunk, int* __restrict__ prefix,
                        int* __restrict__ gstarts, int* __restrict__ starts,
                        int* __restrict__ counter) {
  extern __shared__ __align__(16) int walk_smem[];
  __shared__ bool last;
  int* state = walk_smem;          // [ld]
  int* maps = walk_smem + ld;      // [chunk][ld]
  const int m_end = min(n_maps, (blockIdx.x + 1) * group);
  wait_for_previous_kernel();
  for (int p = threadIdx.x; p < n_cand; p += blockDim.x) state[p] = p;
  for (int m0 = blockIdx.x * group; m0 < m_end; m0 += chunk) {
    const int count = min(chunk, m_end - m0);
    stage_maps(maps, part + (static_cast<long long>(m0) * n_bounds +
                             n_bounds - 1) * ld,
               static_cast<long long>(n_bounds) * ld, count, ld);
    for (int p = threadIdx.x; p < n_cand; p += blockDim.x) {
      int b = state[p];
      for (int i = 0; i < count; ++i) {
        if (b >= 0) b = maps[i * ld + b];
        prefix[static_cast<long long>(m0 + i) * ld + p] = b;
      }
      state[p] = b;
    }
    __syncthreads();
  }
  // The last CTA to get here sees every CTA's prefix rows.
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(counter, 1) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  int start = 0;
  if (threadIdx.x == 0) gstarts[0] = 0;
  const int groups = gridDim.x;
  for (int g0 = 0; g0 + 1 < groups; g0 += chunk) {
    const int count = min(chunk, groups - 1 - g0);
    stage_maps(maps, prefix + (static_cast<long long>(g0 + 1) * group - 1) * ld,
               static_cast<long long>(group) * ld, count, ld);
    if (threadIdx.x == 0) {
      for (int i = 0; i < count; ++i) {
        if (start >= 0) start = maps[i * ld + start];
        gstarts[g0 + i + 1] = start;
      }
    }
    __syncthreads();
  }
  __syncthreads();  // gstarts
  for (int s = 1 + threadIdx.x; s <= n_maps; s += blockDim.x) {
    const int g = gstarts[(s - 1) / group];
    starts[s] =
        g >= 0 ? __ldcg(prefix + static_cast<long long>(s - 1) * ld + g) : -1;
  }
}

// Pass 3. Thread t walks frames j*8 .. j*8 + 7 of segment s (t = s *
// n_bounds + j) in global memory from the checkpoint before them: at most
// 10 dependent loads.
__global__ void __launch_bounds__(kEmitThreads)
wsola_walk_emit_kernel(const int* __restrict__ table, int n_cand, int frames,
                       int seg, int ld, const int* __restrict__ part,
                       const int* __restrict__ starts, int* __restrict__ bs) {
  const int n_bounds = walk_bounds(seg);
  wait_for_previous_kernel();
  const long long t =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long s = t / n_bounds;
  const int j = static_cast<int>(t - s * n_bounds);
  const long long seg0 = s * seg;
  const long long k0 = seg0 + static_cast<long long>(j) * kWalkEmitFrames;
  if (k0 >= frames) return;
  const long long k1 = min(min(k0 + kWalkEmitFrames, seg0 + seg),
                           static_cast<long long>(frames));
  int b = s > 0 ? starts[s] : 0;
  if (j > 0 && b >= 0) b = part[(s * n_bounds + j - 1) * ld + b];
  for (long long k = k0; k < k1; ++k) {
    if (b >= 0) {
      b = table[k * n_cand + b];
      if (static_cast<unsigned>(b) >= static_cast<unsigned>(n_cand)) b = -1;
    }
    bs[k] = b;
  }
}

// Rows of a maps-pass stage: kWalkStageRows, or fewer where the ring would
// not fit (0: the row is too wide for the kernel).
int walk_stage_rows(int n_cand) {
  int rows = kWalkStageRows;
  while (rows > 0 && maps_smem_ints(n_cand, rows) > kSmemInts) --rows;
  return rows;
}

// The carry's layout for segs segments: (maps, maps a group, groups, maps a
// staged chunk). Groups of ~sqrt(maps) maps balance the group CTAs' work
// against the last CTA's.
struct CarryPlan {
  int maps, group, groups, chunk;
};

CarryPlan carry_plan(int n_cand, long long segs) {
  CarryPlan plan;
  plan.maps = static_cast<int>(segs - 1);
  plan.group = 1;
  while (static_cast<long long>(plan.group) * plan.group < plan.maps) {
    ++plan.group;
  }
  plan.groups = plan.maps > 0 ? (plan.maps + plan.group - 1) / plan.group : 0;
  plan.chunk = kSmemInts / round4(n_cand) - 1;
  return plan;
}

long long walk_scratch_ints(int n_cand, long long segs, int seg) {
  const CarryPlan plan = carry_plan(n_cand, segs);
  // part, prefix, gstarts, starts, the counter
  return (segs * walk_bounds(seg) + plan.maps) * round4(n_cand) +
         plan.groups + segs + 1;
}

// Launches kernel so that it may start while the kernel before it on the
// stream drains (programmatic dependent launch); it waits for that kernel
// in wait_for_previous_kernel.
template <typename... Params, typename... Args>
cudaError_t launch_dependent(void (*kernel)(Params...), unsigned grid,
                             int threads, int smem, cudaStream_t stream,
                             Args... args) {
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(grid);
  config.blockDim = dim3(threads);
  config.dynamicSmemBytes = static_cast<size_t>(smem);
  config.stream = stream;
  config.attrs = &attr;
  config.numAttrs = 1;
  return cudaLaunchKernelEx(&config, kernel, args...);
}

}  // namespace

extern "C" {

// Shared memory bytes of one score-table CTA.
long long nodey_wsola_table_smem_bytes(int channels, int seek, int overlap) {
  return smem_bytes(channels, seek, overlap);
}

// table int32 [frames, seek+1]. Frame k reads x's columns pos(k) ..
// pos(k) + seek + overlap and pos(k-1) + stride .. pos(k-1) + seq + seek,
// frame 0 the head x[:, :overlap] (every window inside the row); x's rows
// are `ld` floats apart, each row's samples contiguous; frames_per_cta >= 1.
int nodey_wsola_score_table(const float* x, long long ld, int channels,
                            int frames, int frames_per_cta, long long num,
                            long long den, int seq, int seek, int overlap,
                            int* table, void* stream) {
  const long long smem = smem_bytes(channels, seek, overlap);
  cudaError_t err = cudaFuncSetAttribute(
      score_table_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((frames + frames_per_cta - 1) / frames_per_cta,
                  (seek + 1 + kTileRows - 1) / kTileRows);
  score_table_kernel<<<grid, kThreads, static_cast<size_t>(smem),
                       static_cast<cudaStream_t>(stream)>>>(
      x, ld, channels, frames, frames_per_cta, num, den, seq, seek, overlap,
      table);
  return static_cast<int>(cudaGetLastError());
}

// The widest row the walk takes: a state row and kWalkStages staged rows
// in a block's shared memory.
int nodey_wsola_walk_max_cands() {
  int n = kSmemInts / (kWalkStages + 1);
  while (walk_stage_rows(n) < 1) --n;
  return n;
}

// Scratch ints of one walk through segments of seg frames.
long long nodey_wsola_walk_scratch_ints(int n_cand, int frames, int seg) {
  return walk_scratch_ints(
      n_cand, (static_cast<long long>(frames) + seg - 1) / seg, seg);
}

// bs int32 [frames] from table int32 [frames, n_cand] (row-major, 4-byte
// aligned), through segments of seg >= 1 frames; scratch holds
// nodey_wsola_walk_scratch_ints(n_cand, frames, seg) ints, 16-byte
// aligned; n_cand <= nodey_wsola_walk_max_cands(), frames >= 1. Launches
// the three passes and returns the first error.
int nodey_wsola_table_walk(const int* table, int n_cand, int frames, int seg,
                           int* scratch, int* bs, void* stream) {
  const int stage_rows = walk_stage_rows(n_cand);
  if (stage_rows < 1 || frames < 1 || seg < 1 ||
      (reinterpret_cast<unsigned long long>(scratch) & 15) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int ld = round4(n_cand);
  const int n_bounds = walk_bounds(seg);
  const long long segs = (static_cast<long long>(frames) + seg - 1) / seg;
  const CarryPlan plan = carry_plan(n_cand, segs);
  int* part = scratch;
  int* prefix = part + segs * n_bounds * ld;
  int* gstarts = prefix + static_cast<long long>(plan.maps) * ld;
  int* starts = gstarts + plan.groups;
  int* counter = starts + segs;
  const int threads = std::min(kWalkMaxThreads, (n_cand + 31) / 32 * 32);

  const int maps_smem = 4 * maps_smem_ints(n_cand, stage_rows);
  cudaError_t err = cudaFuncSetAttribute(
      wsola_walk_maps_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      maps_smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  wsola_walk_maps_kernel<<<static_cast<unsigned>(segs), threads, maps_smem,
                           st>>>(table, n_cand, frames, seg, stage_rows, ld,
                                 part, counter);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  if (plan.groups > 0) {
    const int carry_smem =
        4 * ld * (1 + std::min(plan.chunk, std::max(plan.group, plan.groups)));
    err = cudaFuncSetAttribute(wsola_walk_carry_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               carry_smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = launch_dependent(wsola_walk_carry_kernel,
                           static_cast<unsigned>(plan.groups), threads,
                           carry_smem, st, part, plan.maps, n_bounds, n_cand,
                           ld, plan.group, plan.chunk, prefix, gstarts, starts,
                           counter);
    if (err != cudaSuccess) return static_cast<int>(err);
  }

  const long long emitters = segs * n_bounds;
  err = launch_dependent(
      wsola_walk_emit_kernel,
      static_cast<unsigned>((emitters + kEmitThreads - 1) / kEmitThreads),
      kEmitThreads, 0, st, table, n_cand, frames, seg, ld, part, starts, bs);
  return static_cast<int>(err);
}

const char* nodey_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
