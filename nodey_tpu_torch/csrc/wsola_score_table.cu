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
// The walk is one thread: K dependent loads b = F[k][b], latency-bound; the
// table stays on the card (no copy to the host, no sync).
//
// C interface (loaded with ctypes): each entry launches on the given stream
// and returns cudaGetLastError(); none synchronizes or allocates.

#include <cuda_runtime.h>

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

// b_k = table[k][b_{k-1}], b_{-1} = 0. An entry outside [0, n_cand) (a table
// this kernel did not write) stops the walk: it and the rest are -1.
__global__ void table_walk_kernel(const int* __restrict__ table, int n_cand,
                                  int frames, int* __restrict__ bs) {
  int b = 0;
  for (long long k = 0; k < frames; ++k) {
    b = table[k * n_cand + b];
    if (b < 0 || b >= n_cand) {
      for (; k < frames; ++k) bs[k] = -1;
      return;
    }
    bs[k] = b;
  }
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

// bs int32 [frames] from table int32 [frames, n_cand] (row-major).
int nodey_wsola_table_walk(const int* table, int n_cand, int frames, int* bs,
                           void* stream) {
  table_walk_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      table, n_cand, frames, bs);
  return static_cast<int>(cudaGetLastError());
}

const char* nodey_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
