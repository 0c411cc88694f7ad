// The second pass of every cross-block sum in these kernels.
//
// On the TPU a Pallas kernel carries a sum from one grid step to the next
// in an output block that every step revisits, because the grid runs in
// order on one core.  Hopper's blocks run in parallel and in no order, so
// each kernel here writes per-block partial sums, one row per block, and
// this pass adds the rows up column by column in a FIXED order.  No
// atomics: the result is the same on every run.
//
// What bounds it: device-memory bandwidth over the partial rows, which are
// far smaller than the tensors the first passes read.

#pragma once

#include <cuda_runtime.h>

namespace imgseg {
namespace {  // one internal copy per translation unit

constexpr int kSumThreads = 256;
constexpr int kSumCols = 32;                         // columns per block
constexpr int kSumLanes = kSumThreads / kSumCols;    // row lanes per column

// out[j] = sum_{r < nrow} in[r * ncol + j]: lane l of column j adds rows
// l, l + 8, ... in order, then lane 0 adds the 8 lane sums in order.
__global__ void __launch_bounds__(kSumThreads) sum_rows_kernel(
    const float* __restrict__ in, float* __restrict__ out, long long nrow, long long ncol) {
  __shared__ float part[kSumLanes][kSumCols];
  const int c = threadIdx.x % kSumCols;
  const int lane = threadIdx.x / kSumCols;
  const long long j = static_cast<long long>(blockIdx.x) * kSumCols + c;
  float acc = 0.f;
  if (j < ncol) {
    for (long long r = lane; r < nrow; r += kSumLanes) acc += in[r * ncol + j];
  }
  part[lane][c] = acc;
  __syncthreads();
  if (lane == 0 && j < ncol) {
    float s = 0.f;
#pragma unroll
    for (int l = 0; l < kSumLanes; ++l) s += part[l][c];
    out[j] = s;
  }
}

inline cudaError_t sum_rows(const float* in, float* out, long long nrow, long long ncol,
                            cudaStream_t stream) {
  if (ncol <= 0) return cudaSuccess;
  const long long blocks = (ncol + kSumCols - 1) / kSumCols;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  sum_rows_kernel<<<static_cast<unsigned>(blocks), kSumThreads, 0, stream>>>(in, out, nrow, ncol);
  return cudaGetLastError();
}

// Number of parallel chunks to split `units` of work into so that about
// `target` blocks are in flight with `per_chunk_blocks` blocks per chunk.
inline long long chunks_for(long long units, long long per_chunk_blocks, long long target = 132 * 4) {
  long long n = (target + per_chunk_blocks - 1) / per_chunk_blocks;
  if (n > units) n = units;
  return n < 1 ? 1 : n;
}

// ---- per-channel sums over pixels, for kernels whose 256-thread blocks
// are laid out as `rows` x `groups` threads: thread (r, g) handles the VEC
// channels of group g for every rows-th pixel of the block's chunk.

constexpr int kChanThreads = 256;
constexpr int kChanMaxVec = 8;

// The two per-thread sums s, q of VEC channels, added over the block's rows
// in row order; the block's row of partials is out[0..C) = s, out[C..2C) = q
// for the channels [cbase, cbase + groups*VEC).
template <int VEC>
__device__ __forceinline__ void block_channel_sums(const float (&s)[VEC], const float (&q)[VEC],
                                                   int r, int g, int rows, int groups,
                                                   int cbase, int C, float* out) {
  __shared__ float red[2 * kChanThreads * kChanMaxVec];
  const int width = groups * VEC;
  if (r < rows) {
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      red[r * width + g * VEC + k] = s[k];
      red[(rows + r) * width + g * VEC + k] = q[k];
    }
  }
  __syncthreads();
  for (int j = threadIdx.x; j < width; j += blockDim.x) {
    float a = 0.f, b = 0.f;
    for (int rr = 0; rr < rows; ++rr) {
      a += red[rr * width + j];
      b += red[(rows + rr) * width + j];
    }
    const int c = cbase + j;
    if (c < C) {
      out[c] = a;
      out[C + c] = b;
    }
  }
}

// Chunks over `units` pixels for the per-channel sums: independent of the
// vector width, so the scratch size is known before the launch picks it.
inline long long channel_chunks(long long units) { return chunks_for(units, 1); }

}  // namespace
}  // namespace imgseg
