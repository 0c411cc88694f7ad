// The cross-block sums of these kernels.
//
// On the TPU a Pallas kernel carries a sum from one grid step to the next
// in an output block that every step revisits, because the grid runs in
// order on one core.  Hopper's blocks run in parallel and in no order, so
// each kernel here writes per-block partial sums, one row per block, and
// the rows are added up column by column in a FIXED order: by a second
// launch (sum_rows: the conv, ConvTranspose and 1x1 kernels), or inside
// the same launch after a grid-wide barrier (block_period_sums and
// grid_column_sums: the BN-ReLU backward reduction and the pool backward).
// No float atomics: the result is the same on every run.
//
// What bounds it: device-memory bandwidth over the partial rows, which are
// far smaller than the tensors the first passes read.

#pragma once

#include <cooperative_groups.h>
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

// ---- one-launch per-channel sums (the BN-ReLU backward reduction K3 and
// the pool backward): a persistent grid, launched cooperatively, whose
// blocks each add their threads' register sums into one row of 2C
// partials (block_period_sums), wait at a grid-wide barrier, and then add
// the 2C columns over the rows in block order, the columns spread over the
// blocks (grid_column_sums).  Fixed order everywhere, no float atomics:
// the same bits on every run on the same card.

constexpr int kGridThreads = 256;  // most threads a block
constexpr int kGridVec = 8;        // most sums of each kind a thread

// A block's sums: thread t holds s[k], q[k] for positions t*K + k of the
// block's flat array of T*K positions (T = blockDim.x), which repeats with
// period L (T*K a multiple of L); position e sums channel (e % L) % C (L a
// multiple of C).  Writes row[c] = the s-sum and row[C + c] = the q-sum of
// channel c: over the periods in order, then over the L/C places of c in a
// period in order.
template <int K>
__device__ __forceinline__ void block_period_sums(const float (&s)[K], const float (&q)[K], int L,
                                                  int C, float* __restrict__ row) {
  static_assert(K <= kGridVec, "at most kGridVec sums of each kind a thread");
  __shared__ float red[2 * kGridThreads * kGridVec];
  __shared__ float col[2 * kGridThreads * kGridVec];  // 2L <= 2 * T * K
  const int t = threadIdx.x, n = blockDim.x * K;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    red[t * K + k] = s[k];
    red[n + t * K + k] = q[k];
  }
  __syncthreads();
  const int periods = n / L;
  for (int j = t; j < 2 * L; j += blockDim.x) {
    const float* src = red + (j < L ? 0 : n) + j % L;
    float acc = 0.f;
    for (int p = 0; p < periods; ++p) acc += src[p * L];
    col[j] = acc;
  }
  __syncthreads();
  const int places = L / C;
  for (int j = t; j < 2 * C; j += blockDim.x) {
    const float* src = col + (j < C ? 0 : L) + j % C;
    float acc = 0.f;
    for (int o = 0; o < places; ++o) acc += src[o * C];
    row[j] = acc;
  }
}

constexpr int kSumGroup = 4;  // columns a block adds at a time in grid_column_sums

// After every block of the cooperative grid has written its row of `ncol`
// partials (row r = block r of part): the grid-wide barrier, then out[j] =
// the sum over rows 0..gridDim.x-1 of part[r * ncol + j].  Block b takes
// the groups of kSumGroup columns b, b + gridDim.x, ...; within a group
// T / kSumGroup row lanes each add the rows l, l + lanes, ... in order, and
// one thread a column adds the lanes in order.
__device__ __forceinline__ void grid_column_sums(const float* part, float* __restrict__ out,
                                                 int ncol) {
  __shared__ float lane_sums[kGridThreads];
  __threadfence();
  cooperative_groups::this_grid().sync();
  const int lanes = blockDim.x / kSumGroup;
  const int t = threadIdx.x, lane = t / kSumGroup, cc = t % kSumGroup;
  const int nrow = gridDim.x;
  for (int j0 = blockIdx.x * kSumGroup; j0 < ncol; j0 += gridDim.x * kSumGroup) {
    const int j = j0 + cc;
    float acc = 0.f;
    if (lane < lanes && j < ncol) {
#pragma unroll 4
      for (int r = lane; r < nrow; r += lanes) acc += __ldcg(part + static_cast<size_t>(r) * ncol + j);
    }
    lane_sums[t] = acc;
    __syncthreads();
    if (t < kSumGroup && j0 + t < ncol) {
      float sum = 0.f;
      for (int l = 0; l < lanes; ++l) sum += lane_sums[l * kSumGroup + t];
      out[j0 + t] = sum;
    }
    __syncthreads();
  }
}

// Blocks of a cooperative launch of `kernel` (`threads` a block, `bytes`
// of dynamic shared memory): the SMs times the blocks resident on one.
// Kept per device and `key` (0 <= key < 512), which the caller makes
// unique to (kernel, threads, bytes); a negative key queries every time.
template <typename Kernel>
inline cudaError_t grid_blocks(Kernel kernel, int threads, size_t bytes, int key, int& blocks) {
  constexpr int kDevices = 16, kKeys = 512;
  static int cached[kDevices][kKeys] = {};  // 0: not queried yet
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (key >= kKeys) return cudaErrorInvalidValue;
  const bool keep = key >= 0 && dev < kDevices;
  if (!keep || cached[dev][key] == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, bytes);
    }
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    blocks = sms * per_sm;
    if (keep) cached[dev][key] = blocks;
    return cudaSuccess;
  }
  blocks = cached[dev][key];
  return cudaSuccess;
}

}  // namespace
}  // namespace imgseg
