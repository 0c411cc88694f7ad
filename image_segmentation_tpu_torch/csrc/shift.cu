// Per-row and per-column variable shift of packed pixels, zero fill:
//   row:  out[n, i, j] = x[n, i, j - s[n, i]]
//   col:  out[n, i, j] = x[n, i - s[n, j], j]
// over (N, H, W) int32 planes, each element one u8x4 pixel (the augmentor's
// image + mask channels) or any other 32-bit word.  Three of these (row,
// col, row) are the three shears of the nearest-neighbour rotation.
//
// Replaces: image_segmentation_tpu/ops/pallas_roll.py _make_shift (:55;
// body _shift_kernel_body :33), reached through pallas_row_shift (:78) and
// pallas_col_shift (:87) from ops/augment.py _rotate_shear3.  The TPU
// kernel rolls the whole plane by the binary digits of each row's shift
// inside VMEM, then masks with (j >= s) & (j < size + s); here every thread
// reads its source element directly, and the same predicate is
// 0 <= j - s < size, so the result is the same word for word.
//
// What bounds it on the card: device-memory bandwidth.  It moves whole
// 32-bit words and computes nothing: one read and one write of 4 bytes per
// element (2 x 16.8 MB for a batch-16 512x512 plane stack, ~10 us at
// 3.35 TB/s).
//
// What the design does about it: one thread per output element, the
// element's row and column from its flat index.  A row shift reads a
// contiguous run of its source row, so a warp's reads and writes coalesce.
// A column shift reads, for each output column j, row i - s[j], which
// differs from lane to lane: those reads are scattered over up to 32 rows.
// Staging a tile in shared memory for the column pass, or fusing flip,
// quarter turn and the three shears into one pass, is later work.

#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace {

constexpr int THREADS = 256;

template <bool ROW>
__global__ void __launch_bounds__(THREADS) shift_kernel(
    const int32_t* __restrict__ x,       // (N, H, W)
    const int32_t* __restrict__ shifts,  // (N, H) for ROW, (N, W) otherwise
    int32_t* __restrict__ out,           // (N, H, W)
    int H, int W, size_t total) {
  for (size_t e = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x; e < total;
       e += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const int j = static_cast<int>(e % W);
    const size_t t = e / W;  // n * H + i
    int32_t v = 0;
    if constexpr (ROW) {
      const long long src = static_cast<long long>(j) - shifts[t];
      if (src >= 0 && src < W) v = x[t * W + src];
    } else {
      const int i = static_cast<int>(t % H);
      const size_t n = t / H;
      const long long src = static_cast<long long>(i) - shifts[n * W + j];
      if (src >= 0 && src < H) v = x[(n * H + src) * W + j];
    }
    out[e] = v;
  }
}

}  // namespace

// out = the row (axis 1) or column (axis 0) shift of x by `shifts`; see above.
extern "C" int imgseg_shift(const void* x, const void* shifts, void* out, int N, int H, int W,
                            int axis, void* stream) {
  const size_t total = static_cast<size_t>(N) * H * W;
  if (total == 0) return static_cast<int>(cudaSuccess);
  const size_t blocks = std::min<size_t>((total + THREADS - 1) / THREADS, 132 * 64);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* xi = static_cast<const int32_t*>(x);
  const auto* si = static_cast<const int32_t*>(shifts);
  auto* oi = static_cast<int32_t*>(out);
  if (axis == 1) {
    shift_kernel<true><<<static_cast<unsigned>(blocks), THREADS, 0, s>>>(xi, si, oi, H, W, total);
  } else if (axis == 0) {
    shift_kernel<false><<<static_cast<unsigned>(blocks), THREADS, 0, s>>>(xi, si, oi, H, W, total);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
