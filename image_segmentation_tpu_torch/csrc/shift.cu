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
// kernel keeps a whole plane in VMEM, rolls it by the binary digits of each
// row's shift and masks with (j >= s) & (j < size + s); here the source
// element is read directly, and the same predicate is 0 <= j - s < size,
// so the result is the same word for word for any shift.
//
// What bounds it on the card: device-memory bandwidth.  It moves whole
// 32-bit words and computes nothing: one read and one write of 4 bytes per
// element (2 x 16.8 MB for a batch-16 512x512 plane stack, ~10 us at
// 3.35 TB/s).
//
// What the design does about it: every block knows its plane, rows or
// column strip from blockIdx, so the only 64-bit index arithmetic is one
// offset per row or plane, and the per-element work is 32-bit.
// - Row form: each warp takes a segment of up to SEG words of one row.  It
//   stages the SEG source words its outputs read (the row's words j0 - s
//   ... j0 - s + SEG - 1, zero outside the row) into shared memory with
//   16-byte cp.async copies, and writes its output words with 16-byte
//   stores, each made of two 16-byte shared-memory reads and a shift by
//   the (warp-uniform) misalignment of the source.  Vectors are aligned to
//   the absolute addresses of x and out, so any row length and any 4-byte
//   aligned base take the same path; the words of a vector that leaves the
//   row are read and written one by one.
// - Column form: a block takes a strip of 32 columns and OUT_ROWS output
//   rows of one plane.  The source rows its outputs read lie between the
//   strip's least and greatest shift, at most OUT_ROWS + max s - min s of
//   them; when they fit the WIN-row window in shared memory, the block
//   stages them with coalesced 16-byte cp.async copies (one-word loads
//   where the strip is not 16-byte aligned), and each warp writes output
//   rows coalesced, lane j reading column j of its source row (bank j: no
//   conflicts).  Strips whose shifts spread further (|s| of random tables,
//   tall planes) read their source words straight from device memory: the
//   same words, just slower.

#include <cuda_runtime.h>

#include <algorithm>
#include <climits>
#include <cstdint>

#include "mma.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
// row form: output words per warp, and the 16-byte vectors a warp stages
// (one more than SEG / 4, for the source's offset within a vector)
constexpr int SEG = 512;
constexpr int SEG_VECS = SEG / 4 + 1;
// column form: columns and output rows per block, and the source rows the
// shared-memory window holds (32 KB)
constexpr int STRIP = 32;
constexpr int OUT_ROWS = 64;
constexpr int WIN = 256;

// A shift of at least `size` either way moves every element out: clamping
// keeps j - s in 32 bits for any int32 shift.
__device__ __forceinline__ int clamp_shift(int s, int size) { return min(max(s, -size), size); }

// Words k, k+1, k+2, k+3 of the staged buffer, from the two vectors that hold them.
__device__ __forceinline__ int4 words4(const int4* buf, int k) {
  const int4 a = buf[k >> 2];
  switch (k & 3) {
    case 0:
      return a;
    case 1: {
      const int4 b = buf[(k >> 2) + 1];
      return make_int4(a.y, a.z, a.w, b.x);
    }
    case 2: {
      const int4 b = buf[(k >> 2) + 1];
      return make_int4(a.z, a.w, b.x, b.y);
    }
    default: {
      const int4 b = buf[(k >> 2) + 1];
      return make_int4(a.w, b.x, b.y, b.z);
    }
  }
}

// Row form.  Warp unit u = (row, segment); xmis / omis: the word offset of
// x / out from a 16-byte boundary.
__global__ void __launch_bounds__(THREADS) row_shift_kernel(
    const int32_t* __restrict__ x, const int32_t* __restrict__ shifts, int32_t* __restrict__ out,
    int W, int segs, long long units, int xmis, int omis) {
  __shared__ __align__(16) int4 stage[WARPS][SEG_VECS];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long u = static_cast<long long>(blockIdx.x) * WARPS + warp;
  if (u >= units) return;
  const long long row = u / segs;
  const int j0 = static_cast<int>(u - row * segs) * SEG;
  const int jn = min(SEG, W - j0);
  const int s = clamp_shift(shifts[row], W);
  const long long rowbase = row * W;
  const int32_t* xr = x + rowbase;
  int32_t* orow = out + rowbase;
  int4* buf = stage[warp];
  int32_t* words = reinterpret_cast<int32_t*>(buf);

  // stage the source words a = j0 - s ... a + jn - 1 from the vector
  // boundary at or before a: buffer word k is row word first + k
  const int a = j0 - s;
  const int lead = static_cast<int>((rowbase + xmis + a) & 3);
  const int first = a - lead;
  const int nvec = (lead + jn + 3) >> 2;
  for (int v = lane; v < nvec; v += 32) {
    const int r0 = first + 4 * v;
    if (r0 >= 0 && r0 + 4 <= W) {
      imgseg::cp_async16(buf + v, xr + r0, true);
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int r = r0 + k;
        words[4 * v + k] = (r >= 0 && r < W) ? xr[r] : 0;
      }
    }
  }
  imgseg::cp_async_commit();
  imgseg::cp_async_wait_all();
  __syncwarp();

  // output word j (j0 <= j < j0 + jn) is buffer word lead + j - j0
  const int jf = j0 - static_cast<int>((rowbase + omis + j0) & 3);  // its vector boundary
  const int nout = (j0 + jn - jf + 3) >> 2;
  for (int v = lane; v < nout; v += 32) {
    const int jv = jf + 4 * v;
    if (jv >= j0 && jv + 4 <= j0 + jn) {
      *reinterpret_cast<int4*>(orow + jv) = words4(buf, lead + jv - j0);
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int j = jv + k;
        if (j >= j0 && j < j0 + jn) orow[j] = words[lead + j - j0];
      }
    }
  }
}

// Column form.  Block = (plane n, row block, strip); vec: every strip row
// starts on a 16-byte boundary (W % 4 == 0 and x 16-byte aligned).
__global__ void __launch_bounds__(THREADS) col_shift_kernel(
    const int32_t* __restrict__ x, const int32_t* __restrict__ shifts, int32_t* __restrict__ out,
    int H, int W, int strips, int row_blocks, bool vec) {
  __shared__ __align__(16) int32_t win[WIN][STRIP];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int strip = static_cast<int>(blockIdx.x % strips);
  const long long t = blockIdx.x / strips;
  const int rb = static_cast<int>(t % row_blocks);
  const long long n = t / row_blocks;
  const int c0 = strip * STRIP;
  const int cols = min(STRIP, W - c0);
  const int r0 = rb * OUT_ROWS;
  const int r1 = min(H, r0 + OUT_ROWS);
  const long long plane = n * H * static_cast<long long>(W);
  const int32_t* xp = x + plane + c0;
  int32_t* op = out + plane + c0;

  // lane j's shift; the strip's least and greatest shift bound the source rows
  const bool live = lane < cols;
  const int s = live ? clamp_shift(shifts[n * W + c0 + lane], H) : 0;
  int lo = live ? s : INT_MAX, hi = live ? s : INT_MIN;
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) {
    lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, m));
    hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, m));
  }
  const int w0 = max(0, r0 - hi);      // source rows [w0, w1)
  const int w1 = min(H, r1 - lo);
  const bool staged = w1 - w0 <= WIN;  // the same for every warp of the block

  if (staged && w1 > w0) {
    if (vec) {
      const int nv = cols >> 2;  // vectors per row (cols is a multiple of 4)
      for (int e = threadIdx.x; e < (w1 - w0) * (STRIP / 4); e += THREADS) {
        const int rr = e / (STRIP / 4), v = e % (STRIP / 4);
        if (v < nv) {
          imgseg::cp_async16(&win[rr][4 * v], xp + static_cast<long long>(w0 + rr) * W + 4 * v, true);
        }
      }
    } else {
      for (int e = threadIdx.x; e < (w1 - w0) * STRIP; e += THREADS) {
        const int rr = e / STRIP, j = e % STRIP;
        if (j < cols) win[rr][j] = xp[static_cast<long long>(w0 + rr) * W + j];
      }
    }
    imgseg::cp_async_commit();
    imgseg::cp_async_wait_all();
  }
  __syncthreads();
  if (!live) return;
  for (int i = r0 + warp; i < r1; i += WARPS) {
    const int src = i - s;
    int32_t v = 0;
    if (src >= 0 && src < H) {
      v = staged ? win[src - w0][lane] : xp[static_cast<long long>(src) * W + lane];
    }
    op[static_cast<long long>(i) * W + lane] = v;
  }
}

// Word offset of a 4-byte aligned pointer from the 16-byte boundary before it.
int misalign(const void* p) { return static_cast<int>((reinterpret_cast<uintptr_t>(p) >> 2) & 3); }

}  // namespace

// out = the row (axis 1) or column (axis 0) shift of x by `shifts`; see above.
extern "C" int imgseg_shift(const void* x, const void* shifts, void* out, int N, int H, int W,
                            int axis, void* stream) {
  if (static_cast<long long>(N) * H * W == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* xi = static_cast<const int32_t*>(x);
  const auto* si = static_cast<const int32_t*>(shifts);
  auto* oi = static_cast<int32_t*>(out);
  if (axis == 1) {
    const int segs = (W + SEG - 1) / SEG;
    const long long units = static_cast<long long>(N) * H * segs;
    const long long blocks = (units + WARPS - 1) / WARPS;
    if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidConfiguration);
    row_shift_kernel<<<static_cast<unsigned>(blocks), THREADS, 0, st>>>(
        xi, si, oi, W, segs, units, misalign(x), misalign(out));
  } else if (axis == 0) {
    const int strips = (W + STRIP - 1) / STRIP;
    const int row_blocks = (H + OUT_ROWS - 1) / OUT_ROWS;
    const long long blocks = static_cast<long long>(N) * strips * row_blocks;
    if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidConfiguration);
    const bool vec = W % 4 == 0 && misalign(x) == 0;
    col_shift_kernel<<<static_cast<unsigned>(blocks), THREADS, 0, st>>>(
        xi, si, oi, H, W, strips, row_blocks, vec);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
