// The BatchNorm-affine + ReLU backward reduction, NHWC bf16 in, fp32 sums:
//   P = g * [y*a + b > 0];  da[c] = sum P*y,  db[c] = sum P
// over (B, H, W): the cotangents of bn2's affine when a block's output is
// z = relu(y2*a2 + b2) (the decoders), with a, b rounded to bf16 and held in
// fp32 (pallas_conv.py:2389-2391).
//
// Replaces: image_segmentation_tpu/ops/pallas_conv.py
// _bn_relu_bwd_reduce_pallas (:1462; body _bnred_kernel_body :1439).
//
// What bounds it on the card: device-memory bandwidth.  It reads two bf16
// tensors once (4 bytes per element) and does a few FLOPs per element, far
// below the H100's ~295 FLOP/byte ridge.
//
// What the design does about it: one cooperative launch of a persistent
// grid (the SMs times the blocks resident on one).  In NHWC the whole
// tensor is one run of pixels, so the kernel reads it as a flat array of
// 16-byte vectors (8 bf16 each), whatever C is: each block walks one
// contiguous range of vectors, each thread every T-th vector of it with four
// vectors of g and four of y in flight.  The flat array repeats its
// channels every L = lcm(C, 8) elements, V = L / 8 vectors; a block of T
// threads, T a multiple of V, and ranges that start at multiples of V give
// every thread the same 8 channels at every step, so its 16 sums stay in
// registers for the whole walk.  The block adds them per channel into one
// row of partials, and after a grid-wide barrier the blocks add the rows in
// block order, in the same launch (reduce.cuh): fixed order, no float
// atomics, no second pass.  a and b arrive as fp32 (C,) vectors and are
// rounded to bf16 here, as the plain version's _round does.  Bulk copies
// (cp.async.bulk) of the runs into a ring of shared memory measured 8-12 %
// slower than these loads at every path's shape (tools/exp_k3_staging.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "reduce.cuh"

namespace {

constexpr int UNROLL = 4;  // vectors of each tensor a thread keeps in flight

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// bf16 element k of a 16-byte vector, exactly, as fp32
__device__ __forceinline__ float elem(const uint4& v, int k) {
  const uint32_t w = (&v.x)[k / 2];
  return __uint_as_float(k % 2 ? w & 0xffff0000u : w << 16);
}

__device__ __forceinline__ void accumulate(const uint4& gv, const uint4& yv, const float (&a)[8],
                                           const float (&b)[8], float (&s)[8], float (&q)[8]) {
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const float yf = elem(yv, k);
    // mul and add rounded separately, as the plain version does
    const float P = __fadd_rn(__fmul_rn(yf, a[k]), b[k]) > 0.f ? elem(gv, k) : 0.f;
    s[k] += __fmul_rn(P, yf);
    q[k] += P;
  }
}

// g, y: n bf16 elements (n = B*H*W*C), 16-byte aligned.  sums: (2, C),
// then gridDim.x rows of (2, C) partials.  Block b walks the vectors
// [b * per_block, (b + 1) * per_block), per_block a multiple of V.
__global__ void __launch_bounds__(imgseg::kGridThreads, 2) bnred_kernel(
    const __nv_bfloat16* __restrict__ g, const __nv_bfloat16* __restrict__ y,
    const float* __restrict__ a_in, const float* __restrict__ b_in, float* __restrict__ sums,
    long long n, int C, int L, long long per_block) {
  const int T = blockDim.x, t = threadIdx.x, V = L / 8;
  const uint4* gv = reinterpret_cast<const uint4*>(g);
  const uint4* yv = reinterpret_cast<const uint4*>(y);
  float a[8], b[8], s[8], q[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int c = (8 * (t % V) + k) % C;
    a[k] = round_bf16(a_in[c]);
    b[k] = round_bf16(b_in[c]);
    s[k] = q[k] = 0.f;
  }
  const long long full = n / 8, nvec = (n + 7) / 8;
  const long long start = blockIdx.x * per_block;
  const long long end = start + per_block < nvec ? start + per_block : nvec;
  const long long end_full = end < full ? end : full;
  long long i = start + t;
  for (; i + (UNROLL - 1) * T < end_full; i += UNROLL * T) {
    uint4 gr[UNROLL], yr[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      gr[u] = __ldcs(gv + i + u * T);
      yr[u] = __ldcs(yv + i + u * T);
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) accumulate(gr[u], yr[u], a, b, s, q);
  }
  for (; i < end; i += T) {
    uint4 gr = make_uint4(0, 0, 0, 0), yr = gr;
    if (i < full) {
      gr = __ldcs(gv + i);
      yr = __ldcs(yv + i);
    } else {  // the last, partial vector (n not a multiple of 8): g = 0 past n
      const unsigned short* gs = reinterpret_cast<const unsigned short*>(g);
      const unsigned short* ys = reinterpret_cast<const unsigned short*>(y);
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        if (8 * i + k < n) {
          (&gr.x)[k / 2] |= static_cast<uint32_t>(gs[8 * i + k]) << (16 * (k % 2));
          (&yr.x)[k / 2] |= static_cast<uint32_t>(ys[8 * i + k]) << (16 * (k % 2));
        }
      }
    }
    accumulate(gr, yr, a, b, s, q);
  }
  imgseg::block_period_sums<8>(s, q, L, C, sums + 2LL * C * (1 + blockIdx.x));
  imgseg::grid_column_sums(sums + 2LL * C, sums, 2 * C);
}

int gcd(int x, int y) { return y == 0 ? x : gcd(y, x % y); }

// The launch for C channels: the period L = lcm(C, 8) and the block size T,
// the largest multiple of V = L / 8 up to 256; false when V > 256.
bool shape_of(int C, int& L, int& T) {
  if (C <= 0) return false;
  const long long lcm = 8LL * C / gcd(C, 8);
  if (lcm / 8 > imgseg::kGridThreads) return false;
  L = static_cast<int>(lcm);
  const int V = L / 8;
  T = V * (imgseg::kGridThreads / V);
  return true;
}

cudaError_t blocks_for(int T, int& blocks) {
  return imgseg::grid_blocks(bnred_kernel, T, 0, T, blocks);
}

}  // namespace

// fp32 elements of the sums buffer for C channels: the (2, C) sums and one
// (2, C) row of partials per block; -1 if the kernel takes no such C
// (lcm(C, 8) > 2048) or the card cannot be queried.
extern "C" long long imgseg_bn_relu_bwd_reduce_floats(int C) {
  int L = 0, T = 0, blocks = 0;
  if (!shape_of(C, L, T) || blocks_for(T, blocks) != cudaSuccess) return -1;
  return 2LL * C * (1 + blocks);
}

// sums[0:2C] = [sum P*y, sum P] with P = g*[y*a + b > 0]; g, y (B,H,W,C)
// bf16, 16-byte aligned; a, b (C,) fp32; sums as
// imgseg_bn_relu_bwd_reduce_floats(C) gives it.
extern "C" int imgseg_bn_relu_bwd_reduce(const void* g, const void* y, const void* a, const void* b,
                                         void* sums, int B, int H, int W, int C, void* stream) {
  int L = 0, T = 0, blocks = 0;
  if (B < 0 || H < 0 || W < 0 || !shape_of(C, L, T)) return static_cast<int>(cudaErrorInvalidValue);
  if (reinterpret_cast<uintptr_t>(g) % 16 || reinterpret_cast<uintptr_t>(y) % 16) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  cudaError_t err = blocks_for(T, blocks);
  if (err != cudaSuccess) return static_cast<int>(err);
  long long n = static_cast<long long>(B) * H * W * C;
  const long long nvec = (n + 7) / 8, V = L / 8;
  long long per_block = (nvec + blocks - 1) / blocks;
  per_block = (per_block + V - 1) / V * V;
  const __nv_bfloat16* gp = static_cast<const __nv_bfloat16*>(g);
  const __nv_bfloat16* yp = static_cast<const __nv_bfloat16*>(y);
  const float* ap = static_cast<const float*>(a);
  const float* bp = static_cast<const float*>(b);
  float* sp = static_cast<float*>(sums);
  void* args[] = {&gp, &yp, &ap, &bp, &sp, &n, &C, &L, &per_block};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(bnred_kernel), dim3(blocks),
                                    dim3(T), args, 0, static_cast<cudaStream_t>(stream));
  return static_cast<int>(err);
}
