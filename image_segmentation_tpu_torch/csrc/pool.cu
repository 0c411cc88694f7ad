// 2x2 / stride-2 max-pool of relu(z*a + b), NHWC bf16, and its backward:
// the encoder block's bn2 affine + ReLU applied on load, so the activated
// full-resolution tensor never exists in device memory in either direction.
//
// Replaces: image_segmentation_tpu/ops/pallas_conv.py make_folded_pool
// (:1608) with with_ab=True, as models/folded.py:651-673 calls it: the
// forward _fwd_pallas (:1629; kernel body _pool_fwd_kernel_body :1507) and
// the backward _bwd_pallas (:1665; body _pool_bwd_kernel_body :1540).  The
// TPU kernels pool adjacent fold slots; at fold 1 that is this NHWC pool.
//
// What bounds it on the card: device-memory bandwidth.  The forward reads 4
// bf16 values and writes 1 per output element, the backward reads 5 and
// writes 4, with a handful of FLOPs each, orders of magnitude below the
// H100's ~295 FLOP/byte ridge.
//
// What the design does about it: one pass each, a thread per output pixel
// (window) and group of 8 channels, 16-byte vector loads and stores (the
// channel axis is innermost, so a warp reads contiguous memory), the affine
// + ReLU in fp32 in registers.  The backward routes each window's cotangent
// to the window's first maximum in row-major order of the fp32 relu(z*a+b)
// (top row if it holds one, then the left column, as the TPU kernel does)
// and writes dz = round(P*a) with P = routed*[z*a + b > 0]; the affine
// cotangents sum P*z and sum P are summed per thread over a chunk of
// windows, over the block's rows in shared memory, and over the blocks by a
// fixed-order second pass (reduce.cuh) -- the TPU kernel's grid-sequential
// accumulator.  Channel counts that are not a multiple of 8 take a
// one-channel-per-thread instance of the same kernels.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

#include "reduce.cuh"

namespace {

constexpr int THREADS = 256;

template <int VEC>
struct alignas(2 * VEC) Pack {
  __nv_bfloat16 v[VEC];
};

template <int VEC>
__global__ void __launch_bounds__(THREADS) pool_kernel(
    const __nv_bfloat16* __restrict__ z,  // (B, H, W, C)
    const float* __restrict__ ab,         // (2, C): rows a, b
    __nv_bfloat16* __restrict__ p,        // (B, H/2, W/2, C)
    int H, int W, int C, int Ho, int Wo, size_t total) {
  const int cv = C / VEC;
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x; i < total;
       i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const int c = static_cast<int>(i % cv) * VEC;
    size_t t = i / cv;
    const int ox = static_cast<int>(t % Wo);
    t /= Wo;
    const int oy = static_cast<int>(t % Ho);
    const size_t n = t / Ho;
    float a[VEC], b[VEC], m[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      a[k] = ab[c + k];
      b[k] = ab[C + c + k];
      m[k] = 0.f;  // every candidate is a ReLU output, so >= 0
    }
#pragma unroll
    for (int dy = 0; dy < 2; ++dy) {
#pragma unroll
      for (int dx = 0; dx < 2; ++dx) {
        const size_t pix = (n * H + 2 * oy + dy) * W + 2 * ox + dx;
        const Pack<VEC> in = *reinterpret_cast<const Pack<VEC>*>(z + pix * C + c);
#pragma unroll
        for (int k = 0; k < VEC; ++k) {
          // mul and add rounded separately, as the plain version does
          const float u = __fadd_rn(__fmul_rn(__bfloat162float(in.v[k]), a[k]), b[k]);
          m[k] = fmaxf(m[k], fmaxf(u, 0.f));
        }
      }
    }
    Pack<VEC> o;
#pragma unroll
    for (int k = 0; k < VEC; ++k) o.v[k] = __float2bfloat16(m[k]);
    *reinterpret_cast<Pack<VEC>*>(p + ((n * Ho + oy) * Wo + ox) * C + c) = o;
  }
}

template <int VEC>
int launch(const void* z, const void* ab, void* p, int B, int H, int W, int C,
           cudaStream_t stream) {
  const int Ho = H / 2, Wo = W / 2;
  const size_t total = static_cast<size_t>(B) * Ho * Wo * (C / VEC);
  if (total == 0) return static_cast<int>(cudaSuccess);
  const size_t blocks = std::min<size_t>((total + THREADS - 1) / THREADS, 132 * 64);
  pool_kernel<VEC><<<static_cast<unsigned>(blocks), THREADS, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(z), static_cast<const float*>(ab),
      static_cast<__nv_bfloat16*>(p), H, W, C, Ho, Wo, total);
  return static_cast<int>(cudaGetLastError());
}

template <int VEC>
__global__ void __launch_bounds__(imgseg::kChanThreads) pool_bwd_kernel(
    const __nv_bfloat16* __restrict__ z,   // (B, H, W, C)
    const float* __restrict__ ab,          // (2, C): rows a, b
    const __nv_bfloat16* __restrict__ dp,  // (B, H/2, W/2, C)
    __nv_bfloat16* __restrict__ dz,        // (B, H, W, C)
    float* __restrict__ part,              // (chunks, 2, C)
    int H, int W, int C, long long windows, long long per_chunk, int groups) {
  const int G = C / VEC;
  const int rows = imgseg::kChanThreads / groups;
  const int gl = threadIdx.x % groups, r = threadIdx.x / groups;
  const int grp = blockIdx.y * groups + gl;
  const int Ho = H / 2, Wo = W / 2;
  float s[VEC], q[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) s[k] = q[k] = 0.f;
  if (r < rows && grp < G) {
    const int c = grp * VEC;
    float a[VEC], b[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      a[k] = ab[c + k];
      b[k] = ab[C + c + k];
    }
    const long long w0 = static_cast<long long>(blockIdx.x) * per_chunk;
    const long long w1 = w0 + per_chunk < windows ? w0 + per_chunk : windows;
    for (long long wi = w0 + r; wi < w1; wi += rows) {
      const int ox = static_cast<int>(wi % Wo);
      const int oy = static_cast<int>((wi / Wo) % Ho);
      const long long n = wi / (static_cast<long long>(Wo) * Ho);
      size_t pix[4];
      Pack<VEC> in[4], out[4];
#pragma unroll
      for (int d = 0; d < 4; ++d) {  // (dy, dx) = (d / 2, d % 2), row-major
        pix[d] = (static_cast<size_t>(n) * H + 2 * oy + d / 2) * W + 2 * ox + d % 2;
        in[d] = *reinterpret_cast<const Pack<VEC>*>(z + pix[d] * C + c);
      }
      const Pack<VEC> g = *reinterpret_cast<const Pack<VEC>*>(dp + static_cast<size_t>(wi) * C + c);
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        float zf[4], pre[4], u[4];
#pragma unroll
        for (int d = 0; d < 4; ++d) {
          zf[d] = __bfloat162float(in[d].v[k]);
          // mul and add rounded separately, as the forward and the plain version do
          pre[d] = __fadd_rn(__fmul_rn(zf[d], a[k]), b[k]);
          u[d] = fmaxf(pre[d], 0.f);
        }
        const bool top = fmaxf(u[0], u[1]) >= fmaxf(u[2], u[3]);
        const int sel = top ? (u[0] >= u[1] ? 0 : 1) : (u[2] >= u[3] ? 2 : 3);
        const float gk = __bfloat162float(g.v[k]);
#pragma unroll
        for (int d = 0; d < 4; ++d) {
          const float P = (d == sel && pre[d] > 0.f) ? gk : 0.f;
          out[d].v[k] = __float2bfloat16(__fmul_rn(P, a[k]));
          s[k] += __fmul_rn(P, zf[d]);
          q[k] += P;
        }
      }
#pragma unroll
      for (int d = 0; d < 4; ++d) *reinterpret_cast<Pack<VEC>*>(dz + pix[d] * C + c) = out[d];
    }
  }
  imgseg::block_channel_sums<VEC>(s, q, r, gl, rows, groups, blockIdx.y * groups * VEC, C,
                                  part + static_cast<size_t>(blockIdx.x) * 2 * C);
}

template <int VEC>
int launch_bwd(const void* z, const void* ab, const void* dp, void* dz, void* sums, void* scratch,
               int B, int H, int W, int C, cudaStream_t stream) {
  const long long windows = static_cast<long long>(B) * (H / 2) * (W / 2);
  const int G = C / VEC;
  const int groups = std::min(G, 32);
  const long long chunks = imgseg::channel_chunks(windows);
  const long long per_chunk = (windows + chunks - 1) / chunks;
  const dim3 grid(static_cast<unsigned>(chunks), (G + groups - 1) / groups);
  pool_bwd_kernel<VEC><<<grid, imgseg::kChanThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(z), static_cast<const float*>(ab),
      static_cast<const __nv_bfloat16*>(dp), static_cast<__nv_bfloat16*>(dz),
      static_cast<float*>(scratch), H, W, C, windows, per_chunk, groups);
  cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess) {
    err = imgseg::sum_rows(static_cast<const float*>(scratch), static_cast<float*>(sums), chunks,
                           2LL * C, stream);
  }
  return static_cast<int>(err);
}

}  // namespace

extern "C" int imgseg_maxpool2x2_affine_relu(const void* z, const void* ab, void* p, int B,
                                             int H, int W, int C, void* stream) {
  const bool vec8 = C % 8 == 0 && reinterpret_cast<uintptr_t>(z) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(p) % 16 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return vec8 ? launch<8>(z, ab, p, B, H, W, C, s) : launch<1>(z, ab, p, B, H, W, C, s);
}

// dz (B,H,W,C) and sums (2, C) = [sum P*z, sum P] from z (B,H,W,C), ab
// (2, C) and dp (B,H/2,W/2,C); H and W even.  Scratch: see
// imgseg_channel_sums_scratch(B*(H/2)*(W/2), C).
extern "C" int imgseg_maxpool2x2_affine_relu_bwd(const void* z, const void* ab, const void* dp,
                                                 void* dz, void* sums, void* scratch, int B,
                                                 int H, int W, int C, void* stream) {
  if (B <= 0 || H < 2 || W < 2 || C <= 0) return static_cast<int>(cudaSuccess);
  if (H % 2 || W % 2) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec8 = C % 8 == 0 && reinterpret_cast<uintptr_t>(z) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(dp) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(dz) % 16 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return vec8 ? launch_bwd<8>(z, ab, dp, dz, sums, scratch, B, H, W, C, s)
              : launch_bwd<1>(z, ab, dp, dz, sums, scratch, B, H, W, C, s);
}
