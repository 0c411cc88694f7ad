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
// What the design does about it: one pass over (g, y) with 16-byte loads
// (8 bf16 channels per thread; the channel axis is innermost, so a warp
// reads contiguous memory), the mask and products in fp32 registers, the
// sums kept per thread over a chunk of pixels, then added over the block's
// rows in shared memory; one partial row per block and a fixed-order second
// pass (reduce.cuh) instead of the TPU's grid-sequential accumulator.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

#include "reduce.cuh"

namespace {

template <int VEC>
struct alignas(2 * VEC) Pack {
  __nv_bfloat16 v[VEC];
};

template <int VEC>
__global__ void __launch_bounds__(imgseg::kChanThreads) bnred_kernel(
    const __nv_bfloat16* __restrict__ g, const __nv_bfloat16* __restrict__ y,
    const float* __restrict__ ab, float* __restrict__ part, long long npix, int C,
    long long per_chunk, int groups) {
  const int G = C / VEC;
  const int rows = imgseg::kChanThreads / groups;
  const int gl = threadIdx.x % groups, r = threadIdx.x / groups;
  const int grp = blockIdx.y * groups + gl;
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
    const long long p0 = static_cast<long long>(blockIdx.x) * per_chunk;
    const long long p1 = p0 + per_chunk < npix ? p0 + per_chunk : npix;
    for (long long p = p0 + r; p < p1; p += rows) {
      const Pack<VEC> gv = *reinterpret_cast<const Pack<VEC>*>(g + p * C + c);
      const Pack<VEC> yv = *reinterpret_cast<const Pack<VEC>*>(y + p * C + c);
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        const float yf = __bfloat162float(yv.v[k]);
        // mul and add rounded separately, as the plain version does
        const float P = __fadd_rn(__fmul_rn(yf, a[k]), b[k]) > 0.f ? __bfloat162float(gv.v[k]) : 0.f;
        s[k] += __fmul_rn(P, yf);
        q[k] += P;
      }
    }
  }
  imgseg::block_channel_sums<VEC>(s, q, r, gl, rows, groups, blockIdx.y * groups * VEC, C,
                                  part + static_cast<size_t>(blockIdx.x) * 2 * C);
}

template <int VEC>
int launch(const void* g, const void* y, const void* ab, void* sums, void* scratch,
           long long npix, int C, cudaStream_t stream) {
  const int G = C / VEC;
  const int groups = std::min(G, 32);
  const long long chunks = imgseg::channel_chunks(npix);
  const long long per_chunk = (npix + chunks - 1) / chunks;
  const dim3 grid(static_cast<unsigned>(chunks), (G + groups - 1) / groups);
  bnred_kernel<VEC><<<grid, imgseg::kChanThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(g), static_cast<const __nv_bfloat16*>(y),
      static_cast<const float*>(ab), static_cast<float*>(scratch), npix, C, per_chunk, groups);
  cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess) {
    err = imgseg::sum_rows(static_cast<const float*>(scratch), static_cast<float*>(sums), chunks,
                           2LL * C, stream);
  }
  return static_cast<int>(err);
}

}  // namespace

// Floats of scratch for the per-channel sums over `npix` pixels (shared by
// the pool backward): one (2, C) row per chunk.
extern "C" long long imgseg_channel_sums_scratch(long long npix, int C) {
  return imgseg::channel_chunks(npix) * 2LL * C;
}

// sums (2, C) = [sum P*y, sum P] with P = g*[y*a + b > 0]; g, y (B,H,W,C)
// bf16, ab (2, C) fp32.
extern "C" int imgseg_bn_relu_bwd_reduce(const void* g, const void* y, const void* ab, void* sums,
                                         void* scratch, int B, int H, int W, int C, void* stream) {
  const long long npix = static_cast<long long>(B) * H * W;
  if (npix <= 0 || C <= 0) return static_cast<int>(cudaSuccess);
  const bool vec8 = C % 8 == 0 && reinterpret_cast<uintptr_t>(g) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(y) % 16 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return vec8 ? launch<8>(g, y, ab, sums, scratch, npix, C, s)
              : launch<1>(g, y, ab, sums, scratch, npix, C, s);
}
