// 2x2 / stride-2 max-pool of relu(z*a + b), NHWC bf16: the encoder block's
// bn2 affine + ReLU applied on load, so the activated full-resolution tensor
// never exists in device memory.
//
// Replaces: image_segmentation_tpu/ops/pallas_conv.py make_folded_pool
// (:1608) forward, _fwd_pallas (:1629; kernel body _pool_fwd_kernel_body
// :1507) with with_ab=True, as models/folded.py:651-673 calls it.  The TPU
// kernel pools adjacent fold slots; at fold 1 that is this plain NHWC pool.
//
// What bounds it on the card: device-memory bandwidth.  It reads 4 bf16
// values and writes 1 per output element with a handful of FLOPs each,
// orders of magnitude below the H100's ~295 FLOP/byte ridge.
//
// What the design does about it: one pass, one thread per output pixel and
// group of 8 channels.  Each thread reads its four input pixels as 16-byte
// vectors (8 bf16 channels; the channel axis is innermost, so a warp reads
// contiguous memory), applies the affine + ReLU in fp32 in registers, takes
// the max and writes one 16-byte vector.  Channel counts that are not a
// multiple of 8 take a one-channel-per-thread instance of the same kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

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

}  // namespace

extern "C" int imgseg_maxpool2x2_affine_relu(const void* z, const void* ab, void* p, int B,
                                             int H, int W, int C, void* stream) {
  const bool vec8 = C % 8 == 0 && reinterpret_cast<uintptr_t>(z) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(p) % 16 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return vec8 ? launch<8>(z, ab, p, B, H, W, C, s) : launch<1>(z, ab, p, B, H, W, C, s);
}
