// 3x3 SAME convolution, NHWC bf16, with the decoder's two-input concat and
// the previous BatchNorm's affine + ReLU applied on load.
//
// Replaces: image_segmentation_tpu/ops/pallas_conv.py _folded_conv_pallas
// (:568; kernel body _conv_kernel_body :423, slab _build_aug :275) in the
// eval form make_folded_conv_bn3x3 (:2033) reaches: `pre` on or off,
// `lanes_b` (the [up | skip] concat), no `stats`.  The TPU kernel works on a
// width-folded tensor; at fold 1 that is this plain NHWC conv.
//
// What bounds it on the card: arithmetic.  At the serving shapes (batch 16,
// 32..128 channels at 512^2 and 256^2) a conv does 2*9*Cin*Co FLOPs per
// output pixel against ~2*(Cin+Co) bytes moved, far above the H100's
// ~295 FLOP/byte ridge, so it is compute bound; this first kernel runs on
// the fp32 FMA pipes, not the tensor cores.
//
// What the design does about it: each 256-thread block computes an 8x16
// pixel by 32 output-channel tile.  It stages 16 input channels at a time
// of the activated (TH+2)x(TW+2) halo tile and the matching 3x3x16x32
// weights in shared memory as fp32, so every staged value feeds 32 (input)
// or 128 (weight) FMAs from shared memory; each thread keeps a 4-pixel by
// 4-channel fp32 accumulator in registers and reuses each loaded input row
// across the three horizontal taps.  The activation, the concat and the zero
// border are all done while staging, so neither the activated tensor nor the
// concat ever exists in device memory (as in the Pallas kernel).  Tensor
// cores (mma.sync / wgmma), TMA and pipelining are left for later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int TH = 8;    // output rows per block
constexpr int TW = 16;   // output columns per block
constexpr int TCO = 32;  // output channels per block
constexpr int CK = 16;   // input channels staged per step
constexpr int IH = TH + 2;
constexpr int IW = TW + 2;
constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS) conv3x3_kernel(
    const __nv_bfloat16* __restrict__ x,   // (B, H, W, Ca)
    const __nv_bfloat16* __restrict__ xb,  // (B, H, W, Cb) or null
    const __nv_bfloat16* __restrict__ w,   // (3, 3, Ca+Cb, Co)
    const float* __restrict__ bias,        // (Co)
    const float* __restrict__ ab,          // (2, Ca) or null
    __nv_bfloat16* __restrict__ out,       // (B, H, W, Co)
    int H, int W, int Ca, int Cb, int Co, int co_tiles) {
  __shared__ float s_in[CK][IH * IW];
  __shared__ __align__(16) float s_w[9][CK][TCO];

  const int cin = Ca + Cb;
  const int tid = threadIdx.x;
  const int x0 = blockIdx.x * TW;
  const int y0 = blockIdx.y * TH;
  const int n = blockIdx.z / co_tiles;
  const int co0 = (blockIdx.z % co_tiles) * TCO;

  // 32 pixel groups (one warp) x 8 channel groups (the warps).
  const int pg = tid % 32;
  const int row = pg / 4;
  const int col = (pg % 4) * 4;
  const int co_t = (tid / 32) * 4;

  float acc[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[j][k] = 0.f;

  for (int c0 = 0; c0 < cin; c0 += CK) {
    for (int i = tid; i < IH * IW * CK; i += THREADS) {
      const int c = i % CK;
      const int p = i / CK;
      const int gy = y0 + p / IW - 1;
      const int gx = x0 + p % IW - 1;
      const int gc = c0 + c;
      float v = 0.f;  // SAME padding: zero AFTER the activation
      if (gy >= 0 && gy < H && gx >= 0 && gx < W && gc < cin) {
        const size_t pix = (static_cast<size_t>(n) * H + gy) * W + gx;
        if (gc < Ca) {
          v = __bfloat162float(x[pix * Ca + gc]);
          if (ab != nullptr) {
            // mul and add rounded separately, as the plain version does
            const float t = __fadd_rn(__fmul_rn(v, ab[gc]), ab[Ca + gc]);
            v = __bfloat162float(__float2bfloat16(fmaxf(t, 0.f)));
          }
        } else {
          v = __bfloat162float(xb[pix * Cb + (gc - Ca)]);
        }
      }
      s_in[c][p] = v;
    }
    for (int i = tid; i < 9 * CK * TCO; i += THREADS) {
      const int co = i % TCO;
      const int c = (i / TCO) % CK;
      const int tap = i / (TCO * CK);
      const int gc = c0 + c;
      const int gco = co0 + co;
      s_w[tap][c][co] =
          (gc < cin && gco < Co)
              ? __bfloat162float(w[(static_cast<size_t>(tap) * cin + gc) * Co + gco])
              : 0.f;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < CK; ++c) {
#pragma unroll
      for (int ky = 0; ky < 3; ++ky) {
        float xs[6];
#pragma unroll
        for (int j = 0; j < 6; ++j) xs[j] = s_in[c][(row + ky) * IW + col + j];
#pragma unroll
        for (int kx = 0; kx < 3; ++kx) {
          const float4 wv = *reinterpret_cast<const float4*>(&s_w[ky * 3 + kx][c][co_t]);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float xv = xs[j + kx];
            acc[j][0] = fmaf(xv, wv.x, acc[j][0]);
            acc[j][1] = fmaf(xv, wv.y, acc[j][1]);
            acc[j][2] = fmaf(xv, wv.z, acc[j][2]);
            acc[j][3] = fmaf(xv, wv.w, acc[j][3]);
          }
        }
      }
    }
    __syncthreads();
  }

  const int gy = y0 + row;
  if (gy >= H) return;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int gx = x0 + col + j;
    if (gx >= W) continue;
    const size_t base = ((static_cast<size_t>(n) * H + gy) * W + gx) * Co;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int gco = co0 + co_t + k;
      if (gco < Co) out[base + gco] = __float2bfloat16(acc[j][k] + bias[gco]);
    }
  }
}

}  // namespace

extern "C" int imgseg_conv3x3(const void* x, const void* xb, const void* w,
                              const void* bias, const void* ab, void* out, int B,
                              int H, int W, int Ca, int Cb, int Co, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || Co <= 0) return static_cast<int>(cudaSuccess);
  const int co_tiles = (Co + TCO - 1) / TCO;
  const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B * co_tiles);
  if (grid.y > 65535 || grid.z > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
  conv3x3_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(xb),
      static_cast<const __nv_bfloat16*>(w), static_cast<const float*>(bias),
      static_cast<const float*>(ab), static_cast<__nv_bfloat16*>(out), H, W, Ca, Cb,
      Co, co_tiles);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* imgseg_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
