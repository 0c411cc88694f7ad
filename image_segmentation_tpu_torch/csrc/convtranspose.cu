// ConvTranspose2d(kernel 2, stride 2), NHWC bf16, fp32 sums:
//   y[b, 2i+dy, 2j+dx, o] = bias[o] + sum_c x[b, i, j, c] * w[c, dy, dx, o].
//
// Replaces: image_segmentation_tpu/ops/pallas_conv.py
// make_folded_convtranspose2x2 (:1795) forward, _fwd_pallas (:1852; kernel
// body _ct_fwd_kernel_body :1745), as the decoder's up-conv at
// models/folded.py:586-595.  The TPU kernel is one matmul whose output rows
// are interleaved in VMEM; this kernel is the same matmul with the 2x2
// interleave done in the epilogue's store addresses.  The weight comes in
// torch's ConvTranspose2d layout (flax's spatial flip already undone by
// utils/convert.state_dict_from_jax), rearranged by the
// wrapper to (Cin, 2, 2, Co).
//
// What bounds it on the card: at the serving shapes it is one GEMM of
// (B*Hin*Win) x Cin by Cin x 4*Co with Cin 64..128, i.e. 2*Cin FLOPs per
// output element against ~2 bytes written: ~64..128 FLOP/byte, below the
// H100's bf16 ridge but above what the fp32 FMA pipes sustain, so this first
// kernel is bound by its fp32 FMA rate.
//
// What the design does about it: a classic shared-memory tiled GEMM.  Each
// 256-thread block computes 64 input pixels x 64 output columns (tap, o),
// stages 16-deep slices of both operands in shared memory as fp32 and keeps
// a 4x4 fp32 accumulator per thread, so each staged value feeds 64 FMAs.
// The epilogue adds the bias and scatters each column to its (dy, dx)
// output pixel, so no intermediate ever lands in device memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int BM = 64;  // input pixels per block
constexpr int BN = 64;  // output columns (tap, o) per block
constexpr int BK = 16;  // input channels staged per step
constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS) convtranspose2x2_kernel(
    const __nv_bfloat16* __restrict__ x,  // (M = B*Hin*Win, Cin)
    const __nv_bfloat16* __restrict__ w,  // (Cin, N = 4*Co), columns (dy, dx, o)
    const float* __restrict__ bias,       // (Co)
    __nv_bfloat16* __restrict__ y,        // (B, 2Hin, 2Win, Co)
    long long M, int Hin, int Win, int Cin, int Co) {
  // +4: the transposed staging stores hit 2-way, not 16-way, bank conflicts
  __shared__ __align__(16) float As[BK][BM + 4];
  __shared__ __align__(16) float Bs[BK][BN];

  const int N = 4 * Co;
  const int tid = threadIdx.x;
  const long long m0 = static_cast<long long>(blockIdx.x) * BM;
  const int n0 = blockIdx.y * BN;
  const int tr = (tid / 16) * 4;  // this thread's rows tr..tr+3
  const int tc = (tid % 16) * 4;  // and columns tc..tc+3

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < Cin; k0 += BK) {
    for (int i = tid; i < BM * BK; i += THREADS) {
      const int r = i / BK, k = i % BK;
      const long long gm = m0 + r;
      const int gk = k0 + k;
      As[k][r] = (gm < M && gk < Cin) ? __bfloat162float(x[gm * Cin + gk]) : 0.f;
    }
    for (int i = tid; i < BK * BN; i += THREADS) {
      const int k = i / BN, cidx = i % BN;
      const int gk = k0 + k, gn = n0 + cidx;
      Bs[k][cidx] = (gk < Cin && gn < N)
                        ? __bfloat162float(w[static_cast<size_t>(gk) * N + gn])
                        : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(&As[k][tr]);
      const float4 b = *reinterpret_cast<const float4*>(&Bs[k][tc]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long gm = m0 + tr + i;
    if (gm >= M) continue;
    const int ix = static_cast<int>(gm % Win);
    const long long t = gm / Win;
    const int iy = static_cast<int>(t % Hin);
    const long long nb = t / Hin;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + tc + j;
      if (gn >= N) continue;
      const int tap = gn / Co, o = gn % Co;
      const int oy = 2 * iy + tap / 2, ox = 2 * ix + tap % 2;
      const size_t dst = ((static_cast<size_t>(nb) * 2 * Hin + oy) * 2 * Win + ox) * Co + o;
      y[dst] = __float2bfloat16(acc[i][j] + bias[o]);
    }
  }
}

}  // namespace

extern "C" int imgseg_convtranspose2x2(const void* x, const void* w, const void* bias, void* y,
                                       int B, int Hin, int Win, int Cin, int Co,
                                       void* stream) {
  const long long M = static_cast<long long>(B) * Hin * Win;
  if (M <= 0 || Co <= 0) return static_cast<int>(cudaSuccess);
  const dim3 grid(static_cast<unsigned>((M + BM - 1) / BM), (4 * Co + BN - 1) / BN);
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
  convtranspose2x2_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
      static_cast<const float*>(bias), static_cast<__nv_bfloat16*>(y), M, Hin, Win, Cin, Co);
  return static_cast<int>(cudaGetLastError());
}
