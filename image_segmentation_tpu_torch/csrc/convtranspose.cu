// ConvTranspose2d(kernel 2, stride 2), NHWC bf16, fp32 sums, and its
// backward:
//   y[b, 2i+dy, 2j+dx, o] = bias[o] + sum_c x[b, i, j, c] * w[c, dy, dx, o]
//   dx[b, i, j, c] = sum_{dy, dx, o} g[b, 2i+dy, 2j+dx, o] * w[c, dy, dx, o]
//   dw[c, dy, dx, o] = sum_{b, i, j} x[b, i, j, c] * g[b, 2i+dy, 2j+dx, o]
//   db[dy, dx, o] = sum_{b, i, j} g[b, 2i+dy, 2j+dx, o]   (the wrapper sums the taps)
//
// Replaces: image_segmentation_tpu/ops/pallas_conv.py
// make_folded_convtranspose2x2 (:1795): the forward _fwd_pallas (:1852;
// kernel body _ct_fwd_kernel_body :1745), as the decoder's up-conv at
// models/folded.py:586-595, and the backward ct_bwd (:1888; body
// _ct_bwd_kernel_body :1761).  The TPU forward is one matmul whose output
// rows are interleaved in VMEM; this kernel is the same matmul with the 2x2
// interleave done in the epilogue's store addresses, and the backward
// kernels gather the interleaved cotangent in their staging addresses.
// The weight comes in torch's ConvTranspose2d layout (flax's spatial flip
// already undone by utils/convert.state_dict_from_jax), rearranged by the
// wrapper to (Cin, 2, 2, Co) for the forward and (2, 2, Co, Cin) for dx.
//
// What bounds it on the card: at the serving shapes it is one GEMM of
// (B*Hin*Win) x Cin by Cin x 4*Co with Cin 64..128, i.e. 2*Cin FLOPs per
// output element against ~2 bytes written: ~64..128 FLOP/byte, below the
// H100's bf16 ridge but above what the fp32 FMA pipes sustain, so this first
// kernel is bound by its fp32 FMA rate.
//
// What the design does about it: a classic shared-memory tiled GEMM.  Each
// 256-thread block computes 64 x 64 outputs -- forward: input pixels x
// columns (tap, o); dx: input pixels x channels c; dw: channels c x columns
// (tap, o) -- stages 16-deep slices of both operands in shared memory as
// fp32 and keeps a 4x4 fp32 accumulator per thread, so each staged value
// feeds 64 FMAs.  The forward's epilogue adds the bias and scatters each
// column to its (dy, dx) output pixel, so no intermediate ever lands in
// device memory.  dw and db reduce over every input pixel: each block sums
// a contiguous chunk of pixels, writes one tile of partial sums, and a
// fixed-order second pass (reduce.cuh) adds the chunks, where the TPU
// kernel accumulated across its sequential grid.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "reduce.cuh"

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

// g as a (B*Hin*Win) x (4*Co) matrix: row m = (b, i, j), column (tap, o).
__device__ __forceinline__ float gather_g(const __nv_bfloat16* __restrict__ g, long long m, int k,
                                          int Hin, int Win, int Co) {
  const int ix = static_cast<int>(m % Win);
  const long long t = m / Win;
  const int iy = static_cast<int>(t % Hin);
  const long long nb = t / Hin;
  const int tap = k / Co, o = k % Co;
  const size_t pix = (static_cast<size_t>(nb) * 2 * Hin + 2 * iy + tap / 2) * 2 * Win + 2 * ix + tap % 2;
  return __bfloat162float(g[pix * Co + o]);
}

// dx = G (M x 4Co) @ Wt (4Co x Cin), rounded to bf16.
__global__ void __launch_bounds__(THREADS) ct_dx_kernel(
    const __nv_bfloat16* __restrict__ g,   // (B, 2Hin, 2Win, Co)
    const __nv_bfloat16* __restrict__ wt,  // (4*Co, Cin), rows (dy, dx, o)
    __nv_bfloat16* __restrict__ dx,        // (M, Cin)
    long long M, int Hin, int Win, int Cin, int Co) {
  __shared__ __align__(16) float As[BK][BM + 4];
  __shared__ __align__(16) float Bs[BK][BN];
  const int K = 4 * Co;
  const int tid = threadIdx.x;
  const long long m0 = static_cast<long long>(blockIdx.x) * BM;
  const int n0 = blockIdx.y * BN;
  const int tr = (tid / 16) * 4, tc = (tid % 16) * 4;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int i = tid; i < BM * BK; i += THREADS) {
      const int r = i / BK, k = i % BK;
      const long long gm = m0 + r;
      const int gk = k0 + k;
      As[k][r] = (gm < M && gk < K) ? gather_g(g, gm, gk, Hin, Win, Co) : 0.f;
    }
    for (int i = tid; i < BK * BN; i += THREADS) {
      const int k = i / BN, c = i % BN;
      const int gk = k0 + k, gn = n0 + c;
      Bs[k][c] = (gk < K && gn < Cin) ? __bfloat162float(wt[static_cast<size_t>(gk) * Cin + gn]) : 0.f;
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
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + tc + j;
      if (gn < Cin) dx[gm * Cin + gn] = __float2bfloat16(acc[i][j]);
    }
  }
}

// Partial dw = X^T (Cin x M) @ G (M x 4Co) and db = column sums of G over
// this block's chunk of rows m.
__global__ void __launch_bounds__(THREADS) ct_dw_kernel(
    const __nv_bfloat16* __restrict__ x,  // (M, Cin)
    const __nv_bfloat16* __restrict__ g,  // (B, 2Hin, 2Win, Co)
    float* __restrict__ part_w,           // (chunks, Cin, 4*Co)
    float* __restrict__ part_b,           // (chunks, 4*Co)
    long long M, int Hin, int Win, int Cin, int Co, long long per_chunk) {
  __shared__ __align__(16) float As[BK][BM];
  __shared__ __align__(16) float Bs[BK][BN];
  const int N = 4 * Co;
  const int n_tiles = (N + BN - 1) / BN;
  const int c0 = (blockIdx.x / n_tiles) * BM;
  const int n0 = (blockIdx.x % n_tiles) * BN;
  const int tid = threadIdx.x;
  const int tr = (tid / 16) * 4, tc = (tid % 16) * 4;
  const long long mb = static_cast<long long>(blockIdx.y) * per_chunk;
  const long long me = mb + per_chunk < M ? mb + per_chunk : M;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  float bsum[4] = {0.f, 0.f, 0.f, 0.f};

  for (long long m0 = mb; m0 < me; m0 += BK) {
    for (int i = tid; i < BK * BM; i += THREADS) {
      const int k = i / BM, c = i % BM;
      const long long gm = m0 + k;
      const int gc = c0 + c;
      As[k][c] = (gm < me && gc < Cin) ? __bfloat162float(x[gm * Cin + gc]) : 0.f;
    }
    for (int i = tid; i < BK * BN; i += THREADS) {
      const int k = i / BN, c = i % BN;
      const long long gm = m0 + k;
      const int gn = n0 + c;
      Bs[k][c] = (gm < me && gn < N) ? gather_g(g, gm, gn, Hin, Win, Co) : 0.f;
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
      if (tr == 0) {
#pragma unroll
        for (int j = 0; j < 4; ++j) bsum[j] += bv[j];
      }
    }
    __syncthreads();
  }
  const size_t chunk = blockIdx.y;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gc = c0 + tr + i;
    if (gc >= Cin) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + tc + j;
      if (gn < N) part_w[(chunk * Cin + gc) * N + gn] = acc[i][j];
    }
  }
  if (c0 == 0 && tr == 0) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + tc + j;
      if (gn < N) part_b[chunk * N + gn] = bsum[j];
    }
  }
}

struct BwdPlan {
  int combos;
  long long chunks, per_chunk;
};

BwdPlan bwd_plan(int B, int Hin, int Win, int Cin, int Co) {
  BwdPlan q{};
  const long long M = static_cast<long long>(B) * Hin * Win;
  q.combos = ((Cin + BM - 1) / BM) * ((4 * Co + BN - 1) / BN);
  q.chunks = imgseg::chunks_for((M + BK - 1) / BK, q.combos);
  q.per_chunk = (M + q.chunks - 1) / q.chunks;
  return q;
}

}  // namespace

// Floats of scratch for the backward: a (Cin, 4*Co) and a (4*Co) row per chunk.
extern "C" long long imgseg_convtranspose2x2_bwd_scratch(int B, int Hin, int Win, int Cin, int Co) {
  return bwd_plan(B, Hin, Win, Cin, Co).chunks * (static_cast<long long>(Cin) + 1) * 4 * Co;
}

// dx (B,Hin,Win,Cin) bf16, dw (Cin, 4*Co) fp32 with columns (dy, dx, o), db
// (4*Co) fp32 per (dy, dx, o); x (B,Hin,Win,Cin), wt (2, 2, Co, Cin) bf16,
// g (B,2Hin,2Win,Co).
extern "C" int imgseg_convtranspose2x2_bwd(const void* x, const void* wt, const void* g, void* dx,
                                           void* dw, void* db, void* scratch, int B, int Hin,
                                           int Win, int Cin, int Co, void* stream) {
  const long long M = static_cast<long long>(B) * Hin * Win;
  if (M <= 0 || Co <= 0 || Cin <= 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid_dx(static_cast<unsigned>((M + BM - 1) / BM), (Cin + BN - 1) / BN);
  if (grid_dx.y > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
  ct_dx_kernel<<<grid_dx, THREADS, 0, s>>>(
      static_cast<const __nv_bfloat16*>(g), static_cast<const __nv_bfloat16*>(wt),
      static_cast<__nv_bfloat16*>(dx), M, Hin, Win, Cin, Co);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const BwdPlan q = bwd_plan(B, Hin, Win, Cin, Co);
  if (q.chunks > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
  float* part_w = static_cast<float*>(scratch);
  float* part_b = part_w + q.chunks * static_cast<long long>(Cin) * 4 * Co;
  ct_dw_kernel<<<dim3(q.combos, static_cast<unsigned>(q.chunks)), THREADS, 0, s>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(g), part_w, part_b,
      M, Hin, Win, Cin, Co, q.per_chunk);
  err = cudaGetLastError();
  if (err == cudaSuccess) {
    err = imgseg::sum_rows(part_w, static_cast<float*>(dw), q.chunks, 4LL * Cin * Co, s);
  }
  if (err == cudaSuccess) err = imgseg::sum_rows(part_b, static_cast<float*>(db), q.chunks, 4LL * Co, s);
  return static_cast<int>(err);
}

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
