// Merged backward of a 1x1 convolution, NHWC bf16 operands, fp32 sums:
//   dx[p][ci] = round(sum_co g[p][co] * w[co][ci])   (skipped on request)
//   dw[co][ci] = sum over pixels p of x[p][ci] * g[p][co]
//   db[co]     = sum over pixels p of g[p][co]
// with w the bf16-rounded (Co, Ci) weight.
//
// Replaces: image_segmentation_tpu/ops/pallas_conv.py _folded_1x1_bwd_pallas
// (:1343; body _1x1_bwd_kernel_body :1306), the backward of make_folded_1x1
// (:1394) behind models/folded.Folded1x1.  The TPU kernel reads the folded
// tensor and sums the kron adjoint over fold slots; at fold 1 that is the
// plain sum over pixels computed here.
//
// What bounds it on the card: device-memory bandwidth.  The stem (Ci 3,
// Co 32) and the output conv (Ci 32, Co 3) of the U-Nets and the
// autoencoder do ~2*Ci*Co FLOPs per pixel against 2*(Ci + Co) bytes read
// (and 2*Ci written for dx): a few FLOPs per byte, far below the H100's
// ~295 FLOP/byte ridge.
//
// What the design does about it: one pass over (x, g).  Each 256-thread
// block walks a contiguous chunk of 128-pixel tiles (fewer pixels for wide
// channels); per tile it stages the x and g rows, which are contiguous in
// NHWC, with 16-byte loads into shared memory as fp32, and keeps the
// bf16-rounded weight there for the whole walk.  dx is written from the
// staged g, 8 channels (16 bytes) per store.  The (Co, Ci) weight gradient
// and the bias gradient are one (Co, Ci + 1) table of E sums -- the bias as
// the product with a column of ones.  The block's threads form G groups of
// ceil(E / K) threads, K entries a thread (K, a template argument, the least
// of 1, 2, 4, 8 that covers E with 256 threads); group r adds its entries
// over the tile's pixels r, r + G, ... in order in fp32 registers, so at
// the U-Nets' widths (E about 100) two groups keep every thread but a few
// busy and no thread loops over entries it does not own.  At the end the
// groups' sums are added in group order through shared memory, and each
// block writes its table once as a row of partial sums; a fixed-order
// second pass (reduce.cuh) adds the rows.  No atomics.  Tensor cores and
// TMA are left for later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "reduce.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int EMAX = 8;                    // sums per thread: Co*(Ci+1) <= THREADS*EMAX
constexpr int TILE = 128;                  // pixels per tile, halved while shared memory is short
constexpr int SMEM_BYTES = 40 * 1024;      // dynamic tiles: with s_red, under 48 KB

struct Args {
  const __nv_bfloat16* x;  // (npix, Ci)
  const __nv_bfloat16* g;  // (npix, Co)
  const __nv_bfloat16* w;  // (Co, Ci)
  __nv_bfloat16* dx;       // (npix, Ci) or null: no input gradient
  float* part;             // (chunks, Co, Ci + 1)
  long long npix, tiles, per_chunk;
  int Ci, Co, P;
};

struct Plan {
  int P;
  long long tiles, chunks, per_chunk;
  size_t smem;
};

size_t smem_bytes(int P, int Ci, int Co) {
  return sizeof(float) * (static_cast<size_t>(P) * (Ci + 1) + static_cast<size_t>(P) * Co +
                          static_cast<size_t>(Co) * Ci);
}

Plan plan(long long npix, int Ci, int Co) {
  Plan q{};
  q.P = TILE;
  while (q.P > 8 && smem_bytes(q.P, Ci, Co) > SMEM_BYTES) q.P /= 2;
  q.smem = smem_bytes(q.P, Ci, Co);
  q.tiles = (npix + q.P - 1) / q.P;
  q.chunks = imgseg::chunks_for(q.tiles, 1, 132 * 8);
  q.per_chunk = (q.tiles + q.chunks - 1) / q.chunks;
  return q;
}

// The first `n` of a tile's `total` contiguous bf16 values of rows of C
// channels, into shared rows of stride `ld` as fp32; zero past `n`.  With
// `vec`, 8 values per 16-byte load (`total` is a multiple of 8).
__device__ __forceinline__ void stage(const __nv_bfloat16* __restrict__ src, int n, int total,
                                      int C, int ld, float* dst, bool vec) {
  if (vec && n == total) {
    for (int i = threadIdx.x; i < total / 8; i += THREADS) {
      const uint4 raw = reinterpret_cast<const uint4*>(src)[i];
      const __nv_bfloat16* v = reinterpret_cast<const __nv_bfloat16*>(&raw);
      int q = (8 * i) / C, c = 8 * i - q * C;
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        dst[q * ld + c] = __bfloat162float(v[k]);
        if (++c == C) c = 0, ++q;
      }
    }
  } else {
    for (int e = threadIdx.x; e < total; e += THREADS) {
      const int q = e / C;
      dst[q * ld + (e - q * C)] = e < n ? __bfloat162float(src[e]) : 0.f;
    }
  }
}

// dx of staged pixel q, channel c: the fp32 sum over the output channels.
__device__ __forceinline__ float dx_at(const float* s_g, const float* s_w, int q, int c, int Ci,
                                       int Co) {
  float s = 0.f;
  for (int co = 0; co < Co; ++co) s = fmaf(s_g[q * Co + co], s_w[co * Ci + c], s);
  return s;
}

template <int K>
__global__ void __launch_bounds__(THREADS) conv1x1_bwd_kernel(const Args p) {
  extern __shared__ float smem[];
  __shared__ float s_red[THREADS];  // the groups' sums (K == 1: G * E <= THREADS)
  const int Ci = p.Ci, Co = p.Co, P = p.P, L = Ci + 1;
  float* s_x = smem;         // P x (Ci + 1): x, then a column of ones (the bias)
  float* s_g = s_x + P * L;  // P x Co
  float* s_w = s_g + P * Co;  // Co x Ci
  const int tid = threadIdx.x;
  for (int i = tid; i < Co * Ci; i += THREADS) s_w[i] = __bfloat162float(p.w[i]);
  for (int q = tid; q < P; q += THREADS) s_x[q * L + Ci] = 1.f;  // staging never writes it

  // this thread's sums: entries j = slot + k*S of the (Co, Ci + 1) table,
  // over the pixels q = grp, grp + G, ... of each tile
  const int E = Co * L;
  const int S = (E + K - 1) / K;
  const int G = THREADS / S;
  const int grp = tid / S, slot = tid - grp * S;
  int off_x[K], off_g[K];
  bool has[K];
  float acc[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int j = slot + k * S;
    has[k] = grp < G && j < E;
    off_g[k] = has[k] ? j / L : 0;
    off_x[k] = has[k] ? j - off_g[k] * L : 0;
    acc[k] = 0.f;
  }

  // P is a multiple of 8, so every tile starts 16-byte aligned if the tensor does
  const bool vx = reinterpret_cast<uintptr_t>(p.x) % 16 == 0;
  const bool vg = reinterpret_cast<uintptr_t>(p.g) % 16 == 0;
  const bool vdx = p.dx != nullptr && reinterpret_cast<uintptr_t>(p.dx) % 16 == 0;

  const long long t0 = static_cast<long long>(blockIdx.x) * p.per_chunk;
  const long long t1 = t0 + p.per_chunk < p.tiles ? t0 + p.per_chunk : p.tiles;
  for (long long t = t0; t < t1; ++t) {
    const long long p0 = t * P;
    const int n = static_cast<int>(p.npix - p0 < P ? p.npix - p0 : P);
    __syncthreads();  // the previous tile's readers are done (and s_w, the ones, are set)
    stage(p.x + p0 * Ci, n * Ci, P * Ci, Ci, L, s_x, vx);
    stage(p.g + p0 * Co, n * Co, P * Co, Co, Co, s_g, vg);
    __syncthreads();

    if (has[0]) {
      for (int q = grp; q < P; q += G) {
        const float* xr = s_x + q * L;
        const float* gr = s_g + q * Co;
#pragma unroll
        for (int k = 0; k < K; ++k) {
          if (has[k]) acc[k] = fmaf(xr[off_x[k]], gr[off_g[k]], acc[k]);
        }
      }
    }

    if (p.dx != nullptr) {
      __nv_bfloat16* dst = p.dx + p0 * Ci;
      const int total = P * Ci, valid = n * Ci;
      if (vdx && valid == total) {  // whole 16-byte stores
        for (int i = tid; i < total / 8; i += THREADS) {
          uint4 raw;
          __nv_bfloat16* o = reinterpret_cast<__nv_bfloat16*>(&raw);
          int q = (8 * i) / Ci, c = 8 * i - q * Ci;
#pragma unroll
          for (int k = 0; k < 8; ++k) {
            o[k] = __float2bfloat16(dx_at(s_g, s_w, q, c, Ci, Co));
            if (++c == Ci) c = 0, ++q;
          }
          reinterpret_cast<uint4*>(dst)[i] = raw;
        }
      } else {
        for (int e = tid; e < valid; e += THREADS) {
          const int q = e / Ci;
          dst[e] = __float2bfloat16(dx_at(s_g, s_w, q, e - q * Ci, Ci, Co));
        }
      }
    }
  }

  float* row = p.part + static_cast<size_t>(blockIdx.x) * E;
  if (K == 1 && G > 1) {  // add the groups' sums in group order
    if (has[0]) s_red[grp * E + slot] = acc[0];
    __syncthreads();
    if (grp == 0 && has[0]) {
      float s = s_red[slot];
      for (int r = 1; r < G; ++r) s += s_red[r * E + slot];
      row[slot] = s;
    }
    return;
  }
#pragma unroll
  for (int k = 0; k < K; ++k) {
    if (has[k]) row[slot + k * S] = acc[k];
  }
}

}  // namespace

// Floats of scratch: one (Co, Ci + 1) row of partial sums per chunk.
extern "C" long long imgseg_conv1x1_bwd_scratch(long long npix, int Ci, int Co) {
  return plan(npix, Ci, Co).chunks * static_cast<long long>(Co) * (Ci + 1);
}

// dwb (Co, Ci + 1) fp32 = [dw | db]; with `dx` also the input gradient.
// x (npix, Ci), g (npix, Co), w (Co, Ci), dx (npix, Ci): bf16, contiguous.
extern "C" int imgseg_conv1x1_bwd(const void* x, const void* g, const void* w, void* dx,
                                  void* dwb, void* scratch, long long npix, int Ci, int Co,
                                  void* stream) {
  if (npix <= 0 || Ci <= 0 || Co <= 0) return static_cast<int>(cudaSuccess);
  if (static_cast<long long>(Co) * (Ci + 1) > static_cast<long long>(THREADS) * EMAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Plan q = plan(npix, Ci, Co);
  // the dynamic tiles and the static s_red under the 48 KB a launch takes without opting in
  if (q.smem + sizeof(float) * THREADS > 48 * 1024 || q.chunks > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args p{};
  p.x = static_cast<const __nv_bfloat16*>(x);
  p.g = static_cast<const __nv_bfloat16*>(g);
  p.w = static_cast<const __nv_bfloat16*>(w);
  p.dx = static_cast<__nv_bfloat16*>(dx);
  p.part = static_cast<float*>(scratch);
  p.npix = npix, p.tiles = q.tiles, p.per_chunk = q.per_chunk;
  p.Ci = Ci, p.Co = Co, p.P = q.P;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long E = static_cast<long long>(Co) * (Ci + 1);
  const unsigned grid = static_cast<unsigned>(q.chunks);
  if (E <= THREADS) {
    conv1x1_bwd_kernel<1><<<grid, THREADS, q.smem, s>>>(p);
  } else if (E <= 2 * THREADS) {
    conv1x1_bwd_kernel<2><<<grid, THREADS, q.smem, s>>>(p);
  } else if (E <= 4 * THREADS) {
    conv1x1_bwd_kernel<4><<<grid, THREADS, q.smem, s>>>(p);
  } else {
    conv1x1_bwd_kernel<EMAX><<<grid, THREADS, q.smem, s>>>(p);
  }
  cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess) {
    err = imgseg::sum_rows(p.part, static_cast<float*>(dwb), q.chunks,
                           static_cast<long long>(Co) * (Ci + 1), s);
  }
  return static_cast<int>(err);
}
