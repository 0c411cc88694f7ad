// The pool backward's vector path (csrc/pool.cu pool_bwd_kernel) at other
// depths and cache hints, for tools/exp_pool_bwd.py only: N windows a thread
// in flight, at least MINB blocks an SM (__launch_bounds__), and evict-first
// (CS) or plain loads and stores.  The same routing, sums and one
// cooperative launch as the library's kernel; takes C a multiple of 8 and
// 16-byte aligned operands.  Built by the tool with nvcc against csrc/
// (reduce.cuh); not part of the kernel library.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "reduce.cuh"

namespace {

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

__device__ __forceinline__ float elem(const uint4& v, int k) {
  const uint32_t w = (&v.x)[k / 2];
  return __uint_as_float(k % 2 ? w & 0xffff0000u : w << 16);
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ void route(const float (&zf)[4], float gk, float a, float b,
                                      float (&dz)[4], float& s, float& q) {
  float pre[4], u[4];
#pragma unroll
  for (int d = 0; d < 4; ++d) {
    pre[d] = __fadd_rn(__fmul_rn(zf[d], a), b);
    u[d] = fmaxf(pre[d], 0.f);
  }
  const bool top = fmaxf(u[0], u[1]) >= fmaxf(u[2], u[3]);
  const int sel = top ? (u[0] >= u[1] ? 0 : 1) : (u[2] >= u[3] ? 2 : 3);
#pragma unroll
  for (int d = 0; d < 4; ++d) {
    const float P = (d == sel && pre[d] > 0.f) ? gk : 0.f;
    dz[d] = __fmul_rn(P, a);
    s += __fmul_rn(P, zf[d]);
    q += P;
  }
}

template <bool CS>
__device__ __forceinline__ uint4 load(const __nv_bfloat16* p) {
  const uint4* v = reinterpret_cast<const uint4*>(p);
  if constexpr (CS) {
    return __ldcs(v);
  } else {
    return *v;
  }
}

template <bool CS>
__device__ __forceinline__ void store(__nv_bfloat16* p, const uint4& x) {
  uint4* v = reinterpret_cast<uint4*>(p);
  if constexpr (CS) {
    __stcs(v, x);
  } else {
    *v = x;
  }
}

template <int N, int MINB, bool CS>
__global__ void __launch_bounds__(imgseg::kGridThreads, MINB) pool_bwd_var(
    const __nv_bfloat16* __restrict__ z, const float* __restrict__ a_in,
    const float* __restrict__ b_in, const __nv_bfloat16* __restrict__ dp,
    __nv_bfloat16* __restrict__ dz, float* __restrict__ sums, int W, int C, long long items,
    long long per_block) {
  const int T = blockDim.x, t = threadIdx.x, G = C / 8, Wo = W / 2;
  const int c = (t % G) * 8;
  const size_t row = static_cast<size_t>(W) * C;
  float a[8], b[8], s[8], q[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    a[k] = round_bf16(a_in[c + k]);
    b[k] = round_bf16(b_in[c + k]);
    s[k] = q[k] = 0.f;
  }
  const long long start = blockIdx.x * per_block;
  const long long end = start + per_block < items ? start + per_block : items;
  for (long long i0 = start + t; i0 < end; i0 += N * T) {
    size_t x0[N];
    uint4 in[N][4], g[N];
#pragma unroll
    for (int u = 0; u < N; ++u) {
      const long long i = i0 + u * T < end ? i0 + u * T : i0;
      const long long w = i / G, k = w / Wo;
      x0[u] = (static_cast<size_t>(2 * k) * W + 2 * (w - k * Wo)) * C + c;
#pragma unroll
      for (int d = 0; d < 4; ++d) in[u][d] = load<CS>(z + x0[u] + (d / 2) * row + (d % 2) * C);
      g[u] = load<CS>(dp + static_cast<size_t>(w) * C + c);
    }
#pragma unroll
    for (int u = 0; u < N; ++u) {
      if (i0 + u * T >= end) break;
      uint32_t o[4][4];
#pragma unroll
      for (int k2 = 0; k2 < 4; ++k2) {
        float dz2[2][4];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int k = 2 * k2 + h;
          const float zf[4] = {elem(in[u][0], k), elem(in[u][1], k), elem(in[u][2], k),
                               elem(in[u][3], k)};
          route(zf, elem(g[u], k), a[k], b[k], dz2[h], s[k], q[k]);
        }
#pragma unroll
        for (int d = 0; d < 4; ++d) o[d][k2] = pack2(dz2[0][d], dz2[1][d]);
      }
#pragma unroll
      for (int d = 0; d < 4; ++d) {
        store<CS>(dz + x0[u] + (d / 2) * row + (d % 2) * C,
                  make_uint4(o[d][0], o[d][1], o[d][2], o[d][3]));
      }
    }
  }
  imgseg::block_period_sums<8>(s, q, C, C, sums + 2LL * C * (1 + blockIdx.x));
  imgseg::grid_column_sums(sums + 2LL * C, sums, 2 * C);
}

using Kernel = void (*)(const __nv_bfloat16*, const float*, const float*, const __nv_bfloat16*,
                        __nv_bfloat16*, float*, int, int, long long, long long);

// the variants: (N, MINB, CS); 2 is the library's kernel
const Kernel kVariants[] = {pool_bwd_var<1, 3, true>, pool_bwd_var<2, 2, true>,
                            pool_bwd_var<2, 2, false>, pool_bwd_var<2, 1, true>,
                            pool_bwd_var<3, 1, true>, pool_bwd_var<4, 1, true>};
constexpr int kCount = sizeof(kVariants) / sizeof(kVariants[0]);

cudaError_t plan(int variant, int C, int& threads, int& blocks) {
  if (variant < 0 || variant >= kCount || C <= 0 || C % 8 || C / 8 > imgseg::kGridThreads) {
    return cudaErrorInvalidValue;
  }
  threads = (C / 8) * (imgseg::kGridThreads / (C / 8));
  return imgseg::grid_blocks(kVariants[variant], threads, 0, -1, blocks);
}

}  // namespace

extern "C" int exp_pool_bwd_variants() { return kCount; }

extern "C" long long exp_pool_bwd_floats(int variant, int C) {
  int threads = 0, blocks = 0;
  if (plan(variant, C, threads, blocks) != cudaSuccess) return -1;
  return 2LL * C * (1 + blocks);
}

extern "C" int exp_pool_bwd(int variant, const void* z, const void* a, const void* b,
                            const void* dp, void* dz, void* sums, int B, int H, int W, int C,
                            void* stream) {
  int threads = 0, blocks = 0;
  if (H % 2 || W % 2) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = plan(variant, C, threads, blocks);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int G = C / 8;
  long long items = static_cast<long long>(B) * (H / 2) * (W / 2) * G;
  long long per_block = (items + blocks - 1) / blocks;
  per_block = (per_block + G - 1) / G * G;
  const __nv_bfloat16* zp = static_cast<const __nv_bfloat16*>(z);
  const __nv_bfloat16* dpp = static_cast<const __nv_bfloat16*>(dp);
  __nv_bfloat16* dzp = static_cast<__nv_bfloat16*>(dz);
  const float* ap = static_cast<const float*>(a);
  const float* bp = static_cast<const float*>(b);
  float* sp = static_cast<float*>(sums);
  void* args[] = {&zp, &ap, &bp, &dpp, &dzp, &sp, &W, &C, &items, &per_block};
  return static_cast<int>(cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kVariants[variant]),
                                                      dim3(blocks), dim3(threads), args, 0,
                                                      static_cast<cudaStream_t>(stream)));
}
