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
// What the design does about it.  The forward: one pass, a thread per
// output pixel (window) and group of 8 channels, 16-byte vector loads and
// stores (the channel axis is innermost, so a warp reads contiguous
// memory), the affine + ReLU in fp32 in registers; channel counts that are
// not a multiple of 8 take a one-channel-per-thread instance.  The
// backward routes each window's cotangent to the window's first maximum in
// row-major order of the fp32 relu(z*a + b) (top row if it holds one, then
// the left column, as the TPU kernel does) and writes dz = round(P*a) with
// P = routed*[z*a + b > 0]; it is one cooperative launch of a persistent
// grid whose blocks walk contiguous runs of windows, every thread on fixed
// channels, so the affine cotangents sum P*z and sum P stay in registers
// until the block adds them into one row of partials, and the blocks add
// the rows in block order after a grid-wide barrier, in the same launch
// (reduce.cuh): the TPU kernel's grid-sequential accumulator, in a fixed
// order.  With C a multiple of 8 each thread reads z and dp and writes dz
// by 16-byte vectors, two windows in flight; otherwise runs of whole
// window rows (two image rows of whole pixels) are staged in shared memory
// by 16-byte loads and dz goes out by 16-byte stores.

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

// ---- the backward: one cooperative launch of a persistent grid (the SMs
// times the blocks resident on one), the affine sums added in the same
// launch (reduce.cuh).

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// bf16 element k of a 16-byte vector, exactly, as fp32
__device__ __forceinline__ float elem(const uint4& v, int k) {
  const uint32_t w = (&v.x)[k / 2];
  return __uint_as_float(k % 2 ? w & 0xffff0000u : w << 16);
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// One channel of one window: z at its (dy, dx) = (d / 2, d % 2) pixels,
// row-major, and the window's cotangent gk.  The cotangent goes to the
// first maximum in row-major order of the fp32 relu(z*a + b) (the top row
// if it holds one, then the left column, as the TPU kernel does); returns
// dz = P*a with P = routed*[z*a + b > 0] per pixel and adds P*z and P to
// the sums.
__device__ __forceinline__ void route(const float (&zf)[4], float gk, float a, float b,
                                      float (&dz)[4], float& s, float& q) {
  float pre[4], u[4];
#pragma unroll
  for (int d = 0; d < 4; ++d) {
    // mul and add rounded separately, as the forward and the plain version do
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

// The vector path (C a multiple of 8): an item is one window's 8 channels
// c .. c+7 of group i % G (G = C / 8): 4 vectors of z (its 2x2 pixels),
// one of dp, 4 of dz, 16 bytes each.  Block b walks the items [b *
// per_block, (b + 1) * per_block), per_block a multiple of G, each thread
// every T-th with two items (10 vectors) in flight; T a multiple of G, so a
// thread's channels never change and its 16 sums stay in registers.  Plain
// loads and stores: evict-first ones (__ldcs, __stcs) measured 2-3 %
// slower, one item or three in flight no faster (tools/exp_pool_bwd.py).
__global__ void __launch_bounds__(imgseg::kGridThreads, 2) pool_bwd_kernel(
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
  constexpr int N = 2;  // items a thread keeps in flight
  for (long long i0 = start + t; i0 < end; i0 += N * T) {
    size_t x0[N];  // the window's top-left pixel, channel c
    uint4 in[N][4], g[N];
#pragma unroll
    for (int u = 0; u < N; ++u) {
      const long long i = i0 + u * T < end ? i0 + u * T : i0;  // a repeat is not stored
      const long long w = i / G, k = w / Wo;
      x0[u] = (static_cast<size_t>(2 * k) * W + 2 * (w - k * Wo)) * C + c;
#pragma unroll
      for (int d = 0; d < 4; ++d) {
        in[u][d] = *reinterpret_cast<const uint4*>(z + x0[u] + (d / 2) * row + (d % 2) * C);
      }
      g[u] = *reinterpret_cast<const uint4*>(dp + static_cast<size_t>(w) * C + c);
    }
#pragma unroll
    for (int u = 0; u < N; ++u) {
      if (i0 + u * T >= end) break;
      uint32_t o[4][4];  // dz of the 4 pixels, 8 channels packed in pairs
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
        *reinterpret_cast<uint4*>(dz + x0[u] + (d / 2) * row + (d % 2) * C) =
            make_uint4(o[d][0], o[d][1], o[d][2], o[d][3]);
      }
    }
  }
  imgseg::block_period_sums<8>(s, q, C, C, sums + 2LL * C * (1 + blockIdx.x));
  imgseg::grid_column_sums(sums + 2LL * C, sums, 2 * C);
}

// 16-byte vectors [0, ceil(count / 8)) of src -> dst; only a vector at the
// tensor's end can be partial (count not a multiple of 8), loaded by element.
__device__ __forceinline__ void stage_in(const __nv_bfloat16* src, long long count, uint4* dst) {
  const long long nv = (count + 7) / 8;
  for (long long v = threadIdx.x; v < nv; v += blockDim.x) {
    if (8 * v + 8 <= count) {
      dst[v] = __ldcs(reinterpret_cast<const uint4*>(src) + v);
    } else {
      __nv_bfloat16* d = reinterpret_cast<__nv_bfloat16*>(dst + v);
      for (long long e = 8 * v; e < count; ++e) d[e - 8 * v] = src[e];
    }
  }
}

// The narrow path (C not a multiple of 8): runs of R window rows, whole
// pixels: 2R image rows of z and R rows of dp, each one contiguous range
// that starts on 16 bytes (R a multiple of m = 8 / gcd(W/2 * C, 8)),
// staged in shared memory by 16-byte loads; a thread per (window, channel)
// of the run (T a multiple of C, so its channel never changes) writes dz
// over the staged z, which goes back out by 16-byte stores.  Blocks take
// runs b, b + gridDim.x, ...
__global__ void __launch_bounds__(imgseg::kGridThreads) pool_bwd_narrow_kernel(
    const __nv_bfloat16* __restrict__ z, const float* __restrict__ a_in,
    const float* __restrict__ b_in, const __nv_bfloat16* __restrict__ dp,
    __nv_bfloat16* __restrict__ dz, float* __restrict__ sums, int W, int C, long long krows,
    int R) {
  extern __shared__ uint4 stage[];
  const int T = blockDim.x, t = threadIdx.x, c = t % C, Wo = W / 2;
  const float a = round_bf16(a_in[c]), b = round_bf16(b_in[c]);
  float s[1] = {0.f}, q[1] = {0.f};
  const long long drow = static_cast<long long>(Wo) * C, zrow = 4 * drow;  // elements a window row
  uint4* zs = stage;
  uint4* ds = stage + R * zrow / 8;
  __nv_bfloat16* zb = reinterpret_cast<__nv_bfloat16*>(zs);
  const __nv_bfloat16* db = reinterpret_cast<const __nv_bfloat16*>(ds);
  const long long runs = (krows + R - 1) / R;
  for (long long r = blockIdx.x; r < runs; r += gridDim.x) {
    const long long k0 = r * R, rows = krows - k0 < R ? krows - k0 : R;
    const long long zc = rows * zrow;
    stage_in(z + k0 * zrow, zc, zs);
    stage_in(dp + k0 * drow, rows * drow, ds);
    __syncthreads();
    for (long long e = t; e < rows * drow; e += T) {
      const long long w = e / C, k = w / Wo;
      const long long x0 = (2 * k * W + 2 * (w - k * Wo)) * C + c;
      const long long at[4] = {x0, x0 + C, x0 + 2 * drow, x0 + 2 * drow + C};
      float zf[4], o[4];
#pragma unroll
      for (int d = 0; d < 4; ++d) zf[d] = __bfloat162float(zb[at[d]]);
      route(zf, __bfloat162float(db[e]), a, b, o, s[0], q[0]);
#pragma unroll
      for (int d = 0; d < 4; ++d) zb[at[d]] = __float2bfloat16(o[d]);
    }
    __syncthreads();
    __nv_bfloat16* out = dz + k0 * zrow;
    for (long long v = t; v < (zc + 7) / 8; v += T) {
      if (8 * v + 8 <= zc) {
        __stcs(reinterpret_cast<uint4*>(out) + v, zs[v]);
      } else {
        for (long long e = 8 * v; e < zc; ++e) out[e] = zb[e];
      }
    }
    __syncthreads();
  }
  imgseg::block_period_sums<1>(s, q, C, C, sums + 2LL * C * (1 + blockIdx.x));
  imgseg::grid_column_sums(sums + 2LL * C, sums, 2 * C);
}

int gcd(long long x, long long y) { return static_cast<int>(y == 0 ? x : gcd(y, x % y)); }

constexpr int kStageBytes = 32 << 10;   // a narrow run's staging, when one aligned group fits
constexpr int kMaxStageBytes = 192 << 10;

// A backward launch for width W and C channels: the kernel, block size,
// dynamic shared memory, the narrow path's rows a run, and the blocks.
struct Plan {
  bool narrow;
  int threads, R, blocks;
  size_t bytes;
};

cudaError_t plan_of(int W, int C, long long krows, Plan& p) {
  if (C <= 0 || W < 0 || W % 2) return cudaErrorInvalidValue;
  p.narrow = C % 8 != 0;
  if (!p.narrow) {
    const int G = C / 8;
    if (G > imgseg::kGridThreads) return cudaErrorInvalidValue;
    p.threads = G * (imgseg::kGridThreads / G);
    p.R = 0;
    p.bytes = 0;
    return imgseg::grid_blocks(pool_bwd_kernel, p.threads, 0, p.threads, p.blocks);
  }
  if (C > imgseg::kGridThreads) return cudaErrorInvalidValue;
  p.threads = C * (imgseg::kGridThreads / C);
  const long long drow = static_cast<long long>(W / 2) * C;  // dp elements a window row
  const long long m = drow > 0 ? 8 / gcd(drow, 8) : 1;       // window rows a 16-byte aligned group
  const long long group = 10 * m * drow;                     // staged bytes (z and dp) a group
  if (group > kMaxStageBytes) return cudaErrorInvalidValue;
  long long groups = group > 0 ? (group >= kStageBytes ? 1 : kStageBytes / group) : 1;
  const long long need = (krows + m - 1) / m;                // groups that cover every row
  if (groups > need) groups = need > 0 ? need : 1;
  p.R = static_cast<int>(groups * m);
  p.bytes = static_cast<size_t>(groups * group);
  static bool opted = false;  // the opt-in past 48 KB of dynamic shared memory, once
  if (!opted) {
    const cudaError_t err = cudaFuncSetAttribute(
        pool_bwd_narrow_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxStageBytes);
    if (err != cudaSuccess) return err;
    opted = true;
  }
  return imgseg::grid_blocks(pool_bwd_narrow_kernel, p.threads, p.bytes, -1, p.blocks);
}

}  // namespace

extern "C" int imgseg_maxpool2x2_affine_relu(const void* z, const void* ab, void* p, int B,
                                             int H, int W, int C, void* stream) {
  const bool vec8 = C % 8 == 0 && reinterpret_cast<uintptr_t>(z) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(p) % 16 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return vec8 ? launch<8>(z, ab, p, B, H, W, C, s) : launch<1>(z, ab, p, B, H, W, C, s);
}

// fp32 elements of the backward's sums buffer for width W and C channels
// over krows = B*H/2 window rows: the (2, C) sums and one (2, C) row of
// partials per block; -1 if the kernel takes no such shape (C > 2048, or
// not a multiple of 8 and past 256 or past its staging) or the card cannot
// be queried.
extern "C" long long imgseg_maxpool2x2_affine_relu_bwd_floats(int W, int C, long long krows) {
  Plan p;
  if (plan_of(W, C, krows, p) != cudaSuccess) return -1;
  return 2LL * C * (1 + p.blocks);
}

// dz (B,H,W,C) and sums[0:2C] = [sum P*z, sum P] from z (B,H,W,C), a, b
// (C,) fp32 and dp (B,H/2,W/2,C); H and W even; z, dp, dz 16-byte aligned;
// sums as imgseg_maxpool2x2_affine_relu_bwd_floats(W, C, B*H/2) gives it.
extern "C" int imgseg_maxpool2x2_affine_relu_bwd(const void* z, const void* a, const void* b,
                                                 const void* dp, void* dz, void* sums, int B,
                                                 int H, int W, int C, void* stream) {
  if (B < 0 || H < 0 || H % 2) return static_cast<int>(cudaErrorInvalidValue);
  if (reinterpret_cast<uintptr_t>(z) % 16 || reinterpret_cast<uintptr_t>(dp) % 16 ||
      reinterpret_cast<uintptr_t>(dz) % 16) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  long long krows = static_cast<long long>(B) * (H / 2);
  Plan p;
  cudaError_t err = plan_of(W, C, krows, p);
  if (err != cudaSuccess) return static_cast<int>(err);
  const __nv_bfloat16* zp = static_cast<const __nv_bfloat16*>(z);
  const __nv_bfloat16* dpp = static_cast<const __nv_bfloat16*>(dp);
  __nv_bfloat16* dzp = static_cast<__nv_bfloat16*>(dz);
  const float* ap = static_cast<const float*>(a);
  const float* bp = static_cast<const float*>(b);
  float* sp = static_cast<float*>(sums);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!p.narrow) {
    const int G = C / 8;
    long long items = krows * (W / 2) * G;
    long long per_block = (items + p.blocks - 1) / p.blocks;
    per_block = (per_block + G - 1) / G * G;
    void* args[] = {&zp, &ap, &bp, &dpp, &dzp, &sp, &W, &C, &items, &per_block};
    err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(pool_bwd_kernel),
                                      dim3(p.blocks), dim3(p.threads), args, 0, s);
  } else {
    int R = p.R;
    void* args[] = {&zp, &ap, &bp, &dpp, &dzp, &sp, &W, &C, &krows, &R};
    err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(pool_bwd_narrow_kernel),
                                      dim3(p.blocks), dim3(p.threads), args, p.bytes, s);
  }
  return static_cast<int>(err);
}
