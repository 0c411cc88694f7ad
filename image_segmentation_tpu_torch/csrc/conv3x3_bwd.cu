// Weight and bias gradient of a 3x3 SAME convolution of a BatchNorm'd
// block, NHWC bf16 operands, fp32 sums:
//   dw[tap][ci][co] = sum over pixels p of act(x)[p + tap - 1][ci] * ge[p][co]
//   db[co]          = sum over pixels of ge[p][co]
// with ge the transformed cotangent (as conv3x3.cu's dgrad reads it), or
// the cotangent itself for a conv with no BatchNorm after it, and
// act(x) the conv's operand as its forward read it: [x | xb], or
// round(relu(x*a + b)); both are zero outside the image.
//
// Replaces: the wgrad half of image_segmentation_tpu/ops/pallas_conv.py
// _folded_bwd_fused_pallas (:1139; body _bwd_fused_kernel_body :1057-1109,
// `gfold` via _gfold_transform :249, `ab_pre`, `xwb`), and
// _folded_wgrad_pallas (:822), the wgrad alone: of a block input that takes
// no gradient, and of make_folded_conv3x3 (:1932) with no transform.  The TPU kernel
// merges dx and wgrad to read the cotangent once from VMEM; here they are
// two kernels (conv3x3.cu computes dx).
//
// What bounds it on the card: arithmetic.  It is a GEMM of (9*Cin) x Co
// outputs over a reduction depth of B*H*W pixels (4.2M at batch 16, 512^2):
// the same FLOPs as the forward conv, on the fp32 FMA pipes in this first
// kernel.  The reduction over pixels is the other problem: on the TPU the
// dk block stays in VMEM while the grid walks the image in order.
//
// What the design does about it: each 256-thread block owns a 9-tap x 32
// input-channel x 32 output-channel tile of dw and walks a contiguous chunk
// of 8x16 pixel tiles.  Per tile it stages the activated (8+2)x(16+2) halo
// of its 32 input channels and the transformed cotangent of its 32 output
// channels in shared memory as fp32; each thread keeps 2 input x 2 output
// channels x 9 taps = 36 fp32 accumulators and reuses every loaded input
// row across the three horizontal taps and both output channels.  Each
// block writes its tile of partial sums once; a second pass (reduce.cuh)
// adds the chunks in a fixed order.  The chunk count is chosen so that
// about four blocks per SM are in flight.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "reduce.cuh"

namespace {

constexpr int TH = 8;
constexpr int TW = 16;
constexpr int IH = TH + 2;
constexpr int IW = TW + 2;
constexpr int XS = IH * IW + 1;  // +1: the channel-major staging stores spread over banks
constexpr int TCI = 32;          // input channels per block
constexpr int TCO = 32;          // output channels per block
constexpr int THREADS = 256;     // 16 input-channel pairs x 16 output-channel pairs

struct Args {
  const __nv_bfloat16* g;   // (B,H,W,Co) cotangent
  const __nv_bfloat16* y;   // (B,H,W,Co) the conv's output
  const float* gf;          // (2|4, Co) transform rows, or null: ge = g
  const __nv_bfloat16* x;   // (B,H,W,Ca)
  const __nv_bfloat16* xb;  // (B,H,W,Cb) or null
  const float* ab;          // (2, Ca) pre-affine or null
  float* part_w;            // (chunks, 9, Cin, Co)
  float* part_b;            // (chunks, Co)
  int B, H, W, Ca, Cb, Co, tiles_x, tiles_y;
  long long tiles, per_chunk;
};

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// How the cotangent is read.
enum Ge {
  kGePlain = 0,   // g
  kGeStats = 1,   // round(g + c1 + 2*y*c2)
  kGeAffine = 2,  // round(g*a*[y*a + b > 0] + c1 + 2*y*c2)
};

template <int GE>
__device__ __forceinline__ float load_ge(const Args& p, size_t pix, int co) {
  const int C = p.Co;
  const float g = __bfloat162float(p.g[pix * C + co]);
  if constexpr (GE == kGePlain) return g;
  const float y = __bfloat162float(p.y[pix * C + co]);
  float gv = g;
  int row = 0;
  if constexpr (GE == kGeAffine) {
    const float a = p.gf[co], b = p.gf[C + co];
    gv = __fadd_rn(__fmul_rn(y, a), b) > 0.f ? __fmul_rn(g, a) : 0.f;
    row = 2;
  }
  const float c1 = p.gf[row * C + co], c2 = p.gf[(row + 1) * C + co];
  return round_bf16(__fadd_rn(__fadd_rn(gv, c1), __fmul_rn(__fmul_rn(2.f, y), c2)));
}

__device__ __forceinline__ float load_act(const Args& p, size_t pix, int ci) {
  if (ci >= p.Ca) return __bfloat162float(p.xb[pix * p.Cb + (ci - p.Ca)]);
  float v = __bfloat162float(p.x[pix * p.Ca + ci]);
  if (p.ab != nullptr) {
    const float t = __fadd_rn(__fmul_rn(v, p.ab[ci]), p.ab[p.Ca + ci]);
    v = round_bf16(fmaxf(t, 0.f));
  }
  return v;
}

template <int GE>
__global__ void __launch_bounds__(THREADS) wgrad_kernel(const Args p) {
  __shared__ float s_x[TCI * XS];
  __shared__ __align__(16) float s_g[TH * TW][TCO];

  const int cin = p.Ca + p.Cb;
  const int co_tiles = (p.Co + TCO - 1) / TCO;
  const int ci0 = (blockIdx.x / co_tiles) * TCI;
  const int co0 = (blockIdx.x % co_tiles) * TCO;
  const int tid = threadIdx.x;
  const int cp = tid / 16;  // this thread's input channels ci0 + 2cp, +1
  const int op = tid % 16;  // and output channels co0 + 2op, +1

  float acc[9][2][2];
#pragma unroll
  for (int t = 0; t < 9; ++t)
#pragma unroll
    for (int i = 0; i < 2; ++i) acc[t][i][0] = acc[t][i][1] = 0.f;
  float db0 = 0.f, db1 = 0.f;

  const long long t_begin = static_cast<long long>(blockIdx.y) * p.per_chunk;
  long long t_end = t_begin + p.per_chunk;
  if (t_end > p.tiles) t_end = p.tiles;
  for (long long t = t_begin; t < t_end; ++t) {
    const int tx = static_cast<int>(t % p.tiles_x);
    const int ty = static_cast<int>((t / p.tiles_x) % p.tiles_y);
    const int n = static_cast<int>(t / (static_cast<long long>(p.tiles_x) * p.tiles_y));
    const int x0 = tx * TW, y0 = ty * TH;

    for (int i = tid; i < IH * IW * TCI; i += THREADS) {
      const int c = i % TCI;
      const int q = i / TCI;
      const int gy = y0 + q / IW - 1, gx = x0 + q % IW - 1, gc = ci0 + c;
      float v = 0.f;  // zero outside the image, after the activation
      if (gy >= 0 && gy < p.H && gx >= 0 && gx < p.W && gc < cin) {
        v = load_act(p, (static_cast<size_t>(n) * p.H + gy) * p.W + gx, gc);
      }
      s_x[c * XS + q] = v;
    }
    for (int i = tid; i < TH * TW * TCO; i += THREADS) {
      const int c = i % TCO;
      const int q = i / TCO;
      const int gy = y0 + q / TW, gx = x0 + q % TW, gc = co0 + c;
      float v = 0.f;  // no cotangent outside the image
      if (gy < p.H && gx < p.W && gc < p.Co) {
        v = load_ge<GE>(p, (static_cast<size_t>(n) * p.H + gy) * p.W + gx, gc);
      }
      s_g[q][c] = v;
    }
    __syncthreads();

    if (cp == 0) {  // the bias gradient, once per output channel pair
      for (int q = 0; q < TH * TW; ++q) {
        db0 += s_g[q][2 * op];
        db1 += s_g[q][2 * op + 1];
      }
    }
    const float* x0p = &s_x[(2 * cp) * XS];
    const float* x1p = x0p + XS;
#pragma unroll 1
    for (int r = 0; r < TH; ++r) {
#pragma unroll
      for (int ky = 0; ky < 3; ++ky) {
        float xa[IW], xb[IW];
#pragma unroll
        for (int j = 0; j < IW; ++j) {
          xa[j] = x0p[(r + ky) * IW + j];
          xb[j] = x1p[(r + ky) * IW + j];
        }
#pragma unroll
        for (int px = 0; px < TW; ++px) {
          const float2 gv = *reinterpret_cast<const float2*>(&s_g[r * TW + px][2 * op]);
#pragma unroll
          for (int kx = 0; kx < 3; ++kx) {
            float(&a)[2][2] = acc[ky * 3 + kx];
            a[0][0] = fmaf(xa[px + kx], gv.x, a[0][0]);
            a[0][1] = fmaf(xa[px + kx], gv.y, a[0][1]);
            a[1][0] = fmaf(xb[px + kx], gv.x, a[1][0]);
            a[1][1] = fmaf(xb[px + kx], gv.y, a[1][1]);
          }
        }
      }
    }
    __syncthreads();
  }

  // this block's partial sums: every (tap, ci, co) of its tile, zeros included
  const size_t chunk = blockIdx.y;
  float* pw = p.part_w + chunk * 9 * static_cast<size_t>(cin) * p.Co;
#pragma unroll
  for (int t = 0; t < 9; ++t) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int ci = ci0 + 2 * cp + i;
      if (ci >= cin) continue;
#pragma unroll
      for (int o = 0; o < 2; ++o) {
        const int co = co0 + 2 * op + o;
        if (co < p.Co) pw[(static_cast<size_t>(t) * cin + ci) * p.Co + co] = acc[t][i][o];
      }
    }
  }
  if (ci0 == 0 && cp == 0) {
    float* pb = p.part_b + chunk * p.Co;
    if (co0 + 2 * op < p.Co) pb[co0 + 2 * op] = db0;
    if (co0 + 2 * op + 1 < p.Co) pb[co0 + 2 * op + 1] = db1;
  }
}

struct Plan {
  int tiles_x, tiles_y, combos;
  long long tiles, chunks, per_chunk;
};

Plan plan(int B, int H, int W, int Cin, int Co) {
  Plan q{};
  q.tiles_x = (W + TW - 1) / TW;
  q.tiles_y = (H + TH - 1) / TH;
  q.tiles = static_cast<long long>(B) * q.tiles_x * q.tiles_y;
  q.combos = ((Cin + TCI - 1) / TCI) * ((Co + TCO - 1) / TCO);
  q.chunks = imgseg::chunks_for(q.tiles, q.combos);
  q.per_chunk = (q.tiles + q.chunks - 1) / q.chunks;
  return q;
}

}  // namespace

// Floats of scratch: a (9, Cin, Co) and a (Co) row per chunk.
extern "C" long long imgseg_conv3x3_wgrad_scratch(int B, int H, int W, int Cin, int Co) {
  const Plan q = plan(B, H, W, Cin, Co);
  return q.chunks * (9LL * Cin * Co + Co);
}

// dw (9, Ca+Cb, Co) and db (Co), fp32.  g, y (B,H,W,Co); gf (2|4, Co) rows
// of the cotangent transform, `affine` selecting the 4-row form, or no gf
// (and no y): the cotangent g itself; x
// (B,H,W,Ca) with xb (B,H,W,Cb) or the pre-affine ab (2, Ca).
extern "C" int imgseg_conv3x3_wgrad(const void* g, const void* y, const void* gf, const void* x,
                                    const void* xb, const void* ab, void* dw, void* db,
                                    void* scratch, int B, int H, int W, int Ca, int Cb, int Co,
                                    int affine, void* stream) {
  const int cin = Ca + Cb;
  if (B <= 0 || H <= 0 || W <= 0 || Co <= 0 || cin <= 0) return static_cast<int>(cudaSuccess);
  const Plan q = plan(B, H, W, cin, Co);
  if (q.chunks > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
  Args p{};
  p.g = static_cast<const __nv_bfloat16*>(g);
  p.y = static_cast<const __nv_bfloat16*>(y);
  p.gf = static_cast<const float*>(gf);
  p.x = static_cast<const __nv_bfloat16*>(x);
  p.xb = static_cast<const __nv_bfloat16*>(xb);
  p.ab = static_cast<const float*>(ab);
  p.part_w = static_cast<float*>(scratch);
  p.part_b = p.part_w + q.chunks * 9LL * cin * Co;
  p.B = B, p.H = H, p.W = W, p.Ca = Ca, p.Cb = Cb, p.Co = Co;
  p.tiles_x = q.tiles_x, p.tiles_y = q.tiles_y, p.tiles = q.tiles, p.per_chunk = q.per_chunk;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(q.combos, static_cast<unsigned>(q.chunks));
  if (gf == nullptr) {
    wgrad_kernel<kGePlain><<<grid, THREADS, 0, s>>>(p);
  } else if (affine) {
    wgrad_kernel<kGeAffine><<<grid, THREADS, 0, s>>>(p);
  } else {
    wgrad_kernel<kGeStats><<<grid, THREADS, 0, s>>>(p);
  }
  cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess) {
    err = imgseg::sum_rows(p.part_w, static_cast<float*>(dw), q.chunks, 9LL * cin * Co, s);
  }
  if (err == cudaSuccess) err = imgseg::sum_rows(p.part_b, static_cast<float*>(db), q.chunks, Co, s);
  return static_cast<int>(err);
}
