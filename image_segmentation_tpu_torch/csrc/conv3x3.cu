// 3x3 SAME convolution, NHWC bf16, fp32 sums, in the forms the LargeUNet's
// BatchNorm'd blocks need: the forward (with the decoder's two-input concat
// and the previous BatchNorm's affine + ReLU applied on load, optionally
// with the batch statistics of its output) and the input gradient (with the
// BatchNorm backward applied to the cotangent on load).
//
// Replaces: image_segmentation_tpu/ops/pallas_conv.py _folded_conv_pallas
// (:568; kernel body _conv_kernel_body :423, slab _build_aug :275) with
// `pre`, `lanes_b` and `stats` (:557-565), and the dx half of
// _folded_bwd_fused_pallas (:1139; body :938-1055) with `gfold`
// (_gfold_transform :249), `post` and `split_out`; in their plain forms
// (no affine, no statistics, the raw cotangent) they are the forward and
// the dx of make_folded_conv3x3 (:1932, :1978 and :2005), the conv of a
// block with no BatchNorm fused in.  The TPU kernels work on a
// width-folded tensor; at fold 1 that is this plain NHWC conv.  The dx of
// a conv is a conv of the cotangent with the flipped, transposed kernel,
// which the wrapper passes in the forward's weight layout.
//
// What bounds it on the card: arithmetic.  At the LargeUNet's level-0/1
// shapes (batch 16, 32..128 channels at 512^2 and 256^2) a conv does
// 2*9*Cin*Co FLOPs per output pixel against ~2*(Cin+Co) bytes moved, far
// above the H100's ~295 FLOP/byte ridge, so it is compute bound; this first
// kernel runs on the fp32 FMA pipes, not the tensor cores.
//
// What the design does about it: each 256-thread block computes an 8x16
// pixel by 32 output-channel tile.  It stages 16 input channels at a time
// of the (TH+2)x(TW+2) halo tile and the matching 3x3x16x32 weights in
// shared memory as fp32, so every staged value feeds 32 (input) or 128
// (weight) FMAs from shared memory; each thread keeps a 4-pixel by
// 4-channel fp32 accumulator in registers and reuses each loaded input row
// across the three horizontal taps.  Whatever the operand needs before the
// conv -- the activation, the concat, the cotangent transform -- and the
// zero border (after it, as in JAX) are done while staging, so none of them
// exists in device memory.  The epilogues that need sums over the whole
// batch (the statistics, the `post` adjoint's affine cotangent) reduce
// their tile in registers and warp shuffles and write one row of partial
// sums per block; a second pass (reduce.cuh) adds the rows in a fixed
// order.  Tensor cores (mma.sync / wgmma), TMA and pipelining are left for
// later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "reduce.cuh"

namespace {

constexpr int TH = 8;    // output rows per block
constexpr int TW = 16;   // output columns per block
constexpr int TCO = 32;  // output channels per block
constexpr int CK = 16;   // input channels staged per step
constexpr int IH = TH + 2;
constexpr int IW = TW + 2;
constexpr int THREADS = 256;

// How the staged operand is read.
enum Load {
  kLoadX = 0,         // [x | xb], or round(relu(x*a + b)) with `ab`
  kLoadGeStats = 1,   // round(g + c1 + 2*y*c2)
  kLoadGeAffine = 2,  // round(g*a*[y*a + b > 0] + c1 + 2*y*c2)
  kLoadG = 3,         // g itself: a conv with no BatchNorm after it
};

// What the epilogue writes.
enum Epi {
  kEpiStore = 0,  // out = round(acc + bias)
  kEpiStats = 1,  // and partial sums of round(.) and round(.)^2
  kEpiPost = 2,   // gu = acc*[xpost*a + b > 0]; out = round(gu*a), partial sums of gu*xpost, gu
  kEpiSplit = 3,  // out = round(acc) split into channels [0, Na) and [Na, Co)
};

struct Args {
  const __nv_bfloat16* x;   // kLoadX: (B,H,W,Ca); else the cotangent g (B,H,W,Ca)
  const __nv_bfloat16* xb;  // kLoadX: (B,H,W,Cb) or null; else the forward output y
  const float* ab;          // kLoadX: (2,Ca) or null; else (2|4, Ca) transform rows
  const __nv_bfloat16* w;   // (3, 3, Ca+Cb, Co)
  const float* bias;        // (Co) or null
  const __nv_bfloat16* xpost;  // kEpiPost: (B,H,W,Co)
  const float* abpost;         // kEpiPost: (2, Co)
  __nv_bfloat16* out;          // (B,H,W,Co), or (B,H,W,Na) with kEpiSplit
  __nv_bfloat16* out_b;        // kEpiSplit: (B,H,W,Co-Na)
  float* partial;              // kEpiStats/kEpiPost: (blocks, 2, Co)
  int H, W, Ca, Cb, Co, Na, co_tiles;
};

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// The staged operand at pixel `pix`, input channel `gc` (in the image).
// mul and add are rounded separately, as the plain PyTorch version does,
// so ReLU masks agree bit for bit.
template <int LOAD>
__device__ __forceinline__ float load_operand(const Args& p, size_t pix, int gc) {
  if constexpr (LOAD == kLoadX) {
    if (gc >= p.Ca) return __bfloat162float(p.xb[pix * p.Cb + (gc - p.Ca)]);
    float v = __bfloat162float(p.x[pix * p.Ca + gc]);
    if (p.ab != nullptr) {
      const float t = __fadd_rn(__fmul_rn(v, p.ab[gc]), p.ab[p.Ca + gc]);
      v = round_bf16(fmaxf(t, 0.f));
    }
    return v;
  } else if constexpr (LOAD == kLoadG) {
    return __bfloat162float(p.x[pix * p.Ca + gc]);
  } else {
    const int C = p.Ca;
    const float g = __bfloat162float(p.x[pix * C + gc]);
    const float y = __bfloat162float(p.xb[pix * C + gc]);
    float gv = g;
    int row = 0;
    if constexpr (LOAD == kLoadGeAffine) {
      const float a = p.ab[gc], b = p.ab[C + gc];
      gv = __fadd_rn(__fmul_rn(y, a), b) > 0.f ? __fmul_rn(g, a) : 0.f;
      row = 2;
    }
    const float c1 = p.ab[row * C + gc], c2 = p.ab[(row + 1) * C + gc];
    return round_bf16(__fadd_rn(__fadd_rn(gv, c1), __fmul_rn(__fmul_rn(2.f, y), c2)));
  }
}

template <int LOAD, int EPI>
__global__ void __launch_bounds__(THREADS) conv3x3_kernel(const Args p) {
  __shared__ float s_in[CK][IH * IW];
  __shared__ __align__(16) float s_w[9][CK][TCO];

  const int H = p.H, W = p.W, Co = p.Co;
  const int cin = p.Ca + p.Cb;
  const int tid = threadIdx.x;
  const int x0 = blockIdx.x * TW;
  const int y0 = blockIdx.y * TH;
  const int n = blockIdx.z / p.co_tiles;
  const int co0 = (blockIdx.z % p.co_tiles) * TCO;

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
      const int q = i / CK;
      const int gy = y0 + q / IW - 1;
      const int gx = x0 + q % IW - 1;
      const int gc = c0 + c;
      float v = 0.f;  // SAME padding: zero AFTER the operand's transform
      if (gy >= 0 && gy < H && gx >= 0 && gx < W && gc < cin) {
        v = load_operand<LOAD>(p, (static_cast<size_t>(n) * H + gy) * W + gx, gc);
      }
      s_in[c][q] = v;
    }
    for (int i = tid; i < 9 * CK * TCO; i += THREADS) {
      const int co = i % TCO;
      const int c = (i / TCO) % CK;
      const int tap = i / (TCO * CK);
      const int gc = c0 + c;
      const int gco = co0 + co;
      s_w[tap][c][co] =
          (gc < cin && gco < Co)
              ? __bfloat162float(p.w[(static_cast<size_t>(tap) * cin + gc) * Co + gco])
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

  // ---- epilogue: every thread runs it (the sums end in warp shuffles)
  const int gy = y0 + row;
  float s1[4] = {0.f, 0.f, 0.f, 0.f}, s2[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int gx = x0 + col + j;
    if (gy >= H || gx >= W) continue;
    const size_t pix = (static_cast<size_t>(n) * H + gy) * W + gx;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int gco = co0 + co_t + k;
      if (gco >= Co) continue;
      const float v = acc[j][k] + (p.bias != nullptr ? p.bias[gco] : 0.f);
      if constexpr (EPI == kEpiStore) {
        p.out[pix * Co + gco] = __float2bfloat16(v);
      } else if constexpr (EPI == kEpiStats) {
        const __nv_bfloat16 r = __float2bfloat16(v);
        p.out[pix * Co + gco] = r;
        const float rf = __bfloat162float(r);  // statistics of the ROUNDED output
        s1[k] += rf;
        s2[k] += __fmul_rn(rf, rf);
      } else if constexpr (EPI == kEpiPost) {
        const float xv = __bfloat162float(p.xpost[pix * Co + gco]);
        const float a = p.abpost[gco];
        const float gu = __fadd_rn(__fmul_rn(xv, a), p.abpost[Co + gco]) > 0.f ? v : 0.f;
        p.out[pix * Co + gco] = __float2bfloat16(__fmul_rn(gu, a));
        s1[k] += __fmul_rn(gu, xv);
        s2[k] += gu;
      } else {
        if (gco < p.Na) {
          p.out[pix * p.Na + gco] = __float2bfloat16(v);
        } else {
          p.out_b[pix * (Co - p.Na) + (gco - p.Na)] = __float2bfloat16(v);
        }
      }
    }
  }
  if constexpr (EPI == kEpiStats || EPI == kEpiPost) {
    // all 32 lanes of a warp hold the same 4 channels: butterfly sums
#pragma unroll
    for (int k = 0; k < 4; ++k) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        s1[k] += __shfl_xor_sync(0xffffffffu, s1[k], off);
        s2[k] += __shfl_xor_sync(0xffffffffu, s2[k], off);
      }
    }
    if (pg == 0) {
      const size_t blk = (static_cast<size_t>(n) * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int gco = co0 + co_t + k;
        if (gco < Co) {
          p.partial[(blk * 2) * Co + gco] = s1[k];
          p.partial[(blk * 2 + 1) * Co + gco] = s2[k];
        }
      }
    }
  }
}

dim3 grid_of(int B, int H, int W, int Co) {
  const int co_tiles = (Co + TCO - 1) / TCO;
  return dim3((W + TW - 1) / TW, (H + TH - 1) / TH, B * co_tiles);
}

long long blocks_per_channel(int B, int H, int W) {
  return static_cast<long long>(B) * ((H + TH - 1) / TH) * ((W + TW - 1) / TW);
}

template <int LOAD, int EPI>
int launch(const Args& p, int B, cudaStream_t stream) {
  const dim3 grid = grid_of(B, p.H, p.W, p.Co);
  if (grid.y > 65535 || grid.z > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
  conv3x3_kernel<LOAD, EPI><<<grid, THREADS, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// The second pass of the sum epilogues: (blocks, 2, Co) rows -> (2, Co).
int finish_sums(const Args& p, int B, float* sums, cudaStream_t stream) {
  return static_cast<int>(
      imgseg::sum_rows(p.partial, sums, blocks_per_channel(B, p.H, p.W), 2LL * p.Co, stream));
}

}  // namespace

// Floats of scratch the sum epilogues need: one (2, Co) row per pixel block.
extern "C" long long imgseg_conv3x3_scratch(int B, int H, int W, int Co) {
  return blocks_per_channel(B, H, W) * 2LL * Co;
}

// y = conv(act([x | xb])) + bias; with `stats` (2, Co) also the sums of y
// and y*y over (B, H, W), using `scratch`.
extern "C" int imgseg_conv3x3(const void* x, const void* xb, const void* w,
                              const void* bias, const void* ab, void* out, void* stats,
                              void* scratch, int B, int H, int W, int Ca, int Cb, int Co,
                              void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || Co <= 0) return static_cast<int>(cudaSuccess);
  Args p{};
  p.x = static_cast<const __nv_bfloat16*>(x);
  p.xb = static_cast<const __nv_bfloat16*>(xb);
  p.ab = static_cast<const float*>(ab);
  p.w = static_cast<const __nv_bfloat16*>(w);
  p.bias = static_cast<const float*>(bias);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.partial = static_cast<float*>(scratch);
  p.H = H, p.W = W, p.Ca = Ca, p.Cb = Cb, p.Co = Co, p.Na = Co;
  p.co_tiles = (Co + TCO - 1) / TCO;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (stats == nullptr) return launch<kLoadX, kEpiStore>(p, B, s);
  const int err = launch<kLoadX, kEpiStats>(p, B, s);
  return err != 0 ? err : finish_sums(p, B, static_cast<float*>(stats), s);
}

// dx = conv(ge, w) of the transformed cotangent ge (from g, y and the
// (2|4, Cg) rows `gf`; `affine` selects the 4-row form), or without `gf`
// of g itself (y unread; neither `xpost` nor `out_b`).  With `xpost`: the
// post adjoint, `sums` (2, Co) = [sum gu*xpost, sum gu]; with `out_b`: dx
// split at channel Na.
extern "C" int imgseg_conv3x3_dgrad(const void* g, const void* y, const void* gf,
                                    const void* w, const void* xpost, const void* abpost,
                                    void* out, void* out_b, void* sums, void* scratch, int B,
                                    int H, int W, int Cg, int Co, int Na, int affine,
                                    void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || Co <= 0) return static_cast<int>(cudaSuccess);
  Args p{};
  p.x = static_cast<const __nv_bfloat16*>(g);
  p.xb = static_cast<const __nv_bfloat16*>(y);
  p.ab = static_cast<const float*>(gf);
  p.w = static_cast<const __nv_bfloat16*>(w);
  p.xpost = static_cast<const __nv_bfloat16*>(xpost);
  p.abpost = static_cast<const float*>(abpost);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.out_b = static_cast<__nv_bfloat16*>(out_b);
  p.partial = static_cast<float*>(scratch);
  p.H = H, p.W = W, p.Ca = Cg, p.Cb = 0, p.Co = Co, p.Na = Na;
  p.co_tiles = (Co + TCO - 1) / TCO;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (gf == nullptr) {
    if (xpost != nullptr || out_b != nullptr) return static_cast<int>(cudaErrorInvalidValue);
    return launch<kLoadG, kEpiStore>(p, B, s);
  }
  int err;
  if (xpost != nullptr) {
    err = affine ? launch<kLoadGeAffine, kEpiPost>(p, B, s) : launch<kLoadGeStats, kEpiPost>(p, B, s);
    return err != 0 ? err : finish_sums(p, B, static_cast<float*>(sums), s);
  }
  if (out_b != nullptr) {
    return affine ? launch<kLoadGeAffine, kEpiSplit>(p, B, s) : launch<kLoadGeStats, kEpiSplit>(p, B, s);
  }
  return affine ? launch<kLoadGeAffine, kEpiStore>(p, B, s) : launch<kLoadGeStats, kEpiStore>(p, B, s);
}

extern "C" const char* imgseg_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
