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
// What bounds it on the card: the tensor cores.  At the LargeUNet's
// level-0/1 shapes (batch 16, 32..128 channels at 512^2 and 256^2) a conv
// does 2*9*Cin*Co FLOPs per output pixel against ~2*(Cin+Co) bytes moved,
// far above the H100's ~295 FLOP/byte ridge.  The operands are bf16 (every
// on-load transform ends in a bf16 rounding), so a bf16 x bf16 product is
// exact in fp32 and the tensor cores compute the same sums as fp32 FMAs, in
// another order.
//
// What the design does about it: an implicit GEMM on mma.sync m16n8k16
// (bf16 in, fp32 sums).  A 256-thread block owns an 8x16-pixel by TCO
// (32 or 64) output-channel tile: M = 128 pixels, N = TCO, K = 9 taps x Cin
// in 16-wide slices.  Per stage of 32 input channels it holds the
// (8+2)x(16+2) halo of the operand and the 3x3x32xTCO weights in shared
// memory as bf16, rows padded by 16 bytes so that every ldmatrix is free of
// bank conflicts.  All 9 taps read the one halo: a tap is the halo shifted
// by (ky, kx), which is only another row pointer per lane for ldmatrix.
// Each warp owns 2 output rows (2 m16 tiles) by TCO/2 channels and keeps
// its sums in registers in the mma fragment layout.  The stages are
// double-buffered: the weights, and the operand where it needs no
// transform (x without the affine, the raw cotangent), arrive by cp.async
// (16 bytes, zero-filled outside the image); a transformed operand (the
// affine + ReLU, the cotangent transform) is read 16 bytes a thread into
// registers before the stage's mma, transformed and stored after, so both
// loads overlap the tensor cores.  Channel counts that are not a multiple of
// 8 (the 1-channel heatmap, odd test shapes) take a path of the same kernel
// that loads element by element and pads K and N with zeros.  The zero
// border (after the transform, as in JAX) is the zero fill.  The epilogues
// run on the fragments: the bias, the bf16 rounding, the statistics of the
// ROUNDED output or the ReLU adjoint with its sums, the split of dx; sums
// go over each lane's pixels, then warp shuffles, then the four row warps in
// order through shared memory, and each block writes one row of partial
// sums that a second pass (reduce.cuh) adds in a fixed order.  No atomics.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "mma.cuh"
#include "reduce.cuh"

namespace {

using imgseg::cp_async16;
using imgseg::ldsm_x4;
using imgseg::ldsm_x4_trans;
using imgseg::mma_bf16;

constexpr int TH = 8;     // output rows per block
constexpr int TW = 16;    // output columns per block: one m16 tile per row
constexpr int IH = TH + 2;
constexpr int IW = TW + 2;
constexpr int HALO = IH * IW;
constexpr int CK = 32;        // input channels per stage: two k16 slices
constexpr int AS = CK + 8;    // halo row stride (bf16): 80 bytes
constexpr int AV = (HALO * CK / 8 + 255) / 256;  // 16-byte halo vectors per thread
constexpr int THREADS = 256;  // 8 warps: 4 along the rows x 2 along the channels

template <int TCO>
struct Tiles {
  static constexpr int WS = TCO + 8;  // weight row stride (bf16)
  static constexpr int A = HALO * AS;
  static constexpr int W = 9 * CK * WS;
  static constexpr int STAGE = A + W;
  static constexpr size_t BYTES = 2 * STAGE * sizeof(__nv_bfloat16);
};

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
  int avec;  // the operand in 16-byte vectors (channel counts multiples of 8, aligned)
  int wvec;  // the weights in 16-byte vectors (Co a multiple of 8)
  int pair;  // outputs stored two channels at a time (Co and Na even)
};

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// The staged operand at pixel `pix`, input channel `gc` (in the image), one
// element: the path for channel counts that are not a multiple of 8.  mul
// and add are rounded separately, as the plain PyTorch version does, so
// ReLU masks agree bit for bit.
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

// Two bf16 outputs at channels c, c+1 of row `base` (c+1 only if `has1`).
__device__ __forceinline__ void put2(__nv_bfloat16* base, int c, __nv_bfloat16 r0, __nv_bfloat16 r1,
                                     bool has1, bool pair) {
  if (has1 && pair) {
    *reinterpret_cast<__nv_bfloat162*>(base + c) = __halves2bfloat162(r0, r1);
  } else {
    base[c] = r0;
    if (has1) base[c + 1] = r1;
  }
}

// The epilogue of output channels gco, gco+1 (gco < Co) at pixel `pix`.
template <int EPI>
__device__ __forceinline__ void emit(const Args& p, size_t pix, int gco, const float (&v)[2],
                                     float (&s1)[2], float (&s2)[2]) {
  const int Co = p.Co;
  const bool has1 = gco + 1 < Co;
  const bool pair = p.pair != 0;
  if constexpr (EPI == kEpiStore || EPI == kEpiStats) {
    const __nv_bfloat16 r0 = __float2bfloat16(v[0]), r1 = __float2bfloat16(v[1]);
    put2(p.out + pix * Co, gco, r0, r1, has1, pair);
    if constexpr (EPI == kEpiStats) {  // statistics of the ROUNDED output
      const float f0 = __bfloat162float(r0), f1 = __bfloat162float(r1);
      s1[0] += f0;
      s2[0] += __fmul_rn(f0, f0);
      if (has1) {
        s1[1] += f1;
        s2[1] += __fmul_rn(f1, f1);
      }
    }
  } else if constexpr (EPI == kEpiPost) {
    __nv_bfloat16 r[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      if (e == 1 && !has1) {
        r[1] = r[0];
        break;
      }
      const int c = gco + e;
      const float xv = __bfloat162float(p.xpost[pix * Co + c]);
      const float a = p.abpost[c];
      const float gu = __fadd_rn(__fmul_rn(xv, a), p.abpost[Co + c]) > 0.f ? v[e] : 0.f;
      r[e] = __float2bfloat16(__fmul_rn(gu, a));
      s1[e] += __fmul_rn(gu, xv);
      s2[e] += gu;
    }
    put2(p.out + pix * Co, gco, r[0], r[1], has1, pair);
  } else {
    const __nv_bfloat16 r0 = __float2bfloat16(v[0]), r1 = __float2bfloat16(v[1]);
    const int Na = p.Na, Nb = Co - Na;
    if (pair && has1) {  // Na is even: both channels on one side
      if (gco < Na) {
        put2(p.out + pix * Na, gco, r0, r1, true, true);
      } else {
        put2(p.out_b + pix * Nb, gco - Na, r0, r1, true, true);
      }
    } else {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = gco + e;
        if (c >= Co) break;
        const __nv_bfloat16 r = e ? r1 : r0;
        if (c < Na) {
          p.out[pix * Na + c] = r;
        } else {
          p.out_b[pix * Nb + (c - Na)] = r;
        }
      }
    }
  }
}

template <int LOAD, int EPI, int TCO>
__global__ void __launch_bounds__(THREADS, 2) conv3x3_kernel(const Args p) {
  using T = Tiles<TCO>;
  constexpr int NT = TCO / 16;  // n8 tiles per warp: each warp has TCO/2 channels
  constexpr bool kGe = LOAD == kLoadGeStats || LOAD == kLoadGeAffine;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* smem = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __shared__ float red[2][4][TCO];

  const int H = p.H, W = p.W, Co = p.Co;
  const int cin = p.Ca + p.Cb;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp & 3;   // output rows 2wm, 2wm+1
  const int wn = warp >> 2;  // output channels wn*TCO/2 ..
  const int x0 = blockIdx.x * TW;
  const int y0 = blockIdx.y * TH;
  const int n = blockIdx.z / p.co_tiles;
  const int co0 = (blockIdx.z % p.co_tiles) * TCO;
  const size_t img = static_cast<size_t>(n) * H;
  // the operand goes shared <- global by cp.async; else through registers
  const bool direct = LOAD == kLoadG || (LOAD == kLoadX && p.ab == nullptr);
  const bool regs = p.avec && !direct;

  uint4 pg[AV] = {}, py[AV] = {};  // a transformed operand's next stage, in flight

  // Where 16-byte halo vector i (pixel q, channels gc..gc+7) comes from.
  auto halo_vec = [&](int i, int c0, int& q, int& gc, size_t& pix) {
    q = i >> 2;
    gc = c0 + 8 * (i & 3);
    const int gy = y0 + q / IW - 1, gx = x0 + q % IW - 1;
    const bool ok = gy >= 0 && gy < H && gx >= 0 && gx < W && gc < cin;
    pix = ok ? (img + gy) * W + gx : 0;
    return ok;
  };

  // Start stage `c0` into buffer `buf`: the weights and a direct operand by
  // cp.async, a transformed one into registers, the element path at once.
  auto begin_stage = [&](int c0, int buf) {
    __nv_bfloat16* sA = smem + buf * T::STAGE;
    __nv_bfloat16* sW = sA + T::A;
    if (p.wvec) {
      constexpr int WV = TCO / 8;
      for (int i = tid; i < 9 * CK * WV; i += THREADS) {
        const int v = i % WV, c = (i / WV) % CK, tap = i / (WV * CK);
        const int gc = c0 + c, gco = co0 + 8 * v;
        const bool ok = gc < cin && gco < Co;
        const __nv_bfloat16* src =
            ok ? p.w + (static_cast<size_t>(tap) * cin + gc) * Co + gco : p.w;
        cp_async16(sW + (tap * CK + c) * T::WS + 8 * v, src, ok);
      }
    } else {
      for (int i = tid; i < 9 * CK * TCO; i += THREADS) {
        const int co = i % TCO, c = (i / TCO) % CK, tap = i / (TCO * CK);
        const int gc = c0 + c, gco = co0 + co;
        sW[(tap * CK + c) * T::WS + co] =
            (gc < cin && gco < Co) ? p.w[(static_cast<size_t>(tap) * cin + gc) * Co + gco]
                                   : __float2bfloat16(0.f);
      }
    }
    if (!p.avec) {
      for (int i = tid; i < HALO * CK; i += THREADS) {
        const int c = i % CK, q = i / CK;
        const int gy = y0 + q / IW - 1, gx = x0 + q % IW - 1, gc = c0 + c;
        float v = 0.f;  // SAME padding: zero AFTER the operand's transform
        if (gy >= 0 && gy < H && gx >= 0 && gx < W && gc < cin) {
          v = load_operand<LOAD>(p, (img + gy) * W + gx, gc);
        }
        sA[q * AS + c] = __float2bfloat16(v);
      }
      return;
    }
#pragma unroll
    for (int j = 0; j < AV; ++j) {
      const int i = tid + j * THREADS;
      if (i >= HALO * CK / 8) break;
      int q, gc;
      size_t pix;
      const bool ok = halo_vec(i, c0, q, gc, pix);
      const __nv_bfloat16* src = p.x;
      if (ok) {
        src = (LOAD == kLoadX && gc >= p.Ca) ? p.xb + pix * p.Cb + (gc - p.Ca)
                                             : p.x + pix * p.Ca + gc;
      }
      if (direct) {
        cp_async16(sA + q * AS + (i & 3) * 8, src, ok);
      } else if (ok) {
        pg[j] = *reinterpret_cast<const uint4*>(src);
        if constexpr (kGe) py[j] = *reinterpret_cast<const uint4*>(p.xb + pix * p.Ca + gc);
      }
    }
  };

  // Finish a transformed operand's stage: transform and store the registers.
  auto finish_stage = [&](int c0, int buf) {
    __nv_bfloat16* sA = smem + buf * T::STAGE;
#pragma unroll
    for (int j = 0; j < AV; ++j) {
      const int i = tid + j * THREADS;
      if (i >= HALO * CK / 8) break;
      int q, gc;
      size_t pix;
      const bool ok = halo_vec(i, c0, q, gc, pix);
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (ok) {
        if constexpr (LOAD == kLoadX) {
          val = gc < p.Ca ? imgseg::affine_relu8(p.ab, p.Ca, gc, pg[j]) : pg[j];
        } else {
          val = imgseg::cotangent8<LOAD == kLoadGeAffine>(p.ab, p.Ca, gc, pg[j], py[j]);
        }
      }
      *reinterpret_cast<uint4*>(sA + q * AS + (i & 3) * 8) = val;
    }
  };

  float acc[2][NT][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < NT; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

  // this lane's ldmatrix rows: A (pixels, 8-channel half), B (k row, 8-channel half)
  const int a_pix = (lane & 7) + ((lane >> 3) & 1) * 8, a_k = (lane >> 4) * 8;
  const int b_k = (lane & 7) + ((lane >> 3) & 1) * 8, b_n = wn * (TCO / 2) + (lane >> 4) * 8;

  const int nk = (cin + CK - 1) / CK;
  begin_stage(0, 0);
  if (regs) finish_stage(0, 0);
  imgseg::cp_async_commit();
  imgseg::cp_async_wait_all();
  __syncthreads();
  for (int k = 0; k < nk; ++k) {
    const int buf = k & 1, c0 = k * CK;
    const bool next = k + 1 < nk;
    if (next) {
      begin_stage(c0 + CK, buf ^ 1);
      imgseg::cp_async_commit();
    }
    const __nv_bfloat16* sA = smem + buf * T::STAGE;
    const __nv_bfloat16* sW = sA + T::A;
#pragma unroll
    for (int kk = 0; kk < CK / 16; ++kk) {
      if (c0 + kk * 16 >= cin) break;  // K past the channels: zeros
#pragma unroll
      for (int ky = 0; ky < 3; ++ky) {
#pragma unroll
        for (int kx = 0; kx < 3; ++kx) {
          const int tap = ky * 3 + kx;
          uint32_t b[NT][2];
#pragma unroll
          for (int pr = 0; pr < NT / 2; ++pr) {
            uint32_t r[4];
            ldsm_x4_trans(r, sW + (tap * CK + kk * 16 + b_k) * T::WS + b_n + pr * 16);
            b[2 * pr][0] = r[0], b[2 * pr][1] = r[1];
            b[2 * pr + 1][0] = r[2], b[2 * pr + 1][1] = r[3];
          }
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) {
            uint32_t a[4];
            ldsm_x4(a, sA + ((wm * 2 + mi + ky) * IW + a_pix + kx) * AS + kk * 16 + a_k);
#pragma unroll
            for (int ni = 0; ni < NT; ++ni) mma_bf16(acc[mi][ni], a, b[ni][0], b[ni][1]);
          }
        }
      }
    }
    if (next && regs) finish_stage(c0 + CK, buf ^ 1);
    imgseg::cp_async_wait_all();
    __syncthreads();
  }

  // ---- epilogue on the fragments: lane holds pixels lane/4 (+8) of rows
  // 2wm, 2wm+1 and channels 2(lane%4) (+1) of each n8 tile
  float s1[NT][2], s2[NT][2], bias[NT][2];
#pragma unroll
  for (int ni = 0; ni < NT; ++ni)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int gco = co0 + wn * (TCO / 2) + ni * 8 + 2 * (lane & 3) + e;
      s1[ni][e] = s2[ni][e] = 0.f;
      bias[ni][e] = (p.bias != nullptr && gco < Co) ? p.bias[gco] : 0.f;
    }
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
    const int gy = y0 + wm * 2 + mi;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gx = x0 + (lane >> 2) + 8 * h;
      if (gy >= H || gx >= W) continue;
      const size_t pix = (img + gy) * W + gx;
#pragma unroll
      for (int ni = 0; ni < NT; ++ni) {
        const int gco = co0 + wn * (TCO / 2) + ni * 8 + 2 * (lane & 3);
        if (gco >= Co) continue;
        const float v[2] = {acc[mi][ni][2 * h] + bias[ni][0], acc[mi][ni][2 * h + 1] + bias[ni][1]};
        emit<EPI>(p, pix, gco, v, s1[ni], s2[ni]);
      }
    }
  }
  if constexpr (EPI == kEpiStats || EPI == kEpiPost) {
    // the 8 lanes of one channel pair: butterfly sums; then the 4 row warps in order
#pragma unroll
    for (int ni = 0; ni < NT; ++ni)
#pragma unroll
      for (int e = 0; e < 2; ++e)
#pragma unroll
        for (int off = 4; off < 32; off <<= 1) {
          s1[ni][e] += __shfl_xor_sync(0xffffffffu, s1[ni][e], off);
          s2[ni][e] += __shfl_xor_sync(0xffffffffu, s2[ni][e], off);
        }
    if (lane < 4) {
#pragma unroll
      for (int ni = 0; ni < NT; ++ni)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int ch = wn * (TCO / 2) + ni * 8 + 2 * lane + e;
          red[0][wm][ch] = s1[ni][e];
          red[1][wm][ch] = s2[ni][e];
        }
    }
    __syncthreads();
    if (tid < TCO && co0 + tid < Co) {
      const size_t blk = (static_cast<size_t>(n) * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
      float a = red[0][0][tid], q = red[1][0][tid];
#pragma unroll
      for (int r = 1; r < 4; ++r) {
        a += red[0][r][tid];
        q += red[1][r][tid];
      }
      p.partial[(blk * 2) * Co + co0 + tid] = a;
      p.partial[(blk * 2 + 1) * Co + co0 + tid] = q;
    }
  }
}

int tco_of(int Co) { return Co > 32 ? 64 : 32; }

long long blocks_per_channel(int B, int H, int W) {
  return static_cast<long long>(B) * ((H + TH - 1) / TH) * ((W + TW - 1) / TW);
}

template <int LOAD, int EPI, int TCO>
int launch_tiles(const Args& p, int B, cudaStream_t stream) {
  static bool opted = false;
  auto* kernel = conv3x3_kernel<LOAD, EPI, TCO>;
  cudaError_t err = imgseg::allow_smem(kernel, Tiles<TCO>::BYTES, opted);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((p.W + TW - 1) / TW, (p.H + TH - 1) / TH, B * p.co_tiles);
  if (grid.y > 65535 || grid.z > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
  kernel<<<grid, THREADS, Tiles<TCO>::BYTES, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int LOAD, int EPI>
int launch(Args p, int B, cudaStream_t stream) {
  const int tco = tco_of(p.Co);
  p.co_tiles = (p.Co + tco - 1) / tco;
  return tco == 64 ? launch_tiles<LOAD, EPI, 64>(p, B, stream)
                   : launch_tiles<LOAD, EPI, 32>(p, B, stream);
}

bool aligned16(const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16 == 0; }

// The vector paths' conditions, from the channel counts and the pointers.
void set_paths(Args& p) {
  p.avec = p.Ca % 8 == 0 && p.Cb % 8 == 0 && aligned16(p.x) && aligned16(p.xb) && aligned16(p.ab);
  p.wvec = p.Co % 8 == 0 && aligned16(p.w);
  p.pair = p.Co % 2 == 0 && p.Na % 2 == 0;
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
  if (ab != nullptr && Cb != 0) return static_cast<int>(cudaErrorInvalidValue);
  Args p{};
  p.x = static_cast<const __nv_bfloat16*>(x);
  p.xb = static_cast<const __nv_bfloat16*>(xb);
  p.ab = static_cast<const float*>(ab);
  p.w = static_cast<const __nv_bfloat16*>(w);
  p.bias = static_cast<const float*>(bias);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.partial = static_cast<float*>(scratch);
  p.H = H, p.W = W, p.Ca = Ca, p.Cb = Cb, p.Co = Co, p.Na = Co;
  set_paths(p);
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
  set_paths(p);
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
