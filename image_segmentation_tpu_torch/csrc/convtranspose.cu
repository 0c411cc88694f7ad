// ConvTranspose2d(kernel 2, stride 2), NHWC bf16, fp32 sums, and its
// backward:
//   y[b, 2i+dy, 2j+dx, o] = bias[o] + sum_c x[b, i, j, c] * w[c, dy, dx, o]
//   dx[b, i, j, c] = sum_{dy, dx, o} g[b, 2i+dy, 2j+dx, o] * w[c, dy, dx, o]
//   dw[c, dy, dx, o] = sum_{b, i, j} x[b, i, j, c] * g[b, 2i+dy, 2j+dx, o]
//   db[dy, dx, o] = sum_{b, i, j} g[b, 2i+dy, 2j+dx, o]   (the wrapper sums the taps)
//
// Replaces: image_segmentation_tpu/ops/pallas_conv.py
// make_folded_convtranspose2x2 (:1795): the forward _fwd_pallas (:1852;
// kernel body _ct_fwd_kernel_body :1745), the decoder's up-conv at
// models/folded.py:586-595, and the backward ct_bwd (:1888; body
// _ct_bwd_kernel_body :1761), which computes dx, dw and db in one pass over
// (g, x).  The weight comes in torch's ConvTranspose2d layout (flax's
// spatial flip already undone by utils/convert.state_dict_from_jax),
// rearranged by the wrapper to (Cin, 2, 2, Co) for the forward and (2, 2,
// Co, Cin) for the backward.
//
// The layout both kernels rest on: with the weight's columns in (dy, dx, o)
// order the op is a plain GEMM, Y (M x 4Co) = X (M x Cin) W (Cin x 4Co),
// M = B*Hin*Win, whose output rows are already contiguous.  For input pixel
// m = (b, i, j) and tap row dy, the 2Co columns (dx, o) are 2Co consecutive
// elements of y at ((b*Hin + i)*2 + dy)*2Win*Co + j*2Co, and the cotangent g
// has the same layout: a tile of pixels is one contiguous run per dy, with
// no gather and no interleave (the TPU kernel's e0/e1 split and `de`
// concat).
//
// What bounds it on the card: device-memory bytes.  Per large_unet step
// (batch 16, 512^2, two up-convs) the forward moves 603 MB for 34.4 GFLOP
// (57 FLOP/B) and the backward 805 MB for 68.8 GFLOP: both below the
// H100's ~295 FLOP/B bf16 ridge, so the bound is HBM.  But 57 FLOP/B at
// 3.35 TB/s is ~190 TFLOP/s, far above the 67 TFLOP/s of the fp32 FMA
// pipes, so the sums must run on the tensor cores; and the backward's 86
// FLOP/B at mma.sync's practical ~300 TFLOP/s sits near the balance point
// of mma.sync and HBM, so overlapping its loads with the mma decides it.
//
// What the design does about it: both kernels run mma.sync m16n8k16 (bf16
// in, fp32 sums) on tiles staged in shared memory by 16-byte cp.async, rows
// padded by 16 bytes so that every ldmatrix is free of bank conflicts.
// - Forward: persistent blocks (as many as fit on the card) keep their
//   weight columns resident in shared memory and walk M tiles of BM pixels
//   through a three-stage ring of X tiles, so the loads of the next tiles
//   run under the mma of this one.  Each warp owns 32 pixels x 64 columns,
//   and its epilogue needs no block barrier: it adds the bias in fp32,
//   rounds to bf16 once, stages its sub-tile in its own slice of shared
//   memory and writes each pixel's dy-runs with 16-byte coalesced stores;
//   each pixel row computes its base address once.  One barrier per tile.
// - Backward, one pass: each block walks a contiguous chunk of 64-pixel
//   tiles, loading the G tile (64 x 4Co, two contiguous dy-runs per pixel)
//   and the X tile once each, double-buffered, with one barrier per tile.
//   From them each warp computes its part of the dx tile G Wt against the
//   resident Wt and writes it (rounded to bf16, staged in its own slice,
//   16-byte stores); accumulates dW += X^T G in registers (X read through
//   ldmatrix.trans); and adds db as fixed-order fp32 column sums of the
//   staged G.  Register budget: dW's Cin x 4Co tile is spread over the
//   block's 8 warps (128 fp32 a thread at Cin 128, 4Co 256) next to dx's
//   tile (32 a thread), so the big tiles run one 256-thread block per SM
//   (16 warps at 128 registers measured slower).
//   At the end each block writes one partial row of dW and db, and a
//   fixed-order second pass (reduce.cuh) adds the chunks: no atomics, and
//   the chunks stay short (one per resident block) so the tensor cores'
//   fp32 sums run over a few thousand pixels each.
// Channel counts whose Cin is not a multiple of 8 or Co of 4 (odd test
// shapes) take an element path of the same kernels, zero-padded.  The
// backward holds dW's 4Co columns in one block: Co <= 64, any Cin (input
// channels beyond 128 go to further blocks).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "mma.cuh"
#include "reduce.cuh"

namespace {

using imgseg::cp_async16;
using imgseg::ldsm_x4;
using imgseg::ldsm_x4_trans;
using imgseg::mma_bf16;

constexpr int THREADS = 256;  // 8 warps
constexpr int MAX_SMEM = 232448;  // bytes a block may use on Hopper (227 KB)
constexpr int MAX_BWD_N = 256;    // 4Co the backward holds in one block

bool aligned16(const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16 == 0; }

// ---- forward

struct FwdArgs {
  const __nv_bfloat16* x;  // (M, Cin)
  const __nv_bfloat16* w;  // (Cin, N = 4*Co), columns (dy, dx, o)
  const float* bias;       // (Co)
  __nv_bfloat16* y;        // (B, 2Hin, 2Win, Co)
  int M, Win, Cin, Co, N;
  int kc;     // input channels per stage (a multiple of 16, <= 128)
  int nk;     // stages per tile: 1 keeps the weights resident
  int ns;     // ring depth, 2 or 3
  int tiles;  // M tiles
  int vec;    // 16-byte paths (Cin % 8 == 0, Co % 4 == 0, aligned)
};

constexpr int WOS = 64 + 8;  // row stride of a warp's staged 32 x 64 output sub-tile

// The dynamic shared memory of a forward launch, in bf16 elements.
struct FwdSmem {
  int wres, stage, out;
  __host__ __device__ static FwdSmem of(int bm, int tn, int kc, int nk) {
    const int wt = kc * (tn + 8);
    return FwdSmem{nk == 1 ? wt : 0, bm * (kc + 8) + (nk > 1 ? wt : 0), THREADS / 32 * 32 * WOS};
  }
  __host__ __device__ size_t bytes(int ns) const {
    return (static_cast<size_t>(wres) + static_cast<size_t>(ns) * stage + out) * sizeof(__nv_bfloat16);
  }
};

template <int BM, int TN>
__global__ void __launch_bounds__(THREADS, 2) ct_fwd_kernel(const FwdArgs p) {
  constexpr int WN = TN / 64, WM = 8 / WN;  // warp grid; each warp 32 pixels x 64 columns
  static_assert(WM * 32 == BM, "8 warps of 32 x 64");
  constexpr int OS = TN + 8;  // weight row stride (bf16)
  constexpr int TV = TN / 8;  // 16-byte vectors per weight row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ float s_bias[TN];       // the bias of the block's columns

  const int kc = p.kc, XS = kc + 8, KV = kc / 8;
  const FwdSmem L = FwdSmem::of(BM, TN, kc, p.nk);
  __nv_bfloat16* smem = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* s_wres = smem;
  __nv_bfloat16* s_stage = smem + L.wres;
  __nv_bfloat16* s_out = s_stage + p.ns * L.stage;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp % WM, wn = warp / WM;
  const int n0 = blockIdx.y * TN;
  const int M = p.M, N = p.N, Cin = p.Cin, Co = p.Co;
  const int kp = (Cin + 15) & ~15;
  // this block's tiles: blockIdx.x, + gridDim.x, ...; nk stages each
  const int my_tiles = (p.tiles - static_cast<int>(blockIdx.x) + gridDim.x - 1) / gridDim.x;
  const int stages = my_tiles * p.nk;

  // The weight rows [k0, k0 + kc) x columns [n0, n0 + TN), zero-padded.
  auto load_w = [&](__nv_bfloat16* dst, int k0) {
    if (p.vec) {
      for (int i = tid; i < kc * TV; i += THREADS) {
        const int k = i / TV, v = i % TV;
        const int gk = k0 + k, gn = n0 + 8 * v;
        const bool ok = gk < Cin && gn < N;
        cp_async16(dst + k * OS + 8 * v, ok ? p.w + static_cast<size_t>(gk) * N + gn : p.w, ok);
      }
    } else {
      for (int i = tid; i < kc * TN; i += THREADS) {
        const int k = i / TN, c = i % TN;
        const int gk = k0 + k, gn = n0 + c;
        dst[k * OS + c] = (gk < Cin && gn < N) ? p.w[static_cast<size_t>(gk) * N + gn]
                                               : __float2bfloat16(0.f);
      }
    }
  };
  // Stage s (tile blockIdx.x + (s / nk) * gridDim.x, channels (s % nk) * kc ..)
  // into ring slot s % ns; one commit group per stage, empty past the end.
  auto begin_stage = [&](int s) {
    if (s < stages) {
      __nv_bfloat16* sx = s_stage + (s % p.ns) * L.stage;
      const int m0 = (blockIdx.x + (s / p.nk) * gridDim.x) * BM;
      const int k0 = (s % p.nk) * kc;
      if (p.vec) {
        for (int i = tid; i < BM * KV; i += THREADS) {
          const int r = i / KV, v = i % KV;
          const int m = m0 + r, gk = k0 + 8 * v;
          const bool ok = m < M && gk < Cin;
          cp_async16(sx + r * XS + 8 * v, ok ? p.x + static_cast<size_t>(m) * Cin + gk : p.x, ok);
        }
      } else {
        for (int i = tid; i < BM * kc; i += THREADS) {
          const int r = i / kc, k = i % kc;
          const int m = m0 + r, gk = k0 + k;
          sx[r * XS + k] = (m < M && gk < Cin) ? p.x[static_cast<size_t>(m) * Cin + gk]
                                               : __float2bfloat16(0.f);
        }
      }
      if (p.nk > 1) load_w(sx + BM * XS, k0);
    }
    imgseg::cp_async_commit();
  };

  float acc[2][8][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;
  for (int c = tid; c < TN; c += THREADS) s_bias[c] = n0 + c < N ? p.bias[(n0 + c) % Co] : 0.f;

  // this lane's ldmatrix rows: A (pixel, 8-channel half), B (k row, 8-column half)
  const int a_pix = (lane & 7) + ((lane >> 3) & 1) * 8, a_k = (lane >> 4) * 8;
  const int b_k = (lane & 7) + ((lane >> 3) & 1) * 8, b_n = wn * 64 + (lane >> 4) * 8;

  if (p.nk == 1 && stages > 0) load_w(s_wres, 0);  // joins stage 0's group
  for (int s = 0; s < p.ns - 1; ++s) begin_stage(s);
  for (int s = 0; s < stages; ++s) {
    if (p.ns == 3) {
      imgseg::cp_async_wait<1>();
    } else {
      imgseg::cp_async_wait<0>();
    }
    __syncthreads();  // stage s is in; slot (s - 1) % ns is free
    begin_stage(s + p.ns - 1);
    const __nv_bfloat16* sx = s_stage + (s % p.ns) * L.stage;
    const __nv_bfloat16* sw = p.nk > 1 ? sx + BM * XS : s_wres;
    const int k0 = (s % p.nk) * kc;
    const int klen = kp - k0 < kc ? kp - k0 : kc;
    for (int kk = 0; kk < klen; kk += 16) {
      uint32_t b[8][2];
#pragma unroll
      for (int pr = 0; pr < 4; ++pr) {
        uint32_t r[4];
        ldsm_x4_trans(r, sw + (kk + b_k) * OS + b_n + pr * 16);
        b[2 * pr][0] = r[0], b[2 * pr][1] = r[1];
        b[2 * pr + 1][0] = r[2], b[2 * pr + 1][1] = r[3];
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        uint32_t a[4];
        ldsm_x4(a, sx + (wm * 32 + mi * 16 + a_pix) * XS + kk + a_k);
#pragma unroll
        for (int ni = 0; ni < 8; ++ni) mma_bf16(acc[mi][ni], a, b[ni][0], b[ni][1]);
      }
    }
    if (s % p.nk != p.nk - 1) continue;

    // ---- epilogue of the tile, each warp on its own 32 x 64 sub-tile (no
    // block barrier): bias, one bf16 rounding, staged, 16-byte stores
    const int m0 = (blockIdx.x + (s / p.nk) * gridDim.x) * BM + wm * 32;
    const int c0 = n0 + wn * 64;
    __nv_bfloat16* so = s_out + warp * 32 * WOS;
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = mi * 16 + (lane >> 2) + 8 * h;
#pragma unroll
        for (int ni = 0; ni < 8; ++ni) {
          const int c = ni * 8 + 2 * (lane & 3);
          const int cb = wn * 64 + c;
          *reinterpret_cast<__nv_bfloat162*>(so + r * WOS + c) = __floats2bfloat162_rn(
              acc[mi][ni][2 * h] + s_bias[cb], acc[mi][ni][2 * h + 1] + s_bias[cb + 1]);
          acc[mi][ni][2 * h] = acc[mi][ni][2 * h + 1] = 0.f;
        }
      }
    // lane r: the offset in y of the dy = 0 run of the warp's pixel row r, one division
    long long row_off;
    {
      const int m = m0 + lane;
      const int q = m / p.Win, j = m - q * p.Win;
      row_off = (2LL * q * 2 * p.Win + 2LL * j) * Co;
    }
    __syncwarp();
    const long long run = 2LL * p.Win * Co;  // from the dy = 0 run to the dy = 1 run
    const int co2 = 2 * Co;
    if (p.vec) {
#pragma unroll
      for (int k = 0; k < 8; ++k) {  // 4 pixel rows of 128 bytes a step
        const int r = k * 4 + (lane >> 3), v = lane & 7;
        const long long off = __shfl_sync(0xffffffffu, row_off, r);
        const int n = c0 + 8 * v;
        if (m0 + r >= M || n >= N) continue;
        const int dy = n >= co2;
        *reinterpret_cast<uint4*>(p.y + off + dy * run + (n - dy * co2)) =
            *reinterpret_cast<const uint4*>(so + r * WOS + 8 * v);
      }
    } else {
      for (int k = 0; k < 64; ++k) {
        const int r = k >> 1, c = (k & 1) * 32 + lane;
        const long long off = __shfl_sync(0xffffffffu, row_off, r);
        const int n = c0 + c;
        if (m0 + r >= M || n >= N) continue;
        const int dy = n >= co2;
        p.y[off + dy * run + (n - dy * co2)] = so[r * WOS + c];
      }
    }
    __syncwarp();  // the sub-tile is read before the warp's next epilogue writes it
  }
  imgseg::cp_async_wait<0>();
}

template <int BM, int TN>
cudaError_t launch_fwd(FwdArgs p, cudaStream_t stream) {
  static bool opted = false;
  auto* kernel = ct_fwd_kernel<BM, TN>;
  const int kp = (p.Cin + 15) & ~15;
  p.kc = kp < 128 ? kp : 128;
  p.nk = (kp + p.kc - 1) / p.kc;
  const FwdSmem L = FwdSmem::of(BM, TN, p.kc, p.nk);
  const size_t limit = MAX_SMEM - TN * sizeof(float) - 1024;  // room for the static bias row
  p.ns = L.bytes(3) <= limit ? 3 : 2;
  const size_t bytes = L.bytes(p.ns);
  p.tiles = (p.M + BM - 1) / BM;
  const int col_tiles = (p.N + TN - 1) / TN;
  cudaError_t err = imgseg::allow_smem(kernel, limit, opted);
  int resident = 0;
  if (err == cudaSuccess) err = imgseg::resident_blocks(kernel, THREADS, bytes, resident);
  if (err != cudaSuccess) return err;
  int blocks = resident / col_tiles;
  blocks = blocks < 1 ? 1 : (blocks > p.tiles ? p.tiles : blocks);
  if (col_tiles > 65535) return cudaErrorInvalidConfiguration;
  kernel<<<dim3(blocks, col_tiles), THREADS, bytes, stream>>>(p);
  return cudaGetLastError();
}

// ---- backward

constexpr int BBM = 64;  // pixels per backward tile: four k16 steps of dW

struct BwdArgs {
  const __nv_bfloat16* x;   // (M, Cin)
  const __nv_bfloat16* wt;  // (N = 4*Co, Cin), rows (dy, dx, o)
  const __nv_bfloat16* g;   // (B, 2Hin, 2Win, Co)
  __nv_bfloat16* dx;        // (M, Cin)
  float* part_w;            // (chunks, Cin, N)
  float* part_b;            // (chunks, N)
  int M, Win, Cin, Co, N;
  int tiles, per_chunk;
  int vec;  // 16-byte paths (Cin % 8 == 0, Co % 4 == 0, aligned)
};

// CP input channels (64 or 128) x NP columns (128 or 256) per block.
template <int CP, int NP>
struct BwdTiles {
  static constexpr int GS = NP + 8, XS = CP + 8;  // row strides (bf16)
  static constexpr int G = BBM * GS, X = BBM * XS, STAGE = G + X;
  static constexpr int WT = NP * XS;
  // dW: warps 2 (channels) x 4 (columns), MI m16 x NI n8 tiles each
  static constexpr int MI = CP / 32, NI = NP / 32;
  // dx: warps WMX (pixels) x WNX (channels), MT m16 x NT n8 tiles each,
  // staged per warp (rows of 32 channels, stride DS)
  static constexpr int WNX = CP / 32, WMX = 8 / WNX, MT = BBM / WMX / 16, NT = 4;
  static constexpr int DS = 32 + 8, DX = MT * 16 * DS;
  static constexpr size_t BYTES = (WT + 2 * STAGE + 8 * DX) * sizeof(__nv_bfloat16);
  // db: DBC 8-column groups x DBR pixel lanes
  static constexpr int DBC = NP / 8, DBR = THREADS / DBC;
  // the big tiles hold 128 + 32 fp32 sums a thread: one block per SM
  static constexpr int MIN_BLOCKS = CP * NP >= 128 * 128 ? 1 : 2;
};

template <int CP, int NP>
__global__ void __launch_bounds__(THREADS, BwdTiles<CP, NP>::MIN_BLOCKS) ct_bwd_kernel(const BwdArgs p) {
  using T = BwdTiles<CP, NP>;
  constexpr int GS = T::GS, XS = T::XS, MI = T::MI, NI = T::NI, MT = T::MT, NT = T::NT;
  constexpr int GV = NP / 8, XV = CP / 8;  // 16-byte vectors per staged row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* smem = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  __nv_bfloat16* s_wt = smem;
  __nv_bfloat16* s_stage = smem + T::WT;
  __nv_bfloat16* s_dx = s_stage + 2 * T::STAGE + warp * T::DX;  // this warp's dx sub-tile

  const int M = p.M, N = p.N, Cin = p.Cin, Co = p.Co, co2 = 2 * Co;
  const int ci0 = blockIdx.y * CP;
  const bool with_db = blockIdx.y == 0;
  const int t_begin = blockIdx.x * p.per_chunk;
  const int t_end = t_begin + p.per_chunk < p.tiles ? t_begin + p.per_chunk : p.tiles;

  // Wt rows n < NP x channels ci0 .. ci0 + CP, zero-padded; resident.
  if (p.vec) {
    for (int i = tid; i < NP * XV; i += THREADS) {
      const int n = i / XV, v = i % XV;
      const int ci = ci0 + 8 * v;
      const bool ok = n < N && ci < Cin;
      cp_async16(s_wt + n * XS + 8 * v, ok ? p.wt + static_cast<size_t>(n) * Cin + ci : p.wt, ok);
    }
  } else {
    for (int i = tid; i < NP * CP; i += THREADS) {
      const int n = i / CP, c = i % CP;
      const int ci = ci0 + c;
      s_wt[n * XS + c] =
          (n < N && ci < Cin) ? p.wt[static_cast<size_t>(n) * Cin + ci] : __float2bfloat16(0.f);
    }
  }

  // Tile t into slot `buf`: the G tile (pixel rows; columns (dy, dx, o) from
  // the pixel's two contiguous dy-runs) and the X tile, zero-padded.
  auto load_tile = [&](int t, int buf) {
    __nv_bfloat16* sg = s_stage + buf * T::STAGE;
    __nv_bfloat16* sx = sg + T::G;
    const int m0 = t * BBM;
    if (p.vec) {
      for (int i = tid; i < BBM * GV; i += THREADS) {
        const int r = i / GV, v = i % GV;
        const int m = m0 + r, n = 8 * v;
        const bool ok = m < M && n < N;
        const __nv_bfloat16* src = p.g;
        if (ok) {
          const int q = m / p.Win, j = m - q * p.Win, dy = n >= co2;
          src = p.g + (2LL * (2 * q + dy) * p.Win + 2LL * j) * Co + (n - dy * co2);
        }
        cp_async16(sg + r * GS + 8 * v, src, ok);
      }
      for (int i = tid; i < BBM * XV; i += THREADS) {
        const int r = i / XV, v = i % XV;
        const int m = m0 + r, ci = ci0 + 8 * v;
        const bool ok = m < M && ci < Cin;
        cp_async16(sx + r * XS + 8 * v, ok ? p.x + static_cast<size_t>(m) * Cin + ci : p.x, ok);
      }
    } else {
      for (int i = tid; i < BBM * NP; i += THREADS) {
        const int r = i / NP, n = i % NP;
        const int m = m0 + r;
        __nv_bfloat16 v = __float2bfloat16(0.f);
        if (m < M && n < N) {
          const int q = m / p.Win, j = m - q * p.Win, dy = n >= co2;
          v = p.g[(2LL * (2 * q + dy) * p.Win + 2LL * j) * Co + (n - dy * co2)];
        }
        sg[r * GS + n] = v;
      }
      for (int i = tid; i < BBM * CP; i += THREADS) {
        const int r = i / CP, c = i % CP;
        const int m = m0 + r, ci = ci0 + c;
        sx[r * XS + c] = (m < M && ci < Cin) ? p.x[static_cast<size_t>(m) * Cin + ci]
                                             : __float2bfloat16(0.f);
      }
    }
  };

  float acc_w[MI][NI][4];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc_w[mi][ni][e] = 0.f;
  // db: this thread's 8 columns dbc*8 .. over the tile pixels dbr, dbr + DBR, ...
  const int dbc = tid % T::DBC, dbr = tid / T::DBC;
  float dbs[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) dbs[k] = 0.f;

  // warp roles: dW (wm, wn); dx (xm, xn)
  const int wm = warp & 1, wn = warp >> 1;
  const int xm = warp % T::WMX, xn = warp / T::WMX;
  // ldmatrix rows: non-trans A (pixel, k half); trans B (k row, n half); trans A (k row, m half)
  const int a_pix = (lane & 7) + ((lane >> 3) & 1) * 8, a_k = (lane >> 4) * 8;
  const int b_k = (lane & 7) + ((lane >> 3) & 1) * 8, b_n = (lane >> 4) * 8;
  const int at_k = (lane & 7) + (lane >> 4) * 8, at_m = ((lane >> 3) & 1) * 8;

  if (t_begin < t_end) load_tile(t_begin, 0);
  imgseg::cp_async_commit();
  for (int t = t_begin; t < t_end; ++t) {
    const int buf = (t - t_begin) & 1;
    imgseg::cp_async_wait<0>();
    __syncthreads();  // tile t is in; the other slot is free
    if (t + 1 < t_end) load_tile(t + 1, buf ^ 1);
    imgseg::cp_async_commit();
    const __nv_bfloat16* sg = s_stage + buf * T::STAGE;
    const __nv_bfloat16* sx = sg + T::G;

    // dx = G Wt: (64 x NP) x (NP x CP)
    float acc_x[MT][NT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc_x[mt][nt][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < NP; kk += 16) {  // columns past 4Co are zeros in G and Wt
      uint32_t b[NT][2];
#pragma unroll
      for (int pr = 0; pr < NT / 2; ++pr) {
        uint32_t r[4];
        ldsm_x4_trans(r, s_wt + (kk + b_k) * XS + xn * 32 + pr * 16 + b_n);
        b[2 * pr][0] = r[0], b[2 * pr][1] = r[1];
        b[2 * pr + 1][0] = r[2], b[2 * pr + 1][1] = r[3];
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        uint32_t a[4];
        ldsm_x4(a, sg + (xm * MT * 16 + mt * 16 + a_pix) * GS + kk + a_k);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) mma_bf16(acc_x[mt][nt], a, b[nt][0], b[nt][1]);
      }
    }

    // dx, each warp on its own sub-tile (no block barrier): one bf16
    // rounding, staged, then 16-byte stores of 64-byte row segments
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = mt * 16 + (lane >> 2) + 8 * h;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          *reinterpret_cast<__nv_bfloat162*>(s_dx + r * T::DS + nt * 8 + 2 * (lane & 3)) =
              __floats2bfloat162_rn(acc_x[mt][nt][2 * h], acc_x[mt][nt][2 * h + 1]);
        }
      }
    __syncwarp();
    {
      const int m0 = t * BBM + xm * MT * 16, c0 = ci0 + xn * 32;
      if (p.vec) {
#pragma unroll
        for (int k = 0; k < MT * 2; ++k) {  // 8 pixel rows of 64 bytes a step
          const int r = k * 8 + (lane >> 2), v = lane & 3;
          const int m = m0 + r, ci = c0 + 8 * v;
          if (m < M && ci < Cin) {
            *reinterpret_cast<uint4*>(p.dx + static_cast<size_t>(m) * Cin + ci) =
                *reinterpret_cast<const uint4*>(s_dx + r * T::DS + 8 * v);
          }
        }
      } else {
        for (int r = 0; r < MT * 16; ++r) {
          const int m = m0 + r, ci = c0 + lane;
          if (m < M && ci < Cin) p.dx[static_cast<size_t>(m) * Cin + ci] = s_dx[r * T::DS + lane];
        }
      }
    }
    __syncwarp();  // the sub-tile is read before the warp's next tile writes it

    // dW += X^T G: (CP x 64) x (64 x NP)
#pragma unroll
    for (int kk = 0; kk < BBM; kk += 16) {
      uint32_t b[NI][2];
#pragma unroll
      for (int pr = 0; pr < NI / 2; ++pr) {
        uint32_t r[4];
        ldsm_x4_trans(r, sg + (kk + b_k) * GS + wn * (NP / 4) + pr * 16 + b_n);
        b[2 * pr][0] = r[0], b[2 * pr][1] = r[1];
        b[2 * pr + 1][0] = r[2], b[2 * pr + 1][1] = r[3];
      }
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) {
        uint32_t a[4];
        ldsm_x4_trans(a, sx + (kk + at_k) * XS + wm * (CP / 2) + mi * 16 + at_m);
#pragma unroll
        for (int ni = 0; ni < NI; ++ni) mma_bf16(acc_w[mi][ni], a, b[ni][0], b[ni][1]);
      }
    }

    // db: fp32 column sums in pixel order
    if (with_db) {
      for (int r = dbr; r < BBM; r += T::DBR) {
        const imgseg::Vec8 v = imgseg::as_vec8(*reinterpret_cast<const uint4*>(sg + r * GS + 8 * dbc));
#pragma unroll
        for (int k = 0; k < 8; ++k) dbs[k] += __bfloat162float(v.v[k]);
      }
    }
  }
  imgseg::cp_async_wait<0>();

  // this block's partial dW rows (every entry of its channels, zeros included)
  float* pw = p.part_w + static_cast<size_t>(blockIdx.x) * Cin * N;
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ci = ci0 + wm * (CP / 2) + mi * 16 + (lane >> 2) + (e >> 1) * 8;
        const int n = wn * (NP / 4) + ni * 8 + 2 * (lane & 3) + (e & 1);
        if (ci < Cin && n < N) pw[static_cast<size_t>(ci) * N + n] = acc_w[mi][ni][e];
      }
  if (with_db) {  // the pixel lanes' sums, added in lane order per column
    __syncthreads();
    float* red = reinterpret_cast<float*>(s_stage);  // (DBR, NP)
#pragma unroll
    for (int k = 0; k < 8; ++k) red[dbr * NP + 8 * dbc + k] = dbs[k];
    __syncthreads();
    for (int n = tid; n < N; n += THREADS) {
      float s = 0.f;
      for (int r = 0; r < T::DBR; ++r) s += red[r * NP + n];
      p.part_b[static_cast<size_t>(blockIdx.x) * N + n] = s;
    }
  }
}

struct BwdPlan {
  int cp, np, ci_tiles, tiles, chunks, per_chunk;
  size_t bytes;
  cudaError_t err;
};

template <int CP, int NP>
cudaError_t bwd_kernel_ready(int& resident) {
  static bool opted = false;
  auto* kernel = ct_bwd_kernel<CP, NP>;
  const size_t bytes = BwdTiles<CP, NP>::BYTES;
  const cudaError_t err = imgseg::allow_smem(kernel, bytes, opted);
  return err != cudaSuccess ? err : imgseg::resident_blocks(kernel, THREADS, bytes, resident);
}

// The tiles and chunks of a backward launch; the scratch query and the
// launch take the same plan.
BwdPlan bwd_plan(int B, int Hin, int Win, int Cin, int Co) {
  BwdPlan q{};
  q.cp = Cin <= 64 ? 64 : 128;
  q.np = 4 * Co <= 128 ? 128 : 256;
  q.ci_tiles = (Cin + q.cp - 1) / q.cp;
  const long long M = static_cast<long long>(B) * Hin * Win;
  q.tiles = static_cast<int>((M + BBM - 1) / BBM);
  int resident = 0;
  if (q.cp == 64) {
    q.err = q.np == 128 ? bwd_kernel_ready<64, 128>(resident) : bwd_kernel_ready<64, 256>(resident);
    q.bytes = q.np == 128 ? BwdTiles<64, 128>::BYTES : BwdTiles<64, 256>::BYTES;
  } else {
    q.err = q.np == 128 ? bwd_kernel_ready<128, 128>(resident) : bwd_kernel_ready<128, 256>(resident);
    q.bytes = q.np == 128 ? BwdTiles<128, 128>::BYTES : BwdTiles<128, 256>::BYTES;
  }
  q.chunks = static_cast<int>(imgseg::chunks_for(q.tiles, q.ci_tiles, resident));
  q.per_chunk = (q.tiles + q.chunks - 1) / q.chunks;
  q.chunks = (q.tiles + q.per_chunk - 1) / q.per_chunk;
  return q;
}

// The shapes the kernels take: pixel rows (and their tiles) counted in int,
// and the backward's 4Co columns in one block.
bool fits(int B, int Hin, int Win, int Co, bool bwd) {
  return static_cast<long long>(B) * Hin * Win <= INT_MAX - 256 && (!bwd || 4 * Co <= MAX_BWD_N);
}

}  // namespace

// Floats of scratch for the backward: a (Cin, 4*Co) and a (4*Co) row per chunk.
extern "C" long long imgseg_convtranspose2x2_bwd_scratch(int B, int Hin, int Win, int Cin, int Co) {
  if (B <= 0 || Hin <= 0 || Win <= 0 || Cin <= 0 || Co <= 0 || !fits(B, Hin, Win, Co, true)) return 0;
  const BwdPlan q = bwd_plan(B, Hin, Win, Cin, Co);
  return static_cast<long long>(q.chunks) * (static_cast<long long>(Cin) + 1) * 4 * Co;
}

// dx (B,Hin,Win,Cin) bf16, dw (Cin, 4*Co) fp32 with columns (dy, dx, o), db
// (4*Co) fp32 per (dy, dx, o); x (B,Hin,Win,Cin), wt (2, 2, Co, Cin) bf16,
// g (B,2Hin,2Win,Co); Co <= 64.
extern "C" int imgseg_convtranspose2x2_bwd(const void* x, const void* wt, const void* g, void* dx,
                                           void* dw, void* db, void* scratch, int B, int Hin,
                                           int Win, int Cin, int Co, void* stream) {
  if (B <= 0 || Hin <= 0 || Win <= 0 || Co <= 0 || Cin <= 0) return static_cast<int>(cudaSuccess);
  if (!fits(B, Hin, Win, Co, true)) return static_cast<int>(cudaErrorInvalidValue);
  const BwdPlan q = bwd_plan(B, Hin, Win, Cin, Co);
  if (q.err != cudaSuccess) return static_cast<int>(q.err);
  if (q.ci_tiles > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
  BwdArgs p{};
  p.x = static_cast<const __nv_bfloat16*>(x);
  p.wt = static_cast<const __nv_bfloat16*>(wt);
  p.g = static_cast<const __nv_bfloat16*>(g);
  p.dx = static_cast<__nv_bfloat16*>(dx);
  p.part_w = static_cast<float*>(scratch);
  p.part_b = p.part_w + static_cast<long long>(q.chunks) * Cin * 4 * Co;
  p.M = B * Hin * Win, p.Win = Win, p.Cin = Cin, p.Co = Co, p.N = 4 * Co;
  p.tiles = q.tiles, p.per_chunk = q.per_chunk;
  p.vec = Cin % 8 == 0 && Co % 4 == 0 && aligned16(x) && aligned16(wt) && aligned16(g) && aligned16(dx);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(q.chunks, q.ci_tiles);
  if (q.cp == 64) {
    if (q.np == 128) {
      ct_bwd_kernel<64, 128><<<grid, THREADS, q.bytes, s>>>(p);
    } else {
      ct_bwd_kernel<64, 256><<<grid, THREADS, q.bytes, s>>>(p);
    }
  } else if (q.np == 128) {
    ct_bwd_kernel<128, 128><<<grid, THREADS, q.bytes, s>>>(p);
  } else {
    ct_bwd_kernel<128, 256><<<grid, THREADS, q.bytes, s>>>(p);
  }
  cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess) {
    err = imgseg::sum_rows(p.part_w, static_cast<float*>(dw), q.chunks, 4LL * Cin * Co, s);
  }
  if (err == cudaSuccess) err = imgseg::sum_rows(p.part_b, static_cast<float*>(db), q.chunks, 4LL * Co, s);
  return static_cast<int>(err);
}

extern "C" int imgseg_convtranspose2x2(const void* x, const void* w, const void* bias, void* y,
                                       int B, int Hin, int Win, int Cin, int Co,
                                       void* stream) {
  if (B <= 0 || Hin <= 0 || Win <= 0 || Co <= 0 || Cin <= 0) return static_cast<int>(cudaSuccess);
  if (!fits(B, Hin, Win, Co, false)) return static_cast<int>(cudaErrorInvalidValue);
  FwdArgs p{};
  p.x = static_cast<const __nv_bfloat16*>(x);
  p.w = static_cast<const __nv_bfloat16*>(w);
  p.bias = static_cast<const float*>(bias);
  p.y = static_cast<__nv_bfloat16*>(y);
  p.M = B * Hin * Win, p.Win = Win, p.Cin = Cin, p.Co = Co, p.N = 4 * Co;
  p.vec = Cin % 8 == 0 && Co % 4 == 0 && aligned16(x) && aligned16(w) && aligned16(y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // one warp: 32 pixels x 64 columns; the tile spans all 4Co columns up to 256
  cudaError_t err;
  if (p.N <= 64) {
    err = launch_fwd<256, 64>(p, s);
  } else if (p.N <= 128) {
    err = launch_fwd<128, 128>(p, s);
  } else {
    err = launch_fwd<64, 256>(p, s);
  }
  return static_cast<int>(err);
}
