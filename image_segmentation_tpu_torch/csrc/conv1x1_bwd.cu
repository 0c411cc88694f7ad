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
// ~295 FLOP/byte ridge.  But a first design, which widened every
// operand to fp32 in shared memory and did the sums on the FMA pipes with
// two shared loads per FMA, was bound by instructions at 0.32 of that.
//
// What the design does about it: the sums run on the tensor cores
// (mma.sync m16n8k16, bf16 in, fp32 sums) from bf16 tiles, fed by a
// three-stage ring of 16-byte cp.async copies so the next tiles' loads run
// under this tile's arithmetic.  Each 256-thread block walks a contiguous
// chunk of P-pixel tiles (P 256 at the models' widths); a tile of x or g
// is one contiguous run of P x C bf16 in NHWC.
// - Operand rows in shared memory are padded to an odd number of 16-byte
//   units (conflict-free ldmatrix): [X | 1] to Ci + 1 rounded up to 8
//   columns (a column of ones, so db is the product with it, as in the
//   first design), G to Co rounded up to 16; the padding columns are set
//   once.  An operand whose rows are whole 16-byte words (C % 8 == 0, an
//   aligned tensor) is copied straight into its padded rows.  A narrow one
//   (Ci 3 at the stem, Co 3 at the output: 6-byte rows) is copied raw, as
//   the contiguous run it is, and re-laid once per tile into its padded
//   rows by a shared -> shared pass (one index division per thread per
//   tile); an unaligned one (a view at an odd offset) is read element by
//   element into the raw slot.
// - The weight gradient is a GEMM with the pixels as K: A = G^T (Co
//   padded to 16) by ldmatrix.trans from the [pixel][co] rows, B = [X | 1]
//   by ldmatrix.trans from the [pixel][ci] rows.  The warps split the
//   tile's 16-pixel k-steps; each warp holds all of the block's TPW m16n8
//   tiles of the (Co, Ci + 1) table in fp32 registers over the whole
//   chunk (so each warp's sums run over 1/8 of the chunk's pixels, ~2,000
//   at the models' shapes).  Tables of more than 8 tiles are split over
//   grid.y (each y-block reads the operands again; no model's 1x1 has one).
// - dx = G W on the tensor cores: M 16 pixels, K = Co padded to 16, N = Ci
//   in passes of 64 columns; W resident in shared memory, read by
//   ldmatrix.trans.  Each warp rounds its 16 x 64 sub-tile to bf16 once,
//   stages it in its own slice of shared memory and writes it with 16-byte
//   stores (no block barrier).
// - At the end the warps' sums are added in warp order through shared
//   memory, each block writes one row of partial sums, and a fixed-order
//   second pass (reduce.cuh) adds the rows.  The grid is one wave of
//   resident blocks.  No atomics: the sums are the same on every run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "mma.cuh"
#include "reduce.cuh"

namespace {

using imgseg::cp_async16;
using imgseg::ldsm_x2_trans;
using imgseg::ldsm_x4;
using imgseg::ldsm_x4_trans;
using imgseg::mma_bf16;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int NS = 3;                 // ring depth
constexpr int TMAX = 8;               // m16n8 tiles of the (Co, Ci + 1) table per block
constexpr int MAX_SUMS = 2048;        // Co * (Ci + 1), as the wrapper checks
constexpr int DXN = 64;               // dx columns per pass
constexpr int DXS = DXN + 8;          // row stride of a warp's staged dx sub-tile
constexpr int MAX_SMEM = 232448;      // bytes a block may use on Hopper (227 KB)
constexpr int SMEM_TARGET = 100 * 1024;  // room for two blocks per SM

// A padded row of n columns (n a multiple of 8): an odd number of 16-byte
// units, so that the 8 rows an ldmatrix reads fall in distinct banks.
constexpr int padded(int n) { return (n / 8) % 2 ? n : n + 8; }

constexpr int round_up(int n, int m) { return (n + m - 1) / m * m; }

bool aligned16(const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16 == 0; }

struct Args {
  const __nv_bfloat16* x;  // (npix, Ci)
  const __nv_bfloat16* g;  // (npix, Co)
  const __nv_bfloat16* w;  // (Co, Ci)
  __nv_bfloat16* dx;       // (npix, Ci) or null: no input gradient
  float* part;             // (chunks, Co, Ci + 1)
  long long npix, tiles, per_chunk;
  int Ci, Co, P;
  int xn, gn, wn;          // padded widths: Ci + 1 to 8, Co to 16, Ci to 16
  int xs, gs, ws;          // their row strides
  int mt, nt;              // the table's m16 x n8 tiles: gn / 16 x xn / 8
  bool x_direct, g_direct; // 16-byte copies straight into the padded rows
  bool x_vec, g_vec;       // aligned: raw tiles by 16-byte copies
  bool dx_vec;             // dx by 16-byte stores
  // shared-memory layout, in bf16 elements
  int xslot, gslot;        // one ring stage: the x part, then the g part
  int o_xe, o_ge, o_w, o_dx;
};

// Dynamic shared memory of a launch with tiles of P pixels, in bytes; fills
// the layout fields of `p`.
size_t layout(Args& p, int P, bool with_dx) {
  p.P = P;
  p.xslot = p.x_direct ? P * p.xs : round_up(P * p.Ci, 8);
  p.gslot = p.g_direct ? P * p.gs : round_up(P * p.Co, 8);
  int off = NS * (p.xslot + p.gslot);
  // the warps' sums at the end reuse the ring (fp32)
  const int red = WARPS * TMAX * 128 * 2;
  if (off < red) off = red;
  p.o_xe = off;
  off += p.x_direct ? 0 : P * p.xs;
  p.o_ge = off;
  off += p.g_direct ? 0 : P * p.gs;
  p.o_w = off;
  p.o_dx = off + (with_dx ? p.gn * p.ws : 0);
  off = p.o_dx + (with_dx ? WARPS * 16 * DXS : 0);
  return static_cast<size_t>(off) * sizeof(__nv_bfloat16);
}

// Walks i = start, start + THREADS, ... < n over rows of C columns without
// a division per step: (row, col) of i.
struct RowCursor {
  int q, c, dq, dc, C;
  __device__ RowCursor(int start, int C_) : C(C_) {
    q = start / C, c = start - q * C;
    dq = THREADS / C, dc = THREADS - dq * C;
  }
  __device__ void next() {
    q += dq, c += dc;
    if (c >= C) c -= C, ++q;
  }
};

// Tile rows [0, n) of C channels from src (contiguous) into a ring slot:
// with `direct`, 16-byte copies into rows of stride `stride` (zeros past
// n); else the raw run of P*C values (zeros past n*C), by 16-byte copies
// when `vec` and the tile is whole, else element by element.
__device__ __forceinline__ void stage(const __nv_bfloat16* __restrict__ src, int n, int P, int C,
                                      int stride, bool direct, bool vec, __nv_bfloat16* dst) {
  const int tid = threadIdx.x;
  if (direct) {
    const int V = C / 8;
    RowCursor r(tid, V);
    for (int i = tid; i < P * V; i += THREADS, r.next()) {
      const bool ok = r.q < n;
      cp_async16(dst + r.q * stride + 8 * r.c, ok ? src + static_cast<size_t>(r.q) * C + 8 * r.c : src,
                 ok);
    }
  } else if (vec && n == P) {
    for (int i = tid; i < P * C / 8; i += THREADS) cp_async16(dst + 8 * i, src + 8 * i, true);
  } else {
    const int valid = n * C;
    for (int e = tid; e < P * C; e += THREADS) dst[e] = e < valid ? src[e] : __float2bfloat16(0.f);
  }
}

// A raw run of P rows of C values into rows of stride `stride` (columns
// past C keep what they hold).
__device__ __forceinline__ void relay(const __nv_bfloat16* raw, int P, int C, int stride,
                                      __nv_bfloat16* dst) {
  RowCursor r(threadIdx.x, C);
  for (int e = threadIdx.x; e < P * C; e += THREADS, r.next()) dst[r.q * stride + r.c] = raw[e];
}

template <int TPW>
__global__ void __launch_bounds__(THREADS) conv1x1_bwd_kernel(const Args p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* smem = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int P = p.P, Ci = p.Ci, Co = p.Co;
  const bool with_dx = p.dx != nullptr && blockIdx.y == 0;
  __nv_bfloat16* s_xe = smem + p.o_xe;
  __nv_bfloat16* s_ge = smem + p.o_ge;
  __nv_bfloat16* s_w = smem + p.o_w;
  __nv_bfloat16* s_dx = smem + p.o_dx + warp * 16 * DXS;  // this warp's dx sub-tile
  auto slot_x = [&](int s) { return smem + s * (p.xslot + p.gslot); };
  auto slot_g = [&](int s) { return slot_x(s) + p.xslot; };

  // the columns the staging never writes: [X | 1]'s ones and zeros, G's zeros
  auto pad_x = [&](__nv_bfloat16* rows) {
    const int w = p.xn - Ci;
    for (int i = tid; i < P * w; i += THREADS) {
      const int q = i / w, c = Ci + (i - q * w);
      rows[q * p.xs + c] = __float2bfloat16(c == Ci ? 1.f : 0.f);
    }
  };
  auto pad_g = [&](__nv_bfloat16* rows) {
    const int w = p.gn - Co;
    for (int i = tid; i < P * w; i += THREADS) {
      const int q = i / w;
      rows[q * p.gs + Co + (i - q * w)] = __float2bfloat16(0.f);
    }
  };
  for (int s = 0; s < (p.x_direct ? NS : 1); ++s) pad_x(p.x_direct ? slot_x(s) : s_xe);
  for (int s = 0; s < (p.g_direct ? NS : 1); ++s) pad_g(p.g_direct ? slot_g(s) : s_ge);
  if (with_dx) {  // W (Co, Ci) into gn x wn, zero-padded; resident
    for (int i = tid; i < p.gn * p.wn; i += THREADS) {
      const int co = i / p.wn, ci = i - co * p.wn;
      s_w[co * p.ws + ci] =
          (co < Co && ci < Ci) ? p.w[static_cast<size_t>(co) * Ci + ci] : __float2bfloat16(0.f);
    }
  }

  auto load_tile = [&](long long t, int s) {
    const long long p0 = t * P;
    const int n = static_cast<int>(p.npix - p0 < P ? p.npix - p0 : P);
    stage(p.x + p0 * Ci, n, P, Ci, p.xs, p.x_direct, p.x_vec, slot_x(s));
    stage(p.g + p0 * Co, n, P, Co, p.gs, p.g_direct, p.g_vec, slot_g(s));
  };

  // this block's tiles of the table: tile j is (m16 tile mi, n8 tile ni)
  const int T = p.mt * p.nt, tbase = blockIdx.y * TPW;
  int a_col[TPW], b_col[TPW];
  bool has[TPW];
  float acc[TPW][4];
#pragma unroll
  for (int j = 0; j < TPW; ++j) {
    const int t = tbase + j;
    has[j] = t < T;
    const int mi = has[j] ? t / p.nt : 0;
    a_col[j] = 16 * mi + ((lane >> 3) & 1) * 8;
    b_col[j] = 8 * (has[j] ? t - mi * p.nt : 0);
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  }
  // ldmatrix rows: trans A (pixel), non-trans A (pixel, k half), trans B (k row, n half)
  const int at_k = (lane & 7) + (lane >> 4) * 8;
  const int a_pix = (lane & 7) + ((lane >> 3) & 1) * 8, a_k = (lane >> 4) * 8;
  const int b_k = (lane & 7) + ((lane >> 3) & 1) * 8, b_n = (lane >> 4) * 8;

  const long long t0 = static_cast<long long>(blockIdx.x) * p.per_chunk;
  const long long t1 = t0 + p.per_chunk < p.tiles ? t0 + p.per_chunk : p.tiles;
#pragma unroll
  for (int s = 0; s < NS - 1; ++s) {
    if (t0 + s < t1) load_tile(t0 + s, s);
    imgseg::cp_async_commit();
  }
  for (long long t = t0; t < t1; ++t) {
    const int s = static_cast<int>((t - t0) % NS);
    imgseg::cp_async_wait<NS - 2>();
    __syncthreads();  // tile t is in; the slot of tile t - 1 and the re-laid rows are free
    if (t + NS - 1 < t1) load_tile(t + NS - 1, static_cast<int>((t - t0 + NS - 1) % NS));
    imgseg::cp_async_commit();
    const __nv_bfloat16* xe = p.x_direct ? slot_x(s) : s_xe;
    const __nv_bfloat16* ge = p.g_direct ? slot_g(s) : s_ge;
    if (!p.x_direct || !p.g_direct) {
      if (!p.x_direct) relay(slot_x(s), P, Ci, p.xs, s_xe);
      if (!p.g_direct) relay(slot_g(s), P, Co, p.gs, s_ge);
      __syncthreads();
    }

    // [dW | db] += G^T [X | 1], the warps taking turns over the k-steps
    for (int k0 = warp * 16; k0 < P; k0 += WARPS * 16) {
#pragma unroll
      for (int j = 0; j < TPW; ++j) {
        if (!has[j]) continue;
        uint32_t a[4], b[2];
        ldsm_x4_trans(a, ge + (k0 + at_k) * p.gs + a_col[j]);
        ldsm_x2_trans(b, xe + (k0 + (lane & 15)) * p.xs + b_col[j]);
        mma_bf16(acc[j], a, b[0], b[1]);
      }
    }

    if (!with_dx) continue;
    // dx = G W, one 16-pixel m-tile and up to 64 columns at a time
    const long long p0 = t * P;
    for (int m0 = warp * 16; m0 < P; m0 += WARPS * 16) {
      for (int n0 = 0; n0 < Ci; n0 += DXN) {
        const int nw = p.wn - n0 < DXN ? p.wn - n0 : DXN;  // a multiple of 16
        float c[8][4];
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) c[nt][e] = 0.f;
        for (int kk = 0; kk < p.gn; kk += 16) {
          uint32_t a[4];
          ldsm_x4(a, ge + (m0 + a_pix) * p.gs + kk + a_k);
#pragma unroll
          for (int pr = 0; pr < 4; ++pr) {
            if (16 * pr >= nw) break;
            uint32_t r[4];
            ldsm_x4_trans(r, s_w + (kk + b_k) * p.ws + n0 + 16 * pr + b_n);
            mma_bf16(c[2 * pr], a, r[0], r[1]);
            mma_bf16(c[2 * pr + 1], a, r[2], r[3]);
          }
        }
        // one bf16 rounding, staged in the warp's own slice, then stored
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          if (8 * nt >= nw) break;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            *reinterpret_cast<__nv_bfloat162*>(s_dx + ((lane >> 2) + 8 * h) * DXS + 8 * nt +
                                               2 * (lane & 3)) =
                __floats2bfloat162_rn(c[nt][2 * h], c[nt][2 * h + 1]);
          }
        }
        __syncwarp();
        const int cw = Ci - n0 < DXN ? Ci - n0 : DXN;
        const long long pix = p0 + m0;
        const int rows = p.npix - pix < 16 ? static_cast<int>(p.npix - pix) : 16;
        __nv_bfloat16* dst = p.dx + pix * Ci + n0;
        if (p.dx_vec) {  // rows of cw / 8 16-byte words
          const int V = cw / 8;
          for (int i = lane; i < rows * V; i += 32) {
            const int r = i / V, v = i - r * V;
            *reinterpret_cast<uint4*>(dst + static_cast<size_t>(r) * Ci + 8 * v) =
                *reinterpret_cast<const uint4*>(s_dx + r * DXS + 8 * v);
          }
        } else {
          for (int i = lane; i < rows * cw; i += 32) {
            const int r = i / cw, col = i - r * cw;
            dst[static_cast<size_t>(r) * Ci + col] = s_dx[r * DXS + col];
          }
        }
        __syncwarp();  // the sub-tile is read before the warp's next pass writes it
      }
    }
  }
  imgseg::cp_async_wait<0>();
  __syncthreads();

  // the warps' sums, added in warp order: one partial row per block
  float* red = reinterpret_cast<float*>(smem_raw);  // [WARPS][TPW][4][32]
#pragma unroll
  for (int j = 0; j < TPW; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) red[((warp * TPW + j) * 4 + e) * 32 + lane] = acc[j][e];
  __syncthreads();
  const int L = Ci + 1;
  float* row = p.part + static_cast<size_t>(blockIdx.x) * Co * L;
  for (int i = tid; i < TPW * 128; i += THREADS) {
    const int j = i / 128, e = (i / 32) % 4, l = i % 32, t = tbase + j;
    if (t >= T) continue;
    const int mi = t / p.nt, ni = t - mi * p.nt;
    const int co = 16 * mi + (l >> 2) + 8 * (e >> 1), col = 8 * ni + 2 * (l & 3) + (e & 1);
    if (co >= Co || col >= L) continue;
    float sum = 0.f;
    for (int w = 0; w < WARPS; ++w) sum += red[((w * TPW + j) * 4 + e) * 32 + l];
    row[co * L + col] = sum;
  }
}

// Channel widths of a launch, and whether each operand goes straight into
// its padded rows (`aligned`: the tensor starts on a 16-byte boundary).
Args widths(long long npix, int Ci, int Co, bool x_aligned, bool g_aligned) {
  Args p{};
  p.npix = npix, p.Ci = Ci, p.Co = Co;
  p.xn = round_up(Ci + 1, 8), p.gn = round_up(Co, 16), p.wn = round_up(Ci, 16);
  p.xs = padded(p.xn), p.gs = padded(p.gn), p.ws = padded(p.wn);
  p.mt = p.gn / 16, p.nt = p.xn / 8;
  p.x_vec = x_aligned, p.g_vec = g_aligned;
  p.x_direct = x_aligned && Ci % 8 == 0;
  p.g_direct = g_aligned && Co % 8 == 0;
  return p;
}

struct Plan {
  int P, tpw, ygroups;
  long long tiles, chunks, per_chunk;
  cudaError_t err;
};

template <int TPW>
cudaError_t kernel_ready(size_t bytes, int& resident) {
  static bool opted = false;
  auto* kernel = conv1x1_bwd_kernel<TPW>;
  const cudaError_t err = imgseg::allow_smem(kernel, MAX_SMEM, opted);
  return err != cudaSuccess ? err : imgseg::resident_blocks(kernel, THREADS, bytes, resident);
}

// The tile, chunks and table split of a launch, from the shapes alone (the
// scratch query knows no pointers): laid out for aligned operands with dx.
// An unaligned launch keeps them and lays out its raw slots beside.
Plan plan(long long npix, int Ci, int Co) {
  Plan q{};
  Args p = widths(npix, Ci, Co, true, true);
  const int T = p.mt * p.nt;
  q.tpw = T <= 2 ? 2 : (T <= 4 ? 4 : TMAX);
  q.ygroups = (T + q.tpw - 1) / q.tpw;
  q.P = 256;
  size_t bytes = layout(p, q.P, true);
  while (q.P > 16 && bytes > SMEM_TARGET) bytes = layout(p, q.P /= 2, true);
  q.tiles = (npix + q.P - 1) / q.P;
  int resident = 0;
  q.err = q.tpw == 2 ? kernel_ready<2>(bytes, resident)
                     : (q.tpw == 4 ? kernel_ready<4>(bytes, resident) : kernel_ready<TMAX>(bytes, resident));
  q.chunks = imgseg::chunks_for(q.tiles, q.ygroups, resident);
  q.per_chunk = (q.tiles + q.chunks - 1) / q.chunks;
  q.chunks = (q.tiles + q.per_chunk - 1) / q.per_chunk;
  return q;
}

bool fits(long long npix, int Ci, int Co) {
  return npix > 0 && Ci > 0 && Co > 0 && static_cast<long long>(Co) * (Ci + 1) <= MAX_SUMS;
}

}  // namespace

// Floats of scratch: one (Co, Ci + 1) row of partial sums per chunk.
extern "C" long long imgseg_conv1x1_bwd_scratch(long long npix, int Ci, int Co) {
  if (!fits(npix, Ci, Co)) return 0;
  return plan(npix, Ci, Co).chunks * static_cast<long long>(Co) * (Ci + 1);
}

// dwb (Co, Ci + 1) fp32 = [dw | db]; with `dx` also the input gradient.
// x (npix, Ci), g (npix, Co), w (Co, Ci), dx (npix, Ci): bf16, contiguous.
extern "C" int imgseg_conv1x1_bwd(const void* x, const void* g, const void* w, void* dx,
                                  void* dwb, void* scratch, long long npix, int Ci, int Co,
                                  void* stream) {
  if (npix <= 0 || Ci <= 0 || Co <= 0) return static_cast<int>(cudaSuccess);
  if (!fits(npix, Ci, Co)) return static_cast<int>(cudaErrorInvalidValue);
  const Plan q = plan(npix, Ci, Co);
  if (q.err != cudaSuccess) return static_cast<int>(q.err);
  if (q.chunks > 0x7fffffffLL || q.ygroups > 65535) return static_cast<int>(cudaErrorInvalidValue);
  Args p = widths(npix, Ci, Co, aligned16(x), aligned16(g));
  p.x = static_cast<const __nv_bfloat16*>(x);
  p.g = static_cast<const __nv_bfloat16*>(g);
  p.w = static_cast<const __nv_bfloat16*>(w);
  p.dx = static_cast<__nv_bfloat16*>(dx);
  p.part = static_cast<float*>(scratch);
  p.dx_vec = dx != nullptr && aligned16(dx) && Ci % 8 == 0;
  p.tiles = q.tiles, p.per_chunk = q.per_chunk;
  const size_t bytes = layout(p, q.P, dx != nullptr);
  if (bytes > MAX_SMEM) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(q.chunks), q.ygroups);
  if (q.tpw == 2) {
    conv1x1_bwd_kernel<2><<<grid, THREADS, bytes, s>>>(p);
  } else if (q.tpw == 4) {
    conv1x1_bwd_kernel<4><<<grid, THREADS, bytes, s>>>(p);
  } else {
    conv1x1_bwd_kernel<TMAX><<<grid, THREADS, bytes, s>>>(p);
  }
  cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess) {
    err = imgseg::sum_rows(p.part, static_cast<float*>(dwb), q.chunks,
                           static_cast<long long>(Co) * (Ci + 1), s);
  }
  return static_cast<int>(err);
}
