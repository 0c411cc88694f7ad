// Multi-head cross-attention, bf16 in and out, fp32 scores:
//   out[b, l, h*dh:(h+1)*dh] = softmax_s(q_h[b,l] . k_h[b,s] * scale) @ v_h[b]
// for q (B, L, D) and k, v (B, S, D), dh = D / heads, over the S real keys.
//
// Replaces: image_segmentation_tpu/ops/cross_attention.py
// pallas_cross_attention (:82; kernel body _attn_kernel :45-79).  The TPU
// kernel pads S to a multiple of 128 and masks the padding with -inf; these
// mask the keys past S.  Its numerics are the TPU kernel's: the scores are
// fp32 sums of bf16 products times the scale, the softmax is fp32 with the
// row maximum taken out, the NORMALISED weights are rounded to v's dtype
// (:75-77) and multiplied into v with an fp32 accumulator, and the output
// is rounded to q's dtype.  An online softmax would round unnormalised
// weights and differ by a bf16 step, so the softmax is the exact one, over
// all keys at once.
//
// What bounds it on the card: memory.  At the CLIP bottleneck (B 32, L
// 1024, D 512) q and the output are 33.5 MB each, while K and V (S tokens)
// are tiny; the arithmetic, 4*B*L*S*D, is below the bytes at these S.
//
// What the design does about it (attn_mma_kernel, S <= 64): one block per
// batch image, a run of its 16-row query tiles and a group of heads (all
// of them when K/V fit), W warps of 32 (8 at the models' widths).
// - K and V of the block's heads (S rounded up to 16 keys, zeros past S,
//   rows padded to an odd number of 16-byte units for conflict-free
//   ldmatrix) are staged once in shared memory by 16-byte cp.async and
//   reused by every query tile of the run.
// - Each warp walks its own (16-row tile, head) units.  A unit's q rows
//   come in pieces of 16 rows x 64 columns through a 4-stage warp-private
//   ring of 16-byte cp.async copies that keeps 3 pieces in flight across
//   unit boundaries; no block barrier after the K/V staging.  At dh 512 a
//   unit is 8 pieces, so the Q fragments are read from the ring per k-step
//   (ldmatrix) and never held whole.
// - Scores on mma.sync m16n8k16 (bf16 in, fp32 sums): Q by ldmatrix, K (a
//   [key][d] row layout: the B operand as it lies) by ldmatrix, the keys in
//   n-tiles of 8 summed over the unit's pieces in registers.
// - The exact softmax on the accumulator fragments: keys past S masked to
//   -inf, the row max and the row sum over a lane quad (two shuffles each),
//   then the normalised weights rounded to bf16 and packed straight into
//   the A fragments of P V (the m16n8k16 accumulator layout of two key
//   n-tiles is the A layout of one k-step).
// - P V on mma.sync with V by ldmatrix.trans, 64 output columns at a time
//   (32 fp32 accumulators a lane at any dh); each 16 x 64 output sub-tile is
//   rounded once, staged in the warp's own slice and written with 16-byte
//   stores.
// Heads with dh not a multiple of 8, or operands off a 16-byte boundary,
// take element loads and stores in the same kernel.
//
// Long context (S > 64, or S past 48 at dh above 800, where one head's K
// and V do not fit in shared memory beside two warps' rings): attn_kernel,
// the first, CUDA-core design, kept as that path.  One 256-thread block per (32
// queries, head, batch), each warp owning four query rows.  The block
// stages its q rows and, up to 32 keys at a time, K and V of its head in
// shared memory as bf16, with 16-byte loads where the rows allow them.  For
// the scores the warp's lanes form groups of G = 32 / min(32, S rounded up
// to a power of two): each group takes one key, each lane of it a G-th of
// the head dimension, from 16-byte shared-memory loads, and log2(G)
// shuffles finish the dot product.  Three sweeps over the keys (the
// maximum, the sum of exponentials, the weighted sum of v); while the
// scores fit in shared memory beside the rest (up to ~1000 keys), the
// first sweep keeps them there for the other two; beyond that each sweep
// computes them again, from K staged again.  For the product with v the
// weights go through shared memory and the lanes split the head
// dimension, so the output is written once, coalesced.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "mma.cuh"

namespace {

using imgseg::cp_async16;
using imgseg::ldsm_x4;
using imgseg::ldsm_x4_trans;
using imgseg::mma_bf16;

constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_SMEM = 232448;  // bytes a block may use on Hopper (227 KB)

bool aligned16(const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16 == 0; }

// ---- the tensor-core path, S <= 64

constexpr int MMA_KEYS = 64;   // keys the scores keep in registers
constexpr int QC = 64;         // q columns per ring piece: four k-steps
constexpr int QS = QC + 8;     // row stride of a piece, and of the staged output
constexpr int NSQ = 4;         // ring depth per warp
constexpr int WARP_SMEM = (NSQ + 1) * 16 * QS;  // a warp's ring and output slice (bf16)

struct MmaArgs {
  const __nv_bfloat16* q;  // (B, L, D)
  const __nv_bfloat16* k;  // (B, S, D)
  const __nv_bfloat16* v;  // (B, S, D)
  __nv_bfloat16* out;      // (B, L, D)
  int L, S, D, dh;
  int dhp;       // dh rounded up to 16
  int kvs;       // row stride of the staged K and V: dhp + 8
  int nkeys;     // S rounded up to 16
  int heads, hg;  // heads; heads per block (grid.y groups them)
  int tpb;       // query tiles per block (grid.x runs them)
  bool vec;      // 16-byte copies and stores
  float scale;
};

__host__ __device__ size_t kv_elems(const MmaArgs& p) { return static_cast<size_t>(p.nkeys) * p.kvs; }

size_t mma_smem_bytes(const MmaArgs& p, int warps) {
  return (2 * p.hg * kv_elems(p) + static_cast<size_t>(warps) * WARP_SMEM) * sizeof(__nv_bfloat16);
}

// NKT: key k-steps of 16 (S <= 16 * NKT)
template <int NKT>
__global__ void __launch_bounds__(256) attn_mma_kernel(const MmaArgs p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* smem = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, W = blockDim.x >> 5;
  const int b = blockIdx.z, h0 = blockIdx.y * p.hg;
  const int hg = p.heads - h0 < p.hg ? p.heads - h0 : p.hg;
  const int tiles = (p.L + 15) / 16;
  const int tb0 = blockIdx.x * p.tpb;
  const int ntile = tiles - tb0 < p.tpb ? tiles - tb0 : p.tpb;
  const int dh = p.dh, dhp = p.dhp, D = p.D, kvs = p.kvs;
  const size_t kv = kv_elems(p);
  __nv_bfloat16* k_s = smem;                 // [hg][nkeys][kvs]
  __nv_bfloat16* v_s = k_s + p.hg * kv;      // [hg][nkeys][kvs]
  __nv_bfloat16* ring = v_s + p.hg * kv + static_cast<size_t>(warp) * WARP_SMEM;  // [NSQ][16][QS]
  __nv_bfloat16* o_s = ring + NSQ * 16 * QS;  // [16][QS]

  // K and V of the block's heads: keys past S and columns past dh are zeros
  {
    const size_t kv0 = static_cast<size_t>(b) * p.S * D + static_cast<size_t>(h0) * dh;
    if (p.vec) {
      const int V = dhp / 8;
      for (int i = tid; i < hg * p.nkeys * V; i += blockDim.x) {
        const int c = i % V, j = (i / V) % p.nkeys, hh = i / (V * p.nkeys);
        const bool ok = j < p.S && 8 * c < dh;
        const size_t src = kv0 + static_cast<size_t>(j) * D + hh * dh + 8 * c;
        const size_t dst = hh * kv + j * kvs + 8 * c;
        cp_async16(k_s + dst, ok ? p.k + src : p.k, ok);
        cp_async16(v_s + dst, ok ? p.v + src : p.v, ok);
      }
    } else {
      for (int i = tid; i < hg * p.nkeys * dhp; i += blockDim.x) {
        const int c = i % dhp, j = (i / dhp) % p.nkeys, hh = i / (dhp * p.nkeys);
        const bool ok = j < p.S && c < dh;
        const size_t src = kv0 + static_cast<size_t>(j) * D + hh * dh + c;
        const size_t dst = hh * kv + j * kvs + c;
        k_s[dst] = ok ? p.k[src] : __float2bfloat16(0.f);
        v_s[dst] = ok ? p.v[src] : __float2bfloat16(0.f);
      }
    }
    imgseg::cp_async_commit();
  }

  // this warp's units u = warp, warp + W, ... of the block's (tile, head)
  // pairs, each in nch pieces of 64 columns
  const int units = ntile * hg;
  const int mine = warp < units ? (units - warp + W - 1) / W : 0;
  const int nch = (dhp + QC - 1) / QC;
  const int pieces = mine * nch;
  auto unit_of = [&](int i, int& row0, int& head) {
    const int u = warp + (i / nch) * W;
    row0 = (tb0 + u / hg) * 16;
    head = u % hg;
  };
  // piece i of this warp into ring slot `slot`: 16 rows x 64 columns of
  // q, zeros past L and past dh
  auto fetch = [&](int i) {
    if (i >= pieces) return;
    int row0, head;
    unit_of(i, row0, head);
    const int c0 = (i % nch) * QC;
    __nv_bfloat16* dst = ring + (i % NSQ) * 16 * QS;
    const size_t base = (static_cast<size_t>(b) * p.L + row0) * D + static_cast<size_t>(h0 + head) * dh;
    if (p.vec) {
#pragma unroll
      for (int j = lane; j < 16 * QC / 8; j += 32) {
        const int r = j / (QC / 8), c = c0 + 8 * (j % (QC / 8));
        if (c >= dhp) continue;
        const bool ok = row0 + r < p.L && c < dh;
        cp_async16(dst + r * QS + c - c0, ok ? p.q + base + static_cast<size_t>(r) * D + c : p.q, ok);
      }
    } else {
      for (int j = lane; j < 16 * QC; j += 32) {
        const int r = j / QC, c = c0 + j % QC;
        if (c >= dhp) continue;
        const bool ok = row0 + r < p.L && c < dh;
        dst[r * QS + c - c0] = ok ? p.q[base + static_cast<size_t>(r) * D + c] : __float2bfloat16(0.f);
      }
    }
  };
#pragma unroll
  for (int i = 0; i < NSQ - 1; ++i) {
    fetch(i);
    imgseg::cp_async_commit();
  }
  imgseg::cp_async_wait<NSQ - 1>();  // K and V are in (this thread's copies)
  __syncthreads();                   // (every thread's)

  // ldmatrix rows: Q (row, k half); K (key, k half); V trans (key, column half)
  const int a_row = (lane & 7) + ((lane >> 3) & 1) * 8, a_k = (lane >> 4) * 8;
  const int k_key = (lane & 7) + (lane >> 4) * 8, k_d = ((lane >> 3) & 1) * 8;
  const int v_key = (lane & 7) + ((lane >> 3) & 1) * 8, v_d = (lane >> 4) * 8;

  float s[2 * NKT][4];
  for (int i = 0; i < pieces; ++i) {
    imgseg::cp_async_wait<NSQ - 2>();
    __syncwarp();  // piece i is in for every lane; every lane is done with piece i - 1's slot
    fetch(i + NSQ - 1);
    imgseg::cp_async_commit();
    int row0, head;
    unit_of(i, row0, head);
    const int c0 = (i % nch) * QC;
    const __nv_bfloat16* qs = ring + (i % NSQ) * 16 * QS;
    const __nv_bfloat16* ks = k_s + head * kv;
    if (c0 == 0) {
#pragma unroll
      for (int n = 0; n < 2 * NKT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < QC; kk += 16) {
      if (c0 + kk >= dhp) break;
      uint32_t a[4];
      ldsm_x4(a, qs + a_row * QS + kk + a_k);
#pragma unroll
      for (int np = 0; np < NKT; ++np) {
        uint32_t r[4];
        ldsm_x4(r, ks + (16 * np + k_key) * kvs + c0 + kk + k_d);
        mma_bf16(s[2 * np], a, r[0], r[1]);
        mma_bf16(s[2 * np + 1], a, r[2], r[3]);
      }
    }
    if (c0 + QC < dhp) continue;  // the unit's scores are not complete yet

    // the exact softmax of rows lane/4 (e 0, 1) and lane/4 + 8 (e 2, 3)
    float m[2] = {-INFINITY, -INFINITY}, sum[2] = {0.f, 0.f};
#pragma unroll
    for (int n = 0; n < 2 * NKT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = 8 * n + 2 * (lane & 3) + (e & 1);
        s[n][e] = key < p.S ? __fmul_rn(s[n][e], p.scale) : -INFINITY;
        m[e >> 1] = fmaxf(m[e >> 1], s[n][e]);
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      m[h] = fmaxf(m[h], __shfl_xor_sync(FULL, m[h], 1));
      m[h] = fmaxf(m[h], __shfl_xor_sync(FULL, m[h], 2));
    }
#pragma unroll
    for (int n = 0; n < 2 * NKT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = expf(s[n][e] - m[e >> 1]);  // 0 at the masked keys
        sum[e >> 1] = __fadd_rn(sum[e >> 1], s[n][e]);
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      sum[h] = __fadd_rn(sum[h], __shfl_xor_sync(FULL, sum[h], 1));
      sum[h] = __fadd_rn(sum[h], __shfl_xor_sync(FULL, sum[h], 2));
    }
    // the normalised weights, rounded to bf16, as the A fragments of P V
    uint32_t pa[NKT][4];
#pragma unroll
    for (int kt = 0; kt < NKT; ++kt)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float* c = s[2 * kt + (r >> 1)] + 2 * (r & 1);
        const __nv_bfloat162 w = __floats2bfloat162_rn(__fdiv_rn(c[0], sum[r & 1]),
                                                       __fdiv_rn(c[1], sum[r & 1]));
        pa[kt][r] = *reinterpret_cast<const uint32_t*>(&w);
      }

    // out = P V, 64 columns at a time
    const __nv_bfloat16* vs = v_s + head * kv;
    const size_t obase =
        (static_cast<size_t>(b) * p.L + row0) * D + static_cast<size_t>(h0 + head) * dh;
    const int rows = p.L - row0 < 16 ? p.L - row0 : 16;
    for (int o0 = 0; o0 < dhp; o0 += 64) {
      float o[8][4];
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
#pragma unroll
      for (int kt = 0; kt < NKT; ++kt)
#pragma unroll
        for (int pr = 0; pr < 4; ++pr) {
          if (o0 + 16 * pr >= dhp) break;
          uint32_t r[4];
          ldsm_x4_trans(r, vs + (16 * kt + v_key) * kvs + o0 + 16 * pr + v_d);
          mma_bf16(o[2 * pr], pa[kt], r[0], r[1]);
          mma_bf16(o[2 * pr + 1], pa[kt], r[2], r[3]);
        }
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          *reinterpret_cast<__nv_bfloat162*>(o_s + ((lane >> 2) + 8 * h) * QS + 8 * n + 2 * (lane & 3)) =
              __floats2bfloat162_rn(o[n][2 * h], o[n][2 * h + 1]);
        }
      __syncwarp();
      const int cw = dh - o0 < 64 ? dh - o0 : 64;
      if (p.vec) {  // cw is a multiple of 8
        const int V = cw / 8;
        for (int j = lane; j < rows * V; j += 32) {
          const int r = j / V, c = 8 * (j - r * V);
          *reinterpret_cast<uint4*>(p.out + obase + static_cast<size_t>(r) * D + o0 + c) =
              *reinterpret_cast<const uint4*>(o_s + r * QS + c);
        }
      } else {
        for (int j = lane; j < rows * cw; j += 32) {
          const int r = j / cw, c = j - r * cw;
          p.out[obase + static_cast<size_t>(r) * D + o0 + c] = o_s[r * QS + c];
        }
      }
      __syncwarp();  // the slice is read before the next columns are staged
    }
  }
  imgseg::cp_async_wait<0>();
}

template <int NKT>
int launch_mma(MmaArgs& p, int B, int warps, cudaStream_t stream) {
  static bool opted = false;
  auto* kernel = attn_mma_kernel<NKT>;
  const size_t bytes = mma_smem_bytes(p, warps);
  cudaError_t err = imgseg::allow_smem(kernel, MAX_SMEM, opted);
  int resident = 0;
  if (err == cudaSuccess) err = imgseg::resident_blocks(kernel, 32 * warps, bytes, resident);
  if (err != cudaSuccess) return static_cast<int>(err);
  // about one wave: the query tiles of an image split into runs
  const int groups = (p.heads + p.hg - 1) / p.hg;
  const int tiles = (p.L + 15) / 16;
  long long runs = resident / (static_cast<long long>(B) * groups);
  runs = runs < 1 ? 1 : (runs > tiles ? tiles : runs);
  p.tpb = static_cast<int>((tiles + runs - 1) / runs);
  const dim3 grid((tiles + p.tpb - 1) / p.tpb, groups, B);
  kernel<<<grid, 32 * warps, bytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// The tensor-core path if it takes this shape: S <= 64 and one head's K and
// V beside at least two warps' rings; else -1.
int try_mma(const void* q, const void* k, const void* v, void* out, int B, int L, int S, int D,
            int heads, float scale, cudaStream_t stream) {
  if (S > MMA_KEYS) return -1;
  MmaArgs p{};
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.L = L, p.S = S, p.D = D, p.dh = D / heads, p.heads = heads, p.scale = scale;
  p.dhp = (p.dh + 15) / 16 * 16;
  p.kvs = p.dhp + 8;
  p.nkeys = (S + 15) / 16 * 16;
  p.vec = p.dh % 8 == 0 && D % 8 == 0 && aligned16(q) && aligned16(k) && aligned16(v) &&
          aligned16(out);
  int warps = 8;
  p.hg = 1;
  while (warps > 2 && mma_smem_bytes(p, warps) > MAX_SMEM) warps /= 2;
  if (mma_smem_bytes(p, warps) > MAX_SMEM) return -1;
  // as many heads a block as fit beside the rings
  const size_t room = MAX_SMEM - static_cast<size_t>(warps) * WARP_SMEM * sizeof(__nv_bfloat16);
  const size_t per_head = 2 * kv_elems(p) * sizeof(__nv_bfloat16);
  p.hg = static_cast<int>(room / per_head < static_cast<size_t>(heads) ? room / per_head : heads);
  if (S <= 16) return launch_mma<1>(p, B, warps, stream);
  if (S <= 32) return launch_mma<2>(p, B, warps, stream);
  if (S <= 48) return launch_mma<3>(p, B, warps, stream);
  return launch_mma<4>(p, B, warps, stream);
}

// ---- the long-context path

constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int KC = 32;            // keys per chunk: one per lane
constexpr size_t KEPT_SMEM = 200 * 1024;  // bytes of shared memory that keeping the scores may take

struct Args {
  const __nv_bfloat16* q;  // (B, L, D)
  const __nv_bfloat16* k;  // (B, S, D)
  const __nv_bfloat16* v;  // (B, S, D)
  __nv_bfloat16* out;      // (B, L, D)
  int L, S, D, dh;
  int dhp;                 // dh rounded up to a multiple of 8 (q and v rows in shared memory)
  int dhk;                 // dhp + 8: the K rows' stride, which spreads the lanes over banks
  int kc;                  // keys staged per chunk: min(KC, S)
  int g;                   // lanes per key in the scores: 32 / min(32, S rounded up to 2^n)
  bool vec;                // rows of 16-byte aligned, whole groups of 8 elements
  int kept;                // the first sweep's scores kept in shared memory: S rounded up to KC, or 0
  float scale;
};

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(FULL, x, off);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(FULL, x, off));
  return x;
}

// 8 bf16 in a 16-byte word -> 4 pairs of floats
__device__ __forceinline__ void unpack8(const uint4& w, float (&f)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&w);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

// DPL: head-dimension elements per lane in the product with v, dh <= 32 * DPL;
// QPW: query rows per warp.
template <int DPL, int QPW>
__global__ void __launch_bounds__(THREADS) attn_kernel(const Args p) {
  constexpr int TQ = WARPS * QPW;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem);   // [TQ][dhp]
  __nv_bfloat16* k_s = q_s + TQ * p.dhp;                           // [kc][dhk]
  __nv_bfloat16* v_s = k_s + p.kc * p.dhk;                         // [kc][dhp]
  float* w_s = reinterpret_cast<float*>(v_s + p.kc * p.dhp);       // [WARPS][QPW][KC]
  float* s_s = w_s + WARPS * QPW * KC;                             // [WARPS][QPW][kept]

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int h = blockIdx.y, b = blockIdx.z;
  const int dh = p.dh, dhp = p.dhp, D = p.D, S = p.S;
  const size_t head = static_cast<size_t>(h) * dh;
  const int row0 = blockIdx.x * TQ;

  // the block's q rows (zero past L and past dh)
  if (p.vec) {
    for (int i = threadIdx.x; i < TQ * dhp / 8; i += THREADS) {
      const int r = i / (dhp / 8), d = i % (dhp / 8) * 8, l = row0 + r;
      reinterpret_cast<uint4*>(q_s)[i] =
          l < p.L ? *reinterpret_cast<const uint4*>(p.q + (static_cast<size_t>(b) * p.L + l) * D + head + d)
                  : make_uint4(0, 0, 0, 0);
    }
  } else {
    for (int i = threadIdx.x; i < TQ * dhp; i += THREADS) {
      const int r = i / dhp, d = i % dhp, l = row0 + r;
      q_s[i] = (l < p.L && d < dh) ? p.q[(static_cast<size_t>(b) * p.L + l) * D + head + d]
                                   : __float2bfloat16(0.f);
    }
  }

  // scores of this lane's key (lane / g) against the warp's rows from the
  // staged chunk; the g lanes of a key split the head dimension
  const int G = p.g, key = lane / G, part = lane % G;
  auto scores = [&](int sc, float (&s)[QPW]) {
#pragma unroll
    for (int r = 0; r < QPW; ++r) s[r] = 0.f;
    if (key < sc) {
      const uint4* kr = reinterpret_cast<const uint4*>(k_s + key * p.dhk);
      for (int c = part; c < dhp / 8; c += G) {
        float kf[8];
        unpack8(kr[c], kf);
#pragma unroll
        for (int r = 0; r < QPW; ++r) {
          float qf[8];
          unpack8(reinterpret_cast<const uint4*>(q_s + (warp * QPW + r) * dhp)[c], qf);
#pragma unroll
          for (int e = 0; e < 8; ++e) s[r] = fmaf(qf[e], kf[e], s[r]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < QPW; ++r) {
      for (int off = G / 2; off > 0; off >>= 1) s[r] += __shfl_xor_sync(FULL, s[r], off);
      s[r] = __fmul_rn(s[r], p.scale);
    }
  };
  auto stage = [&](int c0, int sc, bool with_k, bool with_v) {
    __syncthreads();  // every warp is done with the previous chunk
    const size_t kv0 = static_cast<size_t>(b) * S + c0;
    if (p.vec) {
      const uint4 zero = make_uint4(0, 0, 0, 0);
      for (int i = threadIdx.x; i < p.kc * dhp / 8; i += THREADS) {
        const int j = i / (dhp / 8), d = i % (dhp / 8) * 8;
        const size_t g = (kv0 + j) * D + head + d;
        if (with_k) {
          *reinterpret_cast<uint4*>(k_s + j * p.dhk + d) =
              j < sc ? *reinterpret_cast<const uint4*>(p.k + g) : zero;
        }
        if (with_v) {
          *reinterpret_cast<uint4*>(v_s + j * dhp + d) =
              j < sc ? *reinterpret_cast<const uint4*>(p.v + g) : zero;
        }
      }
    } else {
      for (int i = threadIdx.x; i < p.kc * dhp; i += THREADS) {
        const int j = i / dhp, d = i % dhp;
        const bool in = j < sc && d < dh;
        const size_t g = (kv0 + j) * D + head + d;
        if (with_k) k_s[j * p.dhk + d] = in ? p.k[g] : __float2bfloat16(0.f);
        if (with_v) v_s[j * dhp + d] = in ? p.v[g] : __float2bfloat16(0.f);
      }
    }
    __syncthreads();
  };

  float m[QPW], sum[QPW], s[QPW], acc[QPW][DPL];
#pragma unroll
  for (int r = 0; r < QPW; ++r) {
    m[r] = -INFINITY;
    sum[r] = 0.f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[r][i] = 0.f;
  }
  const int nchunks = (S + p.kc - 1) / p.kc;
  const bool kept = p.kept > 0;
  float* s_row = s_s + warp * QPW * p.kept;
  for (int pass = 0; pass < 3; ++pass) {
    for (int c = 0; c < nchunks; ++c) {
      const int c0 = c * p.kc, sc = min(p.kc, S - c0);
      // a key's g lanes hold the same score: the sum counts its first lane
      const bool valid = key < sc, first = valid && part == 0;
      if (pass == 0 || (nchunks > 1 && !kept)) {
        // one chunk: K and V staged once; else K per sweep, V in the last
        stage(c0, sc, true, pass == 2 || nchunks == 1);
        scores(sc, s);
        if (kept && first) {
#pragma unroll
          for (int r = 0; r < QPW; ++r) s_row[r * p.kept + c0 + key] = s[r];
        }
      } else if (kept) {
        if (pass == 2) stage(c0, sc, false, true);
        __syncwarp();
#pragma unroll
        for (int r = 0; r < QPW; ++r) s[r] = valid ? s_row[r * p.kept + c0 + key] : 0.f;
      }  // else one chunk: the scores are still in registers
#pragma unroll
      for (int r = 0; r < QPW; ++r) {
        if (pass == 0) {
          m[r] = fmaxf(m[r], warp_max(valid ? s[r] : -INFINITY));
        } else if (pass == 1) {
          sum[r] = __fadd_rn(sum[r], warp_sum(first ? expf(s[r] - m[r]) : 0.f));
        } else if (first) {
          // the normalised weight, rounded to v's dtype
          w_s[(warp * QPW + r) * KC + key] =
              __bfloat162float(__float2bfloat16(__fdiv_rn(expf(s[r] - m[r]), sum[r])));
        }
      }
      if (pass == 2) {
        __syncwarp();
        for (int j = 0; j < sc; ++j) {
          float vv[DPL];
#pragma unroll
          for (int i = 0; i < DPL; ++i) {
            const int d = lane + 32 * i;
            vv[i] = d < dh ? __bfloat162float(v_s[j * dhp + d]) : 0.f;
          }
#pragma unroll
          for (int r = 0; r < QPW; ++r) {
            const float w = w_s[(warp * QPW + r) * KC + j];
#pragma unroll
            for (int i = 0; i < DPL; ++i) acc[r][i] = fmaf(w, vv[i], acc[r][i]);
          }
        }
        __syncwarp();
      }
    }
  }

#pragma unroll
  for (int r = 0; r < QPW; ++r) {
    const int l = row0 + warp * QPW + r;
    if (l >= p.L) continue;
    const size_t base = (static_cast<size_t>(b) * p.L + l) * D + head;
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      const int d = lane + 32 * i;
      if (d < dh) p.out[base + d] = __float2bfloat16(acc[r][i]);
    }
  }
}

size_t smem_bytes(const Args& p, int qpw) {
  return (static_cast<size_t>(WARPS) * qpw * p.dhp + static_cast<size_t>(p.kc) * (p.dhk + p.dhp)) *
             sizeof(__nv_bfloat16) +
         static_cast<size_t>(WARPS) * qpw * (KC + p.kept) * sizeof(float);
}

template <int DPL, int QPW>
int launch(const Args& p, int B, int heads, cudaStream_t stream) {
  const size_t bytes = smem_bytes(p, QPW);
  cudaError_t err = cudaFuncSetAttribute(attn_kernel<DPL, QPW>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((p.L + WARPS * QPW - 1) / (WARPS * QPW), heads, B);
  attn_kernel<DPL, QPW><<<grid, THREADS, bytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int DPL>
int launch_rows(Args& p, int B, int heads, cudaStream_t stream) {
  p.kept = (p.S + KC - 1) / KC * KC;
  if (smem_bytes(p, 4) > KEPT_SMEM) p.kept = 0;
  return launch<DPL, 4>(p, B, heads, stream);
}


}  // namespace

// out (B, L, D) = multi-head softmax(q k^T * scale) v; q (B, L, D), k and v
// (B, S, D), all bf16.  The head dimension D / heads must be at most 1024.
extern "C" int imgseg_cross_attention(const void* q, const void* k, const void* v, void* out,
                                      int B, int L, int S, int D, int heads, float scale,
                                      void* stream) {
  if (B <= 0 || L <= 0 || D <= 0) return static_cast<int>(cudaSuccess);
  if (S <= 0 || heads <= 0 || D % heads != 0) return static_cast<int>(cudaErrorInvalidValue);
  const int dh = D / heads;
  if (dh > 1024 || B > 65535 || heads > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int mma = try_mma(q, k, v, out, B, L, S, D, heads, scale, s);
  if (mma >= 0) return mma;
  Args p{};
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.L = L, p.S = S, p.D = D, p.dh = dh, p.scale = scale;
  p.dhp = (dh + 7) / 8 * 8;
  p.dhk = p.dhp + 8;
  p.kc = S < KC ? S : KC;
  int keys = 1;
  while (keys < p.kc) keys *= 2;
  p.g = 32 / keys;
  p.kept = 0;
  p.vec = dh % 8 == 0 && D % 8 == 0 && aligned16(q) && aligned16(k) && aligned16(v);
  if (dh <= 32) return launch_rows<1>(p, B, heads, s);
  if (dh <= 64) return launch_rows<2>(p, B, heads, s);
  if (dh <= 128) return launch_rows<4>(p, B, heads, s);
  if (dh <= 256) return launch_rows<8>(p, B, heads, s);
  if (dh <= 512) return launch_rows<16>(p, B, heads, s);
  return launch_rows<32>(p, B, heads, s);
}
