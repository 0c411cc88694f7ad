// Multi-head cross-attention, bf16 in and out, fp32 scores:
//   out[b, l, h*dh:(h+1)*dh] = softmax_s(q_h[b,l] . k_h[b,s] * scale) @ v_h[b]
// for q (B, L, D) and k, v (B, S, D), dh = D / heads, over the S real keys.
//
// Replaces: image_segmentation_tpu/ops/cross_attention.py
// pallas_cross_attention (:82; kernel body _attn_kernel :45-79).  The TPU
// kernel pads S to a multiple of 128 and masks the padding with -inf; this
// one reduces over the S keys only.  Its numerics are the TPU kernel's: the
// scores are fp32 sums of bf16 products times the scale, the softmax is
// fp32 with the row maximum taken out, the NORMALISED weights are rounded
// to v's dtype (:75-77) and multiplied into v with an fp32 accumulator, and
// the output is rounded to q's dtype.  An online softmax would round
// unnormalised weights and differ by a bf16 step, so each row takes three
// sweeps over its keys: the maximum, then the sum of exponentials, then the
// weighted sum of v.
//
// What bounds it on the card: memory.  At the CLIP bottleneck (B 32, L
// 1024, D 512) q and the output are 33.5 MB each, while K and V (S tokens)
// are tiny; the arithmetic, 4*B*L*S*D, is below the bytes at these S.
//
// What the design does about it: one 256-thread block per (32 queries,
// head, batch), each warp owning four query rows; with at most 32 keys, 16
// queries and two rows a warp (fewer registers, more blocks in flight).  The block stages its q
// rows and, up to 32 keys at a time, K and V of its head in shared memory
// as bf16, with 16-byte loads where the rows allow them.  For the scores
// the warp's lanes form groups of G = 32 / min(32, S rounded up to a power
// of two): each group takes one key, each lane of it a G-th of the head
// dimension, from 16-byte shared-memory loads (the q rows are read by all
// lanes at once, a broadcast; the K rows are padded so the lanes' loads
// fall in distinct banks), and log2(G) shuffles finish the dot product, so
// a long context needs no shuffle per score and a short one keeps every
// lane busy.  One warp reduction per chunk gives the maximum and the sum.
// When the keys fit one chunk (S <= 32) the scores stay in registers for
// all three sweeps; else, while they fit in shared memory beside the rest
// (up to ~1000 keys), the first sweep keeps them there for the other two
// (each warp its own rows); beyond that each sweep computes them again,
// from K staged again.  For the
// product with v the weights go through shared memory and the lanes split
// the head dimension, so the output is written once, coalesced.  Tensor
// cores, TMA and keeping more query rows per K/V load are left for later
// work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int KC = 32;            // keys per chunk: one per lane
constexpr size_t KEPT_SMEM = 200 * 1024;  // bytes of shared memory that keeping the scores may take
constexpr unsigned FULL = 0xffffffffu;

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
  if (p.S <= KC) return launch<DPL, 2>(p, B, heads, stream);
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
  p.vec = dh % 8 == 0 && D % 8 == 0 && reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
          reinterpret_cast<uintptr_t>(k) % 16 == 0 && reinterpret_cast<uintptr_t>(v) % 16 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dh <= 32) return launch_rows<1>(p, B, heads, s);
  if (dh <= 64) return launch_rows<2>(p, B, heads, s);
  if (dh <= 128) return launch_rows<4>(p, B, heads, s);
  if (dh <= 256) return launch_rows<8>(p, B, heads, s);
  if (dh <= 512) return launch_rows<16>(p, B, heads, s);
  return launch_rows<32>(p, B, heads, s);
}
