// Tensor-core and asynchronous-copy primitives shared by the tensor-core
// kernels (conv3x3.cu, conv3x3_bwd.cu, convtranspose.cu, conv1x1_bwd.cu,
// cross_attention.cu): ldmatrix, mma.sync m16n8k16 in bf16 with
// fp32 sums, Hopper's wgmma with shared-memory descriptors (the conv
// kernels' vector and deep paths) and the vector paths' row streams,
// cp.async with zero fill, bulk copies on an mbarrier, 8-wide
// bf16 vector helpers, the operand transforms applied on load, and the
// narrow conv paths' staging of operands of any channel count and
// alignment.
//
// Fragment layouts (PTX ISA, "mma.m16n8k16"): lane l holds A elements
// (row l/4 [+8], cols 2(l%4)+{0,1} [+8]) in 4 registers, B elements
// (rows 2(l%4)+{0,1} [+8], col l/4) in 2, and C/D elements (row l/4 [+8],
// cols 2(l%4)+{0,1}) in 4 floats: c0, c1 on row l/4, c2, c3 on row l/4+8.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace imgseg {
namespace {  // one internal copy per translation unit

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8x8 b16 matrices; lane 8j + r gives the address of row r of matrix j.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

// The same, each matrix transposed on the way into the registers.
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

// Two 8x8 b16 matrices, transposed; lanes 0-15 give the row addresses
// (lane 8j + r: row r of matrix j), the others are ignored.
__device__ __forceinline__ void ldsm_x2_trans(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p))
               : "memory");
}

// d += a (16x16, row) * b (16x8, col): bf16 products, fp32 sums.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16 bytes global -> shared without passing through registers; zeros
// instead when !valid (src is then not read, but must be a valid address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Arrive on `bar` once all of this thread's cp.async copies so far have
// landed (the barrier counts the thread's arrival among its expected ones).
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// Wait until at most N of this thread's committed groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ---- Hopper's bulk copy (the TMA engine, no tensor map): one instruction
// copies a contiguous global range (16-byte aligned, a multiple of 16 bytes)
// into shared memory and counts its bytes on an mbarrier.
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count) : "memory");
}

// Expect `bytes` more of this phase's copies on the barrier.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.expect_tx.relaxed.cta.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("{\n.reg .b64 st;\nmbarrier.arrive.shared::cta.b64 st, [%0];\n}\n" ::"r"(smem_u32(bar))
               : "memory");
}

// Wait for the barrier's phase of this parity to complete.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n.reg .pred done;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// Order this thread's earlier shared-memory accesses before the bulk
// copies it issues next (the copies are in another proxy).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
          smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Ask for a contiguous global range (16-byte aligned, a multiple of 16
// bytes) to be brought into L2: one instruction, nothing waits for it.
__device__ __forceinline__ void prefetch_l2(const void* src, uint32_t bytes) {
  asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;\n" ::"l"(src), "r"(bytes) : "memory");
}

// 8 bf16 <-> 16 bytes
struct Vec8 {
  __nv_bfloat16 v[8];
};

__device__ __forceinline__ Vec8 as_vec8(const uint4& raw) {
  Vec8 out;
  *reinterpret_cast<uint4*>(out.v) = raw;
  return out;
}

__device__ __forceinline__ uint4 as_raw(const Vec8& v) { return *reinterpret_cast<const uint4*>(v.v); }

// 8 consecutive entries of an fp32 per-channel row, out[k] = row[c + k],
// in two 16-byte loads (row + c must be 16-byte aligned).
__device__ __forceinline__ void load_row8(const float* row, int c, float (&out)[8]) {
  const float4 lo = __ldg(reinterpret_cast<const float4*>(row + c));
  const float4 hi = __ldg(reinterpret_cast<const float4*>(row + c + 4));
  out[0] = lo.x, out[1] = lo.y, out[2] = lo.z, out[3] = lo.w;
  out[4] = hi.x, out[5] = hi.y, out[6] = hi.z, out[7] = hi.w;
}

// ---- the BatchNorm transforms the conv kernels apply to an operand while
// staging it, 8 channels c.. of one pixel at a time, each mul and add
// rounded separately as the plain PyTorch versions do (so ReLU masks agree
// bit for bit); per-channel rows of width C.

// round(relu(x*a + b)) of 8 channels, with their a and b.
__device__ __forceinline__ uint4 affine_relu8(const float (&a)[8], const float (&b)[8],
                                              const uint4& raw) {
  const Vec8 x = as_vec8(raw);
  Vec8 out;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const float t = __fadd_rn(__fmul_rn(__bfloat162float(x.v[k]), a[k]), b[k]);
    out.v[k] = __float2bfloat16(fmaxf(t, 0.f));
  }
  return as_raw(out);
}

// The same, with rows ab = [a, b].
__device__ __forceinline__ uint4 affine_relu8(const float* ab, int C, int c, const uint4& raw) {
  float a[8], b[8];
  load_row8(ab, c, a);
  load_row8(ab + C, c, b);
  return affine_relu8(a, b, raw);
}

// The transformed cotangent of a BatchNorm'd conv output y: round(g + c1 +
// 2*y*c2); with AFFINE round(g*a*[y*a + b > 0] + c1 + 2*y*c2).  r holds
// the rows [c1, c2], or [a, b, c1, c2] with AFFINE.
template <bool AFFINE>
__device__ __forceinline__ uint4 cotangent8(const float (&r)[4][8], const uint4& graw,
                                            const uint4& yraw) {
  const Vec8 g = as_vec8(graw), y = as_vec8(yraw);
  constexpr int R = AFFINE ? 2 : 0;
  Vec8 out;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const float gv = __bfloat162float(g.v[k]), yv = __bfloat162float(y.v[k]);
    float t = gv;
    if constexpr (AFFINE) t = __fadd_rn(__fmul_rn(yv, r[0][k]), r[1][k]) > 0.f ? __fmul_rn(gv, r[0][k]) : 0.f;
    out.v[k] = __float2bfloat16(
        __fadd_rn(__fadd_rn(t, r[R][k]), __fmul_rn(__fmul_rn(2.f, yv), r[R + 1][k])));
  }
  return as_raw(out);
}

// The same, with rows gf = [c1, c2] or, with AFFINE, [a, b, c1, c2] of width C.
template <bool AFFINE>
__device__ __forceinline__ uint4 cotangent8(const float* gf, int C, int c, const uint4& graw,
                                            const uint4& yraw) {
  float r[4][8];
#pragma unroll
  for (int i = 0; i < (AFFINE ? 4 : 2); ++i) load_row8(gf + i * C, c, r[i]);
  return cotangent8<AFFINE>(r, graw, yraw);
}

// The two transforms with their rows in shared memory (row i at rows + i *
// stride, channel c + k at [c + k], 16-byte aligned), read 4 channels at a
// time: the vector paths' consumer warps apply them, whose registers hold
// their accumulators.
__device__ __forceinline__ float lane4(const float4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

__device__ __forceinline__ uint4 affine_relu8_shared(const float* rows, int stride, int c,
                                                     const uint4& raw) {
  const Vec8 x = as_vec8(raw);
  Vec8 out;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float4 a = *reinterpret_cast<const float4*>(rows + c + 4 * h);
    const float4 b = *reinterpret_cast<const float4*>(rows + stride + c + 4 * h);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float t = __fadd_rn(__fmul_rn(__bfloat162float(x.v[4 * h + k]), lane4(a, k)), lane4(b, k));
      out.v[4 * h + k] = __float2bfloat16(fmaxf(t, 0.f));
    }
  }
  return as_raw(out);
}

template <bool AFFINE>
__device__ __forceinline__ uint4 cotangent8_shared(const float* rows, int stride, int c,
                                                   const uint4& graw, const uint4& yraw) {
  const Vec8 g = as_vec8(graw), y = as_vec8(yraw);
  constexpr int R = AFFINE ? 2 : 0;
  Vec8 out;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float4 r[4];
#pragma unroll
    for (int i = 0; i < (AFFINE ? 4 : 2); ++i) {
      r[i] = *reinterpret_cast<const float4*>(rows + i * stride + c + 4 * h);
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float gv = __bfloat162float(g.v[4 * h + k]), yv = __bfloat162float(y.v[4 * h + k]);
      float t = gv;
      if constexpr (AFFINE) {
        t = __fadd_rn(__fmul_rn(yv, lane4(r[0], k)), lane4(r[1], k)) > 0.f ? __fmul_rn(gv, lane4(r[0], k)) : 0.f;
      }
      out.v[4 * h + k] = __float2bfloat16(
          __fadd_rn(__fadd_rn(t, lane4(r[R], k)), __fmul_rn(__fmul_rn(2.f, yv), lane4(r[R + 1], k))));
    }
  }
  return as_raw(out);
}

// ---- the narrow path of the conv kernels: operands whose channel count is
// not a multiple of 8, or that do not start on a 16-byte boundary, staged 8
// channels of a pixel at a time into rows padded to a multiple of 8 channels.

__device__ __forceinline__ uint4 or4(const uint4& a, const uint4& b) {
  return make_uint4(a.x | b.x, a.y | b.y, a.z | b.z, a.w | b.w);
}

// ---- runs: the stretches of an NHWC operand that a tile needs, copied
// into shared memory as they lie in global memory, one bulk copy a run
// (aligned down to 16 bytes at the head, up at the tail: a 16-byte block
// that holds a wanted byte lies on the tensor's own pages), then placed 8
// channels of a pixel at a time into the padded rows the mma reads (the
// conv kernels' narrow paths).

// A tile: rows x cols pixels from (gy0, gx0) of the image whose first row
// is img (n * H).
struct Tile {
  int gy0, gx0, rows, cols, H, W;
  size_t img;
};

// The channels [lo, lo + n) of a C-channel operand that a block takes (n
// <= 0: none), and where its runs land: `whole` (all C channels, one stage)
// one run a tile row, else one run a pixel (n <= 32); each run in a slot
// of `slot` bytes of raw, starting mis[s] bytes into its first 16.
struct Src {
  const __nv_bfloat16* ptr;
  int C, lo, n;
  bool whole;
  int slot;
  unsigned char* raw;
  unsigned char* mis;
};

__device__ __forceinline__ Src src_of(const __nv_bfloat16* ptr, int C, int lo, int hi, bool single,
                                      int cols, unsigned char* raw, unsigned char* mis) {
  Src r{ptr, C, lo, hi - lo, false, 0, raw, mis};
  r.whole = single && lo == 0 && r.n == C;
  const int len = r.whole ? cols * C : 32;  // elements of a run, at most
  r.slot = r.n > 0 ? (2 * len + 14 + 15) / 16 * 16 : 0;
  return r;
}

// Shared-memory bytes of the runs of a C-channel operand over a rows x
// cols tile (as src_of lays them out).
__host__ __device__ inline int raw_bytes(int C, bool single, int rows, int cols) {
  if (C <= 0) return 0;
  return single ? rows * ((2 * cols * C + 29) / 16 * 16) : rows * cols * 80;
}

// Start the copies of an operand's runs over a tile, by the lanes of one
// warp: a bulk copy a run (aligned down at the head, up at the tail), its
// bytes expected on `bar` before it is issued; each run's offset within its
// first 16 bytes goes to mis.  The warp then arrives on `bar` once
// (issue_arrive) and every thread waits for the phase (mbar_wait).
__device__ __forceinline__ void issue_runs(const Src& r, const Tile& t, int lane, uint64_t* bar) {
  if (r.n <= 0) return;
  const int nruns = r.whole ? t.rows : t.rows * t.cols;
  for (int s = lane; s < nruns; s += 32) {
    long long eb, ee;
    if (r.whole) {
      const int gy = t.gy0 + s;
      const int xa = max(t.gx0, 0), xb = min(t.gx0 + t.cols, t.W);
      if (gy < 0 || gy >= t.H || xa >= xb) continue;
      const long long row = static_cast<long long>(t.img + gy) * t.W;
      eb = (row + xa) * r.C;
      ee = (row + xb) * r.C;
    } else {
      const int gy = t.gy0 + s / t.cols, gx = t.gx0 + s % t.cols;
      if (gy < 0 || gy >= t.H || gx < 0 || gx >= t.W) continue;
      eb = (static_cast<long long>(t.img + gy) * t.W + gx) * r.C + r.lo;
      ee = eb + r.n;
    }
    const uintptr_t a = reinterpret_cast<uintptr_t>(r.ptr + eb);
    const uintptr_t a0 = a & ~static_cast<uintptr_t>(15);
    const uintptr_t a1 = (reinterpret_cast<uintptr_t>(r.ptr + ee) + 15) & ~static_cast<uintptr_t>(15);
    r.mis[s] = static_cast<unsigned char>(a & 15);
    mbar_expect_tx(bar, static_cast<uint32_t>(a1 - a0));
    bulk_copy(r.raw + s * r.slot, reinterpret_cast<const void*>(a0), static_cast<uint32_t>(a1 - a0), bar);
  }
}

// Where in-image tile pixel q (tile row tr, column tc) of an operand lies
// in its runs: channel c (lo <= c < lo + n) at byte at + 2c.
__device__ __forceinline__ int pixel_at(const Src& r, const Tile& t, int q, int tr, int tc) {
  if (r.n <= 0) return 0;
  return r.whole ? tr * r.slot + r.mis[tr] + 2 * (tc + min(t.gx0, 0)) * r.C
                 : q * r.slot + r.mis[q] - 2 * r.lo;
}

// Channels c .. c+7 (the operand's own numbering) of a pixel at `at`
// (pixel_at), zero outside [lo, lo + n).
__device__ __forceinline__ uint4 read8(const Src& r, int at, int c) {
  const int k0 = max(r.lo - c, 0), k1 = min(r.lo + r.n - c, 8);
  if (k0 >= k1) return make_uint4(0u, 0u, 0u, 0u);
  at += 2 * c;
  if (k0 == 0 && k1 == 8 && (at & 15) == 0) return *reinterpret_cast<const uint4*>(r.raw + at);
  Vec8 v;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    v.v[k] = k >= k0 && k < k1 ? *reinterpret_cast<const __nv_bfloat16*>(r.raw + at + 2 * k)
                               : __float2bfloat16(0.f);
  }
  return as_raw(v);
}

// How a narrow operand is read.
enum NarrowOp {
  kOpCat = 0,        // [a | b] (b may have no channels): a conv's input, or g itself
  kOpAffineRelu = 1,  // round(relu(a*r0 + r1)), no b
  kOpCot = 2,        // round(a + r0 + 2*b*r1): a = g, b = y (as many channels)
  kOpCotAffine = 3,  // round(a*r0*[b*r0 + r1 > 0] + r2 + 2*b*r3)
};

// Channels c .. c+7 (of [a | b], or of a beside b = y) of an in-image
// pixel at pa in a's runs and pb in b's, after the transform; rows[i][j]:
// row i of the transform at channel c0 + j (c - c0 a multiple of 8, below
// 32; zero past the channels).
template <int OP>
__device__ __forceinline__ uint4 place8(const Src& a, int pa, const Src& b, int pb, int c,
                                        const float (*rows)[32], int c0) {
  const uint4 v = read8(a, pa, c);
  if constexpr (OP == kOpCat) {
    return or4(v, read8(b, pb, c - a.C));
  } else {
    float f[4][8];
#pragma unroll
    for (int i = 0; i < (OP == kOpCotAffine ? 4 : 2); ++i) {
      const float4* row = reinterpret_cast<const float4*>(rows[i] + (c - c0));
      const float4 lo = row[0], hi = row[1];
      f[i][0] = lo.x, f[i][1] = lo.y, f[i][2] = lo.z, f[i][3] = lo.w;
      f[i][4] = hi.x, f[i][5] = hi.y, f[i][6] = hi.z, f[i][7] = hi.w;
    }
    if constexpr (OP == kOpAffineRelu) {
      return affine_relu8(f[0], f[1], v);
    } else {
      return cotangent8<OP == kOpCotAffine>(f, v, read8(b, pb, c));
    }
  }
}

// Place the tile's pixels, a thread a pixel: its G vectors (channels c0 +
// 8j) at dst + q * stride + 8j; zero for a pixel outside the image (after
// the transform, as SAME padding is).
template <int OP>
__device__ __forceinline__ void place_tile(__nv_bfloat16* dst, int stride, int G, const Src& a,
                                           const Src& b, const Tile& t, int c0,
                                           const float (*rows)[32], int tid, int nthreads) {
  for (int q = tid; q < t.rows * t.cols; q += nthreads) {
    const int tr = q / t.cols, tc = q - tr * t.cols;
    const int gy = t.gy0 + tr, gx = t.gx0 + tc;
    uint4* d = reinterpret_cast<uint4*>(dst + q * stride);
    if (gy < 0 || gy >= t.H || gx < 0 || gx >= t.W) {
      for (int j = 0; j < G; ++j) d[j] = make_uint4(0u, 0u, 0u, 0u);
      continue;
    }
    const int pa = pixel_at(a, t, q, tr, tc), pb = pixel_at(b, t, q, tr, tc);
    for (int j = 0; j < G; ++j) d[j] = place8<OP>(a, pa, b, pb, c0 + 8 * j, rows, c0);
  }
}

// Stage the `nrows` per-channel rows of width C (row i at src + i*C) for
// channels c0 .. c0+31 into rows[i][0..32), zeros past C.
__device__ __forceinline__ void stage_rows(float (*rows)[32], const float* src, int nrows, int C,
                                           int c0, int tid, int nthreads) {
  for (int i = tid; i < nrows * 32; i += nthreads) {
    const int r = i / 32, j = i % 32;
    rows[r][j] = c0 + j < C ? src[r * C + c0 + j] : 0.f;
  }
}

// Shared-memory row stride (bf16) for `c` channels (a multiple of 8) at
// which the 8 rows of an ldmatrix fall in distinct banks: an odd number of
// 16-byte units.
__host__ __device__ constexpr int odd16(int c) { return (c / 8) % 2 ? c : c + 8; }


// ---- Hopper's warpgroup MMA (wgmma, sm_90a), for the conv kernels' deep
// paths.  Four warps issue one asynchronous 64 x N x 16 product whose
// operands both lie in shared memory, each described by a 64-bit
// descriptor; the fp32 sums stay in registers, warp w of the group holding
// rows 16w .. 16w+15 in the m16n8 C layout above, repeated over N/8.
//
// The operands here use the layout without swizzle: "core matrices" of 8
// rows x 16 bytes, each row 16 bytes after the last (128 contiguous bytes).
// A K-major operand's core matrix is 8 rows of M (or N) by 8 elements of
// K; an MN-major one's is 8 rows of K by 8 elements of M (or N).  The
// descriptor holds the start address and two strides: LBO between core
// matrices adjacent along K, SBO between those adjacent along M (or N)
// (PTX ISA, "Matrix Descriptor Format"; CUTLASS's GmmaDescriptor,
// LayoutType::INTERLEAVE).  The start needs only 16-byte alignment, so
// starting one 16-byte row later shifts a core matrix by one row: the
// conv kernels' tap shifts are start addresses.
__device__ __forceinline__ uint64_t wgmma_desc(const void* smem, uint32_t lbo, uint32_t sbo) {
  const uint64_t a = smem_u32(smem);
  return ((a & 0x3FFFFull) >> 4) | (static_cast<uint64_t>((lbo & 0x3FFFFu) >> 4) << 16) |
         (static_cast<uint64_t>((sbo & 0x3FFFFu) >> 4) << 32);
}

// Before the first wgmma of a run, and after registers it reads were written.
__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Wait until at most N of this warpgroup's committed groups are in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving reads or writes of the accumulators across
// a wgmma_wait (the asynchronous product writes them behind its back).
template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define IMGSEG_F8(i)                                                                      \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])

// d (64 x N, fp32) += A (64 x 16) * B (16 x N), bf16 operands in shared
// memory (descriptors da, db); scale_d = 0 overwrites d instead.  TA / TB:
// 1 where the operand is MN-major.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_n16(float (&d)[8], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, %11, %12;\n}\n"
      : IMGSEG_F8(0)
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_n32(float (&d)[16], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, %19, %20;\n}\n"
      : IMGSEG_F8(0), IMGSEG_F8(8)
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_n64(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, %35, %36;\n}\n"
      : IMGSEG_F8(0), IMGSEG_F8(8), IMGSEG_F8(16), IMGSEG_F8(24)
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, %67, %68;\n}\n"
      : IMGSEG_F8(0), IMGSEG_F8(8), IMGSEG_F8(16), IMGSEG_F8(24), IMGSEG_F8(32), IMGSEG_F8(40),
        IMGSEG_F8(48), IMGSEG_F8(56)
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

#undef IMGSEG_F8

// d += A * B at N = 8 * NT (16, 32, 64 or 128) output columns.
template <int TA, int TB, int NT>
__device__ __forceinline__ void wgmma(float (&d)[4 * NT], uint64_t da, uint64_t db, int scale_d) {
  if constexpr (NT == 2) {
    wgmma_n16<TA, TB>(d, da, db, scale_d);
  } else if constexpr (NT == 4) {
    wgmma_n32<TA, TB>(d, da, db, scale_d);
  } else if constexpr (NT == 8) {
    wgmma_n64<TA, TB>(d, da, db, scale_d);
  } else {
    static_assert(NT == 16, "N is 16, 32, 64 or 128");
    wgmma_n128<TA, TB>(d, da, db, scale_d);
  }
}

// Move registers between warpgroups (sm_90a): a producer gives some back,
// the consumers take them.  Every warp of a warpgroup executes it, and the
// two roles' code paths must not meet again after it.
template <int N>
__device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// Wait for `count` threads at named barrier `id` (1..15; 0 is __syncthreads').
__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// mbarrier pieces for the deep paths' rings (with mbar_init, mbar_wait,
// bulk_copy above): the init made visible, an arrival that also expects
// `bytes` of bulk copies, and shared-memory writes of this thread made
// visible to the async proxy (wgmma, bulk copies) before it arrives.
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(bytes)
               : "memory");
}

// ---- the vector paths' row streams (conv3x3.cu's forward, conv3x3_bwd.cu's
// wgrad).  A block walks a contiguous run of units, unit u being one strip
// of one image row: strip s of `strips`, row y of image n, u = (n * strips
// + s) * H + y, so consecutive units are consecutive rows of one strip.  It
// keeps the x rows the units read (rows y - 1, y, y + 1 with their halo
// columns) in a ring of R shared-memory slots: a unit that continues the
// one before it loads one new row, one that starts a run (the block's
// first, or the first of a strip) loads three.  Every role walks the same
// units and rows with its own cursor, kept incrementally (a division a
// unit cost more than the unit's products): the unit's (n, s, y), and the
// slot and phase parity of the last row loaded; a unit reads the last three.
struct UnitWalk {
  int H, strips, R;
  long long n;  // the unit: image n, strip s, row y
  int s, y;
  int left;     // units after this one (-1: past the run)
  bool fresh;   // this unit restarts the ring (loads three rows)
  int slot, phase;  // the ring slot of the last row loaded, and its phase parity

  __device__ __forceinline__ void begin(long long u0, long long u1, int h, int nstrips, int ring) {
    H = h, strips = nstrips, R = ring;
    y = static_cast<int>(u0 % h);
    const long long ns = u0 / h;
    s = static_cast<int>(ns % nstrips);
    n = ns / nstrips;
    left = static_cast<int>(u1 - u0) - 1;
    fresh = true;
    slot = R - 1, phase = 1;  // so that the first row lands in slot 0, phase 0
  }
  __device__ __forceinline__ bool more() const { return left >= 0; }
  __device__ __forceinline__ int loads() const { return fresh ? 3 : 1; }
  // after this unit, its rows q - 2 and, where the next unit restarts or
  // this is the last, q - 1 and q are read by no later unit
  __device__ __forceinline__ bool frees_all() const { return left == 0 || y + 1 == H; }
  __device__ __forceinline__ void next_unit() {
    --left;
    fresh = ++y == H;
    if (fresh) {
      y = 0;
      if (++s == strips) s = 0, ++n;
    }
  }
  __device__ __forceinline__ void next_row() {
    if (++slot == R) slot = 0, phase ^= 1;
  }
  // the slot and phase parity of row q - k (k < R)
  __device__ __forceinline__ int slot_back(int k) const { return slot >= k ? slot - k : slot - k + R; }
  __device__ __forceinline__ int phase_back(int k) const { return slot >= k ? phase : phase ^ 1; }
};

// One consumer's arrival on the empty barriers of the x rows that a unit
// (its last row in `slot`) is the last to read (UnitWalk::frees_all).
__device__ __forceinline__ void release_rows(int slot, int R, bool all, uint64_t* empty) {
  mbar_arrive(&empty[slot >= 2 ? slot - 2 : slot - 2 + R]);
  if (all) {
    mbar_arrive(&empty[slot >= 1 ? slot - 1 : slot - 1 + R]);
    mbar_arrive(&empty[slot]);
  }
}

// A ring position that steps one slot at a time: slot and phase parity.
struct RingPos {
  int slot, phase, R;
  __device__ __forceinline__ void next() {
    if (++slot == R) slot = 0, phase ^= 1;
  }
};

// Opt a kernel in to more than 48 KB of dynamic shared memory, once.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes, bool& done) {
  if (done) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  done = err == cudaSuccess;
  return err;
}

// Blocks of `kernel` (`threads` a block, `bytes` of dynamic shared memory)
// that fit on the whole card at once.
template <typename Kernel>
inline cudaError_t resident_blocks(Kernel kernel, int threads, size_t bytes, int& blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, bytes);
  }
  blocks = sms * (per_sm > 0 ? per_sm : 1);
  return err;
}

}  // namespace
}  // namespace imgseg
