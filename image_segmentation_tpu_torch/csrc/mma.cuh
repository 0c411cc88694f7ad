// Tensor-core and asynchronous-copy primitives shared by the tensor-core
// kernels (conv3x3.cu, conv3x3_bwd.cu, convtranspose.cu, conv1x1_bwd.cu,
// cross_attention.cu): ldmatrix, mma.sync m16n8k16 in bf16 with
// fp32 sums, cp.async with zero fill, 8-wide bf16 vector helpers and the
// operand transforms applied on load.
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

// Wait until at most N of this thread's committed groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
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

// round(relu(x*a + b)), with rows ab = [a, b].
__device__ __forceinline__ uint4 affine_relu8(const float* ab, int C, int c, const uint4& raw) {
  const Vec8 x = as_vec8(raw);
  float a[8], b[8];
  load_row8(ab, c, a);
  load_row8(ab + C, c, b);
  Vec8 out;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const float t = __fadd_rn(__fmul_rn(__bfloat162float(x.v[k]), a[k]), b[k]);
    out.v[k] = __float2bfloat16(fmaxf(t, 0.f));
  }
  return as_raw(out);
}

// The transformed cotangent of a BatchNorm'd conv output y: round(g + c1 +
// 2*y*c2), with rows gf = [c1, c2]; with AFFINE round(g*a*[y*a + b > 0] +
// c1 + 2*y*c2), rows gf = [a, b, c1, c2].
template <bool AFFINE>
__device__ __forceinline__ uint4 cotangent8(const float* gf, int C, int c, const uint4& graw,
                                            const uint4& yraw) {
  const Vec8 g = as_vec8(graw), y = as_vec8(yraw);
  float a[8], b[8], c1[8], c2[8];
  if constexpr (AFFINE) {
    load_row8(gf, c, a);
    load_row8(gf + C, c, b);
    gf += 2 * C;
  }
  load_row8(gf, c, c1);
  load_row8(gf + C, c, c2);
  Vec8 out;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const float gv = __bfloat162float(g.v[k]), yv = __bfloat162float(y.v[k]);
    float t = gv;
    if constexpr (AFFINE) t = __fadd_rn(__fmul_rn(yv, a[k]), b[k]) > 0.f ? __fmul_rn(gv, a[k]) : 0.f;
    out.v[k] = __float2bfloat16(__fadd_rn(__fadd_rn(t, c1[k]), __fmul_rn(__fmul_rn(2.f, yv), c2[k])));
  }
  return as_raw(out);
}

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
