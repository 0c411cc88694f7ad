// K3 (csrc/bn_relu_bwd.cu) with the other staging, for tools/exp_k3_staging.py
// only: the same cooperative launch, channel layout and in-launch sums, but
// each block's whole vectors of g and y arrive by bulk copies (cp.async.bulk
// on an mbarrier, one thread issuing) of runs of UNROLL * T vectors into a
// two-stage ring of shared memory, from which the threads read them.  Takes
// n = B*H*W*C a multiple of 8 (every path's shape); the library's kernel
// takes any.  Built by the tool with nvcc against csrc/ (reduce.cuh,
// mma.cuh); not part of the kernel library.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "mma.cuh"
#include "reduce.cuh"

namespace {

constexpr int UNROLL = 4;  // vectors of each tensor a thread takes from a run
constexpr int STAGES = 2;  // runs in the ring

// dynamic shared memory of the ring for a T-thread block
constexpr size_t ring_bytes(int T) { return size_t{2} * STAGES * UNROLL * T * 16; }

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

__device__ __forceinline__ float elem(const uint4& v, int k) {
  const uint32_t w = (&v.x)[k / 2];
  return __uint_as_float(k % 2 ? w & 0xffff0000u : w << 16);
}

__device__ __forceinline__ void accumulate(const uint4& gv, const uint4& yv, const float (&a)[8],
                                           const float (&b)[8], float (&s)[8], float (&q)[8]) {
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const float yf = elem(yv, k);
    const float P = __fadd_rn(__fmul_rn(yf, a[k]), b[k]) > 0.f ? elem(gv, k) : 0.f;
    s[k] += __fmul_rn(P, yf);
    q[k] += P;
  }
}

__global__ void __launch_bounds__(imgseg::kGridThreads, 2) bnred_bulk_kernel(
    const __nv_bfloat16* __restrict__ g, const __nv_bfloat16* __restrict__ y,
    const float* __restrict__ a_in, const float* __restrict__ b_in, float* __restrict__ sums,
    long long n, int C, int L, long long per_block) {
  extern __shared__ uint4 ring[];
  __shared__ uint64_t full_bar[STAGES];
  const int T = blockDim.x, t = threadIdx.x, V = L / 8;
  const uint4* gv = reinterpret_cast<const uint4*>(g);
  const uint4* yv = reinterpret_cast<const uint4*>(y);
  float a[8], b[8], s[8], q[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int c = (8 * (t % V) + k) % C;
    a[k] = round_bf16(a_in[c]);
    b[k] = round_bf16(b_in[c]);
    s[k] = q[k] = 0.f;
  }
  const long long nvec = n / 8;
  const long long start = blockIdx.x * per_block;
  const long long end = start + per_block < nvec ? start + per_block : nvec;
  // runs [start + r * UNROLL * T, ...) of the block's vectors, run r in
  // stage r % STAGES: g's vectors, then y's
  const long long run = static_cast<long long>(UNROLL) * T;
  const long long runs = end > start ? (end - start + run - 1) / run : 0;
  auto issue = [&](long long r) {
    const int st = static_cast<int>(r % STAGES);
    const long long v0 = start + r * run;
    const long long cnt = end - v0 < run ? end - v0 : run;
    const uint32_t bytes = static_cast<uint32_t>(cnt * 16);
    imgseg::mbar_arrive_tx(&full_bar[st], 2 * bytes);
    imgseg::bulk_copy(ring + st * 2 * run, gv + v0, bytes, &full_bar[st]);
    imgseg::bulk_copy(ring + st * 2 * run + run, yv + v0, bytes, &full_bar[st]);
  };
  if (t == 0) {
    for (int st = 0; st < STAGES; ++st) imgseg::mbar_init(&full_bar[st], 1);
    imgseg::fence_barrier_init();
  }
  __syncthreads();
  if (t == 0) {
    for (long long r = 0; r < runs && r < STAGES; ++r) issue(r);
  }
  for (long long r = 0; r < runs; ++r) {
    const int st = static_cast<int>(r % STAGES);
    imgseg::mbar_wait(&full_bar[st], static_cast<int>((r / STAGES) & 1));
    const long long v0 = start + r * run;
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (v0 + t + u * T < end) {
        accumulate(ring[st * 2 * run + t + u * T], ring[st * 2 * run + run + t + u * T], a, b, s, q);
      }
    }
    __syncthreads();  // every thread is done with stage st
    if (t == 0 && r + STAGES < runs) {
      imgseg::fence_proxy_async();
      issue(r + STAGES);
    }
  }
  imgseg::block_period_sums<8>(s, q, L, C, sums + 2LL * C * (1 + blockIdx.x));
  imgseg::grid_column_sums(sums + 2LL * C, sums, 2 * C);
}

int gcd(int x, int y) { return y == 0 ? x : gcd(y, x % y); }

bool shape_of(int C, int& L, int& T) {
  if (C <= 0) return false;
  const long long lcm = 8LL * C / gcd(C, 8);
  if (lcm / 8 > imgseg::kGridThreads) return false;
  L = static_cast<int>(lcm);
  T = (L / 8) * (imgseg::kGridThreads / (L / 8));
  return true;
}

cudaError_t blocks_for(int T, int& blocks) {
  static bool opted = false;  // the opt-in past 48 KB of dynamic shared memory, once
  if (!opted) {
    const cudaError_t err =
        cudaFuncSetAttribute(bnred_bulk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(ring_bytes(imgseg::kGridThreads)));
    if (err != cudaSuccess) return err;
    opted = true;
  }
  return imgseg::grid_blocks(bnred_bulk_kernel, T, ring_bytes(T), T, blocks);
}

}  // namespace

// As imgseg_bn_relu_bwd_reduce_floats and imgseg_bn_relu_bwd_reduce.
extern "C" long long exp_k3_bulk_floats(int C) {
  int L = 0, T = 0, blocks = 0;
  if (!shape_of(C, L, T) || blocks_for(T, blocks) != cudaSuccess) return -1;
  return 2LL * C * (1 + blocks);
}

extern "C" int exp_k3_bulk(const void* g, const void* y, const void* a, const void* b, void* sums,
                           int B, int H, int W, int C, void* stream) {
  int L = 0, T = 0, blocks = 0;
  long long n = static_cast<long long>(B) * H * W * C;
  if (n < 0 || n % 8 || !shape_of(C, L, T)) return static_cast<int>(cudaErrorInvalidValue);
  if (reinterpret_cast<uintptr_t>(g) % 16 || reinterpret_cast<uintptr_t>(y) % 16) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  cudaError_t err = blocks_for(T, blocks);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long V = L / 8;
  long long per_block = (n / 8 + blocks - 1) / blocks;
  per_block = (per_block + V - 1) / V * V;
  const __nv_bfloat16* gp = static_cast<const __nv_bfloat16*>(g);
  const __nv_bfloat16* yp = static_cast<const __nv_bfloat16*>(y);
  const float* ap = static_cast<const float*>(a);
  const float* bp = static_cast<const float*>(b);
  float* sp = static_cast<float*>(sums);
  void* args[] = {&gp, &yp, &ap, &bp, &sp, &n, &C, &L, &per_block};
  return static_cast<int>(cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(bnred_bulk_kernel), dim3(blocks), dim3(T), args,
      ring_bytes(T), static_cast<cudaStream_t>(stream)));
}
