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
// two kernels (conv3x3.cu computes dx).  On the TPU the dk block stays in
// VMEM while the grid walks the image in order; here blocks run in
// parallel, so each sums its own pixels and a second pass adds the blocks.
//
// The vector path (wgrad_vec_kernel): Ca, Cb and Co multiples of 8 on
// 16-byte aligned operands where the forward's path rule gives the vector
// path (ops/fused_conv.conv_path: Cin up to 192), every level 0-1 conv of
// every U-Net.  What
// bounds it on the card: bytes, at 7 of the large_unet step's 8 convs.  It
// reads x, g and y (2*(Cin + 2*Co) bytes a pixel) for 18*Cin*Co FLOPs, so
// at 32-64 channels the tensor cores have 1.5-3x of slack (enc1.conv1 32
// -> 64 at batch 16, 512^2: 0.401 ms of bytes against 0.156 of FLOPs at
// 3.35 TB/s and 989 TFLOP/s; only enc2.conv2, 128 -> 128, is bound by
// FLOPs).  So the design reads every operand from device memory once and
// transforms it once.  What the design does: one wave of persistent blocks
// (one an SM), each owning a 9-tap x 64 input x TCO (16, 32 or 64) output
// channel tile of dw and walking a contiguous run of units, a unit being a
// 128-pixel strip of one image row (mma.cuh UnitWalk).  Warpgroup 0 copies
// each new row of x (with its halo columns) and each row of g (and y) by
// 16-byte cp.async straight into rings of 8-channel planes (8 consecutive
// pixels of a plane are the wgmma's MN-major core matrix, so a tap's shift
// of one pixel is a start address 16 bytes on), as many rows ahead as the
// rings hold, each row's copies counted on an mbarrier; consecutive units
// are consecutive rows, so each x row is copied once for the three tap
// rows that read it.  Warpgroups 1-3 apply the transforms in place (act(x),
// the cotangent transform: 384 threads, while the previous unit's wgmmas
// run; with one staging warpgroup doing them they were the bottleneck) and
// then, warpgroup ky + 1 owning the tap row ky, run m64 (input channels) x
// n(TCO) x k16 (pixels) wgmmas with both operands read from shared memory
// by descriptor, the sums in registers over the whole run (9 x 64 x 64
// fp32: 96 registers a thread over the three).  Where dw has more than one
// tile (64 -> 128, 128 -> 128, [64 | 64] -> 64) the blocks of one run sit
// next to each other in the grid and walk the same rows together, so their
// second reads of an operand come from L2.  db is a fixed-order fp32 sum of
// the transformed ge (each transforming thread keeps 8 channels).  Each
// block writes its tile of partial sums once (132 rows at most: 19 MB at 64
// -> 64); a second pass (reduce.cuh) adds them in a fixed order.  No
// atomics.  Cin below 64 leaves part of each m64 tile empty.  What limits
// it now (PERF.md, section 6): the wgmmas run at a third of the tensor
// cores' rate, neither the copies nor the transforms being on the critical
// path.
//
// The narrow path (wgrad_narrow_kernel) takes every other shape: a channel
// count that is not a multiple of 8 (ClipRes's output block, [16 | 3] -> 3
// and 3 -> 3; the prompt heatmap's K10, 1 -> 32), more input channels
// than the vector path takes, an operand off a 16-byte boundary.  What bounds it on the card: bytes (2*9*19*3 FLOPs a
// pixel against ~50 bytes).  What cost was the staging, as in conv3x3.cu's
// narrow path: padded to 32 x 32 channels a tap group, most of each tile
// was zeros, staged one element at a time.  What the design does about it:
// x [| xb] over the halo and g (and y) over the tile arrive as runs of NHWC
// memory, one bulk copy (TMA) a run on an mbarrier (mma.cuh), the next
// tile's while this tile's mma runs, and are placed 8 channels of a pixel
// a thread, transformed in registers, into rows padded only to CP = Cin
// rounded up to 8 (24 a tile past 24 channels) and TCO = 8, 16 or 32.  M is
// 9 taps x CP in m16 tiles of two 8-channel halves (CP = 8: two taps a
// tile, 5 tiles, not 9), N = TCO; warp w owns the M tiles w and w+8 by all
// of N over the chunk, so no sums cross warps.  A tile is 16x16 pixels, a
// k16 step a tile row; there are as many chunks as blocks fit on the card
// (one wave).  The partial rows and the second pass are the vector path's.
// Measured share of the bound: PERF.md (section 6).
//
// The deep path (wgrad_deep_kernel) takes Ca, Cb and Co multiples of 64
// with 256 or more channels in or out, as the caller's rule (ops/
// fused_conv.conv_path) says: the fold-1 blocks of fused_deep.  What held
// the vector path back there: 64 x 64 dw tiles on mma.sync, 4.36 waves of
// blocks with the last a third full, and 85 MB of partial rows at enc4.conv2.
// What the design does about it: (1) a prepass (wgrad_ge_prepass,
// wgrad_x_prepass) transforms each operand once, where the products' blocks
// would repeat the transform Cin/64 or Co/64 times, and lays it out in
// 8-channel planes padded to whole tiles (DeepLayout), so that each tile
// row of a plane is one contiguous run; it also writes db's rows of
// partials.  (2) The products: a block owns a 9-tap x 64 x 64 tile of dw
// and walks a chunk of 2 x 64-pixel tiles, as many chunks as fill one wave
// beside the dw tiles; warp 12 brings each tile's operands by 48 bulk
// copies (the TMA engine) into a ring of 4 stages on mbarriers (2-row
// tiles: the copies run 3 tiles ahead; a 4-row tile fit only 2 stages), in
// the wgmma's MN-major core-matrix layout (8 consecutive pixels a core
// matrix, so a tap's shift is a start address); warpgroup ky runs the
// taps (ky, 0..2) as m64 (input channels) x n64 (output channels) x k16
// (16 pixels) wgmmas with both operands read by descriptor.  Each block sums
// at most DSUB tiles (4096 pixels) in registers and then adds them into its
// chunk's rows; the second pass (reduce.cuh) reads chunks x 9 x Cin x Co,
// 19 MB at enc4.conv2.  No atomics, and no fallback.  Measured share of the
// bound: PERF.md (section 6, the fold-1 rows).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "mma.cuh"
#include "reduce.cuh"

namespace {

using imgseg::ldsm_x4_trans;
using imgseg::mma_bf16;

constexpr int TW = 16;  // the narrow path's tile columns: one k16 step a tile row
constexpr int IW = TW + 2;

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
  int cp;  // the narrow path: input channels per tile, padded to a multiple of 8
  long long tiles, per_chunk;  // the vector path: units (tiles_x strips a row) and units a chunk
};

// How the cotangent is read.
enum Ge {
  kGePlain = 0,   // g
  kGeStats = 1,   // round(g + c1 + 2*y*c2)
  kGeAffine = 2,  // round(g*a*[y*a + b > 0] + c1 + 2*y*c2)
};

// ---- the vector path: Ca, Cb and Co multiples of 8 on 16-byte aligned
// operands.  A block owns a 9-tap x 64 input x TCO output channel tile of dw
// (TCO = 8 * NT: 16, 32 or 64) and walks a chunk of units (mma.cuh
// UnitWalk): a unit is a VSW-pixel strip of one cotangent row, 8 k16 steps
// of K.  Warpgroup 0 copies; warpgroup ky + 1 runs the taps (ky, 0..2).
constexpr int VSW = 128;       // pixels a unit
constexpr int VXW = VSW + 2;   // x pixels a unit: the strip and its halo columns
constexpr int VXP = VXW * 8;   // bf16 from one 8-channel plane of an x row to the next
constexpr int VGP = VSW * 8;   // and of a cotangent row
constexpr int VTCI = 64;       // input channels a block: one m64 tile
constexpr int VXR = 6;         // x rows in the ring (see wgrad_vec_products)
constexpr int VGR = 3;         // cotangent rows in the ring
constexpr int VTHREADS = 512;  // warpgroup 0 copies; 1-3 transform and run the products
constexpr int VSTAGERS = 128;
constexpr int VCONSUMERS = VTHREADS - VSTAGERS;
// registers a thread after the copying warpgroup hands some to the others
// (128 at the launch): 128 x 72 given, 384 x 24 taken, which must balance
// (setmaxnreg.inc waits for what the block's setmaxnreg.dec gave back);
// setmaxnreg also keeps ptxas from serializing the products' wgmmas behind
// the branch between the roles
constexpr int VSTAGE_REGS = 56;
constexpr int VPRODUCT_REGS = 152;
static_assert((128 - VSTAGE_REGS) * VSTAGERS == (VPRODUCT_REGS - 128) * VCONSUMERS,
              "the registers given and taken balance");

// Bytes of the rings: x rows of 8 planes, cotangent rows of NT planes, and
// as many rows of y beside them.
__host__ __device__ constexpr size_t vec_bytes(int nt) {
  return (static_cast<size_t>(VXR) * 8 * VXP + static_cast<size_t>(2 * VGR) * nt * VGP) *
         sizeof(__nv_bfloat16);
}

// The shared state of a vector-path block: the rings and their barriers
// (`land`: a row's copies have landed; `empty`: the products are done with
// it), the transform rows of its channels.
struct VecShared {
  __nv_bfloat16* xr;  // VXR x rows of 8 planes of VXW pixels (act(x))
  __nv_bfloat16* gr;  // VGR cotangent rows of NT planes of VSW pixels (ge)
  __nv_bfloat16* yr;  // VGR rows of y, as gr
  uint64_t *xland, *xempty, *gland, *gempty;
  const float* rows;  // [xa, xb, r0, r1, r2, r3], 64 floats each, at the block's channels
};

// Warpgroup 0: every unit's new x rows, then its cotangent row (g, and y
// beside it), 16-byte copies (cp.async, zero-filled outside the image) into
// their ring slots once the consumers freed them, as far ahead as the rings
// hold; each row's `land` barrier counts the copies.  Thread t copies plane
// (t / 8) % 8 of x (8 input channels) at pixels t % 8 + 8 (t / 64) + 16 m,
// and plane (t / 8) % NT of g at pixels t % 8 + 8 ((t / 8) / NT) + (128 /
// NT) m, so 8 lanes write 128 contiguous bytes.  x planes past Cin and g
// planes past Co are not copied (they feed rows and columns of dw the block
// does not store).
template <int GE, int NT>
__device__ __forceinline__ void wgrad_vec_issue(const Args& p, const VecShared& sh, long long u0,
                                                long long u1, int ci0, int co0) {
  const int t = threadIdx.x, pl = t & 7, grp = t >> 3;
  const int H = p.H, W = p.W, Co = p.Co;
  const int jx = grp & 7, cx = ci0 + 8 * jx, xbase = pl + 8 * (grp >> 3);
  const bool xon = cx < p.Ca + p.Cb, in_b = cx >= p.Ca;
  const int xcs = in_b ? p.Cb : p.Ca;
  const __nv_bfloat16* xsrc = in_b ? p.xb + (cx - p.Ca) : p.x + cx;
  const int jg = grp % NT, gbase = pl + 8 * (grp / NT), cg = co0 + 8 * jg;
  constexpr int gstride = VSTAGERS / NT, GN = VSW / gstride;  // GN pixels a thread
  const bool gon = cg < Co;
  imgseg::UnitWalk w;
  imgseg::RingPos g{0, 0, VGR};
  for (w.begin(u0, u1, H, p.tiles_x, VXR); w.more(); w.next_unit(), g.next()) {
    const int x0 = w.s * VSW;
    const size_t img = static_cast<size_t>(w.n) * H;
    for (int r = w.fresh ? -1 : 1; r <= 1; ++r) {
      w.next_row();
      const int iy = w.y + r;
      imgseg::mbar_wait(&sh.xempty[w.slot], w.phase ^ 1);
      if (xon) {
        __nv_bfloat16* dst = sh.xr + (static_cast<size_t>(w.slot) * 8 + jx) * VXP;
        const bool row_in = iy >= 0 && iy < H;
        const __nv_bfloat16* src = xsrc + (row_in ? (img + iy) * W * xcs : 0);
        for (int hx = xbase; hx < VXW; hx += 16) {
          const int ix = x0 - 1 + hx;
          const bool ok = row_in && ix >= 0 && ix < W;
          imgseg::cp_async16(dst + hx * 8, ok ? src + ix * xcs : p.x, ok);
        }
      }
      imgseg::cp_async_arrive(&sh.xland[w.slot]);
    }
    imgseg::mbar_wait(&sh.gempty[g.slot], g.phase ^ 1);
    if (gon) {
      const size_t at = ((img + w.y) * W + x0) * Co + cg;
      const size_t o = (static_cast<size_t>(g.slot) * NT + jg) * VGP;
#pragma unroll
      for (int i = 0; i < GN; ++i) {
        const int px = gbase + gstride * i;
        const bool ok = x0 + px < W;
        imgseg::cp_async16(sh.gr + o + px * 8, ok ? p.g + at + px * Co : p.g, ok);
        if constexpr (GE != kGePlain) imgseg::cp_async16(sh.yr + o + px * 8, ok ? p.y + at + px * Co : p.y, ok);
      }
    }
    imgseg::cp_async_arrive(&sh.gland[g.slot]);
  }
}

// The consumers (384 threads, c = thread - 128) on a unit's rows once they
// have landed.  x (its new rows): act(x) in place, thread c taking plane
// (c / 8) % 8 at pixels c % 8 + 8 (c / 64) + 48 m (the zeros outside the
// image stay zero: SAME padding pads the activated tensor).  ge: plane (c /
// 8) % NT at pixels c % 8 + 8 ((c / 8) / NT) + (384 / NT) m, transformed in
// place from g and y (zero past the image), its 8 channels added into db.
template <int GE, int NT>
__device__ __forceinline__ void wgrad_vec_transform(const Args& p, const VecShared& sh,
                                                    const imgseg::UnitWalk& w, int gslot, int ci0,
                                                    int co0, float (&db)[8]) {
  const int c = threadIdx.x - VSTAGERS, pl = c & 7, grp = c >> 3;
  const int H = p.H, W = p.W, x0 = w.s * VSW;
  const int jx = grp & 7;
  if (p.ab != nullptr && ci0 + 8 * jx < p.Ca) {
    for (int k = 0; k < w.loads(); ++k) {  // rows y + 1, y, y - 1
      const int iy = w.y + 1 - k;
      if (iy < 0 || iy >= H) continue;
      __nv_bfloat16* dst = sh.xr + (static_cast<size_t>(w.slot_back(k)) * 8 + jx) * VXP;
      for (int hx = pl + 8 * (grp >> 3); hx < VXW; hx += VCONSUMERS / 8) {
        const int ix = x0 - 1 + hx;
        if (ix < 0 || ix >= W) continue;
        uint4* at = reinterpret_cast<uint4*>(dst + hx * 8);
        *at = imgseg::affine_relu8_shared(sh.rows, 64, 8 * jx, *at);
      }
    }
  }
  const int jg = grp % NT;
  if (co0 + 8 * jg >= p.Co) return;
  const size_t o = (static_cast<size_t>(gslot) * NT + jg) * VGP;
  for (int px = pl + 8 * (grp / NT); px < VSW && x0 + px < W; px += VCONSUMERS / NT) {
    uint4* at = reinterpret_cast<uint4*>(sh.gr + o + px * 8);
    uint4 v = *at;
    if constexpr (GE != kGePlain) {
      v = imgseg::cotangent8_shared<GE == kGeAffine>(sh.rows + 2 * 64, 64, 8 * jg, v,
                                                     *reinterpret_cast<const uint4*>(sh.yr + o + px * 8));
      *at = v;
    }
    const imgseg::Vec8 e8 = imgseg::as_vec8(v);
#pragma unroll
    for (int e = 0; e < 8; ++e) db[e] += __bfloat162float(e8.v[e]);
  }
}

// Warpgroups 1-3 (ky = 0..2): for each unit, the rows' transforms (all 384
// threads, while the unit before's wgmmas run), then taps (ky, kx), kx =
// 0..2, as m64 (input channels) x n(TCO) (output channels) x k16 (pixels)
// wgmmas, both operands MN-major by descriptor: act(x) row y + ky - 1
// shifted by kx pixels (a start address 16 bytes on per pixel), ge row y.
// The sums stay in registers over the whole chunk; a unit's group is
// committed after its 24 wgmmas, and the rows of the unit before are freed
// once it is done.  So the rows a unit frees come back one unit late, and
// a unit that restarts loads three: it needs rows freed by units up to two
// before it, which VXR = 6 slots give (with 5 its last row would wait for
// the unit before it, which waits for it).
template <int GE, int NT>
__device__ __forceinline__ void wgrad_vec_products(const Args& p, const VecShared& sh, long long u0,
                                                   long long u1, int ci0, int co0, float (&db)[8]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ky = warp / 4 - 1, w4 = warp & 3;
  const int cin = p.Ca + p.Cb, Co = p.Co;
  float acc[3][4 * NT];
#pragma unroll
  for (int kx = 0; kx < 3; ++kx)
#pragma unroll
    for (int i = 0; i < 4 * NT; ++i) acc[kx][i] = 0.f;
  imgseg::UnitWalk w;
  imgseg::RingPos g{0, 0, VGR};
  int prev_slot = -1, prev_g = 0;  // the unit before: its last x row's slot, its ge slot
  bool prev_all = false;
  for (w.begin(u0, u1, p.H, p.tiles_x, VXR); w.more(); w.next_unit(), g.next()) {
    for (int i = w.loads(); i > 0; --i) w.next_row();
#pragma unroll
    for (int k = 0; k < 3; ++k) imgseg::mbar_wait(&sh.xland[w.slot_back(k)], w.phase_back(k));
    imgseg::mbar_wait(&sh.gland[g.slot], g.phase);
    wgrad_vec_transform<GE, NT>(p, sh, w, g.slot, ci0, co0, db);
    imgseg::fence_proxy_async();  // the copies and the stores, before the wgmmas read them
    imgseg::named_sync(1, VCONSUMERS);
    const __nv_bfloat16* sx = sh.xr + static_cast<size_t>(w.slot_back(2 - ky)) * 8 * VXP;
    const __nv_bfloat16* sg = sh.gr + static_cast<size_t>(g.slot) * NT * VGP;
    imgseg::wgmma_fence();
#pragma unroll
    for (int s = 0; s < VSW / 16; ++s) {
      // B: ge, MN-major: K-adjacent cores (8 pixels) 128 bytes apart, N-adjacent a plane
      const uint64_t db_desc = imgseg::wgmma_desc(sg + 16 * s * 8, 128, VGP * 2);
#pragma unroll
      for (int kx = 0; kx < 3; ++kx) {
        // A: act(x) shifted by the tap, MN-major: M-adjacent (8 channels) a plane
        const uint64_t da = imgseg::wgmma_desc(sx + (16 * s + kx) * 8, 128, VXP * 2);
        imgseg::wgmma<1, 1, NT>(acc[kx], da, db_desc, 1);
      }
    }
    imgseg::wgmma_commit();
    imgseg::wgmma_wait<1>();  // the unit before is done: free what only it still read
    if (prev_slot >= 0 && lane == 0) {
      imgseg::mbar_arrive(&sh.gempty[prev_g]);
      imgseg::release_rows(prev_slot, VXR, prev_all, sh.xempty);
    }
    prev_slot = w.slot, prev_g = g.slot, prev_all = w.frees_all();
  }
  imgseg::wgmma_wait<0>();
#pragma unroll
  for (int kx = 0; kx < 3; ++kx) imgseg::fence_acc(acc[kx]);
  // (the last unit's rows need no freeing: nothing is staged after it)

  // this block's partial sums: lane holds input channels 16 w4 + lane/4 (+8)
  // and output channels 8t + 2(lane%4) (+1) of each tap (ky, kx)
  float* pw = p.part_w + static_cast<size_t>(blockIdx.y) * 9 * cin * Co;
#pragma unroll
  for (int kx = 0; kx < 3; ++kx)
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int ci = ci0 + 16 * w4 + (lane >> 2) + 8 * h;
        const int co = co0 + 8 * t + 2 * (lane & 3);
        if (ci < cin && co < Co) {
          *reinterpret_cast<float2*>(pw + (static_cast<size_t>(ky * 3 + kx) * cin + ci) * Co + co) =
              make_float2(acc[kx][4 * t + 2 * h], acc[kx][4 * t + 2 * h + 1]);
        }
      }
}

template <int GE, int NT>
__global__ void __launch_bounds__(VTHREADS, 1) wgrad_vec_kernel(const Args p) {
  constexpr int TCO = 8 * NT;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __shared__ uint64_t xland[VXR], xempty[VXR], gland[VGR], gempty[VGR];
  __shared__ __align__(16) float rows[6 * 64];
  __shared__ float dbs[VCONSUMERS][8];

  const int tid = threadIdx.x, warp = tid >> 5;
  const int Co = p.Co;
  const int co_tiles = (Co + TCO - 1) / TCO;
  const int ci0 = (blockIdx.x / co_tiles) * VTCI, co0 = (blockIdx.x % co_tiles) * TCO;
  const long long u0 = static_cast<long long>(blockIdx.y) * p.per_chunk;
  const long long u1 = u0 + p.per_chunk < p.tiles ? u0 + p.per_chunk : p.tiles;
  VecShared sh;
  sh.xr = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  sh.gr = sh.xr + VXR * 8 * VXP;
  sh.yr = sh.gr + VGR * NT * VGP;
  sh.xland = xland, sh.xempty = xempty, sh.gland = gland, sh.gempty = gempty;
  sh.rows = rows;

  if (tid == 0) {
    for (int i = 0; i < VXR; ++i) {
      imgseg::mbar_init(&xland[i], VSTAGERS);
      imgseg::mbar_init(&xempty[i], 12);  // lane 0 of each consumer warp
    }
    for (int i = 0; i < VGR; ++i) {
      imgseg::mbar_init(&gland[i], VSTAGERS);
      imgseg::mbar_init(&gempty[i], 12);
    }
    imgseg::fence_barrier_init();
  }
  // the transform rows at the block's channels: act(x)'s a, b; ge's rows
  for (int i = tid; i < 6 * 64; i += VTHREADS) {
    const int r = i / 64, c = i % 64;
    float v = 0.f;
    if (r < 2) {
      if (p.ab != nullptr && ci0 + c < p.Ca) v = p.ab[r * p.Ca + ci0 + c];
    } else if (GE != kGePlain && r - 2 < (GE == kGeAffine ? 4 : 2) && c < TCO && co0 + c < Co) {
      v = p.gf[(r - 2) * Co + co0 + c];
    }
    rows[i] = v;
  }
  __syncthreads();

  if (warp < 4) {
    imgseg::reg_dealloc<VSTAGE_REGS>();
    wgrad_vec_issue<GE, NT>(p, sh, u0, u1, ci0, co0);
  } else {
    imgseg::reg_alloc<VPRODUCT_REGS>();
    float db[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    wgrad_vec_products<GE, NT>(p, sh, u0, u1, ci0, co0, db);
    if (ci0 == 0) {  // db: the consumer threads' sums, added in thread order per channel
      const int c = tid - VSTAGERS;
#pragma unroll
      for (int e = 0; e < 8; ++e) dbs[c][e] = db[e];
      imgseg::named_sync(1, VCONSUMERS);
      if (c < TCO && co0 + c < Co) {
        const int j = c / 8, e = c % 8;
        float s = 0.f;
        for (int t = 0; t < VCONSUMERS; ++t) {
          if ((t >> 3) % NT == j) s += dbs[t][e];
        }
        p.part_b[static_cast<size_t>(blockIdx.y) * Co + co0 + c] = s;
      }
    }
  }
}

// ---- the narrow path: every shape the vector path does not take (a
// channel count that is not a multiple of 8, an operand off a 16-byte
// boundary).  A 256-thread block owns a dw tile of 9 taps x CP input
// channels (M, in m16 tiles of two 8-channel halves: with CP = 8 one tile
// carries two taps) by TCO = 8, 16 or 32 output channels (N), and walks a
// chunk of 16x16-pixel tiles, one k16 step a tile row.  Warp w owns the M
// tiles w and w+8 by all of N, over every pixel of the chunk.
constexpr int NTH = 16;  // tile rows
constexpr int NHALO = (NTH + 2) * IW;
constexpr int NTILE = NTH * TW;
constexpr int NTHREADS = 256;
constexpr int NCP = 24;              // the most input channels per tile
constexpr int NMT = (9 * NCP + 15) / 16;  // the most m16 tiles
constexpr int NMPW = (NMT + 7) / 8;  // m16 tiles a warp

// The narrow kernel's shared memory: the padded act(x) halo and cotangent
// tile, and the runs of x, xb, g and y (Cb = 0: no xb; no y for the raw
// cotangent).
__host__ __device__ inline size_t narrow_bytes(int cp, int nt, int Ca, int Cb, int Co, bool y) {
  const bool xsingle = Ca + Cb <= NCP, gsingle = Co <= 8 * nt;
  return (static_cast<size_t>(NHALO) * imgseg::odd16(cp) +
          static_cast<size_t>(NTILE) * imgseg::odd16(8 * nt)) * sizeof(__nv_bfloat16) +
         imgseg::raw_bytes(Ca, xsingle, NTH + 2, IW) + imgseg::raw_bytes(Cb, xsingle, NTH + 2, IW) +
         imgseg::raw_bytes(Co, gsingle, NTH, TW) * (y ? 2 : 1);
}

template <int GE, int NT>
__global__ void __launch_bounds__(NTHREADS, 3) wgrad_narrow_kernel(const Args p) {
  constexpr int TCO = 8 * NT;
  constexpr int GS = imgseg::odd16(TCO);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int off[2 * NMT];
  __shared__ __align__(16) float xrows[2][32];
  __shared__ __align__(16) float grows[4][32];
  __shared__ float dbs[NTHREADS];
  __shared__ unsigned char mis[4][NHALO];
  __shared__ uint64_t bar;  // a phase a tile: its runs have landed

  const int H = p.H, W = p.W, Co = p.Co, cin = p.Ca + p.Cb;
  const int CP = p.cp, XS = imgseg::odd16(CP), GX = CP / 8, mtiles = (9 * CP + 15) / 16;
  __nv_bfloat16* sX = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sG = sX + NHALO * XS;
  const int co_tiles = (Co + TCO - 1) / TCO;
  const int ci0 = (blockIdx.x / co_tiles) * CP;
  const int co0 = (blockIdx.x % co_tiles) * TCO;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const bool with_db = ci0 == 0;

  // half h of m16 tile i: tap t, channels c.. of the tile (past the 9 taps
  // the rows are not written; the operand is tap 8's)
  for (int i = tid; i < 2 * mtiles; i += NTHREADS) {
    int tap = 8 * i / CP, c = 8 * i % CP;
    if (tap > 8) tap = 8, c = 0;
    off[i] = ((tap / 3) * IW + tap % 3) * XS + c;
  }
  if (p.ab != nullptr) imgseg::stage_rows(xrows, p.ab, 2, p.Ca, ci0, tid, NTHREADS);
  if constexpr (GE != kGePlain) {
    imgseg::stage_rows(grows, p.gf, GE == kGeAffine ? 4 : 2, Co, co0, tid, NTHREADS);
  }
  // the runs of x [| xb] over the halo and of g (and y) over the tile
  const bool xsingle = cin <= NCP, gsingle = Co <= TCO;
  unsigned char* rawxa = smem_raw + (NHALO * XS + NTILE * GS) * sizeof(__nv_bfloat16);
  unsigned char* rawxb = rawxa + imgseg::raw_bytes(p.Ca, xsingle, NTH + 2, IW);
  unsigned char* rawga = rawxb + imgseg::raw_bytes(p.Cb, xsingle, NTH + 2, IW);
  unsigned char* rawgb = rawga + imgseg::raw_bytes(Co, gsingle, NTH, TW);
  const imgseg::Src rxa =
      imgseg::src_of(p.x, p.Ca, min(ci0, p.Ca), min(ci0 + CP, p.Ca), xsingle, IW, rawxa, mis[0]);
  const imgseg::Src rxb = imgseg::src_of(p.xb, p.Cb, p.Cb ? max(ci0, p.Ca) - p.Ca : 0,
                                         p.Cb ? min(ci0 + CP, cin) - p.Ca : 0, xsingle, IW, rawxb, mis[1]);
  const imgseg::Src rga = imgseg::src_of(p.g, Co, co0, min(co0 + TCO, Co), gsingle, TW, rawga, mis[2]);
  const imgseg::Src rgb =
      GE == kGePlain ? imgseg::src_of(nullptr, 0, 0, 0, gsingle, TW, rawgb, mis[3])
                     : imgseg::src_of(p.y, Co, co0, min(co0 + TCO, Co), gsingle, TW, rawgb, mis[3]);
  auto tiles_of = [&](long long t, imgseg::Tile& tx, imgseg::Tile& tg) {
    const int x0 = static_cast<int>(t % p.tiles_x) * TW;
    const int y0 = static_cast<int>((t / p.tiles_x) % p.tiles_y) * NTH;
    const size_t img = static_cast<size_t>(t / (static_cast<long long>(p.tiles_x) * p.tiles_y)) * H;
    tx = imgseg::Tile{y0 - 1, x0 - 1, NTH + 2, IW, H, W, img};
    tg = imgseg::Tile{y0, x0, NTH, TW, H, W, img};
  };
  // warp 0 starts the copies of tile t's runs (after the reads of their
  // space, in the other proxy) and arrives on the barrier
  auto issue = [&](long long t) {
    if (warp != 0) return;
    imgseg::Tile tx, tg;
    tiles_of(t, tx, tg);
    imgseg::fence_proxy_async();
    imgseg::issue_runs(rxa, tx, lane, &bar);
    imgseg::issue_runs(rxb, tx, lane, &bar);
    imgseg::issue_runs(rga, tg, lane, &bar);
    imgseg::issue_runs(rgb, tg, lane, &bar);
    __syncwarp();
    if (lane == 0) imgseg::mbar_arrive(&bar);
  };

  float acc[NMPW][NT][4];
#pragma unroll
  for (int i = 0; i < NMPW; ++i)
#pragma unroll
    for (int ni = 0; ni < NT; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][ni][e] = 0.f;
  // db: this thread's channel co0 + tid % TCO over the tile pixels tid / TCO + k * DG
  constexpr int DG = NTHREADS / TCO;
  float db = 0.f;

  // this lane's ldmatrix rows: A (pixel, channel half), B (pixel, 8-channel half)
  const int a_px = (lane & 7) + (lane >> 4) * 8, a_half = (lane >> 3) & 1;
  const int b_px = (lane & 7) + ((lane >> 3) & 1) * 8, b_c = (lane >> 4) * 8;

  const long long t_begin = static_cast<long long>(blockIdx.y) * p.per_chunk;
  const long long t_end = t_begin + p.per_chunk < p.tiles ? t_begin + p.per_chunk : p.tiles;
  // tile t + 1's runs are copied while tile t's mma runs
  if (tid == 0) imgseg::mbar_init(&bar, 1);
  __syncthreads();
  if (t_begin < t_end) issue(t_begin);
  for (long long t = t_begin; t < t_end; ++t) {
    imgseg::Tile tx, tg;
    tiles_of(t, tx, tg);
    const int y0 = tg.gy0;
    imgseg::mbar_wait(&bar, static_cast<int>((t - t_begin) & 1));
    __syncthreads();  // tile t's runs are in; the previous tile's mma is done
    // act(x) on the halo (zero outside the image, after the activation) and
    // the transformed cotangent on the tile (zero outside the image), 8
    // channels of a pixel a thread, into rows of CP and TCO channels
    if (p.ab != nullptr) {
      imgseg::place_tile<imgseg::kOpAffineRelu>(sX, XS, GX, rxa, rxb, tx, ci0, xrows, tid, NTHREADS);
    } else {
      imgseg::place_tile<imgseg::kOpCat>(sX, XS, GX, rxa, rxb, tx, ci0, xrows, tid, NTHREADS);
    }
    constexpr int OP = GE == kGePlain  ? imgseg::kOpCat
                       : GE == kGeStats ? imgseg::kOpCot
                                        : imgseg::kOpCotAffine;
    imgseg::place_tile<OP>(sG, GS, NT, rga, rgb, tg, co0, grows, tid, NTHREADS);
    __syncthreads();
    if (t + 1 < t_end) issue(t + 1);
    if (with_db) {  // the bias gradient: one channel, a fixed share of the pixels
      for (int q = tid / TCO; q < NTILE; q += DG) db += __bfloat162float(sG[q * GS + tid % TCO]);
    }
#pragma unroll 1
    for (int r = 0; r < NTH; ++r) {
      if (y0 + r >= H) break;  // rows past the image: a zero cotangent
      uint32_t b[NT][2];
#pragma unroll
      for (int pr = 0; pr < NT / 2; ++pr) {
        uint32_t q4[4];
        ldsm_x4_trans(q4, sG + (r * TW + b_px) * GS + pr * 16 + b_c);
        b[2 * pr][0] = q4[0], b[2 * pr][1] = q4[1];
        b[2 * pr + 1][0] = q4[2], b[2 * pr + 1][1] = q4[3];
      }
      if constexpr (NT % 2) {
        uint32_t q2[2];
        imgseg::ldsm_x2_trans(q2, sG + (r * TW + b_px) * GS + (NT - 1) * 8);
        b[NT - 1][0] = q2[0], b[NT - 1][1] = q2[1];
      }
#pragma unroll
      for (int i = 0; i < NMPW; ++i) {
        const int mt = warp + 8 * i;
        if (mt >= mtiles) break;
        uint32_t a[4];
        ldsm_x4_trans(a, sX + (r * IW + a_px) * XS + off[2 * mt + a_half]);
#pragma unroll
        for (int ni = 0; ni < NT; ++ni) mma_bf16(acc[i][ni], a, b[ni][0], b[ni][1]);
      }
    }
  }

  // this block's partial sums: every (tap, ci, co) of its tile, zeros included
  const size_t chunk = blockIdx.y;
  float* pw = p.part_w + chunk * 9 * static_cast<size_t>(cin) * Co;
#pragma unroll
  for (int i = 0; i < NMPW; ++i) {
    const int mt = warp + 8 * i;
    if (mt >= mtiles) break;
#pragma unroll
    for (int ni = 0; ni < NT; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = 16 * mt + (lane >> 2) + (e >> 1) * 8;
        const int tap = m / CP, ci = ci0 + m % CP;
        const int co = co0 + ni * 8 + 2 * (lane & 3) + (e & 1);
        if (tap < 9 && ci < cin && co < Co) {
          pw[(static_cast<size_t>(tap) * cin + ci) * Co + co] = acc[i][ni][e];
        }
      }
  }
  if (with_db) {  // the threads' db sums, added in pixel-share order per channel
    dbs[tid] = db;
    __syncthreads();
    if (tid < TCO && co0 + tid < Co) {
      float s = 0.f;
      for (int g = 0; g < DG; ++g) s += dbs[g * TCO + tid];
      p.part_b[chunk * Co + co0 + tid] = s;
    }
  }
}

// ---- the deep path: Ca, Cb and Co multiples of 64 with 256 or more
// channels in or out (the fold-1 blocks' levels).  A block owns a 9-tap x
// 64 input x 64 output channel tile of dw and walks a chunk of DR x DW
// pixel tiles; one k16 step is 16 pixels of a tile row.  Warpgroup ky
// (0..2) owns the taps (ky, 0..2) in registers; warp 12 copies each tile's
// operands, which the prepass transformed and laid out.
constexpr int DR = 2;                       // tile rows
constexpr int DW = 64;                      // tile columns: 4 k16 steps a row
constexpr int DHALO = (DR + 2) * (DW + 2);  // halo pixels
constexpr int DPX = DR * DW;                // tile pixels
constexpr int DXP = DHALO * 8;              // bf16 of one 8-channel plane of the halo
constexpr int DGP = DPX * 8;                // bf16 of one 8-channel plane of the cotangent
constexpr int DSTAGE = 8 * (DXP + DGP);     // bf16 of one staged tile
constexpr int DTHREADS = 512;               // warpgroups 0-2: taps (ky, 0..2); 3: the copies
// registers a thread after the copies' warpgroup hands some to the others
// (128 at the launch): 128 x 32 given, 384 x 8 taken.  Both roles run
// setmaxnreg (warpgroup-wide): without it ptxas serialized the wgmmas of
// the products' role (C7520) behind the branch between the roles.
constexpr int DCOPY_REGS = 96;
constexpr int DPRODUCT_REGS = 136;
constexpr int DCOPIES = 8 * (DR + 2) + 8 * DR;  // bulk copies a tile: halo rows, cotangent rows
constexpr int DSUB = 4096 / DPX;            // tiles a block sums in registers before it flushes
constexpr int DRING = 4;                    // staged tiles in flight
constexpr size_t DBYTES = DRING * static_cast<size_t>(DSTAGE) * sizeof(__nv_bfloat16);
constexpr int DPRE_THREADS = 256;           // the prepass: 32 pixel lanes x 8 planes
constexpr int DPRE_BLOCKS = 132;            // the prepass's blocks along the pixels: its rows of db partials

// Where the deep path's operands lie: the prepass writes them in 8-channel
// planes, rows padded to whole tiles (Hp x Wp pixels) with zeros, so that
// each tile row of a plane is one contiguous run (one bulk copy): ge as
// (B, Co/8, Hp, Wp, 8), act(x) with a one-pixel zero border as (B, Cin/8,
// Hp + 2, Wp + 2, 8).
struct DeepLayout {
  int Hp, Wp;
  __host__ __device__ DeepLayout(int tiles_y, int tiles_x) : Hp(tiles_y * DR), Wp(tiles_x * DW) {}
  __host__ __device__ long long ge_elems(int B, int Co) const {
    return static_cast<long long>(B) * Co * Hp * Wp;
  }
  __host__ __device__ long long x_elems(int B, int Cin) const {
    return static_cast<long long>(B) * Cin * (Hp + 2) * (Wp + 2);
  }
};

// ---- the deep path's prepass: the operands the products read, each
// transformed once (the products' blocks would repeat a transform Cin/64 or
// Co/64 times) and laid out for bulk copies (DeepLayout).  A block takes 64
// channels (blockIdx.y) of every gridDim.x-th row of pixels, a thread 8
// channels (plane j) of every 32nd pixel, so that 8 lanes read one pixel's
// 128 contiguous bytes and 4 lanes write 64 contiguous bytes of a plane.
// What bounds it: bytes (it reads g, y and x once and writes ge and act(x)
// once).
//
// ge = the transformed cotangent, zero outside the image, with one row of
// db partial sums a block: a thread keeps its 8 channels over its pixels,
// and the block adds its 32 pixel lanes in order.
template <int GE>
__global__ void __launch_bounds__(DPRE_THREADS) wgrad_ge_prepass(const Args p, __nv_bfloat16* gep,
                                                                float* part_db) {
  __shared__ float red[DPRE_THREADS][8];
  const int tid = threadIdx.x, H = p.H, W = p.W, Co = p.Co;
  const DeepLayout L(p.tiles_y, p.tiles_x);
  const int cg = blockIdx.y * 8 + (tid & 7), lane = tid >> 3;  // plane, pixel lane
  float r[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (i < (GE == kGeAffine ? 4 : GE == kGeStats ? 2 : 0)) imgseg::load_row8(p.gf + i * Co, 8 * cg, r[i]);
  }
  float db[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (long long u = blockIdx.x; u < static_cast<long long>(p.B) * L.Hp; u += gridDim.x) {
    const int n = static_cast<int>(u / L.Hp), yy = static_cast<int>(u % L.Hp);
    __nv_bfloat16* dst = gep + ((static_cast<size_t>(n) * (Co / 8) + cg) * L.Hp + yy) * L.Wp * 8;
    for (int xx = lane; xx < L.Wp; xx += DPRE_THREADS / 8) {
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (yy < H && xx < W) {
        const size_t at = ((static_cast<size_t>(n) * H + yy) * W + xx) * Co + 8 * cg;
        v = __ldg(reinterpret_cast<const uint4*>(p.g + at));
        if constexpr (GE != kGePlain) {
          v = imgseg::cotangent8<GE == kGeAffine>(r, v, __ldg(reinterpret_cast<const uint4*>(p.y + at)));
        }
        const imgseg::Vec8 e8 = imgseg::as_vec8(v);
#pragma unroll
        for (int e = 0; e < 8; ++e) db[e] += __bfloat162float(e8.v[e]);
      }
      *reinterpret_cast<uint4*>(dst + xx * 8) = v;
    }
  }
#pragma unroll
  for (int e = 0; e < 8; ++e) red[tid][e] = db[e];
  __syncthreads();
  if (tid < 64) {  // channel blockIdx.y * 64 + tid: the pixel lanes in order
    float s = 0.f;
    for (int l = 0; l < DPRE_THREADS / 8; ++l) s += red[8 * l + tid / 8][tid % 8];
    part_db[static_cast<size_t>(blockIdx.x) * Co + blockIdx.y * 64 + tid] = s;
  }
}

// act(x) = [x | xb], or round(relu(x*a + b)), with a one-pixel zero border.
__global__ void __launch_bounds__(DPRE_THREADS) wgrad_x_prepass(const Args p, __nv_bfloat16* xp) {
  const int tid = threadIdx.x, H = p.H, W = p.W, cin = p.Ca + p.Cb;
  const DeepLayout L(p.tiles_y, p.tiles_x);
  const int hp = L.Hp + 2, wp = L.Wp + 2;
  const int cg = blockIdx.y * 8 + (tid & 7), lane = tid >> 3, c = 8 * cg;
  const bool in_b = c >= p.Ca;
  const __nv_bfloat16* src = in_b ? p.xb + (c - p.Ca) : p.x + c;
  const int cs = in_b ? p.Cb : p.Ca;
  const bool pre = p.ab != nullptr && !in_b;
  float ra[8], rb[8];
  if (pre) {
    imgseg::load_row8(p.ab, c, ra);
    imgseg::load_row8(p.ab + p.Ca, c, rb);
  }
  for (long long u = blockIdx.x; u < static_cast<long long>(p.B) * hp; u += gridDim.x) {
    const int n = static_cast<int>(u / hp), hy = static_cast<int>(u % hp), iy = hy - 1;
    __nv_bfloat16* dst = xp + ((static_cast<size_t>(n) * (cin / 8) + cg) * hp + hy) * wp * 8;
    for (int hx = lane; hx < wp; hx += DPRE_THREADS / 8) {
      const int ix = hx - 1;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (iy >= 0 && iy < H && ix >= 0 && ix < W) {
        v = __ldg(reinterpret_cast<const uint4*>(src + ((static_cast<size_t>(n) * H + iy) * W + ix) * cs));
        if (pre) v = imgseg::affine_relu8(ra, rb, v);
      }
      *reinterpret_cast<uint4*>(dst + hx * 8) = v;
    }
  }
}

// Warp 12 (of warpgroup 3): each tile's operands by bulk copies (the TMA engine), one a
// tile row of an 8-channel plane: the halo rows of act(x) and the rows of
// ge, into 8-channel planes of 16-byte pixel rows (the wgmma's MN-major
// core matrices: 8 consecutive pixels a core matrix, so a tap's shift is a
// start address).
__device__ __forceinline__ void wgrad_deep_copies(const Args& p, long long t_begin, long long t_end,
                                                  __nv_bfloat16* stage, uint64_t* full,
                                                  uint64_t* empty, int ci0, int co0,
                                                  const __nv_bfloat16* gep, const __nv_bfloat16* xp) {
  const int lane = threadIdx.x & 31, cin = p.Ca + p.Cb;
  const DeepLayout L(p.tiles_y, p.tiles_x);
  constexpr uint32_t kXRow = (DW + 2) * 16, kGRow = DW * 16;
  for (long long t = t_begin; t < t_end; ++t) {
    const long long k = t - t_begin;
    const int b = static_cast<int>(k % DRING);
    const int x0 = static_cast<int>(t % p.tiles_x) * DW;
    const int y0 = static_cast<int>((t / p.tiles_x) % p.tiles_y) * DR;
    const int n = static_cast<int>(t / (static_cast<long long>(p.tiles_x) * p.tiles_y));
    imgseg::mbar_wait(&empty[b], static_cast<int>((k / DRING) & 1) ^ 1);
    if (lane == 0) imgseg::mbar_arrive_tx(&full[b], 8 * (DR + 2) * kXRow + 8 * DR * kGRow);
    __syncwarp();
    __nv_bfloat16* st = stage + b * DSTAGE;
    for (int i = lane; i < DCOPIES; i += 32) {
      if (i < 8 * (DR + 2)) {  // plane j, halo row hy
        const int j = i / (DR + 2), hy = i % (DR + 2);
        const __nv_bfloat16* src =
            xp + (((static_cast<size_t>(n) * (cin / 8) + ci0 / 8 + j) * (L.Hp + 2) + y0 + hy) * (L.Wp + 2) + x0) * 8;
        imgseg::bulk_copy(st + j * DXP + hy * (DW + 2) * 8, src, kXRow, &full[b]);
      } else {  // plane j, tile row r
        const int j = (i - 8 * (DR + 2)) / DR, r = (i - 8 * (DR + 2)) % DR;
        const __nv_bfloat16* src =
            gep + (((static_cast<size_t>(n) * (p.Co / 8) + co0 / 8 + j) * L.Hp + y0 + r) * L.Wp + x0) * 8;
        imgseg::bulk_copy(st + 8 * DXP + j * DGP + r * DW * 8, src, kGRow, &full[b]);
      }
    }
  }
}

// The consumers: warpgroup ky owns taps (ky, kx), kx = 0..2: M = 64 input
// channels, N = 64 output channels, K = the pixels.
__device__ __forceinline__ void wgrad_deep_products(const Args& p, const __nv_bfloat16* stage,
                                                    uint64_t* full, uint64_t* empty,
                                                    long long t_begin, long long t_end, int ci0,
                                                    int co0) {
  const int Co = p.Co, cin = p.Ca + p.Cb;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ky = warp / 4, w = warp & 3;
  float acc[3][32];
  int pend = -1;  // the stage the group in flight reads
  float* pw = p.part_w + static_cast<size_t>(blockIdx.y) * 9 * cin * Co;
  // sub-chunks of DSUB tiles: summed in registers, then added into this
  // chunk's rows of partials (the first stores)
  for (long long s0 = t_begin; s0 < t_end; s0 += DSUB) {
    const long long s1 = s0 + DSUB < t_end ? s0 + DSUB : t_end;
    for (long long t = s0; t < s1; ++t) {
      const long long k = t - t_begin;
      const int b = static_cast<int>(k % DRING);
      imgseg::mbar_wait(&full[b], static_cast<int>((k / DRING) & 1));
      const __nv_bfloat16* sx = stage + b * DSTAGE;
      const __nv_bfloat16* sg = sx + 8 * DXP;
      imgseg::wgmma_fence();
#pragma unroll 1
      for (int r = 0; r < DR; ++r) {
        const int keep = t != s0 || r != 0;  // the sub-chunk's first k16 step overwrites
#pragma unroll
        for (int ks = 0; ks < DW / 16; ++ks) {
          // B: the cotangent, MN-major: K-adjacent cores 128 bytes apart, N-adjacent a plane
          const uint64_t db = imgseg::wgmma_desc(sg + (r * DW + 16 * ks) * 8, 128, DGP * 2);
#pragma unroll
          for (int kx = 0; kx < 3; ++kx) {
            // A: act(x) shifted by the tap, MN-major: M-adjacent (8 channels) a plane
            const uint64_t da =
                imgseg::wgmma_desc(sx + ((r + ky) * (DW + 2) + kx + 16 * ks) * 8, 128, DXP * 2);
            imgseg::wgmma<1, 1, 8>(acc[kx], da, db, keep | ks);
          }
        }
      }
      imgseg::wgmma_commit();
      imgseg::wgmma_wait<1>();  // the previous tile's group is done: free its stage
      if (lane == 0 && pend >= 0) imgseg::mbar_arrive(&empty[pend]);
      pend = b;
    }
    imgseg::wgmma_wait<0>();
#pragma unroll
    for (int kx = 0; kx < 3; ++kx) imgseg::fence_acc(acc[kx]);
    if (lane == 0) imgseg::mbar_arrive(&empty[pend]);
    pend = -1;
    const bool first = s0 == t_begin;
#pragma unroll
    for (int kx = 0; kx < 3; ++kx)
#pragma unroll
      for (int t = 0; t < 8; ++t)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int ci = ci0 + 16 * w + (lane >> 2) + 8 * h;
          const int co = co0 + 8 * t + 2 * (lane & 3);
          float2* dst = reinterpret_cast<float2*>(pw + (static_cast<size_t>(ky * 3 + kx) * cin + ci) * Co + co);
          float2 v = make_float2(acc[kx][4 * t + 2 * h], acc[kx][4 * t + 2 * h + 1]);
          if (!first) {
            const float2 o = *dst;
            v.x += o.x, v.y += o.y;
          }
          *dst = v;
        }
  }
}

__global__ void __launch_bounds__(DTHREADS, 1) wgrad_deep_kernel(const Args p, const __nv_bfloat16* gep,
                                                                  const __nv_bfloat16* xp) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* stage = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __shared__ uint64_t full[DRING], empty[DRING];

  const int tid = threadIdx.x, warp = tid >> 5;
  const int co_tiles = p.Co / 64;
  const int ci0 = (blockIdx.x / co_tiles) * 64, co0 = (blockIdx.x % co_tiles) * 64;
  const long long t_begin = static_cast<long long>(blockIdx.y) * p.per_chunk;
  const long long t_end = t_begin + p.per_chunk < p.tiles ? t_begin + p.per_chunk : p.tiles;

  if (tid == 0) {
    for (int i = 0; i < DRING; ++i) {
      imgseg::mbar_init(&full[i], 1);    // the copies' warp, and their bytes
      imgseg::mbar_init(&empty[i], 12);  // lane 0 of each consumer warp
    }
    imgseg::fence_barrier_init();
  }
  __syncthreads();

  if (warp >= 12) {
    imgseg::reg_dealloc<DCOPY_REGS>();
    if (warp == 12) wgrad_deep_copies(p, t_begin, t_end, stage, full, empty, ci0, co0, gep, xp);
  } else {
    imgseg::reg_alloc<DPRODUCT_REGS>();
    wgrad_deep_products(p, stage, full, empty, t_begin, t_end, ci0, co0);
  }
}

// Floats of the deep path's scratch past its chunks' rows: ge and act(x)
// in bf16 (DeepLayout), and the prepass's rows of db, each from a 16-byte
// boundary.
inline long long f16(long long floats) { return (floats + 3) / 4 * 4; }

inline long long deep_extra(int B, int H, int W, int Cin, int Co) {
  const DeepLayout L((H + DR - 1) / DR, (W + DW - 1) / DW);
  return f16(L.ge_elems(B, Co) / 2) + f16(L.x_elems(B, Cin) / 2) + f16(static_cast<long long>(DPRE_BLOCKS) * Co);
}

// The kernels' paths (imgseg_conv3x3_wgrad_path).
enum Path { kVector = 0, kNarrow = 1, kDeep = 2 };

struct Plan {
  int tiles_x, tiles_y, combos;
  int cp, nt;  // the narrow path's input channels per tile (cp = 0 elsewhere); n8 tiles of a dw tile
  long long tiles, chunks, per_chunk;
};

// The card's SMs: the vector and deep kernels' blocks, one an SM.
int sm_count() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 132;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) return 132;
  return sms > 0 ? sms : 132;
}

// As many chunks as fill one wave beside `combos` tiles of dw (one block
// an SM), every chunk non-empty.
void one_wave(Plan& q) {
  q.chunks = sm_count() / q.combos;
  q.chunks = q.chunks < 1 ? 1 : q.chunks > q.tiles ? q.tiles : q.chunks;
  q.per_chunk = (q.tiles + q.chunks - 1) / q.chunks;
  q.chunks = (q.tiles + q.per_chunk - 1) / q.per_chunk;
}

Plan plan(int B, int H, int W, int Cin, int Co, int path) {
  Plan q{};
  if (path == kDeep) {
    q.tiles_x = (W + DW - 1) / DW;
    q.tiles_y = (H + DR - 1) / DR;
    q.tiles = static_cast<long long>(B) * q.tiles_x * q.tiles_y;
    q.combos = (Cin / 64) * (Co / 64);
    one_wave(q);
    return q;
  }
  q.nt = Co <= 8 ? 1 : Co <= 16 ? 2 : 4;
  if (path == kVector) {
    // units: strips of one image row; TCO = 16, 32 or 64
    q.nt = Co <= 16 ? 2 : Co <= 32 ? 4 : 8;
    q.tiles_x = (W + VSW - 1) / VSW;
    q.tiles_y = H;
    q.tiles = static_cast<long long>(B) * q.tiles_x * H;
    q.combos = ((Cin + VTCI - 1) / VTCI) * ((Co + 8 * q.nt - 1) / (8 * q.nt));
    one_wave(q);
    return q;
  }
  q.tiles_x = (W + TW - 1) / TW;
  q.tiles_y = (H + NTH - 1) / NTH;
  q.tiles = static_cast<long long>(B) * q.tiles_x * q.tiles_y;
  q.cp = Cin > NCP ? NCP : (Cin + 7) / 8 * 8;
  q.combos = ((Cin + q.cp - 1) / q.cp) * ((Co + 8 * q.nt - 1) / (8 * q.nt));
  q.chunks = imgseg::chunks_for(q.tiles, q.combos);
  q.per_chunk = (q.tiles + q.chunks - 1) / q.chunks;
  return q;
}

template <int GE, int NT>
cudaError_t launch_vec(const Args& p, const Plan& q, cudaStream_t s) {
  static bool opted = false;
  auto* kernel = wgrad_vec_kernel<GE, NT>;
  const cudaError_t err = imgseg::allow_smem(kernel, vec_bytes(NT), opted);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(q.combos, static_cast<unsigned>(q.chunks)), VTHREADS, vec_bytes(NT), s>>>(p);
  return cudaGetLastError();
}

// The narrow kernel: no more chunks than blocks fit on the card at once, so
// that one wave runs them all; the count depends only on the shape and
// the card, and so does the order of every sum.
template <int GE, int NT>
cudaError_t launch_narrow(Args& p, Plan& q, cudaStream_t s) {
  static bool opted = false;
  auto* kernel = wgrad_narrow_kernel<GE, NT>;
  // opted in once to the most any shape takes: 24-channel tiles of x and xb, 32 of g and y
  cudaError_t err = imgseg::allow_smem(kernel, narrow_bytes(NCP, NT, NCP, NCP, 8 * NT + 1, true), opted);
  if (err != cudaSuccess) return err;
  const size_t bytes = narrow_bytes(p.cp, NT, p.Ca, p.Cb, p.Co, GE != kGePlain);
  static size_t asked = 0;  // the last size asked about, and its answer
  static int resident = 0;
  if (bytes != asked) {
    err = imgseg::resident_blocks(kernel, NTHREADS, bytes, resident);
    if (err != cudaSuccess) return err;
    asked = bytes;
  }
  const long long per = resident / q.combos > 1 ? resident / q.combos : 1;
  if (per < q.chunks) {
    q.chunks = per;
    q.per_chunk = p.per_chunk = (q.tiles + q.chunks - 1) / q.chunks;
  }
  kernel<<<dim3(q.combos, static_cast<unsigned>(q.chunks)), NTHREADS, bytes, s>>>(p);
  return cudaGetLastError();
}

// The deep path: the prepass, then the products on its operands, then
// db's rows from the prepass (the caller adds dw's chunks).
template <int GE>
cudaError_t launch_deep(Args& p, const Plan& q, cudaStream_t s) {
  static bool opted = false;
  const cudaError_t err = imgseg::allow_smem(wgrad_deep_kernel, DBYTES, opted);
  if (err != cudaSuccess) return err;
  const DeepLayout L(p.tiles_y, p.tiles_x);
  float* at = p.part_b + f16(p.Co);
  __nv_bfloat16* gep = reinterpret_cast<__nv_bfloat16*>(at);
  at += f16(L.ge_elems(p.B, p.Co) / 2);
  __nv_bfloat16* xp = reinterpret_cast<__nv_bfloat16*>(at);
  float* part_db = at + f16(L.x_elems(p.B, p.Ca + p.Cb) / 2);
  wgrad_ge_prepass<GE><<<dim3(DPRE_BLOCKS, p.Co / 64), DPRE_THREADS, 0, s>>>(p, gep, part_db);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  wgrad_x_prepass<<<dim3(DPRE_BLOCKS, (p.Ca + p.Cb) / 64), DPRE_THREADS, 0, s>>>(p, xp);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  wgrad_deep_kernel<<<dim3(q.combos, static_cast<unsigned>(q.chunks)), DTHREADS, DBYTES, s>>>(p, gep, xp);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  p.part_b = part_db;  // db's rows: the prepass's blocks
  return cudaSuccess;
}

template <int GE>
cudaError_t launch(Args& p, Plan& q, int path, cudaStream_t s) {
  if (path == kDeep) return launch_deep<GE>(p, q, s);
  if (path == kNarrow) {
    return q.nt == 1 ? launch_narrow<GE, 1>(p, q, s)
           : q.nt == 2 ? launch_narrow<GE, 2>(p, q, s)
                       : launch_narrow<GE, 4>(p, q, s);
  }
  return q.nt == 2 ? launch_vec<GE, 2>(p, q, s)
         : q.nt == 4 ? launch_vec<GE, 4>(p, q, s)
                     : launch_vec<GE, 8>(p, q, s);
}

bool aligned16(const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16 == 0; }

int g_last_path = kVector;  // the path of the latest launch (imgseg_conv3x3_wgrad_path)

}  // namespace

// Floats of scratch: a (9, Cin, Co) and a (Co) row per chunk; `deep` as
// imgseg_conv3x3_wgrad's (the deep path's chunks), else for the vector or
// narrow path, whichever has more chunks.
extern "C" long long imgseg_conv3x3_wgrad_scratch(int B, int H, int W, int Cin, int Co, int deep) {
  long long chunks;
  if (deep) {
    chunks = plan(B, H, W, Cin, Co, kDeep).chunks;
    return chunks * (9LL * Cin * Co + Co) + deep_extra(B, H, W, Cin, Co);
  } else {
    const long long vec = plan(B, H, W, Cin, Co, kVector).chunks;
    const long long nar = plan(B, H, W, Cin, Co, kNarrow).chunks;
    chunks = vec > nar ? vec : nar;
  }
  return chunks * (9LL * Cin * Co + Co);
}

// The path of the latest launch of imgseg_conv3x3_wgrad: 0 vector, 1
// narrow, 2 deep.
extern "C" int imgseg_conv3x3_wgrad_path() { return g_last_path; }

// dw (9, Ca+Cb, Co) and db (Co), fp32.  g, y (B,H,W,Co); gf (2|4, Co) rows
// of the cotangent transform, `affine` selecting the 4-row form, or no gf
// (and no y): the cotangent g itself; x
// (B,H,W,Ca) with xb (B,H,W,Cb) or the pre-affine ab (2, Ca).  `path`
// (ops/fused_conv._path_arg): 0 the narrow path, 1 the vector path (Ca, Cb
// and Co multiples of 8), 64 or 128 the deep path (multiples of 64), the
// last two on 16-byte aligned operands; the library refuses a path it
// cannot take and chooses none.
extern "C" int imgseg_conv3x3_wgrad(const void* g, const void* y, const void* gf, const void* x,
                                    const void* xb, const void* ab, void* dw, void* db,
                                    void* scratch, int B, int H, int W, int Ca, int Cb, int Co,
                                    int affine, int path, void* stream) {
  const int cin = Ca + Cb;
  if (B <= 0 || H <= 0 || W <= 0 || Co <= 0 || cin <= 0) return static_cast<int>(cudaSuccess);
  const bool aligned = aligned16(x) && aligned16(xb) && aligned16(ab) && aligned16(g) &&
                       aligned16(y) && aligned16(gf);
  const int invalid = static_cast<int>(cudaErrorInvalidValue);
  if (path == 64 || path == 128) {
    if (Ca % 64 || Cb % 64 || Co % 64 || !aligned) return invalid;
    path = kDeep;
  } else if (path == 1) {
    if (Ca % 8 || Cb % 8 || Co % 8 || !aligned) return invalid;
    path = kVector;
  } else if (path == 0) {
    path = kNarrow;
  } else {
    return invalid;
  }
  Plan q = plan(B, H, W, cin, Co, path);
  if (q.chunks > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
  g_last_path = path;
  Args p{};
  p.g = static_cast<const __nv_bfloat16*>(g);
  p.y = static_cast<const __nv_bfloat16*>(y);
  p.gf = static_cast<const float*>(gf);
  p.x = static_cast<const __nv_bfloat16*>(x);
  p.xb = static_cast<const __nv_bfloat16*>(xb);
  p.ab = static_cast<const float*>(ab);
  p.part_w = static_cast<float*>(scratch);
  p.part_b = p.part_w + q.chunks * 9LL * cin * Co;  // the narrow launch may take fewer chunks
  p.B = B, p.H = H, p.W = W, p.Ca = Ca, p.Cb = Cb, p.Co = Co;
  p.tiles_x = q.tiles_x, p.tiles_y = q.tiles_y, p.tiles = q.tiles, p.per_chunk = q.per_chunk;
  p.cp = q.cp;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (gf == nullptr) {
    err = launch<kGePlain>(p, q, path, s);
  } else if (affine) {
    err = launch<kGeAffine>(p, q, path, s);
  } else {
    err = launch<kGeStats>(p, q, path, s);
  }
  if (err == cudaSuccess) {
    err = imgseg::sum_rows(p.part_w, static_cast<float*>(dw), q.chunks, 9LL * cin * Co, s);
  }
  const long long db_rows = path == kDeep ? DPRE_BLOCKS : q.chunks;
  if (err == cudaSuccess) err = imgseg::sum_rows(p.part_b, static_cast<float*>(db), db_rows, Co, s);
  return static_cast<int>(err);
}
