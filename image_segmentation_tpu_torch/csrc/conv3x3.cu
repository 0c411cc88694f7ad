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
// The vector path takes Ca, Cb and Co multiples of 8 on 16-byte aligned
// operands whose weights fit its shared memory: K (the forward's Cin, the
// dgrad's Co), padded to 16, at most 192, or 160 where N (the other side) is
// at most 16.  That is every level 0-1 conv of every U-Net (32-128 channels
// at 512^2 and 256^2 in large_unet at batch 16).  The caller chooses the
// path (ops/fused_conv.conv_path, one rule for the forward, the dx and the
// wgrad); the library refuses one it cannot take.  A conv does 18*Cin*Co FLOPs per
// output pixel against 2*(Cin + Co) bytes moved, so what bounds it on the
// card depends on the shape: bytes at enc1.conv1 (32 -> 64: 0.240 ms of
// bytes against 0.156 of FLOPs at 3.35 TB/s and 989 TFLOP/s), enc1.conv2,
// dec5.conv1 and dec5.conv2; the tensor cores at enc2.conv1, enc2.conv2 and
// dec4.conv1 (128 -> 128: 0.313 ms of FLOPs against 0.160 of bytes); the
// two nearly equal at dec4.conv2.  The dgrad moves more bytes (g, and y
// beside it for the cotangent transform, and xpost for the post adjoint).
// The operands are bf16 (every on-load
// transform ends in a bf16 rounding), so a bf16 x bf16 product is exact in
// fp32 and the tensor cores compute the same sums as fp32 FMAs, in another
// order.
//
// The vector path's kernel (vec_kernel; see its section) runs the forward
// and the dgrad alike, the dgrad as the conv of the transformed cotangent
// with the flipped, transposed weights (K = the forward's Co, N = its Cin;
// ops/fused_conv.vector_pack packs them).  It reads its operand once and
// keeps the weights resident: one wave of persistent blocks, each holding
// the whole 9 x K x N weight tile in shared memory (147 KB at K = 128, N =
// 64) and walking a run of 128-pixel strips of consecutive rows with a ring
// of operand rows, each row transformed in place once per N tile (the
// forward's pre-affine + ReLU; the cotangent transform, by the copying
// warpgroup from y staged beside g where that fits, else by the consumers
// from y read from global memory); the products are wgmma with both
// operands read from shared memory by descriptor.  Its epilogues: the forward's bias and
// statistics, the dgrad's post adjoint and its split of dx.

// The narrow path (narrow_kernel) takes every other shape: a channel count
// that is not a multiple of 8 (ClipRes's output block, [16 | 3] -> 3 and
// 3 -> 3, its dx from a 3-channel cotangent; the prompt heatmap, 1 -> 32),
// a split not at a multiple of 8, more input channels than the vector
// path's weights fit, an operand off a 16-byte boundary.  What bounds it on the
// card: bytes.  At 3 output channels a pixel does 2*9*19*3 FLOPs against
// ~44 bytes moved, far below the ridge.  What cost was the staging: a
// 128-pixel block padded K and N to 32, so 94 % of the weights it staged
// for out.conv1 were zeros, each element with its own load and index
// arithmetic.  What the design does about it: a tile's operand arrives as
// runs, the stretches of NHWC memory it covers (a halo row of IW pixels x
// C channels is one run where one stage holds every channel), each run one
// bulk copy of the TMA engine (cp.async.bulk, aligned down at the head and
// up at the tail) counted on an mbarrier; a second pass places 8 channels
// of a pixel a thread, transformed in registers (mul and add rounded
// apart), into rows padded only to KP = Cin rounded up to 8 (32 a stage
// past 32 channels).  N is 8, 16 or 32 (8 for 3 outputs, not 32).  A block
// stays on the card (as many as fit) and walks its 16x16-pixel tiles, its
// weights staged once, the next tile's runs copied while this tile's mma
// and epilogue run.  K is 9 taps x KP in 8-wide halves on the vector
// path's ldmatrix / mma.sync core: with KP = 8 one k16 step carries two
// taps (per-lane ldmatrix row pointers), 5 steps, not 9.  The epilogue
// writes each tile row through shared memory in the output's own layout
// and stores it as 16-byte words (16 pixels x 3 channels are one 96-byte
// run); a block's sums are one row of partials.  Measured share of the
// bound: PERF.md (section 6, the output block's rows).
//
// The deep path (deep_kernel) takes Ca, Cb and Co multiples of 64 with 256
// or more channels in or out, as the caller's rule (ops/fused_conv.
// conv_path) says: the fold-1 blocks of fused_deep, 128-512 channels at
// 1/4 and 1/8 of the image side, whose whole weights do not fit in shared
// memory.  What bounds it: the tensor cores (2*9*Cin*Co FLOPs a pixel
// against ~2*(Cin+Co) bytes).  What the design does about it: an implicit GEMM on Hopper's wgmma (bf16
// in, fp32 sums) with both operands read from shared memory by descriptor.
// A persistent block (one an SM) walks tiles of 4 x 64 output pixels (M =
// 256, one image row a m64 wgmma tile) by N = 64 or 128 output channels; K
// is 9 taps x Cin in 64-channel stages, so a block reads the weights once
// per 256 pixels.  Warpgroup 0 produces: warp 0 keeps a ring of 4 weight
// tiles (one tap x 64 channels x N, packed by the wrapper as the wgmma's
// K-major core matrices) full with one bulk copy each, on mbarriers; warps
// 1-3 stage each 64-channel stage of the (4+2) x (64+2) halo, transformed
// in registers (the affine + ReLU, [x | xb], or the cotangent transform)
// and zero outside the image after the transform, into 8-channel planes of
// 16-byte pixel rows, double-buffered: a plane's 8 consecutive pixels are
// a core matrix of A, so a tap's shift of one pixel is a start address
// 16 bytes on (no swizzle).  Warpgroups 1 and 2 each run two m64 x N x 16
// wgmmas a k16 step, one commit group a tap, and free a ring slot or a
// halo once the group after it is committed and the one before it is done;
// a tile's epilogue overlaps the producer's next loads.  The epilogues are
// the vector path's, on the wgmma accumulators (the m16n8 layout repeated
// over N/8); sums go to one row of partials a block (reduce.cuh).  No
// atomics, and no fallback: a shape the rule gives this path launches this
// kernel or the call fails.  Measured share of the bound: PERF.md
// (section 6, the fold-1 rows).

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

constexpr int TW = 16;    // the narrow path's tile columns: one m16 tile a row
constexpr int IW = TW + 2;
constexpr int THREADS = 256;  // the narrow path's block

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
  int kp;  // the narrow path: channels per stage, padded to a multiple of 8
  int tiles_x, tiles_y, nblk;  // the narrow and deep paths: pixel tiles; blocks along them
  int deep;  // the deep path: its N tile (64 or 128), else 0
  // the vector path: pixels a unit (a strip of one row), K padded to a
  // multiple of 16, the N tile, whether the two consumer warpgroups split
  // N (else the strip)
  int vsw, vcpad, vntile, vsplit, vxr;  // and the operand rows in its ring
  int vy;  // the dgrad's y planes in a ring slot, after g's (0: y is read from global memory)
  long long tiles, per_chunk;
};

// The post adjoint of one element (the fp32 sum v, xpost's value xv, the
// affine a, b): gu = v*[xv*a + b > 0], out = round(gu*a), and the sums of
// gu*xv and gu (mul and add rounded separately, as the plain version does).
__device__ __forceinline__ __nv_bfloat16 post1(float v, float xv, float a, float b, float& s1,
                                               float& s2) {
  const float gu = __fadd_rn(__fmul_rn(xv, a), b) > 0.f ? v : 0.f;
  s1 += __fmul_rn(gu, xv);
  s2 += gu;
  return __float2bfloat16(__fmul_rn(gu, a));
}

// The epilogue of one output element (channel c < Co at pixel `pix`, the
// fp32 sum v): its bf16 value, and the sums of the statistics or the post
// adjoint.
template <int EPI>
__device__ __forceinline__ __nv_bfloat16 epi1(const Args& p, size_t pix, int c, float v, float& s1,
                                              float& s2) {
  if constexpr (EPI == kEpiPost) {
    const int Co = p.Co;
    return post1(v, __bfloat162float(p.xpost[pix * Co + c]), p.abpost[c], p.abpost[Co + c], s1, s2);
  } else {
    const __nv_bfloat16 r = __float2bfloat16(v);
    if constexpr (EPI == kEpiStats) {  // statistics of the ROUNDED output
      const float f = __bfloat162float(r);
      s1 += f;
      s2 += __fmul_rn(f, f);
    }
    return r;
  }
}

// The deep path's epilogue of output channels gco, gco+1 at pixel `pix`
// (Co and Na multiples of 2): one 4-byte store.
template <int EPI>
__device__ __forceinline__ void emit(const Args& p, size_t pix, int gco, const float (&v)[2],
                                     float (&s1)[2], float (&s2)[2]) {
  const __nv_bfloat16 r0 = epi1<EPI>(p, pix, gco, v[0], s1[0], s2[0]);
  const __nv_bfloat16 r1 = epi1<EPI>(p, pix, gco + 1, v[1], s1[1], s2[1]);
  __nv_bfloat162* dst;
  if (EPI == kEpiSplit && gco >= p.Na) {
    dst = reinterpret_cast<__nv_bfloat162*>(p.out_b + pix * (p.Co - p.Na) + (gco - p.Na));
  } else {
    const int C = EPI == kEpiSplit ? p.Na : p.Co;
    dst = reinterpret_cast<__nv_bfloat162*>(p.out + pix * C + gco);
  }
  *dst = __halves2bfloat162(r0, r1);
}

// ---- the vector path (vec_kernel): the forward ([x | xb], or the
// pre-affine on load; the eval or the stats epilogue) and the dgrad (the
// cotangent g, transformed or as it is; the store, the post or the split
// epilogue).  A block holds the 9 x K x N weights of its N tile
// (blockIdx.x) in shared memory for its whole run of units (mma.cuh
// UnitWalk: a unit is an sw-pixel strip of one output row; blockIdx.y picks
// the run).  Warpgroup 0 copies: a bulk copy a tap of the weights, once,
// then each new operand row of the run by 16-byte cp.async (zero-filled
// outside the image and past K) into a ring of vxr slots of 8-channel
// planes (the wgmma's K-major core matrices of A: 8 consecutive pixels of a
// plane, so a tap's shift of one pixel is a start address 16 bytes on), as
// many rows ahead as the ring holds, the copies counted on the slot's
// `landed` barrier; with the dgrad's cotangent transform also the row of y
// into the slot's second half, where it fits, and then the transform of the
// row in place before it counts it landed.  Warpgroups 1 and 2 transform a
// unit's new rows in place where the mode has a transform the copies do
// not (the forward's pre-affine + ReLU; the cotangent transform where the
// ring does not hold y: at K = 128, reading y from global memory), then
// each runs one m64 (pixels) x n(8 NT) x k16 wgmma a (tap, 16 channels), A
// from the ring's row y + ky - 1 and B from the resident weights, both by
// descriptor: with sw = 128 they take the two 64-pixel halves of the strip
// at all N channels, with sw = 64 (where 128-pixel rows and the weights do
// not fit together, K = 128, and for the post adjoint's N tiles of 64 and
// 128) the two halves of N.  A unit's epilogue runs
// while the next unit's wgmmas do (two accumulator sets); its stores go
// through shared memory as 16-byte words, its sums into registers.  What
// limits it (PERF.md, section 6): the wgmmas, at a third of the tensor
// cores' rate with N = 64 and less with the halves of N at K = 128.
constexpr int FXR_MIN = 4;      // operand rows in the ring: the three a unit reads and one ahead
constexpr int FXR_MAX = 8;      // and at most, where the weights leave room
constexpr int FTHREADS = 384;   // warpgroup 0 copies; 1 and 2 transform and run the products
constexpr int FSTAGERS = 128;
constexpr int FCONSUMERS = FTHREADS - FSTAGERS;
// registers a thread after the copying warpgroup hands some to the others
// (168 at the launch): 128 x 112 given, 256 x 56 taken; 128 x 96 and 256 x
// 48 where the copying warpgroup may apply the cotangent transform
// (copier_modes).  setmaxnreg.inc takes only what the block's own
// setmaxnreg.dec gave back, and waits for it: the two must balance
// exactly, or the consumers wait forever
constexpr int FLAUNCH_REGS = 168;
constexpr int FSTAGE_REGS = 56, FSTAGE_REGS_GE = 72;
constexpr int FPRODUCT_REGS = 224, FPRODUCT_REGS_GE = 216;
static_assert((FLAUNCH_REGS - FSTAGE_REGS) * FSTAGERS == (FPRODUCT_REGS - FLAUNCH_REGS) * FCONSUMERS &&
                  (FLAUNCH_REGS - FSTAGE_REGS_GE) * FSTAGERS ==
                      (FPRODUCT_REGS_GE - FLAUNCH_REGS) * FCONSUMERS,
              "the registers given and taken balance");
constexpr size_t FSMEM = 226 * 1024;  // dynamic shared memory a block may take
constexpr int FEC = 32;       // output channels a consumer warp stores at a time
constexpr int FES = FEC + 8;  // their row stride in shared memory (bf16): no bank conflicts
// the transform's rows of K channels: the forward's pre-affine [a, b]; the
// dgrad's cotangent transform [c1, c2], or [a, b, c1, c2] with the affine
constexpr int FROWS_FWD = 2;
constexpr int FROWS_DGRAD = 4;

__host__ __device__ constexpr int vec_rows(int load) { return load == kLoadX ? FROWS_FWD : FROWS_DGRAD; }

// The elements between two 8-channel planes of an operand row of sw + 2 pixels.
__host__ __device__ constexpr int fwd_xp(int sw) { return (sw + 2) * 8; }

// Bytes of a block's shared memory, in this order: the weights (9 x cpad x
// ntile bf16), the operand ring (xr x cpad x (sw + 2) bf16, twice that
// with the dgrad's rows of y beside g: yring), the consumer
// warps' output rows (8 x 16 x FES bf16; after the last unit the sum
// epilogues' rows, 8 warps x 2 x ntile fp32, take their place), the
// transform's rows (nrows x cpad fp32), the epilogue's rows (2 x ntile
// fp32: the bias, or the post affine).
__host__ __device__ constexpr size_t fvec_bytes(int sw, int cpad, int ntile, int xr, int nrows,
                                                int yring = 0) {
  return (static_cast<size_t>(9) * cpad * ntile +
          static_cast<size_t>(xr) * (1 + yring) * (cpad / 8) * fwd_xp(sw) +
          8 * 16 * FES) * sizeof(__nv_bfloat16) +
         (static_cast<size_t>(nrows) * cpad + 2 * static_cast<size_t>(ntile)) * sizeof(float);
}
static_assert(8 * 2 * 128 * sizeof(float) <= 8 * 16 * FES * sizeof(__nv_bfloat16),
              "the sum rows of an N tile of 128 fit in the output rows' place");

// The most K channels (padded to 16) the vector path takes, as
// ops/fused_conv.conv_path states them: the forward's K is Cin
// (VECTOR_CIN, VECTOR_CIN_N16; its N is Co), the dgrad's K is Co
// (VECTOR_DGRAD_CO, VECTOR_DGRAD_CO_N16; its N is Cin).  The weights of an N
// tile of 32 on 64-pixel strips fit up to K = 192, those of an N tile of
// 16 (N <= 16) on 128-pixel strips up to 160, beside either's transform
// rows (the dgrad with y read from global memory where its ring does not fit).
static_assert(fvec_bytes(64, 192, 32, FXR_MIN, FROWS_FWD) <= FSMEM &&
                  fvec_bytes(64, 208, 32, FXR_MIN, FROWS_FWD) > FSMEM,
              "conv_path's VECTOR_CIN is the most the vector forward fits");
static_assert(fvec_bytes(128, 160, 16, FXR_MIN, FROWS_FWD) <= FSMEM &&
                  fvec_bytes(128, 176, 16, FXR_MIN, FROWS_FWD) > FSMEM,
              "conv_path's VECTOR_CIN_N16 is the most the vector forward fits at Co <= 16");
static_assert(fvec_bytes(64, 192, 32, FXR_MIN, FROWS_DGRAD) <= FSMEM &&
                  fvec_bytes(64, 208, 32, FXR_MIN, FROWS_DGRAD) > FSMEM,
              "conv_path's VECTOR_DGRAD_CO is the most the vector dgrad fits");
static_assert(fvec_bytes(128, 160, 16, FXR_MIN, FROWS_DGRAD) <= FSMEM &&
                  fvec_bytes(128, 176, 16, FXR_MIN, FROWS_DGRAD) > FSMEM,
              "conv_path's VECTOR_DGRAD_CO_N16 is the most the vector dgrad fits at Cin <= 16");

// The vector path's tiles for a K -> N conv (the forward's Cin -> Co, the
// dgrad's Co -> Cin) on rows of w pixels, with nrows transform rows: K
// padded to cpad (a multiple of 16: one k16 step is two planes), N tile
// ntile (16, 32, 64 or 128, past N zero weights), strips of 128 pixels
// with the two consumer warpgroups on its halves, else (rows of 64 pixels
// or fewer, whose second half would be empty; 128-pixel rows and the
// weights not fitting together) of 64 with the two on halves of N; the
// largest N tile that fits in FSMEM with FXR_MIN rows, then as many more
// rows as fit, up to FXR_MAX; at most max_nt n8 tiles a consumer
// warpgroup (8: at 16 the epilogues spill, and the forward's 64 -> 128
// ran slower so; the post adjoint 4, so that an N tile of 64 is split: at
// 8 its epilogue spills).  With `yring` (the dgrad's cotangent transform) the ring
// holds y beside g where that N tile fits so (K <= 64: there the products
// are short and the transform's wait for y would bound the unit; at K =
// 128 they are long enough to hide it, and the ring would halve the N
// tile).  False where none fits.
bool vec_plan(int k, int n_out, int w, int nrows, int max_nt, bool yring, Args& p) {
  p.vcpad = (k + 15) / 16 * 16;
  int n = 16;
  while (n < n_out && n < 128) n *= 2;
  for (; n >= 16; n /= 2) {
    for (int yr = yring ? 1 : 0; yr >= 0; --yr) {
      for (int sw = w <= 64 && n >= 32 ? 64 : 128; sw >= 64; sw /= 2) {
        if (sw == 64 && n < 32) break;
        if ((sw == 64 ? n / 2 : n) / 8 > max_nt) continue;
        const size_t base = fvec_bytes(sw, p.vcpad, n, FXR_MIN, nrows, yr);
        if (base > FSMEM) continue;
        const size_t slot = static_cast<size_t>(1 + yr) * (p.vcpad / 8) * fwd_xp(sw) * sizeof(__nv_bfloat16);
        const size_t more = (FSMEM - base) / slot;
        p.vsw = sw, p.vsplit = sw == 64, p.vntile = n, p.vy = yr * p.vcpad / 8;
        p.vxr = FXR_MIN + static_cast<int>(more < FXR_MAX - FXR_MIN ? more : FXR_MAX - FXR_MIN);
        return true;
      }
    }
  }
  return false;
}

// A thread's walk over the 16-byte vectors of an operand row, among T
// threads (G = T / 8 groups of 8 lanes): its vectors are T m + t, vector i
// being plane j = (i / 8) % KB at pixel hx = 8 ((i / 8) / KB) + i % 8 of the
// sw + 2, so 8 lanes touch 128 contiguous bytes; kept incrementally.
struct RowVecs {
  int j0, h0, dj, dh, KB, pl;
  __device__ __forceinline__ RowVecs(int t, int T, int kb)
      : j0((t >> 3) % kb), h0((t >> 3) / kb), dj((T >> 3) % kb), dh((T >> 3) / kb), KB(kb), pl(t & 7) {}
  __device__ __forceinline__ void step(int& j, int& h8) const {
    j += dj, h8 += dh;
    if (j >= KB) j -= KB, ++h8;
  }
};

// One operand row's vectors of this consumer thread, transformed in place
// (dst: the row's slot), U at a time: their y first (YS: from the slot's
// planes vy..; else from global memory, the U loads in flight together),
// then the transform.  Outside the image and past K nothing is written.
template <int LOAD, int U, bool YS>
__device__ __forceinline__ void vec_transform_row(const Args& p, __nv_bfloat16* dst,
                                                  const __nv_bfloat16* yrow, const float* rows,
                                                  const RowVecs& rv, int x0) {
  const int W = p.W, cin = p.Ca + p.Cb, sw = p.vsw;
  const int KB = p.vcpad / 8, XP = fwd_xp(sw), H8 = (sw + 2 + 7) / 8;
  for (int j = rv.j0, h8 = rv.h0; h8 < H8;) {
    int at[U], c[U];  // the vector's place in the slot (-1: none), its channel
    uint4 yv[U];
#pragma unroll
    for (int u = 0; u < U; ++u, rv.step(j, h8)) {
      const int hx = 8 * h8 + rv.pl, ix = x0 - 1 + hx;
      c[u] = 8 * j;
      const bool ok = h8 < H8 && hx < sw + 2 && c[u] < cin && ix >= 0 && ix < W;
      at[u] = ok ? j * XP + hx * 8 : -1;
      if constexpr (LOAD != kLoadX) {
        yv[u] = !ok ? make_uint4(0u, 0u, 0u, 0u)
                : YS ? *reinterpret_cast<const uint4*>(dst + (KB + j) * XP + hx * 8)
                     : __ldg(reinterpret_cast<const uint4*>(yrow + static_cast<size_t>(ix) * cin + c[u]));
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (at[u] < 0) continue;
      uint4* v = reinterpret_cast<uint4*>(dst + at[u]);
      if constexpr (LOAD == kLoadX) {
        *v = imgseg::affine_relu8_shared(rows, p.vcpad, c[u], *v);
      } else {
        *v = imgseg::cotangent8_shared<LOAD == kLoadGeAffine>(rows, p.vcpad, c[u], *v, yv[u]);
      }
    }
  }
}

// The consumers (256 threads) on a unit's new rows once they have landed,
// in place: the forward's pre-affine + ReLU, or the dgrad's cotangent
// transform from g and y (y from the slot, a vector at a time, or from
// global memory, two in flight a thread: more cost registers the products
// hold); mul and add rounded apart.  Outside the image and past K nothing
// is written, so the ring's zeros stay: zero AFTER the transform, as SAME
// padding pads the transformed tensor (the dgrad's c1 is not zero).
template <int LOAD>
__device__ __forceinline__ void vec_transform(const Args& p, __nv_bfloat16* xr, const float* rows,
                                              const imgseg::UnitWalk& w) {
  const int H = p.H, W = p.W, cin = p.Ca + p.Cb, sw = p.vsw;
  const int KB = p.vcpad / 8, KBR = KB + p.vy, XP = fwd_xp(sw);
  const RowVecs rv(threadIdx.x - FSTAGERS, FCONSUMERS, KB);
  const int x0 = w.s * sw;
  for (int k = 0; k < w.loads(); ++k) {  // rows y + 1, y, y - 1
    const int iy = w.y + 1 - k;
    if (iy < 0 || iy >= H) continue;
    __nv_bfloat16* dst = xr + static_cast<size_t>(w.slot_back(k)) * KBR * XP;
    if constexpr (LOAD == kLoadX) {
      vec_transform_row<LOAD, 1, false>(p, dst, nullptr, rows, rv, x0);
    } else if (p.vy != 0) {
      vec_transform_row<LOAD, 1, true>(p, dst, nullptr, rows, rv, x0);
    } else {
      const __nv_bfloat16* yrow = p.xb + (static_cast<size_t>(w.n) * H + iy) * W * cin;
      vec_transform_row<LOAD, 2, false>(p, dst, yrow, rows, rv, x0);
    }
  }
}

// Whether the copying warpgroup applies the dgrad's cotangent transform:
// with the post adjoint, where the ring holds y.  (In the store and split
// modes, measured both ways, it was slower on the whole: there the consumers' units are
// short, or the ring holds four rows, and its transform became their wait.)
template <int LOAD, int EPI>
__host__ __device__ constexpr bool copier_modes() {
  return (LOAD == kLoadGeStats || LOAD == kLoadGeAffine) && EPI == kEpiPost;
}

template <int LOAD, int EPI>
__device__ __forceinline__ bool copier_transforms(const Args& p) {
  return copier_modes<LOAD, EPI>() && p.vy != 0;
}

// Warpgroup 0: each unit's new operand rows, 16-byte copies of [x | xb]
// (the dgrad's: of g, and of y in planes vy.. where the ring holds it)
// into the ring (cp.async, zero outside the image and past K: its
// padding) as soon as a slot is free, as many rows ahead as the ring
// holds; the slot's `landed` barrier counts the copies.  With the post
// adjoint, where the ring holds y (copier_transforms), this warpgroup also
// applies the cotangent transform to each row once its copies are in, a
// row behind them (a cp.async group a row, then a barrier of the 128
// threads: a thread's vectors were copied by others), and only then
// arrives on the row's `landed` barrier: the consumers' time goes to the
// products and that epilogue, their heaviest.  What the consumers
// read from global memory, the dgrad's y rows where the ring does not hold
// them and the unit's xpost row, is asked into L2 as the unit's rows are
// copied, a unit or more before it is read (one bulk prefetch a row).
template <int LOAD, int EPI>
__device__ __forceinline__ void vec_issue(const Args& p, __nv_bfloat16* xr, const float* rows,
                                          uint64_t* xland, uint64_t* xempty, long long u0,
                                          long long u1) {
  const int H = p.H, W = p.W, Ca = p.Ca, Cb = p.Cb, cin = Ca + Cb, sw = p.vsw;
  const int KB = p.vcpad / 8, KBR = KB + p.vy, XP = fwd_xp(sw), H8 = (sw + 2 + 7) / 8;
  const RowVecs rv(threadIdx.x, FSTAGERS, KBR);
  const bool own = copier_transforms<LOAD, EPI>(p);
  int pend = -1, pend_y = 0, pend_x0 = 0;  // the row copied last, not yet transformed: slot, image row, strip
  auto finish = [&](bool last) {  // the pending row: its copies in, transformed, landed
    if (pend < 0) return;
    if (last) {
      imgseg::cp_async_wait<0>();
    } else {
      imgseg::cp_async_wait<1>();
    }
    imgseg::named_sync(2, FSTAGERS);
    if (pend_y >= 0 && pend_y < H) {
      vec_transform_row<LOAD, 1, true>(p, xr + static_cast<size_t>(pend) * KBR * XP, nullptr, rows,
                                       RowVecs(threadIdx.x, FSTAGERS, KB), pend_x0);
    }
    imgseg::fence_proxy_async();  // the stores, before the wgmmas read them
    imgseg::mbar_arrive(&xland[pend]);
    pend = -1;
  };
  imgseg::UnitWalk w;
  for (w.begin(u0, u1, H, p.tiles_x, p.vxr); w.more(); w.next_unit()) {
    const int x0 = w.s * sw;
    if (LOAD != kLoadX && p.xpost != nullptr && threadIdx.x == 0) {  // the unit's output row
      const size_t at = ((static_cast<size_t>(w.n) * H + w.y) * W + x0) * p.Co;
      imgseg::prefetch_l2(p.xpost + at, static_cast<uint32_t>(min(sw, W - x0) * p.Co * 2));
    }
    for (int r = w.fresh ? -1 : 1; r <= 1; ++r) {
      w.next_row();
      const int iy = w.y + r;
      if ((LOAD == kLoadGeStats || LOAD == kLoadGeAffine) && p.vy == 0 && threadIdx.x == 0 && iy >= 0 &&
          iy < H) {  // the row's y, which the transform reads from global memory
        const int lo = max(x0 - 1, 0), hi = min(x0 + sw + 1, W);
        const size_t at = ((static_cast<size_t>(w.n) * H + iy) * W + lo) * Ca;
        imgseg::prefetch_l2(p.xb + at, static_cast<uint32_t>((hi - lo) * Ca * 2));
      }
      imgseg::mbar_wait(&xempty[w.slot], w.phase ^ 1);
      __nv_bfloat16* dst = xr + static_cast<size_t>(w.slot) * KBR * XP;
      const bool row_in = iy >= 0 && iy < H;
      const size_t rowpix = row_in ? (static_cast<size_t>(w.n) * H + iy) * W : 0;
      const __nv_bfloat16* xa = p.x + rowpix * Ca;
      const __nv_bfloat16* xb = p.xb + rowpix * Cb;
      const __nv_bfloat16* ya = p.xb + rowpix * Ca;  // the dgrad's y, as many channels as g
      for (int j = rv.j0, h8 = rv.h0; h8 < H8; rv.step(j, h8)) {
        const int hx = 8 * h8 + rv.pl, c = 8 * (j < KB ? j : j - KB), ix = x0 - 1 + hx;
        if (hx >= sw + 2) continue;
        const bool ok = row_in && c < cin && ix >= 0 && ix < W;
        const __nv_bfloat16* src = !ok      ? p.x
                                   : j >= KB ? ya + ix * Ca + c
                                   : c < Ca  ? xa + ix * Ca + c
                                             : xb + ix * Cb + (c - Ca);
        imgseg::cp_async16(dst + j * XP + hx * 8, src, ok);
      }
      if (own) {
        imgseg::cp_async_commit();
        finish(false);
        pend = w.slot, pend_y = iy, pend_x0 = x0;
      } else {
        imgseg::cp_async_arrive(&xland[w.slot]);
      }
    }
  }
  if (own) finish(true);
}

// The post adjoint's sums of one store pass, v[0..M) (index 2t + e: the
// pass's n8 tile t, element e), summed over the 8 lanes that hold the same
// channels (lane bits 2-4), halving at each exchange (xor 16, 8, 4): a
// lane is left with its share, M / 8 values, or (M < 8) one that 8 / M
// lanes hold alike.  The exchanges are fixed, so the sums are the same
// bits on every run.
template <int M, int S>
__device__ __forceinline__ void halve_sums(float* v, int lane) {
  if constexpr (M > 1) {
    constexpr int H = M / 2;
    const bool up = (lane & S) != 0;
#pragma unroll
    for (int i = 0; i < H; ++i) {
      const float keep = up ? v[H + i] : v[i], send = up ? v[i] : v[H + i];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, S);
    }
  } else {
    v[0] += __shfl_xor_sync(0xffffffffu, v[0], S);
  }
}

template <int M>
__device__ __forceinline__ void lane_sums(float* v, int lane) {
  halve_sums<M, 16>(v, lane);
  halve_sums<(M > 1 ? M / 2 : 1), 8>(v, lane);
  halve_sums<(M > 2 ? M / 4 : 1), 4>(v, lane);
}

// The first index of a lane's share after lane_sums<M>, and whether the
// lane is its one holder (the lowest of the lanes that hold it alike).
template <int M>
__device__ __forceinline__ int lane_share(int lane, bool& holder) {
  int first = 0, step = M;
  holder = true;
#pragma unroll
  for (int s = 16; s >= 4; s >>= 1) {
    if (step > 1) {
      step /= 2;
      if (lane & s) first += step;
    } else if (lane & s) {
      holder = false;
    }
  }
  return first;
}

// What a consumer keeps of a unit between its products and its epilogue:
// where it lies, and which operand rows it frees.
struct UnitDone {
  long long n;
  int s, y, slot;
  bool frees_all;
};

// Warpgroups 1 and 2 (cw = 0, 1), each on its half of every unit, their
// wgmmas running together (the two dependent chains fill the tensor cores;
// taken in turns, so that one's epilogue ran beside the other's wgmmas,
// they were slower).  A unit: 9 x cpad/16 wgmmas into one commit group;
// meanwhile the next unit's new rows, once landed, are transformed in
// place where the consumers apply a transform (each warpgroup its share of
// the vectors, then an arrival on the row's `act` barrier, which the
// wgmmas of both wait for), and with the post adjoint this lane's xpost
// values are loaded; then the epilogue: the output values (the bias and the bf16
// rounding, or the post adjoint) into this warp's rows in shared memory,
// EC channels at a time, from which each lane stores 16 bytes (into
// [out | out_b] with the split).  The statistics of the ROUNDED outputs:
// lane c adds channel c over the warp's 16 pixels into its running sums
// (sums over a thread's own channels in registers cost spills there); the
// post adjoint's sums of gu*xpost and gu, which the bf16 rows do not hold:
// each lane over its own outputs of a pass, then over the 8 lanes of each
// channel (lane_sums), each lane keeping its share.  (Two accumulator sets in one warpgroup,
// its epilogue beside its own next wgmmas, made ptxas serialize them.)
template <int LOAD, int EPI, int NT>
__device__ __forceinline__ void vec_products(const Args& p, const __nv_bfloat16* ws,
                                             __nv_bfloat16* xr, const float* rows,
                                             const float* erows, __nv_bfloat16* estage,
                                             uint64_t* wfull, uint64_t* xland, uint64_t* xact,
                                             uint64_t* xempty, long long u0, long long u1) {
  constexpr int EC = NT * 8 < FEC ? NT * 8 : FEC;  // channels a store pass
  constexpr bool kPost = EPI == kEpiPost;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int cw = warp / 4 - 1, wi = warp & 3;
  const int H = p.H, W = p.W, Co = p.Co, sw = p.vsw, ntile = p.vntile;
  const int KB = p.vcpad / 8, NB = ntile / 8, XP = fwd_xp(sw), KS = KB / 2, R = p.vxr;
  const int mw = p.vsplit ? 0 : cw, nw = p.vsplit ? cw : 0;
  const int co0 = blockIdx.x * ntile, cbase = nw * NT * 8;  // this warpgroup's first channel of the tile
  // a transform of the new rows here: the forward's pre-affine where it
  // has one; the dgrad's cotangent transform, but for g itself and where
  // the copying warpgroup applies it
  const bool pre = LOAD == kLoadX ? p.ab != nullptr : LOAD != kLoadG && !copier_transforms<LOAD, EPI>(p);
  __nv_bfloat16* stage = estage + (warp - 4) * 16 * FES;
  imgseg::UnitWalk w;
  w.begin(u0, u1, H, p.tiles_x, R);

  // the current unit's new rows: landed, and transformed where the mode
  // has a transform (this thread's share, then its arrival on each row's `act`)
  auto prepare = [&]() {
    for (int i = w.loads(); i > 0; --i) w.next_row();
    if (!pre) return;
    for (int k = 0; k < w.loads(); ++k) imgseg::mbar_wait(&xland[w.slot_back(k)], w.phase_back(k));
    vec_transform<LOAD>(p, xr, rows, w);
    imgseg::fence_proxy_async();  // the stores, before the wgmmas read them
    for (int k = 0; k < w.loads(); ++k) imgseg::mbar_arrive(&xact[w.slot_back(k)]);
  };

  // this lane's running sums: the stats' of channel lane (< EC) of each
  // store pass; the post adjoint's share of each pass (lane_sums)
  constexpr int NPASS = NT * 8 / EC;
  constexpr int PM = EC / 4;                // a pass's post sums a lane before lane_sums
  constexpr int PS = PM >= 8 ? PM / 8 : 1;  // and after
  float s1[NPASS], s2[NPASS];
#pragma unroll
  for (int i = 0; i < NPASS; ++i) s1[i] = s2[i] = 0.f;
  float ps1[kPost ? NPASS : 1][PS], ps2[kPost ? NPASS : 1][PS];
#pragma unroll
  for (int i = 0; i < (kPost ? NPASS : 1); ++i)
#pragma unroll
    for (int k = 0; k < PS; ++k) ps1[i][k] = ps2[i][k] = 0.f;
  float acc[4 * NT];
  imgseg::mbar_wait(wfull, 0);
  if (w.more()) prepare();
  while (w.more()) {
#pragma unroll
    for (int ky = 0; ky < 3; ++ky) {
      uint64_t* bar = pre ? xact : xland;
      imgseg::mbar_wait(&bar[w.slot_back(2 - ky)], w.phase_back(2 - ky));
    }
    if (!pre) imgseg::fence_proxy_async();  // the copies, before the wgmmas read them
    imgseg::wgmma_fence();
#pragma unroll
    for (int ky = 0; ky < 3; ++ky) {
      const __nv_bfloat16* xs = xr + static_cast<size_t>(w.slot_back(2 - ky)) * (KB + p.vy) * XP;
#pragma unroll
      for (int kx = 0; kx < 3; ++kx) {
        const int tap = ky * 3 + kx;
        const __nv_bfloat16* a0 = xs + (64 * mw + kx) * 8;
        const __nv_bfloat16* b0 = ws + (tap * NB + nw * NT) * KB * 64;
        auto k16 = [&](int ks) {
          // A: K-major, K-adjacent cores (8 channels) a plane apart, M-adjacent (8 pixels) 128 bytes
          const uint64_t da = imgseg::wgmma_desc(a0 + 2 * ks * XP, XP * 2, 128);
          // B: K-major, K-adjacent cores 128 bytes apart, N-adjacent KB x 128
          const uint64_t db = imgseg::wgmma_desc(b0 + 2 * ks * 64, 128, KB * 128);
          imgseg::wgmma<0, 0, NT>(acc, da, db, (tap | ks) != 0);
        };
        // unrolled to 128 channels of K, every model's (a loop with a
        // runtime trip count made ptxas fence every wgmma: 2-17 % slower)
#pragma unroll
        for (int ks = 0; ks < 8; ++ks) {
          if (ks >= KS) break;
          k16(ks);
        }
#pragma unroll 1
        for (int ks = 8; ks < KS; ++ks) k16(ks);
      }
    }
    imgseg::wgmma_commit();
    const UnitDone u{w.n, w.s, w.y, w.slot, w.frees_all()};
    w.next_unit();
    // lane holds pixels 16 wi + lane/4 (+8) of the warpgroup's 64,
    // channels 8t + 2(lane%4) (+1) of its N
    const int gx0 = u.s * sw + 64 * mw + 16 * wi;
    const size_t row = (static_cast<size_t>(u.n) * H + u.y) * W;
    // the next unit's new rows while this one's wgmmas run, unless it
    // restarts the ring: it needs the rows this unit frees
    const bool early = w.more() && !w.fresh;
    if (early) prepare();
    // the post adjoint: this lane's xpost pairs, loaded while the wgmmas run
    // (after the transform, whose registers they would take)
    __nv_bfloat162 xq[kPost ? NT : 1][2];
    if constexpr (kPost) {
#pragma unroll
      for (int t = 0; t < NT; ++t)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int gx = gx0 + (lane >> 2) + 8 * h, gc = co0 + cbase + 8 * t + 2 * (lane & 3);
          xq[t][h] = gx < W && gc < Co
                         ? __ldg(reinterpret_cast<const __nv_bfloat162*>(p.xpost + (row + gx) * Co + gc))
                         : __float2bfloat162_rn(0.f);
        }
    }
    imgseg::wgmma_wait<0>();
    imgseg::fence_acc(acc);
    if (lane == 0) imgseg::release_rows(u.slot, R, u.frees_all, xempty);

    // ---- the epilogue
#pragma unroll
    for (int pass = 0; pass < NPASS; ++pass) {
      const int c0 = pass * EC;
      float q1[kPost ? PM : 1], q2[kPost ? PM : 1];  // the post sums of the pass, this lane's outputs
#pragma unroll
      for (int i = 0; i < (kPost ? PM : 1); ++i) q1[i] = q2[i] = 0.f;
#pragma unroll
      for (int t = c0 / 8; t < (c0 + EC) / 8; ++t) {
        const int c = cbase + 8 * t + 2 * (lane & 3);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int q = (lane >> 2) + 8 * h;
          __nv_bfloat162 r;
          if constexpr (kPost) {  // outside the image: no output, nothing summed
            const bool in = gx0 + q < W;
            const float2 xv = __bfloat1622float2(xq[t][h]);
            const float v0 = in ? acc[4 * t + 2 * h] : 0.f, v1 = in ? acc[4 * t + 2 * h + 1] : 0.f;
            const int o = 2 * (t - c0 / 8);
            r = __halves2bfloat162(post1(v0, xv.x, erows[c], erows[ntile + c], q1[o], q2[o]),
                                   post1(v1, xv.y, erows[c + 1], erows[ntile + c + 1], q1[o + 1], q2[o + 1]));
          } else {
            r = __floats2bfloat162_rn(acc[4 * t + 2 * h] + erows[c], acc[4 * t + 2 * h + 1] + erows[c + 1]);
          }
          *reinterpret_cast<__nv_bfloat162*>(stage + q * FES + (c - cbase - c0)) = r;
        }
      }
      if constexpr (kPost) {
        lane_sums<PM>(q1, lane);
        lane_sums<PM>(q2, lane);
#pragma unroll
        for (int k = 0; k < PS; ++k) ps1[pass][k] += q1[k], ps2[pass][k] += q2[k];
      }
      __syncwarp();
      if constexpr (EPI == kEpiStats) {  // statistics of the ROUNDED output, in the image
        if (lane < EC) {  // channel lane of the pass, over the warp's 16 pixels in order
          const int nq = W - gx0;
          float f[16];
#pragma unroll
          for (int q = 0; q < 16; ++q) f[q] = q < nq ? __bfloat162float(stage[q * FES + lane]) : 0.f;
#pragma unroll
          for (int q = 0; q < 16; ++q) s1[pass] += f[q], s2[pass] += __fmul_rn(f[q], f[q]);
        }
      }
      // 16 pixels x EC channels out, 16 bytes a lane (Na a multiple of 8)
#pragma unroll
      for (int i = lane; i < 16 * (EC / 8); i += 32) {
        const int q = i / (EC / 8), part = i % (EC / 8);
        const int gx = gx0 + q, gco = co0 + cbase + c0 + 8 * part;
        if (gx < W && gco < Co) {
          __nv_bfloat16* dst;
          if (EPI == kEpiSplit && gco >= p.Na) {
            dst = p.out_b + (row + gx) * (Co - p.Na) + (gco - p.Na);
          } else {
            dst = p.out + (row + gx) * (EPI == kEpiSplit ? p.Na : Co) + gco;
          }
          *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(stage + q * FES + 8 * part);
        }
      }
      __syncwarp();
    }
    if (w.more() && !early) prepare();
  }
  if constexpr (EPI == kEpiStats || kPost) {
    // one row of partial sums a block: each consumer warp's row, in the
    // output rows' place once every warp is done with them, then the 8
    // rows in order
    imgseg::named_sync(1, FCONSUMERS);
    float* red = reinterpret_cast<float*>(estage);
    float* myred = red + (warp - 4) * 2 * ntile;
    for (int i = lane; i < 2 * ntile; i += 32) myred[i] = 0.f;
    __syncwarp();
    if constexpr (EPI == kEpiStats) {
      if (lane < EC) {
#pragma unroll
        for (int pass = 0; pass < NPASS; ++pass) {
          myred[cbase + pass * EC + lane] = s1[pass];
          myred[ntile + cbase + pass * EC + lane] = s2[pass];
        }
      }
    } else {  // each channel's sums from their one holder: index o is tile o / 2, element o % 2
      bool holder;
      const int first = lane_share<PM>(lane, holder);
      if (holder) {
#pragma unroll
        for (int pass = 0; pass < NPASS; ++pass)
#pragma unroll
          for (int k = 0; k < PS; ++k) {
            const int o = first + k, c = cbase + pass * EC + 8 * (o / 2) + 2 * (lane & 3) + o % 2;
            myred[c] = ps1[pass][k];
            myred[ntile + c] = ps2[pass][k];
          }
      }
    }
    imgseg::named_sync(1, FCONSUMERS);
    for (int i = threadIdx.x - FSTAGERS; i < 2 * ntile; i += FCONSUMERS) {
      const int r = i / ntile, c = i % ntile;
      if (co0 + c >= Co) continue;
      float s = 0.f;
#pragma unroll
      for (int wr = 0; wr < 8; ++wr) s += red[(wr * 2 + r) * ntile + c];
      p.partial[(static_cast<size_t>(blockIdx.y) * 2 + r) * Co + co0 + c] = s;
    }
  }
}

template <int LOAD, int EPI, int NT>
__global__ void __launch_bounds__(FTHREADS, 1) vec_kernel(const Args p) {
  constexpr int NROWS = vec_rows(LOAD);
  constexpr int NAB = LOAD == kLoadGeAffine ? 4 : 2;  // the rows `ab` holds
  constexpr bool kGe = copier_modes<LOAD, EPI>();  // the copier may transform: more registers
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __shared__ uint64_t wfull, xland[FXR_MAX], xact[FXR_MAX], xempty[FXR_MAX];
  const int tid = threadIdx.x, warp = tid >> 5;
  const int cpad = p.vcpad, ntile = p.vntile, KB = cpad / 8, NB = ntile / 8, Co = p.Co;
  const int co0 = blockIdx.x * ntile;
  __nv_bfloat16* ws = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* xr = ws + static_cast<size_t>(9) * cpad * ntile;
  __nv_bfloat16* estage = xr + static_cast<size_t>(p.vxr) * (KB + p.vy) * fwd_xp(p.vsw);
  float* rows = reinterpret_cast<float*>(estage + 8 * 16 * FES);
  float* erows = rows + NROWS * cpad;
  const long long u0 = static_cast<long long>(blockIdx.y) * p.per_chunk;
  const long long u1 = u0 + p.per_chunk < p.tiles ? u0 + p.per_chunk : p.tiles;

  if (tid == 0) {
    imgseg::mbar_init(&wfull, 1 + FSTAGERS);  // the bulk copies' arrival, then the stagers'
    for (int i = 0; i < FXR_MAX; ++i) {
      imgseg::mbar_init(&xland[i], FSTAGERS);
      imgseg::mbar_init(&xact[i], FCONSUMERS);
      imgseg::mbar_init(&xempty[i], 8);  // lane 0 of each consumer warp
    }
    imgseg::fence_barrier_init();
  }
  for (int i = tid; i < NROWS * cpad; i += FTHREADS) {
    const int r = i / cpad, c = i % cpad;
    rows[i] = p.ab != nullptr && r < NAB && c < p.Ca ? p.ab[r * p.Ca + c] : 0.f;
  }
  for (int i = tid; i < ntile; i += FTHREADS) {  // the bias, or the post affine
    const bool ok = co0 + i < Co;
    if constexpr (EPI == kEpiPost) {
      erows[i] = ok ? p.abpost[co0 + i] : 0.f;
      erows[ntile + i] = ok ? p.abpost[Co + co0 + i] : 0.f;
    } else {
      erows[i] = p.bias != nullptr && ok ? p.bias[co0 + i] : 0.f;
      erows[ntile + i] = 0.f;
    }
  }
  __syncthreads();

  if (warp < 4) {
    imgseg::reg_dealloc<kGe ? FSTAGE_REGS_GE : FSTAGE_REGS>();
    // the weights of the N tile, vector_pack's [tap][n/8][cpad/8][8 n][8 k]:
    // one bulk copy a tap of its real channels, zeros past N
    const int nvalid = min(ntile, Co - co0) / 8;
    if (tid == 0) {
      const uint32_t bytes = static_cast<uint32_t>(nvalid) * KB * 128;
      imgseg::mbar_arrive_tx(&wfull, 9 * bytes);
      for (int tap = 0; tap < 9; ++tap) {
        imgseg::bulk_copy(ws + static_cast<size_t>(tap) * NB * KB * 64,
                          p.w + (static_cast<size_t>(tap) * (Co / 8) + co0 / 8) * KB * 64, bytes, &wfull);
      }
    }
    const int pad = (NB - nvalid) * KB * 8;  // 16-byte rows past N, a tap
    for (int i = tid; i < 9 * pad; i += FSTAGERS) {
      const int tap = i / pad, o = i % pad;
      *reinterpret_cast<uint4*>(ws + (static_cast<size_t>(tap) * NB + nvalid) * KB * 64 + o * 8) =
          make_uint4(0u, 0u, 0u, 0u);
    }
    imgseg::fence_proxy_async();
    imgseg::mbar_arrive(&wfull);
    vec_issue<LOAD, EPI>(p, xr, rows, xland, xempty, u0, u1);
  } else {
    imgseg::reg_alloc<kGe ? FPRODUCT_REGS_GE : FPRODUCT_REGS>();
    vec_products<LOAD, EPI, NT>(p, ws, xr, rows, erows, estage, &wfull, xland, xact, xempty, u0, u1);
  }
}

// ---- the narrow path: every shape the vector path does not take (a
// channel count that is not a multiple of 8, an operand off a 16-byte
// boundary, an odd split).  A block walks tiles of NTH x TW output pixels
// by TCO = 8, 16 or 32 output channels; each warp NMR output rows (m16
// tiles) by all TCO channels.  K is the stage's 9 taps x KP channels in
// 8-wide halves: with KP = 8 one k16 step carries two taps.
constexpr int NTH = 16;  // output rows per block
constexpr int NMR = NTH / 8;
constexpr int NHALO = (NTH + 2) * IW;
constexpr int NKP = 32;          // the most channels per stage
constexpr int NKS = 9 * NKP / 16;  // the most k16 steps per stage

__host__ __device__ constexpr int narrow_krows(int kp) { return (9 * kp + 15) / 16 * 16; }

// Shared-memory bytes of the runs of a C-channel operand over the halo.
__host__ __device__ inline int narrow_raw(int C, bool single) {
  return imgseg::raw_bytes(C, single, NTH + 2, IW);
}

// The narrow kernel's shared memory: the padded halo, the weights, each
// warp's output runs, and the runs of the operand (ca channels: x, or g)
// and of its second part (cb: xb, or y beside g), for a conv of cin input
// channels.
__host__ __device__ inline size_t narrow_bytes(int kp, int nt, int cin, int ca, int cb) {
  const bool single = cin <= NKP;
  return (static_cast<size_t>(NHALO) * imgseg::odd16(kp) +
          static_cast<size_t>(narrow_krows(kp)) * imgseg::odd16(8 * nt) +
          static_cast<size_t>(THREADS / 32) * (TW * 8 * nt + 32)) * sizeof(__nv_bfloat16) +
         narrow_raw(ca, single) + narrow_raw(cb, single);
}

// bf16 elements e0 .. e0+7 of `base`, each zero unless lo <= e < hi: the
// aligned 4-byte words that hold a wanted element, read through the
// read-only cache and shifted into place (one 16-byte load where all 8 are
// wanted and aligned).  A word that holds a wanted element lies on the
// tensor's own pages, however the tensor is aligned; no other is read.
__device__ __forceinline__ uint4 gather8(const __nv_bfloat16* base, long long e0, long long lo,
                                         long long hi) {
  const long long first = e0 > lo ? e0 : lo, last = e0 + 8 < hi ? e0 + 8 : hi;
  if (first >= last) return make_uint4(0u, 0u, 0u, 0u);
  const uintptr_t b = reinterpret_cast<uintptr_t>(base);
  const uintptr_t a = b + static_cast<uintptr_t>(2 * e0);
  if (first == e0 && last == e0 + 8 && (a & 15) == 0) {
    return __ldg(reinterpret_cast<const uint4*>(a));
  }
  const uintptr_t fa = b + static_cast<uintptr_t>(2 * first), la = b + static_cast<uintptr_t>(2 * last);
  const uintptr_t w0 = a & ~static_cast<uintptr_t>(3);
  uint32_t w[5];
#pragma unroll
  for (int m = 0; m < 5; ++m) {
    const uintptr_t wa = w0 + 4 * m;
    w[m] = (wa + 4 > fa && wa < la) ? __ldg(reinterpret_cast<const unsigned int*>(wa)) : 0u;
  }
  const bool odd = (a & 2) != 0;  // e0 in the upper half of its word
  const int k0 = static_cast<int>(first - e0), k1 = static_cast<int>(last - e0);
  uint32_t out[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const uint32_t v = odd ? __funnelshift_r(w[k], w[k + 1], 16) : w[k];
    const uint32_t keep = (2 * k >= k0 && 2 * k < k1 ? 0x0000ffffu : 0u) |
                          (2 * k + 1 >= k0 && 2 * k + 1 < k1 ? 0xffff0000u : 0u);
    out[k] = v & keep;
  }
  return make_uint4(out[0], out[1], out[2], out[3]);
}

// Copy n bf16 from shared `src` to global `dst`, where src and dst lie at
// the same offset within 16 bytes: 16-byte stores between the unaligned
// head and tail, by the 32 lanes of a warp.
__device__ __forceinline__ void copy_run(__nv_bfloat16* dst, const __nv_bfloat16* src, int n,
                                         int lane) {
  const int head = min(n, static_cast<int>((16 - (reinterpret_cast<uintptr_t>(dst) & 15)) & 15) / 2);
  for (int i = lane; i < head; i += 32) dst[i] = src[i];
  const int nv = (n - head) / 8;
  uint4* dv = reinterpret_cast<uint4*>(dst + head);
  const uint4* sv = reinterpret_cast<const uint4*>(src + head);
  for (int i = lane; i < nv; i += 32) dv[i] = sv[i];
  for (int i = head + 8 * nv + lane; i < n; i += 32) dst[i] = src[i];
}

// Where a block's output channels [lo, lo + L) of one destination (Cd
// channels a pixel) go in its warp's run buffer: pixel q, channel c at
// base + q * L + c - lo.  Where the block writes whole pixels (L == Cd)
// the row is one run, held at the output's own offset within 16 bytes.
struct Dest {
  __nv_bfloat16* ptr;
  int Cd, lo, L, base;
  bool whole;
};

__device__ __forceinline__ Dest dest_of(__nv_bfloat16* ptr, int Cd, int lo, int hi, size_t pix0,
                                        int at) {
  Dest d{ptr, Cd, lo, hi > lo ? hi - lo : 0, at, false};
  d.whole = d.L == Cd;
  if (d.whole) d.base += static_cast<int>((reinterpret_cast<uintptr_t>(ptr + pix0 * Cd) & 15) / 2);
  return d;
}

// Write one row's run of a destination from the warp's run buffer.
__device__ __forceinline__ void write_run(const Dest& d, const __nv_bfloat16* run, size_t pix0,
                                          int np, int lane) {
  if (d.L == 0) return;
  if (d.whole) {
    copy_run(d.ptr + pix0 * d.Cd, run + d.base, np * d.Cd, lane);
    return;
  }
  for (int e = lane; e < np * d.L; e += 32) {
    const int q = e / d.L;
    d.ptr[(pix0 + q) * d.Cd + d.lo + (e - q * d.L)] = run[d.base + e];
  }
}

template <int LOAD, int EPI, int NT>
__global__ void __launch_bounds__(THREADS, NT == 4 ? 2 : 3) narrow_kernel(const Args p) {
  constexpr int TCO = 8 * NT;
  constexpr int WS = imgseg::odd16(TCO);
  constexpr int NRUN = TW * TCO + 32;  // bf16 of a warp's output runs of one row
  constexpr bool kGe = LOAD == kLoadGeStats || LOAD == kLoadGeAffine;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int off[2 * NKS];
  __shared__ __align__(16) float rows[4][32];
  __shared__ float red[2][8][TCO];
  __shared__ unsigned char mis[2][NHALO];
  __shared__ uint64_t bar;  // a phase a step: its runs have landed
  __shared__ float sbias[TCO];
  __shared__ float sab[2][TCO];  // kEpiPost: the post affine of the block's channels

  const int H = p.H, W = p.W, Co = p.Co, cin = p.Ca + p.Cb;
  const int KP = p.kp, AS = imgseg::odd16(KP), G = KP / 8;
  const int krows = narrow_krows(KP), nks = krows / 16;
  const bool single = cin <= NKP;
  const int nst = single ? 1 : (cin + KP - 1) / KP;  // stages of K a tile
  const int cb = LOAD == kLoadX ? p.Cb : kGe ? p.Ca : 0;  // xb's channels, or y's beside g
  __nv_bfloat16* sA = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sW = sA + NHALO * AS;
  unsigned char* rawa = smem_raw + (NHALO * AS + krows * WS) * sizeof(__nv_bfloat16);
  unsigned char* rawb = rawa + narrow_raw(p.Ca, single);
  __nv_bfloat16* run = reinterpret_cast<__nv_bfloat16*>(rawb + narrow_raw(cb, single)) + (threadIdx.x >> 5) * NRUN;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wr0 = warp * NMR;  // this warp's first output row in a tile
  const int co0 = blockIdx.y * TCO;
  const int nrows = LOAD == kLoadX ? (p.ab != nullptr ? 2 : 0) : LOAD == kLoadGeAffine ? 4 : kGe ? 2 : 0;

  // half h of k16 step s: tap t, channels c.. of the stage (past the 9 taps
  // the weights are zero; the operand is tap 8's, finite)
  for (int i = tid; i < 2 * nks; i += THREADS) {
    int tap = 8 * i / KP, c = 8 * i % KP;
    if (tap > 8) tap = 8, c = 0;
    off[i] = ((tap / 3) * IW + tap % 3) * AS + c;
  }
  // the transform's rows and the weights of a stage: row k = tap * KP + c,
  // zero past the taps, channels and Co
  auto stage_weights = [&](int c0) {
    if (nrows) imgseg::stage_rows(rows, p.ab, nrows, p.Ca, c0, tid, THREADS);
    for (int i = tid; i < krows * NT; i += THREADS) {
      const int k = i / NT, g = i % NT, tap = k / KP, gc = c0 + k % KP;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (tap < 9 && gc < cin) {
        const long long row = (static_cast<long long>(tap) * cin + gc) * Co;
        v = gather8(p.w, row + co0 + 8 * g, row, row + Co);
      }
      *reinterpret_cast<uint4*>(sW + k * WS + 8 * g) = v;
    }
  };
  // step s of this block: its k-th pixel tile (the halo from (y0-1, x0-1)),
  // stage s % nst, and the runs of the operand and of its second part
  auto tile_of = [&](long long s) {
    const long long t = blockIdx.x + (s / nst) * gridDim.x;
    const int x0 = static_cast<int>(t % p.tiles_x) * TW;
    const int y0 = static_cast<int>((t / p.tiles_x) % p.tiles_y) * NTH;
    const size_t img = static_cast<size_t>(t / (static_cast<long long>(p.tiles_x) * p.tiles_y)) * H;
    return imgseg::Tile{y0 - 1, x0 - 1, NTH + 2, IW, H, W, img};
  };
  auto srcs_of = [&](int c0, imgseg::Src& a, imgseg::Src& b) {
    a = imgseg::src_of(p.x, p.Ca, min(c0, p.Ca), min(c0 + KP, p.Ca), single, IW, rawa, mis[0]);
    const int blo = LOAD == kLoadX ? max(c0, p.Ca) - p.Ca : a.lo;
    const int bhi = LOAD == kLoadX ? min(c0 + KP, cin) - p.Ca : a.lo + a.n;
    b = imgseg::src_of(p.xb, cb, cb ? blo : 0, cb ? bhi : 0, single, IW, rawb, mis[1]);
  };
  // warp 0 starts step s's copies (after the reads of the runs' space, in
  // the other proxy) and arrives on the barrier
  auto issue = [&](long long s) {
    if (warp != 0) return;
    imgseg::Src a, b;
    srcs_of(static_cast<int>(s % nst) * KP, a, b);
    const imgseg::Tile t = tile_of(s);
    imgseg::fence_proxy_async();
    imgseg::issue_runs(a, t, lane, &bar);
    imgseg::issue_runs(b, t, lane, &bar);
    __syncwarp();
    if (lane == 0) imgseg::mbar_arrive(&bar);
  };

  float acc[NMR][NT][4];
  // the epilogue's sums (statistics, or the post adjoint's), over every tile
  // of the block; lane holds channels 2(lane%4) (+1) of each n8 tile
  float s1[NT][2], s2[NT][2];
#pragma unroll
  for (int ni = 0; ni < NT; ++ni)
#pragma unroll
    for (int e = 0; e < 2; ++e) s1[ni][e] = s2[ni][e] = 0.f;
  if (tid < TCO) {
    const bool ok = co0 + tid < Co;
    sbias[tid] = (p.bias != nullptr && ok) ? p.bias[co0 + tid] : 0.f;
    if constexpr (EPI == kEpiPost) {
      sab[0][tid] = ok ? p.abpost[co0 + tid] : 0.f;
      sab[1][tid] = ok ? p.abpost[Co + co0 + tid] : 0.f;
    }
  }
  const int na = EPI == kEpiSplit ? p.Na : Co;

  // this lane's ldmatrix rows: A (pixel, k half), B (k row, 8-channel half)
  const int a_pix = (lane & 7) + ((lane >> 3) & 1) * 8, a_half = lane >> 4;
  const int b_k = (lane & 7) + ((lane >> 3) & 1) * 8, b_n = (lane >> 4) * 8;

  // the block walks its pixel tiles, each in nst steps; step s + 1's runs
  // are copied while step s's mma and epilogue run
  const long long mine = blockIdx.x < p.tiles ? (p.tiles - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  const long long steps = mine * nst;
  if (tid == 0) imgseg::mbar_init(&bar, 1);
  if (single) stage_weights(0);
  __syncthreads();
  if (steps > 0) issue(0);
  for (long long s = 0; s < steps; ++s) {
    const int st = static_cast<int>(s % nst), c0 = st * KP;
    const imgseg::Tile t = tile_of(s);
    const int y0 = t.gy0 + 1, x0 = t.gx0 + 1;
    imgseg::mbar_wait(&bar, static_cast<int>(s & 1));
    __syncthreads();  // step s's runs are in; step s - 1's mma is done
    if (!single) {
      stage_weights(c0);
      __syncthreads();
    }
    imgseg::Src a, b;
    srcs_of(c0, a, b);
    // the halo, 8 channels of a pixel a thread, into rows of KP channels;
    // SAME padding: zero AFTER the operand's transform
    if constexpr (LOAD == kLoadX) {
      if (nrows) {
        imgseg::place_tile<imgseg::kOpAffineRelu>(sA, AS, G, a, b, t, c0, rows, tid, THREADS);
      } else {
        imgseg::place_tile<imgseg::kOpCat>(sA, AS, G, a, b, t, c0, rows, tid, THREADS);
      }
    } else if constexpr (LOAD == kLoadG) {
      imgseg::place_tile<imgseg::kOpCat>(sA, AS, G, a, b, t, c0, rows, tid, THREADS);
    } else {
      constexpr int OP = LOAD == kLoadGeAffine ? imgseg::kOpCotAffine : imgseg::kOpCot;
      imgseg::place_tile<OP>(sA, AS, G, a, b, t, c0, rows, tid, THREADS);
    }
    __syncthreads();
    if (s + 1 < steps) issue(s + 1);
    const int mrows = min(NMR, H - y0 - wr0);  // this warp's rows in the image
    const int np = min(TW, W - x0);
    // kEpiPost: this lane's xpost values, loaded now for the epilogue after the mma
    float xq[NMR][2][NT][2];
    if constexpr (EPI == kEpiPost) {
      if (st == nst - 1) {
#pragma unroll
        for (int mr = 0; mr < NMR; ++mr)
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int ni = 0; ni < NT; ++ni)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int q = (lane >> 2) + 8 * h, c = co0 + ni * 8 + 2 * (lane & 3) + e;
                const size_t pix = (t.img + y0 + wr0 + mr) * W + x0 + q;
                xq[mr][h][ni][e] = mr < mrows && q < np && c < Co
                                       ? __bfloat162float(p.xpost[pix * Co + c]) : 0.f;
              }
      }
    }
    if (st == 0) {
#pragma unroll
      for (int mr = 0; mr < NMR; ++mr)
#pragma unroll
        for (int ni = 0; ni < NT; ++ni)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mr][ni][e] = 0.f;
    }
#pragma unroll 1
    for (int k = 0; k < nks; ++k) {
      const int o = off[2 * k + a_half];
      uint32_t bf[NT][2];
#pragma unroll
      for (int pr = 0; pr < NT / 2; ++pr) {
        uint32_t r[4];
        ldsm_x4_trans(r, sW + (16 * k + b_k) * WS + pr * 16 + b_n);
        bf[2 * pr][0] = r[0], bf[2 * pr][1] = r[1];
        bf[2 * pr + 1][0] = r[2], bf[2 * pr + 1][1] = r[3];
      }
      if constexpr (NT % 2) {
        uint32_t r[2];
        imgseg::ldsm_x2_trans(r, sW + (16 * k + b_k) * WS + (NT - 1) * 8);
        bf[NT - 1][0] = r[0], bf[NT - 1][1] = r[1];
      }
#pragma unroll
      for (int mr = 0; mr < NMR; ++mr) {
        if (mr >= mrows) break;
        uint32_t af[4];
        ldsm_x4(af, sA + ((wr0 + mr) * IW + a_pix) * AS + o);
#pragma unroll
        for (int ni = 0; ni < NT; ++ni) mma_bf16(acc[mr][ni], af, bf[ni][0], bf[ni][1]);
      }
    }
    if (st != nst - 1) continue;

    // ---- the tile's epilogue: the fragments through this warp's run
    // buffer, one row at a time, out as 16-byte stores; lane holds pixels
    // lane/4 (+8) of each row
#pragma unroll
    for (int mr = 0; mr < NMR; ++mr) {
      if (mr >= mrows) break;
      const size_t pix0 = (t.img + y0 + wr0 + mr) * W + x0;
      const Dest d0 = dest_of(p.out, na, co0, min(co0 + TCO, na), pix0, 0);
      Dest d1{};
      if constexpr (EPI == kEpiSplit) {
        const int at = (d0.base + TW * d0.L + 7) / 8 * 8;
        d1 = dest_of(p.out_b, Co - na, max(co0, na) - na, min(co0 + TCO, Co) - na, pix0, at);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int q = (lane >> 2) + 8 * h;
        if (q >= np) continue;
#pragma unroll
        for (int ni = 0; ni < NT; ++ni)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = co0 + ni * 8 + 2 * (lane & 3) + e;
            if (c >= Co) continue;
            const float v = acc[mr][ni][2 * h + e] + sbias[c - co0];
            __nv_bfloat16 r;
            if constexpr (EPI == kEpiPost) {
              r = post1(v, xq[mr][h][ni][e], sab[0][c - co0], sab[1][c - co0], s1[ni][e], s2[ni][e]);
            } else {
              r = epi1<EPI>(p, pix0 + q, c, v, s1[ni][e], s2[ni][e]);
            }
            if (EPI == kEpiSplit && c >= na) {
              run[d1.base + q * d1.L + (c - na - d1.lo)] = r;
            } else {
              run[d0.base + q * d0.L + (c - d0.lo)] = r;
            }
          }
      }
      __syncwarp();
      write_run(d0, run, pix0, np, lane);
      if constexpr (EPI == kEpiSplit) write_run(d1, run, pix0, np, lane);
      __syncwarp();
    }
  }
  if constexpr (EPI == kEpiStats || EPI == kEpiPost) {
    // the 8 lanes of one channel pair: butterfly sums; then the 8 warps in
    // order; one row of partial sums a block
#pragma unroll
    for (int ni = 0; ni < NT; ++ni)
#pragma unroll
      for (int e = 0; e < 2; ++e)
#pragma unroll
        for (int o = 4; o < 32; o <<= 1) {
          s1[ni][e] += __shfl_xor_sync(0xffffffffu, s1[ni][e], o);
          s2[ni][e] += __shfl_xor_sync(0xffffffffu, s2[ni][e], o);
        }
    if (lane < 4) {
#pragma unroll
      for (int ni = 0; ni < NT; ++ni)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          red[0][warp][ni * 8 + 2 * lane + e] = s1[ni][e];
          red[1][warp][ni * 8 + 2 * lane + e] = s2[ni][e];
        }
    }
    __syncthreads();
    if (tid < TCO && co0 + tid < Co) {
      const size_t blk = blockIdx.x;
      float a = red[0][0][tid], q = red[1][0][tid];
#pragma unroll
      for (int r = 1; r < 8; ++r) {
        a += red[0][r][tid];
        q += red[1][r][tid];
      }
      p.partial[(blk * 2) * Co + co0 + tid] = a;
      p.partial[(blk * 2 + 1) * Co + co0 + tid] = q;
    }
  }
}

// ---- the deep path: Ca, Cb and Co multiples of 64 with 256 or more
// channels in or out (the fold-1 blocks' levels).  A block walks tiles of
// DR x DW output pixels by N = 8 * NT output channels (blockIdx.y); K is 9
// taps x Cin in stages of DK channels.  Warpgroup 0 is the producer: warp 0
// keeps the weights' ring full by bulk copies, warps 1-3 stage the
// transformed halo of each DK-channel group; warpgroups 1 and 2 each own
// two tile rows (two m64 wgmma tiles) by all N channels.
constexpr int DR = 4;                       // output rows a tile
constexpr int DW = 64;                      // output columns a tile: one m64 tile a row
constexpr int DHALO = (DR + 2) * (DW + 2);  // halo pixels
constexpr int DK = 64;                      // channels a K stage
constexpr int DPLANE = DHALO * 8;           // bf16 of one 8-channel plane of the halo
constexpr int DA = 8 * DPLANE;              // bf16 of one staged halo
constexpr int DSTAGES = 4;                  // the weights' ring
constexpr int DTHREADS = 384;
constexpr int DPRODUCERS = 96;              // warps 1-3: the halo
// registers a thread after the producer warpgroup gives some to the two
// consumer warpgroups (168 at the launch: 128 x 48 given, 256 x 24 taken);
// setmaxnreg also keeps ptxas from serializing the consumers' wgmmas
// behind the branch between the roles
constexpr int DPRODUCER_REGS = 120;
constexpr int DCONSUMER_REGS = 192;

__host__ __device__ constexpr size_t deep_bytes(int nt) {
  return (2 * static_cast<size_t>(DA) + DSTAGES * static_cast<size_t>(8 * nt) * DK) *
         sizeof(__nv_bfloat16);
}

__host__ __device__ inline long long deep_tiles(int B, int H, int W) {
  return static_cast<long long>(B) * ((H + DR - 1) / DR) * ((W + DW - 1) / DW);
}

// The block's k-th tile: image n, origin (y0, x0).
__device__ __forceinline__ void deep_tile_of(const Args& p, long long k, int& n, int& y0, int& x0) {
  const long long t = blockIdx.x + k * gridDim.x;
  x0 = static_cast<int>(t % p.tiles_x) * DW;
  y0 = static_cast<int>((t / p.tiles_x) % p.tiles_y) * DR;
  n = static_cast<int>(t / (static_cast<long long>(p.tiles_x) * p.tiles_y));
}

// Warp 0 of the producer: the weights' ring, one bulk copy of N x DK a
// (tile, K stage, tap), packed by the wrapper as the wgmma's K-major core
// matrices (ops/fused_conv.deep_pack), by lane 0.
template <int NT>
__device__ __forceinline__ void deep_weights(const Args& p, __nv_bfloat16* sW, uint64_t* full_w,
                                             uint64_t* empty_w, long long mine, int nk) {
  constexpr int WSTAGE = 8 * NT * DK;
  if ((threadIdx.x & 31) != 0) return;
  long long q = 0;
  for (long long k = 0; k < mine; ++k)
    for (int c = 0; c < nk; ++c)
      for (int tap = 0; tap < 9; ++tap, ++q) {
        const int s = static_cast<int>(q % DSTAGES);
        imgseg::mbar_wait(&empty_w[s], static_cast<int>((q / DSTAGES) & 1) ^ 1);
        imgseg::mbar_arrive_tx(&full_w[s], WSTAGE * 2);
        const size_t at = ((static_cast<size_t>(blockIdx.y) * nk + c) * 9 + tap) * WSTAGE;
        imgseg::bulk_copy(sW + s * WSTAGE, p.w + at, WSTAGE * 2, &full_w[s]);
      }
}

// Warps 1-3 of the producer: the halo of each (tile, K stage), 8 channels
// of a pixel a thread (pt: 0..95), transformed in registers, into 8-channel
// planes of 16-byte pixel rows (the K-major core matrices of A: 8
// consecutive pixels a core matrix); zero outside the image AFTER the
// transform.
template <int LOAD>
__device__ __forceinline__ void deep_halo(const Args& p, __nv_bfloat16* sA, uint64_t* full_a,
                                          uint64_t* empty_a, long long mine, int nk, int pt) {
  constexpr bool kGe = LOAD == kLoadGeStats || LOAD == kLoadGeAffine;
  constexpr int NR = LOAD == kLoadGeAffine ? 4 : kGe ? 2 : LOAD == kLoadX ? 2 : 0;
  constexpr int PL = DPRODUCERS / 8;  // pixel lanes
  constexpr int U = 8;                // vectors in flight a thread
  const int H = p.H, W = p.W;
  const int j = pt & 7;  // this thread's plane: the stride is a multiple of 8
  long long g = 0;
  for (long long k = 0; k < mine; ++k) {
    int n, y0, x0;
    deep_tile_of(p, k, n, y0, x0);
    const size_t img = static_cast<size_t>(n) * H;
    for (int c = 0; c < nk; ++c, ++g) {
      const int b = static_cast<int>(g & 1);
      const int gc = c * DK + 8 * j;  // channel of [x | xb], or of g
      const bool in_b = LOAD == kLoadX && gc >= p.Ca;
      const __nv_bfloat16* src = in_b ? p.xb : p.x;
      const int cs = in_b ? p.Cb : p.Ca, cc = in_b ? gc - p.Ca : gc;
      // this stage's transform rows at the thread's 8 channels
      const bool rows = kGe || (LOAD == kLoadX && p.ab != nullptr && !in_b);
      float r[4][8];
#pragma unroll
      for (int i = 0; i < NR; ++i) {
        if (rows) imgseg::load_row8(p.ab + i * p.Ca, gc, r[i]);
      }
      imgseg::mbar_wait(&empty_a[b], static_cast<int>((g >> 1) & 1) ^ 1);
      __nv_bfloat16* dst = sA + b * DA + j * DPLANE;
      for (int q0 = pt >> 3; q0 < DHALO; q0 += U * PL) {
        uint4 v[U], yv[U];
        bool ok[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int q = q0 + u * PL;
          const int gy = y0 - 1 + q / (DW + 2), gx = x0 - 1 + q % (DW + 2);
          ok[u] = q < DHALO && gy >= 0 && gy < H && gx >= 0 && gx < W;
          v[u] = yv[u] = make_uint4(0u, 0u, 0u, 0u);
          if (ok[u]) {
            const size_t pix = (img + gy) * W + gx;
            v[u] = __ldg(reinterpret_cast<const uint4*>(src + pix * cs + cc));
            if constexpr (kGe) yv[u] = __ldg(reinterpret_cast<const uint4*>(p.xb + pix * cs + cc));
          }
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int q = q0 + u * PL;
          if (q >= DHALO) break;
          uint4 val = v[u];
          if (ok[u] && rows) {
            if constexpr (LOAD == kLoadX) {
              val = imgseg::affine_relu8(r[0], r[1], v[u]);
            } else if constexpr (kGe) {
              val = imgseg::cotangent8<LOAD == kLoadGeAffine>(r, v[u], yv[u]);
            }
          }
          *reinterpret_cast<uint4*>(dst + q * 8) = val;
        }
      }
      imgseg::fence_proxy_async();  // the stores, before the wgmma reads them
      imgseg::mbar_arrive(&full_a[b]);
    }
  }
}

template <int LOAD, int EPI, int NT>
__global__ void __launch_bounds__(DTHREADS, 1) deep_kernel(const Args p) {
  constexpr int N = 8 * NT;
  constexpr int WSTAGE = N * DK;  // bf16 of one (tap, K stage) weight tile
  constexpr bool kSums = EPI == kEpiStats || EPI == kEpiPost;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sA = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // two staged halos
  __nv_bfloat16* sW = sA + 2 * DA;                                  // the weights' ring
  __shared__ uint64_t full_a[2], empty_a[2], full_w[DSTAGES], empty_w[DSTAGES];
  __shared__ float red[8][2][N];  // the sum epilogues: one row a consumer warp

  const int H = p.H, W = p.W, Co = p.Co, cin = p.Ca + p.Cb;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int co0 = blockIdx.y * N;
  const int nk = cin / DK;  // K stages a tile
  const long long mine = (p.tiles - 1 - blockIdx.x) / gridDim.x + 1;

  if (tid == 0) {
    for (int i = 0; i < 2; ++i) {
      imgseg::mbar_init(&full_a[i], DPRODUCERS);
      imgseg::mbar_init(&empty_a[i], 8);  // lane 0 of each consumer warp
    }
    for (int i = 0; i < DSTAGES; ++i) {
      imgseg::mbar_init(&full_w[i], 1);
      imgseg::mbar_init(&empty_w[i], 8);
    }
    imgseg::fence_barrier_init();
  }
  for (int i = tid; i < 8 * 2 * N; i += DTHREADS) (&red[0][0][0])[i] = 0.f;
  __syncthreads();

  if (warp < 4) {  // ---- the producer warpgroup
    imgseg::reg_dealloc<DPRODUCER_REGS>();
    if (warp == 0) {
      deep_weights<NT>(p, sW, full_w, empty_w, mine, nk);
    } else {
      deep_halo<LOAD>(p, sA, full_a, empty_a, mine, nk, tid - 32);
    }
  } else {
    // ---- the consumers: warpgroup cw owns tile rows 2cw, 2cw+1 (m64 tiles
    // jm = 0, 1: one image row of DW pixels each) by all N channels
    imgseg::reg_alloc<DCONSUMER_REGS>();
    const int cw = warp / 4 - 1, w = warp & 3;
    float acc[2][4 * NT];
    long long g = 0, q = 0;
    int pend_w = -1, pend_a = -1;  // what the group in flight reads
    auto release = [&]() {
      if (lane == 0) {
        if (pend_w >= 0) imgseg::mbar_arrive(&empty_w[pend_w]);
        if (pend_a >= 0) imgseg::mbar_arrive(&empty_a[pend_a]);
      }
      pend_w = pend_a = -1;
    };
    for (long long k = 0; k < mine; ++k) {
      int n, y0, x0;
      deep_tile_of(p, k, n, y0, x0);
      for (int c = 0; c < nk; ++c, ++g) {
        const int b = static_cast<int>(g & 1);
        imgseg::mbar_wait(&full_a[b], static_cast<int>((g >> 1) & 1));
        const __nv_bfloat16* a0 = sA + b * DA;
#pragma unroll 1
        for (int tap = 0; tap < 9; ++tap, ++q) {
          const int s = static_cast<int>(q % DSTAGES);
          imgseg::mbar_wait(&full_w[s], static_cast<int>((q / DSTAGES) & 1));
          const int ky = tap / 3, kx = tap % 3;
          const __nv_bfloat16* w0 = sW + s * WSTAGE;
          imgseg::wgmma_fence();
#pragma unroll
          for (int ks = 0; ks < DK / 16; ++ks) {
            // B: K-major cores (n/8, k/8) of 128 bytes: K-adjacent 128 apart, N-adjacent 1024
            const uint64_t db = imgseg::wgmma_desc(w0 + ks * 128, 128, 1024);
#pragma unroll
            for (int jm = 0; jm < 2; ++jm) {
              // A: pixel rows of plane 2ks, shifted by the tap; K-adjacent planes DPLANE apart
              const __nv_bfloat16* at = a0 + 2 * ks * DPLANE + ((2 * cw + jm + ky) * (DW + 2) + kx) * 8;
              const uint64_t da = imgseg::wgmma_desc(at, DPLANE * 2, 128);
              imgseg::wgmma<0, 0, NT>(acc[jm], da, db, (c | tap | ks) != 0);
            }
          }
          imgseg::wgmma_commit();
          imgseg::wgmma_wait<1>();  // the previous group is done: free what it read
          release();
          pend_w = s;
          if (tap == 8) pend_a = b;
        }
      }
      imgseg::wgmma_wait<0>();
      imgseg::fence_acc(acc[0]);
      imgseg::fence_acc(acc[1]);
      release();

      // ---- the epilogue on the accumulators: lane holds pixels 16w +
      // lane/4 (+8) of rows 2cw + jm, channels 8t + 2(lane%4) (+1)
      const size_t img = static_cast<size_t>(n) * H;
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        const int gco = co0 + 8 * t + 2 * (lane & 3);
        float bias[2] = {0.f, 0.f};
        if (p.bias != nullptr) bias[0] = p.bias[gco], bias[1] = p.bias[gco + 1];
        float s1[2] = {0.f, 0.f}, s2[2] = {0.f, 0.f};
#pragma unroll
        for (int jm = 0; jm < 2; ++jm) {
          const int gy = y0 + 2 * cw + jm;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int gx = x0 + 16 * w + (lane >> 2) + 8 * h;
            if (gy >= H || gx >= W) continue;
            const float v[2] = {acc[jm][4 * t + 2 * h] + bias[0], acc[jm][4 * t + 2 * h + 1] + bias[1]};
            emit<EPI>(p, (img + gy) * W + gx, gco, v, s1, s2);
          }
        }
        if constexpr (kSums) {
          // the 8 lanes of one channel pair, then this warp's row over its tiles
#pragma unroll
          for (int e = 0; e < 2; ++e)
#pragma unroll
            for (int off = 4; off < 32; off <<= 1) {
              s1[e] += __shfl_xor_sync(0xffffffffu, s1[e], off);
              s2[e] += __shfl_xor_sync(0xffffffffu, s2[e], off);
            }
          if (lane < 4) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              red[warp - 4][0][8 * t + 2 * lane + e] += s1[e];
              red[warp - 4][1][8 * t + 2 * lane + e] += s2[e];
            }
          }
        }
      }
    }
    if constexpr (kSums) {
      // one row of partial sums a block: the consumer warps' rows in order
      imgseg::named_sync(1, 256);
      for (int i = tid - 128; i < 2 * N; i += 256) {
        const int r = i / N, c = i % N;
        float s = 0.f;
#pragma unroll
        for (int wr = 0; wr < 8; ++wr) s += red[wr][r][c];
        p.partial[(static_cast<size_t>(blockIdx.x) * 2 + r) * Co + co0 + c] = s;
      }
    }
  }
}

// The kernels' paths (imgseg_conv3x3_path).
enum Path { kVector = 0, kNarrow = 1, kDeep = 2 };

int g_last_path = kVector;  // the path of the latest launch

// The narrow kernel: as many blocks as fit on the card at once, each walking
// every gridDim.x-th pixel tile of one N tile (blockIdx.y).  The grid, so
// the order of every sum, depends only on the shape and the card.
template <int LOAD, int EPI, int NT>
int launch_narrow(Args& p, int B, cudaStream_t stream) {
  static bool opted = false;
  auto* kernel = narrow_kernel<LOAD, EPI, NT>;
  // opted in once to the most any shape takes: 32-channel stages of x and xb
  cudaError_t err = imgseg::allow_smem(kernel, narrow_bytes(NKP, NT, 2 * NKP + 1, NKP, NKP), opted);
  if (err != cudaSuccess) return static_cast<int>(err);
  constexpr bool kGe = LOAD == kLoadGeStats || LOAD == kLoadGeAffine;
  const int cb = LOAD == kLoadX ? p.Cb : kGe ? p.Ca : 0;
  const size_t bytes = narrow_bytes(p.kp, NT, p.Ca + p.Cb, p.Ca, cb);
  static size_t asked = 0;  // the last size asked about, and its answer
  static int resident = 0;
  if (bytes != asked) {
    err = imgseg::resident_blocks(kernel, THREADS, bytes, resident);
    if (err != cudaSuccess) return static_cast<int>(err);
    asked = bytes;
  }
  p.tiles_x = (p.W + TW - 1) / TW;
  p.tiles_y = (p.H + NTH - 1) / NTH;
  p.tiles = static_cast<long long>(B) * p.tiles_x * p.tiles_y;
  const long long per = resident / p.co_tiles > 1 ? resident / p.co_tiles : 1;
  p.nblk = static_cast<int>(p.tiles < per ? p.tiles : per);
  if (p.co_tiles > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
  kernel<<<dim3(p.nblk, p.co_tiles), THREADS, bytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// The deep kernel: one block an SM (its shared memory takes more than half
// of one), each walking every gridDim.x-th pixel tile of one N tile
// (blockIdx.y).  The grid depends only on the shape and the card.
template <int LOAD, int EPI, int NT>
int launch_deep(Args& p, int B, cudaStream_t stream) {
  static bool opted = false;
  auto* kernel = deep_kernel<LOAD, EPI, NT>;
  cudaError_t err = imgseg::allow_smem(kernel, deep_bytes(NT), opted);
  if (err != cudaSuccess) return static_cast<int>(err);
  static int resident = 0;
  if (resident == 0) {
    err = imgseg::resident_blocks(kernel, DTHREADS, deep_bytes(NT), resident);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  p.tiles_x = (p.W + DW - 1) / DW;
  p.tiles_y = (p.H + DR - 1) / DR;
  p.tiles = deep_tiles(B, p.H, p.W);
  p.co_tiles = p.Co / (8 * NT);
  const long long per = resident / p.co_tiles > 1 ? resident / p.co_tiles : 1;
  p.nblk = static_cast<int>(p.tiles < per ? p.tiles : per);
  if (p.co_tiles > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
  kernel<<<dim3(p.nblk, p.co_tiles), DTHREADS, deep_bytes(NT), stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// The card's SMs: the vector path's blocks, one an SM.
int sm_count() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 132;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) return 132;
  return sms > 0 ? sms : 132;
}

// Units of the vector path (strips of sw pixels of one row) and its
// runs: one wave, one block an SM beside the N tiles, every run non-empty.
long long vec_runs(Args& p, int B) {
  p.tiles_x = (p.W + p.vsw - 1) / p.vsw;
  p.tiles = static_cast<long long>(B) * p.tiles_x * p.H;
  long long runs = sm_count() / p.co_tiles;
  runs = runs < 1 ? 1 : runs > p.tiles ? p.tiles : runs;
  p.per_chunk = (p.tiles + runs - 1) / runs;
  return (p.tiles + p.per_chunk - 1) / p.per_chunk;
}

// The vector path: blockIdx.x the N tile, blockIdx.y the run, so the
// N tiles of one run are neighbours in the grid and read its operand rows
// together (the second read from L2).
template <int LOAD, int EPI, int NT>
int launch_vec(Args& p, int B, cudaStream_t stream) {
  static bool opted = false;
  auto* kernel = vec_kernel<LOAD, EPI, NT>;
  cudaError_t err = imgseg::allow_smem(kernel, FSMEM, opted);
  if (err != cudaSuccess) return static_cast<int>(err);
  p.nblk = static_cast<int>(vec_runs(p, B));
  if (p.nblk > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
  kernel<<<dim3(p.co_tiles, p.nblk), FTHREADS,
           fvec_bytes(p.vsw, p.vcpad, p.vntile, p.vxr, vec_rows(LOAD), p.vy != 0),
                                                   stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int LOAD, int EPI>
int launch(Args& p, int B, cudaStream_t stream) {
  g_last_path = p.deep ? kDeep : p.kp != 0 ? kNarrow : kVector;
  if (p.deep) {
    return p.deep == 128 ? launch_deep<LOAD, EPI, 16>(p, B, stream)
                         : launch_deep<LOAD, EPI, 8>(p, B, stream);
  }
  if (p.kp != 0) {
    const int nt = p.Co <= 8 ? 1 : p.Co <= 16 ? 2 : 4;  // N = 8, 16 or 32
    p.co_tiles = (p.Co + 8 * nt - 1) / (8 * nt);
    return nt == 1   ? launch_narrow<LOAD, EPI, 1>(p, B, stream)
           : nt == 2 ? launch_narrow<LOAD, EPI, 2>(p, B, stream)
                     : launch_narrow<LOAD, EPI, 4>(p, B, stream);
  }
  p.co_tiles = (p.Co + p.vntile - 1) / p.vntile;
  const int nt = (p.vsplit ? p.vntile / 2 : p.vntile) / 8;  // n8 tiles a consumer warpgroup
  if (nt == 2) return launch_vec<LOAD, EPI, 2>(p, B, stream);
  if (nt == 4) return launch_vec<LOAD, EPI, 4>(p, B, stream);
  if constexpr (EPI != kEpiPost) {  // vec_plan gives the post at most 4, the rest at most 8
    if (nt == 8) return launch_vec<LOAD, EPI, 8>(p, B, stream);
  }
  return static_cast<int>(cudaErrorInvalidConfiguration);
}

bool aligned16(const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16 == 0; }

// The path the caller chose (`path`: ops/fused_conv._path_arg, from
// conv_path and the operands' alignment): 0 the narrow path, kp channels a
// stage; 1 the vector path; 64 or 128 the deep path, that N tile.  The
// library chooses nothing: it refuses (returns false) a vector or deep
// path whose channel counts or operands it cannot take.  `path` also names
// w's layout (vector_pack on the vector path, deep_pack on the deep path,
// (3, 3, Cin, Co) on the narrow path); the vector path's tiles must fit
// (vec_plan, with the mode's nrows transform rows, max_nt n8 tiles a
// consumer warpgroup and, for the dgrad's cotangent transform, y in the
// ring where it fits).
bool take_path(Args& p, int path, int nrows, int max_nt = 8, bool yring = false) {
  const bool aligned = aligned16(p.x) && aligned16(p.xb) && aligned16(p.ab) && aligned16(p.w);
  if (path == 64 || path == 128) {
    p.deep = path;
    return p.Ca % DK == 0 && p.Cb % DK == 0 && p.Co % path == 0 && p.Na % 2 == 0 && aligned;
  }
  const int cin = p.Ca + p.Cb;
  p.kp = path == 1 ? 0 : cin > NKP ? NKP : (cin + 7) / 8 * 8;
  if (path == 0) return true;
  return path == 1 && p.Ca % 8 == 0 && p.Cb % 8 == 0 && p.Co % 8 == 0 && p.Na % 8 == 0 && aligned &&
         aligned16(p.xpost) && vec_plan(cin, p.Co, p.W, nrows, max_nt, yring, p);
}

// The second pass of the sum epilogues: (blocks, 2, Co) rows -> (2, Co).
int finish_sums(const Args& p, float* sums, cudaStream_t stream) {
  return static_cast<int>(imgseg::sum_rows(p.partial, sums, p.nblk, 2LL * p.Co, stream));
}

}  // namespace

// Floats of scratch the sum epilogues need: one (2, Co) row per block of
// the narrow path (no more blocks than its 16x16-pixel tiles), of the deep
// path (no more than its tiles) or of the vector path (one a run: no more
// than the SMs, nor than its units, strips of 64 or 128 pixels of one
// row), whichever is more.
extern "C" long long imgseg_conv3x3_scratch(int B, int H, int W, int Co) {
  const long long narrow = static_cast<long long>(B) * ((H + NTH - 1) / NTH) * ((W + TW - 1) / TW);
  const long long deep = deep_tiles(B, H, W);
  long long runs = static_cast<long long>(B) * H * ((W + 63) / 64);
  runs = runs < sm_count() ? runs : sm_count();
  const long long most = narrow > deep ? narrow : deep;
  return (most > runs ? most : runs) * 2LL * Co;
}

// The path of the latest launch of imgseg_conv3x3 or imgseg_conv3x3_dgrad:
// 0 vector, 1 narrow, 2 deep.
extern "C" int imgseg_conv3x3_path() { return g_last_path; }

// y = conv(act([x | xb])) + bias; with `stats` (2, Co) also the sums of y
// and y*y over (B, H, W), using `scratch`.  `path`: as take_path takes it.
extern "C" int imgseg_conv3x3(const void* x, const void* xb, const void* w,
                              const void* bias, const void* ab, void* out, void* stats,
                              void* scratch, int B, int H, int W, int Ca, int Cb, int Co,
                              int path, void* stream) {
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
  if (!take_path(p, path, FROWS_FWD)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (stats == nullptr) return launch<kLoadX, kEpiStore>(p, B, s);
  const int err = launch<kLoadX, kEpiStats>(p, B, s);
  return err != 0 ? err : finish_sums(p, static_cast<float*>(stats), s);
}

// dx = conv(ge, w) of the transformed cotangent ge (from g, y and the
// (2|4, Cg) rows `gf`; `affine` selects the 4-row form), or without `gf`
// of g itself (y unread; neither `xpost` nor `out_b`).  With `xpost`: the
// post adjoint, `sums` (2, Co) = [sum gu*xpost, sum gu]; with `out_b`: dx
// split at channel Na.  `path`: as take_path takes it.
extern "C" int imgseg_conv3x3_dgrad(const void* g, const void* y, const void* gf,
                                    const void* w, const void* xpost, const void* abpost,
                                    void* out, void* out_b, void* sums, void* scratch, int B,
                                    int H, int W, int Cg, int Co, int Na, int affine, int path,
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
  if (!take_path(p, path, FROWS_DGRAD, xpost != nullptr ? 4 : 8, gf != nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (gf == nullptr) {
    if (xpost != nullptr || out_b != nullptr) return static_cast<int>(cudaErrorInvalidValue);
    return launch<kLoadG, kEpiStore>(p, B, s);
  }
  int err;
  if (xpost != nullptr) {
    err = affine ? launch<kLoadGeAffine, kEpiPost>(p, B, s) : launch<kLoadGeStats, kEpiPost>(p, B, s);
    return err != 0 ? err : finish_sums(p, static_cast<float*>(sums), s);
  }
  if (out_b != nullptr) {
    return affine ? launch<kLoadGeAffine, kEpiSplit>(p, B, s) : launch<kLoadGeStats, kEpiSplit>(p, B, s);
  }
  return affine ? launch<kLoadGeAffine, kEpiStore>(p, B, s) : launch<kLoadGeStats, kEpiStore>(p, B, s);
}

extern "C" const char* imgseg_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
