// ADown, the whole block in one kernel (inference, BN folded):
//
//   a  = avgpool(2, stride 1, pad 0)(x)                 (B, H-1, W-1, Cin)
//   a1, a2 = a[..., :Cin/2], a[..., Cin/2:]
//   y1 = SiLU(conv3x3_s2_p1(a1; w1) + b1)               zero padding
//   y2 = SiLU(conv1x1(maxpool(3, 2, 1)(a2); w2) + b2)   -inf padding
//   y  = concat(y1, y2)                                 (B, H/2, W/2, Cout)
//
// Replaces the TPU kernel yolo_re_tpu/ops/pallas/adown_kernel.py
// (adown_from_packed). Its width-packed p=2 input layout exists for the
// TPU's lanes and is not ported: input and output here are plain NHWC
// (channels_last), for any even Cin and Cout and any H, W >= 2. The edge
// rules are that kernel's (adown_kernel.py:26-29): the avg domain is rows
// 0..H-2 and columns 0..W-2; outside it the conv branch sees 0 and the
// maxpool branch -inf; a maxpool window wholly outside the output is kept
// finite. The /4 of the average is applied to each window sum,
// 0.25 * ((x00 + x01) + (x10 + x11)) in f32 (exact in binary floating
// point, like the TPU kernel's folding into the weights).
//
// The same kernels give the pre-BN train forward (yolo_adown_raw,
// replacing adown_from_packed(raw=True)): no bias and no SiLU. Its
// backward is csrc/adown_bwd.cu.
//
// Weights: one packed image per branch (hopper.cuh: packed_index), the
// wgmma B layout, input channels padded with zeros to a multiple of 16 and
// output channels to 128 (Co <= 128) or a multiple of 256 (`packed_n`).
// A fused ADown packs them once (ops/kernels/adown.py: pack_weights); the
// train forward packs, casting to x's dtype, in one launch of
// yolo_adown_pack. Every variant below reads the same image.
//
// What bounds it on an H100 (bf16, gelan-c at 640 px, batch 32): x, the
// weights and y once each at 3.35 TB/s, or the products at 989 TFLOP/s:
//   down1      (32, 160, 160, 256) -> 256   524.6 MB  67.1 GFLOP  0.157 ms
//   down2      (32,  80,  80, 512) -> 512   263.4 MB  67.1 GFLOP  0.079 ms
//   down3      (32,  40,  40, 512) -> 512    66.8 MB  16.8 GFLOP  0.020 ms
//   pan_down1  (32,  80,  80, 256) -> 256   131.4 MB  16.8 GFLOP  0.039 ms
//   pan_down2  (32,  40,  40, 512) -> 512    66.8 MB  16.8 GFLOP  0.020 ms
// bytes everywhere, but at down2 the products (0.068 ms) come close: the
// kernel has to stream x once and keep the tensor cores fed.
//
// bf16 with Cin and Cout multiples of 16 (every ADown of gelan-c and of the
// tiny test model): a persistent, warp-specialized wgmma kernel. What it
// does about what held the wmma kernel it replaced at 0.064 of the bound:
// 1. The grid split what the TPU kernel keeps together (2-4 CTAs per tile,
//    each re-reading x and re-forming the avg). Here one CTA takes an
//    output tile of up to 128 pixels (8 x 16; 12 x 10 or 6 x 20 where that
//    needs fewer rounds of the grid), both branches one after the other,
//    and every output channel of each: N = 128 (Co <= 128), or 256 as two
//    warpgroups' m64n256 accumulators over the tile's two halves of 64
//    pixels (Co > 256 walks n-blocks of 256). Each avg value is formed
//    once and x leaves device memory about once; the one-row halo comes
//    from L2.
// 2. Nothing overlapped. Here the CTA's warps have roles. Warpgroups 0 and
//    1 run the products and the epilogue. One thread of warp 8 streams each
//    chunk's weights (16 input channels) by bulk copies (the TMA engine,
//    completion on an mbarrier) into a ring of 2 (N = 256) or 3 (N = 128)
//    slots. The builder warps after it (3 at N = 256, where the consumers'
//    128 accumulators leave registers for 384 threads only; 7 at N = 128)
//    load x patches by cp.async with zero fill into a ring of their own,
//    kXStages - 1 chunks ahead, and build each chunk's A operand into an
//    operand slot; named barriers hand the operand slots over. A
//    persistent grid (resident CTAs per SM by the occupancy API x the SM
//    count) walks the tiles in (image, row, column) order, so that halos
//    are still in L2, and its rings run on across tiles. The products of
//    consecutive chunks follow each other without a drain: a chunk's slot
//    is released once the next chunk's first product is issued.
// 3. The weights were staged from a (Cin/2, 3, 3, Co) layout that the
//    wrapper permuted on every call. Here they are packed once (above) in
//    the B layout and read by descriptor; branch 1's (1.18 MB at Ch = Co =
//    256) stream by chunk.
// 4. The avg took four x loads per avg pixel for every 16-channel chunk.
//    Here the builders form each chunk's operand once from the x patch in
//    shared memory, as bf16 in 32-byte pixels whose 16-byte halves are
//    XOR-swizzled (unit u at u ^ ((u >> 3) & 3)), so that ldmatrix reading
//    8 pixels at a stride of 2 (the conv's stride) hits 8 bank groups.
//    Branch 1: the (2R+1) x (2C+1) avg patch, rounded to bf16 (the JAX bf16
//    graph's rounding point); its products are an implicit GEMM, 9 taps of
//    one k-step a chunk, A by ldmatrix at the tap's pixel shift, the next
//    tap's A registers loading while a product runs. Branch 2: the 3 x 3
//    max of the avg of each output pixel, straight from the x patch into a
//    128 x 16 A tile, then one wgmma k16.
// 5. The epilogue went through shared memory in 2-byte elements. Here it
//    runs from the accumulator registers: bias and SiLU in f32 (raw:
//    neither), one rounding, bf16 pairs exchanged within lane quads,
//    16-byte stores into the branch's channel slice of y.
// Raw mode is a template parameter (as a run-time flag in the wmma kernel
// it cost 7 registers and a third of the speed).
//
// f32 (the default dtype of the Evaluator and of TrainConfig), any even
// Cin and Cout: the products on the tensor cores in 3xTF32 by TF32 wgmma
// (hopper.cuh: wgmma_m64n128k8_tf32; one TF32 product misses the f32
// tolerances), `namespace f32` below. Its bound is the products: 10 x 2 x
// Ch x (output elements / 2) operations at 495 / 3 TFLOP/s, 0.407 ms at
// down1 and down2, 0.102 at down3, pan_down1 and pan_down2 (the f32 bytes,
// 0.31, 0.16, 0.04, 0.08, 0.04 ms, stay below): one block takes a tile's
// whole n-block of output channels for both branches, so each avg value is
// formed once a task, and its loads, operand builds and products overlap.
//
// bf16 with channel counts that are not multiples of 16 (no model config;
// the card tests): CUDA cores, an 8x8-pixel tile, 64 output channels of
// one branch per block, chunks of 16 input channels, a 4-pixel x
// 4-channel f32 register tile per thread.
#include "common.cuh"
#include "hopper.cuh"

namespace yolo {
namespace {

// output channels of the packed image: 128, or a multiple of 256
__host__ __device__ constexpr int packed_n(int co) {
  return co <= 128 ? 128 : (co + 255) / 256 * 256;
}

constexpr int kTile = 8;                 // output tile kTile x kTile pixels
constexpr int kPatch = 2 * kTile + 1;    // avg patch rows / cols
constexpr int kCK = 16;                  // input channels per chunk
constexpr int kCoT = 64;                 // output channels per block
constexpr int kThreads = 256;

constexpr int kAvgFloats = kPatch * kPatch * kCK;
constexpr int kW1Floats = 9 * kCK * kCoT;
constexpr int kMaxFloats = kTile * kTile * kCK;
constexpr size_t kSmemBytes =
    sizeof(float) * (kAvgFloats + kW1Floats + kMaxFloats);

using bf16 = __nv_bfloat16;

// 8 contiguous elements of the packed image (one output channel's 8 input
// channels of a tap), as f32
__device__ __forceinline__ void load8(float (&v)[8], const bf16* p) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__global__ void __launch_bounds__(kThreads)
adown_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w1,
             const bf16* __restrict__ b1, const bf16* __restrict__ w2,
             const bf16* __restrict__ b2, bf16* __restrict__ y, int H, int W,
             int Cin, int Cout, int Ho, int Wo, int tiles_w, int co_tiles,
             int raw) {
  extern __shared__ float smem[];
  float* avg_s = smem;                    // [kPatch][kPatch][kCK]
  float* w_s = avg_s + kAvgFloats;        // [tap][kCK][kCoT] (branch 2: tap 0)
  float* max_s = w_s + kW1Floats;         // [kTile * kTile][kCK]

  const int Ch = Cin / 2;                 // input channels of each branch
  const int Co = Cout / 2;                // output channels of each branch
  const int KS = ceil_div(Ch, 16);        // k-steps of the packed image
  const size_t blk = (size_t)16 * packed_n(Co);   // elements of a block
  const int tile = blockIdx.x;
  const int oy0 = (tile / tiles_w) * kTile, ox0 = (tile % tiles_w) * kTile;
  const int branch = blockIdx.y / co_tiles;
  const int co0 = (blockIdx.y % co_tiles) * kCoT;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;

  // register tile: 4 pixels (one row, 4 adjacent columns) x 4 channels
  const int cg = tid % 16, pg = tid / 16;
  const int pr = pg / 2, pc0 = (pg % 2) * 4;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  const bf16* xb = x + (size_t)b * H * W * Cin;
  const int cbase = branch * Ch;          // first input channel of the branch
  const float pad = branch == 0 ? 0.0f : -CUDART_INF_F;

  for (int ci0 = 0; ci0 < Ch; ci0 += kCK) {
    // 1. avg patch: local (r, c) <-> avg pixel (2*oy0-1+r, 2*ox0-1+c)
    for (int e = tid; e < kAvgFloats; e += kThreads) {
      const int k = e % kCK, rc = e / kCK;
      const int r = rc / kPatch, c = rc % kPatch;
      const int ay = 2 * oy0 - 1 + r, ax = 2 * ox0 - 1 + c;
      float v = pad;
      if (ci0 + k >= Ch) {
        v = 0.0f;                         // channel past the branch: no term
      } else if (ay >= 0 && ay <= H - 2 && ax >= 0 && ax <= W - 2) {
        const bf16* p = xb + ((size_t)ay * W + ax) * Cin + cbase + ci0 + k;
        const size_t row = (size_t)W * Cin;
        v = 0.25f * ((to_f32(p[0]) + to_f32(p[Cin])) +
                     (to_f32(p[row]) + to_f32(p[row + Cin])));
      }
      avg_s[e] = v;
    }
    // 2. weights of the chunk, f32, [tap][ci][co], from the packed image
    //    (zero past Ch and Co), where the chunk's 64 output channels of a
    //    tap are 8 groups of 8, each 2 x 8 input channels: an item is one
    //    output channel's 8 contiguous input channels, the lanes along the
    //    output channels, so that the shared-memory writes do not conflict
    const int taps = branch == 0 ? 9 : 1;
    const bf16* wsrc = (branch == 0 ? w1 : w2) + (size_t)(ci0 / 16) * blk +
                    (co0 / 8) * 128;
    for (int it = tid; it < taps * 128; it += kThreads) {
      const int nr = it % 8, grp = (it / 8) % 8, kh = (it / 64) % 2;
      const int tap = it / 128;
      float v[8];
      load8(v, wsrc + (size_t)tap * KS * blk + grp * 128 + kh * 64 + nr * 8);
      float* dst = w_s + (tap * kCK + 8 * kh) * kCoT + 8 * grp + nr;
#pragma unroll
      for (int i = 0; i < 8; ++i) dst[i * kCoT] = v[i];
    }
    __syncthreads();

    if (branch == 0) {
      // 3a. 3x3 stride-2 conv over the avg patch
#pragma unroll
      for (int ky = 0; ky < 3; ++ky) {
#pragma unroll
        for (int kx = 0; kx < 3; ++kx) {
          const float* wt = w_s + (3 * ky + kx) * kCK * kCoT + 4 * cg;
          const float* at = avg_s + ((2 * pr + ky) * kPatch + 2 * pc0 + kx) * kCK;
#pragma unroll 4
          for (int k = 0; k < kCK; ++k) {
            const float4 wv = *reinterpret_cast<const float4*>(wt + k * kCoT);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const float a = at[2 * i * kCK + k];
              acc[i][0] += a * wv.x; acc[i][1] += a * wv.y;
              acc[i][2] += a * wv.z; acc[i][3] += a * wv.w;
            }
          }
        }
      }
    } else {
      // 3b. maxpool(3, 2, 1) of the avg patch into max_s, then 1x1 conv
      for (int e = tid; e < kMaxFloats; e += kThreads) {
        const int k = e % kCK, p = e / kCK;
        const int r = p / kTile, c = p % kTile;
        float m = -CUDART_INF_F;
#pragma unroll
        for (int ky = 0; ky < 3; ++ky)
#pragma unroll
          for (int kx = 0; kx < 3; ++kx)
            m = fmaxf(m, avg_s[((2 * r + ky) * kPatch + 2 * c + kx) * kCK + k]);
        // a pixel outside the output has an all -inf window: keep it finite
        max_s[e] = (oy0 + r < Ho && ox0 + c < Wo) ? m : 0.0f;
      }
      __syncthreads();
      const float* mt = max_s + (pr * kTile + pc0) * kCK;
#pragma unroll 4
      for (int k = 0; k < kCK; ++k) {
        const float4 wv = *reinterpret_cast<const float4*>(w_s + k * kCoT + 4 * cg);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float a = mt[i * kCK + k];
          acc[i][0] += a * wv.x; acc[i][1] += a * wv.y;
          acc[i][2] += a * wv.z; acc[i][3] += a * wv.w;
        }
      }
    }
    __syncthreads();
  }

  // epilogue: bias + SiLU (raw: neither), into channels [branch*Co + co]
  const bf16* bias = branch == 0 ? b1 : b2;
  const int oy = oy0 + pr;
  if (oy >= Ho) return;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int co = co0 + 4 * cg + j;
    if (co >= Co) continue;
    const float bj = raw ? 0.0f : to_f32(bias[co]);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int ox = ox0 + pc0 + i;
      if (ox >= Wo) continue;
      y[(((size_t)b * Ho + oy) * Wo + ox) * Cout + branch * Co + co] =
          from_f32<bf16>(raw ? acc[i][j] : silu(acc[i][j] + bj));
    }
  }
}


// ---------------------------------------------------------------------------
// bf16 tensor-core variant (wgmma; Cin % 16 == 0 and Cout % 16 == 0)
// ---------------------------------------------------------------------------

namespace tc {

using bf16 = __nv_bfloat16;
using namespace sm90;

// warpgroups 0, 1 run the products; warp 8 streams the weights (one
// thread, bulk copies); kBuildWarps warps after it load the x patches and
// build the operands: 7 at N = 128, 3 at N = 256, where the consumers'
// 128 accumulators each leave registers for 384 threads only (168 each)
constexpr int kConsumers = 256;
template <int kBuildWarps>
__host__ __device__ constexpr int threads() {
  return kConsumers + 32 + 32 * kBuildWarps;
}
constexpr int kM = 128;                  // tile pixels, 64 per consumer
constexpr int kPix = 32;                 // bytes of a pixel's 16 channels
constexpr int kXPix = 612;               // x patch pixels of the largest tile
constexpr int kAPix = 561;               // avg patch pixels of the largest tile
constexpr int kXBytes = kXPix * kPix;                      // 19,584
constexpr int kABytes = (kAPix * kPix + 127) / 128 * 128;  // 18,048
// named barriers (0 is __syncthreads): FULL and EMPTY per operand slot,
// between the builders and the consumers, and the builders' own
constexpr int kMaxSlots = 3;
constexpr int kFullBar = 1, kEmptyBar = 1 + kMaxSlots,
              kProdBar = 1 + 2 * kMaxSlots;

// one chunk's branch-1 weights: 9 blocks of 16 x kN
template <int kN>
__host__ __device__ constexpr int w_bytes() { return 9 * 16 * kN * 2; }

// kSlots x (weights + operand), kXStages x patches, then the weight
// slots' mbarriers: 222,784 bytes at N = 256 (2, 2), 223,552 at N = 128
// (3, 3); a block may have 232,448
template <int kN, int kSlots, int kXStages>
__host__ __device__ constexpr int bar_offset() {
  return kSlots * (w_bytes<kN>() + kABytes) + kXStages * kXBytes;
}

template <int kN, int kSlots, int kXStages>
__host__ __device__ constexpr int smem_bytes() {
  return bar_offset<kN, kSlots, kXStages>() + 64;
}

// output tiles (rows x columns, at most kM pixels); the launch takes the
// one that needs the fewest rounds of the grid, then the fewest tiles
struct TileShape {
  int rows, cols;
};
constexpr TileShape kTiles[] = {{8, 16}, {16, 8}, {12, 10},
                                {10, 12}, {6, 20}, {20, 6}};

constexpr bool tiles_fit() {
  for (const TileShape& t : kTiles)
    if (t.rows * t.cols > kM || (2 * t.rows + 2) * (2 * t.cols + 2) > kXPix ||
        (2 * t.rows + 1) * (2 * t.cols + 1) > kAPix)
      return false;
  return true;
}
static_assert(tiles_fit(), "every tile's patches fit their buffers");

struct Geo {
  int B, H, W, Cin, Cout, Ch, Co, Ho, Wo;
  int KS, Np, nblocks;         // k-steps, packed N, n-blocks of kN
  int TR, TC, tiles_h, tiles_w, n_tasks;
  int XPC, APC;                // x and avg patch columns
  float inv_xpc, inv_apc, inv_tc;
};

struct Task {
  int b, oy0, ox0, nb;
};

__device__ __forceinline__ Task task_of(int t, const Geo& g) {
  const int nb = t % g.nblocks;
  t /= g.nblocks;
  const int per = g.tiles_h * g.tiles_w, r = t % per;
  return {t / per, (r / g.tiles_w) * g.TR, (r % g.tiles_w) * g.TC, nb};
}

// a / d for 0 <= a < 2^12 and d <= 42 (the patch widths), by the
// reciprocal inv = 1 / d: (a + 0.5) / d is at least 1 / 84 from an
// integer, far above the float error
__device__ __forceinline__ int div_small(int a, float inv) {
  return __float2int_rz((a + 0.5f) * inv);
}

__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// arrive and expect `bytes` of bulk copies on the barrier
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar), "r"(bytes)
               : "memory");
}

// wait until the barrier's phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// bytes (a multiple of 16) global -> shared by the bulk copy engine,
// completing on the mbarrier
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          int bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// byte offset of 16-byte unit u (pixel u / 2, channels 8 * (u % 2) on) of
// an operand buffer: XOR-swizzled so that 8 pixels at a stride of 1 or 2
// fall in 8 different bank groups
__device__ __forceinline__ uint32_t swz(int u) {
  return 16u * (u ^ ((u >> 3) & 3));
}

__device__ __forceinline__ uint4 ld16(const unsigned char* p) {
  return *reinterpret_cast<const uint4*>(p);
}

__device__ __forceinline__ void to_f32x8(float (&o)[8], uint4 v) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    o[2 * i] = f.x;
    o[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ uint4 to_bf16x8(const float (&f)[8]) {
  return make_uint4(pack_bf16x2(f[0], f[1]), pack_bf16x2(f[2], f[3]),
                    pack_bf16x2(f[4], f[5]), pack_bf16x2(f[6], f[7]));
}

// ---- the weights' warp and the builders ---------------------------------

// cp.async of chunk j's x patch (rows 2*oy0-1 .. 2*oy0+2R, columns
// 2*ox0-1 .. 2*ox0+2C, 16 channels of the branch; zero outside the image
// and past Ch)
template <int kB>
__device__ __forceinline__ void load_x(uint32_t xs, const bf16* x,
                                       const Geo& g, Task t, int j, int pt) {
  const bool pool = j >= g.KS;
  const int s = pool ? j - g.KS : j;
  const int n = (2 * g.TR + 2) * g.XPC * 2;
  const int y0 = 2 * t.oy0 - 1, x0 = 2 * t.ox0 - 1;
  const bf16* xb =
      x + (size_t)t.b * g.H * g.W * g.Cin + (pool ? g.Ch : 0) + 16 * s;
  for (int e = pt; e < n; e += kB) {
    const int h = e & 1, q = e >> 1;
    const int qr = div_small(q, g.inv_xpc);
    const int iy = y0 + qr, ix = x0 + q - qr * g.XPC;
    const bool ok = iy >= 0 && iy < g.H && ix >= 0 && ix < g.W &&
                    16 * s + 8 * h < g.Ch;
    const bf16* src = ok ? xb + ((size_t)iy * g.W + ix) * g.Cin + 8 * h : x;
    cp_async16(xs + 16 * e, src, ok);
  }
}

// The weights' warp: one thread walks the CTA's chunks, waits until the
// consumers have released weight slot c % kSlots (chunk c - kSlots), and
// streams chunk c's weights into it by bulk copies, n-block nb: branch 1
// the blocks (tap, j) of the 9 taps, branch 2 the block j - KS (16 x kN
// elements each, contiguous in the packed image)
template <int kN, int kSlots>
__device__ __forceinline__ void load_weights(uint32_t w_u, uint32_t full,
                                             uint32_t empty, const bf16* w1p,
                                             const bf16* w2p, const Geo& g,
                                             int total) {
  constexpr int kW = w_bytes<kN>(), kBlock = 32 * kN;
  const int CPT = 2 * g.KS;
  const size_t blk = (size_t)16 * g.Np;   // elements of a block
  int ti = blockIdx.x, j = 0;             // chunk j of task ti
#pragma unroll 1
  for (int c = 0; c < total; ++c) {
    const int slot = c % kSlots, use = c / kSlots;
    const bool pool = j >= g.KS;
    const bf16* wb = (pool ? w2p : w1p) + (size_t)(ti % g.nblocks) * 16 * kN +
                     (pool ? j - g.KS : j) * blk;
    const int taps = pool ? 1 : 9;
    if (c >= kSlots) mbar_wait(empty + 8 * slot, (use - 1) & 1);
    mbar_expect_tx(full + 8 * slot, taps * kBlock);
    for (int tap = 0; tap < taps; ++tap)
      bulk_load(w_u + slot * kW + tap * kBlock, wb + tap * g.KS * blk, kBlock,
                full + 8 * slot);
    if (++j == CPT) {
      j = 0;
      ti += gridDim.x;
    }
  }
}

// branch 1's operand: the avg patch (2R+1) x (2C+1), 0 outside the avg
// domain; avg patch pixel (ar, ac) reads x patch pixels (ar, ac) ..
// (ar + 1, ac + 1): 0.25 * ((x00 + x01) + (x10 + x11)) in f32, rounded
template <int kB>
__device__ __forceinline__ void build_avg(const unsigned char* xs,
                                          unsigned char* as, const Geo& g,
                                          Task t, int pt) {
  const int n = (2 * g.TR + 1) * g.APC * 2;
  const int xrow = g.XPC * kPix;
#pragma unroll 2
  for (int e = pt; e < n; e += kB) {
    const int h = e & 1, p = e >> 1;
    const int ar = div_small(p, g.inv_apc), ac = p - ar * g.APC;
    const int ay = 2 * t.oy0 - 1 + ar, ax = 2 * t.ox0 - 1 + ac;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (ay >= 0 && ay <= g.H - 2 && ax >= 0 && ax <= g.W - 2) {
      const unsigned char* q = xs + (ar * g.XPC + ac) * kPix + 16 * h;
      float a[8], b[8], c[8], d[8], f[8];
      to_f32x8(a, ld16(q));
      to_f32x8(b, ld16(q + kPix));
      to_f32x8(c, ld16(q + xrow));
      to_f32x8(d, ld16(q + xrow + kPix));
#pragma unroll
      for (int i = 0; i < 8; ++i)
        f[i] = 0.25f * ((a[i] + b[i]) + (c[i] + d[i]));
      v = to_bf16x8(f);
    }
    *reinterpret_cast<uint4*>(as + swz(e)) = v;
  }
}

// branch 2's operand: row m of the 128 x 16 A tile is maxpool(3, 2, 1) of
// the avg at tile pixel m (-inf outside the avg domain), 0 for a pixel
// outside the output; 4 channels an item. The window's 4 x 4 x pixels are
// read once, a row at a time: the pair sums of x row k and k + 1 give avg
// row k - 1's window sums, in branch 1's order; 0.25 x their max (exact)
// is the max of the f32 avgs, which rounds to the max of the bf16-rounded
// ones.
template <int kB>
__device__ __forceinline__ void build_max(const unsigned char* xs,
                                          unsigned char* as, const Geo& g,
                                          Task t, int pt) {
#pragma unroll 2
  for (int e = pt; e < 4 * kM; e += kB) {
    const int qd = e & 3, m = e >> 2;
    const int r = div_small(m, g.inv_tc), c = m - r * g.TC;
    uint2 v = make_uint2(0, 0);
    if (m < g.TR * g.TC && t.oy0 + r < g.Ho && t.ox0 + c < g.Wo) {
      const int ay0 = 2 * (t.oy0 + r) - 1, ax0 = 2 * (t.ox0 + c) - 1;
      float mx[4], hp[3][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) mx[i] = -CUDART_INF_F;
      const unsigned char* q = xs + ((2 * r) * g.XPC + 2 * c) * kPix + 8 * qd;
#pragma unroll
      for (int k = 0; k < 4; ++k, q += g.XPC * kPix) {
        float f[4][4], cur[3][4];
#pragma unroll
        for (int px = 0; px < 4; ++px) {
          const uint2 u = *reinterpret_cast<const uint2*>(q + px * kPix);
          const float2 lo = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(&u.x));
          const float2 hi = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(&u.y));
          f[px][0] = lo.x;
          f[px][1] = lo.y;
          f[px][2] = hi.x;
          f[px][3] = hi.y;
        }
#pragma unroll
        for (int dx = 0; dx < 3; ++dx)
#pragma unroll
          for (int i = 0; i < 4; ++i) cur[dx][i] = f[dx][i] + f[dx + 1][i];
        const int ay = ay0 + k - 1;       // avg row of x rows k - 1, k
        if (k > 0 && ay >= 0 && ay <= g.H - 2) {
#pragma unroll
          for (int dx = 0; dx < 3; ++dx) {
            const int ax = ax0 + dx;
            if (ax < 0 || ax > g.W - 2) continue;
#pragma unroll
            for (int i = 0; i < 4; ++i)
              mx[i] = fmaxf(mx[i], hp[dx][i] + cur[dx][i]);
          }
        }
#pragma unroll
        for (int dx = 0; dx < 3; ++dx)
#pragma unroll
          for (int i = 0; i < 4; ++i) hp[dx][i] = cur[dx][i];
      }
      v = make_uint2(pack_bf16x2(0.25f * mx[0], 0.25f * mx[1]),
                     pack_bf16x2(0.25f * mx[2], 0.25f * mx[3]));
    }
    *reinterpret_cast<uint2*>(as + swz(2 * m + (qd >> 1)) + 8 * (qd & 1)) = v;
  }
}

// The builders walk the CTA's chunks: for chunk c they wait until the
// consumers have released operand slot c % kSlots (chunk c - kSlots) and
// chunk c's x patch (loaded kXStages - 1 chunks ahead) is in, load the x
// patch of chunk c + kXStages - 1 into the x ring, build chunk c's operand
// and mark the slot full.
template <int kSlots, int kXStages, int kBuildWarps>
__device__ __forceinline__ void builders(unsigned char* a_s,
                                         unsigned char* x_s, const bf16* x,
                                         const Geo& g, int total) {
  constexpr int kB = 32 * kBuildWarps, kSync = kConsumers + kB;
  const uint32_t x_u = smem_u32(x_s);
  const int pt = threadIdx.x - kConsumers - 32;
  const int CPT = 2 * g.KS;
  // chunk j of task ti (decoded: t) is built; chunk jn of task tn
  // (decoded: tl) has its x patch loaded next
  int ti = blockIdx.x, j = 0, tn = blockIdx.x, jn = 0;
  Task t = task_of(ti, g), tl = t;
  auto load_next = [&](int stage) {
    load_x<kB>(x_u + stage * kXBytes, x, g, tl, jn, pt);
    if (++jn == CPT) {
      jn = 0;
      tn += gridDim.x;
      tl = task_of(tn, g);
    }
  };

  for (int c = 0; c < kXStages - 1; ++c) {
    if (c < total) load_next(c);
    cp_async_commit();
  }
#pragma unroll 1
  for (int c = 0; c < total; ++c) {
    const int slot = c % kSlots;
    if (c >= kSlots) bar_sync(kEmptyBar + slot, kSync);
    cp_async_wait<kXStages - 2>();        // chunk c's x patch
    // chunk c's x patch is in for every builder, and chunk c - 1's, read by
    // its build, is free
    bar_sync(kProdBar, kB);
    const int cx = c + kXStages - 1;
    if (cx < total) load_next(cx % kXStages);
    cp_async_commit();
    const unsigned char* xs = x_s + (c % kXStages) * kXBytes;
    if (j >= g.KS)
      build_max<kB>(xs, a_s + slot * kABytes, g, t, pt);
    else
      build_avg<kB>(xs, a_s + slot * kABytes, g, t, pt);
    bar_arrive(kFullBar + slot, kSync);
    if (++j == CPT) {
      j = 0;
      ti += gridDim.x;
      t = task_of(ti, g);
    }
  }
  cp_async_wait_all();
}

// ---- the consumer warpgroups -------------------------------------------

__device__ __forceinline__ void wgmma_tile(float (&d)[64],
                                           const uint32_t (&a)[4],
                                           uint64_t desc) {
  wgmma_m64n128k16(d, a, desc, 1);
}

__device__ __forceinline__ void wgmma_tile(float (&d)[128],
                                           const uint32_t (&a)[4],
                                           uint64_t desc) {
  wgmma_m64n256k16(d, a, desc, 1);
}

// one product: the k-step of `tap` in weight slot ws
template <int kN>
__device__ __forceinline__ void issue(float (&acc)[kN / 2],
                                      const uint32_t (&a)[4], uint32_t ws,
                                      int tap) {
  wgmma_fence();
  wgmma_tile(acc, a, make_desc(ws + tap * 32 * kN));
  wgmma_commit();
}

// rows m0 and m0 + 8 of the warp (m0 = 64 wg + 16 warp + lane / 4),
// channels 8j + 2q4, +1 of each 8-channel group j: bias and SiLU in f32
// (raw: neither), one rounding, 16-byte stores of 8 channels per lane. The
// biases are read through the read-only path, so that their loads can run
// ahead of the stores.
template <int kN, bool kRaw>
__device__ __forceinline__ void epilogue(const float (&acc)[kN / 2],
                                         bf16* y, const bf16* bias,
                                         const Geo& g, Task t, int pool,
                                         int m0, int q4) {
  bf16* dst[2];
  bool ok[2];
#pragma unroll
  for (int rh = 0; rh < 2; ++rh) {
    const int m = m0 + 8 * rh, r = m / g.TC, c = m % g.TC;
    const int oy = t.oy0 + r, ox = t.ox0 + c;
    ok[rh] = m < g.TR * g.TC && oy < g.Ho && ox < g.Wo;
    dst[rh] = y + (((size_t)t.b * g.Ho + oy) * g.Wo + ox) * g.Cout +
              pool * g.Co + t.nb * kN;
  }
  const int cmax = g.Co - t.nb * kN;      // channels of this n-block
#pragma unroll
  for (int gr = 0; gr < kN / 32; ++gr) {
    float bl[4][2];
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int ch = 32 * gr + 8 * jj + 2 * q4;
      bl[jj][0] = bl[jj][1] = 0.0f;
      if (!kRaw && ch < cmax) {
        const float2 f = __bfloat1622float2(__ldg(
            reinterpret_cast<const __nv_bfloat162*>(bias + t.nb * kN + ch)));
        bl[jj][0] = f.x;
        bl[jj][1] = f.y;
      }
    }
#pragma unroll
    for (int rh = 0; rh < 2; ++rh) {
      uint32_t v[4], o[4];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int i = 4 * (4 * gr + jj) + 2 * rh;
        float f0 = acc[i], f1 = acc[i + 1];
        if (!kRaw) {
          f0 = silu_mufu(f0 + bl[jj][0]);
          f1 = silu_mufu(f1 + bl[jj][1]);
        }
        v[jj] = pack_bf16x2(f0, f1);
      }
      quad_transpose(v, o, q4);
      const int ch = 32 * gr + 8 * q4;
      if (ok[rh] && ch < cmax)
        *reinterpret_cast<uint4*>(dst[rh] + ch) =
            make_uint4(o[0], o[1], o[2], o[3]);
    }
  }
}

template <int kN>
__device__ __forceinline__ void zero(float (&acc)[kN / 2]) {
#pragma unroll
  for (int i = 0; i < kN / 2; ++i) acc[i] = 0.0f;
}

// after wgmma_wait: the compiler may not move reads of the accumulators
// above the wait, which does not name them
template <int kN>
__device__ __forceinline__ void fence_acc(float (&acc)[kN / 2]) {
#pragma unroll
  for (int i = 0; i < kN / 2; ++i) asm volatile("" : "+f"(acc[i])::"memory");
}

// The consumers walk the same chunks: wait until operand and weight slot
// c % kSlots are full and run the products, both warpgroups over their
// own 64 rows of the tile with the same weights. Branch 1 is 9 taps of one
// k-step: this lane's A row is avg patch pixel p0 shifted by the tap
// (ky * APC + kx), channels 8h on; branch 2 one k-step, A row tile pixel
// m. Each product waits for the one before it, and the A registers of the
// next tap load while it runs: tap 0 into a[2], taps 1-8 into a[0], a[1]
// in turn. Once a chunk's tap 0 is issued and every earlier product is
// done, the previous chunk's slot is released, so the products of
// consecutive chunks follow each other without a drain; after the last
// chunk of a branch, the outputs are written from the accumulators.
template <int kN, int kSlots, int kBuildWarps, bool kRaw>
__device__ __forceinline__ void consumer(unsigned char* smem, uint32_t full,
                                         uint32_t empty, const bf16* b1,
                                         const bf16* b2, bf16* y,
                                         const Geo& g, int total) {
  constexpr int kW = w_bytes<kN>(), kSync = kConsumers + 32 * kBuildWarps;
  const uint32_t w_u = smem_u32(smem), a_u = w_u + kSlots * kW;
  const int tid = threadIdx.x, lane = tid % 32;
  const int row0 = 64 * (tid / 128) + 16 * ((tid / 32) % 4);
  const int CPT = 2 * g.KS;
  // this lane's ldmatrix row: tile pixel m, channels 8h on; the avg patch
  // pixel of its tap (0, 0) (a padding row reads pixel 0)
  const int m = row0 + lane % 16, h = lane / 16;
  const int p0 = m < g.TR * g.TC
                     ? 2 * (m / g.TC) * g.APC + 2 * (m % g.TC) : 0;
  auto release = [&](int c) {
    if (lane == 0) mbar_arrive(empty + 8 * (c % kSlots));
    if (c + kSlots < total) bar_arrive(kEmptyBar + c % kSlots, kSync);
  };

  float acc[kN / 2];
  uint32_t a[3][4];
  zero<kN>(acc);
  int held = -1;                          // chunk whose slot is not released
  int ti = blockIdx.x, j = 0;             // chunk j of task ti
#pragma unroll 1
  for (int c = 0; c < total; ++c, ++j) {
    const int slot = c % kSlots;
    const bool pool = j >= g.KS;
    bar_sync(kFullBar + slot, kSync);
    mbar_wait(full + 8 * slot, (c / kSlots) & 1);
    const uint32_t as = a_u + slot * kABytes, ws = w_u + slot * kW;
    ldmatrix_x4(as + swz(pool ? 2 * m + h : 2 * p0 + h), a[2]);
    issue<kN>(acc, a[2], ws, 0);
    wgmma_wait<1>();
    if (held >= 0) release(held);
    if (!pool) {
#pragma unroll
      for (int tap = 1; tap < 9; ++tap) {
        ldmatrix_x4(as + swz(2 * (p0 + (tap / 3) * g.APC + tap % 3) + h),
                    a[(tap - 1) & 1]);
        issue<kN>(acc, a[(tap - 1) & 1], ws, tap);
        wgmma_wait<1>();
      }
    }
    held = c;
    if (j == g.KS - 1 || j == CPT - 1) {
      wgmma_wait<0>();
      release(c);
      held = -1;
      fence_acc<kN>(acc);
      epilogue<kN, kRaw>(acc, y, pool ? b2 : b1, g, task_of(ti, g), pool,
                         row0 + lane / 4, lane % 4);
      zero<kN>(acc);
      if (pool) {
        j = -1;
        ti += gridDim.x;
      }
    }
  }
}

// Each CTA walks tasks blockIdx.x, + gridDim.x, ...; a task is 2 KS chunks
// of 16 input channels (branch 1, then branch 2), and the chunk counter
// runs on across tasks, so the rings never drain.
template <int kN, int kSlots, int kXStages, int kBuildWarps, bool kRaw>
__global__ void __launch_bounds__(threads<kBuildWarps>(), 1)
adown_wgmma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w1p,
                   const bf16* __restrict__ b1, const bf16* __restrict__ w2p,
                   const bf16* __restrict__ b2, bf16* __restrict__ y,
                   const Geo g) {
  static_assert(kSlots <= kMaxSlots, "named barriers per slot");
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int kW = w_bytes<kN>();
  unsigned char* a_s = smem + kSlots * kW;
  unsigned char* x_s = a_s + kSlots * kABytes;
  // weight slot s: full (the bulk copies landed) and empty (the consumers'
  // products on it are done: one arrival per consumer warp) mbarriers
  const uint32_t full = smem_u32(smem + bar_offset<kN, kSlots, kXStages>());
  const uint32_t empty = full + 8 * kSlots;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kSlots; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int total =
      ((g.n_tasks - 1 - (int)blockIdx.x) / (int)gridDim.x + 1) * 2 * g.KS;
  if (threadIdx.x >= kConsumers + 32)
    builders<kSlots, kXStages, kBuildWarps>(a_s, x_s, x, g, total);
  else if (threadIdx.x == kConsumers)
    load_weights<kN, kSlots>(smem_u32(smem), full, empty, w1p, w2p, g, total);
  else if (threadIdx.x < kConsumers)
    consumer<kN, kSlots, kBuildWarps, kRaw>(smem, full, empty, b1, b2, y, g,
                                            total);
}

// The geometry of a call; the tile fields are set by plan()
Geo geometry(int B, int H, int W, int Cin, int Cout) {
  Geo g{};
  g.B = B;
  g.H = H;
  g.W = W;
  g.Cin = Cin;
  g.Cout = Cout;
  g.Ch = Cin / 2;
  g.Co = Cout / 2;
  g.Ho = H / 2;
  g.Wo = W / 2;
  g.KS = ceil_div(g.Ch, 16);
  g.Np = packed_n(g.Co);
  return g;
}

// Tasks of one tile and one n-block of kN output channels, the n-blocks
// of a tile neighbours: takes the tile shape of `tiles` that needs the
// fewest rounds of `ctas` resident CTAs, then the fewest tasks
template <int kNT>
cudaError_t plan(Geo& g, int kN, int ctas, const TileShape (&tiles)[kNT]) {
  if (ctas < 1) return cudaErrorInvalidConfiguration;
  g.nblocks = ceil_div(g.Co, kN);
  long best_rounds = -1, best_tasks = 0;
  for (const TileShape& s : tiles) {
    const long tasks = (long)g.B * ceil_div(g.Ho, s.rows) *
                       ceil_div(g.Wo, s.cols) * g.nblocks;
    const long rounds = (tasks + ctas - 1) / ctas;
    if (best_rounds < 0 || rounds < best_rounds ||
        (rounds == best_rounds && tasks < best_tasks)) {
      best_rounds = rounds;
      best_tasks = tasks;
      g.TR = s.rows;
      g.TC = s.cols;
    }
  }
  if (best_tasks > 0x7fffffffL) return cudaErrorInvalidValue;
  g.tiles_h = ceil_div(g.Ho, g.TR);
  g.tiles_w = ceil_div(g.Wo, g.TC);
  g.n_tasks = (int)best_tasks;
  g.XPC = 2 * g.TC + 2;
  g.APC = 2 * g.TC + 1;
  g.inv_xpc = 1.0f / g.XPC;
  g.inv_apc = 1.0f / g.APC;
  g.inv_tc = 1.0f / g.TC;
  return cudaSuccess;
}

template <int kN, int kSlots, int kXStages, int kBuildWarps, bool kRaw>
cudaError_t launch_n(const void* x, const void* w1p, const void* b1,
                     const void* w2p, const void* b2, void* y, Geo g,
                     cudaStream_t stream) {
  static PerDeviceSmem smem;
  constexpr int bytes = smem_bytes<kN, kSlots, kXStages>();
  constexpr int kThreads = threads<kBuildWarps>();
  auto kernel = adown_wgmma_kernel<kN, kSlots, kXStages, kBuildWarps, kRaw>;
  cudaError_t e = smem.opt_in((const void*)kernel, bytes);
  if (e != cudaSuccess) return e;
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                    kThreads, bytes);
  if (e != cudaSuccess) return e;
  const int ctas = per_sm * sm_count();
  e = plan(g, kN, ctas, kTiles);
  if (e != cudaSuccess) return e;
  const int grid = g.n_tasks < ctas ? g.n_tasks : ctas;
  kernel<<<grid, kThreads, bytes, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w1p),
      static_cast<const bf16*>(b1), static_cast<const bf16*>(w2p),
      static_cast<const bf16*>(b2), static_cast<bf16*>(y), g);
  return cudaGetLastError();
}

cudaError_t launch(const void* x, const void* w1p, const void* b1,
                   const void* w2p, const void* b2, void* y, int B, int H,
                   int W, int Cin, int Cout, int raw, cudaStream_t stream) {
  const Geo g = geometry(B, H, W, Cin, Cout);
  // (N, slots, x stages, builder warps): see threads() and smem_bytes()
  if (g.Co <= 128)
    return raw ? launch_n<128, 3, 3, 7, true>(x, w1p, b1, w2p, b2, y, g,
                                              stream)
               : launch_n<128, 3, 3, 7, false>(x, w1p, b1, w2p, b2, y, g,
                                               stream);
  return raw ? launch_n<256, 2, 2, 3, true>(x, w1p, b1, w2p, b2, y, g, stream)
             : launch_n<256, 2, 2, 3, false>(x, w1p, b1, w2p, b2, y, g,
                                             stream);
}

}  // namespace tc

// ---------------------------------------------------------------------------
// f32 tensor-core variant (3xTF32 on wgmma; any even Cin, Cout)
// ---------------------------------------------------------------------------

// A persistent, warp-specialized kernel. A task is one of tc's (tc::plan:
// an output tile of up to 128 pixels, one n-block of 128 output
// channels), both branches: branch 1's chunks of 8 input channels (one
// TF32 k-step), then branch 2's. The n-blocks of a tile are neighbours in
// the grid, so the second reads its x from L2. Each CTA walks tasks
// blockIdx.x, + gridDim.x, ..., and the chunk counter runs on across its
// tasks.
// - Warpgroups 0 and 1 (the consumers) take the task's pixels 0-63 and
//   64-127 by all 128 channels: per chunk, 9 taps (A at the tap's shift
//   in the avg patch) or one, each three m64n128k8 TF32 wgmma (lo_a hi_b,
//   hi_a lo_b, hi_a hi_b) with A split into hi and lo in registers as it
//   loads. A segment (the products summed apart, in an accumulator that
//   its first product overwrites) is two chunks of a branch, or its last
//   one; it is then added into the output accumulators by FADD. The next
//   tap's A loads while a tap's products run. After a branch's last chunk
//   its outputs leave from the accumulators: bias and accurate SiLU (raw:
//   neither), a quad transpose, and 32-byte stores of a lane's 8
//   consecutive channels.
// - Warps 8-11 (the producers) prepare each chunk in one of two slots
//   while the consumers run the chunk before: they copy its weights by
//   cp.async into the wgmma B layout, load its x patch (the tile's
//   (2R+2) x (2C+2) pixels, zero outside the image and past Ch; the next
//   chunk's is loaded while this one's weights land), build its A operand
//   from the x patch (branch 1 the (2R+1) x (2C+1) avg patch, 0 outside
//   the avg domain; branch 2 the 3 x 3 max of the avg at each tile pixel,
//   0 for a pixel outside the output), and write the weights' lo half.
// Named barriers hand the slots over (FULL: prepared, EMPTY: the
// consumers' products on it are done).
// Why so (H100; scratch builds timed one stage at a time, clock64() per
// phase and microbenchmarks, none kept): mma.sync m16n8k8 TF32 tops out
// well below TF32 wgmma, and loops of it stalled well below that; wgmma in
// this kernel's issue pattern alone runs near the data sheet's TF32 rate.
// A block of 9 to 12 warps gets at most 168 registers a thread, which two
// 64-float accumulators and the A fragments fill: more producer warps, or
// the consumers doing more than their products, spilled, and spilled wgmma
// registers serialize wgmma. 8 warps alone (no producers) left the loads
// and builds exposed. Splitting the weights (every task re-splits them)
// was the largest share of the consumers' time until it moved to the
// producers as a cut (one write).
namespace f32 {

using namespace sm90;
using tc::Geo;
using tc::Task;
using tc::div_small;
using tc::bar_sync;
using tc::bar_arrive;

constexpr int kConsumers = 256;   // 2 warpgroups of 64 pixels
constexpr int kProducers = 128;   // 4 warps
constexpr int kThreads = kConsumers + kProducers;
constexpr int kM = tc::kM;        // tile pixels (128)
constexpr int kN = 128;           // output channels of an n-block
constexpr int kCK = 8;            // input channels of a chunk (one k-step)
// named barriers (0 is __syncthreads): FULL and EMPTY per slot, and the
// producers' own
constexpr int kFullBar = 1, kEmptyBar = 3, kProdBar = 5;

// a slot's weights: hi, then lo, each 9 taps of [co / 8][ci / 4][co % 8]
// [ci % 4] (the B layout of hopper.cuh: core matrices of 8 output channels
// by 4 input channels, the next along K 128 bytes on, along N 256)
constexpr int kTapBytes = kN * kCK * 4;                   // 4,096
constexpr int kLoOffset = 9 * kTapBytes;                  // 36,864
constexpr int kBBytes = 2 * kLoOffset;                    // 73,728
// a slot's A operand: avg patch pixel p (branch 2: tile pixel m) as its 8
// channels in the order 0, 4, 1, 5, 2, 6, 3, 7, so that a lane's two
// columns t and t + 4 are one 8-byte load; avg pixels 12 floats apart
// (two rows at the conv's stride of 2 pixels then meet different banks),
// max tile rows 8
constexpr int kAStride = 12, kMStride = 8;
constexpr int kABytes = tc::kAPix * kAStride * 4;         // 26,928
constexpr int kXBytes = tc::kXPix * kCK * 4;              // 19,584
// 220,896 bytes; a block may have 232,448
constexpr int kSmemBytes = 2 * kBBytes + 2 * kABytes + kXBytes;
static_assert(kM * kMStride * 4 <= kABytes, "the max tile fits");

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

__device__ __forceinline__ float4 max4(float4 a, float4 b) {
  return make_float4(fmaxf(a.x, b.x), fmaxf(a.y, b.y), fmaxf(a.z, b.z),
                     fmaxf(a.w, b.w));
}

// channels 0-3 (lo4) and 4-7 (hi4) of one pixel, in the operand's order
__device__ __forceinline__ void store_pixel(float* dst, float4 lo4,
                                            float4 hi4) {
  *reinterpret_cast<float4*>(dst) = make_float4(lo4.x, hi4.x, lo4.y, hi4.y);
  *reinterpret_cast<float4*>(dst + 4) =
      make_float4(lo4.z, hi4.z, lo4.w, hi4.w);
}

// A position in a role's walk: chunk j (of 2 KC) of task ti, decoded as t
struct Cursor {
  int ti, j;
  Task t;
  __device__ __forceinline__ void next(const Geo& g, int per_task) {
    if (++j == per_task) {
      j = 0;
      ti += gridDim.x;
      t = tc::task_of(ti, g);
    }
  }
};

// A producer's 16-byte copies of a task's x patches (E = 4): copy
// e = pt + kProducers i is x patch pixel e / 2, channels 4 (e % 2) on;
// its offset in the image (floats, before the chunk's channels), or -1
// where the pixel is outside the image or the copy is past the patch
constexpr int kXCopies = (tc::kXPix * 2 + kProducers - 1) / kProducers;
struct XCopies {
  int off[kXCopies];
  __device__ void set(const Geo& g, Task t, int pt) {
    const int n = (2 * g.TR + 2) * g.XPC * 2;
    const int y0 = 2 * t.oy0 - 1, x0 = 2 * t.ox0 - 1;
#pragma unroll
    for (int i = 0; i < kXCopies; ++i) {
      const int e = pt + i * kProducers, q = e >> 1;
      const int qr = div_small(q, g.inv_xpc);
      const int iy = y0 + qr, ix = x0 + q - qr * g.XPC;
      off[i] = e < n && iy >= 0 && iy < g.H && ix >= 0 && ix < g.W
                   ? (iy * g.W + ix) * g.Cin + 4 * (e & 1)
                   : -1;
    }
  }
};

// chunk k's x patch (E = 4, from the task's copies): branch 1's chunk
// k.j or, for k.j >= KC, branch 2's chunk k.j - KC (input channels
// 8 (k.j - KC) on of the second half of x); zero past Ch (Ch % 4 == 0)
__device__ __forceinline__ void load_x4(uint32_t xs, const float* x,
                                        const Geo& g, const Cursor& k,
                                        int KC, const XCopies& xc, int pt) {
  const bool pool = k.j >= KC;
  const int ck = pool ? k.j - KC : k.j;
  const int n = (2 * g.TR + 2) * g.XPC * 2;
  const float* xb = x + (size_t)k.t.b * g.H * g.W * g.Cin +
                    (pool ? g.Ch : 0) + kCK * ck;
#pragma unroll
  for (int i = 0; i < kXCopies; ++i) {
    const int e = pt + i * kProducers;
    if (e >= n) break;
    const bool ok = xc.off[i] >= 0 && kCK * ck + 4 * (e & 1) < g.Ch;
    cp_async16(xs + 16 * e, ok ? xb + xc.off[i] : x, ok);
  }
}

// the same by 4-byte copies (E = 1: any even Cin), copy e is x patch
// pixel e / 8, channel e % 8
__device__ __forceinline__ void load_x1(uint32_t xs, const float* x,
                                        const Geo& g, const Cursor& k,
                                        int KC, int pt) {
  const bool pool = k.j >= KC;
  const int ck = pool ? k.j - KC : k.j;
  const int n = (2 * g.TR + 2) * g.XPC * kCK;
  const int y0 = 2 * k.t.oy0 - 1, x0 = 2 * k.t.ox0 - 1;
  const float* xb = x + (size_t)k.t.b * g.H * g.W * g.Cin +
                    (pool ? g.Ch : 0) + kCK * ck;
  for (int e = pt; e < n; e += kProducers) {
    const int q = e / kCK, u = e % kCK;
    const int qr = div_small(q, g.inv_xpc);
    const int iy = y0 + qr, ix = x0 + q - qr * g.XPC;
    const bool ok = iy >= 0 && iy < g.H && ix >= 0 && ix < g.W &&
                    kCK * ck + u < g.Ch;
    cp_async4(xs + 4 * e, ok ? xb + ((size_t)iy * g.W + ix) * g.Cin + u : x,
              ok);
  }
}

// A producer's two 16-byte units of every tap's weights: unit v (pt and
// pt + 128) is output channel co = v / 2, input channels 4 h on
// (h = v % 2), which the packed image's block (tap, k-step) keeps
// contiguous (8 input channels of one half of the k-step per output
// channel); offsets in the slot (bytes) and in the block (floats)
struct WUnits {
  int dst[2], src[2];
  __device__ explicit WUnits(int pt) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int v = pt + i * kProducers, co = v >> 1, h = v & 1;
      dst[i] = (co / 8) * 256 + h * 128 + (co % 8) * 16;
      src[i] = (co / 8) * 128 + (co % 8) * 8 + 4 * h;
    }
  }
};
static_assert(2 * kN == 2 * kProducers, "two weight units a producer a tap");

// chunk k's weights into the slot's hi half
__device__ __forceinline__ void load_w(uint32_t bs, const float* w1p,
                                       const float* w2p, const Geo& g,
                                       const Cursor& k, int KC,
                                       const WUnits& wu) {
  const bool pool = k.j >= KC;
  const int ck = pool ? k.j - KC : k.j;
  const size_t tap_stride = (size_t)g.KS * 16 * g.Np;
  const float* wb = (pool ? w2p : w1p) + (size_t)(ck / 2) * 16 * g.Np +
                    k.t.nb * 16 * kN + (ck % 2) * 64;
  for (int tap = 0; tap < (pool ? 1 : 9); ++tap)
#pragma unroll
    for (int i = 0; i < 2; ++i)
      cp_async16(bs + tap * kTapBytes + wu.dst[i],
                 wb + tap * tap_stride + wu.src[i], true);
}

// b - (b cut to TF32): exact in f32
__device__ __forceinline__ float cut_rest(float b) {
  return b - __uint_as_float(__float_as_uint(b) & 0xffffe000u);
}

// The slot's weights split for the products: the tensor cores read a TF32
// operand's top 19 bits (its low 13 are ignored), so the f32 weights serve
// as hi = b cut to TF32 as they are, and lo = b - hi is written kLoOffset
// on (the tensor cores cut it in turn). Cutting instead of rounding
// (split_tf32, as A is split) leaves lo below 2^-10 |b|, and the products
// within about 2^-20 of f32 ones: one write instead of two for the split.
__device__ __forceinline__ void split_w(unsigned char* bs, int taps, int pt) {
  for (int u = pt; u < taps * 2 * kN; u += kProducers) {
    const float4 v = *reinterpret_cast<const float4*>(bs + 16 * u);
    *reinterpret_cast<float4*>(bs + kLoOffset + 16 * u) = make_float4(
        cut_rest(v.x), cut_rest(v.y), cut_rest(v.z), cut_rest(v.w));
  }
}

// branch 1's A operand: avg patch pixel (ar, ac) reads x patch pixels
// (ar, ac) .. (ar + 1, ac + 1), 0.25 * ((x00 + x01) + (x10 + x11)) in f32;
// 0 outside the avg domain. An item is two avg pixels, rows ar = 2i and
// ar + 1 of one column, which share x row ar + 1's pair sums.
__device__ __forceinline__ void build_avg(const float* xs, float* as,
                                          const Geo& g, Task t, int pt) {
  const int rows = 2 * g.TR + 1, n = (g.TR + 1) * g.APC;
  const int xrow = g.XPC * kCK;
  for (int it = pt; it < n; it += kProducers) {
    const int pr = div_small(it, g.inv_apc), ac = it - pr * g.APC;
    const int ar = 2 * pr;
    const int ay = 2 * t.oy0 - 1 + ar, ax = 2 * t.ox0 - 1 + ac;
    const bool col = ax >= 0 && ax <= g.W - 2;
    const bool in0 = col && ay >= 0 && ay <= g.H - 2;
    const bool in1 = col && ay + 1 >= 0 && ay + 1 <= g.H - 2 &&
                     ar + 1 < rows;
    const float* q = xs + (ar * g.XPC + ac) * kCK;
    float4 v0[2], v1[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      float4 s0 = zero, s1 = zero, s2 = zero;
      if (in0 || in1) {
        s1 = add4(ld4(q + xrow + 4 * h), ld4(q + xrow + kCK + 4 * h));
        if (in0) s0 = add4(ld4(q + 4 * h), ld4(q + kCK + 4 * h));
        if (in1)
          s2 = add4(ld4(q + 2 * xrow + 4 * h), ld4(q + 2 * xrow + kCK + 4 * h));
      }
      const float4 a0 = add4(s0, s1), a1 = add4(s1, s2);
      v0[h] = in0 ? make_float4(0.25f * a0.x, 0.25f * a0.y, 0.25f * a0.z,
                                0.25f * a0.w)
                  : zero;
      v1[h] = in1 ? make_float4(0.25f * a1.x, 0.25f * a1.y, 0.25f * a1.z,
                                0.25f * a1.w)
                  : zero;
    }
    store_pixel(as + (ar * g.APC + ac) * kAStride, v0[0], v0[1]);
    if (ar + 1 < rows)
      store_pixel(as + ((ar + 1) * g.APC + ac) * kAStride, v1[0], v1[1]);
  }
}

// branch 2's A operand: row m is maxpool(3, 2, 1) of the avg at tile
// pixel m (-inf outside the avg domain), 0 for a pixel outside the
// output. The window's 4 x 4 x pixels are read a row at a time: the pair
// sums of x rows k - 1 and k give avg row k - 1's window sums, in branch
// 1's order; 0.25 x their max (exact) is the max of the avgs.
__device__ __forceinline__ void build_max(const float* xs, float* as,
                                          const Geo& g, Task t, int pt) {
  for (int m = pt; m < kM; m += kProducers) {
    const int r = div_small(m, g.inv_tc), c = m - r * g.TC;
    float4 v[2] = {make_float4(0.0f, 0.0f, 0.0f, 0.0f),
                   make_float4(0.0f, 0.0f, 0.0f, 0.0f)};
    if (m < g.TR * g.TC && t.oy0 + r < g.Ho && t.ox0 + c < g.Wo) {
      const int ay0 = 2 * (t.oy0 + r) - 1, ax0 = 2 * (t.ox0 + c) - 1;
      const float inf = CUDART_INF_F;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float4 mx = make_float4(-inf, -inf, -inf, -inf), hp[3];
        const float* q = xs + ((2 * r) * g.XPC + 2 * c) * kCK + 4 * h;
#pragma unroll
        for (int k = 0; k < 4; ++k, q += g.XPC * kCK) {
          float4 f[4], cur[3];
#pragma unroll
          for (int px = 0; px < 4; ++px) f[px] = ld4(q + px * kCK);
#pragma unroll
          for (int dx = 0; dx < 3; ++dx) cur[dx] = add4(f[dx], f[dx + 1]);
          const int ay = ay0 + k - 1;     // avg row of x rows k - 1, k
          if (k > 0 && ay >= 0 && ay <= g.H - 2) {
#pragma unroll
            for (int dx = 0; dx < 3; ++dx) {
              const int ax = ax0 + dx;
              if (ax >= 0 && ax <= g.W - 2)
                mx = max4(mx, add4(hp[dx], cur[dx]));
            }
          }
#pragma unroll
          for (int dx = 0; dx < 3; ++dx) hp[dx] = cur[dx];
        }
        v[h] = make_float4(0.25f * mx.x, 0.25f * mx.y, 0.25f * mx.z,
                           0.25f * mx.w);
      }
    }
    store_pixel(as + m * kMStride, v[0], v[1]);
  }
}

// The producers walk the CTA's chunks. For chunk c, in slot c % 2: once
// the consumers are done with chunk c - 2 (from c = 2 on), its weights'
// copies start; the x patch (loaded during chunk c - 1) becomes its A
// operand; the next chunk's x patch starts; the weights, once in, get
// their lo half (split_w) and are fenced for wgmma's async proxy; then the
// slot is marked full. The commit groups go X_0, then
// W_c, X_{c+1} per chunk, so waiting for all but the newest group gives
// X_c after W_c's commit and W_c after X_{c+1}'s.
template <int E>
__device__ __forceinline__ void producers(unsigned char* smem, const float* x,
                                          const float* w1p, const float* w2p,
                                          const Geo& g, int KC, int total) {
  constexpr int kSync = kConsumers + kProducers;
  unsigned char* const x_s = smem + 2 * kBBytes + 2 * kABytes;
  const int pt = threadIdx.x - kConsumers, per_task = 2 * KC;
  Cursor k{(int)blockIdx.x, 0, tc::task_of(blockIdx.x, g)}, kx = k;
  const WUnits wu(pt);
  XCopies xc;
  // the x patch of chunk kx (E = 4: from the task's copies)
  auto copy_x = [&]() {
    if constexpr (E == 4) {
      if (kx.j == 0) xc.set(g, kx.t, pt);
      load_x4(smem_u32(x_s), x, g, kx, KC, xc, pt);
    } else {
      load_x1(smem_u32(x_s), x, g, kx, KC, pt);
    }
  };
  copy_x();
  kx.next(g, per_task);
  cp_async_commit();
#pragma unroll 1
  for (int c = 0; c < total; ++c) {
    const int slot = c & 1;
    unsigned char* const bs = smem + slot * kBBytes;
    float* const as = reinterpret_cast<float*>(smem + 2 * kBBytes +
                                               slot * kABytes);
    const bool pool = k.j >= KC;
    if (c >= 2) bar_sync(kEmptyBar + slot, kSync);
    load_w(smem_u32(bs), w1p, w2p, g, k, KC, wu);
    cp_async_commit();
    cp_async_wait<1>();                   // X_c
    bar_sync(kProdBar, kProducers);
    if (pool)
      build_max(reinterpret_cast<const float*>(x_s), as, g, k.t, pt);
    else
      build_avg(reinterpret_cast<const float*>(x_s), as, g, k.t, pt);
    bar_sync(kProdBar, kProducers);       // the x patch is free
    if (c + 1 < total) copy_x();
    kx.next(g, per_task);
    cp_async_commit();
    cp_async_wait<1>();                   // W_c
    bar_sync(kProdBar, kProducers);
    split_w(bs, pool ? 1 : 9, pt);
    // the weights (hi), written through the generic proxy, are read by
    // wgmma through the async proxy
    fence_proxy_async();
    bar_arrive(kFullBar + slot, kSync);
    k.next(g, per_task);
  }
  cp_async_wait_all();
}

// the outputs of a branch from the accumulators: a lane holds rows
// r0 = 64 wg + 16 warp + lane / 4 and r0 + 8, channels 8j + 2q, + 1 of
// each group j of 8 (acc[4j + 2 rh], + 1 for row half rh); a quad
// transpose of groups 4gr .. 4gr + 3 gives lane q channels 32gr + 8q ..
// + 7
template <int E, bool kRaw>
__device__ __forceinline__ void epilogue(const float (&acc)[64], float* y,
                                         const float* bias, const Geo& g,
                                         Task t, int pool, int r0, int q) {
  const int c0 = t.nb * kN;               // the n-block's first channel
  const int cmax = g.Co - c0;             // its channels in the branch
  float* dst[2];
  bool ok[2];
#pragma unroll
  for (int rh = 0; rh < 2; ++rh) {
    const int m = r0 + 8 * rh;
    const int tr = div_small(m, g.inv_tc), tcol = m - tr * g.TC;
    const int oy = t.oy0 + tr, ox = t.ox0 + tcol;
    ok[rh] = m < g.TR * g.TC && oy < g.Ho && ox < g.Wo;
    dst[rh] = y + (((size_t)t.b * g.Ho + oy) * g.Wo + ox) * g.Cout +
              pool * g.Co + c0;
  }
#pragma unroll
  for (int gr = 0; gr < 4; ++gr) {
    float bl[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int ch = E == 4 ? 32 * gr + 8 * q + i
                            : 32 * gr + 8 * (i / 2) + 2 * q + i % 2;
      bl[i] = !kRaw && ch < cmax ? __ldg(bias + c0 + ch) : 0.0f;
    }
#pragma unroll
    for (int rh = 0; rh < 2; ++rh) {
      float f[8];
      if constexpr (E == 4) {
        uint32_t ex[4], ey[4], ox4[4], oy4[4];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          ex[jj] = __float_as_uint(acc[4 * (4 * gr + jj) + 2 * rh]);
          ey[jj] = __float_as_uint(acc[4 * (4 * gr + jj) + 2 * rh + 1]);
        }
        quad_transpose(ex, ox4, q);
        quad_transpose(ey, oy4, q);
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          f[2 * jj] = __uint_as_float(ox4[jj]);
          f[2 * jj + 1] = __uint_as_float(oy4[jj]);
        }
      } else {
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          f[2 * jj] = acc[4 * (4 * gr + jj) + 2 * rh];
          f[2 * jj + 1] = acc[4 * (4 * gr + jj) + 2 * rh + 1];
        }
      }
      if (!kRaw) {
#pragma unroll
        for (int i = 0; i < 8; ++i) f[i] = silu(f[i] + bl[i]);
      }
      if (!ok[rh]) continue;
      if constexpr (E == 4) {
        // Co % 4 == 0: a lane's two 16-byte halves are in or out whole
        const int ch = 32 * gr + 8 * q;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
          if (ch + 4 * hh < cmax)
            *reinterpret_cast<float4*>(dst[rh] + ch + 4 * hh) =
                make_float4(f[4 * hh], f[4 * hh + 1], f[4 * hh + 2],
                            f[4 * hh + 3]);
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int ch = 32 * gr + 8 * (i / 2) + 2 * q + i % 2;
          if (ch < cmax) dst[rh][ch] = f[i];
        }
      }
    }
  }
}

// A of one tap: rows r0, r0 + 8 at pixels p0 and p1 of the operand,
// columns q and q + 4 (channels q and q + 4: one 8-byte load a row),
// split into hi and lo
__device__ __forceinline__ void load_a(uint32_t (&ah)[4], uint32_t (&al)[4],
                                       const float* as, int p0, int p1,
                                       int q) {
  const float2 v0 = *reinterpret_cast<const float2*>(as + p0 + 2 * q);
  const float2 v1 = *reinterpret_cast<const float2*>(as + p1 + 2 * q);
  split_tf32(v0.x, ah[0], al[0]);
  split_tf32(v1.x, ah[1], al[1]);
  split_tf32(v0.y, ah[2], al[2]);
  split_tf32(v1.y, ah[3], al[3]);
}

// One chunk's products: kTaps taps, tap t's A in register set (P + t) % 2
// (tap 0's loaded by the caller), B at bs + t * kTapBytes. The three
// products of a tap are one commit group; tap t + 1's A loads once tap
// t - 1's group is done. `fresh`: the chunk's first product overwrites the
// segment. `release` >= 0: the chunk before, whose slot is released (once
// total allows a later chunk on it) as soon as this chunk's first group is
// issued and its own are done.
template <int kTaps, int P>
__device__ __forceinline__ void chunk_products(
    float (&seg)[64], uint32_t (&ah)[2][4], uint32_t (&al)[2][4],
    uint32_t bs, const float* as, int p0, int p1, int apc, int q, bool fresh,
    int release, int total) {
#pragma unroll
  for (int tap = 0; tap < kTaps; ++tap) {
    const int s = (P + tap) & 1;
    const uint32_t bt = bs + tap * kTapBytes;
    wgmma_fence();
    wgmma_m64n128k8_tf32(seg, al[s], make_desc(bt), tap > 0 || !fresh);
    wgmma_m64n128k8_tf32(seg, ah[s], make_desc(bt + kLoOffset), 1);
    wgmma_m64n128k8_tf32(seg, ah[s], make_desc(bt), 1);
    wgmma_commit();
    wgmma_wait<1>();
    if (tap == 0 && release >= 0 && release + 2 < total)
      bar_arrive(kEmptyBar + (release & 1), kConsumers + kProducers);
    if (tap + 1 < kTaps) {
      const int off = ((tap + 1) / 3 * apc + (tap + 1) % 3) * kAStride;
      load_a(ah[s ^ 1], al[s ^ 1], as, p0 + off, p1 + off, q);
    }
  }
}

// The consumers walk the same chunks: wait until slot c % 2 is full and
// run the chunk's products. A segment (the products summed apart before
// FADD into the output accumulators) is two chunks of a branch, or its
// last one, so that only a segment's end waits for the tensor cores to
// drain; the products of the next chunk follow those of a chunk without a
// drain. Every chunk has an odd number of taps, so chunk c's first tap
// takes register set c % 2.
template <int E, bool kRaw>
__device__ __forceinline__ void consumers(unsigned char* smem, const float* b1,
                                          const float* b2, float* y,
                                          const Geo& g, int KC, int total) {
  constexpr int kSync = kConsumers + kProducers;
  const int tid = threadIdx.x, lane = tid % 32, q = lane % 4;
  const int r0 = 64 * (tid / 128) + 16 * ((tid / 32) % 4) + lane / 4;
  // this lane's rows' avg patch pixel at tap (0, 0), in floats (a row past
  // the tile reads pixel 0)
  int pa[2];
#pragma unroll
  for (int rh = 0; rh < 2; ++rh) {
    const int m = r0 + 8 * rh;
    const int tr = div_small(m, g.inv_tc), tcol = m - tr * g.TC;
    pa[rh] = m < g.TR * g.TC ? (2 * tr * g.APC + 2 * tcol) * kAStride : 0;
  }
  Cursor k{(int)blockIdx.x, 0, tc::task_of(blockIdx.x, g)};
  float acc[64], seg[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = seg[i] = 0.0f;
  uint32_t ah[2][4], al[2][4];
  bool held = false;                      // chunk c - 1's slot not released
#pragma unroll 1
  for (int c = 0; c < total; ++c) {
    const int slot = c & 1;
    const uint32_t bs = smem_u32(smem + slot * kBBytes);
    const float* as =
        reinterpret_cast<const float*>(smem + 2 * kBBytes + slot * kABytes);
    const bool pool = k.j >= KC;
    const int jb = pool ? k.j - KC : k.j;   // the chunk in its branch
    bar_sync(kFullBar + slot, kSync);
    wgmma_wait<1>();                      // the group that used set c % 2
    const int p0 = pool ? r0 * kMStride : pa[0];
    const int p1 = pool ? (r0 + 8) * kMStride : pa[1];
    const bool fresh = jb % 2 == 0;
    const int release = held ? c - 1 : -1;
    if (slot) {
      load_a(ah[1], al[1], as, p0, p1, q);
      if (pool)
        chunk_products<1, 1>(seg, ah, al, bs, as, p0, p1, g.APC, q, fresh,
                             release, total);
      else
        chunk_products<9, 1>(seg, ah, al, bs, as, p0, p1, g.APC, q, fresh,
                             release, total);
    } else {
      load_a(ah[0], al[0], as, p0, p1, q);
      if (pool)
        chunk_products<1, 0>(seg, ah, al, bs, as, p0, p1, g.APC, q, fresh,
                             release, total);
      else
        chunk_products<9, 0>(seg, ah, al, bs, as, p0, p1, g.APC, q, fresh,
                             release, total);
    }
    held = true;
    if (jb % 2 == 1 || jb == KC - 1) {
      wgmma_wait<0>();
      if (c + 2 < total) bar_arrive(kEmptyBar + slot, kSync);
      held = false;
      tc::fence_acc<kN>(seg);
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] += seg[i];
      if (jb == KC - 1) {
        epilogue<E, kRaw>(acc, y, pool ? b2 : b1, g, k.t, pool, r0, q);
#pragma unroll
        for (int i = 0; i < 64; ++i) acc[i] = 0.0f;
      }
    }
    k.next(g, 2 * KC);
  }
}

// E = 4: Cin and Cout multiples of 8 (16-byte copies and stores); E = 1
// any even Cin, Cout
template <int E, bool kRaw>
__global__ void __launch_bounds__(kThreads, 1)
adown_tf32_kernel(const float* __restrict__ x, const float* __restrict__ w1p,
                  const float* __restrict__ b1, const float* __restrict__ w2p,
                  const float* __restrict__ b2, float* __restrict__ y,
                  const Geo g) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int KC = ceil_div(g.Ch, kCK);
  const int total =
      ((g.n_tasks - 1 - (int)blockIdx.x) / (int)gridDim.x + 1) * 2 * KC;
  if (threadIdx.x >= kConsumers)
    producers<E>(smem, x, w1p, w2p, g, KC, total);
  else
    consumers<E, kRaw>(smem, b1, b2, y, g, KC, total);
}

template <int E, bool kRaw>
cudaError_t launch_k(const void* x, const void* w1p, const void* b1,
                     const void* w2p, const void* b2, void* y, Geo g,
                     cudaStream_t stream) {
  static PerDeviceSmem smem;
  auto kernel = adown_tf32_kernel<E, kRaw>;
  cudaError_t e = smem.opt_in((const void*)kernel, kSmemBytes);
  if (e != cudaSuccess) return e;
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                    kThreads, kSmemBytes);
  if (e != cudaSuccess) return e;
  const int ctas = per_sm * sm_count();
  e = tc::plan(g, kN, ctas, tc::kTiles);
  if (e != cudaSuccess) return e;
  kernel<<<g.n_tasks < ctas ? g.n_tasks : ctas, kThreads, kSmemBytes,
           stream>>>(static_cast<const float*>(x),
                     static_cast<const float*>(w1p),
                     static_cast<const float*>(b1),
                     static_cast<const float*>(w2p),
                     static_cast<const float*>(b2), static_cast<float*>(y), g);
  return cudaGetLastError();
}

cudaError_t launch(const void* x, const void* w1p, const void* b1,
                   const void* w2p, const void* b2, void* y, int B, int H,
                   int W, int Cin, int Cout, int raw, cudaStream_t stream) {
  const Geo g = tc::geometry(B, H, W, Cin, Cout);
  if (Cin % 8 == 0 && Cout % 8 == 0)
    return raw ? launch_k<4, true>(x, w1p, b1, w2p, b2, y, g, stream)
               : launch_k<4, false>(x, w1p, b1, w2p, b2, y, g, stream);
  return raw ? launch_k<1, true>(x, w1p, b1, w2p, b2, y, g, stream)
             : launch_k<1, false>(x, w1p, b1, w2p, b2, y, g, stream);
}

}  // namespace f32

cudaError_t launch(const void* x, const void* w1, const void* b1,
                   const void* w2, const void* b2, void* y, int B, int H,
                   int W, int Cin, int Cout, int raw, cudaStream_t stream) {
  static PerDeviceSmem smem;
  cudaError_t e = smem.opt_in((const void*)adown_kernel, (int)kSmemBytes);
  if (e != cudaSuccess) return e;
  const int Ho = H / 2, Wo = W / 2;
  const int tiles_w = ceil_div(Wo, kTile), tiles_h = ceil_div(Ho, kTile);
  const int co_tiles = ceil_div(Cout / 2, kCoT);
  dim3 grid(tiles_w * tiles_h, 2 * co_tiles, B);
  adown_kernel<<<grid, kThreads, kSmemBytes, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w1),
      static_cast<const bf16*>(b1), static_cast<const bf16*>(w2),
      static_cast<const bf16*>(b2), static_cast<bf16*>(y), H, W, Cin, Cout, Ho,
      Wo, tiles_w, co_tiles, raw);
  return cudaGetLastError();
}

cudaError_t dispatch(const void* x, const void* w1, const void* b1,
                     const void* w2, const void* b2, void* y, int B, int H,
                     int W, int Cin, int Cout, int dtype, int raw,
                     cudaStream_t s) {
  if (dtype == kBFloat16 && Cin % 16 == 0 && Cout % 16 == 0)
    return tc::launch(x, w1, b1, w2, b2, y, B, H, W, Cin, Cout, raw, s);
  if (dtype == kBFloat16)
    return launch(x, w1, b1, w2, b2, y, B, H, W, Cin, Cout, raw, s);
  return f32::launch(x, w1, b1, w2, b2, y, B, H, W, Cin, Cout, raw, s);
}

// The packed images of both branches from OIHW weights, cast to the
// activation dtype; zero past Ch and Co. One thread per packed element.
template <typename S, typename D>
__global__ void pack_kernel(const S* __restrict__ w1,
                            const S* __restrict__ w2, D* __restrict__ w1p,
                            D* __restrict__ w2p, int Co, int Ch, int KS,
                            int Np) {
  const int blk = 16 * Np, n1 = 9 * KS * blk, n = n1 + KS * blk;
  for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < n;
       e += gridDim.x * blockDim.x) {
    const bool pool = e >= n1;
    const int i = pool ? e - n1 : e;
    const int b = i / blk, r = i % blk;
    const int co = (r / 128) * 8 + (r / 8) % 8;
    const int ci = (b % KS) * 16 + ((r / 64) % 2) * 8 + r % 8;
    float v = 0.0f;
    if (co < Co && ci < Ch)
      v = to_f32(pool ? w2[co * Ch + ci] : w1[(co * Ch + ci) * 9 + b / KS]);
    (pool ? w2p : w1p)[i] = from_f32<D>(v);
  }
}

template <typename S, typename D>
cudaError_t launch_pack(const void* w1, const void* w2, void* w1p,
                        void* w2p, int Co, int Ch, cudaStream_t stream) {
  const int KS = ceil_div(Ch, 16), Np = packed_n(Co);
  const int n = 10 * KS * 16 * Np;
  int grid = ceil_div(n, 256);
  if (grid > 8 * sm_count()) grid = 8 * sm_count();
  if (grid < 1) return cudaErrorInvalidConfiguration;
  pack_kernel<S, D><<<grid, 256, 0, stream>>>(
      static_cast<const S*>(w1), static_cast<const S*>(w2),
      static_cast<D*>(w1p), static_cast<D*>(w2p), Co, Ch, KS, Np);
  return cudaGetLastError();
}

}  // namespace
}  // namespace yolo

// x (B, H, W, Cin) NHWC; w1p, w2p the packed images of the two branches
// (yolo_adown_pack; ops/kernels/adown.py: pack_weights); b1, b2 (Cout/2,);
// y (B, H/2, W/2, Cout) NHWC; all of one dtype. Cin, Cout even, H, W >= 2;
// x, w1p, w2p and y 16-byte aligned (checked by the Python wrapper).
extern "C" int yolo_adown(const void* x, const void* w1p, const void* b1,
                          const void* w2p, const void* b2, void* y, int B,
                          int H, int W, int Cin, int Cout, int dtype,
                          void* stream) {
  return yolo::dispatch(x, w1p, b1, w2p, b2, y, B, H, W, Cin, Cout, dtype, 0,
                        static_cast<cudaStream_t>(stream));
}

// The pre-BN train forward (kernel 5): both branches without bias and
// SiLU, in x's dtype rounded once from the f32 accumulator. Same layouts
// and constraints as yolo_adown.
extern "C" int yolo_adown_raw(const void* x, const void* w1p,
                              const void* w2p, void* y, int B, int H, int W,
                              int Cin, int Cout, int dtype, void* stream) {
  return yolo::dispatch(x, w1p, nullptr, w2p, nullptr, y, B, H, W, Cin, Cout,
                        dtype, 1, static_cast<cudaStream_t>(stream));
}

// w1 (Co, Ch, 3, 3), w2 (Co, Ch, 1, 1) OIHW in src_dtype -> w1p
// (9 * KS * 16 * Np,), w2p (KS * 16 * Np,) in dst_dtype, KS = ceil(Ch/16),
// Np = 128 or a multiple of 256 (packed_n).
extern "C" int yolo_adown_pack(const void* w1, const void* w2, void* w1p,
                               void* w2p, int Co, int Ch, int src_dtype,
                               int dst_dtype, void* stream) {
  using bf16 = __nv_bfloat16;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool sb = src_dtype == yolo::kBFloat16,
             db = dst_dtype == yolo::kBFloat16;
  if (sb && db)
    return yolo::launch_pack<bf16, bf16>(w1, w2, w1p, w2p, Co, Ch, s);
  if (sb) return yolo::launch_pack<bf16, float>(w1, w2, w1p, w2p, Co, Ch, s);
  if (db) return yolo::launch_pack<float, bf16>(w1, w2, w1p, w2p, Co, Ch, s);
  return yolo::launch_pack<float, float>(w1, w2, w1p, w2p, Co, Ch, s);
}
