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
// yolo_adown_pack. Both variants below read the same image.
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
// Everything else (f32, the Evaluator's default; bf16 with other channel
// counts): CUDA cores, an 8x8-pixel tile, 64 output channels of one branch
// per block, chunks of 16 input channels, a 4-pixel x 4-channel f32
// register tile per thread. Its redesign is later work.
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

// 8 contiguous elements of the packed image (one output channel's 8 input
// channels of a tap), as f32
__device__ __forceinline__ void load8(float (&v)[8], const float* p) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void load8(float (&v)[8],
                                      const __nv_bfloat16* p) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
adown_kernel(const T* __restrict__ x, const T* __restrict__ w1,
             const T* __restrict__ b1, const T* __restrict__ w2,
             const T* __restrict__ b2, T* __restrict__ y, int H, int W,
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

  const T* xb = x + (size_t)b * H * W * Cin;
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
        const T* p = xb + ((size_t)ay * W + ax) * Cin + cbase + ci0 + k;
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
    const T* wsrc = (branch == 0 ? w1 : w2) + (size_t)(ci0 / 16) * blk +
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
  const T* bias = branch == 0 ? b1 : b2;
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
          from_f32<T>(raw ? acc[i][j] : silu(acc[i][j] + bj));
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

// SiLU in f32 by the fast exponential and division (two MUFU operations;
// a few f32 ulps, far below the bf16 rounding that follows)
__device__ __forceinline__ float silu_mufu(float y) {
  return __fdividef(y, 1.0f + __expf(-y));
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
  if (ctas < 1) return cudaErrorInvalidConfiguration;
  g.nblocks = g.Np / kN;
  long best_rounds = -1, best_tasks = 0;
  for (const TileShape& s : kTiles) {
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

template <typename T>
cudaError_t launch(const void* x, const void* w1, const void* b1,
                   const void* w2, const void* b2, void* y, int B, int H,
                   int W, int Cin, int Cout, int raw, cudaStream_t stream) {
  static PerDeviceSmem smem;
  cudaError_t e = smem.opt_in((const void*)adown_kernel<T>, (int)kSmemBytes);
  if (e != cudaSuccess) return e;
  const int Ho = H / 2, Wo = W / 2;
  const int tiles_w = ceil_div(Wo, kTile), tiles_h = ceil_div(Ho, kTile);
  const int co_tiles = ceil_div(Cout / 2, kCoT);
  dim3 grid(tiles_w * tiles_h, 2 * co_tiles, B);
  adown_kernel<T><<<grid, kThreads, kSmemBytes, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w1),
      static_cast<const T*>(b1), static_cast<const T*>(w2),
      static_cast<const T*>(b2), static_cast<T*>(y), H, W, Cin, Cout, Ho,
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
    return launch<__nv_bfloat16>(x, w1, b1, w2, b2, y, B, H, W, Cin, Cout,
                                 raw, s);
  return launch<float>(x, w1, b1, w2, b2, y, B, H, W, Cin, Cout, raw, s);
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
