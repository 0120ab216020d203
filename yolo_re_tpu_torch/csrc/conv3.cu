// 3x3 convolution, stride 1, padding 1, plus bias and SiLU, 64 -> 64
// channels (inference, BN folded):
//
//   y = SiLU(conv3x3_s1_p1(x; w) + b)        x, y (B, H, W, 64) NHWC
//
// Replaces the TPU kernel yolo_re_tpu/ops/pallas/conv3_kernel.py
// (conv3_silu), written for stage1's inner 64-channel convs at 1/4 of the
// input resolution. Its width-packed [even | odd] lane layout and the
// wm/wz block matrices exist only to fill the TPU's 128 lanes and are not
// ported: input and output here are plain NHWC (channels_last), any H, W.
//
// What bounds it on an H100: at gelan-c's stage1, (32, 160, 160, 64) bf16,
// it reads 104.9 MB and writes 104.9 MB (0.063 ms at 3.35 TB/s) and does
// 60.4 GFLOP (0.061 ms at 989 TFLOP/s): bytes and products bound it about
// evenly. The conv, the bias and the SiLU are one pass, so the output is
// written once (cuDNN's convolution writes it, then a bias pass and a SiLU
// pass read and write it again).
//
// Design:
// - bf16: a persistent grid, one CTA of four warpgroups per SM, walking
//   16 x 16-pixel output tiles in (image, row, column) order, so that the
//   CTAs in flight cover neighbouring tiles and the halos are still in L2.
//   The CTA loads the 576 x 64 weights once, already packed by the wrapper
//   in the wgmma B layout (hopper.cuh), and keeps them resident (73.7 KB).
//   Input tiles with their 1-pixel halo (18 x 18 x 64) are staged through
//   a 2-stage ring by cp.async, whose zero fill is the conv's padding; the
//   loads of tile i + 1 run while tile i computes. A pixel is 128 bytes,
//   its 16-byte chunks XOR-swizzled by the pixel index so that ldmatrix
//   reads 8 neighbouring pixels from 8 different bank groups. Products:
//   wgmma m64n64k16, A from registers (ldmatrix at the tap's pixel shift),
//   B from the resident weights by descriptor; each warpgroup owns 4 rows
//   of 16 pixels (one m64 accumulator), 9 taps x 4 k-steps, the A
//   registers of tap t + 1 loaded while tap t's products run. (Two
//   warpgroups of two m64 blocks each read slower on the card.) Epilogue from the
//   accumulator registers: bias and SiLU in f32, one rounding, bf16 pairs
//   exchanged within each quad of lanes so that every lane stores 16
//   contiguous bytes.
// - f32: the same 60.4 GFLOP and twice the bytes (0.125 ms); on the CUDA
//   cores (67 TFLOP/s) the products alone take 0.90 ms, so they go to the
//   tensor cores in 3xTF32 (hopper.cuh: three TF32 products per f32
//   product, 0.366 ms at 495 TFLOP/s) by mma.sync m16n8k8, on the f32
//   bottleneck chain's skeleton (csp_chain.cu). Shared memory sets the
//   shape: all 64 output channels' weights stay resident (147,456 B, staged
//   once from the packed image into [tap][16 channels][co][16 channels]),
//   which leaves room for 18 rows of an 18-pixel-wide frame (82,944 B) and
//   not for two 18 x 18 frames. So a tile is 16 columns x 8 rows, and the
//   18 rows are a ring: image row iy in slot iy mod 18. A persistent grid
//   of one 8-warp CTA per SM takes a contiguous range of tiles in (image,
//   column strip, row block) order; while a tile computes, the next tile
//   of its strip gets its 8 new rows by cp.async (zero fill outside the
//   image) into the slots the tile before freed, and only a new strip
//   waits for a whole frame. A pixel is 256 bytes, an odd pixel's 16-byte
//   chunks XOR-swizzled by 4 (pix_off). A warp takes two tile rows (two
//   m16 tiles) for 32 output channels (four n8 tiles); every operand is
//   split into hi and lo in registers as its fragment loads, and each
//   tap's 64-deep products are summed apart, then added by FADD. Epilogue
//   from the registers: bias and SiLU in f32, the lanes of each quad trade
//   so that each stores 8 consecutive channels in two 16-byte stores.
#include "common.cuh"
#include "hopper.cuh"

namespace yolo {
namespace {

constexpr int kC = 64;   // input and output channels

// ---------------------------------------------------------------------------
// bf16 tensor-core variant (wgmma)
// ---------------------------------------------------------------------------

namespace tc {

using bf16 = __nv_bfloat16;
using namespace sm90;

constexpr int kWG = 4;                    // warpgroups per CTA
constexpr int kThreads = 128 * kWG;
constexpr int kTW = 16;                   // tile columns: one warp's M rows
constexpr int kTH = 4 * kWG;              // tile rows: one per warp
constexpr int kFW = kTW + 2, kFH = kTH + 2;
constexpr int kFramePix = kFW * kFH;
constexpr int kPixBytes = kC * 2;         // 128
constexpr int kFrameBytes = kFramePix * kPixBytes;
constexpr int kKSteps = kC / 16;          // 4
constexpr int kBlockBytes = 16 * kC * 2;  // one (tap, k-step) B block
constexpr int kWBytes = 9 * kKSteps * kBlockBytes;   // 73,728
constexpr int kSmemBytes = kWBytes + 2 * kFrameBytes;

struct Tile {
  int b, y0, x0;
};

__device__ __forceinline__ Tile tile_of(int t, int tiles_h, int tiles_w) {
  const int per = tiles_h * tiles_w, r = t % per;
  return {t / per, (r / tiles_w) * kTH, (r % tiles_w) * kTW};
}

// the tile's input frame (rows y0 - 1 .. y0 + kTH, same for columns),
// zero outside the image; chunk c of frame pixel q at q * 128 + (c ^ (q % 8))
// * 16
__device__ __forceinline__ void load_frame(uint32_t buf, const bf16* x,
                                           Tile t, int H, int W) {
  for (int e = threadIdx.x; e < kFramePix * 8; e += kThreads) {
    const int q = e / 8, c = e % 8;
    const int iy = t.y0 - 1 + q / kFW, ix = t.x0 - 1 + q % kFW;
    const bool ok = iy >= 0 && iy < H && ix >= 0 && ix < W;
    const bf16* src =
        ok ? x + (((size_t)t.b * H + iy) * W + ix) * kC + 8 * c : x;
    cp_async16(buf + q * kPixBytes + ((c ^ (q & 7)) << 4), src, ok);
  }
}

// A registers of one tap for the 4 k-steps: this lane's row is frame
// pixel q
__device__ __forceinline__ void load_a(uint32_t (&a)[kKSteps][4],
                                       uint32_t buf, int q, int hi) {
  const uint32_t row = buf + q * kPixBytes;
#pragma unroll
  for (int s = 0; s < kKSteps; ++s)
    ldmatrix_x4(row + (((2 * s + hi) ^ (q & 7)) << 4), a[s]);
}

__global__ void __launch_bounds__(kThreads, 1)
conv3_wgmma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                   const bf16* __restrict__ bias, bf16* __restrict__ y, int H,
                   int W, int tiles_h, int tiles_w, int n_tiles) {
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t w_s = smem_u32(smem);
  const uint32_t frames = w_s + kWBytes;

  const int tid = threadIdx.x, lane = tid % 32;
  const int wg = tid / 128, warp = (tid / 32) % 4, q4 = lane % 4;

  // resident weights, then the first tile: one cp.async group
  for (int e = tid; e < kWBytes / 16; e += kThreads)
    cp_async16(w_s + 16 * e, w + 8 * e, true);
  int t = blockIdx.x;
  load_frame(frames, x, tile_of(t, tiles_h, tiles_w), H, W);
  cp_async_commit();

  float bl[8][2];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e)
      bl[j][e] = __bfloat162float(bias[8 * j + 2 * q4 + e]);

  // this lane's A row: tile row 4 * wg + warp, tile column lane % 16;
  // frame pixel of tap (0, 0)
  const int ty = 4 * wg + warp;
  const int q0 = ty * kFW + lane % 16;
  const int hi = lane / 16;

  for (int it = 0; t < n_tiles; ++it, t += gridDim.x) {
    const uint32_t cur = frames + (it & 1) * kFrameBytes;
    cp_async_wait_all();
    fence_proxy_async();
    __syncthreads();   // tile t and the weights are in; buffer it+1 free
    const int tn = t + gridDim.x;
    if (tn < n_tiles)
      load_frame(frames + ((it + 1) & 1) * kFrameBytes, x,
                 tile_of(tn, tiles_h, tiles_w), H, W);
    cp_async_commit();

    float acc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.0f;

    uint32_t a[2][kKSteps][4];
    load_a(a[0], cur, q0, hi);
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      wgmma_fence();
#pragma unroll
      for (int s = 0; s < kKSteps; ++s)
        wgmma_m64n64k16(acc, a[tap & 1][s],
                        make_desc(w_s + (tap * kKSteps + s) * kBlockBytes),
                        1);
      wgmma_commit();
      if (tap < 8) {
        wgmma_wait<1>();   // tap - 1's products: its A registers are free
        const int nt = tap + 1;
        load_a(a[nt & 1], cur, q0 + (nt / 3) * kFW + nt % 3, hi);
      }
    }
    wgmma_wait<0>();

    // epilogue: rows lane / 4 and lane / 4 + 8 of the warp's 16 pixels
    const Tile tl = tile_of(t, tiles_h, tiles_w);
    const int oy = tl.y0 + ty;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int ox = tl.x0 + lane / 4 + 8 * r;
      uint32_t v[2][4], o[2][4];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        v[j / 4][j % 4] =
            pack_bf16x2(silu_fast(acc[4 * j + 2 * r] + bl[j][0]),
                        silu_fast(acc[4 * j + 2 * r + 1] + bl[j][1]));
      quad_transpose(v[0], o[0], q4);
      quad_transpose(v[1], o[1], q4);
      if (oy < H && ox < W) {
        bf16* dst = y + (((size_t)tl.b * H + oy) * W + ox) * kC + 8 * q4;
        *reinterpret_cast<uint4*>(dst) =
            make_uint4(o[0][0], o[0][1], o[0][2], o[0][3]);
        *reinterpret_cast<uint4*>(dst + 32) =
            make_uint4(o[1][0], o[1][1], o[1][2], o[1][3]);
      }
    }
  }
  cp_async_wait_all();
}

cudaError_t launch(const void* x, const void* w, const void* b, void* y,
                   int B, int H, int W, cudaStream_t stream) {
  static PerDeviceSmem smem;
  cudaError_t e = smem.opt_in((const void*)conv3_wgmma_kernel, kSmemBytes);
  if (e != cudaSuccess) return e;
  const int tiles_h = ceil_div(H, kTH), tiles_w = ceil_div(W, kTW);
  const int n_tiles = B * tiles_h * tiles_w;
  const int grid = n_tiles < sm_count() ? n_tiles : sm_count();
  conv3_wgmma_kernel<<<grid, kThreads, kSmemBytes, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w),
      static_cast<const bf16*>(b), static_cast<bf16*>(y), H, W, tiles_h,
      tiles_w, n_tiles);
  return cudaGetLastError();
}

}  // namespace tc

// ---------------------------------------------------------------------------
// f32 tensor-core variant (3xTF32, mma.sync)
// ---------------------------------------------------------------------------

namespace f32 {

using namespace sm90;

constexpr int kTW = 16;                  // tile columns: one m16 tile
constexpr int kTH = 8;                   // tile rows
constexpr int kFW = kTW + 2;             // frame columns
constexpr int kRing = 2 * kTH + 2;       // ring rows: a frame + the next 8
constexpr int kPixBytes = kC * 4;        // 256
constexpr int kRowBytes = kFW * kPixBytes;
constexpr int kRingBytes = kRing * kRowBytes;         // 82,944
constexpr int kWBytes = 9 * kC * kC * 4;              // 147,456
constexpr int kSmemBytes = kWBytes + kRingBytes;      // 230,400
constexpr int kThreads = 256;
constexpr int kSteps = kC / 16;          // 16-channel steps of a tap

// the ring slot of image row iy (>= -1)
__device__ __forceinline__ int slot(int iy) { return (iy + kRing) % kRing; }

// byte offset of chunk c (4 channels) of ring pixel q (slot * kFW +
// frame column): an odd pixel's chunks XOR-swizzled by 4, so that the two
// pixels of an A load's 8-lane phase meet 8 bank groups
__device__ __forceinline__ uint32_t pix_off(int q, int c) {
  return q * kPixBytes + ((c ^ ((q & 1) << 2)) << 4);
}

struct Tile {
  int b, y0, x0;
};

// tiles in (image, column strip, row block) order
__device__ __forceinline__ Tile tile_of(int t, int rblocks, int strips) {
  const int s = t / rblocks;
  return {s / strips, (t % rblocks) * kTH, (s % strips) * kTW};
}

// image rows [iy0, iy1) of the tile's frame columns into their ring
// slots, zero outside the image
__device__ __forceinline__ void load_rows(uint32_t ring, const float* x,
                                          Tile t, int iy0, int iy1, int H,
                                          int W) {
  for (int e = threadIdx.x; e < (iy1 - iy0) * kFW * 16; e += kThreads) {
    const int c = e % 16, col = (e / 16) % kFW, iy = iy0 + e / (16 * kFW);
    const int ix = t.x0 - 1 + col;
    const bool ok = iy >= 0 && iy < H && ix >= 0 && ix < W;
    const float* src =
        ok ? x + (((size_t)t.b * H + iy) * W + ix) * kC + 4 * c : x;
    cp_async16(ring + pix_off(slot(iy) * kFW + col, c), src, ok);
  }
}

// The weights from the packed image into [tap][16-channel step h][co][16
// input channels]: 16-byte chunk e = ((4 tap + h) * 64 + co) * 4 + cq
// holds input channels 16 h + 4 cq .. + 3 of output channel co, which the
// packed image keeps contiguous.
__device__ __forceinline__ void load_weights(uint32_t w_s, const float* w) {
  for (int e = threadIdx.x; e < kWBytes / 16; e += kThreads) {
    const int cq = e & 3, co = (e >> 2) & 63, th = e >> 8;
    cp_async16(w_s + 16 * e,
               w + th * 16 * kC + (co / 8) * 128 + (cq / 2) * 64 +
                   (co % 8) * 8 + (cq % 2) * 4,
               true);
  }
}

// A persistent grid; CTA i walks tiles [i T / G, (i + 1) T / G) of the T
// tiles. Warp w takes tile rows 2 (w % 4) and + 1 (two m16 tiles) for the
// 32 output channels 32 (w / 4) .. + 31 (four n8 tiles). In a k8 step
// (tap, h, s) the column t of A and B stands for input channel
// 16 h + 4 t + 2 s and column t + 4 for the next one, so a lane reads 4
// contiguous channels (one 16-byte load) of its pixel for A and of its
// output channel for B, for both steps s.
__global__ void __launch_bounds__(kThreads, 1)
conv3_tf32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                  const float* __restrict__ bias, float* __restrict__ y,
                  int H, int W, int rblocks, int strips, int n_tiles) {
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t w_s = smem_u32(smem), ring = w_s + kWBytes;
  const unsigned char* const ws = smem;
  const unsigned char* const rs = smem + kWBytes;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int gq = lane / 4, tq = lane % 4;
  const int pr = 2 * (warp % 4), n0 = 32 * (warp / 4);

  const int t0 = (int)((long long)blockIdx.x * n_tiles / gridDim.x);
  const int t1 = (int)((long long)(blockIdx.x + 1) * n_tiles / gridDim.x);
  load_weights(w_s, w);
  bool ready = false;   // the tile's frame is in, or in flight

  float bc[4][2];       // biases of this lane's channels
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e)
      bc[j][e] = __ldg(bias + n0 + 8 * j + 2 * tq + e);

  for (int t = t0; t < t1; ++t) {
    const Tile tl = tile_of(t, rblocks, strips);
    if (!ready) {
      __syncthreads();   // the last tile is done with the ring
      load_rows(ring, x, tl, tl.y0 - 1, tl.y0 + kTH + 1, H, W);
      cp_async_commit();
    }
    cp_async_wait_all();
    // the frame is in, and every warp is done with tile t - 1, whose
    // first 8 rows are the slots of the next tile's 8 new rows
    __syncthreads();
    ready = t + 1 < t1 && (t + 1) % rblocks != 0;
    if (ready) {
      load_rows(ring, x, tl, tl.y0 + kTH + 1, tl.y0 + 2 * kTH + 1, H, W);
      cp_async_commit();
    }

    float acc[2][4][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[mt][j][k] = 0.0f;
#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      const int ky = tap / 3, kx = tap % 3;
      // ring pixels of this lane's A rows gq and gq + 8 of each m16 tile
      int q[2][2];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int r = 0; r < 2; ++r)
          q[mt][r] = slot(tl.y0 + pr + mt + ky - 1) * kFW + gq + 8 * r + kx;
      const unsigned char* const wt =
          ws + (((4 * tap * kC + n0 + gq) << 6) + (tq << 4));
      float part[2][4][4];   // this tap's products, added by FADD
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int k = 0; k < 4; ++k) part[mt][j][k] = 0.0f;
#pragma unroll
      for (int h = 0; h < kSteps; ++h) {
        float4 av[2][2], bv[4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int r = 0; r < 2; ++r)
            av[mt][r] = *reinterpret_cast<const float4*>(
                rs + pix_off(q[mt][r], 4 * h + tq));
#pragma unroll
        for (int j = 0; j < 4; ++j)
          bv[j] = *reinterpret_cast<const float4*>(
              wt + ((h * kC + 8 * j) << 6));
#pragma unroll
        for (int s = 0; s < 2; ++s) {
          uint32_t ah[2][4], al[2][4];
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            const float4 &r0 = av[mt][0], &r1 = av[mt][1];
            const float v[4] = {s ? r0.z : r0.x, s ? r1.z : r1.x,
                                s ? r0.w : r0.y, s ? r1.w : r1.y};
#pragma unroll
            for (int k = 0; k < 4; ++k)
              split_tf32(v[k], ah[mt][k], al[mt][k]);
          }
          uint32_t bh[4][2], bl[4][2];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            split_tf32(s ? bv[j].z : bv[j].x, bh[j][0], bl[j][0]);
            split_tf32(s ? bv[j].w : bv[j].y, bh[j][1], bl[j][1]);
          }
          mma_3xtf32(part, ah, al, bh, bl);
        }
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int k = 0; k < 4; ++k) acc[mt][j][k] += part[mt][j][k];
    }

    // epilogue: pixel (row pr + mt, column gq + 8 r), channels n0 + 8 j +
    // 2 tq, + 1; within each quad the lanes trade so that lane tq holds
    // channels n0 + 8 tq .. + 7, two 16-byte stores
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        uint32_t vx[4], vy[4], ox[4], oy[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          vx[j] = __float_as_uint(
              silu_mufu(acc[mt][j][2 * r] + bc[j][0]));
          vy[j] = __float_as_uint(
              silu_mufu(acc[mt][j][2 * r + 1] + bc[j][1]));
        }
        quad_transpose(vx, ox, tq);
        quad_transpose(vy, oy, tq);
        const int iy = tl.y0 + pr + mt, ix = tl.x0 + gq + 8 * r;
        if (iy < H && ix < W) {
          float* dst =
              y + (((size_t)tl.b * H + iy) * W + ix) * kC + n0 + 8 * tq;
          *reinterpret_cast<uint4*>(dst) =
              make_uint4(ox[0], oy[0], ox[1], oy[1]);
          *reinterpret_cast<uint4*>(dst + 4) =
              make_uint4(ox[2], oy[2], ox[3], oy[3]);
        }
      }
  }
  cp_async_wait_all();
}

cudaError_t launch(const void* x, const void* w, const void* b, void* y,
                   int B, int H, int W, cudaStream_t stream) {
  static PerDeviceSmem smem;
  cudaError_t e = smem.opt_in((const void*)conv3_tf32_kernel, kSmemBytes);
  if (e != cudaSuccess) return e;
  const int rblocks = ceil_div(H, kTH), strips = ceil_div(W, kTW);
  const int n_tiles = B * strips * rblocks;
  const int grid = n_tiles < sm_count() ? n_tiles : sm_count();
  conv3_tf32_kernel<<<grid, kThreads, kSmemBytes, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<const float*>(b), static_cast<float*>(y), H, W, rblocks,
      strips, n_tiles);
  return cudaGetLastError();
}

}  // namespace f32

}  // namespace
}  // namespace yolo

// x (B, H, W, 64) NHWC; w the packed weight image (hopper.cuh:
// packed_index, 36,864 elements; ops/kernels/conv3.py: pack_weights);
// b (64,); y (B, H, W, 64) NHWC; all of one dtype; x, w, b and y 16-byte
// aligned (checked by the Python wrapper).
extern "C" int yolo_conv3_silu(const void* x, const void* w, const void* b,
                               void* y, int B, int H, int W, int dtype,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == yolo::kBFloat16) return yolo::tc::launch(x, w, b, y, B, H, W, s);
  return yolo::f32::launch(x, w, b, y, B, H, W, s);
}
