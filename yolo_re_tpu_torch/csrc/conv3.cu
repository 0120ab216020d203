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
// - f32: CUDA cores, an 8 x 16-pixel tile, chunks of 8 input channels and
//   an 8-pixel x 4-channel f32 register tile per thread. The products are
//   not rounded to TF32. It reads the same packed weights.
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
// f32 CUDA-core variant
// ---------------------------------------------------------------------------

namespace f32 {

constexpr int kTR = 8;                  // output tile rows
constexpr int kTC = 16;                 // output tile columns
constexpr int kPR = kTR + 2, kPC = kTC + 2;
constexpr int kCK = 8;                  // input channels per chunk
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
conv3_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                 const float* __restrict__ bias, float* __restrict__ y, int H,
                 int W, int tiles_w) {
  __shared__ __align__(16) float patch[kPR * kPC * kCK];   // [r][c][k]
  __shared__ __align__(16) float w_s[9 * kCK * kC];        // [tap][k][co]

  const int oy0 = (blockIdx.x / tiles_w) * kTR;
  const int ox0 = (blockIdx.x % tiles_w) * kTC;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  // register tile: 8 pixels (one row, 8 adjacent columns) x 4 channels
  const int cg = tid % 16, pg = tid / 16;
  const int pr = pg / 2, pc0 = (pg % 2) * 8;
  const float* xb = x + (size_t)b * H * W * kC;

  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (int ci0 = 0; ci0 < kC; ci0 += kCK) {
    for (int e = tid; e < kPR * kPC * (kCK / 4); e += kThreads) {
      const int q = e % 2, rc = e / 2;
      const int iy = oy0 - 1 + rc / kPC, ix = ox0 - 1 + rc % kPC;
      float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (iy >= 0 && iy < H && ix >= 0 && ix < W)
        v = *reinterpret_cast<const float4*>(
            xb + ((size_t)iy * W + ix) * kC + ci0 + 4 * q);
      *reinterpret_cast<float4*>(patch + rc * kCK + 4 * q) = v;
    }
    // the chunk's weights, [tap][ci][co], from the packed image, where
    // one output channel's 8 input channels of a chunk are contiguous
    for (int e = tid; e < 9 * kC * 2; e += kThreads) {
      const int half = e % 2, co = (e / 2) % kC, tap = e / (2 * kC);
      const float4 v = *reinterpret_cast<const float4*>(
          w + sm90::packed_index<kC>(co, ci0, tap) + 4 * half);
      float* d = w_s + (tap * kCK + 4 * half) * kC + co;
      d[0] = v.x; d[kC] = v.y; d[2 * kC] = v.z; d[3 * kC] = v.w;
    }
    __syncthreads();
#pragma unroll
    for (int ky = 0; ky < 3; ++ky) {
#pragma unroll
      for (int kx = 0; kx < 3; ++kx) {
        const float* wt = w_s + (3 * ky + kx) * kCK * kC + 4 * cg;
        const float* at = patch + ((pr + ky) * kPC + pc0 + kx) * kCK;
#pragma unroll
        for (int k = 0; k < kCK; ++k) {
          const float4 wv = *reinterpret_cast<const float4*>(wt + k * kC);
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const float a = at[i * kCK + k];
            acc[i][0] += a * wv.x; acc[i][1] += a * wv.y;
            acc[i][2] += a * wv.z; acc[i][3] += a * wv.w;
          }
        }
      }
    }
    __syncthreads();
  }

  const int oy = oy0 + pr;
  if (oy >= H) return;
  const float4 bv = *reinterpret_cast<const float4*>(bias + 4 * cg);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int ox = ox0 + pc0 + i;
    if (ox >= W) continue;
    *reinterpret_cast<float4*>(y + (((size_t)b * H + oy) * W + ox) * kC +
                               4 * cg) =
        make_float4(silu(acc[i][0] + bv.x), silu(acc[i][1] + bv.y),
                    silu(acc[i][2] + bv.z), silu(acc[i][3] + bv.w));
  }
}

cudaError_t launch(const void* x, const void* w, const void* b, void* y,
                   int B, int H, int W, cudaStream_t stream) {
  const int tiles_w = ceil_div(W, kTC), tiles_h = ceil_div(H, kTR);
  dim3 grid(tiles_w * tiles_h, B);
  conv3_f32_kernel<<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<const float*>(b), static_cast<float*>(y), H, W, tiles_w);
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
