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
// - bf16: tensor cores through nvcuda::wmma 16x16x16 bf16 fragments with
//   f32 accumulators. A block owns 8 output rows x 32 output columns x all
//   64 output channels; each warp one row (two M fragments of 16 pixels) x
//   four N fragments of 16 channels. For each chunk of 16 input channels
//   the block stages the (8 + 2) x (32 + 2) input patch (zero outside the
//   image: the padding) and the chunk's 9 x 16 x 64 weights in shared
//   memory with 16-byte loads; weight rows are padded to 72 channels so the
//   B-fragment loads do not share banks. For tap (ky, kx) the A fragment of
//   a warp is read straight from the patch at row warp + ky, column kx (no
//   im2col copy). The epilogue goes through shared memory per fragment:
//   bias and SiLU in f32, one rounding to bf16, 4-byte stores of channel
//   pairs.
// - f32: CUDA cores, an 8 x 16-pixel tile, chunks of 8 input channels and
//   an 8-pixel x 4-channel f32 register tile per thread. The products are
//   not rounded to TF32.
// Double buffering, TMA and wgmma are later work.
#include <mma.h>

#include "common.cuh"

namespace yolo {
namespace {

constexpr int kC = 64;   // input and output channels

// ---------------------------------------------------------------------------
// bf16 tensor-core variant
// ---------------------------------------------------------------------------

namespace tc {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

constexpr int kTR = 8;                  // output rows per block, one per warp
constexpr int kTC = 32;                 // output columns per block (2 x wmma M)
constexpr int kPR = kTR + 2;            // patch rows
constexpr int kPC = kTC + 2;            // patch columns
constexpr int kCK = 16;                 // input channels per chunk (wmma K)
constexpr int kNF = kC / 16;            // wmma N fragments per warp
constexpr int kWLd = kC + 8;            // padded weight row (bank conflicts)
constexpr int kThreads = 32 * kTR;

constexpr int kPatchElems = kPR * kPC * kCK;
constexpr int kWElems = 9 * kCK * kWLd;
constexpr int kStageFloats = kTR * 16 * kC;   // one M fragment per warp
constexpr int kMainBytes = 2 * (kPatchElems + kWElems);
constexpr int kSmemBytes =
    kMainBytes > 4 * kStageFloats ? kMainBytes : 4 * kStageFloats;

__global__ void __launch_bounds__(kThreads)
conv3_wmma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                  const bf16* __restrict__ bias, bf16* __restrict__ y, int H,
                  int W, int tiles_w) {
  __shared__ __align__(128) unsigned char smem[kSmemBytes];
  bf16* patch = reinterpret_cast<bf16*>(smem);     // [kPR][kPC][kCK]
  bf16* w_s = patch + kPatchElems;                 // [tap][kCK][kWLd]
  float* stage = reinterpret_cast<float*>(smem);   // epilogue, reuses all

  const int oy0 = (blockIdx.x / tiles_w) * kTR;
  const int ox0 = (blockIdx.x % tiles_w) * kTC;
  const int b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const bf16* xb = x + (size_t)b * H * W * kC;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][kNF];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int n = 0; n < kNF; ++n) wmma::fill_fragment(acc[m][n], 0.0f);

  for (int ci0 = 0; ci0 < kC; ci0 += kCK) {
    // 1. input patch, 8 channels (16 bytes) per item: local (r, c) <->
    //    pixel (oy0 - 1 + r, ox0 - 1 + c); zero outside the image
    for (int e = tid; e < kPR * kPC * (kCK / 8); e += kThreads) {
      const int half = e % 2, rc = e / 2;
      const int iy = oy0 - 1 + rc / kPC, ix = ox0 - 1 + rc % kPC;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (iy >= 0 && iy < H && ix >= 0 && ix < W)
        v = *reinterpret_cast<const uint4*>(
            xb + ((size_t)iy * W + ix) * kC + ci0 + 8 * half);
      *reinterpret_cast<uint4*>(patch + rc * kCK + 8 * half) = v;
    }
    // 2. the chunk's weights, [tap][ci][co] from the (ci, tap, co) layout
    for (int e = tid; e < kCK * 9 * (kC / 8); e += kThreads) {
      const int v8 = e % (kC / 8), kt = e / (kC / 8);
      const int k = kt / 9, tap = kt % 9;
      *reinterpret_cast<uint4*>(w_s + (tap * kCK + k) * kWLd + 8 * v8) =
          *reinterpret_cast<const uint4*>(
              w + ((size_t)(ci0 + k) * 9 + tap) * kC + 8 * v8);
    }
    __syncthreads();

    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[2];
    wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bm;
#pragma unroll
    for (int ky = 0; ky < 3; ++ky) {
#pragma unroll
      for (int kx = 0; kx < 3; ++kx) {
#pragma unroll
        for (int m = 0; m < 2; ++m)
          wmma::load_matrix_sync(
              a[m], patch + ((warp + ky) * kPC + 16 * m + kx) * kCK, kCK);
#pragma unroll
        for (int n = 0; n < kNF; ++n) {
          wmma::load_matrix_sync(
              bm, w_s + (3 * ky + kx) * kCK * kWLd + 16 * n, kWLd);
          wmma::mma_sync(acc[0][n], a[0], bm, acc[0][n]);
          wmma::mma_sync(acc[1][n], a[1], bm, acc[1][n]);
        }
      }
    }
    __syncthreads();
  }

  // epilogue, one M fragment at a time through the warp's staging area
  // (16 pixels x 64 channels f32): bias + SiLU, bf16 channel pairs out
  float* st = stage + warp * 16 * kC;
  const int oy = oy0 + warp;
  const float2 bl = make_float2(__bfloat162float(bias[2 * lane]),
                                __bfloat162float(bias[2 * lane + 1]));
#pragma unroll
  for (int m = 0; m < 2; ++m) {
#pragma unroll
    for (int n = 0; n < kNF; ++n)
      wmma::store_matrix_sync(st + 16 * n, acc[m][n], kC,
                              wmma::mem_row_major);
    __syncwarp();
    for (int p = 0; p < 16; ++p) {
      const int ox = ox0 + 16 * m + p;
      if (oy < H && ox < W) {
        const float2 v = *reinterpret_cast<const float2*>(st + p * kC +
                                                          2 * lane);
        *reinterpret_cast<__nv_bfloat162*>(
            y + (((size_t)b * H + oy) * W + ox) * kC + 2 * lane) =
            __floats2bfloat162_rn(silu(v.x + bl.x), silu(v.y + bl.y));
      }
    }
    __syncwarp();
  }
}

cudaError_t launch(const void* x, const void* w, const void* b, void* y,
                   int B, int H, int W, cudaStream_t stream) {
  const int tiles_w = ceil_div(W, kTC), tiles_h = ceil_div(H, kTR);
  dim3 grid(tiles_w * tiles_h, B);
  conv3_wmma_kernel<<<grid, kThreads, 0, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w),
      static_cast<const bf16*>(b), static_cast<bf16*>(y), H, W, tiles_w);
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
    for (int e = tid; e < kCK * 9 * (kC / 4); e += kThreads) {
      const int v4 = e % (kC / 4), kt = e / (kC / 4);
      const int k = kt / 9, tap = kt % 9;
      *reinterpret_cast<float4*>(w_s + (tap * kCK + k) * kC + 4 * v4) =
          *reinterpret_cast<const float4*>(
              w + ((size_t)(ci0 + k) * 9 + tap) * kC + 4 * v4);
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

// x (B, H, W, 64) NHWC; w (64, 3, 3, 64) input channel major (the wrapper
// permutes the OIHW weight); b (64,); y (B, H, W, 64) NHWC; all of one
// dtype; x, w, b and y 16-byte aligned (checked by the Python wrapper).
extern "C" int yolo_conv3_silu(const void* x, const void* w, const void* b,
                               void* y, int B, int H, int W, int dtype,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == yolo::kBFloat16) return yolo::tc::launch(x, w, b, y, B, H, W, s);
  return yolo::f32::launch(x, w, b, y, B, H, W, s);
}
