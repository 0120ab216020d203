// Backward of the pre-BN ADown (train), the gradient of yolo_adown_raw:
//
//   a  = avgpool(2, 1, 0)(x)      a[ay, ax] = ((x00 + x01) + (x10 + x11)) / 4
//   y1 = conv3x3_s2_p1(a[.., :Ch]; w1)        zero padding
//   M  = maxpool(3, 2, 1)(a[.., Ch:])         -inf padding
//   y2 = conv1x1(M; w2)
//
// Given g = dL/d(concat(y1, y2)), it returns dx, dW1 (Co, Ch, 3, 3) and
// dW2 (Co, Ch, 1, 1), f32 weight gradients. The avg domain is rows
// 0..H-2 and columns 0..W-2. The maxpool gradient goes to the FIRST
// maximum of the window in row-major (ky, kx) order, XLA's
// select_and_scatter rule and PyTorch's max_pool2d rule.
//
// Replaces the TPU kernel yolo_re_tpu/ops/pallas/adown_train_kernel.py
// (adown_bwd_from_packed, _bwd_kernel). That kernel runs one sequential
// grid over row blocks with halos and carries the weight-gradient sums in
// VMEM from step to step; its (row parity x column parity) dS planes avoid
// scatters on the TPU. Here the same function is six launches on one
// stream, none with atomics, so the result is the same on every run:
//   1. pool_argmax: the branch-2 window max M and its first-max tap
//      (one thread per output pixel and channel);
//   2. gemm_dm: dM = g2 . w2^T, the gradient at M (tiled product);
//   3. gemm_da1: dA1 = the transposed 3x3 stride-2 conv of g1, the
//      gradient at the branch-1 avg. Blocks take one (row, column) parity
//      class of avg pixels, so every pixel of a tile has the same 1, 2 or
//      4 taps: no zero taps are multiplied;
//   4. adown_dx: dx = (sum of the four avg pixels' gradients) / 4; the
//      branch-2 gradient of an avg pixel is gathered from the <= 4 output
//      windows whose first max it is (no scatter);
//   5. gemm_dw: per slab of output pixels, partial dW1 (9 taps, with the
//      avg recomputed from x) and dW2 (from M) as tiled products over the
//      slab's pixels;
//   6. dw_reduce: the slabs summed in a fixed order.
// The avg is summed in the order above, the plain version's
// (ops/kernels/adown.py:adown_raw_plain), so the first max is taken among
// the same f32 values.
//
// What bounds it on an H100: at gelan-c's down1 ((32, 256, 160, 160),
// Co = Ch = 128) the two 3x3 products (dA1 and dW1) are ~60 GFLOP each and
// the rest ~13 GFLOP, against ~2 GB of traffic (x, g, dx and the f32
// intermediates): arithmetic-bound on the CUDA cores. The products use
// 64 x 64 output tiles: for f32 on the CUDA cores (a 4 x 4 register tile
// per thread, 16-deep chunks in shared memory); for bf16 (Ch, Co multiples
// of 8), products 3 and 5 on the tensor cores with nvcuda::wmma fragments
// and 16-byte staging (namespace tc, one more launch writes the bf16 avg).
// wgmma and TMA are later work.
#include <mma.h>

#include <type_traits>

#include "common.cuh"

namespace yolo {
namespace {

constexpr int kThreads = 256;
constexpr int kT = 64;          // product tile rows and columns
constexpr int kK = 16;          // reduction chunk
constexpr int kLd = kT + 4;     // shared row stride: 16-byte aligned, fewer conflicts

__device__ __forceinline__ void mma_chunk(const float* As, const float* Bs,
                                          float (&acc)[4][4], int tr,
                                          int tc) {
#pragma unroll
  for (int k = 0; k < kK; ++k) {
    const float4 a = *reinterpret_cast<const float4*>(As + k * kLd + 4 * tr);
    const float4 b = *reinterpret_cast<const float4*>(Bs + k * kLd + 4 * tc);
    const float av[4] = {a.x, a.y, a.z, a.w};
    const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] += av[i] * bv[j];
  }
}

// avg pixel (ay, ax), channel c of one image (NHWC), in the plain order
template <typename T>
__device__ __forceinline__ float avg4(const T* xb, int W, int Cin, int ay,
                                      int ax, int c) {
  const T* p = xb + ((size_t)ay * W + ax) * Cin + c;
  const size_t row = (size_t)W * Cin;
  return ((to_f32(p[0]) + to_f32(p[Cin])) +
          (to_f32(p[row]) + to_f32(p[row + Cin]))) * 0.25f;
}

__device__ __forceinline__ bool in_avg(int ay, int ax, int H, int W) {
  return ay >= 0 && ay <= H - 2 && ax >= 0 && ax <= W - 2;
}

// 1. M (B, Ho, Wo, Ch) f32 and idx: tap 3*ky + kx of the first max
template <typename T>
__global__ void __launch_bounds__(kThreads)
pool_argmax(const T* __restrict__ x, float* __restrict__ M,
            unsigned char* __restrict__ idx, int B, int H, int W, int Cin,
            int Ho, int Wo) {
  const int Ch = Cin / 2;
  const size_t total = (size_t)B * Ho * Wo * Ch;
  for (size_t e = (size_t)blockIdx.x * kThreads + threadIdx.x; e < total;
       e += (size_t)gridDim.x * kThreads) {
    const int ci = (int)(e % Ch);
    const size_t p = e / Ch;
    const int ox = (int)(p % Wo);
    const size_t t = p / Wo;
    const int oy = (int)(t % Ho), b = (int)(t / Ho);
    const T* xb = x + (size_t)b * H * W * Cin;
    float m = -CUDART_INF_F;
    int arg = 0;
#pragma unroll
    for (int ky = 0; ky < 3; ++ky)
#pragma unroll
      for (int kx = 0; kx < 3; ++kx) {
        const int ay = 2 * oy - 1 + ky, ax = 2 * ox - 1 + kx;
        if (!in_avg(ay, ax, H, W)) continue;
        const float v = avg4(xb, W, Cin, ay, ax, Ch + ci);
        if (v > m) {
          m = v;
          arg = 3 * ky + kx;
        }
      }
    M[e] = m;
    idx[e] = (unsigned char)arg;
  }
}

// 2. dM[p, ci] = sum_co g[p, Co + co] * w2[co, ci]; w2t (Co, Ch)
template <typename T>
__global__ void __launch_bounds__(kThreads)
gemm_dm(const T* __restrict__ g, const float* __restrict__ w2t,
        float* __restrict__ dM, long long N, int Co, int Ch) {
  __shared__ __align__(16) float As[kK * kLd];
  __shared__ __align__(16) float Bs[kK * kLd];
  const long long p0 = (long long)blockIdx.x * kT;
  const int ci0 = blockIdx.y * kT;
  const int tid = threadIdx.x, tr = tid / 16, tc = tid % 16;
  const int Cout = 2 * Co;
  float acc[4][4] = {};
  for (int co0 = 0; co0 < Co; co0 += kK) {
    for (int e = tid; e < kK * kT; e += kThreads) {
      const int k = e % kK, m = e / kK;
      const long long p = p0 + m;
      As[k * kLd + m] = (p < N && co0 + k < Co)
          ? to_f32(g[(size_t)p * Cout + Co + co0 + k]) : 0.0f;
      const int n = e % kT, kk = e / kT;
      Bs[kk * kLd + n] = (ci0 + n < Ch && co0 + kk < Co)
          ? w2t[(size_t)(co0 + kk) * Ch + ci0 + n] : 0.0f;
    }
    __syncthreads();
    mma_chunk(As, Bs, acc, tr, tc);
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long p = p0 + 4 * tr + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int ci = ci0 + 4 * tc + j;
      if (p < N && ci < Ch) dM[(size_t)p * Ch + ci] = acc[i][j];
    }
  }
}

// 3. dA1[b, ay, ax, ci] = sum over the taps reaching (ay, ax) of
//    sum_co g[b, oy, ox, co] * w1[co, ci, ky, kx]; w1t (9, Co, Ch).
//    A block: one parity class (py, px), 8 x 8 class pixels, 64 channels.
template <typename T>
__global__ void __launch_bounds__(kThreads)
gemm_da1(const T* __restrict__ g, const float* __restrict__ w1t,
         float* __restrict__ dA1, int Ho, int Wo, int HA, int WA, int Co,
         int Ch, int tiles_j, int ci_tiles) {
  __shared__ __align__(16) float As[kK * kLd];
  __shared__ __align__(16) float Bs[kK * kLd];
  const int cls = blockIdx.y / ci_tiles;
  const int ci0 = (blockIdx.y % ci_tiles) * kT;
  const int py = cls >> 1, px = cls & 1;
  const int ti = blockIdx.x / tiles_j, tj = blockIdx.x % tiles_j;
  const int b = blockIdx.z;
  const int tid = threadIdx.x, tr = tid / 16, tc = tid % 16;
  const int Cout = 2 * Co;
  const T* gb = g + (size_t)b * Ho * Wo * Cout;
  float acc[4][4] = {};
  // an even avg row is reached by ky = 1 only, an odd one by ky = 0 and 2
  for (int ty = 0; ty < (py ? 2 : 1); ++ty) {
    for (int tx = 0; tx < (px ? 2 : 1); ++tx) {
      const int ky = py ? 2 * ty : 1, kx = px ? 2 * tx : 1;
      const int tap = 3 * ky + kx;
      for (int co0 = 0; co0 < Co; co0 += kK) {
        for (int e = tid; e < kK * kT; e += kThreads) {
          const int k = e % kK, m = e / kK;
          const int ay = 2 * (8 * ti + m / 8) + py;
          const int ax = 2 * (8 * tj + m % 8) + px;
          const int oy = (ay + 1 - ky) / 2, ox = (ax + 1 - kx) / 2;
          const bool ok = ay < HA && ax < WA && oy < Ho && ox < Wo &&
                          co0 + k < Co;
          As[k * kLd + m] =
              ok ? to_f32(gb[((size_t)oy * Wo + ox) * Cout + co0 + k]) : 0.0f;
          const int n = e % kT, kk = e / kT;
          Bs[kk * kLd + n] = (ci0 + n < Ch && co0 + kk < Co)
              ? w1t[((size_t)tap * Co + co0 + kk) * Ch + ci0 + n] : 0.0f;
        }
        __syncthreads();
        mma_chunk(As, Bs, acc, tr, tc);
        __syncthreads();
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = 4 * tr + i;
    const int ay = 2 * (8 * ti + m / 8) + py;
    const int ax = 2 * (8 * tj + m % 8) + px;
    if (ay >= HA || ax >= WA) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int ci = ci0 + 4 * tc + j;
      if (ci < Ch)
        dA1[(((size_t)b * HA + ay) * WA + ax) * Ch + ci] = acc[i][j];
    }
  }
}

// branch-2 gradient at avg pixel (ay, ax), channel ci of image b: dM of
// every output window whose first max sits there
__device__ __forceinline__ float da2(const float* __restrict__ dM,
                                     const unsigned char* __restrict__ idx,
                                     int b, int ay, int ax, int ci, int Ho,
                                     int Wo, int Ch) {
  float v = 0.0f;
  for (int ty = 0; ty < ((ay & 1) ? 2 : 1); ++ty) {
    const int ky = (ay & 1) ? 2 * ty : 1;
    const int oy = (ay + 1 - ky) / 2;
    if (oy >= Ho) continue;
    for (int tx = 0; tx < ((ax & 1) ? 2 : 1); ++tx) {
      const int kx = (ax & 1) ? 2 * tx : 1;
      const int ox = (ax + 1 - kx) / 2;
      if (ox >= Wo) continue;
      const size_t o = (((size_t)b * Ho + oy) * Wo + ox) * Ch + ci;
      if (idx[o] == 3 * ky + kx) v += dM[o];
    }
  }
  return v;
}

// 4. dx[b, y, x, c] = (sum of the avg gradients at (y-1|y, x-1|x)) / 4
template <typename T>
__global__ void __launch_bounds__(kThreads)
adown_dx(const float* __restrict__ dA1, const float* __restrict__ dM,
         const unsigned char* __restrict__ idx, T* __restrict__ dx, int B,
         int H, int W, int Cin, int Ho, int Wo) {
  const int Ch = Cin / 2, HA = H - 1, WA = W - 1;
  const size_t total = (size_t)B * H * W * Cin;
  for (size_t e = (size_t)blockIdx.x * kThreads + threadIdx.x; e < total;
       e += (size_t)gridDim.x * kThreads) {
    const int c = (int)(e % Cin);
    const size_t p = e / Cin;
    const int xx = (int)(p % W);
    const size_t t = p / W;
    const int y = (int)(t % H), b = (int)(t / H);
    float s = 0.0f;
#pragma unroll
    for (int dy = -1; dy <= 0; ++dy)
#pragma unroll
      for (int dxx = -1; dxx <= 0; ++dxx) {
        const int ay = y + dy, ax = xx + dxx;
        if (!in_avg(ay, ax, H, W)) continue;
        s += c < Ch ? dA1[(((size_t)b * HA + ay) * WA + ax) * Ch + c]
                    : da2(dM, idx, b, ay, ax, c - Ch, Ho, Wo, Ch);
      }
    dx[e] = from_f32<T>(0.25f * s);
  }
}

// 5. part[s, q, ci, co]: for tap q < 9, sum over the slab's output pixels
//    of avg1pad[2oy-1+ky, 2ox-1+kx, ci] * g[p, co]; for q = 9,
//    M[p, ci] * g[p, Co + co]
template <typename T>
__global__ void __launch_bounds__(kThreads)
gemm_dw(const T* __restrict__ x, const T* __restrict__ g,
        const float* __restrict__ M, float* __restrict__ part, int H, int W,
        int Cin, int Ho, int Wo, int Co, long long N, long long slab,
        int co_tiles) {
  __shared__ __align__(16) float As[kK * kLd];
  __shared__ __align__(16) float Bs[kK * kLd];
  const int s = blockIdx.x, q = blockIdx.y;
  const int ci0 = (blockIdx.z / co_tiles) * kT;
  const int co0 = (blockIdx.z % co_tiles) * kT;
  const int Ch = Cin / 2, Cout = 2 * Co;
  const int ky = q / 3, kx = q % 3;
  const int goff = q == 9 ? Co : 0;
  const int tid = threadIdx.x, tr = tid / 16, tc = tid % 16;
  const long long p_begin = (long long)s * slab;
  const long long p_end = p_begin + slab < N ? p_begin + slab : N;
  float acc[4][4] = {};
  for (long long pk = p_begin; pk < p_end; pk += kK) {
    for (int e = tid; e < kK * kT; e += kThreads) {
      const int m = e % kT, k = e / kT;
      const long long p = pk + k;
      const bool live = p < p_end;
      float v = 0.0f;
      if (live && ci0 + m < Ch) {
        if (q == 9) {
          v = M[(size_t)p * Ch + ci0 + m];
        } else {
          const int ox = (int)(p % Wo);
          const long long t = p / Wo;
          const int oy = (int)(t % Ho), b = (int)(t / Ho);
          const int ay = 2 * oy - 1 + ky, ax = 2 * ox - 1 + kx;
          if (in_avg(ay, ax, H, W))
            v = avg4(x + (size_t)b * H * W * Cin, W, Cin, ay, ax, ci0 + m);
        }
      }
      As[k * kLd + m] = v;
      Bs[k * kLd + m] = (live && co0 + m < Co)
          ? to_f32(g[(size_t)p * Cout + goff + co0 + m]) : 0.0f;
    }
    __syncthreads();
    mma_chunk(As, Bs, acc, tr, tc);
    __syncthreads();
  }
  float* out = part + ((size_t)s * 10 + q) * Ch * Co;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int ci = ci0 + 4 * tr + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int co = co0 + 4 * tc + j;
      if (ci < Ch && co < Co) out[(size_t)ci * Co + co] = acc[i][j];
    }
  }
}

// 6. dW1 (Co, Ch, 3, 3) and dW2 (Co, Ch): the slabs summed in order
__global__ void __launch_bounds__(kThreads)
dw_reduce(const float* __restrict__ part, float* __restrict__ dw1,
          float* __restrict__ dw2, int S, int Ch, int Co) {
  const size_t total = (size_t)10 * Ch * Co;
  for (size_t e = (size_t)blockIdx.x * kThreads + threadIdx.x; e < total;
       e += (size_t)gridDim.x * kThreads) {
    const int co = (int)(e % Co);
    const size_t t = e / Co;
    const int ci = (int)(t % Ch), q = (int)(t / Ch);
    float v = 0.0f;
    for (int s = 0; s < S; ++s) v += part[(size_t)s * total + e];
    if (q < 9)
      dw1[((size_t)co * Ch + ci) * 9 + q] = v;
    else
      dw2[(size_t)co * Ch + ci] = v;
  }
}

// ---------------------------------------------------------------------------
// bf16 inputs: products 3 and 5 on the tensor cores
// ---------------------------------------------------------------------------
//
// Taken when x is bf16 and Ch, Co are multiples of 8. The same tiles as
// above (64 x 64 outputs per block), with bf16 operands in shared memory,
// 32-deep reduction chunks and nvcuda::wmma 16x16x16 bf16 fragments with
// f32 accumulators: warp w of 8 owns rows 16*(w/2) and two fragments of
// columns at 32*(w%2). Every operand tile is staged with one 16-byte load
// (8 channels) per thread per chunk: g, the weights (two float4 loads,
// rounded to bf16: exact, the forward used bf16 weights), and for dW the
// branch-1 avg that avg_bf16 writes once in bf16 (the forward kernel also
// multiplies a bf16 avg) and the max M, rounded to bf16. The accumulators
// go through shared memory to the same f32 outputs as the CUDA-core
// kernels. (v2 staged with scalar loads and recomputed the avg from x for
// every tap; the staging, not the products, set its time.)
namespace tc {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

constexpr int kKC = 32;           // reduction chunk: two wmma K steps
constexpr int kALd = kKC + 8;     // [m][k] bf16 rows (gemm_da1 A)
constexpr int kBLd = kT + 8;      // [k][n] / [k][m] bf16 rows
constexpr int kCLd = kT + 4;      // f32 staging rows

using Acc = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

__device__ __forceinline__ void stage_acc(Acc (&acc)[2], float* stage,
                                          int warp) {
  const int wr = 16 * (warp / 2), wc = 32 * (warp % 2);
#pragma unroll
  for (int f = 0; f < 2; ++f)
    wmma::store_matrix_sync(stage + wr * kCLd + wc + 16 * f, acc[f], kCLd,
                            wmma::mem_row_major);
}

// 8 consecutive f32 (32-byte aligned) -> 8 bf16 as one uint4
__device__ __forceinline__ uint4 f32x8_to_bf16(const float* p) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  __align__(16) __nv_bfloat162 h[4] = {
      __floats2bfloat162_rn(a.x, a.y), __floats2bfloat162_rn(a.z, a.w),
      __floats2bfloat162_rn(b.x, b.y), __floats2bfloat162_rn(b.z, b.w)};
  return *reinterpret_cast<const uint4*>(h);
}

// avg1 (B, H-1, W-1, Ch) bf16: the branch-1 avg, rounded once
__global__ void __launch_bounds__(kThreads)
avg_bf16(const bf16* __restrict__ x, bf16* __restrict__ avg1, int B, int H,
         int W, int Cin) {
  const int Ch = Cin / 2, HA = H - 1, WA = W - 1;
  const size_t total = (size_t)B * HA * WA * Ch;
  for (size_t e = (size_t)blockIdx.x * kThreads + threadIdx.x; e < total;
       e += (size_t)gridDim.x * kThreads) {
    const int ci = (int)(e % Ch);
    const size_t p = e / Ch;
    const int ax = (int)(p % WA);
    const size_t t = p / WA;
    const int ay = (int)(t % HA), b = (int)(t / HA);
    avg1[e] = __float2bfloat16(
        avg4(x + (size_t)b * H * W * Cin, W, Cin, ay, ax, ci));
  }
}

// product 3 (dA1) on the tensor cores; see gemm_da1
__global__ void __launch_bounds__(kThreads)
gemm_da1_wmma(const bf16* __restrict__ g, const float* __restrict__ w1t,
              float* __restrict__ dA1, int Ho, int Wo, int HA, int WA, int Co,
              int Ch, int tiles_j, int ci_tiles) {
  __shared__ __align__(32) bf16 As[kT * kALd];      // [pixel][co]
  __shared__ __align__(32) bf16 Bs[kKC * kBLd];     // [co][ci]
  __shared__ __align__(32) float stage[kT * kCLd];  // [pixel][ci]
  const int cls = blockIdx.y / ci_tiles;
  const int ci0 = (blockIdx.y % ci_tiles) * kT;
  const int py = cls >> 1, px = cls & 1;
  const int ti = blockIdx.x / tiles_j, tj = blockIdx.x % tiles_j;
  const int b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32;
  const int wr = 16 * (warp / 2), wc = 32 * (warp % 2);
  const int Cout = 2 * Co;
  const bf16* gb = g + (size_t)b * Ho * Wo * Cout;
  // this thread's staging items: A row m, 8 channels at 8*va; B row kk,
  // 8 channels at 8*vb
  const int m = tid / 4, va = tid % 4;
  const int kk = tid / 8, vb = tid % 8;
  const int ay = 2 * (8 * ti + m / 8) + py;
  const int ax = 2 * (8 * tj + m % 8) + px;
  const bool b_ok = ci0 + 8 * vb < Ch;
  Acc acc[2];
  wmma::fill_fragment(acc[0], 0.0f);
  wmma::fill_fragment(acc[1], 0.0f);
  for (int ty = 0; ty < (py ? 2 : 1); ++ty) {
    for (int tx = 0; tx < (px ? 2 : 1); ++tx) {
      const int ky = py ? 2 * ty : 1, kx = px ? 2 * tx : 1;
      const int tap = 3 * ky + kx;
      const int oy = (ay + 1 - ky) / 2, ox = (ax + 1 - kx) / 2;
      const bool a_pix = ay < HA && ax < WA && oy < Ho && ox < Wo;
      for (int co0 = 0; co0 < Co; co0 += kKC) {
        uint4 av = make_uint4(0, 0, 0, 0);
        if (a_pix && co0 + 8 * va < Co)
          av = *reinterpret_cast<const uint4*>(
              gb + ((size_t)oy * Wo + ox) * Cout + co0 + 8 * va);
        *reinterpret_cast<uint4*>(As + m * kALd + 8 * va) = av;
        uint4 bv = make_uint4(0, 0, 0, 0);
        if (b_ok && co0 + kk < Co)
          bv = f32x8_to_bf16(w1t + ((size_t)tap * Co + co0 + kk) * Ch + ci0 +
                             8 * vb);
        *reinterpret_cast<uint4*>(Bs + kk * kBLd + 8 * vb) = bv;
        __syncthreads();
#pragma unroll
        for (int ks = 0; ks < kKC; ks += 16) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
          wmma::load_matrix_sync(a, As + wr * kALd + ks, kALd);
#pragma unroll
          for (int f = 0; f < 2; ++f) {
            wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>
                bm;
            wmma::load_matrix_sync(bm, Bs + ks * kBLd + wc + 16 * f, kBLd);
            wmma::mma_sync(acc[f], a, bm, acc[f]);
          }
        }
        __syncthreads();
      }
    }
  }
  stage_acc(acc, stage, warp);
  __syncthreads();
  for (int e = tid; e < kT * kT; e += kThreads) {
    const int mm = e / kT, n = e % kT;
    const int y = 2 * (8 * ti + mm / 8) + py;
    const int x = 2 * (8 * tj + mm % 8) + px;
    if (y < HA && x < WA && ci0 + n < Ch)
      dA1[(((size_t)b * HA + y) * WA + x) * Ch + ci0 + n] =
          stage[mm * kCLd + n];
  }
}

// product 5 (partial dW1, dW2) on the tensor cores; see gemm_dw
__global__ void __launch_bounds__(kThreads)
gemm_dw_wmma(const bf16* __restrict__ avg1, const bf16* __restrict__ g,
             const float* __restrict__ M, float* __restrict__ part, int H,
             int W, int Cin, int Ho, int Wo, int Co, int N, int slab,
             int co_tiles) {
  __shared__ __align__(32) bf16 As[kKC * kBLd];     // [pixel][ci]
  __shared__ __align__(32) bf16 Bs[kKC * kBLd];     // [pixel][co]
  __shared__ __align__(32) float stage[kT * kCLd];  // [ci][co]
  const int s = blockIdx.x, q = blockIdx.y;
  const int ci0 = (blockIdx.z / co_tiles) * kT;
  const int co0 = (blockIdx.z % co_tiles) * kT;
  const int Ch = Cin / 2, Cout = 2 * Co, HA = H - 1, WA = W - 1;
  const int ky = q / 3, kx = q % 3;
  const int goff = q == 9 ? Co : 0;
  const int tid = threadIdx.x, warp = tid / 32;
  const int wr = 16 * (warp / 2), wc = 32 * (warp % 2);
  const int p_begin = s * slab;
  const int p_end = p_begin + slab < N ? p_begin + slab : N;
  // this thread's staging item: pixel k of the chunk, 8 channels at 8*v
  const int k = tid / 8, v = tid % 8;
  const bool a_ch = ci0 + 8 * v < Ch, b_ch = co0 + 8 * v < Co;
  Acc acc[2];
  wmma::fill_fragment(acc[0], 0.0f);
  wmma::fill_fragment(acc[1], 0.0f);
  for (int pk = p_begin; pk < p_end; pk += kKC) {
    const int p = pk + k;
    uint4 av = make_uint4(0, 0, 0, 0), bv = make_uint4(0, 0, 0, 0);
    if (p < p_end) {
      if (a_ch) {
        if (q == 9) {
          av = f32x8_to_bf16(M + (size_t)p * Ch + ci0 + 8 * v);
        } else {
          const int ox = p % Wo, t = p / Wo;
          const int oy = t % Ho, b = t / Ho;
          const int ay = 2 * oy - 1 + ky, ax = 2 * ox - 1 + kx;
          if (in_avg(ay, ax, H, W))
            av = *reinterpret_cast<const uint4*>(
                avg1 + (((size_t)b * HA + ay) * WA + ax) * Ch + ci0 + 8 * v);
        }
      }
      if (b_ch)
        bv = *reinterpret_cast<const uint4*>(
            g + (size_t)p * Cout + goff + co0 + 8 * v);
    }
    *reinterpret_cast<uint4*>(As + k * kBLd + 8 * v) = av;
    *reinterpret_cast<uint4*>(Bs + k * kBLd + 8 * v) = bv;
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < kKC; ks += 16) {
      // A(m = ci, k = pixel) is stored [pixel][ci]: column major
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> a;
      wmma::load_matrix_sync(a, As + ks * kBLd + wr, kBLd);
#pragma unroll
      for (int f = 0; f < 2; ++f) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bm;
        wmma::load_matrix_sync(bm, Bs + ks * kBLd + wc + 16 * f, kBLd);
        wmma::mma_sync(acc[f], a, bm, acc[f]);
      }
    }
    __syncthreads();
  }
  stage_acc(acc, stage, warp);
  __syncthreads();
  float* out = part + ((size_t)s * 10 + q) * Ch * Co;
  for (int e = tid; e < kT * kT; e += kThreads) {
    const int mm = e / kT, n = e % kT;
    if (ci0 + mm < Ch && co0 + n < Co)
      out[(size_t)(ci0 + mm) * Co + co0 + n] = stage[mm * kCLd + n];
  }
}

}  // namespace tc

int grid_for(size_t total) {
  const size_t blocks = (total + kThreads - 1) / kThreads;
  return (int)(blocks < 132 * 64 ? (blocks ? blocks : 1) : 132 * 64);
}

template <typename T>
cudaError_t launch(const void* x_, const void* g_, const float* w1t,
                   const float* w2t, void* dx_, float* dw1, float* dw2,
                   float* M, unsigned char* idx, float* dM, float* dA1,
                   void* avg1, float* part, int B, int H, int W, int Cin,
                   int Cout, int S, cudaStream_t stream) {
  const T* x = static_cast<const T*>(x_);
  const T* g = static_cast<const T*>(g_);
  T* dx = static_cast<T*>(dx_);
  const int Ch = Cin / 2, Co = Cout / 2;
  const int Ho = H / 2, Wo = W / 2, HA = H - 1, WA = W - 1;
  const long long N = (long long)B * Ho * Wo;
  const bool tensor_cores = std::is_same<T, __nv_bfloat16>::value &&
                            Ch % 8 == 0 && Co % 8 == 0;
  const auto* xb = reinterpret_cast<const tc::bf16*>(x_);
  const auto* gb = reinterpret_cast<const tc::bf16*>(g_);
  auto* ab = static_cast<tc::bf16*>(avg1);
  cudaError_t err;

  pool_argmax<T><<<grid_for((size_t)N * Ch), kThreads, 0, stream>>>(
      x, M, idx, B, H, W, Cin, Ho, Wo);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const int ci_tiles = ceil_div(Ch, kT), co_tiles = ceil_div(Co, kT);
  dim3 g_dm((unsigned)((N + kT - 1) / kT), ci_tiles);
  gemm_dm<T><<<g_dm, kThreads, 0, stream>>>(g, w2t, dM, N, Co, Ch);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const int tiles_i = ceil_div(ceil_div(HA, 2), 8);
  const int tiles_j = ceil_div(ceil_div(WA, 2), 8);
  dim3 g_da(tiles_i * tiles_j, 4 * ci_tiles, B);
  if (tensor_cores)
    tc::gemm_da1_wmma<<<g_da, kThreads, 0, stream>>>(
        gb, w1t, dA1, Ho, Wo, HA, WA, Co, Ch, tiles_j, ci_tiles);
  else
    gemm_da1<T><<<g_da, kThreads, 0, stream>>>(g, w1t, dA1, Ho, Wo, HA, WA,
                                               Co, Ch, tiles_j, ci_tiles);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  adown_dx<T><<<grid_for((size_t)B * H * W * Cin), kThreads, 0, stream>>>(
      dA1, dM, idx, dx, B, H, W, Cin, Ho, Wo);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const long long slab = (N + S - 1) / S;
  dim3 g_dw(S, 10, ci_tiles * co_tiles);
  if (tensor_cores) {
    tc::avg_bf16<<<grid_for((size_t)B * HA * WA * Ch), kThreads, 0,
                   stream>>>(xb, ab, B, H, W, Cin);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    tc::gemm_dw_wmma<<<g_dw, kThreads, 0, stream>>>(
        ab, gb, M, part, H, W, Cin, Ho, Wo, Co, (int)N, (int)slab, co_tiles);
  } else
    gemm_dw<T><<<g_dw, kThreads, 0, stream>>>(x, g, M, part, H, W, Cin, Ho,
                                              Wo, Co, N, slab, co_tiles);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  dw_reduce<<<grid_for((size_t)10 * Ch * Co), kThreads, 0, stream>>>(
      part, dw1, dw2, S, Ch, Co);
  return cudaGetLastError();
}

}  // namespace
}  // namespace yolo

// x (B, H, W, Cin) and g (B, H/2, W/2, Cout) NHWC in one dtype; w1t
// (9, Cout/2, Cin/2) and w2t (Cout/2, Cin/2) f32 (tap-major, as the wrapper
// permutes them); dx like x; dw1 (Cout/2, Cin/2, 3, 3), dw2 (Cout/2, Cin/2)
// f32. Scratch, all allocated by the wrapper: M and dM (B, H/2, W/2, Cin/2)
// f32, idx the same in uint8, dA1 (B, H-1, W-1, Cin/2) f32, avg1 the
// same in bf16 (bf16 x only; may be null for f32), part
// (S, 10, Cin/2, Cout/2) f32. Cin and Cout even, H and W >= 2,
// 1 <= S <= B*(H/2)*(W/2) < 2^31, 16-byte aligned tensors (checked by the
// Python wrapper).
extern "C" int yolo_adown_bwd(const void* x, const void* g, const void* w1t,
                              const void* w2t, void* dx, void* dw1, void* dw2,
                              void* M, void* idx, void* dM, void* dA1,
                              void* avg1, void* part, int B, int H, int W,
                              int Cin, int Cout, int S, int dtype,
                              void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto f = [](void* p) { return static_cast<float*>(p); };
  auto cf = [](const void* p) { return static_cast<const float*>(p); };
  auto* i8 = static_cast<unsigned char*>(idx);
  if (dtype == yolo::kBFloat16)
    return yolo::launch<__nv_bfloat16>(x, g, cf(w1t), cf(w2t), dx, f(dw1),
                                       f(dw2), f(M), i8, f(dM), f(dA1), avg1,
                                       f(part), B, H, W, Cin, Cout, S, s);
  return yolo::launch<float>(x, g, cf(w1t), cf(w2t), dx, f(dw1), f(dw2),
                             f(M), i8, f(dM), f(dA1), avg1, f(part), B, H, W,
                             Cin, Cout, S, s);
}
