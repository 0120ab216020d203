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
// maxpool branch -inf.
//
// What bounds it on an H100: at gelan-c's down1, (32, 160, 160, 256) ->
// (32, 80, 80, 256), it reads 420 MB and does about 67 GFLOP (60 of them in
// the 3x3 branch), ~160 FLOP per byte. On the CUDA cores (67 TFLOP/s f32)
// that is arithmetic-bound; on the tensor cores it would be memory-bound
// (0.13 ms of bytes against 0.07 ms of bf16 products), so there the limit
// is how fast shared memory feeds the products.
//
// Design: the stride-1 avgpool intermediate never goes to device memory.
// A block owns a tile of output pixels and 64 output channels of ONE
// branch. For each chunk of 16 input channels it
//   1. forms the avg patch the tile needs (output pixel o reads avg pixels
//      2o-1 .. 2o+1) in shared memory from four global reads each, with 0
//      (branch 1) or -inf (branch 2) outside the avg domain;
//   2. stages the chunk's weights in shared memory (given input-channel
//      major by the wrapper, so a row of output channels is contiguous);
//   3. branch 1: accumulates the 9 taps of the 3x3 stride-2 product;
//      branch 2: writes the 3x3 max of each (pixel, channel) to shared
//      memory, then accumulates the 1x1 product.
// The /4 of the average is applied to each window sum (exact in binary
// floating point, like the TPU kernel's folding into the weights). The
// epilogue adds the bias, applies SiLU in f32 and writes the branch's
// channel slice of the concatenated output.
//
// Two variants of that design:
// - bf16 with Cin and Cout multiples of 16 (every ADown of gelan-c and of
//   the tiny test model): the products run on the tensor cores through
//   nvcuda::wmma 16x16x16 bf16 fragments with f32 accumulators. The tile is
//   8 output rows x 16 output columns, one warp per row (the wmma M
//   dimension is the row's 16 pixels), and 4 N fragments of 16 channels.
//   For tap (ky, kx) the A fragment of a row is read straight from the bf16
//   avg patch with a leading dimension of two pixels (the stride of 2), so
//   no im2col copy is made. The avg patch and the weights are filled with
//   16-byte loads of 8 channels; weight rows are padded to 72 channels so
//   the B-fragment loads do not share banks. The avg is rounded to bf16
//   before the product, as the JAX package's bf16 graph rounds it. The
//   epilogue goes through shared memory so each thread writes consecutive
//   channels.
// - everything else (f32; bf16 with other channel counts): CUDA cores, an
//   8x8-pixel tile and a 4-pixel x 4-channel f32 register tile per thread.
// wgmma, TMA and a swizzled layout for the A loads are later work.
//
// The same kernels give the pre-BN train forward (yolo_adown_raw, replacing
// adown_from_packed(raw=True) of the TPU kernel): raw = 1 skips the bias
// and the SiLU. Its backward is csrc/adown_bwd.cu.
#include <mma.h>

#include "common.cuh"

namespace yolo {
namespace {

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
    // 2. weights of the chunk, f32, [tap][ci][co]; zero past Ch / Co
    if (branch == 0) {
      for (int e = tid; e < kW1Floats; e += kThreads) {
        const int co = e % kCoT, kt = e / kCoT;
        const int k = kt / 9, tap = kt % 9;
        const int gco = co0 + co, gci = ci0 + k;
        float v = 0.0f;
        if (gco < Co && gci < Ch) v = to_f32(w1[((size_t)gci * 9 + tap) * Co + gco]);
        w_s[(tap * kCK + k) * kCoT + co] = v;
      }
    } else {
      for (int e = tid; e < kCK * kCoT; e += kThreads) {
        const int co = e % kCoT, k = e / kCoT;
        const int gco = co0 + co, gci = ci0 + k;
        float v = 0.0f;
        if (gco < Co && gci < Ch) v = to_f32(w2[(size_t)gci * Co + gco]);
        w_s[k * kCoT + co] = v;
      }
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
// bf16 tensor-core variant (Cin % 16 == 0 and Cout % 16 == 0)
// ---------------------------------------------------------------------------

namespace tc {

using namespace nvcuda;

constexpr int kTR = 8;                   // output rows per block, one per warp
constexpr int kTC = 16;                  // output columns per block (wmma M)
constexpr int kPR = 2 * kTR + 1;         // avg patch rows
constexpr int kPC = 2 * kTC + 1;         // avg patch columns
constexpr int kCK = 16;                  // input channels per chunk (wmma K)
constexpr int kCoT = 64;                 // output channels per block
constexpr int kNF = kCoT / 16;           // wmma N fragments per warp
// weight rows padded by 8 channels (16 bytes): with a 128-byte row stride
// the 8 rows a B-fragment load touches would share banks 8 ways
constexpr int kWLd = kCoT + 8;
constexpr int kThreads = 32 * kTR;

constexpr int kAvgElems = kPR * kPC * kCK;
constexpr int kWElems = 9 * kCK * kWLd;
constexpr int kMaxElems = kTR * kTC * kCK;
constexpr int kStageFloats = kTR * kTC * kCoT;
constexpr int kSmemBytes = 2 * (kAvgElems + kWElems + kMaxElems);
static_assert(kStageFloats * 4 <= kSmemBytes, "epilogue staging fits");

using bf16 = __nv_bfloat16;

__device__ __forceinline__ void add8(float* acc, uint4 v) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    acc[2 * i] += f.x;
    acc[2 * i + 1] += f.y;
  }
}

// kRaw is a template parameter, not an argument: as a run-time flag its
// branch took the kernel from 128 to 135 registers, one 256-thread block per
// SM instead of two, and a third of its speed on an H100.
template <bool kRaw>
__global__ void __launch_bounds__(kThreads)
adown_wmma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w1,
                  const bf16* __restrict__ b1, const bf16* __restrict__ w2,
                  const bf16* __restrict__ b2, bf16* __restrict__ y, int H,
                  int W, int Cin, int Cout, int Ho, int Wo, int tiles_w,
                  int co_tiles) {
  __shared__ __align__(128) unsigned char tc_smem[kSmemBytes];
  bf16* avg_s = reinterpret_cast<bf16*>(tc_smem);    // [kPR][kPC][kCK]
  bf16* w_s = avg_s + kAvgElems;                      // [tap][kCK][kWLd]
  bf16* max_s = w_s + kWElems;                        // [kTR*kTC][kCK]
  float* stage = reinterpret_cast<float*>(tc_smem);   // epilogue, reuses all

  const int Ch = Cin / 2, Co = Cout / 2;
  const int oy0 = (blockIdx.x / tiles_w) * kTR;
  const int ox0 = (blockIdx.x % tiles_w) * kTC;
  const int branch = blockIdx.y / co_tiles;
  const int co0 = (blockIdx.y % co_tiles) * kCoT;
  const int b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32;
  const bf16 pad = __float2bfloat16(branch == 0 ? 0.0f : -CUDART_INF_F);
  const bf16 zero = __float2bfloat16(0.0f);
  const bf16* xb = x + (size_t)b * H * W * Cin + branch * Ch;
  const size_t row = (size_t)W * Cin;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[kNF];
#pragma unroll
  for (int n = 0; n < kNF; ++n) wmma::fill_fragment(acc[n], 0.0f);

  for (int ci0 = 0; ci0 < Ch; ci0 += kCK) {
    // 1. bf16 avg patch, 8 channels (16 bytes) per item
    for (int e = tid; e < kPR * kPC * (kCK / 8); e += kThreads) {
      const int half = e % 2, rc = e / 2;
      const int r = rc / kPC, c = rc % kPC;
      const int ay = 2 * oy0 - 1 + r, ax = 2 * ox0 - 1 + c;
      const int ch = ci0 + 8 * half;
      __align__(16) bf16 v[8];
      if (ch >= Ch) {
#pragma unroll
        for (int i = 0; i < 8; ++i) v[i] = zero;
      } else if (ay >= 0 && ay <= H - 2 && ax >= 0 && ax <= W - 2) {
        const bf16* p = xb + ((size_t)ay * W + ax) * Cin + ch;
        float s[8] = {0, 0, 0, 0, 0, 0, 0, 0};
        float t[8] = {0, 0, 0, 0, 0, 0, 0, 0};
        add8(s, *reinterpret_cast<const uint4*>(p));
        add8(s, *reinterpret_cast<const uint4*>(p + Cin));
        add8(t, *reinterpret_cast<const uint4*>(p + row));
        add8(t, *reinterpret_cast<const uint4*>(p + row + Cin));
#pragma unroll
        for (int i = 0; i < 8; ++i) v[i] = __float2bfloat16(0.25f * (s[i] + t[i]));
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i) v[i] = pad;
      }
      *reinterpret_cast<uint4*>(avg_s + rc * kCK + 8 * half) =
          *reinterpret_cast<const uint4*>(v);
    }
    // 2. weights of the chunk, [tap][ci][co], 8 channels (16 bytes) per
    //    item from the (ci, tap, co) layout; zero past Ch / Co
    if (branch == 0) {
      for (int e = tid; e < kCK * 9 * (kCoT / 8); e += kThreads) {
        const int v8 = e % (kCoT / 8), kt = e / (kCoT / 8);
        const int k = kt / 9, tap = kt % 9;
        const int gco = co0 + 8 * v8, gci = ci0 + k;
        uint4 v = make_uint4(0, 0, 0, 0);
        if (gco < Co && gci < Ch)
          v = *reinterpret_cast<const uint4*>(w1 + ((size_t)gci * 9 + tap) * Co + gco);
        *reinterpret_cast<uint4*>(w_s + (tap * kCK + k) * kWLd + 8 * v8) = v;
      }
    } else {
      for (int e = tid; e < kCK * (kCoT / 8); e += kThreads) {
        const int v8 = e % (kCoT / 8), k = e / (kCoT / 8);
        const int gco = co0 + 8 * v8, gci = ci0 + k;
        uint4 v = make_uint4(0, 0, 0, 0);
        if (gco < Co && gci < Ch)
          v = *reinterpret_cast<const uint4*>(w2 + (size_t)gci * Co + gco);
        *reinterpret_cast<uint4*>(w_s + k * kWLd + 8 * v8) = v;
      }
    }
    __syncthreads();

    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
    wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bm;
    if (branch == 0) {
      // 3a. row `warp`: A(m = column, k = channel) at avg pixel
      //     (2*warp + ky, 2*m + kx): leading dimension 2 pixels
#pragma unroll
      for (int ky = 0; ky < 3; ++ky) {
#pragma unroll
        for (int kx = 0; kx < 3; ++kx) {
          wmma::load_matrix_sync(
              a, avg_s + ((2 * warp + ky) * kPC + kx) * kCK, 2 * kCK);
#pragma unroll
          for (int n = 0; n < kNF; ++n) {
            wmma::load_matrix_sync(
                bm, w_s + (3 * ky + kx) * kCK * kWLd + 16 * n, kWLd);
            wmma::mma_sync(acc[n], a, bm, acc[n]);
          }
        }
      }
    } else {
      // 3b. maxpool(3, 2, 1) into max_s, then the 1x1 product
      for (int e = tid; e < kMaxElems; e += kThreads) {
        const int k = e % kCK, p = e / kCK;
        const int r = p / kTC, c = p % kTC;
        float m = -CUDART_INF_F;
#pragma unroll
        for (int ky = 0; ky < 3; ++ky)
#pragma unroll
          for (int kx = 0; kx < 3; ++kx)
            m = fmaxf(m, __bfloat162float(
                             avg_s[((2 * r + ky) * kPC + 2 * c + kx) * kCK + k]));
        // a pixel outside the output has an all -inf window: keep it finite
        max_s[e] = (oy0 + r < Ho && ox0 + c < Wo) ? __float2bfloat16(m) : zero;
      }
      __syncthreads();
      wmma::load_matrix_sync(a, max_s + warp * kTC * kCK, kCK);
#pragma unroll
      for (int n = 0; n < kNF; ++n) {
        wmma::load_matrix_sync(bm, w_s + 16 * n, kWLd);
        wmma::mma_sync(acc[n], a, bm, acc[n]);
      }
    }
    __syncthreads();
  }

  // epilogue: fragments -> shared f32 [pixel][co] -> bias, SiLU, bf16 out
#pragma unroll
  for (int n = 0; n < kNF; ++n)
    wmma::store_matrix_sync(stage + warp * kTC * kCoT + 16 * n, acc[n], kCoT,
                            wmma::mem_row_major);
  __syncthreads();
  const bf16* bias = branch == 0 ? b1 : b2;
  for (int e = tid; e < kStageFloats; e += kThreads) {
    const int co = e % kCoT, p = e / kCoT;
    const int oy = oy0 + p / kTC, ox = ox0 + p % kTC, gco = co0 + co;
    if (oy < Ho && ox < Wo && gco < Co)
      y[(((size_t)b * Ho + oy) * Wo + ox) * Cout + branch * Co + gco] =
          __float2bfloat16(kRaw ? stage[e]
                                : silu(stage[e] + __bfloat162float(bias[gco])));
  }
}

cudaError_t launch_wmma(const void* x, const void* w1, const void* b1,
                        const void* w2, const void* b2, void* y, int B, int H,
                        int W, int Cin, int Cout, int raw,
                        cudaStream_t stream) {
  const int Ho = H / 2, Wo = W / 2;
  const int tiles_w = ceil_div(Wo, kTC), tiles_h = ceil_div(Ho, kTR);
  const int co_tiles = ceil_div(Cout / 2, kCoT);
  dim3 grid(tiles_w * tiles_h, 2 * co_tiles, B);
  auto kernel = raw ? adown_wmma_kernel<true> : adown_wmma_kernel<false>;
  kernel<<<grid, kThreads, 0, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w1),
      static_cast<const bf16*>(b1), static_cast<const bf16*>(w2),
      static_cast<const bf16*>(b2), static_cast<bf16*>(y), H, W, Cin, Cout,
      Ho, Wo, tiles_w, co_tiles);
  return cudaGetLastError();
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
    return tc::launch_wmma(x, w1, b1, w2, b2, y, B, H, W, Cin, Cout, raw, s);
  if (dtype == kBFloat16)
    return launch<__nv_bfloat16>(x, w1, b1, w2, b2, y, B, H, W, Cin, Cout,
                                 raw, s);
  return launch<float>(x, w1, b1, w2, b2, y, B, H, W, Cin, Cout, raw, s);
}

}  // namespace
}  // namespace yolo

// x (B, H, W, Cin) NHWC; w1 (Cin/2, 3, 3, Cout/2) and w2 (Cin/2, Cout/2),
// input channel major (the wrapper permutes the OIHW weights); b1, b2
// (Cout/2,); y (B, H/2, W/2, Cout) NHWC. Cin, Cout even,
// H, W >= 2, x 16-byte aligned (checked by the Python wrapper).
extern "C" int yolo_adown(const void* x, const void* w1, const void* b1,
                          const void* w2, const void* b2, void* y, int B,
                          int H, int W, int Cin, int Cout, int dtype,
                          void* stream) {
  return yolo::dispatch(x, w1, b1, w2, b2, y, B, H, W, Cin, Cout, dtype, 0,
                        static_cast<cudaStream_t>(stream));
}

// The pre-BN train forward (kernel 5): both branches without bias and
// SiLU, in x's dtype rounded once from the f32 accumulator. Same layouts
// and constraints as yolo_adown.
extern "C" int yolo_adown_raw(const void* x, const void* w1, const void* w2,
                              void* y, int B, int H, int W, int Cin, int Cout,
                              int dtype, void* stream) {
  return yolo::dispatch(x, w1, nullptr, w2, nullptr, y, B, H, W, Cin, Cout,
                        dtype, 1, static_cast<cudaStream_t>(stream));
}
