// The RepNCSP bottleneck chain, n bottlenecks in one kernel (inference, BN
// and RepConv folded), at 32 channels:
//
//   r = m
//   for i in 0 .. n-1:
//     t = SiLU(conv3x3_s1_p1(r; w1[i]) + b1[i])     rounded to the dtype
//     t = SiLU(conv3x3_s1_p1(t; w2[i]) + b2[i])     rounded to the dtype
//     r = r + t                                     in the dtype
//   out = r                                         m, out (B, H, W, 32) NHWC
//
// Replaces the TPU kernel yolo_re_tpu/ops/pallas/csp_chain_kernel.py
// (bottleneck_chain). Its p=4 width packing and the wm/wz parity matrices
// exist only to fill the TPU's 128 lanes and are not ported; neither is its
// Wq % 8 / row-block gate: input and output here are plain NHWC
// (channels_last), any H and W, 1 <= n <= 4. The rounding points are that
// kernel's (csp_chain_kernel.py:206-215), and so is the rule that makes a
// tile right at the image border: every intermediate position outside the
// image is set to zero after its SiLU, rows and columns alike, because the
// next conv reads it as zero padding (SiLU(bias) there is not zero).
//
// What bounds it on an H100: at gelan-c's stage1, (32, 160, 160, 32) bf16
// and n = 1, it reads 52.4 MB and writes 52.4 MB (0.031 ms at 3.35 TB/s)
// and does 30.2 GFLOP (0.031 ms at 989 TFLOP/s); bytes and products bound it
// about evenly, and each further bottleneck adds 30.2 GFLOP and no bytes.
// So no intermediate goes to device memory.
//
// Design: one block per T x T output tile (T = 16; 8 for f32 at n >= 3,
// where the buffers would not fit). The block loads the tile and its halo of
// 2n pixels on each side, a Wb x Wb frame (Wb = T + 4n), once into shared
// memory buffer R (zero outside the image). Conv k of the 2n (k = 1 .. 2n)
// computes its outputs over the frame's inner square [k, Wb - k): conv 1 of
// a bottleneck from R into buffer Tb, conv 2 from Tb back into R, adding the
// residual in place. The weights of one conv (9 x 32 x 32) are staged in
// shared memory before it runs. The frame's centre T x T of R is the output.
// The halo costs redundant products: at n = 1 the two convs compute 18^2 +
// 16^2 pixels per 16^2 outputs, 1.13x the work.
// - bf16: tensor cores through nvcuda::wmma 16x16x16 bf16 fragments with
//   f32 accumulators. An M fragment is 16 consecutive pixels of the frame in
//   row-major order, whole rows of Wb included ("implicit GEMM" over the
//   flat frame): tap (ky, kx) of all 16 reads the input buffer at one flat
//   offset (ky - 1) * Wb + (kx - 1), so the A fragment is read in place with
//   a 32-channel leading dimension. Pixels outside the conv's square (the
//   wrapped columns) are computed and thrown away; the buffers carry a
//   margin of Wb + 1 pixels before and 2 * Wb + 31 after the frame for
//   those reads. The bias is added to the f32 accumulator, then SiLU, the
//   mask and one rounding to bf16, through a per-warp staging area where
//   lane l owns channel l.
// - f32: CUDA cores; each thread a 4-pixel x 4-channel register tile of the
//   conv's square, the buffers padded to 33 floats per pixel against bank
//   conflicts.
// Double buffering of the weights, TMA and wgmma are later work.
#include <mma.h>

#include "common.cuh"

namespace yolo {
namespace {

constexpr int kC = 32;                 // channels of the chain
constexpr int kMaxN = 4;
constexpr int kMaxSmem = 232448;       // an H100 block's shared memory
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// ---------------------------------------------------------------------------
// bf16 tensor-core variant
// ---------------------------------------------------------------------------

namespace tc {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

constexpr int kWLd = kC + 8;           // padded weight row (bank conflicts)
constexpr int kWElems = 9 * kC * kWLd;
constexpr int kStageFloats = 16 * kC;  // one M fragment per warp

__host__ __device__ inline int buffer_pixels(int Wb) {
  return Wb * Wb + 2 * Wb + 32;
}

inline size_t smem_bytes(int Wb) {
  return (size_t)2 * buffer_pixels(Wb) * kC * sizeof(bf16) +
         kWElems * sizeof(bf16) + (size_t)kWarps * kStageFloats * 4;
}

__global__ void __launch_bounds__(kThreads)
chain_wmma_kernel(const bf16* __restrict__ m, const bf16* __restrict__ wt,
                  const bf16* __restrict__ bias, bf16* __restrict__ out,
                  int H, int W, int n, int T, int tiles_w) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int Wb = T + 4 * n, nb = buffer_pixels(Wb), org = Wb + 1;
  bf16* R = reinterpret_cast<bf16*>(smem);           // [nb][kC]
  bf16* Tb = R + nb * kC;                              // [nb][kC]
  bf16* w_s = Tb + nb * kC;                            // [tap][ci][kWLd]
  float* stage = reinterpret_cast<float*>(w_s + kWElems);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int halo = 2 * n;
  // image coordinates of frame pixel (0, 0)
  const int fy0 = (blockIdx.x / tiles_w) * T - halo;
  const int fx0 = (blockIdx.x % tiles_w) * T - halo;
  const int b = blockIdx.y;
  const bf16* mb = m + (size_t)b * H * W * kC;
  const bf16 zero = __float2bfloat16(0.0f);

  // the frame, 8 channels (16 bytes) per item; zero outside the image
  for (int e = tid; e < Wb * Wb * (kC / 8); e += kThreads) {
    const int q = e % (kC / 8), g = e / (kC / 8);
    const int iy = fy0 + g / Wb, ix = fx0 + g % Wb;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (iy >= 0 && iy < H && ix >= 0 && ix < W)
      v = *reinterpret_cast<const uint4*>(mb + ((size_t)iy * W + ix) * kC +
                                          8 * q);
    *reinterpret_cast<uint4*>(R + (org + g) * kC + 8 * q) = v;
  }

  float* st = stage + warp * kStageFloats;
  for (int i = 0; i < n; ++i) {
    for (int conv = 0; conv < 2; ++conv) {
      const bf16* src = conv == 0 ? R : Tb;
      bf16* dst = conv == 0 ? Tb : R;
      const int lo = 2 * i + conv + 1, hi = Wb - lo;   // output square
      __syncthreads();      // the frame is loaded / the last conv is done
      const bf16* wg = wt + (size_t)(2 * i + conv) * 9 * kC * kC;
      for (int e = tid; e < 9 * kC * (kC / 8); e += kThreads) {
        const int v8 = e % (kC / 8), row = e / (kC / 8);   // row = tap*kC+ci
        *reinterpret_cast<uint4*>(w_s + row * kWLd + 8 * v8) =
            *reinterpret_cast<const uint4*>(wg + (size_t)row * kC + 8 * v8);
      }
      __syncthreads();
      const float bl = __bfloat162float(bias[(2 * i + conv) * kC + lane]);
      const int end = hi * Wb;                             // flat, exclusive
      const int nfrag = ceil_div((hi - lo) * Wb, 16);
      for (int f = warp; f < nfrag; f += kWarps) {
        const int g0 = lo * Wb + 16 * f;
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2];
        wmma::fill_fragment(acc[0], 0.0f);
        wmma::fill_fragment(acc[1], 0.0f);
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bm;
#pragma unroll
        for (int tap = 0; tap < 9; ++tap) {
          const int off = (tap / 3 - 1) * Wb + (tap % 3 - 1);
#pragma unroll
          for (int kh = 0; kh < 2; ++kh) {
            wmma::load_matrix_sync(a, src + (org + g0 + off) * kC + 16 * kh,
                                   kC);
#pragma unroll
            for (int nf = 0; nf < 2; ++nf) {
              wmma::load_matrix_sync(
                  bm, w_s + (tap * kC + 16 * kh) * kWLd + 16 * nf, kWLd);
              wmma::mma_sync(acc[nf], a, bm, acc[nf]);
            }
          }
        }
        wmma::store_matrix_sync(st, acc[0], kC, wmma::mem_row_major);
        wmma::store_matrix_sync(st + 16, acc[1], kC, wmma::mem_row_major);
        __syncwarp();
        // lane = channel; bias, SiLU, the out-of-square / out-of-image
        // mask and the rounding; conv 2 adds the residual in place
        for (int p = 0; p < 16 && g0 + p < end; ++p) {
          const int g = g0 + p, Y = g / Wb, X = g % Wb;
          const bool in_square = X >= lo && X < hi;
          const bool in_image = fy0 + Y >= 0 && fy0 + Y < H &&
                                fx0 + X >= 0 && fx0 + X < W;
          bf16* d = dst + (org + g) * kC + lane;
          const bf16 t = __float2bfloat16(silu(st[p * kC + lane] + bl));
          if (conv == 0) {
            *d = in_square && in_image ? t : zero;
          } else if (in_square) {
            *d = in_image
                     ? __float2bfloat16(__bfloat162float(*d) +
                                        __bfloat162float(t))
                     : zero;
          }
        }
        __syncwarp();
      }
    }
  }
  __syncthreads();

  // the frame's centre T x T is the output tile
  for (int e = tid; e < T * T * (kC / 8); e += kThreads) {
    const int q = e % (kC / 8), p = e / (kC / 8);
    const int y = p / T, x = p % T;
    const int iy = fy0 + halo + y, ix = fx0 + halo + x;
    if (iy < H && ix < W)
      *reinterpret_cast<uint4*>(out + (((size_t)b * H + iy) * W + ix) * kC +
                                8 * q) =
          *reinterpret_cast<const uint4*>(
              R + (org + (halo + y) * Wb + halo + x) * kC + 8 * q);
  }
}

}  // namespace tc

// ---------------------------------------------------------------------------
// f32 CUDA-core variant
// ---------------------------------------------------------------------------

namespace f32 {

constexpr int kCS = kC + 1;            // buffer floats per pixel (banks)

inline size_t smem_bytes(int Wb) {
  return (size_t)2 * Wb * Wb * kCS * sizeof(float) +
         (size_t)9 * kC * kC * sizeof(float);
}

__global__ void __launch_bounds__(kThreads)
chain_f32_kernel(const float* __restrict__ m, const float* __restrict__ wt,
                 const float* __restrict__ bias, float* __restrict__ out,
                 int H, int W, int n, int T, int tiles_w) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int Wb = T + 4 * n;
  float* R = reinterpret_cast<float*>(smem);          // [Wb*Wb][kCS]
  float* Tb = R + Wb * Wb * kCS;                       // [Wb*Wb][kCS]
  float* w_s = Tb + Wb * Wb * kCS;                     // [tap][ci][co]

  const int tid = threadIdx.x;
  const int cg = tid % 8, q = tid / 8;                 // 4 channels, group
  const int halo = 2 * n;
  const int fy0 = (blockIdx.x / tiles_w) * T - halo;
  const int fx0 = (blockIdx.x % tiles_w) * T - halo;
  const int b = blockIdx.y;
  const float* mb = m + (size_t)b * H * W * kC;

  for (int e = tid; e < Wb * Wb * (kC / 4); e += kThreads) {
    const int c4 = e % (kC / 4), g = e / (kC / 4);
    const int iy = fy0 + g / Wb, ix = fx0 + g % Wb;
    float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (iy >= 0 && iy < H && ix >= 0 && ix < W)
      v = *reinterpret_cast<const float4*>(mb + ((size_t)iy * W + ix) * kC +
                                           4 * c4);
    float* d = R + g * kCS + 4 * c4;
    d[0] = v.x; d[1] = v.y; d[2] = v.z; d[3] = v.w;
  }

  for (int i = 0; i < n; ++i) {
    for (int conv = 0; conv < 2; ++conv) {
      const float* src = conv == 0 ? R : Tb;
      float* dst = conv == 0 ? Tb : R;
      const int lo = 2 * i + conv + 1, S = Wb - 2 * lo;   // square [lo, lo+S)
      __syncthreads();
      const float* wg = wt + (size_t)(2 * i + conv) * 9 * kC * kC;
      for (int e = tid; e < 9 * kC * kC / 4; e += kThreads)
        reinterpret_cast<float4*>(w_s)[e] =
            reinterpret_cast<const float4*>(wg)[e];
      __syncthreads();
      const float4 bv = *reinterpret_cast<const float4*>(
          bias + (2 * i + conv) * kC + 4 * cg);
      const int npos = S * S;
      for (int g4 = q; 4 * g4 < npos; g4 += kThreads / 8) {
        int base[4];                       // input pixel of tap (0, 0)
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          const int idx = min(4 * g4 + s, npos - 1);
          base[s] = (lo + idx / S - 1) * Wb + lo + idx % S - 1;
        }
        float acc[4][4];
#pragma unroll
        for (int s = 0; s < 4; ++s)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[s][j] = 0.0f;
#pragma unroll
        for (int tap = 0; tap < 9; ++tap) {
          const int off = (tap / 3) * Wb + tap % 3;
          const float* wtap = w_s + tap * kC * kC + 4 * cg;
#pragma unroll 4
          for (int ci = 0; ci < kC; ++ci) {
            const float4 wv = *reinterpret_cast<const float4*>(wtap + ci * kC);
#pragma unroll
            for (int s = 0; s < 4; ++s) {
              const float a = src[(base[s] + off) * kCS + ci];
              acc[s][0] += a * wv.x; acc[s][1] += a * wv.y;
              acc[s][2] += a * wv.z; acc[s][3] += a * wv.w;
            }
          }
        }
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          const int idx = 4 * g4 + s;
          if (idx >= npos) break;
          const int Y = lo + idx / S, X = lo + idx % S;
          const bool in_image = fy0 + Y >= 0 && fy0 + Y < H &&
                                fx0 + X >= 0 && fx0 + X < W;
          float* d = dst + (Y * Wb + X) * kCS + 4 * cg;
          const float t[4] = {silu(acc[s][0] + bv.x), silu(acc[s][1] + bv.y),
                              silu(acc[s][2] + bv.z), silu(acc[s][3] + bv.w)};
#pragma unroll
          for (int j = 0; j < 4; ++j)
            d[j] = in_image ? (conv == 0 ? t[j] : d[j] + t[j]) : 0.0f;
        }
      }
    }
  }
  __syncthreads();

  for (int e = tid; e < T * T * (kC / 4); e += kThreads) {
    const int c4 = e % (kC / 4), p = e / (kC / 4);
    const int y = p / T, x = p % T;
    const int iy = fy0 + halo + y, ix = fx0 + halo + x;
    if (iy < H && ix < W) {
      const float* s = R + ((halo + y) * Wb + halo + x) * kCS + 4 * c4;
      *reinterpret_cast<float4*>(out + (((size_t)b * H + iy) * W + ix) * kC +
                                 4 * c4) = make_float4(s[0], s[1], s[2], s[3]);
    }
  }
}

}  // namespace f32

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, bool& done) {
  if (done) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  done = e == cudaSuccess;
  return e;
}

cudaError_t launch(const void* m, const void* wt, const void* bias, void* out,
                   int B, int H, int W, int n, int dtype,
                   cudaStream_t stream) {
  if (n < 1 || n > kMaxN) return cudaErrorInvalidValue;
  if (dtype == kBFloat16) {
    static bool ready = false;
    cudaError_t e = allow_smem(tc::chain_wmma_kernel, ready);
    if (e != cudaSuccess) return e;
    const int T = 16;
    const int tiles_w = ceil_div(W, T);
    dim3 grid(tiles_w * ceil_div(H, T), B);
    tc::chain_wmma_kernel<<<grid, kThreads, tc::smem_bytes(T + 4 * n),
                            stream>>>(
        static_cast<const __nv_bfloat16*>(m),
        static_cast<const __nv_bfloat16*>(wt),
        static_cast<const __nv_bfloat16*>(bias),
        static_cast<__nv_bfloat16*>(out), H, W, n, T, tiles_w);
    return cudaGetLastError();
  }
  static bool ready = false;
  cudaError_t e = allow_smem(f32::chain_f32_kernel, ready);
  if (e != cudaSuccess) return e;
  const int T = f32::smem_bytes(16 + 4 * n) <= (size_t)kMaxSmem ? 16 : 8;
  const int tiles_w = ceil_div(W, T);
  dim3 grid(tiles_w * ceil_div(H, T), B);
  f32::chain_f32_kernel<<<grid, kThreads, f32::smem_bytes(T + 4 * n),
                          stream>>>(
      static_cast<const float*>(m), static_cast<const float*>(wt),
      static_cast<const float*>(bias), static_cast<float*>(out), H, W, n, T,
      tiles_w);
  return cudaGetLastError();
}

}  // namespace
}  // namespace yolo

// m, out (B, H, W, 32) NHWC; wt (n, 2, 3, 3, 32, 32) [bottleneck][conv]
// [ky][kx][ci][co] (the wrapper permutes the OIHW weights); bias (n, 2, 32);
// all of one dtype, 16-byte aligned; 1 <= n <= 4 (checked by the Python
// wrapper).
extern "C" int yolo_csp_chain(const void* m, const void* wt, const void* bias,
                              void* out, int B, int H, int W, int n,
                              int dtype, void* stream) {
  return yolo::launch(m, wt, bias, out, B, H, W, n, dtype,
                      static_cast<cudaStream_t>(stream));
}
