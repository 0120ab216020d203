// Weight gradient of the stem convolution (train):
//
//   dW[c, ci, ky, kx] = sum over (b, oy, ox) of
//                       x[b, 2*oy-1+ky, 2*ox-1+kx, ci] * g[b, oy, ox, c]
//
// with zero padding, Cin = 3, i.e. dW (C, 27) = im2col(x)^T (27, N) . g (N, C)
// over the N = B*Ho*Wo output pixels. f32 result from f32 or bf16 x and g.
//
// Replaces the TPU kernel yolo_re_tpu/ops/pallas/stem_kernel.py
// (stem_wgrad_packed, _wgrad_kernel). That kernel contracts the phase
// planes against the row-paired cotangent on the sequential TPU grid,
// carrying one f32 accumulator across grid steps. Blocks on a GPU run in
// no order, so the sum is split in two launches instead:
//   1. each block walks its share of 32-pixel tiles (tile t goes to block
//      t % blocks). Per tile it stages the pixels' input coordinates, then
//      their im2col rows (27 values) and cotangent rows (C values) in
//      shared memory as f32. A thread owns a register tile of 4 channels
//      x 7 taps and one of 256 / C pixel groups (pixel p of the tile goes
//      to group p % groups): per pixel it reads one float4 of g and 7
//      broadcast im2col values for 28 FMAs. At the end the pixel groups
//      are summed in shared memory in a fixed order and the block writes
//      its 27 x C partial sums to a (blocks, 27, C) f32 buffer;
//   2. one block per output element sums that buffer over the blocks in a
//      fixed order (strided loads, then a fixed tree).
// No float atomics: the result is the same on every run.
//
// What bounds it on an H100: at (32, 3, 640, 640) -> C = 64 it reads 78 MB
// of x and 419 MB of bf16 g (~0.15 ms of memory) for 11 GFLOP (~0.2 ms of
// f32 FMA at full rate): about balanced, with the shared-memory loads of
// the inner loop (8 per 28 FMAs) close behind. A first version (one thread
// per output element, 64-bit index arithmetic in the staging) took 12 ms.
#include "common.cuh"

namespace yolo {
namespace {

constexpr int kThreads = 256;
constexpr int kP = 32;        // output pixels per staged tile
constexpr int kMaxC = 256;
constexpr int kTaps = 7;      // taps per thread: 27 = 7 + 7 + 7 + 6

template <typename T>
__global__ void __launch_bounds__(kThreads)
wgrad_partial(const T* __restrict__ x, const T* __restrict__ g,
              float* __restrict__ part, int H, int W, int C, int Ho, int Wo,
              int N, int ntiles) {
  // g rows of the tile; after the tile loop, the pixel groups' sums
  __shared__ __align__(16) float g_s[kP * kMaxC];
  __shared__ float a_s[kP][28];          // [pixel][9*ci + 3*ky + kx]
  __shared__ int pix_s[kP][3];           // image, first input row, column

  const int tid = threadIdx.x;
  const int quads = C / 4;
  const int groups = kThreads / C;       // pixel groups (C threads each)
  const int pg = tid / C, r = tid % C;
  const int q = r % quads, kg = r / quads;
  const int k0 = kTaps * kg;
  const int nk = 27 - k0 < kTaps ? 27 - k0 : kTaps;
  const bool active = pg < groups;
  float acc[kTaps][4] = {};

  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int p0 = tile * kP;
    if (tid < kP) {
      const int p = p0 + tid;
      const int ox = p % Wo, t = p / Wo;
      pix_s[tid][0] = p < N ? t / Ho : -1;
      pix_s[tid][1] = 2 * (t % Ho) - 1;
      pix_s[tid][2] = 2 * ox - 1;
    }
    for (int e = tid; e < kP * C; e += kThreads)
      g_s[e] = p0 + e / C < N ? to_f32(g[(size_t)p0 * C + e]) : 0.0f;
    __syncthreads();
    for (int e = tid; e < kP * 27; e += kThreads) {
      const int pl = e / 27, k = e % 27;
      const int b = pix_s[pl][0];
      const int iy = pix_s[pl][1] + (k / 3) % 3, ix = pix_s[pl][2] + k % 3;
      float v = 0.0f;
      if (b >= 0 && iy >= 0 && iy < H && ix >= 0 && ix < W)
        v = to_f32(x[(((size_t)b * H + iy) * W + ix) * 3 + k / 9]);
      a_s[pl][k] = v;
    }
    __syncthreads();
    if (active) {
      for (int pl = pg; pl < kP; pl += groups) {
        const float4 gv = *reinterpret_cast<const float4*>(g_s + pl * C + 4 * q);
#pragma unroll
        for (int t = 0; t < kTaps; ++t) {
          if (t < nk) {
            const float a = a_s[pl][k0 + t];
            acc[t][0] += a * gv.x;
            acc[t][1] += a * gv.y;
            acc[t][2] += a * gv.z;
            acc[t][3] += a * gv.w;
          }
        }
      }
    }
    __syncthreads();
  }

  // sum the pixel groups in order: red[group][k][c] in g_s
  float* red = g_s;
  if (active) {
#pragma unroll
    for (int t = 0; t < kTaps; ++t)
      if (t < nk)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          red[(pg * 27 + k0 + t) * C + 4 * q + j] = acc[t][j];
  }
  __syncthreads();
  float* out = part + (size_t)blockIdx.x * 27 * C;
  for (int e = tid; e < 27 * C; e += kThreads) {
    float v = 0.0f;
    for (int grp = 0; grp < groups; ++grp) v += red[grp * 27 * C + e];
    out[e] = v;
  }
}

// dw (C, 27) OIHW; part (nblk, 27, C): one block per output element.
__global__ void __launch_bounds__(kThreads)
wgrad_reduce(const float* __restrict__ part, float* __restrict__ dw,
             int nblk, int C) {
  __shared__ float s[kThreads];
  const int n_out = 27 * C;
  const int e = blockIdx.x;               // e = k*C + c
  const int tid = threadIdx.x;
  float v = 0.0f;
  for (int b = tid; b < nblk; b += kThreads) v += part[(size_t)b * n_out + e];
  s[tid] = v;
  __syncthreads();
  for (int half = kThreads / 2; half > 0; half /= 2) {
    if (tid < half) s[tid] += s[tid + half];
    __syncthreads();
  }
  if (tid == 0) dw[(e % C) * 27 + e / C] = s[0];
}

template <typename T>
cudaError_t launch(const void* x, const void* g, float* part, float* dw,
                   int B, int H, int W, int C, int nblk, cudaStream_t stream) {
  const int Ho = (H + 1) / 2, Wo = (W + 1) / 2;
  const int N = B * Ho * Wo;
  const int ntiles = (N + kP - 1) / kP;
  wgrad_partial<T><<<nblk, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), part, H, W, C, Ho,
      Wo, N, ntiles);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  wgrad_reduce<<<27 * C, kThreads, 0, stream>>>(part, dw, nblk, C);
  return cudaGetLastError();
}

}  // namespace
}  // namespace yolo

// x (B, H, W, 3) and g (B, ceil(H/2), ceil(W/2), C) NHWC, one dtype; part
// (nblk, 27, C) f32 scratch with nblk <= ceil(B*Ho*Wo / 32); dw (C, 3, 3, 3)
// f32. C a multiple of 4 and at most 256, B*Ho*Wo below 2^31 (checked by
// the Python wrapper).
extern "C" int yolo_stem_wgrad(const void* x, const void* g, void* part,
                               void* dw, int B, int H, int W, int C, int nblk,
                               int dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto* p = static_cast<float*>(part);
  auto* d = static_cast<float*>(dw);
  if (dtype == yolo::kBFloat16)
    return yolo::launch<__nv_bfloat16>(x, g, p, d, B, H, W, C, nblk, s);
  return yolo::launch<float>(x, g, p, d, B, H, W, C, nblk, s);
}
