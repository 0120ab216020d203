// Stem convolution: y = SiLU(conv3x3_s2_p1(x) + b), Cin = 3 -> C.
//
// Replaces the TPU kernel yolo_re_tpu/ops/pallas/stem_kernel.py
// (_stem_pallas, reached through stem_conv_packed / stem_conv). That kernel's
// phase planes and row-paired output exist to dodge the TPU's 128-lane
// padding; here input and output are plain NHWC (channels_last) and the next
// layer is an ordinary convolution.
//
// What bounds it on an H100: memory. Per output pixel it reads 27 input
// values (6 bytes of new input per pixel pair in bf16) and writes C values:
// at (32, 640, 640, 3) -> C = 64 in bf16 that is 419 MB written for
// 11 GFLOP, i.e. ~26 FLOP per byte, far below the ~295 FLOP/byte where the
// tensor cores would become the limit. A K = 27 contraction is also too
// small for them to matter.
//
// Design: one block per tile of kRows output rows x kTW output pixels;
// one thread per output pixel. The block stages the 2*kRows+1 input rows it
// needs (zero padded) and the 27 x C weights in shared memory, as f32, once.
// Each thread keeps its pixel's 27 inputs in registers and walks the output
// channels in groups of 16: every weight read is a float4 that all threads
// of the warp share (a shared-memory broadcast), so the FMA pipes, not the
// load unit, set the pace. It then adds the bias, applies SiLU and stores
// the 16 channels as whole 16-byte vectors.
#include "common.cuh"

namespace yolo {
namespace {

constexpr int kTW = 64;        // output pixels per tile row
constexpr int kRows = 4;       // output rows per tile
constexpr int kThreads = kTW * kRows;
constexpr int kMaxC = 256;     // weights 27 x C f32 in shared memory
constexpr int kInRows = 2 * kRows + 1;
constexpr int kInCols = 2 * kTW + 1;
constexpr int kGroup = 16;     // output channels per register group

template <typename T>
__device__ __forceinline__ void store16(T* p, const float* v);
template <>
__device__ __forceinline__ void store16<float>(float* p, const float* v) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
    reinterpret_cast<float4*>(p)[i] =
        make_float4(v[4 * i], v[4 * i + 1], v[4 * i + 2], v[4 * i + 3]);
}
template <>
__device__ __forceinline__ void store16<__nv_bfloat16>(__nv_bfloat16* p,
                                                       const float* v) {
  __align__(16) __nv_bfloat162 h[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  reinterpret_cast<uint4*>(p)[0] = reinterpret_cast<const uint4*>(h)[0];
  reinterpret_cast<uint4*>(p)[1] = reinterpret_cast<const uint4*>(h)[1];
}

// Raw = true: the pre-BN train forward (no bias, no SiLU; bias unused).
template <typename T, bool Raw>
__global__ void __launch_bounds__(kThreads)
stem_kernel(const T* __restrict__ x, const T* __restrict__ w,
            const T* __restrict__ bias, T* __restrict__ y, int H, int W,
            int C, int Ho, int Wo) {
  __shared__ __align__(16) float w_s[27 * kMaxC];   // [9*ky + 3*kx + ci][c]
  __shared__ float b_s[kMaxC];
  __shared__ float in_s[kInRows][kInCols][3];       // [row][col][ci]

  const int ox0 = blockIdx.x * kTW, oy0 = blockIdx.y * kRows;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;

  // weights: OIHW (C, 3, 3, 3) -> [ky, kx, ci][c]
  for (int e = tid; e < 27 * C; e += kThreads) {
    const int c = e / 27, r = e % 27;      // r = 9*ci + 3*ky + kx (OIHW)
    const int ci = r / 9, ky = (r / 3) % 3, kx = r % 3;
    w_s[(9 * ky + 3 * kx + ci) * C + c] = to_f32(w[e]);
  }
  if (!Raw)
    for (int c = tid; c < C; c += kThreads) b_s[c] = to_f32(bias[c]);

  // input rows 2*oy0-1 .., cols 2*ox0-1 .., zero padded
  const T* xb = x + (size_t)b * H * W * 3;
  for (int e = tid; e < kInRows * kInCols * 3; e += kThreads) {
    const int r = e / (kInCols * 3), rem = e % (kInCols * 3);
    const int col = rem / 3, ci = rem % 3;
    const int iy = 2 * oy0 - 1 + r, ix = 2 * ox0 - 1 + col;
    float v = 0.0f;
    if (iy >= 0 && iy < H && ix >= 0 && ix < W)
      v = to_f32(xb[((size_t)iy * W + ix) * 3 + ci]);
    in_s[r][col][ci] = v;
  }
  __syncthreads();

  const int p = tid % kTW, rr = tid / kTW;
  const int ox = ox0 + p, oy = oy0 + rr;
  if (ox >= Wo || oy >= Ho) return;
  float in[27];
#pragma unroll
  for (int ky = 0; ky < 3; ++ky)
#pragma unroll
    for (int kx = 0; kx < 3; ++kx)
#pragma unroll
      for (int ci = 0; ci < 3; ++ci)
        in[9 * ky + 3 * kx + ci] = in_s[2 * rr + ky][2 * p + kx][ci];

  T* yp = y + (((size_t)b * Ho + oy) * Wo + ox) * C;
  for (int c0 = 0; c0 < C; c0 += kGroup) {
    float acc[kGroup];
#pragma unroll
    for (int j = 0; j < kGroup; ++j) acc[j] = 0.0f;
#pragma unroll
    for (int k = 0; k < 27; ++k) {
      const float4* wk = reinterpret_cast<const float4*>(&w_s[k * C + c0]);
#pragma unroll
      for (int q = 0; q < kGroup / 4; ++q) {
        const float4 wv = wk[q];
        acc[4 * q + 0] += in[k] * wv.x;
        acc[4 * q + 1] += in[k] * wv.y;
        acc[4 * q + 2] += in[k] * wv.z;
        acc[4 * q + 3] += in[k] * wv.w;
      }
    }
#pragma unroll
    for (int j = 0; j < kGroup; ++j)
      if (!Raw) acc[j] = silu(acc[j] + b_s[c0 + j]);
    store16<T>(yp + c0, acc);
  }
}

template <typename T, bool Raw>
cudaError_t launch(const void* x, const void* w, const void* b, void* y,
                   int B, int H, int W, int C, cudaStream_t stream) {
  const int Ho = (H + 1) / 2, Wo = (W + 1) / 2;
  dim3 grid(ceil_div(Wo, kTW), ceil_div(Ho, kRows), B);
  stem_kernel<T, Raw><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const T*>(b), static_cast<T*>(y), H, W, C, Ho, Wo);
  return cudaGetLastError();
}

}  // namespace
}  // namespace yolo

// C must be a multiple of 16 and at most 256 (checked by the Python wrapper).
extern "C" int yolo_stem_conv(const void* x, const void* w, const void* b,
                              void* y, int B, int H, int W, int C, int dtype,
                              void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == yolo::kBFloat16)
    return yolo::launch<__nv_bfloat16, false>(x, w, b, y, B, H, W, C, s);
  return yolo::launch<float, false>(x, w, b, y, B, H, W, C, s);
}

// The pre-BN train forward: y = conv3x3_s2_p1(x), no bias, no SiLU, in x's
// dtype rounded once from the f32 accumulator. Same constraints on C.
extern "C" int yolo_stem_conv_raw(const void* x, const void* w, void* y,
                                  int B, int H, int W, int C, int dtype,
                                  void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == yolo::kBFloat16)
    return yolo::launch<__nv_bfloat16, true>(x, w, nullptr, y, B, H, W, C, s);
  return yolo::launch<float, true>(x, w, nullptr, y, B, H, W, C, s);
}

extern "C" const char* yolo_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
