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
// Design: a T x T output tile needs a Wb x Wb input frame (Wb = T + 4n, a
// halo of 2n pixels on each side). Conv k of the 2n (k = 1 .. 2n) computes
// its outputs over the frame's inner square [k, Wb - k): conv 1 of a
// bottleneck from buffer R into buffer Tb, conv 2 from Tb back into R,
// adding the residual in place; the last conv's square is the T x T tile.
// - bf16: a persistent grid walking the tiles in (image, row, column)
//   order: at n = 1 two CTAs of two warpgroups per SM (T = 16), beyond one
//   CTA of four (T = 20 at n = 2, 16 at n = 3, 12 at n = 4), the largest
//   tiles whose buffers fit. One kernel instance per n makes the frame,
//   the squares and their divisions compile-time constants (faster on the
//   card than run-time sizes: the kernel is bound by its non-product
//   instructions as much as by its products). The weights of the 2n convs (9 x 32 x 32 each, packed
//   by the wrapper in the wgmma B layout of hopper.cuh) stay resident for
//   n <= 2 (36.9 KB at n = 1, 73.7 KB at n = 2); for n = 3 and 4 each conv's
//   weights stream into one of two slots while the previous conv runs. The
//   next tile's frame is loaded by cp.async (zero fill outside the image)
//   into a third buffer while this tile computes. A pixel is 64 bytes, its
//   16-byte chunks XOR-swizzled by pixel pairs against bank conflicts.
//   Products: wgmma m64n32k16, M = 64 pixels of the conv's square in
//   row-major order (the last chunk padded), A from registers (ldmatrix at
//   each lane's own pixel address, shifted by the tap), so no wrapped
//   columns are computed: at n = 1 the two convs compute 18^2 + 16^2
//   pixels, padded to 640 rows, per 16^2 outputs (1.25x the useful
//   products; the frame is 1.56x the tile's reads, mostly from L2). Conv
//   1's epilogue writes bias + SiLU, rounded and masked by image, from the
//   registers into Tb; conv 2 adds the residual from R in place; the last
//   conv adds it and stores the tile straight to device memory, 16 bytes a
//   lane.
// - f32: CUDA cores; one block per tile (T = 16; 8 at n >= 3, where the
//   buffers would not fit); each thread a 4-pixel x 4-channel register tile
//   of the conv's square, the buffers padded to 33 floats per pixel against
//   bank conflicts. It reads the same packed weights.
#include "common.cuh"
#include "hopper.cuh"

namespace yolo {
namespace {

constexpr int kC = 32;                 // channels of the chain
constexpr int kMaxN = 4;
constexpr int kMaxSmem = 232448;       // an H100 block's shared memory
constexpr int kThreads = 256;
constexpr int kConvElems = 9 * kC * kC;   // one conv's packed weights

// ---------------------------------------------------------------------------
// bf16 tensor-core variant (wgmma)
// ---------------------------------------------------------------------------

namespace tc {

using bf16 = __nv_bfloat16;
using namespace sm90;

constexpr int kPixBytes = kC * 2;                 // 64
constexpr int kConvBytes = kConvElems * 2;        // 18,432
constexpr int kBlockBytes = 16 * kC * 2;          // one (tap, k-step) block

// convs whose weights stay resident; beyond, two streamed slots
__host__ __device__ constexpr int weight_slots(int n) {
  return n <= 2 ? 2 * n : 2;
}

__host__ __device__ constexpr int tile_for(int n) {
  return n == 2 ? 20 : n == 4 ? 12 : 16;
}

// warpgroups per CTA and CTAs per SM: at n = 1 (113.7 KB of shared
// memory) two CTAs of two warpgroups, beyond one CTA of four
__host__ __device__ constexpr int warpgroups_for(int n) {
  return n == 1 ? 2 : 4;
}

inline size_t smem_bytes(int n, int T) {
  const int Wb = T + 4 * n;
  return (size_t)3 * Wb * Wb * kPixBytes +
         (size_t)weight_slots(n) * kConvBytes;
}

// byte offset of chunk c (8 channels) of frame pixel q
__device__ __forceinline__ uint32_t pix_off(int q, int c) {
  return q * kPixBytes + ((c ^ ((q >> 1) & 3)) << 4);
}

struct Tile {
  int b, y0, x0;      // image coordinates of frame pixel (0, 0)
};

__device__ __forceinline__ Tile tile_of(int t, int T, int halo, int tiles_h,
                                        int tiles_w) {
  const int per = tiles_h * tiles_w, r = t % per;
  return {t / per, (r / tiles_w) * T - halo, (r % tiles_w) * T - halo};
}

__device__ __forceinline__ void load_frame(uint32_t buf, const bf16* m,
                                           Tile t, int Wb, int H, int W,
                                           int threads) {
  for (int e = threadIdx.x; e < Wb * Wb * 4; e += threads) {
    const int q = e / 4, c = e % 4;
    const int iy = t.y0 + q / Wb, ix = t.x0 + q % Wb;
    const bool ok = iy >= 0 && iy < H && ix >= 0 && ix < W;
    const bf16* src =
        ok ? m + (((size_t)t.b * H + iy) * W + ix) * kC + 8 * c : m;
    cp_async16(buf + pix_off(q, c), src, ok);
  }
}

__device__ __forceinline__ void load_weights(uint32_t slot, const bf16* w,
                                             int threads) {
  for (int e = threadIdx.x; e < kConvBytes / 16; e += threads)
    cp_async16(slot + 16 * e, w + 8 * e, true);
}

// A registers of one kernel row (3 taps x 2 k-steps) for this lane's pixel
// q (frame index of the output pixel)
__device__ __forceinline__ void load_a(uint32_t (&a)[3][2][4], uint32_t src,
                                       int q, int ky, int Wb, int hi) {
#pragma unroll
  for (int kx = 0; kx < 3; ++kx) {
    const int p = q + (ky - 1) * Wb + kx - 1;
#pragma unroll
    for (int s = 0; s < 2; ++s) ldmatrix_x4(src + pix_off(p, 2 * s + hi),
                                           a[kx][s]);
  }
}

// one instance per n, so that the frame and square sizes are constants
template <int n>
__global__ void __launch_bounds__(128 * warpgroups_for(n), n == 1 ? 2 : 1)
chain_wgmma_kernel(const bf16* __restrict__ m, const bf16* __restrict__ wt,
                   const bf16* __restrict__ bias, bf16* __restrict__ out,
                   int H, int W, int tiles_h, int tiles_w, int n_tiles) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int kWG = warpgroups_for(n), kThreadsN = 128 * kWG;
  constexpr int T = tile_for(n), Wb = T + 4 * n, halo = 2 * n;
  constexpr int convs = 2 * n, frame_bytes = Wb * Wb * kPixBytes;
  const uint32_t base = smem_u32(smem);
  const uint32_t tb = base + 2 * frame_bytes;
  const uint32_t w_s = base + 3 * frame_bytes;
  constexpr bool streamed = n > 2;
  // the conv after which the next tile's frame load is issued: the first
  // when the weights are resident, else the last (after its weights)
  constexpr int frame_at = streamed ? convs - 1 : 0;

  const int tid = threadIdx.x, lane = tid % 32;
  const int wg = tid / 128, warp = (tid / 32) % 4, q4 = lane % 4;
  const int hi = lane / 16;

  int t = blockIdx.x;
  for (int c = 0; c < (streamed ? 1 : convs); ++c)
    load_weights(w_s + c * kConvBytes, wt + (size_t)c * kConvElems,
                 kThreadsN);
  load_frame(base, m, tile_of(t, T, halo, tiles_h, tiles_w), Wb, H, W,
             kThreadsN);
  cp_async_commit();

  for (int it = 0; t < n_tiles; ++it, t += gridDim.x) {
    const Tile tl = tile_of(t, T, halo, tiles_h, tiles_w);
    const uint32_t R = base + (it & 1) * frame_bytes;
    const int tn = t + gridDim.x;
#pragma unroll
    for (int c = 0; c < convs; ++c) {
      if (c == 0 || streamed) {
        cp_async_wait_all();
        fence_proxy_async();
      }
      __syncthreads();   // the last conv's writes, this conv's weights
      if (streamed && (c + 1 < convs || tn < n_tiles))
        load_weights(w_s + ((c + 1) & 1) * kConvBytes,
                     wt + (size_t)((c + 1) % convs) * kConvElems, kThreadsN);
      if (c == frame_at && tn < n_tiles)
        load_frame(base + ((it + 1) & 1) * frame_bytes, m,
                   tile_of(tn, T, halo, tiles_h, tiles_w), Wb, H, W,
                   kThreadsN);
      cp_async_commit();

      const uint32_t wc = w_s + (streamed ? (c & 1) : c) * kConvBytes;
      const uint32_t src = (c & 1) ? tb : R;
      const bool last = c == convs - 1;
      const int lo = c + 1, S = Wb - 2 * lo, npix = S * S;
      float bl[4][2];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          bl[j][e] = __bfloat162float(bias[c * kC + 8 * j + 2 * q4 + e]);

      for (int ch = wg; 64 * ch < npix; ch += kWG) {
        // this lane's A row, clamped into the square
        const int ia = min(64 * ch + 16 * warp + lane % 16, npix - 1);
        const int qa = (lo + ia / S) * Wb + lo + ia % S;
        float acc[16];
#pragma unroll
        for (int i = 0; i < 16; ++i) acc[i] = 0.0f;
        uint32_t a[2][3][2][4];
        load_a(a[0], src, qa, 0, Wb, hi);
#pragma unroll
        for (int ky = 0; ky < 3; ++ky) {
          wgmma_fence();
#pragma unroll
          for (int kx = 0; kx < 3; ++kx)
#pragma unroll
            for (int s = 0; s < 2; ++s)
              wgmma_m64n32k16(
                  acc, a[ky & 1][kx][s],
                  make_desc(wc + ((3 * ky + kx) * 2 + s) * kBlockBytes), 1);
          wgmma_commit();
          if (ky < 2) {
            wgmma_wait<1>();
            load_a(a[(ky + 1) & 1], src, qa, ky + 1, Wb, hi);
          }
        }
        wgmma_wait<0>();

        // epilogue: rows lane / 4 and lane / 4 + 8 of the warp's 16
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int idx = 64 * ch + 16 * warp + lane / 4 + 8 * r;
          const int Y = lo + idx / S, X = lo + idx % S, q = Y * Wb + X;
          const bool valid = idx < npix;
          const bool in_image = tl.y0 + Y >= 0 && tl.y0 + Y < H &&
                                tl.x0 + X >= 0 && tl.x0 + X < W;
          uint32_t v[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float t0 = __bfloat162float(__float2bfloat16(
                silu_fast(acc[4 * j + 2 * r] + bl[j][0])));
            const float t1 = __bfloat162float(__float2bfloat16(
                silu_fast(acc[4 * j + 2 * r + 1] + bl[j][1])));
            const uint32_t at = pix_off(valid ? q : 0, j) + 4 * q4;
            if (!(c & 1)) {
              v[j] = in_image ? pack_bf16x2(t0, t1) : 0u;
            } else {
              // the residual, in place in R
              uint32_t rv;
              asm volatile("ld.shared.b32 %0, [%1];\n"
                           : "=r"(rv) : "r"(R + at));
              const __nv_bfloat162 r2 =
                  *reinterpret_cast<const __nv_bfloat162*>(&rv);
              v[j] = in_image ? pack_bf16x2(__low2float(r2) + t0,
                                            __high2float(r2) + t1)
                              : 0u;
            }
          }
          if (last) {
            uint32_t o[4];
            quad_transpose(v, o, q4);
            if (valid && in_image)
              *reinterpret_cast<uint4*>(
                  out + (((size_t)tl.b * H + tl.y0 + Y) * W + tl.x0 + X) *
                            kC + 8 * q4) = make_uint4(o[0], o[1], o[2], o[3]);
          } else if (valid) {
            const uint32_t dst = (c & 1) ? R : tb;
#pragma unroll
            for (int j = 0; j < 4; ++j)
              asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(
                               dst + pix_off(q, j) + 4 * q4),
                           "r"(v[j])
                           : "memory");
          }
        }
      }
    }
  }
  cp_async_wait_all();
}

template <int n>
cudaError_t launch_n(const bf16* m, const bf16* wt, const bf16* bias,
                     bf16* out, int B, int H, int W, cudaStream_t stream) {
  constexpr int T = tile_for(n), kMinBlocks = n == 1 ? 2 : 1;
  static PerDeviceSmem smem;
  cudaError_t e = smem.opt_in((const void*)chain_wgmma_kernel<n>, kMaxSmem);
  if (e != cudaSuccess) return e;
  const int tiles_h = ceil_div(H, T), tiles_w = ceil_div(W, T);
  const int n_tiles = B * tiles_h * tiles_w;
  const int slots = kMinBlocks * sm_count();
  const int grid = n_tiles < slots ? n_tiles : slots;
  chain_wgmma_kernel<n><<<grid, 128 * warpgroups_for(n), smem_bytes(n, T),
                          stream>>>(m, wt, bias, out, H, W, tiles_h, tiles_w,
                                    n_tiles);
  return cudaGetLastError();
}

cudaError_t launch(const void* m, const void* wt, const void* bias,
                   void* out, int B, int H, int W, int n,
                   cudaStream_t stream) {
  const bf16 *mp = static_cast<const bf16*>(m),
             *wp = static_cast<const bf16*>(wt),
             *bp = static_cast<const bf16*>(bias);
  bf16* op = static_cast<bf16*>(out);
  switch (n) {
    case 1: return launch_n<1>(mp, wp, bp, op, B, H, W, stream);
    case 2: return launch_n<2>(mp, wp, bp, op, B, H, W, stream);
    case 3: return launch_n<3>(mp, wp, bp, op, B, H, W, stream);
    default: return launch_n<4>(mp, wp, bp, op, B, H, W, stream);
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
      // the conv's weights, [tap][ci][co], from the packed image, where
      // one output channel's 8 input channels of a group are contiguous
      const float* wg = wt + (size_t)(2 * i + conv) * kConvElems;
      for (int e = tid; e < kConvElems / 4; e += kThreads) {
        const int co = e % kC, quad = (e / kC) % 8, tap = e / (8 * kC);
        const float4 v = *reinterpret_cast<const float4*>(
            wg + sm90::packed_index<kC>(co, 8 * (quad / 2), tap) +
            4 * (quad % 2));
        float* d = w_s + (tap * kC + 4 * quad) * kC + co;
        d[0] = v.x; d[kC] = v.y; d[2 * kC] = v.z; d[3 * kC] = v.w;
      }
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

cudaError_t launch(const void* m, const void* wt, const void* bias,
                   void* out, int B, int H, int W, int n,
                   cudaStream_t stream) {
  static PerDeviceSmem smem;
  cudaError_t e = smem.opt_in((const void*)chain_f32_kernel, kMaxSmem);
  if (e != cudaSuccess) return e;
  const int T = smem_bytes(16 + 4 * n) <= (size_t)kMaxSmem ? 16 : 8;
  const int tiles_w = ceil_div(W, T);
  dim3 grid(tiles_w * ceil_div(H, T), B);
  chain_f32_kernel<<<grid, kThreads, smem_bytes(T + 4 * n), stream>>>(
      static_cast<const float*>(m), static_cast<const float*>(wt),
      static_cast<const float*>(bias), static_cast<float*>(out), H, W, n, T,
      tiles_w);
  return cudaGetLastError();
}

}  // namespace f32

}  // namespace
}  // namespace yolo

// m, out (B, H, W, 32) NHWC; wt the packed weights of the 2n convs, conv
// 2i + j (bottleneck i, conv j) at element 9216 * (2i + j) in the layout of
// hopper.cuh: packed_index (ops/kernels/csp_chain.py: pack_weights); bias
// (n, 2, 32); all of one dtype, 16-byte aligned; 1 <= n <= 4 (checked by the
// Python wrapper).
extern "C" int yolo_csp_chain(const void* m, const void* wt, const void* bias,
                              void* out, int B, int H, int W, int n,
                              int dtype, void* stream) {
  if (n < 1 || n > yolo::kMaxN) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == yolo::kBFloat16)
    return yolo::tc::launch(m, wt, bias, out, B, H, W, n, s);
  return yolo::f32::launch(m, wt, bias, out, B, H, W, n, s);
}
