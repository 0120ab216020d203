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
// - f32: the same 30.2 GFLOP per bottleneck and 210 MB of m and out
//   (0.063 ms of bytes) at n = 1; on the CUDA cores (67 TFLOP/s) the
//   products alone take 0.451 ms, so they go to the tensor cores in
//   3xTF32 (hopper.cuh: three TF32 products per f32 product, 3 x 30.2
//   GFLOP at 495 TFLOP/s, 0.183 ms), by mma.sync m16n8k8 (which does not
//   reach the TF32 peak that wgmma does). The skeleton is the bf16 one: a
//   persistent grid of one CTA (12 warps) per SM walking the tiles in
//   (image, row, column) order, the last conv storing from registers. A
//   pixel is 128 bytes, its 16-byte chunks XOR-swizzled by pixel
//   (pix_off). At n = 1 the frame is 20 x 20 (T = 16): three frames, the
//   next tile's prefetched by cp.async with zero fill, and both convs'
//   weights resident, 227,328 B. Beyond, the frame is 24 x 24 (T = 24 -
//   4n), two frames, the next one loaded at the tile's start, and the
//   weights stream conv by conv through two slots. The weights are staged
//   from the packed image into [tap][16 channels][co][16 channels] slots
//   and every operand is split into hi and lo in registers as its
//   fragment is loaded, so the packed image stays the one layout. A warp
//   takes 32 pixels of the square for all 32 channels; each tap's
//   products are summed apart and then added by FADD.
#include "common.cuh"
#include "hopper.cuh"

namespace yolo {
namespace {

constexpr int kC = 32;                 // channels of the chain
constexpr int kMaxN = 4;
constexpr int kMaxSmem = 232448;       // an H100 block's shared memory
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
// f32 tensor-core variant (3xTF32, mma.sync)
// ---------------------------------------------------------------------------

namespace f32 {

using namespace sm90;
using tc::Tile;
using tc::tile_of;

constexpr int kPixBytes = kC * 4;                     // 128
constexpr int kConvBytes = kConvElems * 4;            // 36,864
// 12 warps: conv 1's 11 chunks at n = 1 in one round, three warps to hide
// each sub-partition's waits
constexpr int kThreads = 384;
constexpr int kWarps = kThreads / 32;

// The frame side: 20 at n = 1 (T = 16), where three frames (the next
// tile's prefetched) fit beside two weight slots, 153,600 + 73,728 B; 24
// beyond (T = 24 - 4n), two frames and the next one loaded at the tile's
// start, 147,456 + 73,728 B: at n = 2 a 16-pixel tile takes a fifth less
// work per output pixel than the 12 that three frames would leave.
__host__ __device__ constexpr int wb_for(int n) { return n == 1 ? 20 : 24; }

__host__ __device__ constexpr int frame_bytes(int n) {
  return wb_for(n) * wb_for(n) * kPixBytes;
}

__host__ __device__ constexpr bool prefetched(int n) {
  return 3 * frame_bytes(n) + 2 * kConvBytes <= kMaxSmem;
}

__host__ __device__ constexpr int frames_for(int n) {
  return prefetched(n) ? 3 : 2;
}

__host__ __device__ constexpr int smem_for(int n) {
  return frames_for(n) * frame_bytes(n) + 2 * kConvBytes;
}

// byte offset of chunk c (4 channels) of frame pixel q: the chunks XOR-
// swizzled by q % 4 (0, 4, 2, 6), so that the two pixels of an A load's
// 8-lane phase, and the four of an epilogue store's 16, meet 8 bank groups
__device__ __forceinline__ uint32_t pix_off(int q, int c) {
  return q * kPixBytes + ((c ^ (((q & 1) << 2) | (q & 2))) << 4);
}

template <int Wb>
__device__ __forceinline__ void load_frame(uint32_t buf, const float* m,
                                           Tile t, int H, int W) {
  for (int e = threadIdx.x; e < Wb * Wb * 8; e += kThreads) {
    const int q = e / 8, c = e % 8;
    const int iy = t.y0 + q / Wb, ix = t.x0 + q % Wb;
    const bool ok = iy >= 0 && iy < H && ix >= 0 && ix < W;
    const float* src =
        ok ? m + (((size_t)t.b * H + iy) * W + ix) * kC + 4 * c : m;
    cp_async16(buf + pix_off(q, c), src, ok);
  }
}

// one conv's weights from the packed image into the slot as
// [tap][16-channel half h][co][16 input channels]: 16-byte chunk e =
// ((2 tap + h) * 32 + co) * 4 + cq holds input channels 16 h + 4 cq ..
// + 3 of output channel co, which the packed image keeps contiguous
__device__ __forceinline__ void load_weights(uint32_t slot, const float* w) {
  for (int e = threadIdx.x; e < kConvBytes / 16; e += kThreads) {
    const int cq = e & 3, co = (e >> 2) & 31, th = e >> 7;
    cp_async16(slot + 16 * e,
               w + th * 16 * kC + (co / 8) * 128 + (cq / 2) * 64 +
                   (co % 8) * 8 + (cq % 2) * 4,
               true);
  }
}

// One instance per n. Each warp takes 32 pixels of the conv's square at a
// time (two m16 tiles) for all 32 output channels (four n8 tiles). In a
// k8 step (tap, half h, s) the column t of A and B stands for input
// channel 16 h + 4 t + 2 s and column t + 4 for the next one, so a lane
// reads 4 contiguous channels (one 16-byte load) of its pixel for A and of
// its output channel for B, for both steps s.
template <int n>
__global__ void __launch_bounds__(kThreads, 1)
chain_tf32_kernel(const float* __restrict__ m, const float* __restrict__ wt,
                  const float* __restrict__ bias, float* __restrict__ out,
                  int H, int W, int tiles_h, int tiles_w, int n_tiles) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int Wb = wb_for(n), T = Wb - 4 * n, halo = 2 * n, convs = 2 * n;
  constexpr int FB = frame_bytes(n), WO = frames_for(n) * FB;
  // n = 1: both convs' weights resident, the next tile's frame loaded
  // while this one computes; beyond, the weights streamed conv by conv
  constexpr bool streamed = n > 1, prefetch = prefetched(n);
  static_assert(prefetch != streamed, "one schedule per n");
  const uint32_t base = smem_u32(smem), w_s = base + WO;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int gq = lane / 4, tq = lane % 4;

  int t = blockIdx.x;
  for (int c = 0; c < (streamed ? 1 : convs); ++c)
    load_weights(w_s + c * kConvBytes, wt + (size_t)c * kConvElems);
  if (prefetch)
    load_frame<Wb>(base, m, tile_of(t, T, halo, tiles_h, tiles_w), H, W);
  cp_async_commit();

  for (int it = 0; t < n_tiles; ++it, t += gridDim.x) {
    const Tile tl = tile_of(t, T, halo, tiles_h, tiles_w);
    unsigned char* const R = smem + (prefetch ? (it & 1) * FB : 0);
    unsigned char* const Tb = smem + (prefetch ? 2 : 1) * FB;
    const int tn = t + gridDim.x;
#pragma unroll
    for (int c = 0; c < convs; ++c) {
      if (!prefetch && c == 0) {
        __syncthreads();   // the last tile is done with R
        load_frame<Wb>(base, m, tl, H, W);
        cp_async_commit();
      }
      if (c == 0 || streamed) cp_async_wait_all();
      __syncthreads();   // the last conv's writes, this conv's weights
      if (streamed && (c + 1 < convs || tn < n_tiles))
        load_weights(w_s + ((c + 1) & 1) * kConvBytes,
                     wt + (size_t)((c + 1) % convs) * kConvElems);
      if (prefetch && c == 0 && tn < n_tiles)
        load_frame<Wb>(base + ((it + 1) & 1) * FB, m,
                       tile_of(tn, T, halo, tiles_h, tiles_w), H, W);
      cp_async_commit();

      const unsigned char* wc = smem + WO + (c & 1) * kConvBytes;
      const unsigned char* src = (c & 1) ? Tb : R;
      const bool last = c == convs - 1;
      const int lo = c + 1, S = Wb - 2 * lo, npix = S * S;
      float bc[4][2];   // biases of this lane's channels
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          bc[j][e] = __ldg(bias + c * kC + 8 * j + 2 * tq + e);

      for (int ch = warp; 32 * ch < npix; ch += kWarps) {
        // frame pixels of this lane's A rows gq and gq + 8 of each m16
        // tile, clamped into the square
        int qa[2][2];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int i = min(32 * ch + 16 * mt + 8 * r + gq, npix - 1);
            qa[mt][r] = (lo + i / S) * Wb + lo + i % S;
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
          const int dq = (tap / 3 - 1) * Wb + tap % 3 - 1;
          float part[2][4][4];   // this tap's products, added by FADD
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int j = 0; j < 4; ++j)
#pragma unroll
              for (int k = 0; k < 4; ++k) part[mt][j][k] = 0.0f;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float4 av[2][2], bv[4];
#pragma unroll
            for (int mt = 0; mt < 2; ++mt)
#pragma unroll
              for (int r = 0; r < 2; ++r)
                av[mt][r] = *reinterpret_cast<const float4*>(
                    src + pix_off(qa[mt][r] + dq, 4 * h + tq));
#pragma unroll
            for (int j = 0; j < 4; ++j)
              bv[j] = *reinterpret_cast<const float4*>(
                  wc + (((2 * tap + h) * kC + 8 * j + gq) << 6) + (tq << 4));
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

        // epilogue: rows gq and gq + 8 of each m16 tile, channels
        // 8 j + 2 tq, + 1
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int idx = 32 * ch + 16 * mt + 8 * r + gq;
            if (idx >= npix) continue;
            const int Y = lo + idx / S, X = lo + idx % S, q = Y * Wb + X;
            const bool in_image = tl.y0 + Y >= 0 && tl.y0 + Y < H &&
                                  tl.x0 + X >= 0 && tl.x0 + X < W;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const uint32_t at = pix_off(q, 2 * j + tq / 2) + 8 * (tq % 2);
              float2 v =
                  make_float2(silu_mufu(acc[mt][j][2 * r] + bc[j][0]),
                              silu_mufu(acc[mt][j][2 * r + 1] + bc[j][1]));
              if (c & 1) {   // the residual, from R
                const float2 rv = *reinterpret_cast<const float2*>(R + at);
                v.x += rv.x;
                v.y += rv.y;
              }
              if (!in_image) v = make_float2(0.0f, 0.0f);
              if (last) {
                if (in_image)
                  *reinterpret_cast<float2*>(
                      out + (((size_t)tl.b * H + tl.y0 + Y) * W + tl.x0 + X) *
                                kC + 8 * j + 2 * tq) = v;
              } else {
                // conv 1 into Tb; conv 2 into R, in place
                *reinterpret_cast<float2*>(((c & 1) ? R : Tb) + at) = v;
              }
            }
          }
      }
    }
  }
  cp_async_wait_all();
}

template <int n>
cudaError_t launch_n(const float* m, const float* wt, const float* bias,
                     float* out, int B, int H, int W, cudaStream_t stream) {
  constexpr int T = wb_for(n) - 4 * n;
  static PerDeviceSmem smem;
  cudaError_t e = smem.opt_in((const void*)chain_tf32_kernel<n>, smem_for(n));
  if (e != cudaSuccess) return e;
  const int tiles_h = ceil_div(H, T), tiles_w = ceil_div(W, T);
  const int n_tiles = B * tiles_h * tiles_w;
  const int slots = sm_count();
  const int grid = n_tiles < slots ? n_tiles : slots;
  chain_tf32_kernel<n><<<grid, kThreads, smem_for(n), stream>>>(
      m, wt, bias, out, H, W, tiles_h, tiles_w, n_tiles);
  return cudaGetLastError();
}

cudaError_t launch(const void* m, const void* wt, const void* bias,
                   void* out, int B, int H, int W, int n,
                   cudaStream_t stream) {
  const float *mp = static_cast<const float*>(m),
              *wp = static_cast<const float*>(wt),
              *bp = static_cast<const float*>(bias);
  float* op = static_cast<float*>(out);
  switch (n) {
    case 1: return launch_n<1>(mp, wp, bp, op, B, H, W, stream);
    case 2: return launch_n<2>(mp, wp, bp, op, B, H, W, stream);
    case 3: return launch_n<3>(mp, wp, bp, op, B, H, W, stream);
    default: return launch_n<4>(mp, wp, bp, op, B, H, W, stream);
  }
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
