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
// no order, so the sum is split in two launches: each CTA writes the
// 27 x C partial sums of its share of the pixels to a (ctas, 27, C) f32
// buffer, and wgrad_sum adds them up in CTA order. No float atomics: the
// result is the same on every run.
//
// What bounds it on an H100: at (32, 3, 640, 640) -> C = 64 it reads 78.6 MB
// of x and 419.4 MB of g in bf16 (0.149 ms at 3.35 TB/s) for 11.3 GFLOP
// (0.011 ms on the tensor cores): it is a stream of g with a small product
// on the side, and its design is about moving those bytes at HBM rate.
//
// bf16 design:
// - a persistent grid (the wrapper sizes it by the device's SM count);
//   CTA i walks the contiguous range of output rows (image, oy) from
//   i * R / ctas to (i + 1) * R / ctas, R = B * Ho. Each row is cut into
//   nseg segments of sp pixels (sp a multiple of 16, chosen so that a
//   segment's g is at most 16 KB and the segments of a row are about even);
// - g of a segment is contiguous in memory (NHWC). It is streamed in
//   16-byte cp.async copies through a 4-stage ring, its chunks XOR-swizzled
//   within each 128 bytes so that ldmatrix reads 8 pixels from 8 bank
//   groups; chunks past the row's last pixel are zero-filled. The input
//   window of the segment (3 input rows, 2 sp + 1 columns of 6 bytes) goes
//   into the same stage as whole 16-byte chunks of x, aligned to x's base
//   whatever the row's alignment (the tensor's last, cut chunk is copied
//   element by element);
// - im2col in shared memory, bf16, [tap][pixel], two tiles: 27 taps padded
//   to 32 (the padding rows zeroed once), each row 2 sp + 16 bytes, an odd
//   number of 16-byte chunks, so the 8 rows of an ldmatrix fall in 8 bank
//   groups. The conv's zero padding, odd H and W and the segment's tail are
//   zeros written here;
// - one barrier per segment i: then the copies of segment i + 3 start, the
//   im2col of segment i + 1 is built into one tile and the products of
//   segment i read the other, while the copies of i + 2 and i + 3 are in
//   flight. Two CTAs per SM (102 registers, 89,216 bytes of shared memory
//   each at C = 64) overlap one CTA's barrier with the other's work;
// - the product on the tensor cores, mma.sync m16n8k16 (bf16 in, f32
//   accumulators in registers): M = the 32 taps, N = C, K = the pixels. A
//   warp owns 32 channels (4 n8 tiles, 32 accumulators a lane) and every
//   (8 / slices)-th 16-pixel k-step of a segment, A by ldmatrix and B by
//   ldmatrix.trans from the staged g. mma.sync rather than wgmma: the
//   product is ~1/15 of the time, and per-warp k-steps need no warpgroup
//   synchronisation, no descriptor layout for the ring, and pad 27 taps to
//   32 rows instead of 64;
// - at the end the warps that share channels are summed in warp order in
//   shared memory, and the CTA writes its partial.
//
// f32: the same shape reads 157.3 MB of x and 838.9 MB of g (0.2974 ms at
// 3.35 TB/s); its 11.3 GFLOP would take 0.169 ms on the CUDA cores (67
// TFLOP/s), more than half of that, and 0.069 ms in 3xTF32 on the tensor
// cores (hopper.cuh: 3 x 11.3 GFLOP at 495 TFLOP/s). So the f32 kernel
// (wgrad_tf32_kernel) is the bf16 one's walk with 3xTF32 products: the
// same persistent grid of 2 CTAs per SM over row ranges, segments of at
// most 16 KB of g (64 pixels at C = 64) through the 4-stage cp.async ring,
// each staged pixel padded to C + 4 floats (an odd number of 16-byte
// chunks, against bank conflicts), the input window of 12-byte pixels,
// im2col in shared memory in f32, and mma.sync m16n8k8 on operands split
// into hi and lo as they are loaded (M = 32 taps, N = 32 channels a warp,
// K = 8 pixels a step). The tensor cores' f32 sums are not rounded to
// nearest, so each warp adds a segment's products into its accumulators
// by FADD. The partials and wgrad_sum are the bf16 ones: no atomics.
#include <algorithm>

#include "common.cuh"
#include "hopper.cuh"

namespace yolo {
namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// ---------------------------------------------------------------------------
// bf16 tensor-core variant (mma.sync)
// ---------------------------------------------------------------------------

namespace tc {

using bf16 = __nv_bfloat16;
using namespace sm90;

constexpr int kStages = 4;          // cp.async ring depth
constexpr int kTapRows = 32;        // 27 taps, padded to two m16 tiles
constexpr int kMaxSp = 256;         // pixels of a segment, at most
constexpr int kSegElems = 8192;     // g elements of a segment, at most

// 16-byte chunks of one input row's window for sp output pixels: 2 sp + 1
// pixels of 6 bytes, plus the alignment on either side
__host__ __device__ constexpr int x_chunks(int sp) {
  return ((2 * sp + 1) * 6 + 30) / 16;
}

constexpr int kMaxSmem =
    kStages * (2 * kSegElems + 3 * x_chunks(kMaxSp) * 16) +
    2 * kTapRows * (2 * kMaxSp + 16);

// byte offsets in dynamic shared memory: kStages slots of (g, x window),
// then two im2col tiles
struct Layout {
  int g_bytes, slot_bytes, a_stride, a_bytes, a_off, total;
};

__host__ __device__ inline Layout layout(int sp, int C) {
  Layout l;
  l.g_bytes = sp * C * 2;
  l.slot_bytes = l.g_bytes + 3 * x_chunks(sp) * 16;
  l.a_stride = 2 * sp + 16;
  l.a_bytes = kTapRows * l.a_stride;
  l.a_off = kStages * l.slot_bytes;
  l.total = l.a_off + 2 * l.a_bytes;
  // the warps' sums reuse the ring at the end: kWarps x 32 x 32 f32
  if (l.total < kWarps * 32 * 32 * 4) l.total = kWarps * 32 * 32 * 4;
  return l;
}

// A segment of an output row: row r = (image b, output row oy), output
// columns ox0 .. ox0 + npix - 1, nks 16-pixel k-steps. `next` walks a
// CTA's rows segment by segment.
struct Seg {
  int r, b, oy, ox0, npix, nks;

  __device__ __forceinline__ void start(int r0, int Ho, int Wo, int sp) {
    r = r0;
    b = r0 / Ho;
    oy = r0 % Ho;
    ox0 = 0;
    npix = min(sp, Wo);
    nks = (npix + 15) >> 4;
  }

  __device__ __forceinline__ void next(int Ho, int Wo, int sp) {
    ox0 += sp;
    if (ox0 >= Wo) {
      ox0 = 0;
      ++r;
      if (++oy == Ho) {
        oy = 0;
        ++b;
      }
    }
    npix = min(sp, Wo - ox0);
    nks = (npix + 15) >> 4;
  }
};

// the byte of x (from x's base) where input row 2 oy - 1 + ky's window
// starts at column lo; meaningful where that row lies in the image
__device__ __forceinline__ long long x_byte(const Seg& s, int ky, int lo,
                                            int H, int W) {
  return (((long long)s.b * H + 2 * s.oy - 1 + ky) * W + lo) * 6;
}

__device__ __forceinline__ bool x_row_ok(const Seg& s, int ky, int H) {
  const int iy = 2 * s.oy - 1 + ky;
  return iy >= 0 && iy < H;
}

// start the copies of segment s into a stage slot
__device__ __forceinline__ void load_segment(const Seg& s, uint32_t slot,
                                             unsigned char* slot_p,
                                             const bf16* x, const bf16* g,
                                             int H, int W, int C, int Wo,
                                             int sp, long long x_bytes,
                                             const Layout& L) {
  // g: chunk q (16 bytes) to q ^ ((q >> 3) & 7), so that ldmatrix reads 8
  // pixels from 8 bank groups; a thread's q moves by kThreads = 32 x 8, so
  // its XOR stays the same
  const int cpp = C / 8;
  const int nq = s.nks * 16 * cpp, valid = s.npix * cpp;
  const char* gs = reinterpret_cast<const char*>(
      g + ((size_t)s.r * Wo + s.ox0) * C);
  const int tid = threadIdx.x, flip = (tid >> 3) & 7;
  for (int q = tid; q < nq; q += kThreads)
    cp_async16(slot + ((q ^ flip) << 4), q < valid ? gs + 16 * q : gs,
               q < valid);

  // x: the window of each input row in the image, whole 16-byte chunks
  const int xc = x_chunks(sp);
  const int lo = max(0, 2 * s.ox0 - 1);
  const int hi = min(W, 2 * (s.ox0 + s.npix));   // last column + 1
  for (int e = tid; e < 3 * xc; e += kThreads) {
    const int ky = (e >= xc) + (e >= 2 * xc), c = e - ky * xc;
    if (!x_row_ok(s, ky, H)) continue;
    const long long b0 = x_byte(s, ky, lo, H, W);
    const long long byte = (b0 & ~15LL) + 16 * c;
    if (byte >= b0 + (long long)(hi - lo) * 6) continue;
    const int off = L.g_bytes + e * 16;
    const char* src = reinterpret_cast<const char*>(x) + byte;
    if (byte + 16 <= x_bytes) {
      cp_async16(slot + off, src, true);
    } else {   // x's last chunk, cut by the end of the tensor
      auto* d = reinterpret_cast<unsigned short*>(slot_p + off);
      const auto* v = reinterpret_cast<const unsigned short*>(src);
      const int m = (int)((x_bytes - byte) / 2);
      for (int k = 0; k < 8; ++k) d[k] = k < m ? v[k] : 0;
    }
  }
}

// im2col of segment s from its staged window: a[tap][pixel], tap =
// 9 ci + 3 ky + kx (OIHW order), zero outside the image and past the
// segment's last pixel. One item = (ky, pixel pair): 5 input columns x 3
// channels read, 9 taps x 2 pixels written as 32-bit words.
__device__ __forceinline__ void build_a(const Seg& s, const unsigned char* xw,
                                        unsigned char* a, int H, int W,
                                        int sp, const Layout& L) {
  const int xc = x_chunks(sp);
  const int lo = max(0, 2 * s.ox0 - 1);
  const int pairs = s.nks * 8;
  for (int e = threadIdx.x; e < 3 * pairs; e += kThreads) {
    const int ky = (e >= pairs) + (e >= 2 * pairs), p = 2 * (e - ky * pairs);
    const bool row_ok = x_row_ok(s, ky, H);
    const unsigned char* row =
        xw + ky * xc * 16 + (row_ok ? (int)(x_byte(s, ky, lo, H, W) & 15) : 0);
    const bool ok0 = row_ok && p < s.npix, ok1 = row_ok && p + 1 < s.npix;
    const int ix0 = 2 * (s.ox0 + p) - 1;
    unsigned short v[5][3];
#pragma unroll
    for (int d = 0; d < 5; ++d) {
      const int ix = ix0 + d;
      const bool ok = (d <= 2 ? ok0 : ok1) && ix >= 0 && ix < W;
#pragma unroll
      for (int ci = 0; ci < 3; ++ci)
        v[d][ci] = ok ? *reinterpret_cast<const unsigned short*>(
                            row + (ix - lo) * 6 + 2 * ci)
                      : 0;
    }
#pragma unroll
    for (int ci = 0; ci < 3; ++ci)
#pragma unroll
      for (int kx = 0; kx < 3; ++kx) {
        const uint32_t lo16 = ok0 ? v[kx][ci] : 0;
        const uint32_t hi16 = ok1 ? v[kx + 2][ci] : 0;
        *reinterpret_cast<uint32_t*>(a + (9 * ci + 3 * ky + kx) * L.a_stride +
                                     2 * p) = lo16 | (hi16 << 16);
      }
  }
}

// Per segment i, after one barrier: the copies of segment i + kStages - 1
// start, im2col of segment i + 1 is built into one tile while the products
// of segment i read the other.
__global__ void __launch_bounds__(kThreads, 2)
wgrad_mma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ g,
                 float* __restrict__ part, int H, int W, int C, int Ho,
                 int Wo, int R, int sp, int nseg, long long x_bytes) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout L = layout(sp, C);
  const uint32_t base = smem_u32(smem);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;

  const int r0 = (int)((long long)blockIdx.x * R / gridDim.x);
  const int r1 = (int)((long long)(blockIdx.x + 1) * R / gridDim.x);
  const int n_items = (r1 - r0) * nseg;

  // the padding taps 27..31 of both tiles stay zero
  for (int t = 0; t < 2; ++t) {
    auto* pad = reinterpret_cast<uint32_t*>(smem + L.a_off + t * L.a_bytes +
                                            27 * L.a_stride);
    for (int e = tid; e < (kTapRows - 27) * L.a_stride / 4; e += kThreads)
      pad[e] = 0;
  }

  // warp roles: 32 output channels (a slice) and every kw_n-th k-step
  const int slices = ceil_div(C, 32), kw_n = kWarps / slices;
  const int slice = warp / kw_n, kw = warp % kw_n;
  const bool active = slice < slices;
  const int cpp = C / 8;
  const int a_row = lane % 16, a_col = 8 * (lane / 16);   // ldmatrix lanes
  float acc[2][4][4] = {};

  Seg ld, bd;   // the next segment to load, to build
  ld.start(r0, Ho, Wo, sp);
  bd = ld;
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < n_items) {
      load_segment(ld, base + i * L.slot_bytes, smem + i * L.slot_bytes, x,
                   g, H, W, C, Wo, sp, x_bytes, L);
      ld.next(Ho, Wo, sp);
    }
    cp_async_commit();
  }
  cp_async_wait<kStages - 2>();
  __syncthreads();   // segment 0 is in
  if (n_items > 0) build_a(bd, smem + L.g_bytes, smem + L.a_off, H, W, sp, L);

  for (int i = 0; i < n_items; ++i) {
    const int nks = bd.nks;   // segment i's
    bd.next(Ho, Wo, sp);      // segment i + 1
    cp_async_wait<kStages - 3>();
    // segments i + 1 (staged) and i (im2col) are in; the slot of i - 1 and
    // the im2col tile of i - 1 are free
    __syncthreads();
    const int in = i + kStages - 1;
    if (in < n_items) {
      const int slot = in % kStages;
      load_segment(ld, base + slot * L.slot_bytes,
                   smem + slot * L.slot_bytes, x, g, H, W, C, Wo, sp,
                   x_bytes, L);
      ld.next(Ho, Wo, sp);
    }
    cp_async_commit();
    if (i + 1 < n_items)
      build_a(bd, smem + ((i + 1) % kStages) * L.slot_bytes + L.g_bytes,
              smem + L.a_off + ((i + 1) & 1) * L.a_bytes, H, W, sp, L);

    if (active) {
      const uint32_t gb = base + (i % kStages) * L.slot_bytes;
      const uint32_t ab = base + L.a_off + (i & 1) * L.a_bytes;
      for (int ks = kw; ks < nks; ks += kw_n) {
        uint32_t a[2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
          ldmatrix_x4(ab + (16 * mt + a_row) * L.a_stride +
                          (16 * ks + a_col) * 2,
                      a[mt]);
#pragma unroll
        for (int pr = 0; pr < 2; ++pr) {
          const int j = 4 * slice + 2 * pr;   // first n8 tile of the pair
          if (j < cpp) {
            const int q = (16 * ks + a_row) * cpp + j + lane / 16;
            uint32_t b[4];
            ldmatrix_x4_trans(gb + ((q ^ ((q >> 3) & 7)) << 4), b);
#pragma unroll
            for (int mt = 0; mt < 2; ++mt) {
              mma_m16n8k16(acc[mt][2 * pr], a[mt], b[0], b[1]);
              mma_m16n8k16(acc[mt][2 * pr + 1], a[mt], b[2], b[3]);
            }
          }
        }
      }
    }
  }
  cp_async_wait_all();
  __syncthreads();

  // sum the warps of each slice in warp order: red[warp][tap][channel % 32]
  auto* red = reinterpret_cast<float*>(smem);
  if (active) {
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int tap = 16 * mt + lane / 4 + 8 * (k / 2);
          const int cl = 8 * nt + 2 * (lane % 4) + k % 2;
          red[(warp * 32 + tap) * 32 + cl] = acc[mt][nt][k];
        }
  }
  __syncthreads();
  float* out = part + (size_t)blockIdx.x * 27 * C;
  for (int e = tid; e < 27 * C; e += kThreads) {
    const int tap = e / C, c = e % C;
    float v = 0.0f;
    for (int k = 0; k < kw_n; ++k)
      v += red[(((c / 32) * kw_n + k) * 32 + tap) * 32 + c % 32];
    out[e] = v;
  }
}

cudaError_t launch(const void* x, const void* g, float* part, int B, int H,
                   int W, int C, int ctas, cudaStream_t stream) {
  static PerDeviceSmem smem;
  cudaError_t e = smem.opt_in((const void*)wgrad_mma_kernel, kMaxSmem);
  if (e != cudaSuccess) return e;
  const int Ho = (H + 1) / 2, Wo = (W + 1) / 2;
  // segments of at most 16 KB of g, as even as 16-pixel k-steps allow
  const int sp_max = std::min(kMaxSp, kSegElems / C / 16 * 16);
  const int sp = ceil_div(ceil_div(Wo, ceil_div(Wo, sp_max)), 16) * 16;
  const int nseg = ceil_div(Wo, sp);
  wgrad_mma_kernel<<<ctas, kThreads, layout(sp, C).total, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(g), part, H, W,
      C, Ho, Wo, B * Ho, sp, nseg, (long long)B * H * W * 6);
  return cudaGetLastError();
}

}  // namespace tc

// ---------------------------------------------------------------------------
// f32 tensor-core variant (3xTF32, mma.sync)
// ---------------------------------------------------------------------------

namespace f32 {

using namespace sm90;
using tc::Seg;
using tc::x_row_ok;

constexpr int kStages = 4;          // cp.async ring depth
constexpr int kTapRows = 32;        // 27 taps, padded to two m16 tiles
constexpr int kMaxSp = 256;         // pixels of a segment, at most
constexpr int kSegElems = 4096;     // g elements of a segment, at most
constexpr int kPixX = 12;           // bytes of an input pixel

// 16-byte chunks of one input row's window for sp output pixels
__host__ __device__ constexpr int x_chunks(int sp) {
  return ((2 * sp + 1) * kPixX + 30) / 16;
}

constexpr int kMaxSmem =
    kStages * (4 * (kSegElems + 4 * kMaxSp) + 3 * x_chunks(kMaxSp) * 16) +
    2 * kTapRows * (kMaxSp + 8) * 4;

// byte offsets in dynamic shared memory: kStages slots of (g, x window),
// then two im2col tiles. A staged pixel of g takes C + 4 floats, an odd
// number of 16-byte chunks, so that the 4 pixels of a B load's 8-lane
// phase meet 8 bank groups; an im2col row takes sp + 8 floats (sp a
// multiple of 16), so that the 8 taps of an A load do.
struct Layout {
  int g_bytes, slot_bytes, a_stride, a_bytes, a_off, total;
};

__host__ __device__ inline Layout layout(int sp, int C) {
  Layout l;
  l.g_bytes = sp * (C + 4) * 4;
  l.slot_bytes = l.g_bytes + 3 * x_chunks(sp) * 16;
  l.a_stride = sp + 8;
  l.a_bytes = kTapRows * l.a_stride * 4;
  l.a_off = kStages * l.slot_bytes;
  l.total = l.a_off + 2 * l.a_bytes;
  // the warps' sums reuse the ring at the end: kWarps x 32 x 32 f32
  if (l.total < kWarps * 32 * 32 * 4) l.total = kWarps * 32 * 32 * 4;
  return l;
}

__device__ __forceinline__ long long x_start(const Seg& s, int ky, int lo,
                                            int H, int W) {
  return (((long long)s.b * H + 2 * s.oy - 1 + ky) * W + lo) * kPixX;
}

// start the copies of segment s into a stage slot: g's chunk c of pixel p
// to chunk p * (C / 4 + 1) + c, zero past the row's last pixel; the input
// window as in tc::load_segment, with 12-byte pixels
__device__ __forceinline__ void load_segment(const Seg& s, uint32_t slot,
                                             unsigned char* slot_p,
                                             const float* x, const float* g,
                                             int H, int W, int C, int Wo,
                                             int sp, long long x_bytes,
                                             const Layout& L) {
  const int cpp = C / 4;
  const int nq = s.nks * 16 * cpp, valid = s.npix * cpp;
  const char* gs = reinterpret_cast<const char*>(
      g + ((size_t)s.r * Wo + s.ox0) * C);
  const int tid = threadIdx.x;
  for (int q = tid; q < nq; q += kThreads)
    cp_async16(slot + ((q + q / cpp) << 4), q < valid ? gs + 16 * q : gs,
               q < valid);

  const int xc = x_chunks(sp);
  const int lo = max(0, 2 * s.ox0 - 1);
  const int hi = min(W, 2 * (s.ox0 + s.npix));   // last column + 1
  for (int e = tid; e < 3 * xc; e += kThreads) {
    const int ky = (e >= xc) + (e >= 2 * xc), c = e - ky * xc;
    if (!x_row_ok(s, ky, H)) continue;
    const long long b0 = x_start(s, ky, lo, H, W);
    const long long byte = (b0 & ~15LL) + 16 * c;
    if (byte >= b0 + (long long)(hi - lo) * kPixX) continue;
    const int off = L.g_bytes + e * 16;
    const char* src = reinterpret_cast<const char*>(x) + byte;
    if (byte + 16 <= x_bytes) {
      cp_async16(slot + off, src, true);
    } else {   // x's last chunk, cut by the end of the tensor
      auto* d = reinterpret_cast<float*>(slot_p + off);
      const auto* v = reinterpret_cast<const float*>(src);
      const int m = (int)((x_bytes - byte) / 4);
      for (int k = 0; k < 4; ++k) d[k] = k < m ? v[k] : 0.0f;
    }
  }
}

// im2col of segment s from its staged window: a[tap][pixel] as in
// tc::build_a, in f32, two pixels a float2
__device__ __forceinline__ void build_a(const Seg& s, const unsigned char* xw,
                                        float* a, int H, int W, int sp,
                                        const Layout& L) {
  const int xc = x_chunks(sp);
  const int lo = max(0, 2 * s.ox0 - 1);
  const int pairs = s.nks * 8;
  for (int e = threadIdx.x; e < 3 * pairs; e += kThreads) {
    const int ky = (e >= pairs) + (e >= 2 * pairs), p = 2 * (e - ky * pairs);
    const bool row_ok = x_row_ok(s, ky, H);
    const unsigned char* row =
        xw + ky * xc * 16 +
        (row_ok ? (int)(x_start(s, ky, lo, H, W) & 15) : 0);
    const bool ok0 = row_ok && p < s.npix, ok1 = row_ok && p + 1 < s.npix;
    const int ix0 = 2 * (s.ox0 + p) - 1;
    float v[5][3];
#pragma unroll
    for (int d = 0; d < 5; ++d) {
      const int ix = ix0 + d;
      const bool ok = (d <= 2 ? ok0 : ok1) && ix >= 0 && ix < W;
#pragma unroll
      for (int ci = 0; ci < 3; ++ci)
        v[d][ci] = ok ? *reinterpret_cast<const float*>(
                            row + (ix - lo) * kPixX + 4 * ci)
                      : 0.0f;
    }
#pragma unroll
    for (int ci = 0; ci < 3; ++ci)
#pragma unroll
      for (int kx = 0; kx < 3; ++kx)
        *reinterpret_cast<float2*>(a + (9 * ci + 3 * ky + kx) * L.a_stride +
                                   p) =
            make_float2(ok0 ? v[kx][ci] : 0.0f, ok1 ? v[kx + 2][ci] : 0.0f);
  }
}

// The bf16 kernel's walk (tc::wgrad_mma_kernel), with 3xTF32 products on
// mma.sync m16n8k8: M = the 32 taps, N = 32 channels a warp, K = the
// pixels, 8 a step. Column t of a step stands for pixel 2 t and column
// t + 4 for pixel 2 t + 1, so a lane reads A as float2; its n8 tile j
// holds channel 32 slice + 4 (lane / 4) + j, so it reads B as one float4
// per pixel for all four tiles. Each segment's products are summed apart
// and then added by FADD.
__global__ void __launch_bounds__(kThreads, 2)
wgrad_tf32_kernel(const float* __restrict__ x, const float* __restrict__ g,
                  float* __restrict__ part, int H, int W, int C, int Ho,
                  int Wo, int R, int sp, int nseg, long long x_bytes) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout L = layout(sp, C);
  const uint32_t base = smem_u32(smem);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int gq = lane / 4, tq = lane % 4;

  const int r0 = (int)((long long)blockIdx.x * R / gridDim.x);
  const int r1 = (int)((long long)(blockIdx.x + 1) * R / gridDim.x);
  const int n_items = (r1 - r0) * nseg;

  // the padding taps 27..31 of both tiles stay zero
  for (int t = 0; t < 2; ++t) {
    float* pad = reinterpret_cast<float*>(smem + L.a_off + t * L.a_bytes) +
                 27 * L.a_stride;
    for (int e = tid; e < (kTapRows - 27) * L.a_stride; e += kThreads)
      pad[e] = 0.0f;
  }

  // warp roles: 32 output channels (a slice) and every kw_n-th k-step
  const int slices = ceil_div(C, 32), kw_n = kWarps / slices;
  const int slice = warp / kw_n, kw = warp % kw_n;
  const bool active = slice < slices;
  const int cb = 32 * slice + 4 * gq;   // this lane's B channels
  const bool c_ok = cb < C;
  const int pix_chunks = C / 4 + 1;
  float acc[2][4][4] = {};

  Seg ld, bd;   // the next segment to load, to build
  ld.start(r0, Ho, Wo, sp);
  bd = ld;
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < n_items) {
      load_segment(ld, base + i * L.slot_bytes, smem + i * L.slot_bytes, x,
                   g, H, W, C, Wo, sp, x_bytes, L);
      ld.next(Ho, Wo, sp);
    }
    cp_async_commit();
  }
  cp_async_wait<kStages - 2>();
  __syncthreads();   // segment 0 is in
  if (n_items > 0)
    build_a(bd, smem + L.g_bytes, reinterpret_cast<float*>(smem + L.a_off),
            H, W, sp, L);

  for (int i = 0; i < n_items; ++i) {
    const int nks = bd.nks;   // segment i's
    bd.next(Ho, Wo, sp);      // segment i + 1
    cp_async_wait<kStages - 3>();
    // segments i + 1 (staged) and i (im2col) are in; the slot of i - 1 and
    // the im2col tile of i - 1 are free
    __syncthreads();
    const int in = i + kStages - 1;
    if (in < n_items) {
      const int slot = in % kStages;
      load_segment(ld, base + slot * L.slot_bytes,
                   smem + slot * L.slot_bytes, x, g, H, W, C, Wo, sp,
                   x_bytes, L);
      ld.next(Ho, Wo, sp);
    }
    cp_async_commit();
    if (i + 1 < n_items)
      build_a(bd, smem + ((i + 1) % kStages) * L.slot_bytes + L.g_bytes,
              reinterpret_cast<float*>(smem + L.a_off +
                                       ((i + 1) & 1) * L.a_bytes),
              H, W, sp, L);

    if (active) {
      const float4* gb =
          reinterpret_cast<const float4*>(smem + (i % kStages) * L.slot_bytes);
      const float* ab =
          reinterpret_cast<const float*>(smem + L.a_off + (i & 1) * L.a_bytes);
      float seg[2][4][4] = {};
      for (int ks = kw; ks < 2 * nks; ks += kw_n) {
        const int p = 8 * ks + 2 * tq;
        uint32_t ah[2][4], al[2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const float2 v0 = *reinterpret_cast<const float2*>(
              ab + (16 * mt + gq) * L.a_stride + p);
          const float2 v1 = *reinterpret_cast<const float2*>(
              ab + (16 * mt + gq + 8) * L.a_stride + p);
          split_tf32(v0.x, ah[mt][0], al[mt][0]);
          split_tf32(v1.x, ah[mt][1], al[mt][1]);
          split_tf32(v0.y, ah[mt][2], al[mt][2]);
          split_tf32(v1.y, ah[mt][3], al[mt][3]);
        }
        const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        const float4 b0 = c_ok ? gb[p * pix_chunks + cb / 4] : zero;
        const float4 b1 = c_ok ? gb[(p + 1) * pix_chunks + cb / 4] : zero;
        const float v0[4] = {b0.x, b0.y, b0.z, b0.w};
        const float v1[4] = {b1.x, b1.y, b1.z, b1.w};
        uint32_t bh[4][2], bl[4][2];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          split_tf32(v0[j], bh[j][0], bl[j][0]);
          split_tf32(v1[j], bh[j][1], bl[j][1]);
        }
        mma_3xtf32(seg, ah, al, bh, bl);
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int k = 0; k < 4; ++k) acc[mt][j][k] += seg[mt][j][k];
    }
  }
  cp_async_wait_all();
  __syncthreads();

  // sum the warps of each slice in warp order: red[warp][tap][channel % 32]
  auto* red = reinterpret_cast<float*>(smem);
  if (active) {
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int tap = 16 * mt + gq + 8 * (k / 2);
          const int cl = 4 * (2 * tq + k % 2) + j;
          red[(warp * 32 + tap) * 32 + cl] = acc[mt][j][k];
        }
  }
  __syncthreads();
  float* out = part + (size_t)blockIdx.x * 27 * C;
  for (int e = tid; e < 27 * C; e += kThreads) {
    const int tap = e / C, c = e % C;
    float v = 0.0f;
    for (int k = 0; k < kw_n; ++k)
      v += red[(((c / 32) * kw_n + k) * 32 + tap) * 32 + c % 32];
    out[e] = v;
  }
}

cudaError_t launch(const void* x, const void* g, float* part, int B, int H,
                   int W, int C, int ctas, cudaStream_t stream) {
  static PerDeviceSmem smem;
  cudaError_t e = smem.opt_in((const void*)wgrad_tf32_kernel, kMaxSmem);
  if (e != cudaSuccess) return e;
  const int Ho = (H + 1) / 2, Wo = (W + 1) / 2;
  // segments of at most 16 KB of g, as even as 16-pixel steps allow
  const int sp_max = std::min(kMaxSp, kSegElems / C / 16 * 16);
  const int sp = ceil_div(ceil_div(Wo, ceil_div(Wo, sp_max)), 16) * 16;
  const int nseg = ceil_div(Wo, sp);
  wgrad_tf32_kernel<<<ctas, kThreads, layout(sp, C).total, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(g), part, H, W,
      C, Ho, Wo, B * Ho, sp, nseg, (long long)B * H * W * kPixX);
  return cudaGetLastError();
}

}  // namespace f32

// dw (C, 27) OIHW from part (nblk, 27, C), e = tap * C + c: a block per 32
// consecutive e, warp w summing the partials w, w + 8, ... in order, then
// the 8 warps in order.
__global__ void __launch_bounds__(kThreads)
wgrad_sum(const float* __restrict__ part, float* __restrict__ dw, int nblk,
          int C) {
  __shared__ float s[kWarps][32];
  const int n = 27 * C;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int e = blockIdx.x * 32 + lane;
  float v = 0.0f;
  if (e < n)
    for (int k = warp; k < nblk; k += kWarps) v += part[(size_t)k * n + e];
  s[warp][lane] = v;
  __syncthreads();
  if (warp == 0 && e < n) {
    float t = s[0][lane];
    for (int w = 1; w < kWarps; ++w) t += s[w][lane];
    dw[(e % C) * 27 + e / C] = t;
  }
}

}  // namespace
}  // namespace yolo

// x (B, H, W, 3) and g (B, ceil(H/2), ceil(W/2), C) NHWC, one dtype, 16-byte
// aligned; part (nblk, 27, C) f32 scratch; dw (C, 3, 3, 3) f32. C a
// multiple of 16 and at most 256, B*Ho*Wo below 2^31; nblk CTAs (the
// persistent grid), 1 <= nblk <= B*Ho (checked by the Python wrapper).
extern "C" int yolo_stem_wgrad(const void* x, const void* g, void* part,
                               void* dw, int B, int H, int W, int C, int nblk,
                               int dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto* p = static_cast<float*>(part);
  const cudaError_t e =
      dtype == yolo::kBFloat16
          ? yolo::tc::launch(x, g, p, B, H, W, C, nblk, s)
          : yolo::f32::launch(x, g, p, B, H, W, C, nblk, s);
  if (e != cudaSuccess) return e;
  yolo::wgrad_sum<<<yolo::ceil_div(27 * C, 32), yolo::kThreads, 0, s>>>(
      p, static_cast<float*>(dw), nblk, C);
  return cudaGetLastError();
}
