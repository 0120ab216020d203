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
//   1. pool_avg: the branch-2 window max M (in x's dtype) and its
//      first-max tap idx, and for the products that read it (every f32
//      call; bf16 with Ch and Co multiples of 8) the branch-1 avg avg1 in
//      x's dtype;
//   2. dM = g2 . w2^T, the gradient at M (tiled product);
//   3. dA1 = the transposed 3x3 stride-2 conv of g1, the gradient at the
//      branch-1 avg. Blocks take one (row, column) parity class of avg
//      pixels, so every pixel of a tile has the same 1, 2 or 4 taps: no
//      zero taps are multiplied;
//   4. dx_strips: dx = (sum of the four avg pixels' gradients) / 4; the
//      branch-2 gradient of an avg pixel is gathered from the <= 4 output
//      windows whose first max it is (no scatter);
//   5. per slab of output pixels, partial dW1 (9 taps) and dW2 (from M)
//      as tiled products over the slab's pixels;
//   6. dw_reduce: the slabs summed in a fixed order.
// The avg is summed in the order above, the plain version's
// (ops/kernels/adown.py:adown_raw_plain), so the first max is taken among
// the same f32 values, and dx sums its four terms left to right from 0.
//
// What bounds it on an H100: at gelan-c's down1 ((32, 256, 160, 160),
// Co = Ch = 128) the two 3x3 products (dA1 and dW1) are ~60 GFLOP each and
// the rest ~13 GFLOP: operations, not bytes. Where the products run:
//   - f32: all three on the tensor cores in 3xTF32 on mma.sync (namespace
//     f32: dgrad_tf32 for 2 and 3, dw_tf32 for 5), any Ch and Co;
//   - bf16, Ch and Co multiples of 8 (every gelan-c and TINY_YAML site):
//     all three on the tensor cores in bf16 on mma.sync, on the f32
//     kernels' walks (namespace bf16: dgrad_bf16 for 2 and 3, dw_bf16 for
//     5);
//   - bf16, other Ch or Co: all three on the CUDA cores (gemm_dm,
//     gemm_da1, gemm_dw: 64 x 64 output tiles, a 4 x 4 register tile per
//     thread, 16-deep chunks in shared memory). The shape picks the path
//     before any launch.
// wgmma and TMA for them are later work.
// Passes 1 and 4 do almost no arithmetic: bytes bound them. At down1 the
// dx pass must read dA1, dM (f32) and idx and write dx, 964.7 MB; the
// pool/avg pass must read x and write M, idx and avg1, 705.2 MB (0.288
// and 0.211 ms at 3.35 TB/s, bf16). Their design (the section "memory-bound
// passes" below): a thread owns 8 channels of one column (16-byte loads
// and stores), walks down a strip of rows and carries in registers what
// the next row shares with this one (dx: the pair v[y-1, x-1] + v[y-1, x]
// and the window row both avg rows 2oy -+ 1 reach; pool: the avg row
// 2oy + 1 and x row 2oy + 2), so each input row leaves device memory once
// a strip; 32-bit offsets advanced by row strides, no division in the
// row loop; a persistent grid of as many CTAs as fit on the device.

#include "common.cuh"
#include "hopper.cuh"

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

// ---------------------------------------------------------------------------
// The memory-bound passes: pool_avg (1) and dx_strips (4)
// ---------------------------------------------------------------------------
//
// A thread owns a vector lane, V consecutive channels of one branch (V = 8
// when the branch width Ch is a multiple of 8, else 1), at one column,
// and walks down a strip of rows. What the next row shares with this one
// stays in registers, so each row of its inputs leaves device memory once a
// strip; the lanes of neighbouring columns share theirs through L1. A task
// is (image, branch, strip, run of kThreads lanes of one row); a persistent
// grid of as many CTAs as fit on the device walks the tasks. Offsets are
// 32-bit (the wrapper keeps every tensor below 2^31 elements), set once a
// strip and advanced by row strides.

template <int N> struct Word;
template <> struct Word<16> { using type = uint4; };
template <> struct Word<8> { using type = uint2; };
template <> struct Word<4> { using type = unsigned int; };
template <> struct Word<2> { using type = unsigned short; };
template <> struct Word<1> { using type = unsigned char; };

// V elements between device memory (aligned to their size, or to 16 bytes
// above it) and a 16-byte aligned register array, in words of <= 16 bytes
template <int V, typename E>
__device__ __forceinline__ void vload(E (&dst)[V], const E* src) {
  constexpr int kB = V * (int)sizeof(E);
  using Wd = typename Word<(kB < 16 ? kB : 16)>::type;
#pragma unroll
  for (int i = 0; i < kB / (int)sizeof(Wd); ++i)
    reinterpret_cast<Wd*>(dst)[i] = __ldg(reinterpret_cast<const Wd*>(src) + i);
}

template <int V, typename E>
__device__ __forceinline__ void vstore(E* dst, const E (&src)[V]) {
  constexpr int kB = V * (int)sizeof(E);
  using Wd = typename Word<(kB < 16 ? kB : 16)>::type;
#pragma unroll
  for (int i = 0; i < kB / (int)sizeof(Wd); ++i)
    reinterpret_cast<Wd*>(dst)[i] = reinterpret_cast<const Wd*>(src)[i];
}

// NC columns of one x row (column k valid where ok[k]; 0 elsewhere)
template <int NC, int V, typename T>
__device__ __forceinline__ void load_cols(T (&r)[NC][V], const T* p, int Cin,
                                          const bool (&ok)[NC]) {
#pragma unroll
  for (int k = 0; k < NC; ++k) {
    if (ok[k]) {
      vload(r[k], p + k * Cin);
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j) r[k][j] = from_f32<T>(0.0f);
    }
  }
}

// the avg at NC - 1 columns from two x rows, avg4's order
template <int NC, int V, typename T>
__device__ __forceinline__ void avg_cols(float (&a)[NC - 1][V],
                                         const T (&top)[NC][V],
                                         const T (&bot)[NC][V]) {
#pragma unroll
  for (int k = 0; k + 1 < NC; ++k)
#pragma unroll
    for (int j = 0; j < V; ++j)
      a[k][j] = ((to_f32(top[k][j]) + to_f32(top[k + 1][j])) +
                 (to_f32(bot[k][j]) + to_f32(bot[k + 1][j]))) * 0.25f;
}

// the first max so far over one avg row of a window (taps 3 ky + kx)
template <int V>
__device__ __forceinline__ void take_max(float (&m)[V],
                                         unsigned char (&arg)[V],
                                         const float (&a)[3][V], int ky,
                                         const bool (&ok)[3]) {
#pragma unroll
  for (int kx = 0; kx < 3; ++kx) {
    if (!ok[kx]) continue;
#pragma unroll
    for (int j = 0; j < V; ++j)
      if (a[kx][j] > m[j]) {
        m[j] = a[kx][j];
        arg[j] = (unsigned char)(3 * ky + kx);
      }
  }
}

// 1a. branch 2: M and idx of output rows [o0, o1) at column ox, channels
//     Ch + c.. of x. The avg row 2oy + 1, the window's last, is the next
//     window's first and is carried, and so is x row 2oy + 2.
template <typename T, int V>
__device__ __forceinline__ void pool_strip(const T* __restrict__ x,
                                           T* __restrict__ M,
                                           unsigned char* __restrict__ idx,
                                           int b, int H, int W, int Cin,
                                           int Ho, int Wo, int ox, int c,
                                           int o0, int o1) {
  const int Ch = Cin / 2, cx = 2 * ox - 1, row = W * Cin;
  bool col_ok[4], avg_ok[3];
#pragma unroll
  for (int k = 0; k < 4; ++k) col_ok[k] = cx + k >= 0 && cx + k <= W - 1;
#pragma unroll
  for (int k = 0; k < 3; ++k) avg_ok[k] = cx + k >= 0 && cx + k <= W - 2;
  // x at (b, 2 o0, cx, Ch + c); may lie before x when cx = -1, read only
  // through valid columns
  int ox_off = ((b * H + 2 * o0) * W + cx) * Cin + Ch + c;
  alignas(16) T x0[4][V], x1[4][V];
  alignas(16) float a0[3][V], a[3][V];
  load_cols(x0, x + ox_off, Cin, col_ok);          // x row 2 o0 <= H - 2
  if (o0 > 0) {
    load_cols(x1, x + ox_off - row, Cin, col_ok);
    avg_cols(a0, x1, x0);                          // avg row 2 o0 - 1
  }
  int om = ((b * Ho + o0) * Wo + ox) * Ch + c;
  for (int oy = o0; oy < o1; ++oy, om += Wo * Ch, ox_off += 2 * row) {
    alignas(16) float m[V];
    alignas(16) T mx[V];
    alignas(16) unsigned char arg[V];
#pragma unroll
    for (int j = 0; j < V; ++j) {
      m[j] = -CUDART_INF_F;
      arg[j] = 0;
    }
    if (oy > 0) take_max(m, arg, a0, 0, avg_ok);
    load_cols(x1, x + ox_off + row, Cin, col_ok);  // row 2 oy + 1 <= H - 1
    avg_cols(a, x0, x1);
    take_max(m, arg, a, 1, avg_ok);
    if (2 * oy + 1 <= H - 2) {
      load_cols(x0, x + ox_off + 2 * row, Cin, col_ok);
      avg_cols(a0, x1, x0);
      take_max(m, arg, a0, 2, avg_ok);
    }
#pragma unroll
    for (int j = 0; j < V; ++j) mx[j] = from_f32<T>(m[j]);
    vstore(M + om, mx);
    vstore(idx + om, arg);
  }
}

// 1b. branch 1 (the tensor-core products only): avg1 at avg rows 2oy, 2oy + 1 and
//     columns 2ox, 2ox + 1 for oy in [o0, o1), channels c..; x row 2oy + 2
//     is carried
template <typename T, int V>
__device__ __forceinline__ void avg_strip(const T* __restrict__ x,
                                          T* __restrict__ avg1, int b, int H,
                                          int W, int Cin, int ox, int c,
                                          int o0, int o1) {
  const int Ch = Cin / 2, HA = H - 1, WA = W - 1, cx = 2 * ox;
  const int row = W * Cin;
  const bool col_ok[3] = {true, true, cx + 2 <= W - 1};
  const bool right = cx + 1 <= W - 2;               // avg column 2ox + 1
  int ox_off = ((b * H + 2 * o0) * W + cx) * Cin + c;
  int oa = ((b * HA + 2 * o0) * WA + cx) * Ch + c;
  alignas(16) T x0[3][V], x1[3][V], out[V];
  alignas(16) float a[2][V];
  load_cols(x0, x + ox_off, Cin, col_ok);
  for (int oy = o0; oy < o1; ++oy, ox_off += 2 * row, oa += 2 * WA * Ch) {
    load_cols(x1, x + ox_off + row, Cin, col_ok);
    avg_cols(a, x0, x1);                            // avg row 2oy
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      if (k == 1 && !right) break;
#pragma unroll
      for (int j = 0; j < V; ++j) out[j] = from_f32<T>(a[k][j]);
      vstore(avg1 + oa + k * Ch, out);
    }
    if (2 * oy + 1 > H - 2) break;                  // the last avg row
    load_cols(x0, x + ox_off + 2 * row, Cin, col_ok);
    avg_cols(a, x1, x0);                            // avg row 2oy + 1
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      if (k == 1 && !right) break;
#pragma unroll
      for (int j = 0; j < V; ++j) out[j] = from_f32<T>(a[k][j]);
      vstore(avg1 + oa + WA * Ch + k * Ch, out);
    }
  }
}

// 1. M (B, Ho, Wo, Ch) in x's dtype (the f32 max, rounded once) and idx
//    (tap 3 ky + kx of the first max), and for the tensor-core products
//    (avg1 not null) the branch-1 avg avg1 (B, H-1, W-1, Ch). Tasks: (b,
//    branch, strip of R output rows, run of kThreads lanes of the Wo * Ch /
//    V of a row), the run fastest.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
pool_avg(const T* __restrict__ x, T* __restrict__ M,
         unsigned char* __restrict__ idx, T* __restrict__ avg1, int B, int H,
         int W, int Cin, int Ho, int Wo, int R, int strips, int runs) {
  const int G = Cin / 2 / V, lanes = Wo * G;
  const int per_image = (avg1 ? 2 : 1) * strips * runs;
  const int tasks = B * per_image;
  for (int task = blockIdx.x; task < tasks; task += gridDim.x) {
    const int b = task / per_image, t = task % per_image;
    const int br = t / (strips * runs), strip = t / runs % strips;
    const int lane = t % runs * kThreads + (int)threadIdx.x;
    if (lane >= lanes) continue;
    const int ox = lane / G, c = lane % G * V;
    const int o0 = strip * R, o1 = min(o0 + R, Ho);
    if (br == 0)
      pool_strip<T, V>(x, M, idx, b, H, W, Cin, Ho, Wo, ox, c, o0, o1);
    else
      avg_strip<T, V>(x, avg1, b, H, W, Cin, ox, c, o0, o1);
  }
}

// dM and idx of one output-window row at columns oxL (k 0) and oxL + 1
// (k 1) and channels c..; idx 0xFF (no tap) where the window is outside
template <int V>
struct WinRow {
  alignas(16) float d[2][V];
  alignas(16) unsigned char k[2][V];
};

// the branch-2 gradient terms of one window row (ky) at avg columns x - 1
// (l) and x (r), in da2's old column order: an odd avg column is reached
// by kx = 0 from window column oxL + 1 (k 1), then by kx = 2 from oxL
// (k 0); an even one by kx = 1 from the one window column over it. The
// terms a lane does not have are added as +0, which leaves every sum as
// it was (a sum from +0 is never -0), so all lanes of a warp run the same
// instructions whatever their column's parity.
template <int V>
__device__ __forceinline__ void win_terms(float (&l)[V], float (&r)[V],
                                          const WinRow<V>& w, int ky,
                                          bool x_even) {
  const int l1 = x_even ? 3 * ky : -1, l0 = 3 * ky + (x_even ? 2 : 1);
  const int r1 = 3 * ky + (x_even ? 1 : 0), r0 = x_even ? -1 : 3 * ky + 2;
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const int k0 = w.k[0][j], k1 = w.k[1][j];
    l[j] += k1 == l1 ? w.d[1][j] : 0.0f;
    l[j] += k0 == l0 ? w.d[0][j] : 0.0f;
    r[j] += k1 == r1 ? w.d[1][j] : 0.0f;
    r[j] += k0 == r0 ? w.d[0][j] : 0.0f;
  }
}

// branch 1's avg gradients: dA1 at avg columns x - 1 (l) and x (r), row by
// row from the first; the next row is fetched while this one is used
template <int V>
struct Da1Rows {
  const float* dA1;
  int off, stride, Ch, left;   // (b, ay, x - 1, c); WA * Ch; rows to fetch
  bool in_l, in_r;
  alignas(16) float sl[V], sr[V];

  __device__ __forceinline__ void fetch() {
    if (left-- <= 0) return;
    if (in_l) vload(sl, dA1 + off);
    if (in_r) vload(sr, dA1 + off + Ch);
    off += stride;
  }

  __device__ __forceinline__ void next(float (&l)[V], float (&r)[V]) {
#pragma unroll
    for (int j = 0; j < V; ++j) {
      l[j] = sl[j];
      r[j] = sr[j];
    }
    fetch();
  }
};

// branch 2's: the dM of every window whose first max sits at the avg
// pixel, in da2's old order (the window rows oy = (ay + 1 - ky) / 2 for ky
// = 0, 2 of an odd ay, ky = 1 of an even one; then the columns). The
// window row both avg rows 2oy - 1 and 2oy + 1 reach is carried (`hi`), so
// each window row is read once a strip, and the next one is fetched ahead
// (`ahead`).
template <int V>
struct Da2Rows {
  const float* dM;
  const unsigned char* idx;
  int off, stride, Ch;         // (b, oy_next, oxL, c); Wo * Ch
  int ay, oy_next, oy_end;     // the next avg row; window rows to fetch
  bool ok_l, ok_r, x_even;
  WinRow<V> hi;                // window row ay / 2 (rounded down)
  WinRow<V> ahead;             // window row (ay + 1) / 2 + (ay & 1 ? 0 : 1)

  __device__ __forceinline__ void load(WinRow<V>& w) {
    const bool ok = oy_next < oy_end;
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      if (ok && (k ? ok_r : ok_l)) {
        vload(w.d[k], dM + off + k * Ch);
        vload(w.k[k], idx + off + k * Ch);
      } else {
#pragma unroll
        for (int j = 0; j < V; ++j) {
          w.d[k][j] = 0.0f;
          w.k[k][j] = 0xFF;
        }
      }
    }
    ++oy_next;
    off += stride;
  }

  __device__ __forceinline__ void next(float (&l)[V], float (&r)[V]) {
#pragma unroll
    for (int j = 0; j < V; ++j) l[j] = r[j] = 0.0f;
    if (ay & 1) {
      win_terms(l, r, ahead, 0, x_even);   // oy = (ay + 1) / 2, ky = 0
      win_terms(l, r, hi, 2, x_even);
      hi = ahead;
      load(ahead);
    } else {
      win_terms(l, r, hi, 1, x_even);
    }
    ++ay;
  }
};

// dx rows [y0, y1) at one column from the avg gradients of rows
// max(y0 - 1, 0).. : s = ((P + v[y, x-1]) + v[y, x]) with P = (0 + v[y-1,
// x-1]) + v[y-1, x] carried from the row above, pixels outside the avg
// domain skipped: the old left-to-right order from s = 0, so dx is the same
// to the bit
template <typename T, int V, typename Src>
__device__ __forceinline__ void dx_walk(Src& src, T* __restrict__ dx, int od,
                                        int stride, int y0, int y1, int H,
                                        bool in_l, bool in_r) {
  alignas(16) float p[V], l[V], r[V];
  alignas(16) T out[V];
#pragma unroll
  for (int j = 0; j < V; ++j) p[j] = 0.0f;
  if (y0 > 0) {
    src.next(l, r);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      float q = 0.0f;
      if (in_l) q += l[j];
      if (in_r) q += r[j];
      p[j] = q;
    }
  }
  for (int y = y0; y < y1; ++y, od += stride) {
    if (y <= H - 2) {
      src.next(l, r);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        float s = p[j], q = 0.0f;
        if (in_l) {
          s += l[j];
          q += l[j];
        }
        if (in_r) {
          s += r[j];
          q += r[j];
        }
        out[j] = from_f32<T>(0.25f * s);
        p[j] = q;
      }
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j) out[j] = from_f32<T>(0.25f * p[j]);
    }
    vstore(dx + od, out);
  }
}

// 4. dx[b, y, x, c] = (sum of the avg gradients at (y-1|y, x-1|x)) / 4.
//    Tasks: (b, branch, strip of R dx rows, run of kThreads lanes of the
//    W * Ch / V of a row and branch), the run fastest. Held to 128
//    registers, two CTAs an SM: left free, nvcc takes ~150 and one CTA
//    fits, and the pass ran 1.4x longer at down1 on an H100.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads, 2)
dx_strips(const float* __restrict__ dA1, const float* __restrict__ dM,
          const unsigned char* __restrict__ idx, T* __restrict__ dx, int B,
          int H, int W, int Cin, int Ho, int Wo, int R, int strips,
          int runs) {
  const int Ch = Cin / 2, HA = H - 1, WA = W - 1, G = Ch / V, lanes = W * G;
  const int per_image = 2 * strips * runs, tasks = B * per_image;
  for (int task = blockIdx.x; task < tasks; task += gridDim.x) {
    const int b = task / per_image, t = task % per_image;
    const int br = t / (strips * runs), strip = t / runs % strips;
    const int lane = t % runs * kThreads + (int)threadIdx.x;
    if (lane >= lanes) continue;
    const int x = lane / G, c = lane % G * V;
    const int y0 = strip * R, y1 = min(y0 + R, H);
    // the avg rows the walk reads: the one above the strip, if any, to
    // the strip's last in the avg domain
    const int a0 = y0 > 0 ? y0 - 1 : 0, a1 = min(y1, H - 1);
    const bool in_l = x >= 1, in_r = x <= W - 2;
    const int od = ((b * H + y0) * W + x) * Cin + br * Ch + c;
    if (br == 0) {
      Da1Rows<V> src;
      src.dA1 = dA1;
      src.off = ((b * HA + a0) * WA + x - 1) * Ch + c;
      src.stride = WA * Ch;
      src.Ch = Ch;
      src.left = a1 - a0;
      src.in_l = in_l;
      src.in_r = in_r;
      src.fetch();
      dx_walk<T, V>(src, dx, od, W * Cin, y0, y1, H, in_l, in_r);
    } else {
      const int ox_l = x >= 1 ? (x - 1) / 2 : -1;
      Da2Rows<V> src;
      src.dM = dM;
      src.idx = idx;
      src.stride = Wo * Ch;
      src.Ch = Ch;
      src.ok_l = ox_l >= 0 && ox_l < Wo;
      src.ok_r = ox_l + 1 < Wo;
      src.x_even = !(x & 1);
      src.ay = a0;
      src.oy_next = a0 / 2;
      // the last window row reached: (ay + 1) / 2 of the last avg row
      src.oy_end = min(a1 / 2 + 1, Ho);
      src.off = ((b * Ho + src.oy_next) * Wo + ox_l) * Ch + c;
      src.load(src.hi);
      src.load(src.ahead);
      dx_walk<T, V>(src, dx, od, W * Cin, y0, y1, H, in_l, in_r);
    }
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

// 5. part[s, q, ci, co]: for tap q < 9, sum over the slab's output pixels
//    of avg1pad[2oy-1+ky, 2ox-1+kx, ci] * g[p, co]; for q = 9,
//    M[p, ci] * g[p, Co + co]
template <typename T>
__global__ void __launch_bounds__(kThreads)
gemm_dw(const T* __restrict__ x, const T* __restrict__ g,
        const T* __restrict__ M, float* __restrict__ part, int H, int W,
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
          v = to_f32(M[(size_t)p * Ch + ci0 + m]);
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
// f32 inputs: products 2, 3 and 5 on the tensor cores in 3xTF32
// ---------------------------------------------------------------------------
//
// mma.sync m16n8k8 in TF32 with every f32 operand split into hi and lo as
// it leaves shared memory (hopper.cuh: split_tf32, mma_3xtf32), as the f32
// chain and stem weight gradient do. A warp owns two (dW) or four (dA1,
// dM) m16 tiles by four n8 tiles of outputs; K runs in chunks of 32
// staged by cp.async into a 3-deep ring of padded shared rows (16-byte
// copies when Ch and Co are multiples of 4, else 4-byte ones; zero fill
// past every edge). Each chunk's products are summed apart on the tensor
// cores and then added into the accumulators by FADD, in chunk order: no
// atomics, the same result on every run. Outputs leave as 16-byte stores: a lane holds 8
// consecutive channels of a row, one 32-byte sector. The three products:
//   dW (5):  blocks of 16 warps, M = 128 input channels, N = 128 output
//            channels, K = the slab's output pixels; A the branch-1 avg
//            that pool_avg writes once in f32 (the values avg4 gave, to
//            the bit) at the tap's pixels, or M for q = 9; B the rows of
//            g. A block per (slab, tap, channel tiles); the 10 taps of a
//            slab are neighbours in the grid and read the slab's g
//            together through L2. A thread steps the output pixels of its
//            A rows from chunk to chunk (no division).
//   dA1 (3): blocks of 4 warps, two an SM, M = 64 avg pixels of one
//            parity class, N = 128 input channels, K = Co x the class's 1,
//            2 or 4 taps; A the g rows of each tap's output pixels, B
//            w1t[tap].
//   dM (2):  the same blocks, M = 64 output pixels, K = Co; A the g2 rows,
//            B w2t.
// What sets their time, from scratch builds with one stage removed at a
// time (H100, gelan-c's down1): the product loop alone runs well below
// the 3xTF32 rate and is bound by its shared-memory loads (splitting
// each staged element once per block, hi and lo both staged, doubled the
// loads and ran slower); staging alone costs a large part of the loop's
// time and overlaps it only in part. dW's blocks run 128 chunks, so 16
// warps with 128 x 128 outputs (1.5x fewer operand bytes per output)
// paid; dA1's run ~9, and two small blocks an SM overlap one block's
// start and end with the other's products (there, 64 x 32 outputs a warp
// also ran faster than 32 x 32; for dW they did not). Scattered 4-byte
// stores of dA1 and dM had cost a large share of their time.
// A lane's fragment elements are chosen so that it reads shared memory in
// 16-byte (or 8-byte) words: which channel or pixel a column k or row m of
// an m16n8k8 tile stands for is free, as long as A, B and the outputs
// agree (hopper.cuh: mma_m16n8k8_tf32 gives the fragment layout).
namespace f32 {

using namespace sm90;

constexpr int kKc = 32;           // K chunk
constexpr int kStages = 3;        // cp.async ring depth
// dW: a block of 16 warps (4 x 4), 128 input channels (M) by 128 output
// channels (N); [pixel][ci] and [pixel][co] rows, their stride 8 mod 32
// floats, so the 8 lanes of a 16-byte load phase (rows tq, columns 4 gq)
// meet 8 distinct bank groups
constexpr int kWThreads = 512, kWM = 128, kWN = 128;
constexpr int kWALd = kWM + 8, kWBLd = kWN + 8;
constexpr int kWStage = kKc * (kWALd + kWBLd);              // floats
// dA1, dM: a block of 4 warps (1 x 4), 64 pixels (M) by 128 input
// channels (N), two blocks an SM; [pixel][co] rows (8-byte loads, rows
// gq: 8 mod 32) and [co][ci] rows (16-byte loads, rows 2 tq: 4 mod 32)
constexpr int kDM = 64, kDN = 128;
constexpr int kDMT = 4;   // m16 tiles a warp: 64 x 32 outputs
constexpr int kDThreads = 32 * (kDM / (16 * kDMT)) * (kDN / 32);
constexpr int kDALd = kKc + 8, kDBLd = kDN + 4;
constexpr int kDStage = kDM * kDALd + kKc * kDBLd;          // floats
constexpr int kWSmem = kStages * kWStage * 4;               // bytes
constexpr int kDSmem = kStages * kDStage * 4;

// E consecutive f32 (E = 4: 16 bytes, E = 1: 4) global -> shared, zeros
// where !valid (src is then not read)
template <int E>
__device__ __forceinline__ void copy(uint32_t dst, const float* src,
                                     bool valid) {
  if constexpr (E == 4)
    cp_async16(dst, src, valid);
  else
    cp_async4(dst, src, valid);
}

__device__ __forceinline__ void split4(float4 v, uint32_t (&hi)[4],
                                       uint32_t (&lo)[4]) {
  split_tf32(v.x, hi[0], lo[0]);
  split_tf32(v.y, hi[1], lo[1]);
  split_tf32(v.z, hi[2], lo[2]);
  split_tf32(v.w, hi[3], lo[3]);
}

// B fragments of four n8 tiles from rows k (b0) and k' (b1): column g of
// tile j is element j of a lane's float4
__device__ __forceinline__ void b_frags(const float* r0, const float* r1,
                                        uint32_t (&bh)[4][2],
                                        uint32_t (&bl)[4][2]) {
  uint32_t h0[4], l0[4], h1[4], l1[4];
  split4(*reinterpret_cast<const float4*>(r0), h0, l0);
  split4(*reinterpret_cast<const float4*>(r1), h1, l1);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    bh[j][0] = h0[j];
    bh[j][1] = h1[j];
    bl[j][0] = l0[j];
    bl[j][1] = l1[j];
  }
}

// the outputs of row r (0: g, 1: g + 8) of a lane's m16 tile mt: columns
// c + j (k = 2 r) and c + 4 + j (k = 2 r + 1) of row `row` (C columns),
// as two 16-byte stores where rows and c are 16-byte aligned (E = 4)
template <int E, int MT>
__device__ __forceinline__ void store_row(float* row, int c, int C,
                                          const float (&acc)[MT][4][4],
                                          int mt, int r) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int k = 2 * r + h, ch = c + 4 * h;
    if constexpr (E == 4) {
      if (ch < C)
        *reinterpret_cast<float4*>(row + ch) = make_float4(
            acc[mt][0][k], acc[mt][1][k], acc[mt][2][k], acc[mt][3][k]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (ch + j < C) row[ch + j] = acc[mt][j][k];
    }
  }
}

template <int MT>
__device__ __forceinline__ void add_seg(float (&acc)[MT][4][4],
                                        const float (&seg)[MT][4][4]) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[mt][j][k] += seg[mt][j][k];
}

// 5. part[s, q, ci, co] as gemm_dw. A k8 step's column t stands for pixel
//    t of the step and t + 4 for pixel t + 4; the warp's row g of m16 tile
//    mt for channel wm + 4 g + 2 mt and row g + 8 for the one after it, and
//    column g of n8 tile j for wn + 4 g + j: a lane reads A and B as one
//    float4 per pixel row. A thread copies the same pixel rows of every
//    chunk, whose output pixel it steps by kKc a chunk (no division).
template <int E>
__global__ void __launch_bounds__(kWThreads, 1)
dw_tf32(const float* __restrict__ avg1, const float* __restrict__ g,
        const float* __restrict__ M, float* __restrict__ part, int H, int W,
        int Ho, int Wo, int Ch, int Co, int N, int slab, int co_tiles) {
  extern __shared__ __align__(16) float smem[];
  const int q = blockIdx.x % 10, tile = blockIdx.x / 10, s = blockIdx.y;
  const int ci0 = tile / co_tiles * kWM, co0 = tile % co_tiles * kWN;
  const int HA = H - 1, WA = W - 1, Cout = 2 * Co;
  const int ky = q / 3, kx = q % 3, goff = q == 9 ? Co : 0;
  const int p_begin = s * slab, p_end = min(p_begin + slab, N);
  const int chunks = p_end > p_begin ? ceil_div(p_end - p_begin, kKc) : 0;
  const uint32_t base = smem_u32(smem);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int gq = lane / 4, tq = lane % 4;
  const int wm = 32 * (warp / 4), wn = 32 * (warp % 4);

  // A copies: rows ka + i kAStep of a chunk, channels ci0 + E (tid % av);
  // (b, oy, ox) of row i's pixel in the next chunk to load
  constexpr int av = kWM / E, bv = kWN / E;    // copies a pixel row
  constexpr int kAN = kKc * av / kWThreads, kAStep = kWThreads / av;
  const int ka = tid / av, cia = ci0 + E * (tid % av);
  int pb[kAN], poy[kAN], pox[kAN];
#pragma unroll
  for (int i = 0; i < kAN; ++i) {
    const int p = p_begin + ka + i * kAStep, t = p / Wo;
    pox[i] = p - t * Wo;
    pb[i] = t / Ho;
    poy[i] = t - pb[i] * Ho;
  }

  auto load = [&](int c) {   // called for c = 0, 1, 2, ... in turn
    const uint32_t a_s = base + (c % kStages) * kWStage * 4;
    const uint32_t b_s = a_s + kKc * kWALd * 4;
    const int pk = p_begin + c * kKc;
#pragma unroll
    for (int i = 0; i < kAN; ++i) {
      const int k = ka + i * kAStep, p = pk + k;
      bool ok = p < p_end && cia < Ch;
      const float* src = M;
      if (q == 9) {
        if (ok) src = M + (size_t)p * Ch + cia;
      } else {
        const int ay = 2 * poy[i] - 1 + ky, ax = 2 * pox[i] - 1 + kx;
        ok = ok && in_avg(ay, ax, H, W);
        if (ok)
          src = avg1 + (((size_t)pb[i] * HA + ay) * WA + ax) * Ch + cia;
      }
      copy<E>(a_s + 4 * (k * kWALd + cia - ci0), src, ok);
      for (pox[i] += kKc; pox[i] >= Wo;) {
        pox[i] -= Wo;
        if (++poy[i] == Ho) {
          poy[i] = 0;
          ++pb[i];
        }
      }
    }
    for (int e = tid; e < kKc * bv; e += kWThreads) {
      const int k = e / bv, co = co0 + E * (e % bv), p = pk + k;
      const bool ok = p < p_end && co < Co;
      copy<E>(b_s + 4 * (k * kWBLd + co - co0),
              ok ? g + (size_t)p * Cout + goff + co : g, ok);
    }
  };

  float acc[2][4][4] = {};
  for (int c = 0; c < kStages - 1; ++c) {
    if (c < chunks) load(c);
    cp_async_commit();
  }
  for (int c = 0; c < chunks; ++c) {
    cp_async_wait<kStages - 2>();
    __syncthreads();   // chunk c is in; every warp is done with c - 1
    if (c + kStages - 1 < chunks) load(c + kStages - 1);
    cp_async_commit();
    const float* a_s = smem + (c % kStages) * kWStage;
    const float* b_s = a_s + kKc * kWALd;
    float seg[2][4][4] = {};
#pragma unroll
    for (int ks = 0; ks < kKc; ks += 8) {
      uint32_t h0[4], l0[4], h1[4], l1[4];
      split4(*reinterpret_cast<const float4*>(
                 a_s + (ks + tq) * kWALd + wm + 4 * gq), h0, l0);
      split4(*reinterpret_cast<const float4*>(
                 a_s + (ks + tq + 4) * kWALd + wm + 4 * gq), h1, l1);
      const uint32_t ah[2][4] = {{h0[0], h0[1], h1[0], h1[1]},
                                 {h0[2], h0[3], h1[2], h1[3]}};
      const uint32_t al[2][4] = {{l0[0], l0[1], l1[0], l1[1]},
                                 {l0[2], l0[3], l1[2], l1[3]}};
      uint32_t bh[4][2], bl[4][2];
      b_frags(b_s + (ks + tq) * kWBLd + wn + 4 * gq,
              b_s + (ks + tq + 4) * kWBLd + wn + 4 * gq, bh, bl);
      mma_3xtf32(seg, ah, al, bh, bl);
    }
    add_seg(acc, seg);
  }
  cp_async_wait_all();

  // d[mt][j]: channels ci (k 0, 1) and ci + 1 (k 2, 3), output channels
  // co0 + wn + 8 tq + j (k even) and + 4 (k odd)
  float* out = part + ((size_t)s * 10 + q) * Ch * Co;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int ci = ci0 + wm + 4 * gq + 2 * mt + r;
      if (ci < Ch)
        store_row<E>(out + (size_t)ci * Co, co0 + wn + 8 * tq, Co, acc, mt,
                     r);
    }
}

// 2. and 3. dM (kDa1 false) as gemm_dm, dA1 (kDa1 true) as gemm_da1: a
//    block of 64 pixels and 128 input channels; K runs over the taps
//    (dA1) and 32-channel chunks of Co. dM's pixels are the output pixels
//    in order; dA1's those of one parity class (py, px), the avg pixels
//    (2 cy + py, 2 cx + px) of every image in order, so every row of a
//    block has the same 1, 2 or 4 taps. A k8 step's column t stands for
//    channel 2 t of the step and t + 4 for 2 t + 1, so a lane reads A as a
//    float2 per pixel row; column g of n8 tile j stands for channel
//    wn + 4 g + j, so it reads B as one float4 per channel row.
template <int E, bool kDa1>
__global__ void __launch_bounds__(kDThreads, 2)
dgrad_tf32(const float* __restrict__ g, const float* __restrict__ wt,
           float* __restrict__ out, int B, int Ho, int Wo, int HA, int WA,
           int Co, int Ch, int N, int ci_tiles) {
  extern __shared__ __align__(16) float smem[];
  const int cls = kDa1 ? blockIdx.y / ci_tiles : 0;
  const int ci0 = (blockIdx.y % ci_tiles) * kDN;
  const int py = cls >> 1, px = cls & 1;
  // the class's rows and columns of avg pixels
  const int cr = (HA - py + 1) / 2, cc = (WA - px + 1) / 2;
  const int rows = kDa1 ? B * cr * cc : N, m0 = blockIdx.x * kDM;
  if (m0 >= rows) return;   // the classes with fewer pixels
  const int Cout = 2 * Co, cchunks = ceil_div(Co, kKc);
  const int ntx = px ? 2 : 1;
  const int chunks = (kDa1 ? (py ? 2 : 1) * ntx : 1) * cchunks;
  const uint32_t base = smem_u32(smem);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int gq = lane / 4, tq = lane % 4;
  const int wm = 16 * kDMT * (warp / 4), wn = 32 * (warp % 4);

  // block row m: dA1 the avg pixel (b, ay, ax), dM the output pixel p (in
  // b)
  auto pixel = [&](int m, int& b, int& ay, int& ax) {
    const int n = m0 + m;
    if constexpr (kDa1) {
      const int t = n / cc;
      ax = 2 * (n - t * cc) + px;
      b = t / cr;
      ay = 2 * (t - b * cr) + py;
    } else {
      b = n;
      ay = ax = 0;
    }
  };

  // A copies: rows ma + i kAStep, channels E (tid % av) of each chunk
  constexpr int av = kKc / E, bv = kDN / E;    // copies a row
  constexpr int kAN = kDM * av / kDThreads, kAStep = kDThreads / av;
  const int ma = tid / av, va = E * (tid % av);
  int rb[kAN], ray[kAN], rax[kAN];
#pragma unroll
  for (int i = 0; i < kAN; ++i) {
    pixel(ma + i * kAStep, rb[i], ray[i], rax[i]);
    if (m0 + ma + i * kAStep >= rows) rb[i] = -1;
  }

  auto load = [&](int c) {
    const uint32_t a_s = base + (c % kStages) * kDStage * 4;
    const uint32_t b_s = a_s + kDM * kDALd * 4;
    const int t = c / cchunks, co0 = (c % cchunks) * kKc;
    // an even avg row is reached by ky = 1 only, an odd one by ky = 0 and
    // 2 (gemm_da1's tap order)
    const int ky = py ? 2 * (t / ntx) : 1, kx = px ? 2 * (t % ntx) : 1;
    const int tap = kDa1 ? 3 * ky + kx : 0;
    const int co = co0 + va;
#pragma unroll
    for (int i = 0; i < kAN; ++i) {
      bool ok = rb[i] >= 0 && co < Co;
      size_t off;
      if constexpr (kDa1) {
        const int oy = (ray[i] + 1 - ky) / 2, ox = (rax[i] + 1 - kx) / 2;
        ok = ok && oy < Ho && ox < Wo;
        off = (((size_t)rb[i] * Ho + oy) * Wo + ox) * Cout + co;
      } else {
        off = (size_t)rb[i] * Cout + Co + co;
      }
      copy<E>(a_s + 4 * ((ma + i * kAStep) * kDALd + va), ok ? g + off : g,
              ok);
    }
    for (int e = tid; e < kKc * bv; e += kDThreads) {
      const int k = e / bv, ci = ci0 + E * (e % bv);
      const bool ok = co0 + k < Co && ci < Ch;
      copy<E>(b_s + 4 * (k * kDBLd + ci - ci0),
              ok ? wt + ((size_t)tap * Co + co0 + k) * Ch + ci : wt, ok);
    }
  };

  float acc[kDMT][4][4] = {};
  for (int c = 0; c < kStages - 1; ++c) {
    if (c < chunks) load(c);
    cp_async_commit();
  }
  for (int c = 0; c < chunks; ++c) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    if (c + kStages - 1 < chunks) load(c + kStages - 1);
    cp_async_commit();
    const float* a_s = smem + (c % kStages) * kDStage;
    const float* b_s = a_s + kDM * kDALd;
    float seg[kDMT][4][4] = {};
#pragma unroll
    for (int ks = 0; ks < kKc; ks += 8) {
      uint32_t ah[kDMT][4], al[kDMT][4];
#pragma unroll
      for (int mt = 0; mt < kDMT; ++mt) {
        const float* r = a_s + (wm + 16 * mt + gq) * kDALd + ks + 2 * tq;
        const float2 v0 = *reinterpret_cast<const float2*>(r);
        const float2 v1 = *reinterpret_cast<const float2*>(r + 8 * kDALd);
        split_tf32(v0.x, ah[mt][0], al[mt][0]);
        split_tf32(v1.x, ah[mt][1], al[mt][1]);
        split_tf32(v0.y, ah[mt][2], al[mt][2]);
        split_tf32(v1.y, ah[mt][3], al[mt][3]);
      }
      uint32_t bh[4][2], bl[4][2];
      b_frags(b_s + (ks + 2 * tq) * kDBLd + wn + 4 * gq,
              b_s + (ks + 2 * tq + 1) * kDBLd + wn + 4 * gq, bh, bl);
      mma_3xtf32(seg, ah, al, bh, bl);
    }
    add_seg(acc, seg);
  }
  cp_async_wait_all();

  // d[mt][j]: rows wm + 16 mt + gq (k 0, 1) and + 8 (k 2, 3), channels
  // wn + 8 tq + j (k even) and + 4 (k odd)
#pragma unroll
  for (int mt = 0; mt < kDMT; ++mt)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int m = wm + 16 * mt + gq + 8 * r;
      if (m0 + m >= rows) continue;
      int b, ay, ax;
      pixel(m, b, ay, ax);
      const size_t row =
          (kDa1 ? ((size_t)b * HA + ay) * WA + ax : (size_t)b) * Ch;
      store_row<E>(out + row, ci0 + wn + 8 * tq, Ch, acc, mt, r);
    }
}

}  // namespace f32

// ---------------------------------------------------------------------------
// bf16 inputs, Ch and Co multiples of 8: products 2, 3 and 5 on bf16 mma.sync
// ---------------------------------------------------------------------------
//
// The walks of namespace f32 (the dW grid with the 10 taps of a slab as
// neighbours and pixels stepped without division, dA1 by parity class, a
// 3-deep cp.async ring with zero fill past every edge, 16-byte output
// stores) with bf16 operands: one mma.sync m16n8k16 (hopper.cuh:
// mma_m16n8k16) where the f32 kernels issue three m16n8k8, fragments by
// ldmatrix, 64-deep K chunks (four k16 steps a barrier). Every operand row
// is bf16 in shared memory, staged by 16-byte cp.async (8 channels), in
// rows padded by 8 elements so that the 8 rows an ldmatrix reads lie in
// distinct bank groups. The operands are the values the TPU kernel
// multiplies (adown_train_kernel.py: bf16 g, bf16 weights, the bf16
// branch-1 avg and max): pool_avg writes avg1 and M in bf16 (M rounded
// after the max: the same value as the max of the rounded avg, rounding
// being monotone), and the wrapper hands the weights over tap-major in
// bf16 (exact for the bf16 weights the forward used). The outputs are the
// f32 planes and partials of the other paths, in 16-byte stores
// (store_row16). Both kernels run blocks of 8 warps (2 x 4, 64 x 32
// outputs a warp), two blocks an SM:
//   dW (5):  128 input channels (M) by 128 output channels (N), K = the
//            slab's output pixels; A is avg1 at the tap's pixels (M for q
//            = 9) and B the g rows, both [pixel][channel] in shared
//            memory, so both fragments come from ldmatrix.trans;
//   dA1 (3), dM (2): 128 pixels (M) by 128 input channels (N); A the g
//            rows ([pixel][co], ldmatrix), B wt[tap] ([co][ci],
//            ldmatrix.trans); the blocks of a pixel tile's classes and
//            channel tiles are grid neighbours, so they read its g rows
//            together through L2.
// Unlike the f32 kernels, the tensor cores keep the whole sum (a slab's
// pixels for dW, Co x taps for dA1): bf16 operands carry 2^-9 of relative
// error each, far above what f32 accumulation over a slab adds
// (tests/test_torch_bf16_bwd.py), and summing each chunk apart would
// double the accumulators' registers and leave room for one block an SM.
// What set the design, from scratch builds timed at gelan-c's five sites
// on an H100 (none kept): the f32 kernels' shapes with chunk sums (dgrad
// 4 warps of 64 x 32, dW 16 warps of 32 x 32 at one block an SM) ran
// clearly slower than these 8-warp blocks without them at two blocks an
// SM; 32-deep chunks, 128-deep dW chunks, a 4-deep ring, dgrad blocks of
// 64 pixels at four an SM, and a persistent dgrad grid streaming its
// tiles' chunks through one ring (dA1's tiles are 2-8 chunks long) did
// not help. dW's slab count fills the rounds of resident blocks
// (ops/kernels/adown.py: _bwd_slabs).
namespace bf16 {

using namespace sm90;
using bf = __nv_bfloat16;

constexpr int kV = 8;             // channels a 16-byte copy
constexpr int kMT = 4;            // m16 tiles a warp: 64 x 32 outputs
// dW: 128 input channels (M) by 128 output channels (N), K chunks of
// kWKc pixels; rows of 136 elements (272 bytes: 8 consecutive rows start
// 4 banks apart)
constexpr int kWM = 128, kWN = 128, kWKc = 64;
constexpr int kWStages = 3, kWBlocks = 2;   // ring depth, blocks an SM
constexpr int kWThreads = 32 * (kWM / (16 * kMT)) * (kWN / 32);
constexpr int kWALd = kWM + 8, kWBLd = kWN + 8;
constexpr int kWStage = kWKc * (kWALd + kWBLd);             // elements
// dA1, dM: 128 pixels (M) by 128 input channels (N), K chunks of kDKc
// channels; [pixel][co] rows of kDKc + 8 elements and [co][ci] rows of 136
constexpr int kDM = 128, kDN = 128, kDKc = 64;
constexpr int kDStages = 3, kDBlocks = 2;   // ring depth, blocks an SM
constexpr int kDThreads = 32 * (kDM / (16 * kMT)) * (kDN / 32);
constexpr int kDALd = kDKc + 8, kDBLd = kDN + 8;
constexpr int kDStage = kDM * kDALd + kDKc * kDBLd;         // elements
constexpr int kWSmem = kWStages * kWStage * 2;              // bytes
constexpr int kDSmem = kDStages * kDStage * 2;

// ldmatrix lane offsets (elements) in a stage, rows of ld elements: lane
// l gives the address of row l % 8 of matrix l / 8.
//  - k_major_a: A from [k][m] rows, transposed (dW): matrices (m 0-7, k
//    0-7), (m 8-15, k 0-7), (m 0-7, k 8-15), (m 8-15, k 8-15), the a0..a3
//    of an m16n8k16 A fragment;
//  - rows16: rows 0-15 at column 0, then at column 8. From [m][k] rows
//    (dgrad's A) the a0..a3 of an A fragment; from [k][n] rows, transposed
//    (every B), b0, b1 of n8 tile j, then of tile j + 1.
__device__ __forceinline__ int k_major_a(int lane, int ld) {
  return (8 * (lane / 16) + lane % 8) * ld + 8 * (lane / 8 % 2);
}
__device__ __forceinline__ int rows16(int lane, int ld) {
  return (lane % 16) * ld + 8 * (lane / 16);
}

// d[mt][j] += a x n8 tile j of b (b[j / 2] holds tiles 2 (j / 2), + 1)
__device__ __forceinline__ void mma_tiles(float (&d)[kMT][4][4],
                                          const uint32_t (&a)[4], int mt,
                                          const uint32_t (&b)[2][4]) {
#pragma unroll
  for (int jp = 0; jp < 2; ++jp) {
    mma_m16n8k16(d[mt][2 * jp], a, b[jp][0], b[jp][1]);
    mma_m16n8k16(d[mt][2 * jp + 1], a, b[jp][2], b[jp][3]);
  }
}

// Row r (0: g, 1: g + 8) of a lane's m16 tile mt holds columns 8 j + 2 t
// and + 1 (t = lane % 4) of the four n8 tiles j; it goes to `row` at
// columns c.. (C columns, a multiple of 8) as two 16-byte stores: lanes t
// and t ^ 1 trade a pair, so that an even lane stores columns 8 j + 2 t to
// + 3 of tiles 0 and 2, an odd one 8 j + 2 t - 2 to + 1 of tiles 1 and 3.
// Every lane takes part in the trade; only those with `ok` store.
__device__ __forceinline__ void store_row16(float* row, int c, int C,
                                            const float (&acc)[kMT][4][4],
                                            int mt, int r, bool ok) {
  const int t = threadIdx.x % 4;
  const bool odd = t & 1;
#pragma unroll
  for (int j = 0; j < 4; j += 2) {
    const float a0 = acc[mt][j][2 * r], a1 = acc[mt][j][2 * r + 1];
    const float b0 = acc[mt][j + 1][2 * r], b1 = acc[mt][j + 1][2 * r + 1];
    const float s0 = __shfl_xor_sync(0xffffffffu, odd ? a0 : b0, 1);
    const float s1 = __shfl_xor_sync(0xffffffffu, odd ? a1 : b1, 1);
    const int col = c + 8 * (j + odd) + 2 * (t & 2);
    if (ok && col < C)
      *reinterpret_cast<float4*>(row + col) =
          odd ? make_float4(s0, s1, b0, b1) : make_float4(a0, a1, s0, s1);
  }
}

// 5. part[s, q, ci, co] as gemm_dw: a block per (slab, tap, channel
//    tiles), the 10 taps of a slab neighbours in the grid (they read the
//    slab's g together through L2). A thread copies the same pixel rows of
//    every chunk, whose output pixel it steps by kWKc a chunk (no
//    division).
__global__ void __launch_bounds__(kWThreads, kWBlocks)
dw_bf16(const bf* __restrict__ avg1, const bf* __restrict__ g,
        const bf* __restrict__ M, float* __restrict__ part, int H, int W,
        int Ho, int Wo, int Ch, int Co, int N, int slab, int co_tiles) {
  extern __shared__ __align__(16) unsigned char wsmem[];
  const int q = blockIdx.x % 10, tile = blockIdx.x / 10, s = blockIdx.y;
  const int ci0 = tile / co_tiles * kWM, co0 = tile % co_tiles * kWN;
  const int HA = H - 1, WA = W - 1, Cout = 2 * Co;
  const int ky = q / 3, kx = q % 3, goff = q == 9 ? Co : 0;
  const int p_begin = s * slab, p_end = min(p_begin + slab, N);
  const int chunks = p_end > p_begin ? ceil_div(p_end - p_begin, kWKc) : 0;
  const uint32_t base = smem_u32(wsmem);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int gq = lane / 4;
  const int wm = 16 * kMT * (warp / (kWN / 32));
  const int wn = 32 * (warp % (kWN / 32));

  // A copies: rows ka + i kAStep of a chunk, channels cia..cia + 7; (b,
  // oy, ox) of row i's pixel in the next chunk to load
  constexpr int av = kWM / kV, bv = kWN / kV;    // copies a pixel row
  constexpr int kAN = kWKc * av / kWThreads, kAStep = kWThreads / av;
  constexpr int kBN = kWKc * bv / kWThreads;      // B copies a thread
  static_assert(kWKc * av % kWThreads == 0 && kWKc * bv % kWThreads == 0);
  const int ka = tid / av, cia = ci0 + kV * (tid % av);
  int pb[kAN], poy[kAN], pox[kAN];
#pragma unroll
  for (int i = 0; i < kAN; ++i) {
    const int p = p_begin + ka + i * kAStep, t = p / Wo;
    pox[i] = p - t * Wo;
    pb[i] = t / Ho;
    poy[i] = t - pb[i] * Ho;
  }

  auto load = [&](int c) {   // called for c = 0, 1, 2, ... in turn
    const uint32_t a_s = base + (c % kWStages) * kWStage * 2;
    const uint32_t b_s = a_s + kWKc * kWALd * 2;
    const int pk = p_begin + c * kWKc;
#pragma unroll
    for (int i = 0; i < kAN; ++i) {
      const int k = ka + i * kAStep, p = pk + k;
      bool ok = p < p_end && cia < Ch;
      const bf* src = M;
      if (q == 9) {
        if (ok) src = M + (size_t)p * Ch + cia;
      } else {
        const int ay = 2 * poy[i] - 1 + ky, ax = 2 * pox[i] - 1 + kx;
        ok = ok && in_avg(ay, ax, H, W);
        if (ok)
          src = avg1 + (((size_t)pb[i] * HA + ay) * WA + ax) * Ch + cia;
      }
      cp_async16(a_s + 2 * (k * kWALd + cia - ci0), src, ok);
      for (pox[i] += kWKc; pox[i] >= Wo;) {
        pox[i] -= Wo;
        if (++poy[i] == Ho) {
          poy[i] = 0;
          ++pb[i];
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kBN; ++i) {
      const int e = tid + i * kWThreads;
      const int k = e / bv, co = co0 + kV * (e % bv), p = pk + k;
      const bool ok = p < p_end && co < Co;
      cp_async16(b_s + 2 * (k * kWBLd + co - co0),
                 ok ? g + (size_t)p * Cout + goff + co : g, ok);
    }
  };

  const uint32_t a_lane = 2 * (k_major_a(lane, kWALd) + wm);
  const uint32_t b_lane = 2 * (rows16(lane, kWBLd) + wn);
  float acc[kMT][4][4] = {};
  for (int c = 0; c < kWStages - 1; ++c) {
    if (c < chunks) load(c);
    cp_async_commit();
  }
  for (int c = 0; c < chunks; ++c) {
    cp_async_wait<kWStages - 2>();
    __syncthreads();   // chunk c is in; every warp is done with c - 1
    if (c + kWStages - 1 < chunks) load(c + kWStages - 1);
    cp_async_commit();
    const uint32_t a_s = base + (c % kWStages) * kWStage * 2 + a_lane;
    const uint32_t b_s = base + (c % kWStages) * kWStage * 2 +
                         kWKc * kWALd * 2 + b_lane;
#pragma unroll
    for (int ks = 0; ks < kWKc; ks += 16) {
      uint32_t a[kMT][4], b[2][4];
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
        ldmatrix_x4_trans(a_s + 2 * (ks * kWALd + 16 * mt), a[mt]);
#pragma unroll
      for (int jp = 0; jp < 2; ++jp)
        ldmatrix_x4_trans(b_s + 2 * (ks * kWBLd + 16 * jp), b[jp]);
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) mma_tiles(acc, a[mt], mt, b);
    }
  }
  cp_async_wait_all();

  // d[mt][j]: channels ci0 + wm + 16 mt + g (k 0, 1) and + 8 (k 2, 3),
  // output channels co0 + wn + 8 j + 2 t (k even) and + 1 (k odd)
  float* out = part + ((size_t)s * 10 + q) * Ch * Co;
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int ci = ci0 + wm + 16 * mt + gq + 8 * r;
      store_row16(out + (size_t)(ci < Ch ? ci : 0) * Co, co0 + wn, Co, acc,
                  mt, r, ci < Ch);
    }
}

// 2. and 3. dM (kDa1 false) as gemm_dm, dA1 (kDa1 true) as gemm_da1, on
//    f32::dgrad_tf32's walk: K runs over the taps (dA1) and kDKc-channel
//    chunks of Co; dM's rows are the output pixels in order, dA1's the
//    avg pixels of one parity class (py, px) of every image in order, so
//    every row of a block has the same 1, 2 or 4 taps.
template <bool kDa1>
__global__ void __launch_bounds__(kDThreads, kDBlocks)
dgrad_bf16(const bf* __restrict__ g, const bf* __restrict__ wt,
           float* __restrict__ out, int B, int Ho, int Wo, int HA, int WA,
           int Co, int Ch, int N, int ci_tiles) {
  extern __shared__ __align__(16) unsigned char dsmem[];
  // blocks (pixel tile, class, channel tile), the last fastest: the
  // classes' and channel tiles' blocks of a pixel tile read the same g
  // rows together (through L2)
  const int classes = kDa1 ? 4 : 1;
  const int ci0 = (int)(blockIdx.x % ci_tiles) * kDN;
  const int cls = (int)(blockIdx.x / ci_tiles) % classes;
  const int m0 = (int)(blockIdx.x / (ci_tiles * classes)) * kDM;
  const int py = cls >> 1, px = cls & 1;
  // the class's rows and columns of avg pixels
  const int cr = (HA - py + 1) / 2, cc = (WA - px + 1) / 2;
  const int rows = kDa1 ? B * cr * cc : N;
  if (m0 >= rows) return;   // the classes with fewer pixels
  const int Cout = 2 * Co, cchunks = ceil_div(Co, kDKc);
  const int ntx = px ? 2 : 1;
  const int chunks = (kDa1 ? (py ? 2 : 1) * ntx : 1) * cchunks;
  const uint32_t base = smem_u32(dsmem);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int gq = lane / 4;
  const int wm = 16 * kMT * (warp / (kDN / 32));
  const int wn = 32 * (warp % (kDN / 32));

  // block row m: dA1 the avg pixel (b, ay, ax), dM the output pixel p (in
  // b)
  auto pixel = [&](int m, int& b, int& ay, int& ax) {
    const int n = m0 + m;
    if constexpr (kDa1) {
      const int t = n / cc;
      ax = 2 * (n - t * cc) + px;
      b = t / cr;
      ay = 2 * (t - b * cr) + py;
    } else {
      b = n;
      ay = ax = 0;
    }
  };

  // A copies: rows ma + i kAStep, channels va..va + 7 of each chunk
  constexpr int av = kDKc / kV, bv = kDN / kV;    // copies a row
  constexpr int kAN = kDM * av / kDThreads, kAStep = kDThreads / av;
  constexpr int kBN = kDKc * bv / kDThreads;      // B copies a thread
  static_assert(kDM * av % kDThreads == 0 && kDKc * bv % kDThreads == 0);
  const int ma = tid / av, va = kV * (tid % av);
  int rb[kAN], ray[kAN], rax[kAN];
#pragma unroll
  for (int i = 0; i < kAN; ++i) {
    pixel(ma + i * kAStep, rb[i], ray[i], rax[i]);
    if (m0 + ma + i * kAStep >= rows) rb[i] = -1;
  }

  auto load = [&](int c) {
    const uint32_t a_s = base + (c % kDStages) * kDStage * 2;
    const uint32_t b_s = a_s + kDM * kDALd * 2;
    const int t = c / cchunks, co0 = (c % cchunks) * kDKc;
    // an even avg row is reached by ky = 1 only, an odd one by ky = 0 and
    // 2 (gemm_da1's tap order)
    const int ky = py ? 2 * (t / ntx) : 1, kx = px ? 2 * (t % ntx) : 1;
    const int tap = kDa1 ? 3 * ky + kx : 0;
    const int co = co0 + va;
#pragma unroll
    for (int i = 0; i < kAN; ++i) {
      bool ok = rb[i] >= 0 && co < Co;
      size_t off;
      if constexpr (kDa1) {
        const int oy = (ray[i] + 1 - ky) / 2, ox = (rax[i] + 1 - kx) / 2;
        ok = ok && oy < Ho && ox < Wo;
        off = (((size_t)rb[i] * Ho + oy) * Wo + ox) * Cout + co;
      } else {
        off = (size_t)rb[i] * Cout + Co + co;
      }
      cp_async16(a_s + 2 * ((ma + i * kAStep) * kDALd + va),
                 ok ? g + off : g, ok);
    }
#pragma unroll
    for (int j = 0; j < kBN; ++j) {
      const int e = tid + j * kDThreads;
      const int k = e / bv, ci = ci0 + kV * (e % bv);
      const bool ok = co0 + k < Co && ci < Ch;
      cp_async16(b_s + 2 * (k * kDBLd + ci - ci0),
                 ok ? wt + ((size_t)tap * Co + co0 + k) * Ch + ci : wt, ok);
    }
  };

  const uint32_t a_lane = 2 * (rows16(lane, kDALd) + wm * kDALd);
  const uint32_t b_lane = 2 * (rows16(lane, kDBLd) + wn);
  float acc[kMT][4][4] = {};
  for (int c = 0; c < kDStages - 1; ++c) {
    if (c < chunks) load(c);
    cp_async_commit();
  }
  for (int c = 0; c < chunks; ++c) {
    cp_async_wait<kDStages - 2>();
    __syncthreads();
    if (c + kDStages - 1 < chunks) load(c + kDStages - 1);
    cp_async_commit();
    const uint32_t a_s = base + (c % kDStages) * kDStage * 2 + a_lane;
    const uint32_t b_s = base + (c % kDStages) * kDStage * 2 +
                         kDM * kDALd * 2 + b_lane;
#pragma unroll
    for (int ks = 0; ks < kDKc; ks += 16) {
      uint32_t b[2][4];
#pragma unroll
      for (int jp = 0; jp < 2; ++jp)
        ldmatrix_x4_trans(b_s + 2 * (ks * kDBLd + 16 * jp), b[jp]);
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        uint32_t a[4];
        ldmatrix_x4(a_s + 2 * (16 * mt * kDALd + ks), a);
        mma_tiles(acc, a, mt, b);
      }
    }
  }
  cp_async_wait_all();

  // d[mt][j]: rows wm + 16 mt + g (k 0, 1) and + 8 (k 2, 3), channels
  // ci0 + wn + 8 j + 2 t (k even) and + 1 (k odd)
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int m = wm + 16 * mt + gq + 8 * r;
      const bool ok = m0 + m < rows;
      int b = 0, ay = 0, ax = 0;
      if (ok) pixel(m, b, ay, ax);
      const size_t row =
          (kDa1 ? ((size_t)b * HA + ay) * WA + ax : (size_t)b) * Ch;
      store_row16(out + row, ci0 + wn, Ch, acc, mt, r, ok);
    }
}

}  // namespace bf16

int grid_for(size_t total) {
  const size_t blocks = (total + kThreads - 1) / kThreads;
  return (int)(blocks < 132 * 64 ? (blocks ? blocks : 1) : 132 * 64);
}

// rows per strip of a pass: the longest of 32, 16, ... (not below lo)
// that still gives each CTA of the persistent grid eight tasks
int strip_rows(int rows, int tasks_per_strip, int ctas, int lo) {
  int R = 32;
  while (R > lo && tasks_per_strip * ceil_div(rows, R) < 8 * ctas) R /= 2;
  return R;
}

// a persistent pass: as many CTAs of `kernel` as fit on the device at once
template <typename K>
cudaError_t resident_ctas(K kernel, int* ctas) {
  int per_sm = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, kernel, kThreads, 0);
  *ctas = sm_count() * per_sm;   // 0, a refused launch, if unknown
  return err;
}

// pass 1 with V-channel lanes; avg1 null: M and idx only
template <typename T, int V>
cudaError_t launch_pool(const T* x, T* M, unsigned char* idx, T* avg1,
                        int B, int H, int W, int Cin, cudaStream_t stream) {
  const int Ho = H / 2, Wo = W / 2, branches = avg1 ? 2 : 1;
  const int runs = ceil_div(Wo * (Cin / 2 / V), kThreads);
  int ctas = 0;
  cudaError_t err = resident_ctas(pool_avg<T, V>, &ctas);
  if (err != cudaSuccess) return err;
  const int R = strip_rows(Ho, B * branches * runs, ctas, 2);
  const int strips = ceil_div(Ho, R);
  const int tasks = B * branches * strips * runs;
  pool_avg<T, V><<<tasks < ctas ? tasks : ctas, kThreads, 0, stream>>>(
      x, M, idx, avg1, B, H, W, Cin, Ho, Wo, R, strips, runs);
  return cudaGetLastError();
}

// pass 4 with V-channel lanes
template <typename T, int V>
cudaError_t launch_dx(const float* dA1, const float* dM,
                      const unsigned char* idx, T* dx, int B, int H, int W,
                      int Cin, cudaStream_t stream) {
  const int runs = ceil_div(W * (Cin / 2 / V), kThreads);
  int ctas = 0;
  cudaError_t err = resident_ctas(dx_strips<T, V>, &ctas);
  if (err != cudaSuccess) return err;
  const int R = strip_rows(H, B * 2 * runs, ctas, 4);
  const int strips = ceil_div(H, R);
  const int tasks = B * 2 * strips * runs;
  dx_strips<T, V><<<tasks < ctas ? tasks : ctas, kThreads, 0, stream>>>(
      dA1, dM, idx, dx, B, H, W, Cin, H / 2, W / 2, R, strips, runs);
  return cudaGetLastError();
}

// 8-channel lanes where the branch width Ch allows them (every gelan-c
// and TINY_YAML site), else lanes of one channel
template <typename T>
cudaError_t launch_pool(const T* x, T* M, unsigned char* idx, T* avg1,
                        int B, int H, int W, int Cin, cudaStream_t stream) {
  if (Cin / 2 % 8 == 0)
    return launch_pool<T, 8>(x, M, idx, avg1, B, H, W, Cin, stream);
  return launch_pool<T, 1>(x, M, idx, avg1, B, H, W, Cin, stream);
}

template <typename T>
cudaError_t launch_dx(const float* dA1, const float* dM,
                      const unsigned char* idx, T* dx, int B, int H, int W,
                      int Cin, cudaStream_t stream) {
  if (Cin / 2 % 8 == 0)
    return launch_dx<T, 8>(dA1, dM, idx, dx, B, H, W, Cin, stream);
  return launch_dx<T, 1>(dA1, dM, idx, dx, B, H, W, Cin, stream);
}

// The bf16 backward with Ch or Co not a multiple of 8: the products on the
// CUDA cores (gemm_dm, gemm_da1, gemm_dw), f32 weights
cudaError_t launch_cuda_cores(const bf16::bf* x, const bf16::bf* g,
                              const float* w1t, const float* w2t,
                              bf16::bf* dx, float* dw1, float* dw2,
                              bf16::bf* M, unsigned char* idx, float* dM,
                              float* dA1, float* part, int B, int H, int W,
                              int Cin, int Cout, int S, cudaStream_t stream) {
  using T = bf16::bf;
  const int Ch = Cin / 2, Co = Cout / 2;
  const int Ho = H / 2, Wo = W / 2, HA = H - 1, WA = W - 1;
  const long long N = (long long)B * Ho * Wo;
  cudaError_t err;

  err = launch_pool<T>(x, M, idx, nullptr, B, H, W, Cin, stream);
  if (err != cudaSuccess) return err;

  const int ci_tiles = ceil_div(Ch, kT), co_tiles = ceil_div(Co, kT);
  dim3 g_dm((unsigned)((N + kT - 1) / kT), ci_tiles);
  gemm_dm<T><<<g_dm, kThreads, 0, stream>>>(g, w2t, dM, N, Co, Ch);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const int tiles_i = ceil_div(ceil_div(HA, 2), 8);
  const int tiles_j = ceil_div(ceil_div(WA, 2), 8);
  dim3 g_da(tiles_i * tiles_j, 4 * ci_tiles, B);
  gemm_da1<T><<<g_da, kThreads, 0, stream>>>(g, w1t, dA1, Ho, Wo, HA, WA,
                                             Co, Ch, tiles_j, ci_tiles);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  if ((err = launch_dx<T>(dA1, dM, idx, dx, B, H, W, Cin, stream)) !=
      cudaSuccess)
    return err;

  const long long slab = (N + S - 1) / S;
  dim3 g_dw(S, 10, ci_tiles * co_tiles);
  gemm_dw<T><<<g_dw, kThreads, 0, stream>>>(x, g, M, part, H, W, Cin, Ho,
                                            Wo, Co, N, slab, co_tiles);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  dw_reduce<<<grid_for((size_t)10 * Ch * Co), kThreads, 0, stream>>>(
      part, dw1, dw2, S, Ch, Co);
  return cudaGetLastError();
}

// The bf16 backward with Ch and Co multiples of 8: the passes and
// dw_reduce as above, the products on bf16 mma.sync (namespace bf16) with
// bf16 tap-major weights
cudaError_t launch_bf16(const bf16::bf* x, const bf16::bf* g,
                        const bf16::bf* w1t, const bf16::bf* w2t,
                        bf16::bf* dx, float* dw1, float* dw2, bf16::bf* M,
                        unsigned char* idx, float* dM, float* dA1,
                        bf16::bf* avg1, float* part, int B, int H, int W,
                        int Cin, int Cout, int S, cudaStream_t stream) {
  using namespace bf16;
  static PerDeviceSmem smem_dm, smem_da1, smem_dw;
  cudaError_t err;
  if ((err = smem_dm.opt_in((const void*)dgrad_bf16<false>, kDSmem)) !=
          cudaSuccess ||
      (err = smem_da1.opt_in((const void*)dgrad_bf16<true>, kDSmem)) !=
          cudaSuccess ||
      (err = smem_dw.opt_in((const void*)dw_bf16, kWSmem)) != cudaSuccess)
    return err;
  const int Ch = Cin / 2, Co = Cout / 2;
  const int Ho = H / 2, Wo = W / 2, HA = H - 1, WA = W - 1;
  const int N = B * Ho * Wo;

  if ((err = launch_pool<bf>(x, M, idx, avg1, B, H, W, Cin, stream)) !=
      cudaSuccess)
    return err;

  const int ci_tiles = ceil_div(Ch, kDN);
  dgrad_bf16<false><<<ceil_div(N, kDM) * ci_tiles, kDThreads, kDSmem,
                      stream>>>(g, w2t, dM, B, Ho, Wo, HA, WA, Co, Ch, N,
                                ci_tiles);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  // pixel tiles for the largest class, (0, 0); the others' last ones return
  const int class_px = B * ceil_div(HA, 2) * ceil_div(WA, 2);
  dgrad_bf16<true><<<ceil_div(class_px, kDM) * 4 * ci_tiles, kDThreads,
                     kDSmem, stream>>>(g, w1t, dA1, B, Ho, Wo, HA, WA, Co,
                                       Ch, N, ci_tiles);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  if ((err = launch_dx<bf>(dA1, dM, idx, dx, B, H, W, Cin, stream)) !=
      cudaSuccess)
    return err;

  const int co_tiles = ceil_div(Co, kWN);
  dw_bf16<<<dim3(10 * ceil_div(Ch, kWM) * co_tiles, S), kWThreads, kWSmem,
            stream>>>(avg1, g, M, part, H, W, Ho, Wo, Ch, Co, N,
                      ceil_div(N, S), co_tiles);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  dw_reduce<<<grid_for((size_t)10 * Ch * Co), kThreads, 0, stream>>>(
      part, dw1, dw2, S, Ch, Co);
  return cudaGetLastError();
}

// The f32 backward: the passes and dw_reduce as above, the products on
// the tensor cores (namespace f32) with E-float copies
template <int E>
cudaError_t launch_f32(const float* x, const float* g, const float* w1t,
                       const float* w2t, float* dx, float* dw1, float* dw2,
                       float* M, unsigned char* idx, float* dM, float* dA1,
                       float* avg1, float* part, int B, int H, int W, int Cin,
                       int Cout, int S, cudaStream_t stream) {
  using namespace f32;
  static PerDeviceSmem smem_dm, smem_da1, smem_dw;
  cudaError_t err;
  if ((err = smem_dm.opt_in((const void*)dgrad_tf32<E, false>, kDSmem)) !=
          cudaSuccess ||
      (err = smem_da1.opt_in((const void*)dgrad_tf32<E, true>, kDSmem)) !=
          cudaSuccess ||
      (err = smem_dw.opt_in((const void*)dw_tf32<E>, kWSmem)) != cudaSuccess)
    return err;
  const int Ch = Cin / 2, Co = Cout / 2;
  const int Ho = H / 2, Wo = W / 2, HA = H - 1, WA = W - 1;
  const int N = B * Ho * Wo;

  if ((err = launch_pool<float>(x, M, idx, avg1, B, H, W, Cin, stream)) !=
      cudaSuccess)
    return err;

  const int ci_tiles = ceil_div(Ch, kDN);
  dgrad_tf32<E, false><<<dim3(ceil_div(N, kDM), ci_tiles), kDThreads,
                         kDSmem, stream>>>(g, w2t, dM, B, Ho, Wo, HA, WA, Co,
                                           Ch, N, ci_tiles);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  // blocks for the largest class, (0, 0); the others' last ones return
  const int class_px = B * ceil_div(HA, 2) * ceil_div(WA, 2);
  dgrad_tf32<E, true><<<dim3(ceil_div(class_px, kDM), 4 * ci_tiles),
                        kDThreads, kDSmem, stream>>>(
      g, w1t, dA1, B, Ho, Wo, HA, WA, Co, Ch, N, ci_tiles);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  if ((err = launch_dx<float>(dA1, dM, idx, dx, B, H, W, Cin, stream)) !=
      cudaSuccess)
    return err;

  const int co_tiles = ceil_div(Co, kWN);
  dw_tf32<E><<<dim3(10 * ceil_div(Ch, kWM) * co_tiles, S), kWThreads,
               kWSmem, stream>>>(avg1, g, M, part, H, W, Ho, Wo, Ch, Co, N,
                         ceil_div(N, S), co_tiles);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  dw_reduce<<<grid_for((size_t)10 * Ch * Co), kThreads, 0, stream>>>(
      part, dw1, dw2, S, Ch, Co);
  return cudaGetLastError();
}

}  // namespace
}  // namespace yolo

// x (B, H, W, Cin) and g (B, H/2, W/2, Cout) NHWC in one dtype; w1t
// (9, Cout/2, Cin/2) and w2t (Cout/2, Cin/2) tap-major, as the wrapper
// permutes them: bf16 for a bf16 call with Cin/2 and Cout/2 multiples of 8
// (the bf16 products), else f32; dx like x; dw1 (Cout/2, Cin/2, 3, 3), dw2
// (Cout/2, Cin/2) f32. Scratch, all allocated by the wrapper: M (B, H/2,
// W/2, Cin/2) in x's dtype, idx the same in uint8, dM the same in f32, dA1
// (B, H-1, W-1, Cin/2) f32, avg1 the same in x's dtype, part (S, 10,
// Cin/2, Cout/2) f32. Cin and Cout even, H and W >= 2,
// 1 <= S <= B*(H/2)*(W/2) < 2^31, 16-byte aligned tensors (checked by the
// Python wrapper).
extern "C" int yolo_adown_bwd(const void* x, const void* g, const void* w1t,
                              const void* w2t, void* dx, void* dw1, void* dw2,
                              void* M, void* idx, void* dM, void* dA1,
                              void* avg1, void* part, int B, int H, int W,
                              int Cin, int Cout, int S, int dtype,
                              void* stream) {
  using yolo::bf16::bf;
  auto s = static_cast<cudaStream_t>(stream);
  auto f = [](void* p) { return static_cast<float*>(p); };
  auto cf = [](const void* p) { return static_cast<const float*>(p); };
  auto b = [](void* p) { return static_cast<bf*>(p); };
  auto cb = [](const void* p) { return static_cast<const bf*>(p); };
  auto* i8 = static_cast<unsigned char*>(idx);
  if (dtype == yolo::kBFloat16) {
    if (Cin / 2 % 8 == 0 && Cout / 2 % 8 == 0)
      return yolo::launch_bf16(cb(x), cb(g), cb(w1t), cb(w2t), b(dx), f(dw1),
                               f(dw2), b(M), i8, f(dM), f(dA1), b(avg1),
                               f(part), B, H, W, Cin, Cout, S, s);
    return yolo::launch_cuda_cores(cb(x), cb(g), cf(w1t), cf(w2t), b(dx),
                                   f(dw1), f(dw2), b(M), i8, f(dM), f(dA1),
                                   f(part), B, H, W, Cin, Cout, S, s);
  }
  // 16-byte copies where every row of the f32 products' operands starts
  // 16-byte aligned
  const bool vec = Cin / 2 % 4 == 0 && Cout / 2 % 4 == 0;
  return (vec ? yolo::launch_f32<4> : yolo::launch_f32<1>)(
      cf(x), cf(g), cf(w1t), cf(w2t), f(dx), f(dw1), f(dw2), f(M), i8, f(dM),
      f(dA1), f(avg1), f(part), B, H, W, Cin, Cout, S, s);
}
