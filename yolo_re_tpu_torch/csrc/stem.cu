// Stem convolution: y = SiLU(conv3x3_s2_p1(x) + b), Cin = 3 -> C; raw
// mode y = conv3x3_s2_p1(x), the pre-BN train forward. NHWC in and out,
// sums in f32, rounded once to x's dtype.
//
// Replaces the TPU kernel yolo_re_tpu/ops/pallas/stem_kernel.py
// (_stem_pallas, reached through stem_conv_packed and
// stem_conv_packed_raw). That kernel's phase planes and row-paired output
// exist to dodge the TPU's 128-lane padding; here input and output are
// plain NHWC (channels_last) and the next layer is an ordinary conv.
//
// What bounds it on an H100: memory. At (32, 640, 640, 3) -> C = 64 it
// reads 78.6 MB of x and writes 419.4 MB of y in bf16 (0.1487 ms at
// 3.35 TB/s), twice that in f32 (0.2974 ms), for 11.3 GFLOP. The other
// units sit under that bound but not far: the products take 0.169 ms on
// the CUDA cores (67 TFLOP/s), and the folded SiLU's two MUFU operations
// an output (exp, reciprocal: 419 M at 16 a clock per SM) ~0.1 ms. So the
// design keeps every unit but the memory out of the way:
//
// - a persistent grid (resident CTAs per SM by the occupancy API, times
//   the SM count) of 4-warp CTAs. A tile is up to kSp consecutive output
//   pixels of one output row; CTA i walks tiles i, i + grid, ..., stepping
//   its (image, row, segment) by additions, not divisions;
// - the tile's input window (three input rows, 2 kSp + 1 columns) comes
//   in as whole 16-byte cp.async chunks of x, aligned to x's base whatever
//   a row's alignment, through a 3-slot ring: tile i + 2's copies fly
//   while tile i computes. Rows outside the image are zero-filled; the
//   conv's zero columns (ix = -1, and ix = W for odd W) are masked where
//   the operands are gathered;
// - bf16: the products on the tensor cores, mma.sync m16n8k16 (M = 16
//   pixels, N = 8 channels, K = the 27 taps, k = 9 ky + 3 kx + ci, padded
//   to 32: two k-steps). A lane's A fragment is gathered straight from the
//   window with 16-bit loads (a pair k, k + 1 can straddle two input
//   pixels), k >= 27 and the padding masked in registers. A warp owns a
//   range of at most 64 channels for the whole walk: its B fragments (32
//   registers) and its bias (the product's C operand) are loaded once.
//   bf16 x bf16 products are exact in f32, so only the sum order differs
//   from the plain version;
// - f32: FFMA. 3xTF32 on mma.sync runs no faster per useful operation
//   than the CUDA cores on this card (measured on conv3's f32 kernel), and
//   would pad K to 32 and split every operand; FFMA is exact f32 and its
//   floor is under the f32 bytes bound. A lane takes 2 pixels x 16
//   channels, the pixels' 27 inputs in registers and the weights
//   ([tap][C], f32, staged once a CTA) by broadcast LDS.128: 8 FMAs a
//   load (the old kernel: 4);
// - the epilogue adds the bias (already in the sum) and applies silu_mufu
//   (hopper.cuh: fast exp and division; common.cuh's silu divides in
//   IEEE) unless raw, rounds once to T and writes a staging tile
//   [pixel][C] in shared memory (rows padded by 16 bytes, so the fragment
//   stores hit 32 banks). After a barrier the CTA writes the tile's span,
//   npix * C contiguous elements of NHWC y, in 16-byte stores by
//   consecutive threads: full lines, where the old one-thread-per-pixel
//   kernel's warp store touched 32 lines. A ragged tile writes a shorter
//   span.
#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"

namespace yolo {
namespace {

using bf16 = __nv_bfloat16;
using namespace sm90;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kSp = 64;              // output pixels of a tile, at most
constexpr int kStages = 3;           // input windows in the cp.async ring
constexpr int kMaxC = 256;
constexpr int kCols = 2 * kSp + 1;   // input columns of a window

// A window row in shared memory: 16 bytes of slack (column ix = -1 of the
// first tile of a row lands there), then the 16-byte chunks that hold the
// row's columns, the first chunk aligned to x's base.
template <typename T>
constexpr int kRowChunks = (15 + kCols * 3 * (int)sizeof(T) + 15) / 16;
template <typename T>
constexpr int kRowBytes = 16 + 16 * kRowChunks<T>;
template <typename T>
constexpr int kSlotBytes = 3 * kRowBytes<T>;
// window chunks a thread copies, at most
template <typename T>
constexpr int kChunksPerThread = (3 * kRowChunks<T> + kThreads - 1) /
                                 kThreads;

// dynamic shared memory: the window ring, the staging tile, and for f32
// the weights [tap][C] and the bias
template <typename T>
__host__ __device__ constexpr int stage_stride(int C) {
  return C * (int)sizeof(T) + 16;
}
template <typename T>
__host__ __device__ constexpr int smem_bytes(int C) {
  return kStages * kSlotBytes<T> + kSp * stage_stride<T>(C) +
         (std::is_same<T, float>::value ? 28 * C * 4 : 0);
}

struct Geo {
  int B, H, W, C, Ho, Wo, nseg, n_tiles;
};

// A CTA's walk over its tiles t = blockIdx.x + i * gridDim.x, decoded as
// (image b, output row oy, segment seg) and stepped by additions.
struct TileIter {
  int t, b, oy, seg;
  int dseg, doy, db;   // gridDim.x as (images, rows, segments)

  __device__ __forceinline__ void start(const Geo& g) {
    t = blockIdx.x;
    const int row = t / g.nseg;
    seg = t - row * g.nseg;
    b = row / g.Ho;
    oy = row - b * g.Ho;
    const int drow = gridDim.x / g.nseg;
    dseg = gridDim.x - drow * g.nseg;
    db = drow / g.Ho;
    doy = drow - db * g.Ho;
  }

  __device__ __forceinline__ void step(const Geo& g) {
    t += gridDim.x;
    seg += dseg;
    int carry = 0;
    if (seg >= g.nseg) {
      seg -= g.nseg;
      carry = 1;
    }
    oy += doy + carry;
    if (oy >= g.Ho) {
      oy -= g.Ho;
      ++b;
    }
    b += db;
  }

  __device__ __forceinline__ int ox0() const { return seg * kSp; }
  __device__ __forceinline__ int npix(const Geo& g) const {
    return min(kSp, g.Wo - seg * kSp);
  }
};

// byte of x (from its base) of the window's first column in the image,
// lo = max(0, 2 ox0 - 1), in input row 2 oy - 1 (ky = 0; may lie outside
// the image: only its low bits are used then)
template <typename T>
__device__ __forceinline__ long long row0_byte(const TileIter& it,
                                               const Geo& g) {
  const int lo = max(0, 2 * it.ox0() - 1);
  return (((long long)it.b * g.H + 2 * it.oy - 1) * g.W + lo) * 3 *
         (long long)sizeof(T);
}

// offset in the slot of the window's column 0 (input column ix =
// 2 ox0 - 1) in row ky: the first tile of a row starts one column before
// the image, inside the slack
template <typename T>
__device__ __forceinline__ int row_offset(long long b0, int ky, int ox0) {
  return ky * kRowBytes<T> + 16 + (int)(b0 & 15) -
         (ox0 == 0 ? 3 * (int)sizeof(T) : 0);
}

// A thread's share of a window's copies: chunks e = tid + i kThreads of
// the 3 x kRowChunks, as (ky, chunk in the row), fixed for the walk.
template <typename T>
struct WindowLoader {
  int ky[kChunksPerThread<T>], c[kChunksPerThread<T>];

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int i = 0; i < kChunksPerThread<T>; ++i) {
      const int e = threadIdx.x + i * kThreads;
      ky[i] = e < 3 * kRowChunks<T> ? e / kRowChunks<T> : -1;
      c[i] = e - ky[i] * kRowChunks<T>;
    }
  }

  // start the copies of the tile `it` into the slot at `slot`
  __device__ __forceinline__ void load(const TileIter& it, const Geo& g,
                                       const T* x, uint32_t slot,
                                       unsigned char* slot_p,
                                       long long x_bytes) const {
    constexpr int kE3 = 3 * sizeof(T);
    const int ox0 = it.ox0();
    const int lo = max(0, 2 * ox0 - 1);
    const int hi = min(g.W, 2 * (ox0 + it.npix(g)));   // last column + 1
    const long long b00 = row0_byte<T>(it, g);
    const long long row_bytes = (long long)g.W * kE3;
    const long long span = (long long)(hi - lo) * kE3;
#pragma unroll
    for (int i = 0; i < kChunksPerThread<T>; ++i) {
      if (ky[i] < 0) continue;
      const int iy = 2 * it.oy - 1 + ky[i];
      const int off = ky[i] * kRowBytes<T> + 16 + 16 * c[i];
      if (iy < 0 || iy >= g.H) {          // a zero row
        cp_async16(slot + off, x, false);
        continue;
      }
      const long long b0 = b00 + ky[i] * row_bytes;
      const long long byte = (b0 & ~15LL) + 16LL * c[i];
      if (byte >= b0 + span) continue;
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
};

// After the barrier that follows the products: the CTA writes the tile's
// span of y, npix * C contiguous elements, from the staging tile, cpp
// 16-byte chunks a pixel, by consecutive threads.
template <typename T>
__device__ __forceinline__ void store_span(const TileIter& it, const Geo& g,
                                           T* y, const unsigned char* stage,
                                           int S) {
  char* dst = reinterpret_cast<char*>(
      y + (((long long)it.b * g.Ho + it.oy) * g.Wo + it.ox0()) * g.C);
  const int cpp = g.C * (int)sizeof(T) / 16;
  const int nq = it.npix(g) * cpp;
  int p = threadIdx.x / cpp, r = threadIdx.x - p * cpp;
  const int dp = kThreads / cpp, dr = kThreads - dp * cpp;
  for (int q = threadIdx.x; q < nq; q += kThreads) {
    *reinterpret_cast<uint4*>(dst + 16LL * q) =
        *reinterpret_cast<const uint4*>(stage + p * S + 16 * r);
    p += dp;
    r += dr;
    if (r >= cpp) {
      r -= cpp;
      ++p;
    }
  }
}

// ---------------------------------------------------------------------------
// bf16: mma.sync m16n8k16
// ---------------------------------------------------------------------------

// d = a * b + c (16 x 8 f32): the first k-step starts from the bias
__device__ __forceinline__ void mma_bf16_c(float (&d)[4],
                                           const uint32_t (&a)[4],
                                           uint32_t b0, uint32_t b1,
                                           float c0, float c1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %11, %12, %13};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(c0), "f"(c1), "f"(c0), "f"(c1));
}

// The lane's 8 values of k (g = lane / 4, t = lane % 4): i = 0..7 is
// 2t + (i & 1) + 8 ((i >> 1) & 1) + 16 (i >> 2), the columns of its A
// fragments and the rows of its B fragments (pairs 0, 1: k-step 0's
// registers 0/1 and 2/3; pairs 2, 3: k-step 1's).
__device__ __forceinline__ int lane_k(int t, int i) {
  return 2 * t + (i & 1) + 8 * ((i >> 1) & 1) + 16 * (i >> 2);
}

// Per warp: a range of the output channels (n-tiles of 8) held in
// registers for the whole walk, and the share of each tile's 16-pixel
// m-tiles that it computes. ranges = ceil(C / 64) (<= 4 = kWarps), each of
// nt_max n-tiles but the last; warp w takes range w % ranges and m-tiles
// w / ranges, + step, ... (step = warps sharing its range).
struct WarpRange {
  int c0, nt, m0, step;
};

__device__ __forceinline__ WarpRange warp_range(int warp, int C) {
  const int c8 = C / 8;
  const int ranges = (c8 + 7) / 8;
  const int nt_max = (c8 + ranges - 1) / ranges;
  const int r = warp % ranges;
  WarpRange wr;
  wr.c0 = 8 * r * nt_max;
  wr.nt = min(nt_max, c8 - r * nt_max);
  wr.m0 = warp / ranges;
  wr.step = (kWarps - r + ranges - 1) / ranges;
  return wr;
}

template <bool Raw>
__device__ __forceinline__ void run_bf16(const bf16* x, const bf16* w,
                                         const bf16* bias, bf16* y,
                                         const Geo g, unsigned char* smem) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gl = lane >> 2, t = lane & 3;
  const WarpRange wr = warp_range(warp, g.C);

  // the lane's k values: where each lies in a window row (cofs), which
  // row (ky), and the masks of its four k pairs: k < 27, kx == 0, kx == 2
  int cofs[8], kyi[8];
  uint32_t vmask[4] = {0, 0, 0, 0}, kx0m[4] = {0, 0, 0, 0},
           kx2m[4] = {0, 0, 0, 0};
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int k = lane_k(t, i);
    const bool ok = k < 27;
    const int kk = ok ? k : 0;
    const int ky = kk / 9, kx = (kk % 9) / 3, ci = kk % 3;
    kyi[i] = ky;
    cofs[i] = kx * 6 + ci * 2;
    const uint32_t half = (i & 1) ? 0xffff0000u : 0x0000ffffu;
    if (ok) vmask[i >> 1] |= half;
    if (ok && kx == 0) kx0m[i >> 1] |= half;
    if (ok && kx == 2) kx2m[i >> 1] |= half;
  }

  // B fragments and the bias of the warp's channels, for the whole walk:
  // B[k][n] = w[n][ci][ky][kx] (OIHW), n = c0 + 8 j + gl
  uint32_t bw[8][2][2];
  float bc[8][2];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int n = wr.c0 + 8 * j + gl;
    const bool on = j < wr.nt;
#pragma unroll
    for (int s = 0; s < 2; ++s)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        uint32_t v = 0;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int k = lane_k(t, 4 * s + 2 * r + h);
          if (on && k < 27) {
            const int ky = k / 9, kx = (k % 9) / 3, ci = k % 3;
            const uint32_t u = __bfloat16_as_ushort(
                w[n * 27 + ci * 9 + ky * 3 + kx]);
            v |= u << (16 * h);
          }
        }
        bw[j][s][r] = v;
      }
    const int n2 = wr.c0 + 8 * j + 2 * t;
    bc[j][0] = (!Raw && on) ? __bfloat162float(bias[n2]) : 0.0f;
    bc[j][1] = (!Raw && on) ? __bfloat162float(bias[n2 + 1]) : 0.0f;
  }

  const uint32_t win0 = smem_u32(smem);
  unsigned char* stage = smem + kStages * kSlotBytes<bf16>;
  const int S = stage_stride<bf16>(g.C);
  const long long x_bytes = (long long)g.B * g.H * g.W * 3 * 2;
  const bool w_odd = g.W & 1;
  WindowLoader<bf16> wl;
  wl.init();

  TileIter cur, nxt;
  cur.start(g);
  nxt = cur;
  for (int s = 0; s < kStages - 1; ++s) {
    if (nxt.t < g.n_tiles)
      wl.load(nxt, g, x, win0 + s * kSlotBytes<bf16>,
              smem + s * kSlotBytes<bf16>, x_bytes);
    cp_async_commit();
    nxt.step(g);
  }

  for (int slot = 0; cur.t < g.n_tiles; cur.step(g)) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    {   // the copies of the tile kStages - 1 ahead, into the freed slot
      const int sn = slot == 0 ? kStages - 1 : slot - 1;
      if (nxt.t < g.n_tiles)
        wl.load(nxt, g, x, win0 + sn * kSlotBytes<bf16>,
                smem + sn * kSlotBytes<bf16>, x_bytes);
      cp_async_commit();
      nxt.step(g);
    }
    const int ox0 = cur.ox0(), npix = cur.npix(g);
    const unsigned char* win = smem + slot * kSlotBytes<bf16>;
    int base[8];
    {
      const long long b00 = row0_byte<bf16>(cur, g);
      const long long row_bytes = (long long)g.W * 6;
      const int ro0 = row_offset<bf16>(b00, 0, ox0);
      const int ro1 = row_offset<bf16>(b00 + row_bytes, 1, ox0);
      const int ro2 = row_offset<bf16>(b00 + 2 * row_bytes, 2, ox0);
#pragma unroll
      for (int i = 0; i < 8; ++i)
        base[i] = (kyi[i] == 0 ? ro0 : kyi[i] == 1 ? ro1 : ro2) + cofs[i];
    }
    const int nm = (npix + 15) >> 4;
    for (int m = wr.m0; m < nm; m += wr.step) {
      uint32_t a[2][4];   // [k-step][register]
#pragma unroll
      for (int h = 0; h < 2; ++h) {       // pixel rows gl, gl + 8
        const int p = 16 * m + gl + 8 * h;
        const int ox = ox0 + p;
        const bool left = ox == 0, right = w_odd && ox == g.Wo - 1;
        const unsigned char* src = win + 12 * p;
#pragma unroll
        for (int q = 0; q < 4; ++q) {     // k pairs
          const uint32_t lo =
              *reinterpret_cast<const unsigned short*>(src + base[2 * q]);
          const uint32_t hi = *reinterpret_cast<const unsigned short*>(
              src + base[2 * q + 1]);
          uint32_t mk = vmask[q];
          if (left) mk &= ~kx0m[q];
          if (right) mk &= ~kx2m[q];
          a[q >> 1][2 * (q & 1) + h] = (lo | (hi << 16)) & mk;
        }
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (j >= wr.nt) break;
        float d[4];
        mma_bf16_c(d, a[0], bw[j][0][0], bw[j][0][1], bc[j][0], bc[j][1]);
        mma_m16n8k16(d, a[1], bw[j][1][0], bw[j][1][1]);
        if (!Raw) {
#pragma unroll
          for (int e = 0; e < 4; ++e) d[e] = silu_mufu(d[e]);
        }
        const int col = 2 * (wr.c0 + 8 * j + 2 * t);   // byte in the row
        unsigned char* row = stage + (16 * m + gl) * S + col;
        *reinterpret_cast<uint32_t*>(row) = pack_bf16x2(d[0], d[1]);
        *reinterpret_cast<uint32_t*>(row + 8 * S) = pack_bf16x2(d[2], d[3]);
      }
    }
    __syncthreads();
    store_span<bf16>(cur, g, y, stage, S);
    slot = slot + 1 == kStages ? 0 : slot + 1;
  }
  cp_async_wait_all();
}

// ---------------------------------------------------------------------------
// f32: FFMA
// ---------------------------------------------------------------------------

// run_f32 repeats run_bf16's walk (prologue, barriers, window copies, span
// store): one walk taking the products as a lambda ran the bf16 kernel
// slower on an H100, so the two stay apart.

template <bool Raw>
__device__ __forceinline__ void run_f32(const float* x, const float* w,
                                        const float* bias, float* y,
                                        const Geo g, unsigned char* smem) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned char* stage = smem + kStages * kSlotBytes<float>;
  const int S = stage_stride<float>(g.C);
  float* w_s = reinterpret_cast<float*>(stage + kSp * S);   // [k][C]
  float* b_s = w_s + 27 * g.C;

  // weights OIHW (C, 3, 3, 3) -> [k = 9 ky + 3 kx + ci][c], once a CTA
  for (int e = threadIdx.x; e < 27 * g.C; e += kThreads) {
    const int c = e / 27, r = e - c * 27;     // r = 9 ci + 3 ky + kx
    const int ci = r / 9, ky = (r / 3) % 3, kx = r % 3;
    w_s[(9 * ky + 3 * kx + ci) * g.C + c] = w[e];
  }
  for (int c = threadIdx.x; c < g.C; c += kThreads)
    b_s[c] = Raw ? 0.0f : bias[c];

  const uint32_t win0 = smem_u32(smem);
  const long long x_bytes = (long long)g.B * g.H * g.W * 3 * 4;
  // tasks of a tile: (64-pixel block, group of 16 channels)
  const int groups = g.C / 16;
  const int tasks = (kSp / 64) * groups;
  const bool w_odd = g.W & 1;
  WindowLoader<float> wl;
  wl.init();

  TileIter cur, nxt;
  cur.start(g);
  nxt = cur;
  for (int s = 0; s < kStages - 1; ++s) {
    if (nxt.t < g.n_tiles)
      wl.load(nxt, g, x, win0 + s * kSlotBytes<float>,
              smem + s * kSlotBytes<float>, x_bytes);
    cp_async_commit();
    nxt.step(g);
  }

  for (int slot = 0; cur.t < g.n_tiles; cur.step(g)) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    {
      const int sn = slot == 0 ? kStages - 1 : slot - 1;
      if (nxt.t < g.n_tiles)
        wl.load(nxt, g, x, win0 + sn * kSlotBytes<float>,
                smem + sn * kSlotBytes<float>, x_bytes);
      cp_async_commit();
      nxt.step(g);
    }
    const int ox0 = cur.ox0();
    const unsigned char* win = smem + slot * kSlotBytes<float>;
    const float* rows[3];
    {
      const long long b00 = row0_byte<float>(cur, g);
      const long long row_bytes = (long long)g.W * 12;
#pragma unroll
      for (int ky = 0; ky < 3; ++ky)
        rows[ky] = reinterpret_cast<const float*>(
            win + row_offset<float>(b00 + ky * row_bytes, ky, ox0));
    }

    for (int task = warp; task < tasks; task += kWarps) {
      const int blk = task / groups, c0 = 16 * (task - blk * groups);
      // the lane's pixels 64 blk + lane and + 32; their 27 inputs each
      float in[2][27];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = 64 * blk + lane + 32 * h;
        const int ox = ox0 + p;
        const bool left = ox == 0, right = w_odd && ox == g.Wo - 1;
#pragma unroll
        for (int ky = 0; ky < 3; ++ky)
#pragma unroll
          for (int kx = 0; kx < 3; ++kx)
#pragma unroll
            for (int ci = 0; ci < 3; ++ci) {
              const float v = rows[ky][(2 * p + kx) * 3 + ci];
              in[h][9 * ky + 3 * kx + ci] =
                  (kx == 0 && left) || (kx == 2 && right) ? 0.0f : v;
            }
      }
      float acc[2][16];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float4 b4 = *reinterpret_cast<const float4*>(b_s + c0 + 4 * q);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          acc[h][4 * q + 0] = b4.x;
          acc[h][4 * q + 1] = b4.y;
          acc[h][4 * q + 2] = b4.z;
          acc[h][4 * q + 3] = b4.w;
        }
      }
#pragma unroll
      for (int k = 0; k < 27; ++k) {
        const float4* wk =
            reinterpret_cast<const float4*>(w_s + k * g.C + c0);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float4 wv = wk[q];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            acc[h][4 * q + 0] = fmaf(in[h][k], wv.x, acc[h][4 * q + 0]);
            acc[h][4 * q + 1] = fmaf(in[h][k], wv.y, acc[h][4 * q + 1]);
            acc[h][4 * q + 2] = fmaf(in[h][k], wv.z, acc[h][4 * q + 2]);
            acc[h][4 * q + 3] = fmaf(in[h][k], wv.w, acc[h][4 * q + 3]);
          }
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float4* row = reinterpret_cast<float4*>(
            stage + (64 * blk + lane + 32 * h) * S + 4 * c0);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          float v[4];
#pragma unroll
          for (int e = 0; e < 4; ++e)
            v[e] = Raw ? acc[h][4 * q + e] : silu_mufu(acc[h][4 * q + e]);
          row[q] = make_float4(v[0], v[1], v[2], v[3]);
        }
      }
    }
    __syncthreads();
    store_span<float>(cur, g, y, stage, S);
    slot = slot + 1 == kStages ? 0 : slot + 1;
  }
  cp_async_wait_all();
}

// Raw = true: the pre-BN train forward (no bias, no SiLU; bias unused).
template <typename T, bool Raw>
__global__ void __launch_bounds__(kThreads)
stem_kernel(const T* __restrict__ x, const T* __restrict__ w,
            const T* __restrict__ bias, T* __restrict__ y, const Geo g) {
  extern __shared__ __align__(16) unsigned char smem[];
  if constexpr (std::is_same<T, bf16>::value)
    run_bf16<Raw>(x, w, bias, y, g, smem);
  else
    run_f32<Raw>(x, w, bias, y, g, smem);
}

template <typename T, bool Raw>
cudaError_t launch(const void* x, const void* w, const void* b, void* y,
                   int B, int H, int W, int C, cudaStream_t stream) {
  static PerDeviceSmem smem;
  Geo g;
  g.B = B;
  g.H = H;
  g.W = W;
  g.C = C;
  g.Ho = (H + 1) / 2;
  g.Wo = (W + 1) / 2;
  g.nseg = ceil_div(g.Wo, kSp);
  const long long tiles = (long long)B * g.Ho * g.nseg;
  // the tile index stays below 2^31 while it steps past the last tile
  if (tiles >= (1LL << 30) || C % 16 || C < 16 || C > kMaxC)
    return cudaErrorInvalidValue;
  g.n_tiles = (int)tiles;
  auto kernel = stem_kernel<T, Raw>;
  cudaError_t e = smem.opt_in((const void*)kernel, smem_bytes<T>(kMaxC));
  if (e != cudaSuccess) return e;
  const int bytes = smem_bytes<T>(C);
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                    kThreads, bytes);
  if (e != cudaSuccess) return e;
  const long long ctas = (long long)per_sm * sm_count();
  const int grid = (int)(tiles < ctas ? tiles : ctas);
  kernel<<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const T*>(b), static_cast<T*>(y), g);
  return cudaGetLastError();
}

}  // namespace
}  // namespace yolo

// C must be a multiple of 16 and at most 256, x 16-byte aligned (checked by
// the Python wrapper).
extern "C" int yolo_stem_conv(const void* x, const void* w, const void* b,
                              void* y, int B, int H, int W, int C, int dtype,
                              void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == yolo::kBFloat16)
    return yolo::launch<__nv_bfloat16, false>(x, w, b, y, B, H, W, C, s);
  return yolo::launch<float, false>(x, w, b, y, B, H, W, C, s);
}

// The pre-BN train forward: y = conv3x3_s2_p1(x), no bias, no SiLU, in x's
// dtype rounded once from the f32 accumulator. Same constraints.
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
