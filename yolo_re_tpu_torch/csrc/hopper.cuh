// Hopper (sm_90a) building blocks of the tensor-core kernels conv3.cu,
// csp_chain.cu, stem_wgrad.cu and adown.cu: cp.async with zero fill,
// ldmatrix, warp matrix multiply (mma.sync: bf16, and TF32 with the
// 3xTF32 split that gives the f32 kernels f32 accuracy), and warpgroup
// matrix multiply (wgmma, N = 32 to 256) with A in registers and B in
// shared memory, in bf16 and (m64n128k8) in TF32. A TF32 B has core
// matrices of 8 rows of 4 elements (16 bytes), the same byte strides.
//
// B operand layout ("core matrices", no swizzle): the weights of one
// k-step (16 input channels) for N output channels are N/8 groups of 8
// output channels; each group holds two 8 x 8 core matrices (input
// channels 0-7, then 8-15), each 8 rows of 16 contiguous bytes (one output
// channel's 8 input channels). So the core matrix next along K is 128
// bytes on and the one next along N 256 bytes on (kLboBytes, kSboBytes).
// The Python wrappers pack the weights in this order once
// (ops/kernels/conv3.py, csp_chain.py, adown.py: pack_weights).
//
// A operand: each warp of the warpgroup owns 16 of the 64 rows (pixels);
// ldmatrix.x4 takes one row address per lane (lane l: row l % 16, input
// channels 8 * (l / 16) on), so the 16 pixels of a warp may lie anywhere
// in shared memory: a tap of a 3x3 conv is a shift of those addresses.
#pragma once

#include <cstdint>

#include "common.cuh"

namespace yolo {
namespace sm90 {

// the descriptor's two strides (bytes): next core matrix along K (the
// leading dimension) and along N (the stride dimension)
constexpr uint32_t kLboBytes = 128;
constexpr uint32_t kSboBytes = 256;

// Element index of w[co][ci][ky][kx] (tap = 3 * ky + kx; a 1x1 conv has
// tap 0 only) in the packed weight image of a conv whose input channels
// are padded with zeros to 16 * ksteps and its output channels to n (a
// multiple of 8): blocks (tap, k-step) of 16 x n elements in the B layout
// above, tap-major. The f32 kernels read the same image, so one packed
// buffer serves both dtypes.
__host__ __device__ constexpr int packed_index(int co, int ci, int tap,
                                               int ksteps, int n) {
  return (tap * ksteps + ci / 16) * (16 * n) + (co / 8) * 128 +
         ((ci / 8) % 2) * 64 + (co % 8) * 8 + ci % 8;
}

// ... of a C -> C 3x3 conv (C a multiple of 16)
template <int C>
__host__ __device__ constexpr int packed_index(int co, int ci, int tap) {
  return packed_index(co, ci, tap, C / 16, C);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; valid == false writes 16 zero bytes (the
// conv's zero padding) and reads nothing
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// the same for one 4-byte element (cp.async.ca: .cg copies 16 bytes only)
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// wait until at most N of this thread's cp.async groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// generic-proxy writes to shared memory (stores, cp.async) made visible
// to the async proxy that wgmma reads B through
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// the same, each 8 x 8 matrix transposed: lane l receives the elements
// [2 * (l % 4) + {0, 1}][l / 4] (an mma B fragment from row-major K x N)
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t addr,
                                                  uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d (16 x 8, f32) += a (16 x 16, bf16, row-major fragment) * b (16 x 8,
// bf16, column-major fragment): one warp, mma.sync
__device__ __forceinline__ void mma_m16n8k16(float (&d)[4],
                                             const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// f32-accurate products on the tensor cores (3xTF32), used by the f32
// kernels of csp_chain.cu, stem_wgrad.cu, adown_bwd.cu and adown.cu. TF32
// keeps 10 mantissa bits, too few for the f32 tolerances, so each f32
// operand is split into hi = a rounded to TF32 (to nearest, ties away from
// zero: the value of cvt.rna.tf32.f32) and lo = a - hi (exact in f32) cut
// to TF32 (adown.cu cuts its weights instead: split_w), and a * b
// is taken as lo_a hi_b + hi_a lo_b + hi_a hi_b, the small terms first.
// The dropped lo_a lo_b and the cut of lo are below 2^-21 of |a b|. The
// split is integer arithmetic (4 instructions a value): cvt.rna.tf32.f32
// gives the same hi but compiles to more instructions, and the chain ran
// slower with it. The tensor cores' f32 sums are not rounded to nearest,
// so the kernels add each short run of products (one tap, one segment)
// into their own f32 registers with plain FADDs.
__device__ __forceinline__ void split_tf32(float a, uint32_t& hi,
                                          uint32_t& lo) {
  hi = (__float_as_uint(a) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(a - __uint_as_float(hi)) & 0xffffe000u;
}

// d (16 x 8, f32) += a (16 x 8, tf32, row-major) * b (8 x 8, tf32,
// column-major): one warp, mma.sync m16n8k8. With g = lane / 4 and
// t = lane % 4, lane holds a[0] = A[g][t], a[1] = A[g + 8][t],
// a[2] = A[g][t + 4], a[3] = A[g + 8][t + 4]; b0 = B[t][g], b1 =
// B[t + 4][g]; d[0], d[1] = D[g][2t], D[g][2t + 1], d[2], d[3] the same
// in row g + 8. Which input channel or pixel a column k stands for is the
// caller's choice, as long as A and B agree.
__device__ __forceinline__ void mma_m16n8k8_tf32(float (&d)[4],
                                                 const uint32_t (&a)[4],
                                                 uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d[i][j] += a[i] * b[j] in 3xTF32 for M m16 tiles of A and N n8 tiles
// of B (b[j] = {b0, b1}), from the split operands. The three passes go in
// turn over all M x N tiles, so that consecutive mma.sync are independent:
// a warp issues in order, and a product waits for the one before it on
// the same accumulator.
template <int M, int N>
__device__ __forceinline__ void mma_3xtf32(float (&d)[M][N][4],
                                           const uint32_t (&a_hi)[M][4],
                                           const uint32_t (&a_lo)[M][4],
                                           const uint32_t (&b_hi)[N][2],
                                           const uint32_t (&b_lo)[N][2]) {
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j)
      mma_m16n8k8_tf32(d[i][j], a_lo[i], b_hi[j][0], b_hi[j][1]);
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j)
      mma_m16n8k8_tf32(d[i][j], a_hi[i], b_lo[j][0], b_lo[j][1]);
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j)
      mma_m16n8k8_tf32(d[i][j], a_hi[i], b_hi[j][0], b_hi[j][1]);
}

// shared-memory matrix descriptor, no swizzle
__device__ __forceinline__ uint64_t make_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(kLboBytes >> 4) << 16) |
         (static_cast<uint64_t>(kSboBytes >> 4) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// d (64 x 64, f32) += a (64 x 16, bf16, registers) * b (16 x 64, bf16,
// shared memory by descriptor); scale_d == 0 overwrites d
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32],
                                                const uint32_t (&a)[4],
                                                uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
        "r"(scale_d));
}

// d (64 x 32, f32) += a (64 x 16) * b (16 x 32)
__device__ __forceinline__ void wgmma_m64n32k16(float (&d)[16],
                                                const uint32_t (&a)[4],
                                                uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
        "r"(scale_d));
}

// d (64 x 128, f32) += a (64 x 16) * b (16 x 128)
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64],
                                                 const uint32_t (&a)[4],
                                                 uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
        "r"(scale_d));
}

// d (64 x 256, f32) += a (64 x 16) * b (16 x 256)
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128],
                                                 const uint32_t (&a)[4],
                                                 uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "
      "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, "
      "%93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, "
      "%105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, "
      "%116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, "
      "%127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
        "r"(scale_d));
}

// d (64 x 128, f32) += a (64 x 8, tf32, registers) * b (8 x 128, tf32,
// shared memory by descriptor: K-major core matrices of 8 rows of 4 tf32,
// the next along K kLboBytes on, along N kSboBytes on); scale_d == 0
// overwrites d. A lane's a holds A[g][t], A[g + 8][t], A[g][t + 4],
// A[g + 8][t + 4] of its warp's 16 rows (g = lane / 4, t = lane % 4), as
// mma_m16n8k8_tf32's a.
__device__ __forceinline__ void wgmma_m64n128k8_tf32(float (&d)[64],
                                                     const uint32_t (&a)[4],
                                                     uint64_t desc,
                                                     int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
        "r"(scale_d));
}

// SiLU in f32 with the fast exponential and reciprocal (a few f32 ulps
// from common.cuh's silu, far below the one bf16 rounding that follows)
__device__ __forceinline__ float silu_fast(float y) {
  return y * __frcp_rn(1.0f + __expf(-y));
}

// SiLU by the fast exponential and division (two MUFU operations), within
// ~1e-6 relative of common.cuh's silu, whose IEEE division made the f32
// chain's epilogue a visible share of its time (csp_chain.cu, conv3.cu)
__device__ __forceinline__ float silu_mufu(float y) {
  return __fdividef(y, 1.0f + __expf(-y));
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pick4(const uint32_t (&w)[4], int i) {
  return i == 0 ? w[0] : i == 1 ? w[1] : i == 2 ? w[2] : w[3];
}

// Within each quad of lanes (q = lane % 4), w[j] holds output channels
// 8j + 2q, 8j + 2q + 1 of one pixel (the wgmma accumulator layout); after
// the call o[j] holds channels 8q + 2j, 8q + 2j + 1: each lane then owns
// 16 contiguous bytes of the pixel, for one 16-byte store.
__device__ __forceinline__ void quad_transpose(const uint32_t (&w)[4],
                                               uint32_t (&o)[4], int q) {
  const uint32_t r1 = __shfl_xor_sync(0xffffffffu, pick4(w, q ^ 1), 1);
  const uint32_t r2 = __shfl_xor_sync(0xffffffffu, pick4(w, q ^ 2), 2);
  const uint32_t r3 = __shfl_xor_sync(0xffffffffu, pick4(w, q ^ 3), 3);
  const uint32_t own = pick4(w, q);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int k = j ^ q;
    o[j] = k == 0 ? own : k == 1 ? r1 : k == 2 ? r2 : r3;
  }
}

}  // namespace sm90
}  // namespace yolo
