// Train-mode BatchNorm + activation (SiLU or none), forward and backward,
// over the NHWC rows of an NCHW tensor in channels_last memory:
//   forward   mean, var = batch moments of y (per channel, f32)
//             inv = rsqrt(var + eps) * weight, shift = bias - mean * inv
//             z = act(y * inv + shift), at bn_affine's rounding points
//             running stats updated in place (unbiased variance)
//   backward  gA = g * act'(a), a recomputed from y, inv, shift
//             dbias = sum gA, dweight = sum gA * xhat, xhat = (y - mean) rstd
//             dx = inv * (gA - mean(gA) - xhat * mean(gA * xhat))
//
// Replaces no TPU kernel: the JAX package leaves train BN to XLA's fusions
// (yolo_re_tpu/ops/conv.py: conv_bn_act, train=True). It replaces the eager
// PyTorch chain of ops/conv.py (batch_moments, update_running_stats,
// bn_affine, the activation) and autograd's backward through each of its
// ops: ~85 bytes an element in ~45 launches a site.
//
// What bounds it on an H100: bytes, 10 an element in bf16 (y read and z
// written forward, g and y read and dx written backward) at 3.35 TB/s. The
// kernels move 16: the moments read y (2 bytes in bf16), the affine pass
// reads y and writes z (4), the backward's sums read g and y (4), dx reads
// both and writes one (6). Nothing is saved for the backward but y and the
// [5, C] statistics.
//
// Two kernels over one walk. A block owns a tile of channels (tpr threads
// a row, VEC channels a thread: 16-byte loads, neighbouring threads on
// neighbouring channels) and every gridDim.x-th run of rows; a thread keeps
// its channels' coefficients in registers for the whole walk and loads
// kLoads rows before it uses the first, so that enough bytes are in flight.
//   bn_reduce_kernel<JOB>: per-thread f32 sums over its rows, a fixed-order
//     sum over the block's row groups in shared memory, per-block partials
//     in device memory; the last block of a channel tile (an atomic ticket,
//     reset by that block) sums the partials in block order and finishes:
//     no float atomics, so two identical calls are bit-equal. JOBs:
//       kSumSq    bf16 moments in one pass: sum y, sum y^2 (var = E[y^2] -
//                 mean^2 clamped at 0, as the JAX package's bf16 path);
//       kSum      f32 pass 1: sum y -> mean;
//       kCentered f32 pass 2: sum (y - mean)^2 -> var (two-pass, as the
//                 JAX package's f32 path);
//       kGrad     the backward's sum gA and sum gA * xhat.
//     The moments' finish writes the statistics and updates the running
//     ones (skipped when the caller recomputes a checkpointed forward); two
//     BN modules may share one tensor (ADown: channels [0, split) and
//     [split, C)).
//   bn_pointwise_kernel<BWD>: z = act(a), or dx, one pass.
// The backward reads g's rows at a pitch: channels_last, or a channel slice
// of a wider channels_last tensor, as a concat's backward hands it over.
// Rounding: in bf16 the product y * inv and the sum + shift are rounded to
// bf16 (inv and shift first rounded to bf16), then SiLU is taken in f32 and
// rounded: bn_affine's and F.silu's points. The _rn intrinsics keep the
// multiply and the add apart, as PyTorch's two ops are. The backward works
// in f32 and rounds dx once. Where the one-pass variance was clamped at 0
// the variance term of dx is 0 (autograd's gradient of the clamp).
#include <cstdint>
#include <initializer_list>

#include "common.cuh"

namespace yolo {
namespace {

constexpr int kThreads = 256;
constexpr int kLoads = 4;  // rows a thread loads before it uses the first
constexpr int kBatch = 16;  // partials a thread of the last block loads at once

// rows of the statistics [kStatRows][C] and of the backward's sums [4][C]
constexpr int kMean = 0, kRstd = 1, kInv = 2, kShift = 3, kKeep = 4;
constexpr int kDbias = 0, kDweight = 1, kGMean = 2, kGXMean = 3;

enum Job { kSumSq = 0, kSum = 1, kCentered = 2, kGrad = 3 };
enum Act { kActNone = 0, kActSilu = 1 };

template <typename T>
struct Full;  // elements in 16 bytes
template <>
struct Full<float> { static constexpr int kVec = 4; };
template <>
struct Full<__nv_bfloat16> { static constexpr int kVec = 8; };

template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_f32(from_f32<T>(v));
}

// V elements of T as one load brings them: rows are loaded kLoads at a time
// into these (4 registers a 16-byte vector) and unpacked when used.
template <typename T, int V>
struct Raw {
  using type = T;
};
template <>
struct Raw<float, 4> {
  using type = float4;
};
template <>
struct Raw<__nv_bfloat16, 8> {
  using type = uint4;
};

template <typename T, int V>
__device__ __forceinline__ typename Raw<T, V>::type load(
    const T* __restrict__ p) {
  return *reinterpret_cast<const typename Raw<T, V>::type*>(p);
}

template <typename T, int V>
__device__ __forceinline__ void unpack(const typename Raw<T, V>::type& u,
                                       float (&out)[V]) {
  if constexpr (V == 1) {
    out[0] = to_f32(u);
  } else if constexpr (sizeof(T) == 4) {
    static_assert(V == 4, "f32 vectors are 4 wide");
    out[0] = u.x; out[1] = u.y; out[2] = u.z; out[3] = u.w;
  } else {
    static_assert(V == 8, "bf16 vectors are 8 wide");
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
}

template <typename T, int V>
__device__ __forceinline__ void store(T* __restrict__ p, const float (&v)[V]) {
  if constexpr (V == 1) {
    p[0] = from_f32<T>(v[0]);
  } else if constexpr (sizeof(T) == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    uint4 u;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = u;
  }
}

// a = y * inv + shift in T (inv, shift already rounded to T)
template <typename T>
__device__ __forceinline__ float affine(float y, float inv, float shift) {
  return round_to<T>(__fadd_rn(round_to<T>(__fmul_rn(y, inv)), shift));
}

// act'(a) * g, SiLU's derivative as PyTorch's silu_backward writes it
template <int ACT>
__device__ __forceinline__ float grad_act(float g, float a) {
  if constexpr (ACT == kActNone) return g;
  const float s = 1.0f / (1.0f + expf(-a));
  return g * s * (1.0f + a * (1.0f - s));
}

// What the last block of a channel tile writes.
struct Finish {
  const float* weight;  // [C] f32
  const float* bias;    // [C] f32
  float* stats;         // [kStatRows][C]
  float* grads;         // [4][C] (kGrad)
  float* running_mean[2];
  float* running_var[2];
  long long* tracked[2];  // num_batches_tracked
  int split;            // channels [0, split) -> module 0, the rest -> 1
  int update;           // 0: leave the running statistics as they are
  float n;              // rows: samples per channel
  float unbiased;       // n / (n - 1)
  float eps, momentum, keep_rate;  // keep_rate = 1 - momentum
};

template <int JOB>
__device__ __forceinline__ void finish(const Finish& f, int c, int C, float s0,
                                       float s1) {
  if constexpr (JOB == kSum) {
    f.stats[kMean * C + c] = s0 / f.n;
  } else if constexpr (JOB == kGrad) {
    f.grads[kDbias * C + c] = s0;
    f.grads[kDweight * C + c] = s1;
    f.grads[kGMean * C + c] = s0 / f.n;
    f.grads[kGXMean * C + c] = f.stats[kKeep * C + c] != 0.0f ? s1 / f.n : 0.0f;
  } else {
    float mean, var, keep = 1.0f;
    if constexpr (JOB == kSumSq) {
      mean = s0 / f.n;
      const float raw = __fsub_rn(s1 / f.n, __fmul_rn(mean, mean));
      keep = raw >= 0.0f ? 1.0f : 0.0f;
      var = fmaxf(raw, 0.0f);
    } else {
      mean = f.stats[kMean * C + c];
      var = s0 / f.n;
    }
    const float rstd = rsqrtf(__fadd_rn(var, f.eps));
    const float inv = __fmul_rn(rstd, f.weight[c]);
    f.stats[kMean * C + c] = mean;
    f.stats[kRstd * C + c] = rstd;
    f.stats[kInv * C + c] = inv;
    f.stats[kShift * C + c] = __fsub_rn(f.bias[c], __fmul_rn(mean, inv));
    f.stats[kKeep * C + c] = keep;
    if (f.update) {
      const int m = c < f.split ? 0 : 1;
      const int i = m ? c - f.split : c;
      float* rm = f.running_mean[m];
      float* rv = f.running_var[m];
      rm[i] = __fadd_rn(__fmul_rn(f.keep_rate, rm[i]),
                        __fmul_rn(f.momentum, mean));
      rv[i] = __fadd_rn(__fmul_rn(f.keep_rate, rv[i]),
                        __fmul_rn(f.momentum, __fmul_rn(var, f.unbiased)));
      if (i == 0) f.tracked[m][0] += 1;
    }
  }
}

template <typename T, int V, int JOB, int ACT>
__global__ void __launch_bounds__(kThreads)
bn_reduce_kernel(const T* __restrict__ y, const T* __restrict__ g, int rows,
                 int C, int ldg, int tpr, float* __restrict__ part,
                 unsigned* __restrict__ tickets, Finish f) {
  __shared__ float red[2][kThreads * V];
  __shared__ bool last;
  const int tile = tpr * V;
  const int rpp = kThreads / tpr;
  const int lane = threadIdx.x % tpr, grp = threadIdx.x / tpr;
  const int c0 = blockIdx.y * tile + lane * V;
  float a0[V], a1[V];
#pragma unroll
  for (int v = 0; v < V; ++v) a0[v] = a1[v] = 0.0f;
  if (c0 < C) {
    float mean[V], rstd[V], inv[V], shift[V];
#pragma unroll
    for (int v = 0; v < V; ++v) {
      if constexpr (JOB == kCentered || JOB == kGrad)
        mean[v] = f.stats[kMean * C + c0 + v];
      if constexpr (JOB == kGrad) {
        rstd[v] = f.stats[kRstd * C + c0 + v];
        inv[v] = round_to<T>(f.stats[kInv * C + c0 + v]);
        shift[v] = round_to<T>(f.stats[kShift * C + c0 + v]);
      }
    }
    const long long stride = static_cast<long long>(gridDim.x) * rpp;
    for (long long r0 = static_cast<long long>(blockIdx.x) * rpp + grp;
         r0 < rows; r0 += stride * kLoads) {
      typename Raw<T, V>::type xr[kLoads], gr[kLoads];
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        const long long r = r0 + u * stride;
        if (r < rows) {
          xr[u] = load<T, V>(y + r * C + c0);
          if constexpr (JOB == kGrad) gr[u] = load<T, V>(g + r * ldg + c0);
        }
      }
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        if (r0 + u * stride >= rows) break;
        float x[V];
        unpack<T, V>(xr[u], x);
        if constexpr (JOB == kSumSq) {
#pragma unroll
          for (int v = 0; v < V; ++v) {
            a0[v] += x[v];
            a1[v] = fmaf(x[v], x[v], a1[v]);
          }
        } else if constexpr (JOB == kSum) {
#pragma unroll
          for (int v = 0; v < V; ++v) a0[v] += x[v];
        } else if constexpr (JOB == kCentered) {
#pragma unroll
          for (int v = 0; v < V; ++v) {
            const float d = x[v] - mean[v];
            a0[v] = fmaf(d, d, a0[v]);
          }
        } else {
          float gg[V];
          unpack<T, V>(gr[u], gg);
#pragma unroll
          for (int v = 0; v < V; ++v) {
            const float ga =
                grad_act<ACT>(gg[v], affine<T>(x[v], inv[v], shift[v]));
            a0[v] += ga;
            a1[v] = fmaf(ga, (x[v] - mean[v]) * rstd[v], a1[v]);
          }
        }
      }
    }
  }
#pragma unroll
  for (int v = 0; v < V; ++v) {
    red[0][grp * tile + lane * V + v] = a0[v];
    red[1][grp * tile + lane * V + v] = a1[v];
  }
  __syncthreads();
  // the block's sums, over its row groups in order
  const int cb = blockIdx.y * tile;
  if (threadIdx.x < tile && cb + threadIdx.x < C) {
    float s0 = 0.0f, s1 = 0.0f;
    for (int q = 0; q < rpp; ++q) {
      s0 += red[0][q * tile + threadIdx.x];
      s1 += red[1][q * tile + threadIdx.x];
    }
    const long long c = cb + threadIdx.x;
    part[(2LL * blockIdx.x) * C + c] = s0;
    part[(2LL * blockIdx.x + 1) * C + c] = s1;
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    last = atomicAdd(&tickets[blockIdx.y], 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  // the last block: the tile's partials in block order, in kThreads / tile
  // interleaved groups, then the groups in order
  const int groups = kThreads / tile;
  const int j = threadIdx.x % tile, q = threadIdx.x / tile;
  const int c = cb + j;
  float s0 = 0.0f, s1 = 0.0f;
  if (c < C) {
    // kBatch loads in flight, then their sums in order
    const int blocks = gridDim.x;
    for (int b0 = q; b0 < blocks; b0 += kBatch * groups) {
      float p0[kBatch], p1[kBatch];
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        const int b = b0 + k * groups;
        p0[k] = b < blocks ? __ldcg(part + (2LL * b) * C + c) : 0.0f;
        p1[k] = b < blocks ? __ldcg(part + (2LL * b + 1) * C + c) : 0.0f;
      }
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        s0 += p0[k];
        s1 += p1[k];
      }
    }
  }
  red[0][q * tile + j] = s0;
  red[1][q * tile + j] = s1;
  __syncthreads();
  if (threadIdx.x == 0) tickets[blockIdx.y] = 0;
  if (q == 0 && c < C) {
    for (int k = 1; k < groups; ++k) {
      s0 += red[0][k * tile + j];
      s1 += red[1][k * tile + j];
    }
    finish<JOB>(f, c, C, s0, s1);
  }
}

template <typename T, int V, int ACT, bool BWD>
__global__ void __launch_bounds__(kThreads)
bn_pointwise_kernel(const T* __restrict__ y, const T* __restrict__ g,
                    T* __restrict__ out, int rows, int C, int ldg, int tpr,
                    const float* __restrict__ stats,
                    const float* __restrict__ grads) {
  const int rpp = kThreads / tpr;
  const int lane = threadIdx.x % tpr, grp = threadIdx.x / tpr;
  const int c0 = blockIdx.y * tpr * V + lane * V;
  if (c0 >= C) return;
  float inv[V], shift[V], invf[V], mean[V], rstd[V], m1[V], m2[V];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    invf[v] = stats[kInv * C + c0 + v];
    inv[v] = round_to<T>(invf[v]);
    shift[v] = round_to<T>(stats[kShift * C + c0 + v]);
    if constexpr (BWD) {
      mean[v] = stats[kMean * C + c0 + v];
      rstd[v] = stats[kRstd * C + c0 + v];
      m1[v] = grads[kGMean * C + c0 + v];
      m2[v] = grads[kGXMean * C + c0 + v];
    }
  }
  const long long stride = static_cast<long long>(gridDim.x) * rpp;
  for (long long r0 = static_cast<long long>(blockIdx.x) * rpp + grp;
       r0 < rows; r0 += stride * kLoads) {
    typename Raw<T, V>::type xr[kLoads], gr[kLoads];
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const long long r = r0 + u * stride;
      if (r < rows) {
        xr[u] = load<T, V>(y + r * C + c0);
        if constexpr (BWD) gr[u] = load<T, V>(g + r * ldg + c0);
      }
    }
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const long long r = r0 + u * stride;
      if (r >= rows) break;
      float x[V], gg[V], o[V];
      unpack<T, V>(xr[u], x);
      if constexpr (BWD) unpack<T, V>(gr[u], gg);
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const float a = affine<T>(x[v], inv[v], shift[v]);
        if constexpr (BWD) {
          const float ga = grad_act<ACT>(gg[v], a);
          const float xhat = (x[v] - mean[v]) * rstd[v];
          o[v] = invf[v] * (ga - m1[v] - xhat * m2[v]);
        } else {
          o[v] = ACT == kActSilu ? silu(a) : a;
        }
      }
      store<T, V>(out + r * C + c0, o);
    }
  }
}

// The walk's geometry: threads a row (a power of two, at most 32, enough
// for the row's vectors), channel tiles, row blocks (each at least
// min_passes passes over its rows where the rows allow).
struct Walk {
  int tpr;
  dim3 grid;
};

inline int pow2_at_least(int n) {
  int p = 1;
  while (p < n) p *= 2;
  return p;
}

inline Walk walk(int rows, int C, int vec, int blocks_per_sm,
                 int min_passes) {
  Walk w;
  w.tpr = pow2_at_least(ceil_div(C, vec));
  if (w.tpr > 32) w.tpr = 32;
  const int tiles = ceil_div(C, w.tpr * vec);
  const int want = ceil_div(ceil_div(rows, kThreads / w.tpr), min_passes);
  int blocks = sm_count() * blocks_per_sm / tiles;
  if (blocks < 1) blocks = 1;
  w.grid = dim3(want < blocks ? want : blocks, tiles);
  return w;
}

// The wrapper sizes the partials for kReduceBlocksPerSm blocks an SM
// (ops/kernels/bn_silu.py: REDUCE_BLOCKS_PER_SM): 16 warps an SM keep
// enough 16-byte loads in flight, and the last block sums few partials;
// a reduction block makes at least kReducePasses passes.
constexpr int kReduceBlocksPerSm = 2;
constexpr int kReducePasses = 16;
constexpr int kPointwiseBlocksPerSm = 4;

// What a launch needs besides its template arguments.
struct Launch {
  const void* y;
  const void* g;  // the upstream gradient, rows ldg elements apart
  void* out;      // z or dx, dense
  int rows, C, ldg, act;
  void* part;
  long long part_floats;
  void* tickets;
  int n_tickets;
  const void* stats;
  const void* grads;
  Finish f;
  cudaStream_t s;
};

template <typename T, int V, int JOB, int ACT>
cudaError_t reduce(const Launch& a) {
  const Walk w = walk(a.rows, a.C, V, kReduceBlocksPerSm, kReducePasses);
  if (w.grid.x == 0 || 2LL * w.grid.x * a.C > a.part_floats ||
      static_cast<int>(w.grid.y) > a.n_tickets)
    return cudaErrorInvalidValue;
  bn_reduce_kernel<T, V, JOB, ACT><<<w.grid, kThreads, 0, a.s>>>(
      static_cast<const T*>(a.y), static_cast<const T*>(a.g), a.rows, a.C,
      a.ldg, w.tpr, static_cast<float*>(a.part),
      static_cast<unsigned*>(a.tickets), a.f);
  return cudaGetLastError();
}

template <typename T, int V, int ACT, bool BWD>
cudaError_t pointwise(const Launch& a) {
  const Walk w = walk(a.rows, a.C, V, kPointwiseBlocksPerSm, 1);
  if (w.grid.x == 0) return cudaErrorInvalidValue;
  bn_pointwise_kernel<T, V, ACT, BWD><<<w.grid, kThreads, 0, a.s>>>(
      static_cast<const T*>(a.y), static_cast<const T*>(a.g),
      static_cast<T*>(a.out), a.rows, a.C, a.ldg, w.tpr,
      static_cast<const float*>(a.stats), static_cast<const float*>(a.grads));
  return cudaGetLastError();
}

// The four jobs, each for one element type and vector width.
template <typename T, int V>
struct Moments {
  static cudaError_t run(const Launch& a) {
    if constexpr (sizeof(T) == 2) {
      return reduce<T, V, kSumSq, kActNone>(a);
    } else {
      const cudaError_t e = reduce<T, V, kSum, kActNone>(a);
      if (e != cudaSuccess) return e;
      return reduce<T, V, kCentered, kActNone>(a);
    }
  }
};

template <typename T, int V>
struct AffineAct {
  static cudaError_t run(const Launch& a) {
    return a.act == kActSilu ? pointwise<T, V, kActSilu, false>(a)
                             : pointwise<T, V, kActNone, false>(a);
  }
};

template <typename T, int V>
struct GradSums {
  static cudaError_t run(const Launch& a) {
    return a.act == kActSilu ? reduce<T, V, kGrad, kActSilu>(a)
                             : reduce<T, V, kGrad, kActNone>(a);
  }
};

template <typename T, int V>
struct GradInput {
  static cudaError_t run(const Launch& a) {
    return a.act == kActSilu ? pointwise<T, V, kActSilu, true>(a)
                             : pointwise<T, V, kActNone, true>(a);
  }
};

// 16-byte vectors where C, g's row pitch and every pointer allow, else one
// element a thread; then the element type.
template <template <typename, int> class Job, typename T>
cudaError_t by_width(const Launch& a) {
  constexpr int kVec = Full<T>::kVec;
  bool full = a.C % kVec == 0 && a.ldg % kVec == 0;
  for (const void* p : {a.y, a.g, static_cast<const void*>(a.out)})
    if (p && reinterpret_cast<uintptr_t>(p) % 16) full = false;
  return full ? Job<T, kVec>::run(a) : Job<T, 1>::run(a);
}

template <template <typename, int> class Job>
cudaError_t run(const Launch& a, int dtype) {
  return dtype == kBFloat16 ? by_width<Job, __nv_bfloat16>(a)
                            : by_width<Job, float>(a);
}

}  // namespace
}  // namespace yolo

// The forward: the moments and statistics (one launch in bf16, two in
// f32), the running statistics of one module (split = C, module 1's
// pointers null) or two (ADown: [0, split) and [split, C)) updated unless
// update = 0; then z = act(y * inv + shift).
extern "C" int yolo_bn_forward(
    const void* y, const void* weight, const void* bias, void* stats,
    void* part, long long part_floats, void* tickets, int n_tickets,
    void* rm0, void* rv0, void* nbt0, void* rm1, void* rv1, void* nbt1,
    int split, int rows, int C, float eps, float momentum, float keep_rate,
    float unbiased, int update, void* z, int act, int dtype, void* stream) {
  yolo::Launch a{};
  a.y = y;
  a.rows = rows;
  a.C = a.ldg = C;
  a.part = part;
  a.part_floats = part_floats;
  a.tickets = tickets;
  a.n_tickets = n_tickets;
  a.stats = stats;
  a.s = static_cast<cudaStream_t>(stream);
  yolo::Finish& f = a.f;
  f.weight = static_cast<const float*>(weight);
  f.bias = static_cast<const float*>(bias);
  f.stats = static_cast<float*>(stats);
  f.running_mean[0] = static_cast<float*>(rm0);
  f.running_mean[1] = static_cast<float*>(rm1);
  f.running_var[0] = static_cast<float*>(rv0);
  f.running_var[1] = static_cast<float*>(rv1);
  f.tracked[0] = static_cast<long long*>(nbt0);
  f.tracked[1] = static_cast<long long*>(nbt1);
  f.split = split;
  f.update = update;
  f.n = static_cast<float>(rows);
  f.unbiased = unbiased;
  f.eps = eps;
  f.momentum = momentum;
  f.keep_rate = keep_rate;
  const int e = yolo::run<yolo::Moments>(a, dtype);
  if (e != 0) return e;
  a.out = z;
  a.act = act;
  return yolo::run<yolo::AffineAct>(a, dtype);
}

// The backward: grads [4][C] = sum gA, sum gA * xhat, their means (the
// second 0 where the variance was clamped); then dx = inv * (gA - mean(gA)
// - xhat * mean(gA * xhat)), rounded once. g's rows lie ldg elements apart
// (C, or more for a channel slice of a wider channels_last tensor).
extern "C" int yolo_bn_backward(const void* g, const void* y,
                                const void* stats, void* grads, void* part,
                                long long part_floats, void* tickets,
                                int n_tickets, void* dx, int rows, int C,
                                int ldg, int act, int dtype, void* stream) {
  yolo::Launch a{};
  a.y = y;
  a.g = g;
  a.rows = rows;
  a.C = C;
  a.ldg = ldg;
  a.act = act;
  a.part = part;
  a.part_floats = part_floats;
  a.tickets = tickets;
  a.n_tickets = n_tickets;
  a.stats = stats;
  a.grads = grads;
  a.s = static_cast<cudaStream_t>(stream);
  a.f.stats = const_cast<float*>(static_cast<const float*>(stats));
  a.f.grads = static_cast<float*>(grads);
  a.f.n = static_cast<float>(rows);
  const int e = yolo::run<yolo::GradSums>(a, dtype);
  if (e != 0) return e;
  a.out = dx;
  return yolo::run<yolo::GradInput>(a, dtype);
}
