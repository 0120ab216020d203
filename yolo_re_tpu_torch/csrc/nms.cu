// Greedy NMS selection: per image, repeat max_det times
//   idx  = argmax(live)            (the lower index on ties)
//   keep = live[idx] > 0
//   live[j] = 0 where keep and (IoU(box[idx], box[j]) > iou_thres or j == idx)
//   out[i] = keep ? idx : -1
// over class-offset xyxy boxes (B, K, 4) and scores (B, K) (<= 0 = invalid),
// the candidates in any order.
//
// Replaces the TPU kernel yolo_re_tpu/ops/pallas/nms_kernel.py
// (pallas_nms_select) and, in this package, also the lax.scan greedy loop of
// yolo_re_tpu/ops/nms.py (_nms_single): the same function, tie for tie.
//
// What bounds it on an H100: latency. max_det (300) dependent steps, each a
// reduction over the image's K candidates followed by an elementwise pass;
// the data is tiny (K * 20 bytes per image) and the work per step is K IoUs.
// One block per image left 100 of 132 SMs idle at batch 32 and gave each
// step to one SM.
//
// Design: a thread-block cluster of c CTAs per image (grid B * c; c from the
// wrapper's rule, ops/kernels/nms.py: cluster_size, the largest c whose
// CTAs the SMs hold at once). CTAs are small (256 threads, at most two an
// SM): a step is mostly waiting on latency, and two CTAs of different
// images on one SM fill each other's waits. CTA r of a cluster owns
// the contiguous slice [r * per, (r + 1) * per) of the image's candidates
// (per = ceil(K / c)) and keeps it in shared memory for the whole loop:
// boxes as float4, each box's area (computed once, as the plain version
// computes it) and the live scores, 24 bytes a candidate; thread t owns
// the slice's candidates t, t + kThreads, ... A step:
//   1. each thread holds its best live candidate from the previous pass as
//      a key (score bits, index): live scores are > 0, so their bits order
//      as the scores do, and 0 means none. A warp reduces the keys in two
//      redux.sync (the highest score, then the lowest index holding it);
//   2. lane q < c of every warp writes the warp's winner (key, area, box)
//      into slot [step parity][rank][warp] of CTA q by st.async, which
//      completes on CTA q's mbarrier of that parity: no block barrier and
//      no cluster barrier in the loop. A CTA's mbarrier phase completes
//      when the c * kWarps winners of the step have landed; the slots are
//      double-buffered by parity, and no peer can write step i + 2 before
//      every warp of the cluster has sent step i + 1, so after it has read
//      step i;
//   3. every warp reduces the cluster's c * kWarps winners itself (the
//      same two redux.sync): (score desc, index asc) is a total order, so
//      every warp of every CTA picks the same winner; a winner with score
//      <= 0 stops the whole cluster at the same step;
//   4. one pass over the slice suppresses and, in the same loop, finds each
//      thread's best live candidate for the next step, kUnroll candidates
//      at a time (their loads in flight together). A candidate that is not
//      live (<= 0) is skipped: it can never be chosen while a positive
//      score is live, and once none is the loop stops.
// Before the loop the CTAs pass a cluster barrier (the mbarriers are set up
// before any peer writes), and once more before they exit.
//
// Numerics: the IoU is inter / (area_chosen + area_j - inter) with no
// epsilon, in the order of the plain version, with the _rn intrinsics so
// that no multiply-add is contracted and rounding at the threshold matches
// the plain PyTorch version bit for bit. A NaN IoU (two zero-area boxes)
// compares false, as there. Most candidates belong to another class (the
// offset puts them thousands of pixels away) and have inter == 0 exactly;
// then inter / union is +-0, or NaN where the union is 0 or NaN, so the
// test is decided without the division: suppress iff 0 > iou_thres and the
// union is neither 0 nor NaN. Only a nonzero (or NaN) intersection divides.
#include <cstdint>

#include "common.cuh"

namespace yolo {
namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCluster = 8;   // portable cluster sizes: 1, 2, 4, 8
constexpr int kSlots = kMaxCluster * kWarps;   // a step's warp winners
constexpr int kUnroll = 2;

__device__ __forceinline__ float relu_keep_nan(float d) {
  return d < 0.0f ? 0.0f : d;   // clip(d, 0, None): NaN stays NaN
}

// The best of a warp's keys (score bits s, index i; s = 0: none): the
// highest score, the lowest index on ties; every lane gets it.
__device__ __forceinline__ void warp_best(uint32_t& s, uint32_t& i) {
  const uint32_t m = __reduce_max_sync(0xffffffffu, s);
  i = __reduce_min_sync(0xffffffffu, s == m ? i : 0xffffffffu);
  s = m;
}

// Cluster barrier of all threads of all CTAs of the cluster.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The shared::cluster address of this CTA's shared address a in CTA `rank`.
__device__ __forceinline__ uint32_t map_to_rank(uint32_t a, int rank) {
  uint32_t d;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(d) : "r"(a), "r"(rank));
  return d;
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// arrive and expect `bytes` of st.async on the barrier
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar), "r"(bytes)
               : "memory");
}

// wait until the barrier's phase of parity `parity` has completed; acquire
// at cluster scope, as the data came from the cluster's CTAs
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT:\n"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%0], "
      "%1;\n"
      "@!p bra WAIT;\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// 16 bytes into a peer's shared memory, completing on its mbarrier
__device__ __forceinline__ void st_async(uint32_t addr, uint4 v,
                                         uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], "
      "{%1, %2, %3, %4}, [%5];\n" ::"r"(addr),
      "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w), "r"(bar)
      : "memory");
}

// two CTAs an SM (at most 128 registers a thread): the wrapper's rule
// counts on it
__global__ void __launch_bounds__(kThreads, 2)
nms_cluster_kernel(const float* __restrict__ boxes,
                   const float* __restrict__ scores, int* __restrict__ out,
                   int K, int max_det, float iou_thres, int c) {
  extern __shared__ float4 smem[];
  // [step parity][rank * kWarps + warp]: a warp's winner as its peers read
  // it, the key (score bits, index, area bits, unused) and the box
  __shared__ uint4 slot_key[2][kSlots];
  __shared__ float4 slot_box[2][kSlots];
  __shared__ __align__(8) unsigned long long full[2];

  const int rank = blockIdx.x % c, b = blockIdx.x / c;
  const int per = (K + c - 1) / c;
  const int lo = rank * per;
  const int n = max(0, min(K - lo, per));
  float4* box = smem;
  float* area = reinterpret_cast<float*>(box + per);
  float* live = area + per;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int step_bytes = c * kWarps * (int)(2 * sizeof(uint4));

  if (tid == 0) {
    for (int p = 0; p < 2; ++p) {
      mbar_init(smem_addr(&full[p]), 1);
      mbar_expect_tx(smem_addr(&full[p]), step_bytes);   // steps 0 and 1
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // peers write into the slots only once every CTA has its mbarriers
  cluster_arrive();

  const float4* bx = reinterpret_cast<const float4*>(boxes) +
                     (size_t)b * K + lo;
  const float* sc = scores + (size_t)b * K + lo;
  uint32_t s = 0, si = 0xffffffffu;   // this thread's best live key
  for (int j = tid; j < n; j += kThreads) {
    const float4 v = bx[j];
    const float l = sc[j];
    box[j] = v;
    area[j] = __fmul_rn(__fsub_rn(v.z, v.x), __fsub_rn(v.w, v.y));
    live[j] = l;
    if (l > 0.0f && __float_as_uint(l) > s) {   // j rises: ties keep the
      s = __float_as_uint(l);                   // lower index
      si = lo + j;
    }
  }
  // lane q < c of each warp writes the warp's winner into CTA q
  const int me = rank * kWarps + warp;
  uint32_t key_to = 0, box_to = 0, bar_to = 0;
  if (lane < c) {
    key_to = map_to_rank(smem_addr(&slot_key[0][me]), lane);
    box_to = map_to_rank(smem_addr(&slot_box[0][me]), lane);
    bar_to = map_to_rank(smem_addr(&full[0]), lane);
  }
  const bool zero_suppresses = 0.0f > iou_thres;
  const int slots = c * kWarps;
  int* ob = out + (size_t)b * max_det;
  cluster_wait();

  int i = 0;
  for (; i < max_det; ++i) {
    const int p = i & 1;
    // 1. the warp's best live candidate
    warp_best(s, si);
    // 2. to every CTA of the cluster
    if (lane < c) {
      float4 wb = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      float wa = 0.0f;
      if (s != 0) {
        wb = box[si - lo];
        wa = area[si - lo];
      }
      const uint32_t bar = bar_to + p * 8;
      st_async(key_to + p * kSlots * 16,
               make_uint4(s, si, __float_as_uint(wa), 0u), bar);
      st_async(box_to + p * kSlots * 16,
               make_uint4(__float_as_uint(wb.x), __float_as_uint(wb.y),
                          __float_as_uint(wb.z), __float_as_uint(wb.w)),
               bar);
    }
    // 3. the image's winner, the same in every warp of every CTA
    mbar_wait(smem_addr(&full[p]), (i >> 1) & 1);
    uint32_t ws = 0, wi = 0xffffffffu;
    int wslot = 0;
    for (int q = lane; q < slots; q += 32) {
      const uint4 k = slot_key[p][q];
      if (k.x > ws || (k.x == ws && k.y < wi)) {
        ws = k.x;
        wi = k.y;
        wslot = q;
      }
    }
    const uint32_t mine = ws, mine_i = wi;
    warp_best(ws, wi);
    if (ws == 0) break;                 // nothing live: the rest is -1
    wslot = __shfl_sync(0xffffffffu, wslot,
                        __ffs(__ballot_sync(0xffffffffu, mine == ws &&
                                                         mine_i == wi)) - 1);
    if (tid == 0) {
      if (rank == 0) ob[i] = (int)wi;
      if (i + 2 < max_det) mbar_expect_tx(smem_addr(&full[p]), step_bytes);
    }
    const float4 cb = slot_box[p][wslot];
    const float carea = __uint_as_float(slot_key[p][wslot].z);
    // 4. suppress; each thread's best live candidate for the next step
    s = 0;
    si = 0xffffffffu;
    for (int j0 = tid; j0 < n; j0 += kUnroll * kThreads) {
      float l[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int j = j0 + u * kThreads;
        l[u] = j < n ? live[j] : 0.0f;
      }
      float4 v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (l[u] > 0.0f) v[u] = box[j0 + u * kThreads];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (!(l[u] > 0.0f)) continue;
        const int j = j0 + u * kThreads;
        const float iw = relu_keep_nan(
            __fsub_rn(fminf(cb.z, v[u].z), fmaxf(cb.x, v[u].x)));
        const float ih = relu_keep_nan(
            __fsub_rn(fminf(cb.w, v[u].w), fmaxf(cb.y, v[u].y)));
        const float inter = __fmul_rn(iw, ih);
        bool suppress = (uint32_t)(lo + j) == wi;
        if (inter != 0.0f) {
          const float iou = __fdiv_rn(
              inter, __fsub_rn(__fadd_rn(carea, area[j]), inter));
          suppress |= iou > iou_thres;
        } else if (zero_suppresses) {
          const float un = __fsub_rn(__fadd_rn(carea, area[j]), inter);
          suppress |= un == un && un != 0.0f;
        }
        if (suppress) {
          live[j] = 0.0f;
        } else if (__float_as_uint(l[u]) > s) {
          s = __float_as_uint(l[u]);
          si = lo + j;
        }
      }
    }
  }
  // no CTA leaves while a peer could still write into its shared memory
  cluster_arrive();
  cluster_wait();
  if (rank == 0)
    for (int k = i + tid; k < max_det; k += kThreads) ob[k] = -1;
}

}  // namespace
}  // namespace yolo

// boxes (B, K, 4) f32, scores (B, K) f32, out_idx (B, max_det) int32; one
// cluster of c CTAs (1, 2, 4 or 8) per image, each CTA holding ceil(K / c)
// candidates in shared memory. A cluster that cannot be scheduled is an
// error, returned as such.
extern "C" int yolo_nms_select(const void* boxes, const void* scores,
                               void* out_idx, int B, int K, int max_det,
                               float iou_thres, int c, void* stream) {
  if (c < 1 || c > yolo::kMaxCluster || (c & (c - 1)))
    return cudaErrorInvalidValue;
  const int per = (K + c - 1) / c;
  const size_t smem = (size_t)per * (sizeof(float4) + 2 * sizeof(float));
  // the largest slice the wrapper's rule makes (ops/kernels/nms.py:
  // SLICE_BYTES), beside the kernel's 4 KB of static slots
  static yolo::PerDeviceSmem smem_opt_in;
  cudaError_t e = smem_opt_in.opt_in((const void*)yolo::nms_cluster_kernel,
                                     222 * 1024);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * c);
  cfg.blockDim = dim3(yolo::kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = c;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, yolo::nms_cluster_kernel,
                         static_cast<const float*>(boxes),
                         static_cast<const float*>(scores),
                         static_cast<int*>(out_idx), K, max_det, iou_thres,
                         c);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}
