// Greedy NMS selection: per image, repeat max_det times
//   idx  = argmax(live)            (the lower index on ties)
//   keep = live[idx] > 0
//   live[j] = 0 where keep and (IoU(box[idx], box[j]) > iou_thres or j == idx)
//   out[i] = keep ? idx : -1
// over class-offset xyxy boxes (B, K, 4) and scores (B, K) (<= 0 = invalid).
//
// Replaces the TPU kernel yolo_re_tpu/ops/pallas/nms_kernel.py
// (pallas_nms_select) and, in this package, also the lax.scan greedy loop of
// yolo_re_tpu/ops/nms.py (_nms_single): the same function, tie for tie.
//
// What bounds it on an H100: latency. max_det (300) dependent steps, each a
// block-wide reduction followed by an elementwise pass; the data is tiny
// (K * 20 bytes per image) and the work per step is K IoUs.
//
// Design: one block per image. The boxes (as four coordinate arrays) and the
// live scores stay in shared memory for the whole loop: K = 8400 (gelan-c's
// all anchors at 640) is 168 KB, under the 227 KB a block can take. A step
// is a per-thread scan, a warp-shuffle argmax, one cross-warp round through
// shared memory, then the suppression pass; the loop ends as soon as no
// live score is left, since every later output is -1 anyway.
//
// Numerics: the IoU is inter / (area_chosen + area_j - inter) with no
// epsilon, in the order of the plain version, with the _rn intrinsics so
// that no multiply-add is contracted and rounding at the threshold matches
// the plain PyTorch version bit for bit. A NaN IoU (two zero-area boxes)
// compares false, as there.
#include <climits>

#include "common.cuh"

namespace yolo {
namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ void better(float& s, int& i, float s2, int i2) {
  if (s2 > s || (s2 == s && i2 < i)) {
    s = s2;
    i = i2;
  }
}

__device__ __forceinline__ float relu_keep_nan(float d) {
  return d < 0.0f ? 0.0f : d;   // clip(d, 0, None): NaN stays NaN
}

__global__ void __launch_bounds__(kThreads)
nms_kernel(const float* __restrict__ boxes, const float* __restrict__ scores,
           int* __restrict__ out, int K, int max_det, float iou_thres) {
  extern __shared__ float smem[];
  float* x1 = smem;
  float* y1 = x1 + K;
  float* x2 = y1 + K;
  float* y2 = x2 + K;
  float* live = y2 + K;
  __shared__ float red_s[kWarps];
  __shared__ int red_i[kWarps];
  __shared__ int chosen;
  __shared__ float chosen_score;

  const int b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const float4* bx = reinterpret_cast<const float4*>(boxes) + (size_t)b * K;
  for (int j = tid; j < K; j += kThreads) {
    const float4 v = bx[j];
    x1[j] = v.x; y1[j] = v.y; x2[j] = v.z; y2[j] = v.w;
    live[j] = scores[(size_t)b * K + j];
  }
  int* ob = out + (size_t)b * max_det;
  __syncthreads();

  int i = 0;
  for (; i < max_det; ++i) {
    // block-wide argmax, lower index on ties
    float s = -CUDART_INF_F;
    int si = INT_MAX;
    for (int j = tid; j < K; j += kThreads) better(s, si, live[j], j);
#pragma unroll
    for (int off = 16; off > 0; off /= 2)
      better(s, si, __shfl_down_sync(0xffffffffu, s, off),
             __shfl_down_sync(0xffffffffu, si, off));
    if (lane == 0) {
      red_s[warp] = s;
      red_i[warp] = si;
    }
    __syncthreads();
    if (warp == 0) {
      s = lane < kWarps ? red_s[lane] : -CUDART_INF_F;
      si = lane < kWarps ? red_i[lane] : INT_MAX;
#pragma unroll
      for (int off = 16; off > 0; off /= 2)
        better(s, si, __shfl_down_sync(0xffffffffu, s, off),
               __shfl_down_sync(0xffffffffu, si, off));
      if (lane == 0) {
        chosen = si;
        chosen_score = s;
      }
    }
    __syncthreads();
    const int c = chosen;
    if (!(chosen_score > 0.0f)) break;     // nothing live: the rest is -1
    if (tid == 0) ob[i] = c;
    const float cx1 = x1[c], cy1 = y1[c], cx2 = x2[c], cy2 = y2[c];
    const float carea = __fmul_rn(__fsub_rn(cx2, cx1), __fsub_rn(cy2, cy1));
    for (int j = tid; j < K; j += kThreads) {
      const float iw = relu_keep_nan(
          __fsub_rn(fminf(cx2, x2[j]), fmaxf(cx1, x1[j])));
      const float ih = relu_keep_nan(
          __fsub_rn(fminf(cy2, y2[j]), fmaxf(cy1, y1[j])));
      const float inter = __fmul_rn(iw, ih);
      const float area = __fmul_rn(__fsub_rn(x2[j], x1[j]),
                                   __fsub_rn(y2[j], y1[j]));
      const float iou = __fdiv_rn(inter, __fsub_rn(__fadd_rn(carea, area), inter));
      if (iou > iou_thres || j == c) live[j] = 0.0f;
    }
    __syncthreads();
  }
  for (int k = i + tid; k < max_det; k += kThreads) ob[k] = -1;
}

}  // namespace
}  // namespace yolo

// boxes (B, K, 4) f32, scores (B, K) f32, out_idx (B, max_det) int32.
extern "C" int yolo_nms_select(const void* boxes, const void* scores,
                               void* out_idx, int B, int K, int max_det,
                               float iou_thres, void* stream) {
  const size_t smem = (size_t)5 * K * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        yolo::nms_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
  }
  yolo::nms_kernel<<<B, yolo::kThreads, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(boxes), static_cast<const float*>(scores),
      static_cast<int*>(out_idx), K, max_det, iou_thres);
  return cudaGetLastError();
}
