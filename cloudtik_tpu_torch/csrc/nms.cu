// Greedy non-maximum suppression for Hopper (sm_90a), f32 boxes and scores.
//
// Replaces cloudtik_tpu/ops/detection.py::_nms_kernel (:100, the Pallas
// kernel behind `nms`, pallas_call at :115).  It computes what that kernel's
// `_nms_select_rows` computes: up to K times, take the highest live score
// (the lowest index wins ties); stop once it is at or below -5e29 (no box
// left); keep its index; set every live box whose IoU with it is strictly
// above the threshold, and the winner itself, to -1e30.  keep is -1-padded.
//
// Exactness.  The keep list must equal the plain version's, so the IoU is
// computed in the JAX order with round-to-nearest intrinsics, which nvcc
// never contracts into an FMA:
//   area  = (x2 - x1) * (y2 - y1)
//   inter = max(min(bx2, x2) - max(bx1, x1), 0) * max(min(by2, y2)
//           - max(by1, y1), 0)
//   iou   = inter / max((barea + area) - inter, 1e-9)
// and compared with the threshold as an f32 (the wrapper passes f32(thr)).
//
// What bounds it on this card: almost nothing in bytes (20 bytes a box read
// once, 4 bytes a kept index written) and little arithmetic (~16 flops a box
// per kept box); what limits it is the serial chain of K block-wide argmax
// steps, each two barriers and a shared-memory pass over N boxes.
// What the design does about it: one block per image, all images at once
// (grid = B); each image's boxes, areas and live scores sit in shared memory
// for the whole loop (24 bytes a box, 72 KB at N = 3,000), so a step touches
// no device memory; the argmax is a warp-shuffle reduction then one warp
// over the warps' partials; the loop ends at the first step with no valid box.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr float kNegInf = -1e30f;      // the TPU kernel's _NEG_INF
constexpr float kValidAbove = -5e29f;  // _NEG_INF / 2

// (v, i) beats (ov, oi) when larger, or equal with a lower index.
__device__ __forceinline__ void argmax_merge(float& v, int& i, float ov,
                                             int oi) {
  if (ov > v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

__device__ __forceinline__ void warp_argmax(float& v, int& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_down_sync(0xffffffffu, v, off);
    const int oi = __shfl_down_sync(0xffffffffu, i, off);
    argmax_merge(v, i, ov, oi);
  }
}

__global__ void __launch_bounds__(kThreads)
nms_kernel(const float* __restrict__ boxes, const float* __restrict__ scores,
           int* __restrict__ keep, int N, int K, float thr) {
  extern __shared__ float smem[];
  float* x1 = smem;
  float* y1 = x1 + N;
  float* x2 = y1 + N;
  float* y2 = x2 + N;
  float* area = y2 + N;
  float* live = area + N;
  __shared__ float part_v[kWarps];
  __shared__ int part_i[kWarps];
  __shared__ float win_v;
  __shared__ int win_i;

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float* bx = boxes + (long long)b * N * 4;
  const float* sc = scores + (long long)b * N;
  int* out = keep + (long long)b * K;

  for (int j = tid; j < N; j += kThreads) {
    const float a = bx[j * 4 + 0], c = bx[j * 4 + 1];
    const float e = bx[j * 4 + 2], g = bx[j * 4 + 3];
    x1[j] = a;
    y1[j] = c;
    x2[j] = e;
    y2[j] = g;
    area[j] = __fmul_rn(__fsub_rn(e, a), __fsub_rn(g, c));
    live[j] = sc[j];
  }
  for (int k = tid; k < K; k += kThreads) out[k] = -1;
  __syncthreads();

  for (int k = 0; k < K; ++k) {
    // block-wide first argmax of the live scores
    float v = -INFINITY;
    int i = N;
    for (int j = tid; j < N; j += kThreads) argmax_merge(v, i, live[j], j);
    warp_argmax(v, i);
    if (lane == 0) {
      part_v[warp] = v;
      part_i[warp] = i;
    }
    __syncthreads();
    if (warp == 0) {
      v = lane < kWarps ? part_v[lane] : -INFINITY;
      i = lane < kWarps ? part_i[lane] : N;
      warp_argmax(v, i);
      if (lane == 0) {
        win_v = v;
        win_i = i;
      }
    }
    __syncthreads();
    const float m = win_v;
    const int best = win_i;
    if (!(m > kValidAbove)) break;  // the same for every thread
    if (tid == 0) out[k] = best;
    const float bx1 = x1[best], by1 = y1[best];
    const float bx2 = x2[best], by2 = y2[best];
    const float barea = area[best];
    for (int j = tid; j < N; j += kThreads) {
      const float iw =
          fmaxf(__fsub_rn(fminf(bx2, x2[j]), fmaxf(bx1, x1[j])), 0.0f);
      const float ih =
          fmaxf(__fsub_rn(fminf(by2, y2[j]), fmaxf(by1, y1[j])), 0.0f);
      const float inter = __fmul_rn(iw, ih);
      const float uni = __fsub_rn(__fadd_rn(barea, area[j]), inter);
      const float iou = __fdiv_rn(inter, fmaxf(uni, 1e-9f));
      if (iou > thr || j == best) live[j] = kNegInf;
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" {

// boxes: contiguous [B, N, 4] f32 (x1, y1, x2, y2); scores: contiguous
// [B, N] f32; keep: contiguous [B, K] int32.  thr is the IoU threshold as
// an f32.  Returns the cudaError_t of the launch (0 on success).
int tik_nms(const float* boxes, const float* scores, int* keep, int B,
            int N, int K, float thr, void* stream) {
  if (B <= 0 || N < 0 || K <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = static_cast<size_t>(N) * 6 * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      nms_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  nms_kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      boxes, scores, keep, N, K, thr);
  return static_cast<int>(cudaGetLastError());
}

const char* tik_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
