// ROIAlign for Hopper (sm_90a): f32 or bf16 features in, f32 out.
//
// Replaces cloudtik_tpu/ops/detection.py::_roi_align_kernel (:203, the
// Pallas kernel behind `roi_align(implementation="pallas")`, pallas_call at
// :264).  It computes what that kernel computes, ROIAlign with
// aligned=False: per ROI (x1, y1, x2, y2) and axis, size = max((x2 - x1) *
// scale, 1), bin = size / P, sample coordinates start + (p * s + j + 0.5) *
// bin / s - 0.5 with start = x1 * scale, clipped to [0, extent - 1]; each
// sample is the bilinear value of its two taps per axis at floor(coord) and
// floor + 1 (clamped to the map, so a coordinate at extent - 1 puts weight 1
// on the last pixel); each output is the mean of its s * s samples, in f32.
// The TPU kernel recast this as Wy @ F @ Wx^T because Mosaic has no cheap
// gather; this kernel is the gather form (`roi_align_reference`).
//
// What bounds it on this card: bytes written.  At Mask R-CNN's shape (8 x 128
// ROIs, 1024 channels of a 32 x 32 bf16 map) the outputs are 205.5 MB (7 x 7)
// and 822.1 MB (14 x 14) of f32 against a 16.8 MB map, about 0.066 ms and
// 0.250 ms at 3.35 TB/s.
// What the design does about it: one block per (ROI, 32-channel chunk).  The
// block computes the ROI's P * s sample taps per axis once, into shared
// memory (an IEEE division each, too dear to repeat per output).  Its
// threads are laid over the 32 channels, so each bilinear tap of a warp reads
// 32 neighbouring channels of an NHWC map (64 contiguous bytes in bf16) and
// the map, 16.8 MB, stays in the 50 MB L2.  The block's outputs, channels
// [c0, c0 + 32) of one ROI, are one contiguous run of 32 * P * P floats in
// [R, C, P, P]: they are staged in shared memory and written out in order, so
// every store of a warp fills whole 128-byte lines.  The features are read
// through their strides, so a [C, H, W] tensor and an NHWC map permuted to
// [B, C, H, W] both go in without a copy.  This first version is simple
// rather than fast: it ran at 5-6x its bound on the card (PERF.md), as each
// output still pays for its own tap reads from shared memory, 64-bit address
// arithmetic and a division of its position by P.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChanBlock = 32;  // channels per block = one warp's width

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Sample coordinate along one axis, clipped, and its two taps and weight.
struct Tap {
  int lo, hi;
  float w_hi;
};

// The coordinate is rounded op by op in the plain version's order (no FMA
// contraction): at a coordinate near 31 one ulp is 1.9e-6, and a bilinear
// weight off by that, across neighbouring values 8 apart, moves an output
// by 1.5e-5, past the 1e-5 the kernel is held to.
__device__ __forceinline__ Tap axis_tap(float start, float bin, int sampling,
                                        int sample, int extent) {
  float c = __fsub_rn(
      __fadd_rn(start, __fdiv_rn(__fmul_rn((float)sample + 0.5f, bin),
                                 (float)sampling)),
      0.5f);
  c = fminf(fmaxf(c, 0.0f), (float)extent - 1.0f);
  int lo = (int)floorf(c);
  lo = min(max(lo, 0), extent - 1);
  Tap t;
  t.lo = lo;
  t.hi = min(lo + 1, extent - 1);
  t.w_hi = c - (float)lo;
  return t;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
roi_align_kernel(const T* __restrict__ features,
                 const float* __restrict__ rois, float* __restrict__ out,
                 int R, int C, int H, int W, long long fs_b, long long fs_c,
                 long long fs_h, long long fs_w, int P, int sampling,
                 float scale) {
  extern __shared__ float smem[];
  const int roi = blockIdx.x;       // over all images' ROIs
  const int b = roi / R;
  const int c0 = blockIdx.y * kChanBlock;
  const int nc = min(kChanBlock, C - c0);
  const int PP = P * P;
  const int ld = PP + 1;            // odd: conflict-free column writes
  const int S = P * sampling;       // samples per axis
  float* stage = smem;              // [kChanBlock][ld]
  Tap* ytaps = reinterpret_cast<Tap*>(stage + kChanBlock * ld);  // [S]
  Tap* xtaps = ytaps + S;                                         // [S]

  const float* r = rois + (long long)roi * 4;
  const float x1 = r[0], y1 = r[1], x2 = r[2], y2 = r[3];
  const float w = fmaxf(__fmul_rn(__fsub_rn(x2, x1), scale), 1.0f);
  const float h = fmaxf(__fmul_rn(__fsub_rn(y2, y1), scale), 1.0f);
  const float bin_w = __fdiv_rn(w, (float)P);
  const float bin_h = __fdiv_rn(h, (float)P);
  const float sx = __fmul_rn(x1, scale);
  const float sy = __fmul_rn(y1, scale);
  const float inv = 1.0f / (float)(sampling * sampling);
  // the ROI's sample taps, once per block rather than once per output
  for (int i = threadIdx.x; i < S; i += kThreads) {
    ytaps[i] = axis_tap(sy, bin_h, sampling, i, H);
    xtaps[i] = axis_tap(sx, bin_w, sampling, i, W);
  }
  __syncthreads();

  const int cl = threadIdx.x % kChanBlock;
  const T* f = features + (long long)b * fs_b + (long long)(c0 + cl) * fs_c;
  if (cl < nc) {
    for (int pos = threadIdx.x / kChanBlock; pos < PP;
         pos += kThreads / kChanBlock) {
      const int py = pos / P, px = pos % P;
      float acc = 0.0f;
      for (int iy = 0; iy < sampling; ++iy) {
        const Tap ty = ytaps[py * sampling + iy];
        const T* row0 = f + (long long)ty.lo * fs_h;
        const T* row1 = f + (long long)ty.hi * fs_h;
        for (int ix = 0; ix < sampling; ++ix) {
          const Tap tx = xtaps[px * sampling + ix];
          const float v00 = to_float(row0[(long long)tx.lo * fs_w]);
          const float v01 = to_float(row0[(long long)tx.hi * fs_w]);
          const float v10 = to_float(row1[(long long)tx.lo * fs_w]);
          const float v11 = to_float(row1[(long long)tx.hi * fs_w]);
          const float wy0 = 1.0f - ty.w_hi, wx0 = 1.0f - tx.w_hi;
          acc += v00 * (wy0 * wx0) + v01 * (wy0 * tx.w_hi) +
                 v10 * (ty.w_hi * wx0) + v11 * (ty.w_hi * tx.w_hi);
        }
      }
      stage[cl * ld + pos] = acc * inv;
    }
  }
  __syncthreads();
  // channels [c0, c0 + nc) of this ROI are one contiguous run of nc * PP
  float* o = out + ((long long)roi * C + c0) * PP;
  for (int i = threadIdx.x; i < nc * PP; i += kThreads) {
    o[i] = stage[(i / PP) * ld + (i % PP)];
  }
}

template <typename T>
cudaError_t launch(const void* features, const float* rois, float* out,
                   int B, int C, int H, int W, const long long* fs, int R,
                   int P, int sampling, float scale, cudaStream_t stream) {
  auto kernel = roi_align_kernel<T>;
  const int smem = kChanBlock * (P * P + 1) * static_cast<int>(sizeof(float)) +
                   2 * P * sampling * static_cast<int>(sizeof(Tap));
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * R, (C + kChanBlock - 1) / kChanBlock);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(features), rois, out, R, C, H, W, fs[0], fs[1],
      fs[2], fs[3], P, sampling, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  features: [B, C, H, W] with element
// strides fs[4] (any layout); rois: contiguous [B, R, 4] f32 in input
// coordinates; out: contiguous [B, R, C, P, P] f32.  Returns the
// cudaError_t of the launch (0 on success).
int tik_roi_align(int dtype, const void* features, const float* rois,
                  float* out, int B, int C, int H, int W,
                  const long long* fs, int R, int P, int sampling,
                  float scale, void* stream) {
  if (B <= 0 || C <= 0 || H <= 0 || W <= 0 || R <= 0 || P <= 0 ||
      sampling <= 0 || (C + kChanBlock - 1) / kChanBlock > 65535 ||
      kChanBlock * (P * P + 1) * 4 + 2 * P * sampling * 12 > 227 * 1024) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return static_cast<int>(launch<float>(features, rois, out, B, C, H, W,
                                          fs, R, P, sampling, scale, st));
  }
  if (dtype == 1) {
    return static_cast<int>(launch<__nv_bfloat16>(
        features, rois, out, B, C, H, W, fs, R, P, sampling, scale, st));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* tik_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
