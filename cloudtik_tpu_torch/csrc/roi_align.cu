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
// 0.250 ms at 3.35 TB/s.  The map stays in the 50 MB L2, but every output
// reads 4 taps per sample from it: in bf16 that is twice the bytes written,
// from L2 and L1.
//
// What the design does about it.  Both routes give a block one ROI and a
// run of channels, whose outputs are one contiguous run of nc * P * P floats
// in [R, C, P, P]; the block computes the ROI's P * s sample taps per axis
// once, into shared memory (an IEEE division each), stages its outputs in
// shared memory and writes the run out in order.
//
// The vector route (`roi_align_vec_kernel`), for the detect path's map: bf16
// with channel stride 1 (an NHWC map permuted to [B, C, H, W]), C a multiple
// of 8, 16-byte-aligned base and pixels.  A thread takes 8 consecutive
// channels of a tap as one 16-byte load, so 4 loads make 8 outputs of a
// sample; a warp covers 32 channels at 8 output positions, 64 contiguous
// bytes of each tap's pixel.  The tap table holds 32-bit element offsets
// (tap * pixel-row stride, tap * pixel stride) and weights.  The stage is
// the block's output run itself, skewed by one float every 32 (element e at
// e + e / 32) so that neither the staging writes (8 channels apart) nor the
// read-back (4 consecutive floats a thread) pile onto one bank; the run then
// leaves as streaming 16-byte stores (`__stcs`), so the 822 MB of output does
// not push the map out of L2.  No division or modulo per element.
//
// The strided route (`roi_align_strided_kernel`), for every other layout
// (f32, NCHW, a channel count not a multiple of 8, an unaligned base or
// pixel stride): one thread per output element, threads laid over 32
// channels, scalar loads through 64-bit strides.
//
// The wrapper (ops/detection.py `roi_align_route`) picks the route from
// dtype, shape, strides and alignment; this entry checks the vector route's
// conditions again.  Measured on an H100 SXM ("NVIDIA H100 80GB HBM3,
// 700.00 W") at Mask R-CNN's shapes: the vector route 0.12 ms (7 x 7) and
// 0.33 ms (14 x 14), 54% and 77% of the bound (2.5 TB/s written at 14 x 14);
// the strided route takes 0.39 and 1.31 ms on the same map.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChanBlock = 32;  // strided route: channels per block
constexpr int kVecChan = 64;    // vector route: channels per block
constexpr int kVecPos = 32;     // vector route: output positions per pass

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Sample coordinate along one axis, clipped: its two taps (indices, or
// element offsets in the vector route's table) and the weight of `hi`.
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

// The ROI's geometry along both axes, as the plain version rounds it.
struct Roi {
  float sx, sy, bin_w, bin_h;
};

__device__ __forceinline__ Roi roi_geometry(const float* r, int P,
                                            float scale) {
  const float x1 = r[0], y1 = r[1], x2 = r[2], y2 = r[3];
  const float w = fmaxf(__fmul_rn(__fsub_rn(x2, x1), scale), 1.0f);
  const float h = fmaxf(__fmul_rn(__fsub_rn(y2, y1), scale), 1.0f);
  Roi g;
  g.bin_w = __fdiv_rn(w, (float)P);
  g.bin_h = __fdiv_rn(h, (float)P);
  g.sx = __fmul_rn(x1, scale);
  g.sy = __fmul_rn(y1, scale);
  return g;
}

// ---------------------------------------------------------- vector route --

// 8 bf16 (one 16-byte load) to f32, exactly.
__device__ __forceinline__ void bf16x8(const uint4& u, float (&f)[8]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    f[2 * j] = __uint_as_float(w[j] << 16);
    f[2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
  }
}

__device__ __forceinline__ int skew(int e) { return e + (e >> 5); }

// Stage floats of a block: its output run plus the skew.
__host__ __device__ constexpr int vec_stage_floats(int PP) {
  return kVecChan * PP + (kVecChan * PP >> 5) + 1;
}

__global__ void __launch_bounds__(kThreads)
roi_align_vec_kernel(const __nv_bfloat16* __restrict__ features,
                     const float* __restrict__ rois, float* __restrict__ out,
                     int R, int C, int H, int W, long long fs_b, int fs_h,
                     int fs_w, int P, int sampling, float scale) {
  extern __shared__ float smem[];
  const int roi = blockIdx.x;  // over all images' ROIs
  const int b = roi / R;
  const int c0 = blockIdx.y * kVecChan;
  const int nc = min(kVecChan, C - c0);  // a multiple of 8
  const int PP = P * P;
  const int S = P * sampling;  // samples per axis
  float* stage = smem;         // the block's output run, skewed
  Tap* ytaps = reinterpret_cast<Tap*>(stage + vec_stage_floats(PP));
  Tap* xtaps = ytaps + S;

  const Roi g = roi_geometry(rois + (long long)roi * 4, P, scale);
  const float inv = 1.0f / (float)(sampling * sampling);
  for (int i = threadIdx.x; i < S; i += kThreads) {
    Tap ty = axis_tap(g.sy, g.bin_h, sampling, i, H);
    Tap tx = axis_tap(g.sx, g.bin_w, sampling, i, W);
    ty.lo *= fs_h;
    ty.hi *= fs_h;
    tx.lo *= fs_w;
    tx.hi *= fs_w;
    ytaps[i] = ty;
    xtaps[i] = tx;
  }
  __syncthreads();

  // Warp w, lane l: channels [8 cg, 8 cg + 8) with cg = l % 4 + 4 (w % 2),
  // output positions slot + 32 n with slot = l / 4 + 8 (w / 2).
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int cg = (lane & 3) + 4 * (warp & 1);
  const int slot = (lane >> 2) + 8 * (warp >> 1);
  if (8 * cg < nc) {
    const __nv_bfloat16* f = features + b * fs_b + c0 + 8 * cg;
    int py = slot / P;  // carried by increments below
    int px = slot - py * P;
    const int step_y = kVecPos / P;
    const int step_x = kVecPos - step_y * P;
    for (int pos = slot; pos < PP; pos += kVecPos) {
      float acc[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[i] = 0.0f;
      for (int iy = 0; iy < sampling; ++iy) {
        const Tap ty = ytaps[py * sampling + iy];
        const float wy1 = ty.w_hi, wy0 = 1.0f - ty.w_hi;
        for (int ix = 0; ix < sampling; ++ix) {
          const Tap tx = xtaps[px * sampling + ix];
          const float wx1 = tx.w_hi, wx0 = 1.0f - tx.w_hi;
          float v00[8], v01[8], v10[8], v11[8];
          bf16x8(__ldg(reinterpret_cast<const uint4*>(f + ty.lo + tx.lo)),
                 v00);
          bf16x8(__ldg(reinterpret_cast<const uint4*>(f + ty.lo + tx.hi)),
                 v01);
          bf16x8(__ldg(reinterpret_cast<const uint4*>(f + ty.hi + tx.lo)),
                 v10);
          bf16x8(__ldg(reinterpret_cast<const uint4*>(f + ty.hi + tx.hi)),
                 v11);
          const float w00 = wy0 * wx0, w01 = wy0 * wx1;
          const float w10 = wy1 * wx0, w11 = wy1 * wx1;
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            acc[i] += v00[i] * w00 + v01[i] * w01 + v10[i] * w10 +
                      v11[i] * w11;
          }
        }
      }
      // element (channel 8 cg + i, pos) of the run is (8 cg + i) PP + pos
      int e = 8 * cg * PP + pos;
#pragma unroll
      for (int i = 0; i < 8; ++i, e += PP) stage[skew(e)] = acc[i] * inv;
      py += step_y;
      px += step_x;
      if (px >= P) {
        px -= P;
        ++py;
      }
    }
  }
  __syncthreads();

  // The run, nc * PP floats (a multiple of 8), leaves as 16-byte streaming
  // stores; a float4's four elements share one skew (4 | 32).
  float4* o = reinterpret_cast<float4*>(out + ((long long)roi * C + c0) * PP);
  const int n4 = nc * PP / 4;
  for (int v = threadIdx.x; v < n4; v += kThreads) {
    const float* s4 = stage + skew(4 * v);
    __stcs(o + v, make_float4(s4[0], s4[1], s4[2], s4[3]));
  }
}

// --------------------------------------------------------- strided route --

template <typename T>
__global__ void __launch_bounds__(kThreads)
roi_align_strided_kernel(const T* __restrict__ features,
                         const float* __restrict__ rois,
                         float* __restrict__ out, int R, int C, int H, int W,
                         long long fs_b, long long fs_c, long long fs_h,
                         long long fs_w, int P, int sampling, float scale) {
  extern __shared__ float smem[];
  const int roi = blockIdx.x;       // over all images' ROIs
  const int b = roi / R;
  const int c0 = blockIdx.y * kChanBlock;
  const int nc = min(kChanBlock, C - c0);
  const int PP = P * P;
  const int ld = PP + 1;
  const int S = P * sampling;       // samples per axis
  float* stage = smem;              // [kChanBlock][ld]
  Tap* ytaps = reinterpret_cast<Tap*>(stage + kChanBlock * ld);  // [S]
  Tap* xtaps = ytaps + S;                                         // [S]

  const Roi g = roi_geometry(rois + (long long)roi * 4, P, scale);
  const float inv = 1.0f / (float)(sampling * sampling);
  for (int i = threadIdx.x; i < S; i += kThreads) {
    ytaps[i] = axis_tap(g.sy, g.bin_h, sampling, i, H);
    xtaps[i] = axis_tap(g.sx, g.bin_w, sampling, i, W);
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

constexpr int kSmemMax = 227 * 1024;

int strided_smem(int P, int sampling) {
  return kChanBlock * (P * P + 1) * 4 + 2 * P * sampling * (int)sizeof(Tap);
}

int vec_smem(int P, int sampling) {
  return vec_stage_floats(P * P) * 4 + 2 * P * sampling * (int)sizeof(Tap);
}

// The vector route's conditions: bf16, channel stride 1, C a multiple of 8,
// 16-byte-aligned base and strides (in elements, multiples of 8), and every
// element offset within an image in 32 bits.
bool vec_ok(int dtype, const void* features, int C, int H, int W,
            const long long* fs) {
  if (dtype != 1 || fs[1] != 1 || C % 8 != 0) return false;
  if (reinterpret_cast<uintptr_t>(features) % 16 != 0) return false;
  if (fs[0] % 8 != 0 || fs[2] % 8 != 0 || fs[3] % 8 != 0) return false;
  if (fs[2] < 0 || fs[3] < 0) return false;
  return (long long)(H - 1) * fs[2] + (long long)(W - 1) * fs[3] + C <=
         INT_MAX;
}

template <typename T>
cudaError_t launch_strided(const void* features, const float* rois,
                           float* out, int B, int C, int H, int W,
                           const long long* fs, int R, int P, int sampling,
                           float scale, cudaStream_t stream) {
  auto kernel = roi_align_strided_kernel<T>;
  const int smem = strided_smem(P, sampling);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * R, (C + kChanBlock - 1) / kChanBlock);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(features), rois, out, R, C, H, W, fs[0], fs[1],
      fs[2], fs[3], P, sampling, scale);
  return cudaGetLastError();
}

cudaError_t launch_vec(const void* features, const float* rois, float* out,
                       int B, int C, int H, int W, const long long* fs, int R,
                       int P, int sampling, float scale,
                       cudaStream_t stream) {
  const int smem = vec_smem(P, sampling);
  cudaError_t err = cudaFuncSetAttribute(
      roi_align_vec_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * R, (C + kVecChan - 1) / kVecChan);
  roi_align_vec_kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(features), rois, out, R, C, H, W,
      fs[0], static_cast<int>(fs[2]), static_cast<int>(fs[3]), P, sampling,
      scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16; route: 0 = strided, 1 = vector (see
// the note at the top).  features: [B, C, H, W] with element strides fs[4];
// rois: contiguous [B, R, 4] f32 in input coordinates; out: contiguous
// [B, R, C, P, P] f32.  Returns the cudaError_t of the launch (0 on
// success); cudaErrorInvalidValue for what the chosen route does not take.
int tik_roi_align(int dtype, int route, const void* features,
                  const float* rois, float* out, int B, int C, int H, int W,
                  const long long* fs, int R, int P, int sampling,
                  float scale, void* stream) {
  if (B <= 0 || C <= 0 || H <= 0 || W <= 0 || R <= 0 || P <= 0 ||
      sampling <= 0 || (long long)B * R > INT_MAX ||
      (C + kChanBlock - 1) / kChanBlock > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (route == 1) {
    if (!vec_ok(dtype, features, C, H, W, fs) ||
        vec_smem(P, sampling) > kSmemMax) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    return static_cast<int>(launch_vec(features, rois, out, B, C, H, W, fs,
                                       R, P, sampling, scale, st));
  }
  if (route != 0 || strided_smem(P, sampling) > kSmemMax) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (dtype == 0) {
    return static_cast<int>(launch_strided<float>(
        features, rois, out, B, C, H, W, fs, R, P, sampling, scale, st));
  }
  if (dtype == 1) {
    return static_cast<int>(launch_strided<__nv_bfloat16>(
        features, rois, out, B, C, H, W, fs, R, P, sampling, scale, st));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* tik_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
