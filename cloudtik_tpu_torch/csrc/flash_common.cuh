// Helpers shared by the flash-attention kernels (flash_fwd.cu,
// flash_bwd.cu): 16-bit conversions and the strided tile load.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tik_flash {

constexpr int kTileRows = 64;  // rows of every q / kv tile
constexpr int kThreads = 128;  // 4 warps per block

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(
    float x) {
  return __float2bfloat16(x);
}
template <> __device__ __forceinline__ __half from_float<__half>(float x) {
  return __float2half(x);
}

constexpr size_t align128(size_t n) { return (n + 127) / 128 * 128; }

// Copy rows [row0, row0 + 64) of a strided [rows, D] slab into a shared tile
// with leading dimension LD, 16 bytes per thread per step; rows at or past
// `nrows` are zero so that masked entries multiply finite values.
template <typename T, int D, int LD>
__device__ __forceinline__ void load_tile(T* dst, const T* src,
                                          long long row_stride, int row0,
                                          int nrows) {
  constexpr int kVec = 8;  // 8 x 16-bit = 16 bytes
  constexpr int kPerRow = D / kVec;
  for (int i = threadIdx.x; i < kTileRows * kPerRow; i += kThreads) {
    const int r = i / kPerRow;
    const int c = (i % kPerRow) * kVec;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < nrows) {
      val = *reinterpret_cast<const uint4*>(src + (long long)(row0 + r) *
                                                      row_stride + c);
    }
    *reinterpret_cast<uint4*>(dst + r * LD + c) = val;
  }
}

}  // namespace tik_flash
