// Flash-attention forward for Hopper (sm_90a), bf16 / fp16 in, f32 statistics.
//
// Replaces cloudtik_tpu/ops/flash_attention.py::_fwd_kernel (the Pallas
// kernel behind `_fwd`).  It computes what that kernel computes:
//   s = (q . k^T) * sm_scale in f32; causal entries with q_pos < kv_pos
//   (absolute positions) set to -1e30; online softmax with running max m and
//   normaliser l; p = exp(s - m) cast to v's type before the P.V product;
//   o = acc / l and lse = m + log(l), with l == 0 guarded to 1; o in q's type,
//   lse [B, H, S, 1] in f32.  GQA reads kv head h / (H / Hkv), with no
//   repeated K/V.
//
// What bounds it on this card: at the main path's shape (q [B,16,2048,128]
// bf16, causal) one batch row does 17.2 GFLOP on 33.5 MB of q/k/v/o, about
// 510 flops per byte, above the H100's ~295 bf16 flops/byte ridge, so the
// tensor cores set the bound (~17 us per batch row at 989 TFLOP/s against
// ~10 us of bytes at 3.35 TB/s).
// What the design does about it: both products run on the tensor cores
// (nvcuda::wmma 16x16x16, f32 accumulate); each Q tile is read once and each
// K/V tile once per 64 query rows, and m, l and the output accumulator stay
// in shared memory for the whole kv loop, so HBM sees each input about once
// per q tile and each output once.  This first version is simple rather than
// fast: no wgmma, no TMA, no double buffering of the K/V tiles, and the
// accumulator makes a round trip through shared memory on each tile.
//
// One CTA of 4 warps for each (64-row q tile, head, batch row).  Warp w owns
// q rows [16w, 16w + 16) of the tile: its scores, probabilities, statistics
// and accumulator rows are touched by no other warp, so only the shared K/V
// tiles need block-wide barriers.  Inputs are strided (the model hands in
// [B,S,H,D] transposed to [B,H,S,D]); the last dimension must be contiguous
// and rows 16-byte aligned (the Python wrapper checks).  Rows past S and Skv
// are zero-filled on load and masked, so S and Skv need not be multiples of 64.

#include <mma.h>

#include "flash_common.cuh"

using namespace nvcuda;
using tik_flash::align128;
using tik_flash::from_float;

namespace {

constexpr int kBlockQ = tik_flash::kTileRows;  // q rows per CTA
constexpr int kBlockK = tik_flash::kTileRows;  // kv rows per inner tile
constexpr int kThreads = tik_flash::kThreads;
constexpr float kNegInf = -1e30f;  // the TPU kernel's _NEG_INF

// Shared-memory plan.  Leading dimensions are padded so that the 16-row
// fragment loads of wmma do not all land on one bank; every segment and
// every fragment pointer stays 32-byte aligned as wmma requires.
template <int D>
struct Plan {
  static constexpr int kLdT = D + 8;         // Q, K, V tiles (16-bit)
  static constexpr int kLdS = kBlockK + 4;   // scores (f32)
  static constexpr int kLdP = kBlockK + 8;   // probabilities (16-bit)
  static constexpr int kLdO = D + 4;         // output accumulator (f32)
  static constexpr size_t kQ = 0;
  static constexpr size_t kK = kQ + align128(kBlockQ * kLdT * 2);
  static constexpr size_t kV = kK + align128(kBlockK * kLdT * 2);
  static constexpr size_t kS = kV + align128(kBlockK * kLdT * 2);
  static constexpr size_t kP = kS + align128(kBlockQ * kLdS * 4);
  static constexpr size_t kO = kP + align128(kBlockQ * kLdP * 2);
  static constexpr size_t kM = kO + align128(kBlockQ * kLdO * 4);
  static constexpr size_t kL = kM + align128(kBlockQ * 4);
  static constexpr size_t kBytes = kL + align128(kBlockQ * 4);
};

template <typename T, int D>
__device__ __forceinline__ void load_tile(T* dst, const T* src,
                                          long long row_stride, int row0,
                                          int nrows) {
  tik_flash::load_tile<T, D, Plan<D>::kLdT>(dst, src, row_stride, row0,
                                            nrows);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int H, int group, int S, int Skv,
                 long long qsb, long long qsh, long long qss,
                 long long ksb, long long ksh, long long kss,
                 long long vsb, long long vsh, long long vss,
                 long long osb, long long osh, long long oss,
                 float sm_scale, int causal) {
  using P = Plan<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* sq = reinterpret_cast<T*>(smem + P::kQ);
  T* sk = reinterpret_cast<T*>(smem + P::kK);
  T* sv = reinterpret_cast<T*>(smem + P::kV);
  float* ss = reinterpret_cast<float*>(smem + P::kS);
  T* sp = reinterpret_cast<T*>(smem + P::kP);
  float* so = reinterpret_cast<float*>(smem + P::kO);
  float* sm = reinterpret_cast<float*>(smem + P::kM);
  float* sl = reinterpret_cast<float*>(smem + P::kL);

  const int q0 = blockIdx.x * kBlockQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / group;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int r0 = warp * 16;

  const T* qb = q + b * qsb + h * qsh;
  const T* kb = k + b * ksb + hk * ksh;
  const T* vb = v + b * vsb + hk * vsh;

  load_tile<T, D>(sq, qb, qss, q0, S);
  for (int i = threadIdx.x; i < kBlockQ * D; i += kThreads) {
    so[(i / D) * P::kLdO + i % D] = 0.f;
  }
  if (threadIdx.x < kBlockQ) {
    sm[threadIdx.x] = kNegInf;
    sl[threadIdx.x] = 0.f;
  }

  // The causal loop stops at the TPU kernel's live-block test
  // j*bk <= (last q row of this tile).
  int n_tiles = (Skv + kBlockK - 1) / kBlockK;
  if (causal) {
    const int q_last = min(q0 + kBlockQ - 1, S - 1);
    n_tiles = min(n_tiles, q_last / kBlockK + 1);
  }

  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * kBlockK;
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile<T, D>(sk, kb, kss, k0, Skv);
    load_tile<T, D>(sv, vb, vss, k0, Skv);
    __syncthreads();

    // Scores for this warp's 16 rows: S = Q K^T, f32 accumulate.
#pragma unroll
    for (int n = 0; n < kBlockK / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::col_major> fb;
        wmma::load_matrix_sync(fa, sq + r0 * P::kLdT + kk * 16, P::kLdT);
        wmma::load_matrix_sync(fb, sk + n * 16 * P::kLdT + kk * 16, P::kLdT);
        wmma::mma_sync(acc, fa, fb, acc);
      }
      wmma::store_matrix_sync(ss + r0 * P::kLdS + n * 16, acc, P::kLdS,
                              wmma::mem_row_major);
    }
    __syncwarp();

    // Online softmax, one row at a time; lane owns columns lane, lane + 32.
    for (int r = 0; r < 16; ++r) {
      const int row = r0 + r;
      const int q_pos = q0 + row;
      const int c0 = k0 + lane;
      const int c1 = k0 + lane + 32;
      float s0 = ss[row * P::kLdS + lane] * sm_scale;
      float s1 = ss[row * P::kLdS + lane + 32] * sm_scale;
      if (c0 >= Skv || (causal && q_pos < c0)) s0 = kNegInf;
      if (c1 >= Skv || (causal && q_pos < c1)) s1 = kNegInf;
      float m_cur = fmaxf(s0, s1);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        m_cur = fmaxf(m_cur, __shfl_xor_sync(0xffffffffu, m_cur, off));
      }
      const float m_prev = sm[row];
      const float m_new = fmaxf(m_prev, m_cur);
      const float alpha = expf(m_prev - m_new);
      const float p0 = expf(s0 - m_new);
      const float p1 = expf(s1 - m_new);
      float p_sum = p0 + p1;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        p_sum += __shfl_xor_sync(0xffffffffu, p_sum, off);
      }
      sp[row * P::kLdP + lane] = from_float<T>(p0);
      sp[row * P::kLdP + lane + 32] = from_float<T>(p1);
      for (int d = lane; d < D; d += 32) so[row * P::kLdO + d] *= alpha;
      __syncwarp();  // every lane has read sm[row] before it changes
      if (lane == 0) {
        sm[row] = m_new;
        sl[row] = sl[row] * alpha + p_sum;
      }
    }
    __syncwarp();

    // acc += P V for this warp's 16 rows.
#pragma unroll
    for (int n = 0; n < D / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::load_matrix_sync(acc, so + r0 * P::kLdO + n * 16, P::kLdO,
                             wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < kBlockK / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::row_major> fb;
        wmma::load_matrix_sync(fa, sp + r0 * P::kLdP + kk * 16, P::kLdP);
        wmma::load_matrix_sync(fb, sv + kk * 16 * P::kLdT + n * 16, P::kLdT);
        wmma::mma_sync(acc, fa, fb, acc);
      }
      wmma::store_matrix_sync(so + r0 * P::kLdO + n * 16, acc, P::kLdO,
                              wmma::mem_row_major);
    }
    __syncwarp();
  }

  // Finalize this warp's rows: o = acc / l, lse = m + log(l), l == 0 -> 1.
  for (int r = 0; r < 16; ++r) {
    const int row = r0 + r;
    const int q_pos = q0 + row;
    if (q_pos >= S) break;
    const float l = sl[row];
    const float l_safe = (l == 0.f) ? 1.f : l;
    T* orow = o + b * osb + h * osh + (long long)q_pos * oss;
    for (int d = lane; d < D; d += 32) {
      orow[d] = from_float<T>(so[row * P::kLdO + d] / l_safe);
    }
    if (lane == 0) {
      lse[((long long)b * H + h) * S + q_pos] = sm[row] + logf(l_safe);
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, int B, int H, int Hkv, int S, int Skv,
                   const long long* qs, const long long* ks,
                   const long long* vs, const long long* os, float sm_scale,
                   int causal, cudaStream_t stream) {
  auto kernel = flash_fwd_kernel<T, D>;
  const int smem = static_cast<int>(Plan<D>::kBytes);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kBlockQ - 1) / kBlockQ, H, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, H, H / Hkv, S, Skv,
      qs[0], qs[1], qs[2], ks[0], ks[1], ks[2], vs[0], vs[1], vs[2], os[0],
      os[1], os[2], sm_scale, causal);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = bfloat16, 1 = float16.  Strides are in elements, for the
// batch, head and sequence dimensions of [B, H, S, D] tensors (the head
// dimension D is contiguous).  lse is a contiguous [B, H, S] f32 buffer.
// Returns the cudaError_t of the launch (0 on success).
int tik_flash_fwd(int dtype, int head_dim, const void* q, const void* k,
                  const void* v, void* o, float* lse, int B, int H, int Hkv,
                  int S, int Skv, const long long* q_strides,
                  const long long* k_strides, const long long* v_strides,
                  const long long* o_strides, float sm_scale, int causal,
                  void* stream) {
  if (B <= 0 || H <= 0 || Hkv <= 0 || H % Hkv != 0 || S <= 0 || Skv <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define TIK_FLASH_CASE(T, DIM)                                               \
  return static_cast<int>(launch<T, DIM>(q, k, v, o, lse, B, H, Hkv, S, Skv, \
                                         q_strides, k_strides, v_strides,    \
                                         o_strides, sm_scale, causal, st))
  if (dtype == 0 && head_dim == 64) TIK_FLASH_CASE(__nv_bfloat16, 64);
  if (dtype == 0 && head_dim == 128) TIK_FLASH_CASE(__nv_bfloat16, 128);
  if (dtype == 1 && head_dim == 64) TIK_FLASH_CASE(__half, 64);
  if (dtype == 1 && head_dim == 128) TIK_FLASH_CASE(__half, 128);
#undef TIK_FLASH_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* tik_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
