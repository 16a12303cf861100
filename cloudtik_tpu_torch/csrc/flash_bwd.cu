// Flash-attention backward for Hopper (sm_90a): dq, and dk/dv, bf16 / fp16 in,
// f32 statistics.
//
// Replaces the two Pallas kernels behind cloudtik_tpu/ops/flash_attention.py
// `_bwd`: `_dq_kernel` (flash_bwd_dq_kernel) and `_dkv_kernel`
// (flash_bwd_dkv_kernel).  Both recompute the probabilities from the saved
// statistics instead of storing them, exactly as those kernels do:
//   s = (q . k^T) * sm_scale in f32; entries with q_pos < kv_pos (absolute
//   positions, causal) are masked; p = exp(s - lse);
//   dp = do . v^T in f32; ds = p * (dp - delta) * sm_scale, with
//   delta = rowsum(do * o) computed outside the kernels as XLA does;
//   dq = sum_j ds . k        (ds cast to k's type, f32 accumulate)
//   dv = sum_i p^T . do      (p cast to do's type)
//   dk = sum_i ds^T . q      (ds cast to q's type)
// and the outputs are written in the inputs' types.  GQA: the dk/dv kernel
// walks the `group` query heads of its kv head itself, so dk and dv come out
// per kv head, summed in f32, with no atomics (deterministic).
//
// What bounds them on this card: at the training path's shape (q
// [8,16,2048,128] bf16, causal, 2,098,176 live (q, kv) pairs per head) the dq
// kernel does three products (6 * pairs * D flops, 206 GFLOP) and the dk/dv
// kernel four (8 * pairs * D, 275 GFLOP) on about 0.34 GB of inputs and
// outputs each: ~600-800 flops per byte, above the H100's ~295 bf16 flops per
// byte, so the tensor cores set the bound (0.21 ms and 0.28 ms at 989
// TFLOP/s).
// What the design does about it: every product runs on the tensor cores
// (nvcuda::wmma 16x16x16, f32 accumulate); the dq, dk and dv accumulators stay
// in registers as wmma fragments for the whole loop (no rescaling is needed in
// the backward pass, unlike the forward); each block reads its own q (or k/v)
// tile once and streams the other side's tiles; dead causal tiles are skipped
// as the TPU kernels skip them.  The f32 dp tile is staged 16 columns at a
// time, so a block needs ~109 KB of shared memory at D = 128 and two blocks
// fit on an SM.  This first version is simple rather than fast: no wgmma, no
// TMA, no double buffering, and the probabilities make a round trip through
// shared memory.
//
// One block of 4 warps for each (64-row q tile, head, batch row) in the dq
// kernel and each (64-row kv tile, kv head, batch row) in the dk/dv kernel.
// Warp w owns rows [16w, 16w + 16) of its block's own tile: its scores,
// probabilities, ds rows and accumulators are touched by no other warp, so
// only the shared streamed tiles need block-wide barriers.  Inputs and outputs
// are strided (the model hands in [B,S,H,D] transposed to [B,H,S,D]); the
// last dimension must be contiguous and rows 16-byte aligned (the Python
// wrapper checks).  lse and delta are contiguous [B, H, S] f32.  Rows past S
// and Skv are zero-filled on load and their probabilities forced to 0 (lse is
// undefined there), so S and Skv need not be multiples of 64.

#include <mma.h>

#include "flash_common.cuh"

using namespace nvcuda;
using tik_flash::align128;
using tik_flash::from_float;

namespace {

constexpr int kBlock = tik_flash::kTileRows;  // rows of every q / kv tile
constexpr int kThreads = tik_flash::kThreads;
constexpr int kWarps = kThreads / 32;

template <typename T>
using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major>;
template <typename T>
using FragBCol = wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::col_major>;
template <typename T>
using FragBRow = wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::row_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

// Shared-memory plan, one for both kernels.  Leading dimensions are padded so
// that wmma's 16-row fragment loads spread over the banks; every segment and
// fragment pointer stays 32-byte aligned as wmma requires.
template <int D>
struct Plan {
  static constexpr int kLdT = D + 8;        // [64, D] input tiles (16-bit)
  static constexpr int kLdS = kBlock + 4;   // [64, 64] scores -> p (f32)
  static constexpr int kLdP = kBlock + 8;   // [64, 64] p and ds (16-bit)
  static constexpr int kLdG = 16 + 4;       // per-warp 16x16 staging (f32)
  static constexpr size_t kTile = align128(kBlock * kLdT * 2);
  static constexpr size_t kS = 4 * kTile;   // after four input tiles
  static constexpr size_t kP = kS + align128(kBlock * kLdS * 4);
  static constexpr size_t kDS = kP + align128(kBlock * kLdP * 2);
  static constexpr size_t kG = kDS + align128(kBlock * kLdP * 2);
  static constexpr size_t kLse = kG + align128(kWarps * 16 * kLdG * 4);
  static constexpr size_t kDelta = kLse + align128(kBlock * 4);
  static constexpr size_t kBytes = kDelta + align128(kBlock * 4);
};

template <typename T, int D>
__device__ __forceinline__ void load_tile(T* dst, const T* src,
                                          long long row_stride, int row0,
                                          int nrows) {
  tik_flash::load_tile<T, D, Plan<D>::kLdT>(dst, src, row_stride, row0,
                                            nrows);
}

// lse and delta of rows [row0, row0 + 64); 0 past S (those rows' p is
// forced to 0, so the value is never used).
__device__ __forceinline__ void load_stats(float* slse, float* sdelta,
                                           const float* lse,
                                           const float* delta, int row0,
                                           int S) {
  if (threadIdx.x < kBlock) {
    const int r = row0 + threadIdx.x;
    slse[threadIdx.x] = r < S ? lse[r] : 0.f;
    sdelta[threadIdx.x] = r < S ? delta[r] : 0.f;
  }
}

// c = a[16, D] . b[16, D]^T, both row blocks of padded [64, D] tiles.
template <typename T, int D>
__device__ __forceinline__ void dot_nt(FragC& c, const T* a, const T* b) {
  wmma::fill_fragment(c, 0.f);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    FragA<T> fa;
    FragBCol<T> fb;
    wmma::load_matrix_sync(fa, a + kk * 16, Plan<D>::kLdT);
    wmma::load_matrix_sync(fb, b + kk * 16, Plan<D>::kLdT);
    wmma::mma_sync(c, fa, fb, c);
  }
}

// acc[n] += a[16, 64] . b[64, D] (columns [16n, 16n + 16)); a is a row block
// of a [64, 64] 16-bit tile (p or ds), b a padded [64, D] input tile.
template <typename T, int D>
__device__ __forceinline__ void acc_nn(FragC (&acc)[D / 16], const T* a,
                                       const T* b) {
#pragma unroll
  for (int kk = 0; kk < kBlock / 16; ++kk) {
    FragA<T> fa;
    wmma::load_matrix_sync(fa, a + kk * 16, Plan<D>::kLdP);
#pragma unroll
    for (int n = 0; n < D / 16; ++n) {
      FragBRow<T> fb;
      wmma::load_matrix_sync(fb, b + kk * 16 * Plan<D>::kLdT + n * 16,
                             Plan<D>::kLdT);
      wmma::mma_sync(acc[n], fa, fb, acc[n]);
    }
  }
}

// The warp's rows of ds = p * (dp - delta) * sm_scale, dp = a . b^T staged
// 16 columns at a time.  p: the warp's rows of the f32 [64, 64] tile;
// delta_by_row picks delta by row (dq: rows are queries) or by column (dk/dv:
// columns are queries).
template <typename T, int D>
__device__ __forceinline__ void make_ds(T* sds, const float* sp,
                                        const T* a, const T* b, float* stage,
                                        const float* sdelta,
                                        bool delta_by_row, int r0,
                                        float sm_scale) {
  using P = Plan<D>;
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int n = 0; n < kBlock / 16; ++n) {
    FragC dp;
    dot_nt<T, D>(dp, a, b + n * 16 * P::kLdT);
    wmma::store_matrix_sync(stage, dp, P::kLdG, wmma::mem_row_major);
    __syncwarp();
    for (int e = lane; e < 256; e += 32) {
      const int row = r0 + e / 16;
      const int col = n * 16 + e % 16;
      const float delta = sdelta[delta_by_row ? row : col];
      const float p = sp[row * P::kLdS + col];
      sds[row * P::kLdP + col] =
          from_float<T>(p * (stage[(e / 16) * P::kLdG + e % 16] - delta) *
                        sm_scale);
    }
    __syncwarp();
  }
}

// Write this warp's 16 accumulator rows (absolute rows row0 .. row0 + 15,
// those below nrows) to a strided output, through its 16x16 staging tile.
template <typename T, int D>
__device__ __forceinline__ void store_rows(T* out, long long row_stride,
                                           int row0, int nrows,
                                           FragC (&acc)[D / 16],
                                           float* stage) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int n = 0; n < D / 16; ++n) {
    wmma::store_matrix_sync(stage, acc[n], Plan<D>::kLdG,
                            wmma::mem_row_major);
    __syncwarp();
    for (int e = lane; e < 256; e += 32) {
      const int r = e / 16;
      const int c = e % 16;
      if (row0 + r < nrows) {
        out[(long long)(row0 + r) * row_stride + n * 16 + c] =
            from_float<T>(stage[r * Plan<D>::kLdG + c]);
      }
    }
    __syncwarp();
  }
}

// dq for one (64-row q tile, head, batch row); replaces `_dq_kernel`.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int H, int group, int S, int Skv,
                    long long qsb, long long qsh, long long qss,
                    long long ksb, long long ksh, long long kss,
                    long long vsb, long long vsh, long long vss,
                    long long dsb, long long dsh, long long dss,
                    long long dqsb, long long dqsh, long long dqss,
                    float sm_scale, int causal) {
  using P = Plan<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* sq = reinterpret_cast<T*>(smem);
  T* sdo = reinterpret_cast<T*>(smem + P::kTile);
  T* sk = reinterpret_cast<T*>(smem + 2 * P::kTile);
  T* sv = reinterpret_cast<T*>(smem + 3 * P::kTile);
  float* sp = reinterpret_cast<float*>(smem + P::kS);
  T* sds = reinterpret_cast<T*>(smem + P::kDS);
  float* slse = reinterpret_cast<float*>(smem + P::kLse);
  float* sdelta = reinterpret_cast<float*>(smem + P::kDelta);

  const int q0 = blockIdx.x * kBlock;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / group;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int r0 = warp * 16;
  float* stage = reinterpret_cast<float*>(smem + P::kG) + warp * 16 * P::kLdG;

  const T* kb = k + b * ksb + hk * ksh;
  const T* vb = v + b * vsb + hk * vsh;
  const long long stat0 = ((long long)b * H + h) * S;
  load_tile<T, D>(sq, q + b * qsb + h * qsh, qss, q0, S);
  load_tile<T, D>(sdo, dout + b * dsb + h * dsh, dss, q0, S);
  load_stats(slse, sdelta, lse + stat0, delta + stat0, q0, S);

  FragC acc[D / 16];
#pragma unroll
  for (int n = 0; n < D / 16; ++n) wmma::fill_fragment(acc[n], 0.f);

  // The causal loop stops at the TPU kernel's live-block test
  // j*bk <= (last q row of this tile).
  int n_tiles = (Skv + kBlock - 1) / kBlock;
  if (causal) {
    const int q_last = min(q0 + kBlock - 1, S - 1);
    n_tiles = min(n_tiles, q_last / kBlock + 1);
  }

  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * kBlock;
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile<T, D>(sk, kb, kss, k0, Skv);
    load_tile<T, D>(sv, vb, vss, k0, Skv);
    __syncthreads();

    // p = exp(s - lse) for this warp's 16 q rows x 64 kv columns.
#pragma unroll
    for (int n = 0; n < kBlock / 16; ++n) {
      FragC s;
      dot_nt<T, D>(s, sq + r0 * P::kLdT, sk + n * 16 * P::kLdT);
      wmma::store_matrix_sync(sp + r0 * P::kLdS + n * 16, s, P::kLdS,
                              wmma::mem_row_major);
    }
    __syncwarp();
    for (int r = 0; r < 16; ++r) {
      const int row = r0 + r;
      const int q_pos = q0 + row;
      for (int c = lane; c < kBlock; c += 32) {
        const int kv_pos = k0 + c;
        const bool live = q_pos < S && kv_pos < Skv &&
                          (!causal || q_pos >= kv_pos);
        float* s = sp + row * P::kLdS + c;
        *s = live ? expf(*s * sm_scale - slse[row]) : 0.f;
      }
    }
    __syncwarp();

    // ds = p (do . v^T - delta) scale, then dq += ds . k.
    make_ds<T, D>(sds, sp, sdo + r0 * P::kLdT, sv, stage, sdelta, true, r0,
                  sm_scale);
    acc_nn<T, D>(acc, sds + r0 * P::kLdP, sk);
  }

  store_rows<T, D>(dq + b * dqsb + h * dqsh, dqss, q0 + r0, S, acc, stage);
}

// dk and dv for one (64-row kv tile, kv head, batch row); replaces
// `_dkv_kernel`.  Works on the transposed problem: rows are kv positions,
// columns query positions.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, int H, int group, int S, int Skv,
                     long long qsb, long long qsh, long long qss,
                     long long ksb, long long ksh, long long kss,
                     long long vsb, long long vsh, long long vss,
                     long long dsb, long long dsh, long long dss,
                     long long dksb, long long dksh, long long dkss,
                     long long dvsb, long long dvsh, long long dvss,
                     float sm_scale, int causal) {
  using P = Plan<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* sk = reinterpret_cast<T*>(smem);
  T* sv = reinterpret_cast<T*>(smem + P::kTile);
  T* sq = reinterpret_cast<T*>(smem + 2 * P::kTile);
  T* sdo = reinterpret_cast<T*>(smem + 3 * P::kTile);
  float* sp = reinterpret_cast<float*>(smem + P::kS);
  T* spt = reinterpret_cast<T*>(smem + P::kP);
  T* sds = reinterpret_cast<T*>(smem + P::kDS);
  float* slse = reinterpret_cast<float*>(smem + P::kLse);
  float* sdelta = reinterpret_cast<float*>(smem + P::kDelta);

  const int k0 = blockIdx.x * kBlock;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int r0 = warp * 16;
  float* stage = reinterpret_cast<float*>(smem + P::kG) + warp * 16 * P::kLdG;

  load_tile<T, D>(sk, k + b * ksb + hk * ksh, kss, k0, Skv);
  load_tile<T, D>(sv, v + b * vsb + hk * vsh, vss, k0, Skv);

  FragC dk_acc[D / 16];
  FragC dv_acc[D / 16];
#pragma unroll
  for (int n = 0; n < D / 16; ++n) {
    wmma::fill_fragment(dk_acc[n], 0.f);
    wmma::fill_fragment(dv_acc[n], 0.f);
  }

  // q tile i is live iff i*bq + bq - 1 >= k0 (the TPU kernel's test).
  const int nq = (S + kBlock - 1) / kBlock;
  const int i0 = causal ? k0 / kBlock : 0;
  for (int g = 0; g < group; ++g) {
    const int h = hk * group + g;
    const long long stat0 = ((long long)b * H + h) * S;
    const T* qb = q + b * qsb + h * qsh;
    const T* dob = dout + b * dsb + h * dsh;
    for (int i = i0; i < nq; ++i) {
      const int qt0 = i * kBlock;
      __syncthreads();  // every warp is done with the previous Q/dO tile
      load_tile<T, D>(sq, qb, qss, qt0, S);
      load_tile<T, D>(sdo, dob, dss, qt0, S);
      load_stats(slse, sdelta, lse + stat0, delta + stat0, qt0, S);
      __syncthreads();

      // p^T = exp(s^T - lse) for this warp's 16 kv rows x 64 q columns, in
      // f32 (for ds) and in the input type (for dv).
#pragma unroll
      for (int n = 0; n < kBlock / 16; ++n) {
        FragC s;
        dot_nt<T, D>(s, sk + r0 * P::kLdT, sq + n * 16 * P::kLdT);
        wmma::store_matrix_sync(sp + r0 * P::kLdS + n * 16, s, P::kLdS,
                                wmma::mem_row_major);
      }
      __syncwarp();
      for (int r = 0; r < 16; ++r) {
        const int row = r0 + r;
        const int kv_pos = k0 + row;
        for (int c = lane; c < kBlock; c += 32) {
          const int q_pos = qt0 + c;
          const bool live = q_pos < S && kv_pos < Skv &&
                            (!causal || q_pos >= kv_pos);
          float* s = sp + row * P::kLdS + c;
          const float p = live ? expf(*s * sm_scale - slse[c]) : 0.f;
          *s = p;
          spt[row * P::kLdP + c] = from_float<T>(p);
        }
      }
      __syncwarp();

      // ds^T = p^T (v . do^T - delta) scale; dv += p^T . do; dk += ds^T . q.
      make_ds<T, D>(sds, sp, sv + r0 * P::kLdT, sdo, stage, sdelta, false,
                    r0, sm_scale);
      acc_nn<T, D>(dv_acc, spt + r0 * P::kLdP, sdo);
      acc_nn<T, D>(dk_acc, sds + r0 * P::kLdP, sq);
    }
  }

  store_rows<T, D>(dk + b * dksb + hk * dksh, dkss, k0 + r0, Skv, dk_acc,
                   stage);
  store_rows<T, D>(dv + b * dvsb + hk * dvsh, dvss, k0 + r0, Skv, dv_acc,
                   stage);
}

template <typename T, int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const float* lse, const float* delta,
                      void* dq, int B, int H, int Hkv, int S, int Skv,
                      const long long* qs, const long long* ks,
                      const long long* vs, const long long* ds,
                      const long long* dqs, float sm_scale, int causal,
                      cudaStream_t stream) {
  auto kernel = flash_bwd_dq_kernel<T, D>;
  const int smem = static_cast<int>(Plan<D>::kBytes);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kBlock - 1) / kBlock, H, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dq), H, H / Hkv, S, Skv, qs[0], qs[1], qs[2], ks[0],
      ks[1], ks[2], vs[0], vs[1], vs[2], ds[0], ds[1], ds[2], dqs[0], dqs[1],
      dqs[2], sm_scale, causal);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const float* lse,
                       const float* delta, void* dk, void* dv, int B, int H,
                       int Hkv, int S, int Skv, const long long* qs,
                       const long long* ks, const long long* vs,
                       const long long* ds, const long long* dks,
                       const long long* dvs, float sm_scale, int causal,
                       cudaStream_t stream) {
  auto kernel = flash_bwd_dkv_kernel<T, D>;
  const int smem = static_cast<int>(Plan<D>::kBytes);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Skv + kBlock - 1) / kBlock, Hkv, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dk), static_cast<T*>(dv), H, H / Hkv, S, Skv, qs[0],
      qs[1], qs[2], ks[0], ks[1], ks[2], vs[0], vs[1], vs[2], ds[0], ds[1],
      ds[2], dks[0], dks[1], dks[2], dvs[0], dvs[1], dvs[2], sm_scale,
      causal);
  return cudaGetLastError();
}

bool bad_shape(int B, int H, int Hkv, int S, int Skv) {
  return B <= 0 || H <= 0 || Hkv <= 0 || H % Hkv != 0 || S <= 0 || Skv <= 0;
}

}  // namespace

extern "C" {

// dtype: 0 = bfloat16, 1 = float16.  Strides are in elements, for the batch,
// head and sequence dimensions of [B, H, S, D] tensors (the head dimension D
// is contiguous).  lse and delta are contiguous [B, H, S] f32 buffers.  Each
// returns the cudaError_t of its launch (0 on success).
int tik_flash_bwd_dq(int dtype, int head_dim, const void* q, const void* k,
                     const void* v, const void* dout, const float* lse,
                     const float* delta, void* dq, int B, int H, int Hkv,
                     int S, int Skv, const long long* q_strides,
                     const long long* k_strides, const long long* v_strides,
                     const long long* do_strides,
                     const long long* dq_strides, float sm_scale, int causal,
                     void* stream) {
  if (bad_shape(B, H, Hkv, S, Skv)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define TIK_DQ_CASE(T, DIM)                                                  \
  return static_cast<int>(launch_dq<T, DIM>(                                 \
      q, k, v, dout, lse, delta, dq, B, H, Hkv, S, Skv, q_strides, k_strides, \
      v_strides, do_strides, dq_strides, sm_scale, causal, st))
  if (dtype == 0 && head_dim == 64) TIK_DQ_CASE(__nv_bfloat16, 64);
  if (dtype == 0 && head_dim == 128) TIK_DQ_CASE(__nv_bfloat16, 128);
  if (dtype == 1 && head_dim == 64) TIK_DQ_CASE(__half, 64);
  if (dtype == 1 && head_dim == 128) TIK_DQ_CASE(__half, 128);
#undef TIK_DQ_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

int tik_flash_bwd_dkv(int dtype, int head_dim, const void* q, const void* k,
                      const void* v, const void* dout, const float* lse,
                      const float* delta, void* dk, void* dv, int B, int H,
                      int Hkv, int S, int Skv, const long long* q_strides,
                      const long long* k_strides, const long long* v_strides,
                      const long long* do_strides,
                      const long long* dk_strides,
                      const long long* dv_strides, float sm_scale,
                      int causal, void* stream) {
  if (bad_shape(B, H, Hkv, S, Skv)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define TIK_DKV_CASE(T, DIM)                                                 \
  return static_cast<int>(launch_dkv<T, DIM>(                                \
      q, k, v, dout, lse, delta, dk, dv, B, H, Hkv, S, Skv, q_strides,        \
      k_strides, v_strides, do_strides, dk_strides, dv_strides, sm_scale,     \
      causal, st))
  if (dtype == 0 && head_dim == 64) TIK_DKV_CASE(__nv_bfloat16, 64);
  if (dtype == 0 && head_dim == 128) TIK_DKV_CASE(__nv_bfloat16, 128);
  if (dtype == 1 && head_dim == 64) TIK_DKV_CASE(__half, 64);
  if (dtype == 1 && head_dim == 128) TIK_DKV_CASE(__half, 128);
#undef TIK_DKV_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* tik_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
