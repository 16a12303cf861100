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
// and the outputs are written in the inputs' types.  The exponentials are
// exp2 of the scores scaled by sm_scale * log2(e) less lse * log2(e), the
// same function in another base.  GQA: dq reads kv head h / group; the
// dk/dv kernel walks the `group` query heads of its kv head itself, so dk
// and dv come out per kv head, summed in f32, with no atomics
// (deterministic).
//
// What bounds them on this card: at the training path's shape (q
// [8,16,2048,128] bf16, causal, 2,098,176 live (q, kv) pairs per head) the dq
// kernel does three products (6 * pairs * D flops, 206 GFLOP) and the dk/dv
// kernel four (8 * pairs * D, 275 GFLOP) on about 0.34 GB of inputs and
// outputs each: ~600-800 flops per byte, above the H100's ~295 bf16 flops per
// byte, so the tensor cores set the bound (0.21 ms and 0.28 ms at 989
// TFLOP/s).
//
// What the designs do about it: every product is mma.sync m16n8k16 on
// register fragments (flash_common.cuh), the scores, probabilities and their
// gradients never leave the registers, tiles stream through a two-stage
// cp.async ring with one block barrier per tile, only tiles that cross the
// causal diagonal or a ragged end are masked element by element, a warp
// skips the columns wholly past its rows, and blocks take the heaviest
// causal tiles first (tik_flash::tile_order).
//
// The dq kernel: one block of 8 warps for each (128-row q tile, head, batch
// row); warp w owns q rows [16w, 16w + 16).  Q and dO arrive once by
// cp.async and their A fragments stay in registers (2 x 32 registers a
// thread at D = 128) beside the dq accumulator (64); lse (times log2 e) and
// delta of the lane's two rows are registers too.  K/V tiles of 64 rows
// stream through the ring.  Each tile is taken in two halves of 32 columns,
// so s/p and dp/ds take 16 registers each and D = 128 does not spill: s =
// Q K^T and dp = dO V^T with K's and V's B fragments by ldmatrix, then p
// and ds in f32, then ds, rounded to 16 bits, is the A operand of dq += ds K
// with K's B fragments by ldmatrix.trans (as P V in the forward).  dq leaves
// through the warp's own rows of the Q tile as 16-byte stores.
//
// The dk/dv kernel: one block of 8 warps for each (128-row kv tile, kv head,
// batch row); warp w owns kv rows [16w, 16w + 16).  Its dk and dv
// accumulators (2 x 64 registers a thread at D = 128) stay in registers for
// the whole walk; K and V sit in shared memory and give the A fragments of
// s^T = K q^T and dp^T = V do^T.  The (q, do, lse, delta) tiles of 64 q rows
// stream through the ring, each taken in two halves of 32 columns: p^T and
// ds^T, rounded to 16 bits, are the A operands of dv += p^T do and dk +=
// ds^T q, with do and q by ldmatrix.trans.
//
// Measured on an H100 SXM ("NVIDIA H100 80GB HBM3, 700.00 W"), q
// [8,16,2048,128] bf16 causal: dq 0.69 ms, ~297 TFLOP/s, 30% of its bound;
// dk/dv ~1.09 ms, ~252 TFLOP/s, a quarter of its bound.  mma.sync reaches a fraction of Hopper's wgmma rate: wgmma with
// TMA is the next step.
//
// Inputs and outputs are strided (the model hands in [B,S,H,D] transposed to
// [B,H,S,D]); the last dimension must be contiguous and rows 16-byte aligned
// (the Python wrapper checks).  lse and delta are contiguous [B, H, S] f32.
// Rows past S and Skv are zero-filled on load; probabilities past Skv are
// forced to 0 and rows past S are never stored, so S and Skv need not be
// multiples of 64 or 128.

#include <limits.h>

#include "flash_common.cuh"

using tik_flash::align128;
using tik_flash::cp_async_4;
using tik_flash::cp_async_commit;
using tik_flash::cp_async_tile;
using tik_flash::cp_async_wait;
using tik_flash::kLog2e;
using tik_flash::lane_off_a;
using tik_flash::lane_off_b;
using tik_flash::ldmatrix_x4;
using tik_flash::ldmatrix_x4_trans;
using tik_flash::mma_16816;
using tik_flash::pack2;
using tik_flash::pack_a;
using tik_flash::smem_addr;
using tik_flash::tile_order;

namespace {

// ------------------------------------------------------------------ dq --

constexpr int kDqBlockM = 128;  // q rows per block, 16 per warp
constexpr int kDqBlockN = 64;   // kv rows per streamed tile
constexpr int kDqCols = 32;     // kv columns per register step
constexpr int kDqThreads = kDqBlockM / 16 * 32;

// Shared-memory plan of the dq kernel: the block's Q tile (reused at the end
// to stage dq) and dO tile, then two stages of (K tile, V tile).  Rows are
// padded to D + 8 (flash_common.cuh).
template <int D>
struct DqPlan {
  static constexpr int kLd = D + 8;
  static constexpr int kTileKV = kDqBlockN * kLd;  // elements of a K or V tile
  static constexpr size_t kQ = align128(kDqBlockM * kLd * 2);
  static constexpr size_t kKV0 = 2 * kQ;
  static constexpr size_t kBytes = kKV0 + 2 * 2 * kTileKV * 2;
};

// One half (32 kv columns) of a streamed kv tile for this warp's 16 q rows:
// s = Q K^T, dp = dO V^T, p, ds and dq += ds K, all in registers.  `sk`,
// `sv` address the half's first K and V rows; `row0` is the absolute q row
// of this lane's first accumulator row (its second is row0 + 8), `kc0` the
// absolute kv position of the half's first column; entries that are not
// live (kv_pos >= Skv, causal q_pos < kv_pos) get p = 0 only when kMask.
template <typename T, int D, bool kMask>
__device__ __forceinline__ void dq_half(
    const uint32_t (&qf)[D / 16][4], const uint32_t (&dof)[D / 16][4],
    float (&dq_acc)[D / 8][4], uint32_t sk, uint32_t sv, uint32_t off_a,
    uint32_t off_b, const float (&lse2)[2], const float (&delta)[2],
    float sm_scale, float scale_log2, int row0, int kc0, int Skv,
    int causal) {
  constexpr int kLd = DqPlan<D>::kLd;
  const int lane = threadIdx.x % 32;

  float s[kDqCols / 8][4];
  float dp[kDqCols / 8][4];
#pragma unroll
  for (int nt = 0; nt < kDqCols / 8; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[nt][e] = 0.f;
      dp[nt][e] = 0.f;
    }
  }
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
    for (int np = 0; np < kDqCols / 16; ++np) {
      const uint32_t off = (np * 16 * kLd + kk * 16) * 2 + off_b;
      uint32_t b[4];
      ldmatrix_x4(b, sk + off);
      mma_16816<T>(s[2 * np], qf[kk], b[0], b[1]);
      mma_16816<T>(s[2 * np + 1], qf[kk], b[2], b[3]);
      ldmatrix_x4(b, sv + off);
      mma_16816<T>(dp[2 * np], dof[kk], b[0], b[1]);
      mma_16816<T>(dp[2 * np + 1], dof[kk], b[2], b[3]);
    }
  }

  // p = exp2(s * scale * log2e - lse * log2e); ds = p (dp - delta) scale
#pragma unroll
  for (int nt = 0; nt < kDqCols / 8; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float p = exp2f(s[nt][e] * scale_log2 - lse2[e >> 1]);
      if (kMask) {
        const int col = kc0 + nt * 8 + 2 * (lane & 3) + (e & 1);
        const int row = row0 + (e >> 1) * 8;
        if (col >= Skv || (causal && row < col)) p = 0.f;
      }
      dp[nt][e] = p * (dp[nt][e] - delta[e >> 1]) * sm_scale;
    }
  }

  // dq += ds . K: ds rounded to k's type as the A operand, K's B fragments
  // by ldmatrix.trans.
#pragma unroll
  for (int kk = 0; kk < kDqCols / 16; ++kk) {
    uint32_t a[4];
    pack_a<T>(a, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
    for (int dd = 0; dd < D / 16; ++dd) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, sk + (kk * 16 * kLd + dd * 16) * 2 + off_a);
      mma_16816<T>(dq_acc[2 * dd], a, b[0], b[1]);
      mma_16816<T>(dq_acc[2 * dd + 1], a, b[2], b[3]);
    }
  }
}

// dq for one (128-row q tile, head, batch row); replaces `_dq_kernel`.
template <typename T, int D>
__global__ void __launch_bounds__(kDqThreads, 1)
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
  using P = DqPlan<D>;
  constexpr int kLd = P::kLd;
  extern __shared__ __align__(128) unsigned char smem[];
  T* sq = reinterpret_cast<T*>(smem);
  T* sdo = reinterpret_cast<T*>(smem + P::kQ);
  T* skv = reinterpret_cast<T*>(smem + P::kKV0);
  const uint32_t skv_u = smem_addr(skv);

  const int n_qt = (S + kDqBlockM - 1) / kDqBlockM;
  int head, rank;
  tile_order(blockIdx.x, gridDim.x / n_qt, n_qt, head, rank);
  const int q0 = (n_qt - 1 - rank) * kDqBlockM;  // the last q tile is heaviest
  const int b = head / H;
  const int h = head % H;
  const int hk = h / group;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int wq0 = q0 + warp * 16;  // this warp's first q row
  const uint32_t off_a = lane_off_a<kLd>(lane);
  const uint32_t off_b = lane_off_b<kLd>(lane);

  const T* kb = k + b * ksb + hk * ksh;
  const T* vb = v + b * vsb + hk * vsh;

  // The causal loop stops at the TPU kernel's live-block test
  // j*bk <= (last q row of this tile); a warp computes up to its own last
  // row's tile and skips the rest.
  int n_tiles = (Skv + kDqBlockN - 1) / kDqBlockN;
  int warp_tiles = n_tiles;
  if (causal) {
    n_tiles = min(n_tiles, min(q0 + kDqBlockM - 1, S - 1) / kDqBlockN + 1);
    warp_tiles = min(n_tiles, min(wq0 + 15, S - 1) / kDqBlockN + 1);
  }
  if (wq0 >= S) warp_tiles = 0;

  cp_async_tile<T, D, kDqBlockM, kDqThreads, kLd>(sq, q + b * qsb + h * qsh,
                                                 qss, q0, S);
  cp_async_tile<T, D, kDqBlockM, kDqThreads, kLd>(
      sdo, dout + b * dsb + h * dsh, dss, q0, S);
  cp_async_tile<T, D, kDqBlockN, kDqThreads, kLd>(skv, kb, kss, 0, Skv);
  cp_async_tile<T, D, kDqBlockN, kDqThreads, kLd>(skv + P::kTileKV, vb, vss,
                                                 0, Skv);
  cp_async_commit();

  // lse (times log2 e) and delta of this lane's two rows; 0 past S, where
  // Q and dO are zero, so ds is 0 there (and never stored).
  const int row0 = wq0 + lane / 4;
  const long long stat0 = ((long long)b * H + h) * S;
  float lse2[2], dlt[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = row0 + 8 * i;
    lse2[i] = r < S ? lse[stat0 + r] * kLog2e : 0.f;
    dlt[i] = r < S ? delta[stat0 + r] : 0.f;
  }

  uint32_t qf[D / 16][4];
  uint32_t dof[D / 16][4];
  float dq_acc[D / 8][4];
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dq_acc[nt][e] = 0.f;
  }
  const float scale_log2 = sm_scale * kLog2e;

  for (int j = 0; j < n_tiles; ++j) {
    // Tile j has landed for this thread; the barrier makes every thread's
    // part visible and tells that every warp is done with tile j - 1, whose
    // stage the next copy overwrites.
    cp_async_wait<0>();
    __syncthreads();
    if (j + 1 < n_tiles) {
      T* nxt = skv + ((j + 1) & 1) * 2 * P::kTileKV;
      const int k1 = (j + 1) * kDqBlockN;
      cp_async_tile<T, D, kDqBlockN, kDqThreads, kLd>(nxt, kb, kss, k1, Skv);
      cp_async_tile<T, D, kDqBlockN, kDqThreads, kLd>(nxt + P::kTileKV, vb,
                                                     vss, k1, Skv);
      cp_async_commit();
    }
    if (j == 0) {
      const uint32_t sqw = smem_addr(sq + warp * 16 * kLd) + off_a;
      const uint32_t sdow = smem_addr(sdo + warp * 16 * kLd) + off_a;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        ldmatrix_x4(qf[kk], sqw + kk * 16 * 2);
        ldmatrix_x4(dof[kk], sdow + kk * 16 * 2);
      }
    }
    if (j < warp_tiles) {
      const uint32_t sk = skv_u + (j & 1) * 2 * P::kTileKV * 2;
      const uint32_t sv = sk + P::kTileKV * 2;
#pragma unroll
      for (int half = 0; half < kDqBlockN / kDqCols; ++half) {
        const int kc0 = j * kDqBlockN + half * kDqCols;
        // every kv of this half after every q row of the warp: all masked
        if (causal && kc0 > wq0 + 15) continue;
        const bool masked =
            kc0 + kDqCols > Skv || (causal && kc0 + kDqCols - 1 > wq0);
        const uint32_t hk_u = sk + half * kDqCols * kLd * 2;
        const uint32_t hv_u = sv + half * kDqCols * kLd * 2;
        if (masked) {
          dq_half<T, D, true>(qf, dof, dq_acc, hk_u, hv_u, off_a, off_b,
                              lse2, dlt, sm_scale, scale_log2, row0, kc0,
                              Skv, causal);
        } else {
          dq_half<T, D, false>(qf, dof, dq_acc, hk_u, hv_u, off_a, off_b,
                               lse2, dlt, sm_scale, scale_log2, row0, kc0,
                               Skv, causal);
        }
      }
    }
  }

  // dq goes through this warp's own 16 rows of the Q tile (only it read
  // them, and every copy has landed), so the strided rows leave as 16-byte
  // stores.
  const int g = lane / 4;
  const int c = lane % 4;
  T* sw = sq + warp * 16 * kLd;
  __syncwarp();
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt) {
    *reinterpret_cast<uint32_t*>(sw + g * kLd + nt * 8 + 2 * c) =
        pack2<T>(dq_acc[nt][0], dq_acc[nt][1]);
    *reinterpret_cast<uint32_t*>(sw + (g + 8) * kLd + nt * 8 + 2 * c) =
        pack2<T>(dq_acc[nt][2], dq_acc[nt][3]);
  }
  __syncwarp();
  T* dqb = dq + b * dqsb + h * dqsh;
  constexpr int kPerRow = D / 8;
#pragma unroll
  for (int it = 0; it < 16 * kPerRow / 32; ++it) {
    const int i = lane + it * 32;
    const int r = i / kPerRow;
    const int cc = (i % kPerRow) * 8;
    if (wq0 + r < S) {
      *reinterpret_cast<uint4*>(dqb + (long long)(wq0 + r) * dqss + cc) =
          *reinterpret_cast<const uint4*>(sw + r * kLd + cc);
    }
  }
}

// ------------------------------------------------------------ dk / dv --

constexpr int kDkvBlockN = 128;  // kv rows per block, 16 per warp
constexpr int kDkvBlockM = 64;   // q rows per streamed tile
constexpr int kDkvCols = 32;     // q columns per register step
constexpr int kDkvThreads = kDkvBlockN / 16 * 32;

// Shared-memory plan of the dk/dv kernel: the block's K and V tiles (reused
// at the end to stage dk and dv), then two stages of (Q, dO, lse, delta).
// Rows are padded to D + 8 (flash_common.cuh).
template <int D>
struct DkvPlan {
  static constexpr int kLd = D + 8;
  static constexpr size_t kKV = align128(kDkvBlockN * kLd * 2);
  static constexpr size_t kIn = align128(kDkvBlockM * kLd * 2);
  static constexpr size_t kStat = align128(kDkvBlockM * 4);
  static constexpr size_t kStage0 = 2 * kKV;
  static constexpr size_t kStage = 2 * kIn + 2 * kStat;  // Q, dO, lse, delta
  static constexpr size_t kBytes = kStage0 + 2 * kStage;
};

// Products against 32 q columns [col0, col0 + 32) of a staged tile for this
// warp's 16 kv rows: acc = X_w . Y^T, X_w the warp's rows of K or V (A
// fragments), Y the staged Q or dO rows (B fragments, no transpose).
template <typename T, int D>
__device__ __forceinline__ void dot_rows(float (&acc)[kDkvCols / 8][4],
                                         uint32_t xw, uint32_t y,
                                         uint32_t off_a, uint32_t off_b) {
  constexpr int kLd = DkvPlan<D>::kLd;
#pragma unroll
  for (int nt = 0; nt < kDkvCols / 8; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
  }
  // Unrolled by 2, not fully: with the whole loop unrolled ptxas hoists
  // every ldmatrix of the product and, beside the 128 registers of dk and
  // dv, spills at the 255-register cap (D = 128).
#pragma unroll 2
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t a[4];
    ldmatrix_x4(a, xw + kk * 16 * 2 + off_a);
#pragma unroll
    for (int np = 0; np < kDkvCols / 16; ++np) {
      uint32_t b[4];
      ldmatrix_x4(b, y + (np * 16 * kLd + kk * 16) * 2 + off_b);
      mma_16816<T>(acc[2 * np], a, b[0], b[1]);
      mma_16816<T>(acc[2 * np + 1], a, b[2], b[3]);
    }
  }
}

// acc += A . Y: A the 16 x 32 register tile `x` (rounded to 16 bits as it
// is packed), Y 32 staged rows [col0, col0 + 32) by ldmatrix.trans.
template <typename T, int D>
__device__ __forceinline__ void acc_rows(float (&acc)[D / 8][4],
                                         const float (&x)[kDkvCols / 8][4],
                                         uint32_t y, uint32_t off_a) {
  constexpr int kLd = DkvPlan<D>::kLd;
#pragma unroll
  for (int kk = 0; kk < kDkvCols / 16; ++kk) {
    uint32_t a[4];
    pack_a<T>(a, x[2 * kk], x[2 * kk + 1]);
#pragma unroll
    for (int dp = 0; dp < D / 16; ++dp) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, y + (kk * 16 * kLd + dp * 16) * 2 + off_a);
      mma_16816<T>(acc[2 * dp], a, b[0], b[1]);
      mma_16816<T>(acc[2 * dp + 1], a, b[2], b[3]);
    }
  }
}

// One half (32 q columns) of a streamed q tile for this warp's 16 kv rows,
// on the transposed problem: p^T, dv += p^T . do, dp^T, ds^T, dk += ds^T . q,
// all in registers.  `kv0` is this lane's first kv row (the second is
// kv0 + 8), `qc0` the absolute q position of column col0; entries that are
// not live (q_pos >= S, kv_pos >= Skv, causal q_pos < kv_pos) get p = 0 only
// when kMask.
template <typename T, int D, bool kMask>
__device__ __forceinline__ void dkv_half(
    float (&dk_acc)[D / 8][4], float (&dv_acc)[D / 8][4], uint32_t kw,
    uint32_t vw, uint32_t sq, uint32_t sdo, const float* slse,
    const float* sdelta, uint32_t off_a, uint32_t off_b, float sm_scale,
    float scale_log2, int kv0, int qc0, int S, int Skv, int causal) {
  const int lane = threadIdx.x % 32;
  const int c2 = 2 * (lane & 3);

  // p^T = exp(s^T * scale - lse[q]) in f32
  float p[kDkvCols / 8][4];
  dot_rows<T, D>(p, kw, sq, off_a, off_b);
#pragma unroll
  for (int nt = 0; nt < kDkvCols / 8; ++nt) {
    const float2 l2 = *reinterpret_cast<const float2*>(slse + nt * 8 + c2);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float l = (e & 1) ? l2.y : l2.x;
      float x = exp2f(p[nt][e] * scale_log2 - l * kLog2e);
      if (kMask) {
        const int q_pos = qc0 + nt * 8 + c2 + (e & 1);
        const int kv_pos = kv0 + (e >> 1) * 8;
        if (q_pos >= S || kv_pos >= Skv || (causal && q_pos < kv_pos)) {
          x = 0.f;
        }
      }
      p[nt][e] = x;
    }
  }
  // dv += p^T . do, p rounded to do's type
  acc_rows<T, D>(dv_acc, p, sdo, off_a);

  // ds^T = p^T (do . v^T - delta[q])^T * scale, ds rounded to q's type
  float ds[kDkvCols / 8][4];
  dot_rows<T, D>(ds, vw, sdo, off_a, off_b);
#pragma unroll
  for (int nt = 0; nt < kDkvCols / 8; ++nt) {
    const float2 d2 = *reinterpret_cast<const float2*>(sdelta + nt * 8 + c2);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float delta = (e & 1) ? d2.y : d2.x;
      ds[nt][e] = p[nt][e] * (ds[nt][e] - delta) * sm_scale;
    }
  }
  acc_rows<T, D>(dk_acc, ds, sq, off_a);
}

// Start the copies of streamed step t: (Q, dO) rows of q tile
// i0 + t % per_head of head hk * group + t / per_head, and its lse and delta.
template <typename T, int D>
__device__ __forceinline__ void dkv_load_step(
    unsigned char* stage, const T* q, const T* dout, const float* lse,
    const float* delta, int t, int per_head, int i0, int b, int hk, int H,
    int group, int S, long long qsb, long long qsh, long long qss,
    long long dsb, long long dsh, long long dss) {
  using P = DkvPlan<D>;
  const int h = hk * group + t / per_head;
  const int qt0 = (i0 + t % per_head) * kDkvBlockM;
  cp_async_tile<T, D, kDkvBlockM, kDkvThreads, P::kLd>(
      reinterpret_cast<T*>(stage), q + b * qsb + h * qsh, qss, qt0, S);
  cp_async_tile<T, D, kDkvBlockM, kDkvThreads, P::kLd>(
      reinterpret_cast<T*>(stage + P::kIn), dout + b * dsb + h * dsh, dss,
      qt0, S);
  const int i = threadIdx.x % kDkvBlockM;
  if (threadIdx.x < 2 * kDkvBlockM) {
    const bool is_lse = threadIdx.x < kDkvBlockM;
    const float* src = (is_lse ? lse : delta) + ((long long)b * H + h) * S;
    float* dst = reinterpret_cast<float*>(stage + 2 * P::kIn +
                                          (is_lse ? 0 : P::kStat));
    const bool valid = qt0 + i < S;
    cp_async_4(smem_addr(dst + i), src + (valid ? qt0 + i : 0), valid);
  }
}

// dk and dv for one (128-row kv tile, kv head, batch row); replaces
// `_dkv_kernel`.  Works on the transposed problem: rows are kv positions,
// columns query positions.  Warp w owns kv rows [16w, 16w + 16): its dk and
// dv accumulators stay in registers for the whole walk over the group's
// (head, q tile) steps, which stream through a two-stage cp.async ring.
template <typename T, int D>
__global__ void __launch_bounds__(kDkvThreads, 1)
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
  using P = DkvPlan<D>;
  constexpr int kLd = P::kLd;
  extern __shared__ __align__(128) unsigned char smem[];
  T* sk = reinterpret_cast<T*>(smem);
  T* sv = reinterpret_cast<T*>(smem + P::kKV);

  const int n_kt = (Skv + kDkvBlockN - 1) / kDkvBlockN;
  int head, rank;
  tile_order(blockIdx.x, gridDim.x / n_kt, n_kt, head, rank);
  const int Hkv = H / group;
  const int k0 = rank * kDkvBlockN;  // the first kv tile is heaviest
  const int b = head / Hkv;
  const int hk = head % Hkv;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int wk0 = k0 + warp * 16;  // this warp's first kv row
  const uint32_t off_a = lane_off_a<kLd>(lane);
  const uint32_t off_b = lane_off_b<kLd>(lane);
  const uint32_t kw = smem_addr(sk + warp * 16 * kLd);
  const uint32_t vw = smem_addr(sv + warp * 16 * kLd);

  // q tile i is live iff i*bq + bq - 1 >= k0 (the TPU kernel's test).
  const int nq = (S + kDkvBlockM - 1) / kDkvBlockM;
  const int i0 = causal ? min(k0 / kDkvBlockM, nq) : 0;
  const int per_head = nq - i0;
  const int n_steps = group * per_head;

  cp_async_tile<T, D, kDkvBlockN, kDkvThreads, kLd>(
      sk, k + b * ksb + hk * ksh, kss, k0, Skv);
  cp_async_tile<T, D, kDkvBlockN, kDkvThreads, kLd>(
      sv, v + b * vsb + hk * vsh, vss, k0, Skv);
  if (n_steps > 0) {
    dkv_load_step<T, D>(smem + P::kStage0, q, dout, lse, delta, 0, per_head,
                        i0, b, hk, H, group, S, qsb, qsh, qss, dsb, dsh, dss);
  }
  cp_async_commit();

  float dk_acc[D / 8][4];
  float dv_acc[D / 8][4];
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      dk_acc[nt][e] = 0.f;
      dv_acc[nt][e] = 0.f;
    }
  }
  const float scale_log2 = sm_scale * kLog2e;
  const int kv0 = wk0 + lane / 4;

  for (int t = 0; t < n_steps; ++t) {
    // Step t has landed for this thread; the barrier makes every thread's
    // part visible and tells that every warp is done with step t - 1, whose
    // stage the next copy overwrites.
    cp_async_wait<0>();
    __syncthreads();
    if (t + 1 < n_steps) {
      dkv_load_step<T, D>(smem + P::kStage0 + ((t + 1) & 1) * P::kStage, q,
                          dout, lse, delta, t + 1, per_head, i0, b, hk, H,
                          group, S, qsb, qsh, qss, dsb, dsh, dss);
      cp_async_commit();
    }
    unsigned char* stage = smem + P::kStage0 + (t & 1) * P::kStage;
    const uint32_t sq = smem_addr(stage);
    const uint32_t sdo = smem_addr(stage + P::kIn);
    const float* slse = reinterpret_cast<const float*>(stage + 2 * P::kIn);
    const float* sdelta = slse + P::kStat / 4;
    const int qt0 = (i0 + t % per_head) * kDkvBlockM;
#pragma unroll
    for (int half = 0; half < kDkvBlockM / kDkvCols; ++half) {
      const int col0 = half * kDkvCols;
      const int qc0 = qt0 + col0;
      // every q of this half before every kv row of the warp: all masked
      if (causal && qc0 + kDkvCols - 1 < wk0) continue;
      const bool masked = (causal && qc0 < wk0 + 15) ||
                          qc0 + kDkvCols > S || wk0 + 16 > Skv;
      const uint32_t yq = sq + col0 * kLd * 2;
      const uint32_t ydo = sdo + col0 * kLd * 2;
      if (masked) {
        dkv_half<T, D, true>(dk_acc, dv_acc, kw, vw, yq, ydo, slse + col0,
                             sdelta + col0, off_a, off_b, sm_scale,
                             scale_log2, kv0, qc0, S, Skv, causal);
      } else {
        dkv_half<T, D, false>(dk_acc, dv_acc, kw, vw, yq, ydo, slse + col0,
                              sdelta + col0, off_a, off_b, sm_scale,
                              scale_log2, kv0, qc0, S, Skv, causal);
      }
    }
  }

  // dk and dv go through this warp's own 16 rows of the K and V tiles (only
  // it read them), so the strided rows leave as 16-byte stores.  With no
  // live step the K/V copies may still be in flight: wait for them first.
  cp_async_wait<0>();
  __syncthreads();
  const int g = lane / 4;
  const int c = lane % 4;
  T* skw = sk + warp * 16 * kLd;
  T* svw = sv + warp * 16 * kLd;
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt) {
    const int col = nt * 8 + 2 * c;
    *reinterpret_cast<uint32_t*>(skw + g * kLd + col) =
        pack2<T>(dk_acc[nt][0], dk_acc[nt][1]);
    *reinterpret_cast<uint32_t*>(skw + (g + 8) * kLd + col) =
        pack2<T>(dk_acc[nt][2], dk_acc[nt][3]);
    *reinterpret_cast<uint32_t*>(svw + g * kLd + col) =
        pack2<T>(dv_acc[nt][0], dv_acc[nt][1]);
    *reinterpret_cast<uint32_t*>(svw + (g + 8) * kLd + col) =
        pack2<T>(dv_acc[nt][2], dv_acc[nt][3]);
  }
  __syncwarp();
  T* dkb = dk + b * dksb + hk * dksh;
  T* dvb = dv + b * dvsb + hk * dvsh;
  constexpr int kPerRow = D / 8;
#pragma unroll
  for (int it = 0; it < 16 * kPerRow / 32; ++it) {
    const int i = lane + it * 32;
    const int r = i / kPerRow;
    const int cc = (i % kPerRow) * 8;
    if (wk0 + r < Skv) {
      *reinterpret_cast<uint4*>(dkb + (long long)(wk0 + r) * dkss + cc) =
          *reinterpret_cast<const uint4*>(skw + r * kLd + cc);
      *reinterpret_cast<uint4*>(dvb + (long long)(wk0 + r) * dvss + cc) =
          *reinterpret_cast<const uint4*>(svw + r * kLd + cc);
    }
  }
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
  const int smem = static_cast<int>(DqPlan<D>::kBytes);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const long long blocks =
      (long long)((S + kDqBlockM - 1) / kDqBlockM) * H * B;
  if (blocks > INT_MAX) return cudaErrorInvalidConfiguration;
  kernel<<<static_cast<unsigned>(blocks), kDqThreads, smem, stream>>>(
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
  const int smem = static_cast<int>(DkvPlan<D>::kBytes);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const long long blocks =
      (long long)((Skv + kDkvBlockN - 1) / kDkvBlockN) * Hkv * B;
  if (blocks > INT_MAX) return cudaErrorInvalidConfiguration;
  kernel<<<static_cast<unsigned>(blocks), kDkvThreads, smem, stream>>>(
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
