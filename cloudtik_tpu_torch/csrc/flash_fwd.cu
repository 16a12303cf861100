// Flash-attention forward for Hopper (sm_90a), bf16 / fp16 in, f32 statistics.
//
// Replaces cloudtik_tpu/ops/flash_attention.py::_fwd_kernel (the Pallas
// kernel behind `_fwd`).  It computes what that kernel computes:
//   s = (q . k^T) * sm_scale in f32; causal entries with q_pos < kv_pos
//   (absolute positions) set to -1e30; online softmax with running max m and
//   normaliser l, l summed from the f32 p; p = exp(s - m) cast to v's type
//   before the P.V product; o = acc / l and lse = m + log(l), with l == 0
//   guarded to 1; o in q's type, lse [B, H, S, 1] in f32.  GQA reads kv head
//   h / (H / Hkv), with no repeated K/V.  The exponentials are exp2 of the
//   scores scaled by sm_scale * log2(e), the same function in another base.
//
// What bounds it on this card: at the main path's shape (q [B,16,2048,128]
// bf16, causal) one batch row does 17.2 GFLOP on 33.5 MB of q/k/v/o, about
// 510 flops per byte, above the H100's ~295 bf16 flops/byte ridge, so the
// tensor cores set the bound (~17 us per batch row at 989 TFLOP/s against
// ~10 us of bytes at 3.35 TB/s).
// What the design does about it: both products run on the tensor cores
// (mma.sync m16n8k16, f32 accumulate) with every intermediate in registers:
// Q's A fragments are loaded once, the scores, their softmax and the O
// accumulator never leave the registers, and the score accumulators,
// rounded to 16 bits, are the A operand of P.V (flash_common.cuh).  K/V
// tiles arrive through a two-stage cp.async ring, so the copy of tile j+1
// is in flight while tile j computes, with one block barrier per tile.
// Only tiles that cross the causal diagonal or the ragged end of Skv are
// masked element by element; a warp skips the tiles wholly above its rows.
// Blocks take the heaviest causal q tiles first (tik_flash::tile_order).
// Measured on an H100 SXM (700 W): 0.31 ms at q [4,16,2048,128] bf16
// causal, ~220 TFLOP/s, 22% of the bound.  mma.sync, run by each warp on
// its own, reaches a fraction of the rate of Hopper's wgmma, which with TMA
// and warp specialisation is the next step.
//
// One CTA of 8 warps for each (128-row q tile, head, batch row).  Warp w owns
// q rows [16w, 16w + 16) of the tile: 8 warps of 16 rows, not 4 of 32, keep
// the O accumulator at 64 registers a thread at D = 128 (16 x 128 f32 over
// 32 lanes) beside Q's 32 and the scores' 32, so nothing spills, and give
// the SM 8 warps to hide each other's softmax and barrier.  Inputs are
// strided (the model hands in [B,S,H,D] transposed to [B,H,S,D]); the last
// dimension must be contiguous and rows 16-byte aligned (the Python wrapper
// checks).  Rows past S and Skv are zero-filled on load and masked, so S and
// Skv need not be multiples of 64 or 128.

#include <limits.h>

#include "flash_common.cuh"

using namespace tik_flash;

namespace {

constexpr int kBlockM = 128;  // q rows per CTA
constexpr int kBlockN = 64;   // kv rows per tile
constexpr int kWarps = kBlockM / 16;
constexpr int kThreadsFwd = kWarps * 32;

// Shared-memory plan: the Q tile (reused at the end to stage o), then two
// stages of (K tile, V tile).  Rows are padded to D + 8 (flash_common.cuh).
template <int D>
struct Plan {
  static constexpr int kLd = D + 8;
  static constexpr int kTileKV = kBlockN * kLd;  // elements of a K or V tile
  static constexpr size_t kKV = align128(kBlockM * kLd * 2);
  static constexpr size_t kBytes = kKV + 2 * 2 * kTileKV * 2;
};

// One kv tile for this warp's 16 q rows: S = Q K^T, the online softmax and
// O += P V, all in registers.  `row0` is the absolute q row of this lane's
// first accumulator row (its second is row0 + 8); masked entries (kv_pos >=
// Skv, causal q_pos < kv_pos) only when kMask.
template <typename T, int D, bool kMask>
__device__ __forceinline__ void fwd_tile(
    const uint32_t (&qf)[D / 16][4], uint32_t sk, uint32_t sv,
    uint32_t off_a, uint32_t off_b, float (&o_acc)[D / 8][4],
    float (&m_run)[2], float (&l_run)[2], float scale_log2, int row0, int k0,
    int Skv, int causal) {
  constexpr int kLd = Plan<D>::kLd;
  const int lane = threadIdx.x % 32;

  float s[kBlockN / 8][4];
#pragma unroll
  for (int nt = 0; nt < kBlockN / 8; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
  }
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
    for (int np = 0; np < kBlockN / 16; ++np) {
      uint32_t b[4];
      ldmatrix_x4(b, sk + (np * 16 * kLd + kk * 16) * 2 + off_b);
      mma_16816<T>(s[2 * np], qf[kk], b[0], b[1]);
      mma_16816<T>(s[2 * np + 1], qf[kk], b[2], b[3]);
    }
  }

  // Scale into the log2 domain, mask, and take the row max over the quad.
  float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
  for (int nt = 0; nt < kBlockN / 8; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float t = s[nt][e] * scale_log2;
      if (kMask) {
        const int col = k0 + nt * 8 + 2 * (lane & 3) + (e & 1);
        const int row = row0 + (e >> 1) * 8;
        if (col >= Skv || (causal && row < col)) t = kNegInf;
      }
      s[nt][e] = t;
      mx[e >> 1] = fmaxf(mx[e >> 1], t);
    }
  }
  float alpha[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = quad_max(mx[i]);
    alpha[i] = exp2f(m_run[i] - mx[i]);
    m_run[i] = mx[i];
  }
  // p in f32; l gathers this lane's part of each row sum (the quad's parts
  // are added once, at the end).
  float rs[2] = {0.f, 0.f};
#pragma unroll
  for (int nt = 0; nt < kBlockN / 8; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = exp2f(s[nt][e] - mx[e >> 1]);
      s[nt][e] = p;
      rs[e >> 1] += p;
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) l_run[i] = l_run[i] * alpha[i] + rs[i];
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt) {
    o_acc[nt][0] *= alpha[0];
    o_acc[nt][1] *= alpha[0];
    o_acc[nt][2] *= alpha[1];
    o_acc[nt][3] *= alpha[1];
  }

  // O += P V: p rounded to v's type as the A operand, V's B fragments by
  // ldmatrix.trans.
#pragma unroll
  for (int kk = 0; kk < kBlockN / 16; ++kk) {
    uint32_t pa[4];
    pack_a<T>(pa, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
    for (int dp = 0; dp < D / 16; ++dp) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, sv + (kk * 16 * kLd + dp * 16) * 2 + off_a);
      mma_16816<T>(o_acc[2 * dp], pa, b[0], b[1]);
      mma_16816<T>(o_acc[2 * dp + 1], pa, b[2], b[3]);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreadsFwd, 1)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int H, int group, int S, int Skv,
                 long long qsb, long long qsh, long long qss,
                 long long ksb, long long ksh, long long kss,
                 long long vsb, long long vsh, long long vss,
                 long long osb, long long osh, long long oss,
                 float sm_scale, int causal) {
  using P = Plan<D>;
  constexpr int kLd = P::kLd;
  extern __shared__ __align__(128) unsigned char smem[];
  T* sq = reinterpret_cast<T*>(smem);
  T* skv = reinterpret_cast<T*>(smem + P::kKV);
  const uint32_t sq_u = smem_addr(sq);
  const uint32_t skv_u = smem_addr(skv);

  const int n_qt = (S + kBlockM - 1) / kBlockM;
  int head, rank;
  tile_order(blockIdx.x, gridDim.x / n_qt, n_qt, head, rank);
  const int q0 = (n_qt - 1 - rank) * kBlockM;  // the last q tile is heaviest
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
  int n_tiles = (Skv + kBlockN - 1) / kBlockN;
  int warp_tiles = n_tiles;
  if (causal) {
    n_tiles = min(n_tiles, min(q0 + kBlockM - 1, S - 1) / kBlockN + 1);
    warp_tiles = min(n_tiles, min(wq0 + 15, S - 1) / kBlockN + 1);
  }
  if (wq0 >= S) warp_tiles = 0;

  cp_async_tile<T, D, kBlockM, kThreadsFwd, kLd>(sq, q + b * qsb + h * qsh,
                                                 qss, q0, S);
  cp_async_tile<T, D, kBlockN, kThreadsFwd, kLd>(skv, kb, kss, 0, Skv);
  cp_async_tile<T, D, kBlockN, kThreadsFwd, kLd>(skv + P::kTileKV, vb, vss,
                                                 0, Skv);
  cp_async_commit();

  uint32_t qf[D / 16][4];
  float o_acc[D / 8][4];
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) o_acc[nt][e] = 0.f;
  }
  float m_run[2] = {kNegInf, kNegInf};  // log2 domain
  float l_run[2] = {0.f, 0.f};
  const float scale_log2 = sm_scale * kLog2e;

  for (int j = 0; j < n_tiles; ++j) {
    // Tile j has landed for this thread; the barrier makes every thread's
    // part visible and tells that every warp is done with tile j - 1, whose
    // stage the next copy overwrites.
    cp_async_wait<0>();
    __syncthreads();
    if (j + 1 < n_tiles) {
      T* nxt = skv + ((j + 1) & 1) * 2 * P::kTileKV;
      const int k1 = (j + 1) * kBlockN;
      cp_async_tile<T, D, kBlockN, kThreadsFwd, kLd>(nxt, kb, kss, k1, Skv);
      cp_async_tile<T, D, kBlockN, kThreadsFwd, kLd>(nxt + P::kTileKV, vb,
                                                     vss, k1, Skv);
      cp_async_commit();
    }
    if (j == 0) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        ldmatrix_x4(qf[kk], sq_u + (warp * 16 * kLd + kk * 16) * 2 + off_a);
      }
    }
    if (j < warp_tiles) {
      const uint32_t sk = skv_u + (j & 1) * 2 * P::kTileKV * 2;
      const uint32_t sv = sk + P::kTileKV * 2;
      const int k0 = j * kBlockN;
      const int row0 = wq0 + lane / 4;
      const bool masked =
          k0 + kBlockN > Skv || (causal && k0 + kBlockN - 1 > wq0);
      if (masked) {
        fwd_tile<T, D, true>(qf, sk, sv, off_a, off_b, o_acc, m_run, l_run,
                             scale_log2, row0, k0, Skv, causal);
      } else {
        fwd_tile<T, D, false>(qf, sk, sv, off_a, off_b, o_acc, m_run, l_run,
                              scale_log2, row0, k0, Skv, causal);
      }
    }
  }

  // Finalize this warp's rows: o = acc / l, lse = m + log(l), l == 0 -> 1.
  // o goes through this warp's own 16 rows of the Q tile (only it read
  // them), so the strided rows leave as 16-byte stores.
  float l_safe[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float l = quad_sum(l_run[i]);
    l_safe[i] = (l == 0.f) ? 1.f : l;
  }
  const int g = lane / 4;
  const int c = lane % 4;
  T* so = sq + warp * 16 * kLd;
  __syncwarp();
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt) {
    *reinterpret_cast<uint32_t*>(so + g * kLd + nt * 8 + 2 * c) = pack2<T>(
        o_acc[nt][0] / l_safe[0], o_acc[nt][1] / l_safe[0]);
    *reinterpret_cast<uint32_t*>(so + (g + 8) * kLd + nt * 8 + 2 * c) =
        pack2<T>(o_acc[nt][2] / l_safe[1], o_acc[nt][3] / l_safe[1]);
  }
  __syncwarp();
  T* ob = o + b * osb + h * osh;
  constexpr int kPerRow = D / 8;
#pragma unroll
  for (int it = 0; it < 16 * kPerRow / 32; ++it) {
    const int i = lane + it * 32;
    const int r = i / kPerRow;
    const int cc = (i % kPerRow) * 8;
    if (wq0 + r < S) {
      *reinterpret_cast<uint4*>(ob + (long long)(wq0 + r) * oss + cc) =
          *reinterpret_cast<const uint4*>(so + r * kLd + cc);
    }
  }
  if (c == 0) {
    float* lrow = lse + ((long long)b * H + h) * S;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int q_pos = wq0 + g + 8 * i;
      if (q_pos < S) lrow[q_pos] = m_run[i] * kLn2 + logf(l_safe[i]);
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
  const long long blocks =
      (long long)((S + kBlockM - 1) / kBlockM) * H * B;
  if (blocks > INT_MAX) return cudaErrorInvalidConfiguration;
  kernel<<<static_cast<unsigned>(blocks), kThreadsFwd, smem, stream>>>(
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
