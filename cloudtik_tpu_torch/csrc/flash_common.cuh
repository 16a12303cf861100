// Helpers shared by the flash-attention kernels (flash_fwd.cu,
// flash_bwd.cu): the strided cp.async tile loads, the tensor-core building
// blocks in inline PTX, 16-bit packing, and the order in which blocks take
// tiles.
//
// Register layouts.  `mma.sync.m16n8k16` (row.col, f32 accumulate) keeps
// every operand in registers with a documented layout, so the softmax and
// the ds arithmetic run on the accumulators where they lie.  For lane t of a
// warp, g = t / 4 and c = t % 4:
//   A, 16 x 16 (row-major), 4 x b32, each two 16-bit values, the lower
//   column in the low half:
//     a[0] = (row g, cols 2c, 2c+1)      a[1] = (row g+8, cols 2c, 2c+1)
//     a[2] = (row g, cols 2c+8, 2c+9)    a[3] = (row g+8, cols 2c+8, 2c+9)
//   B, 16 x 8 (k x n), 2 x b32:  b[0] = (k 2c, 2c+1; col g)
//                                b[1] = (k 2c+8, 2c+9; col g)
//   C/D, 16 x 8 f32, 4 floats:   d[0], d[1] = (row g, cols 2c, 2c+1)
//                                d[2], d[3] = (row g+8, cols 2c, 2c+1)
// So the accumulators d0, d1 of two neighbouring n8 tiles (columns 16k ..
// 16k+15 of a 16-row block), packed pairwise to 16 bits, are the A operand
// of a product over those 16 columns:
//   {pack(d0[0], d0[1]), pack(d0[2], d0[3]), pack(d1[0], d1[1]),
//    pack(d1[2], d1[3])}
// (`pack_a`).  A row's values are spread over the 4 lanes of a quad, so a
// row max or row sum is a shuffle over lanes t^1 and t^2 (`quad_max`,
// `quad_sum`).
//
// Shared tiles are row-major with a row pitch of D + 8 16-bit values: the 8
// row addresses of one `ldmatrix` 8x8 matrix then start 4 banks apart and
// never collide, and every row stays 16-byte aligned for `cp.async`.  With
// that pitch the lane addresses of `ldmatrix_x4` are:
//   `lane_off_a`: rows lane % 16, columns (lane / 16) * 8 of a 16 x 16 block
//     -- an A fragment of a row-major [rows][k] tile, or (with .trans) the B
//     fragments of two n8 tiles of a row-major [k][n] tile;
//   `lane_off_b`: rows lane % 8 + (lane / 16) * 8, columns ((lane / 8) % 2)
//     * 8 -- the B fragments of two n8 tiles of a row-major [n][k] tile
//     (K, or Q and dO in the dk/dv kernel: B = tile^T, no transpose).
// In both, r[0], r[1] are the (b[0], b[1]) of the first n8 tile and r[2],
// r[3] those of the second.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tik_flash {

constexpr float kNegInf = -1e30f;  // the TPU kernels' _NEG_INF
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

constexpr size_t align128(size_t n) { return (n + 127) / 128 * 128; }

// ------------------------------------------------------------- cp.async --

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, bypassing L1; with `valid` false nothing is
// read and the 16 bytes are zero (src-size 0), so a ragged edge needs no
// branch around the copy.
__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src,
                                            bool valid) {
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(n));
}

// 4 bytes (one f32 statistic), zero when not `valid`.
__device__ __forceinline__ void cp_async_4(uint32_t dst, const void* src,
                                           bool valid) {
  const int n = valid ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most N of this thread's committed groups are in flight.
// Other threads' copies become visible only after a barrier.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Start the copy of rows [row0, row0 + ROWS) of a strided [nrows, D] slab
// into a shared tile of pitch LD, one 16-byte cp.async per thread per step;
// rows at or past `nrows` are zero-filled.
template <typename T, int D, int ROWS, int THREADS, int LD>
__device__ __forceinline__ void cp_async_tile(T* dst, const T* src,
                                              long long row_stride, int row0,
                                              int nrows) {
  constexpr int kPerRow = D / 8;
  static_assert((ROWS * kPerRow) % THREADS == 0, "tile not a whole step");
#pragma unroll
  for (int it = 0; it < ROWS * kPerRow / THREADS; ++it) {
    const int i = threadIdx.x + it * THREADS;
    const int r = i / kPerRow;
    const int c = (i % kPerRow) * 8;
    const bool valid = row0 + r < nrows;
    const T* g = src + (long long)(valid ? row0 + r : 0) * row_stride + c;
    cp_async_16(smem_addr(dst + r * LD + c), g, valid);
  }
}

// ------------------------------------------------------- tensor cores --

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// Byte offsets of this lane's `ldmatrix_x4` row address in a tile of pitch
// LD (see the note at the top).
template <int LD>
__device__ __forceinline__ uint32_t lane_off_a(int lane) {
  return ((lane & 15) * LD + ((lane >> 4) << 3)) * 2;
}
template <int LD>
__device__ __forceinline__ uint32_t lane_off_b(int lane) {
  return (((lane & 7) + ((lane >> 4) << 3)) * LD + (((lane >> 3) & 1) << 3)) *
         2;
}

// d += a . b on the tensor cores, 16 x 8 x 16, f32 accumulate.
template <typename T>
__device__ __forceinline__ void mma_16816(float (&d)[4],
                                          const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1);
template <>
__device__ __forceinline__ void mma_16816<__nv_bfloat16>(
    float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
template <>
__device__ __forceinline__ void mma_16816<__half>(float (&d)[4],
                                                  const uint32_t (&a)[4],
                                                  uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two f32 rounded to nearest into one b32 of 16-bit values, `lo` in the
// low half (the lower column of an A or C pair).
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi);
template <>
__device__ __forceinline__ uint32_t pack2<__nv_bfloat16>(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
template <>
__device__ __forceinline__ uint32_t pack2<__half>(float lo, float hi) {
  __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The A operand of a k16 product from the accumulators of two neighbouring
// n8 tiles (see the note at the top).
template <typename T>
__device__ __forceinline__ void pack_a(uint32_t (&a)[4], const float (&d0)[4],
                                       const float (&d1)[4]) {
  a[0] = pack2<T>(d0[0], d0[1]);
  a[1] = pack2<T>(d0[2], d0[3]);
  a[2] = pack2<T>(d1[0], d1[1]);
  a[3] = pack2<T>(d1[2], d1[3]);
}

// Max and sum over the 4 lanes of a quad: one row of an m16n8 accumulator.
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// ---------------------------------------------------------- tile order --

// Blocks take (head, tile) pairs in groups of kHeadGroup heads: within a
// group, tile rank 0 of every head first, then rank 1, and so on.  The
// kernels give rank 0 to their heaviest causal tile, so the long blocks
// start first and the grid ends on short ones, and the blocks that run
// together read the K/V (or Q/dO) of a few heads, which stay in L2.
constexpr int kHeadGroup = 16;

__device__ __forceinline__ void tile_order(int block, int heads, int tiles,
                                           int& head, int& rank) {
  const int g0 = block / (kHeadGroup * tiles) * kHeadGroup;
  const int size = min(kHeadGroup, heads - g0);
  const int r = block - g0 * tiles;
  rank = r / size;
  head = g0 + r % size;
}

}  // namespace tik_flash
