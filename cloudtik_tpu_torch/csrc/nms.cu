// Greedy non-maximum suppression for Hopper (sm_90a), f32 boxes and scores.
//
// Replaces cloudtik_tpu/ops/detection.py::_nms_kernel (:100, the Pallas
// kernel behind `nms`, pallas_call at :115).  It computes what that kernel's
// `_nms_select_rows` computes: up to K times, take the highest live score
// (the lowest index wins ties); stop once it is at or below -5e29 (no box
// left) or NaN; keep its index; set every live box whose IoU with it is
// strictly above the threshold, and the winner itself, to -1e30.  keep is
// -1-padded.
//
// The argmax loop as a scan in sorted order.  Call the boxes whose score is
// above -5e29 the candidates, and order them by score descending, then by
// index ascending.  A suppressed box sits at -1e30 and never wins again, an
// unsuppressed candidate keeps its own score, so the argmax of the live
// scores is always the first unsuppressed candidate in that order: candidate
// c is kept iff no box kept before it has IoU(kept, c) > thr, and the scan
// stops at K kept.  Two cases fall outside the order:
//   - a NaN score anywhere makes the reference's max NaN at every step, so
//     nothing is kept (the whole row is -1);
//   - -0.0 and +0.0 compare equal there, so they tie and the lower index
//     wins: the sort key maps -0.0 to +0.0.
//
// Exactness.  The keep list must equal the plain version's, so the IoU is
// computed in the JAX order with round-to-nearest intrinsics, which nvcc
// never contracts into an FMA, and with a min / max that propagate NaN as
// XLA's do (a box with a NaN coordinate suppresses nothing and is never
// suppressed):
//   area  = (x2 - x1) * (y2 - y1)
//   inter = max(min(bx2, x2) - max(bx1, x1), 0) * max(min(by2, y2)
//           - max(by1, y1), 0)
//   iou   = inter / max((barea + area) - inter, 1e-9)
// with b the box kept earlier, compared with the threshold as an f32 (the
// wrapper passes f32(thr)).
//
// What bounds it on this card: neither bytes (20 bytes a box read, 4 bytes a
// kept index written) nor arithmetic (~16 flops an IoU); what limits it is
// the chain of dependent steps within one image.  The design gives each
// image one block of 1,024 threads (grid = B) and takes the chain in wide
// steps, with every box count held in device memory, not shared memory:
//   1. Order.  Each score becomes a 64-bit key (32 bits of order-preserving
//      score, then the complemented index), all distinct, larger first.  A
//      band is the 512 (first) or 2,048 (later) largest keys below the
//      previous band's last: an
//      8-bit radix select over the scores in device memory (one histogram
//      pass a digit, warp-aggregated shared atomics, stopping as soon as the
//      chosen bucket is taken whole; the first pass also finds NaN), a
//      compaction into shared memory, and a bitonic sort of the band with
//      two keys a thread in registers: shuffles within a warp, shared
//      memory across warps.  An image with 2,048 candidates or fewer is one
//      band after one histogram pass.
//   2. Scan the band in chunks of 64 candidates: (a) each candidate's IoU
//      against every box kept so far, 16 threads a candidate; (b) for each
//      candidate, one 64-bit word of the earlier candidates of the chunk
//      that would suppress it, built by ballots; (c) one warp resolves the
//      chunk in rounds of ballots: a candidate is kept once none of its
//      suppressors is undecided or kept, dropped once one is kept, so a
//      round decides at least the first undecided candidate and usually
//      most of the chunk.  A band is ordered again only if the scan runs
//      out of it before K are kept.
// The boxes kept so far (x1, y1, x2, y2), which every later candidate is
// held against, go to a scratch buffer in device memory that the wrapper
// hands in, so K is not bounded by shared memory either (holding them in
// shared memory instead measured no faster).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef unsigned long long u64;

constexpr int kThreads = 1024;
constexpr int kBand = 2048;   // candidates ordered at a time: 2 a thread
constexpr int kFirstBand = 512;  // the first band of an image, a quarter
constexpr int kChunk = 64;    // candidates resolved at a time (bits a word)
constexpr int kLoads = 4;     // scores a thread loads per round of a pass
constexpr int kDigitBits = 8;  // radix digit
constexpr int kBins = 1 << kDigitBits;
constexpr float kValidAbove = -5e29f;  // the TPU kernel's _NEG_INF / 2
constexpr unsigned kAll = 0xffffffffu;

// Phase clocks, for tools/profile_torch_nms_phases.py: built with
// -DNMS_PHASE_CLOCKS, thread 0 of each of the first kPhaseImages blocks adds
// the SM cycles since its last mark to its phase's slot, and one to each
// count, in g_phase [image][slot]; tik_nms_phase_clocks reads and clears
// them.  The normal build has none of it.
#ifdef NMS_PHASE_CLOCKS
enum PhaseSlot {
  kPhRadix, kPhCompact, kPhSort, kPhChunkLoad, kPhChunkIou, kPhChunkResolve,
  kPhChunkWrite,                 // cycles
  kPhPasses, kPhChunks, kPhBands,  // counts
  kPhSlots
};
constexpr int kPhaseImages = 64;
__device__ long long g_phase[kPhaseImages * kPhSlots];
#define PHASE_START long long phase_mark_ = clock64();
#define PHASE_MARK(slot)                                               \
  if (tid == 0 && blockIdx.x < kPhaseImages) {                         \
    const long long now_ = clock64();                                  \
    g_phase[blockIdx.x * kPhSlots + (slot)] += now_ - phase_mark_;     \
    phase_mark_ = now_;                                                \
  }
#define PHASE_COUNT(slot)                                              \
  if (tid == 0 && blockIdx.x < kPhaseImages) {                         \
    g_phase[blockIdx.x * kPhSlots + (slot)] += 1;                      \
  }
#else
#define PHASE_START
#define PHASE_MARK(slot)
#define PHASE_COUNT(slot)
#endif

// Orders scores as floats compare: larger key, larger score; -0.0 is +0.0.
__device__ __forceinline__ uint32_t score_key(float s) {
  uint32_t u = __float_as_uint(s);
  if (u == 0x80000000u) u = 0u;
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// Larger first: score descending, then index ascending.
__device__ __forceinline__ u64 order_key(float s, int j) {
  return (static_cast<u64>(score_key(s)) << 32) |
         static_cast<uint32_t>(~j);
}

__device__ __forceinline__ int key_index(u64 key) {
  return static_cast<int>(~static_cast<uint32_t>(key));
}

// min / max that return NaN when either side is NaN, as XLA's do
__device__ __forceinline__ float min_nan(float a, float b) {
  return (a < b || a != a) ? a : b;
}

__device__ __forceinline__ float max_nan(float a, float b) {
  return (a > b || a != a) ? a : b;
}

__device__ __forceinline__ float area(float4 r) {
  return __fmul_rn(__fsub_rn(r.z, r.x), __fsub_rn(r.w, r.y));
}

// IoU of box c with box w, the one kept earlier, in the reference's order.
__device__ __forceinline__ float iou(float4 w, float4 c) {
  const float iw =
      max_nan(__fsub_rn(min_nan(w.z, c.z), max_nan(w.x, c.x)), 0.0f);
  const float ih =
      max_nan(__fsub_rn(min_nan(w.w, c.w), max_nan(w.y, c.y)), 0.0f);
  const float inter = __fmul_rn(iw, ih);
  const float uni = __fsub_rn(__fadd_rn(area(w), area(c)), inter);
  return __fdiv_rn(inter, max_nan(uni, 1e-9f));
}

// Adds one to hist[bin] for every lane whose bin is >= 0, one shared atomic
// per distinct bin of the warp (ties pile onto one bin).  All 32 lanes call.
__device__ __forceinline__ void hist_add(unsigned* hist, int bin) {
  const unsigned peers = __match_any_sync(kAll, bin);
  if (bin >= 0 && (threadIdx.x & 31) == __ffs(peers) - 1) {
    atomicAdd(&hist[bin], static_cast<unsigned>(__popc(peers)));
  }
}

struct Digit {
  int digit;   // the bucket the rank-th largest key falls in
  int above;   // keys in higher buckets
  int bucket;  // keys in that bucket
  int total;   // keys in the histogram
};

// Warp 0: lane l holds the l-th run of kBins / 32 buckets from the top; a
// scan over the lanes finds the bucket of the rank-th largest (1-based) key.
__device__ __forceinline__ void find_digit(const unsigned* hist, int rank,
                                           Digit* out) {
  constexpr int kPerLane = kBins / 32;
  const int lane = threadIdx.x & 31;
  const int top = kBins - 1 - kPerLane * lane;
  int sum = 0;
#pragma unroll
  for (int q = 0; q < kPerLane; ++q) sum += hist[top - q];
  int incl = sum;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int o = __shfl_up_sync(kAll, incl, off);
    if (lane >= off) incl += o;
  }
  if (lane == 31) out->total = incl;
  int cum = incl - sum;
  if (cum < rank && rank <= incl) {
    for (int q = 0; q < kPerLane; ++q) {
      const int v = hist[top - q];
      if (cum + v >= rank) {
        out->digit = top - q;
        out->above = cum;
        out->bucket = v;
        break;
      }
      cum += v;
    }
  }
}

// Sorts band[0, n) descending (n <= kBand; the band past the next power of
// two is left as it was, the rest up to it clobbered).  Thread t holds keys
// 2t and 2t + 1 in registers; a bitonic step whose partner is within the
// warp (stride <= 32) is a shuffle, one across warps goes through shared
// memory.  Only the warps that hold keys below the power of two work; all
// threads call.
__device__ __forceinline__ void sort_band(u64* band, int n) {
  const int t = threadIdx.x;
  int pow2 = 64;
  while (pow2 < n) pow2 <<= 1;
  const bool active = 2 * t < pow2;  // whole warps: pow2 is a multiple of 64
  u64 e[2] = {0ull, 0ull};            // 0 sorts below every key
  if (active) {
    if (2 * t < n) e[0] = band[2 * t];
    if (2 * t + 1 < n) e[1] = band[2 * t + 1];
  }
  for (int size = 2; size <= pow2; size <<= 1) {
    int stride = size >> 1;
    if (stride >= 64) {
      __syncthreads();
      if (active) {
        band[2 * t] = e[0];
        band[2 * t + 1] = e[1];
      }
      __syncthreads();
      for (; stride >= 64; stride >>= 1) {
        if (active) {
          const int i = 2 * t - (t & (stride - 1));  // pair (i, i + stride)
          const u64 x = band[i], y = band[i + stride];
          if ((x < y) == ((i & size) == 0)) {
            band[i] = y;
            band[i + stride] = x;
          }
        }
        __syncthreads();
      }
      if (active) {
        e[0] = band[2 * t];
        e[1] = band[2 * t + 1];
      }
    }
    if (!active) continue;
    for (; stride >= 2; stride >>= 1) {
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int i = 2 * t + q;
        const u64 o = __shfl_xor_sync(kAll, e[q], stride >> 1);
        // the lower of a pair keeps the larger in a descending run
        const bool larger = ((i & stride) == 0) == ((i & size) == 0);
        e[q] = larger ? max(e[q], o) : min(e[q], o);
      }
    }
    const u64 hi = max(e[0], e[1]), lo = min(e[0], e[1]);
    const bool desc = ((2 * t) & size) == 0;
    e[0] = desc ? hi : lo;
    e[1] = desc ? lo : hi;
  }
  __syncthreads();
  if (active) {
    band[2 * t] = e[0];
    band[2 * t + 1] = e[1];
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads)
nms_kernel(const float* __restrict__ boxes, const float* __restrict__ scores,
           int* __restrict__ keep, float4* kept, int N, int K, float thr) {
  __shared__ u64 band[kBand];
  __shared__ unsigned hist[kBins];
  __shared__ float4 cbox[kChunk];
  __shared__ int cidx[kChunk];
  __shared__ u64 cols[kChunk];
  __shared__ u64 s_supp, s_taken;
  __shared__ Digit s_digit;
  __shared__ int s_count;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  PHASE_START
  const float* bx = boxes + static_cast<long long>(blockIdx.x) * N * 4;
  const float* sc = scores + static_cast<long long>(blockIdx.x) * N;
  int* out = keep + static_cast<long long>(blockIdx.x) * K;
  float4* kb = kept + static_cast<long long>(blockIdx.x) * K;

  for (int k = tid; k < K; k += kThreads) out[k] = -1;
  int nkept = 0;
  u64 upper = ~0ull;  // every key of a later band lies below it
  // The scan of most images ends within a few hundred candidates, so the
  // first band is smaller, and cheaper to sort, than the later ones.
  int band_size = kFirstBand;
  while (nkept < K) {
    // ---- 1. the band: the band_size largest candidate keys below `upper`
    u64 prefix = 0, pmask = 0;
    int rank = band_size;  // keys still to take among those under `prefix`
    int nband = band_size;
    for (int shift = 64 - kDigitBits; shift >= 0; shift -= kDigitBits) {
      for (int i = tid; i < kBins; i += kThreads) hist[i] = 0;
      PHASE_COUNT(kPhPasses)
      __syncthreads();
      int nan = 0;
      for (int base = 0; base < N; base += kThreads * kLoads) {
        float s[kLoads];
#pragma unroll
        for (int r = 0; r < kLoads; ++r) {
          const int j = base + r * kThreads + tid;
          s[r] = j < N ? sc[j] : -INFINITY;
        }
#pragma unroll
        for (int r = 0; r < kLoads; ++r) {
          const u64 key = order_key(s[r], base + r * kThreads + tid);
          const bool in = s[r] > kValidAbove && key < upper &&
                          (key & pmask) == prefix;
          nan |= isnan(s[r]);
          hist_add(hist, in ? static_cast<int>((key >> shift) &
                                               (kBins - 1))
                            : -1);
        }
      }
      // A NaN score anywhere (seen in the first pass): the reference's max
      // is NaN at every step, so nothing is kept.
      if (__syncthreads_or(nan)) return;
      if (tid < 32) find_digit(hist, rank, &s_digit);
      __syncthreads();
      const Digit d = s_digit;
      if (pmask == 0 && d.total <= band_size) {  // one band holds them all
        nband = d.total;
        break;
      }
      prefix |= static_cast<u64>(d.digit) << shift;
      pmask |= static_cast<u64>(kBins - 1) << shift;
      rank -= d.above;
      // every key under `prefix` is taken (keys are distinct, so at the
      // last digit the bucket holds one)
      if (d.bucket == rank) break;
    }
    PHASE_MARK(kPhRadix)
    // keys >= `lowest` below `upper` are the band: exactly nband of them
    const u64 lowest = nband < band_size ? 0ull : prefix;
    if (tid == 0) s_count = 0;
    __syncthreads();
    for (int base = 0; base < N; base += kThreads * kLoads) {
      float s[kLoads];
#pragma unroll
      for (int r = 0; r < kLoads; ++r) {
        const int j = base + r * kThreads + tid;
        s[r] = j < N ? sc[j] : -INFINITY;
      }
#pragma unroll
      for (int r = 0; r < kLoads; ++r) {
        const u64 key = order_key(s[r], base + r * kThreads + tid);
        const bool in = s[r] > kValidAbove && key < upper && key >= lowest;
        const unsigned ballot = __ballot_sync(kAll, in);
        int first = 0;
        if (lane == 0 && ballot) first = atomicAdd(&s_count, __popc(ballot));
        first = __shfl_sync(kAll, first, 0);
        const int pos = first + __popc(ballot & ((1u << lane) - 1u));
        if (in && pos < kBand) band[pos] = key;  // exactly nband are in
      }
    }
    if (nband == 0) break;
    __syncthreads();
    PHASE_MARK(kPhCompact)
    sort_band(band, nband);
    PHASE_MARK(kPhSort)
    PHASE_COUNT(kPhBands)

    // ---- 2. scan the band in chunks of kChunk ----
    for (int p = 0; p < nband && nkept < K; p += kChunk) {
      const int len = min(kChunk, nband - p);
      if (tid < len) {
        const int j = key_index(band[p + tid]);
        cidx[tid] = j;
        cbox[tid] = make_float4(bx[4 * j], bx[4 * j + 1], bx[4 * j + 2],
                                bx[4 * j + 3]);
      }
      if (tid == 0) s_supp = 0ull;
      __syncthreads();
      PHASE_MARK(kPhChunkLoad)
      PHASE_COUNT(kPhChunks)
      // 16 threads a candidate: lanes 0-15 take candidate 2w, 16-31 2w + 1
      const int c = tid >> 4;
      const int sub = tid & 15;
      // (a) suppressed by a box kept before this chunk
      bool hit = false;
      if (c < len) {
        const float4 box = cbox[c];
        for (int k = sub; k < nkept; k += 16) hit |= iou(kb[k], box) > thr;
      }
      const unsigned ballot = __ballot_sync(kAll, hit);
      const unsigned mine = lane < 16 ? (ballot & 0xffffu) : (ballot >> 16);
      // (b) bit i of col: earlier candidate i suppresses c if kept
      u64 col = 0ull;
#pragma unroll
      for (int q = 0; q < kChunk / 16; ++q) {
        const int i = sub + 16 * q;
        const bool s = i < c && c < len && iou(cbox[i], cbox[c]) > thr;
        const unsigned b = __ballot_sync(kAll, s);
        col |= static_cast<u64>(lane < 16 ? (b & 0xffffu) : (b >> 16))
               << (16 * q);
      }
      if (sub == 0) {
        cols[c] = col;
        if (mine) atomicOr(&s_supp, 1ull << c);
      }
      __syncthreads();
      PHASE_MARK(kPhChunkIou)
      // (c) warp 0 resolves the chunk in rounds: a candidate is kept once
      // no earlier one that could suppress it is undecided or kept, and
      // suppressed once one of them is kept; the first undecided candidate
      // is decided every round.  Lane l holds candidates l and l + 32.
      if (tid < 32) {
        const u64 col0 = cols[lane], col1 = cols[lane + 32];
        u64 undecided =
            (len == kChunk ? ~0ull : (1ull << len) - 1ull) & ~s_supp;
        u64 taken = 0ull;
        while (undecided != 0ull) {
          const bool u0 = (undecided >> lane) & 1ull;
          const bool u1 = (undecided >> (lane + 32)) & 1ull;
          const u64 keep_now =
              __ballot_sync(kAll, u0 && !(col0 & (taken | undecided))) |
              static_cast<u64>(__ballot_sync(
                  kAll, u1 && !(col1 & (taken | undecided)))) << 32;
          const u64 gone =
              __ballot_sync(kAll, u0 && (col0 & taken)) |
              static_cast<u64>(__ballot_sync(kAll, u1 && (col1 & taken)))
                  << 32;
          taken |= keep_now;
          undecided &= ~(keep_now | gone);
        }
        // only the first K - nkept of them
        for (int extra = __popcll(taken) - (K - nkept); extra > 0; --extra) {
          taken &= ~(1ull << (63 - __clzll(static_cast<long long>(taken))));
        }
        if (lane == 0) s_taken = taken;
      }
      __syncthreads();
      PHASE_MARK(kPhChunkResolve)
      const u64 taken = s_taken;
      if (tid < len && ((taken >> tid) & 1ull)) {
        const int pos = nkept + __popcll(taken & ((1ull << tid) - 1ull));
        out[pos] = cidx[tid];
        kb[pos] = cbox[tid];
      }
      nkept += __popcll(taken);
      __syncthreads();
      PHASE_MARK(kPhChunkWrite)
    }
    if (nband < band_size) break;  // the band held every candidate left
    upper = band[band_size - 1];
    band_size = kBand;
  }
}

}  // namespace

extern "C" {

// boxes: contiguous [B, N, 4] f32 (x1, y1, x2, y2); scores: contiguous
// [B, N] f32; keep: contiguous [B, K] int32; kept: 16-byte-aligned scratch
// of B * K * 4 f32 for the kept boxes.  thr is the IoU threshold as an f32.
// Returns the cudaError_t of the launch (0 on success).
int tik_nms(const float* boxes, const float* scores, int* keep, void* kept,
            int B, int N, int K, float thr, void* stream) {
  if (B <= 0 || N < 0 || K <= 0 ||
      reinterpret_cast<uintptr_t>(kept) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  nms_kernel<<<B, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      boxes, scores, keep, static_cast<float4*>(kept), N, K, thr);
  return static_cast<int>(cudaGetLastError());
}

#ifdef NMS_PHASE_CLOCKS
// Copies g_phase (kPhaseImages x kPhSlots int64) to the host buffer out and
// clears it; the launches that filled it must have finished.
int tik_nms_phase_clocks(long long* out) {
  static const long long zero[kPhaseImages * kPhSlots] = {};
  cudaError_t err = cudaMemcpyFromSymbol(out, g_phase, sizeof(zero));
  if (err == cudaSuccess) err = cudaMemcpyToSymbol(g_phase, zero, sizeof(zero));
  return static_cast<int>(err);
}
#endif

const char* tik_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
