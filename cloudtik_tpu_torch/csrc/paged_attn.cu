// Paged decode attention for Hopper (sm_90a), bf16 in, f32 inside.
//
// Replaces no Pallas kernel: the reference's decode attention
// (cloudtik_tpu/serve/engine.py `_decode_layer`) is XLA einsums over the
// gathered block tables.  It was added because in the port the same plain
// formulation (ops/paged_attention.py `paged_attention_reference`) gathers
// every lane's whole table, repeats it for each query head of a GQA group
// and casts the copy to f32 before two gemv einsums: several GB of traffic a
// layer for what needs one read of each lane's K/V up to its length.
//
// It computes what that plain version computes, for one decode token a lane:
//   append each active lane's new K/V row at (tables[b, len // bs], len % bs)
//   of the pool planes; s = (q . k) * scale in f32 over positions 0..len of
//   the lane (the new row included); p = softmax(s) in f32; o = sum p * v in
//   f32, rounded once to bf16.  Inactive lanes write nothing and give 0.
//
// What bounds it on this card: bytes.  A position costs 2 * Hkv * D * 2
// bytes of K and V (4 KB at Mistral-7B's 8 KV heads of 128) for about
// 4 * H * D flops (16 K), 4 flops a byte, far under the ~295 at which the
// tensor cores would matter: the least time is the lanes' K/V at 3.35 TB/s.
//
// What the design does about it.  One CTA of 4 warps for each (context
// split, KV head, lane).  It reads its lane's K/V only for its split's
// positions up to the lane's length, straight from the pool through the
// block table (the split's block ids staged once in shared memory), never a
// gathered copy and never an unallocated slot or the null block.  A thread
// takes 8 consecutive elements of a position's row as one 16-byte load;
// D / 8 neighbouring threads cover the row (256 contiguous bytes at D =
// 128), each thread keeps 4 loads in flight.  All G = H / Hkv query heads of
// the group are scored against each loaded K row, so K/V are read once per
// KV head (no repeat).  Scores (f32, then exp(s - m)) sit in shared memory:
// one pass over K scores the split, the max and sum are taken over it, and
// one pass over V accumulates P.V in f32 registers; P is never rounded.
// Contexts are cut into splits so that short batches and ragged lengths
// still fill the SMs: the wrapper picks positions per split from the batch,
// the KV heads and the tables' capacity, and with more than one split a
// second kernel merges the splits' (max, sum, unnormalised output) in f32.
// At most two launches a layer.  The appended position is read by every
// CTA from the new k/v inputs, never from the pool, so the one CTA that
// stores it (the split holding position len) races with no reader.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;           // 4 warps a CTA
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSplit = 512;          // positions a CTA, most
constexpr int kUnroll = 4;              // 16-byte loads in flight a thread
constexpr int kVec = 8;                 // elements of a 16-byte load

// 8 bf16 values of one 16-byte load, in f32
__device__ __forceinline__ void unpack8(const uint4& u, float (&f)[kVec]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

struct Args {
  const uint4* q;          // [B, H, D] as 16-byte vectors
  const uint4* k_new;      // [B, Hkv, D]
  const uint4* v_new;      // [B, Hkv, D]
  uint4* kc;               // [N, bs, Hkv, D], written at the appended rows
  uint4* vc;               // [N, bs, Hkv, D]
  const int64_t* tables;   // [B, M] physical block ids
  const int64_t* lengths;  // [B] the appended position of each lane
  const uint8_t* active;   // [B] bool
  __nv_bfloat16* out;      // [B, H, D]
  float* part_acc;         // [B, H, n_splits, D] unnormalised, f32
  float* part_ml;          // [B, H, n_splits, 2] (max, sum)
  int H, Hkv, M, bs, split, n_splits;
  float scale;
};

// The position lane b appends (its length), or -1 past the tables'
// capacity; the lane attends positions 0..len, at most the capacity.
__device__ __forceinline__ int appended(const Args& a, int b) {
  const long long len = a.lengths[b];
  return len < (long long)a.M * a.bs ? (int)len : -1;
}

__device__ __forceinline__ int attended(const Args& a, int newp) {
  return newp >= 0 ? newp + 1 : a.M * a.bs;
}

template <int D, int G>
__global__ void __launch_bounds__(kThreads)
paged_attn_split_kernel(const Args a) {
  constexpr int kCols = D / kVec;           // threads of a position's row
  constexpr int kRows = kThreads / kCols;   // positions a pass
  __shared__ float s_p[G][kMaxSplit];       // scores, then exp(s - m)
  __shared__ float s_red[kWarps][G][D];     // the warps' partial P.V
  __shared__ int s_blk[kMaxSplit + 1];      // the split's block ids
  __shared__ float s_m[G], s_l[G];

  const int s = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const int row = tid / kCols, col = tid % kCols;
  const int warp = tid / 32, lane = tid % 32;
  __nv_bfloat16* out = a.out;

  if (!a.active[b]) {
    if (a.n_splits == 1) {
      for (int e = tid; e < G * D; e += kThreads) {
        out[((size_t)b * a.H + h * G) * D + e] = __float2bfloat16_rn(0.f);
      }
    }
    return;
  }
  const int newp = appended(a, b);
  const int n = attended(a, newp);
  const int p0 = s * a.split;
  if (p0 >= n) return;                      // nothing of the lane here
  const int p1 = min(p0 + a.split, n);
  const int cnt = p1 - p0;

  const size_t pos_stride = (size_t)a.Hkv * kCols;   // vectors a position
  const uint4* kn = a.k_new + ((size_t)b * a.Hkv + h) * kCols;
  const uint4* vn = a.v_new + ((size_t)b * a.Hkv + h) * kCols;
  const int64_t* table = a.tables + (size_t)b * a.M;

  if (newp >= p0 && newp < p1 && tid < kCols) {     // the append
    const size_t at = ((size_t)table[newp / a.bs] * a.bs + newp % a.bs) *
                          pos_stride + (size_t)h * kCols + tid;
    a.kc[at] = kn[tid];
    a.vc[at] = vn[tid];
  }
  const int blk0 = p0 / a.bs;
  const int n_blk = (p1 - 1) / a.bs - blk0 + 1;
  for (int i = tid; i < n_blk; i += kThreads) {
    s_blk[i] = (int)table[blk0 + i];
  }
  float qf[G][kVec];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    unpack8(a.q[((size_t)b * a.H + h * G + g) * kCols + col], qf[g]);
  }
  __syncthreads();

  // this thread's vector of position p's row in a pool plane
  auto pool_at = [&](int p) -> size_t {
    return ((size_t)s_blk[p / a.bs - blk0] * a.bs + p % a.bs) * pos_stride +
           (size_t)h * kCols + col;
  };

  // scores: every thread of the CTA runs every pass (the shuffles)
  for (int base = p0; base < p1; base += kRows * kUnroll) {
    uint4 kv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int p = base + u * kRows + row;
      kv[u] = p >= p1 ? make_uint4(0, 0, 0, 0)
                      : (p == newp ? kn[col] : a.kc[pool_at(p)]);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      float kf[kVec];
      unpack8(kv[u], kf);
      float dot[G];
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float acc = 0.f;
#pragma unroll
        for (int i = 0; i < kVec; ++i) acc = fmaf(qf[g][i], kf[i], acc);
        dot[g] = acc;
      }
#pragma unroll
      for (int off = kCols / 2; off > 0; off >>= 1) {
#pragma unroll
        for (int g = 0; g < G; ++g) {
          dot[g] += __shfl_xor_sync(0xffffffffu, dot[g], off);
        }
      }
      const int p = base + u * kRows + row;
      if (col == 0 && p < p1) {
#pragma unroll
        for (int g = 0; g < G; ++g) s_p[g][p - p0] = dot[g] * a.scale;
      }
    }
  }
  __syncthreads();

  // the split's softmax statistics, one warp a query head
  for (int g = warp; g < G; g += kWarps) {
    float m = -FLT_MAX;
    for (int i = lane; i < cnt; i += 32) m = fmaxf(m, s_p[g][i]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    }
    float l = 0.f;
    for (int i = lane; i < cnt; i += 32) {
      const float e = expf(s_p[g][i] - m);
      s_p[g][i] = e;
      l += e;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      l += __shfl_xor_sync(0xffffffffu, l, off);
    }
    if (lane == 0) {
      s_m[g] = m;
      s_l[g] = l;
    }
  }
  __syncthreads();

  // P.V in f32, P as computed (never rounded to 16 bits)
  float acc[G][kVec];
#pragma unroll
  for (int g = 0; g < G; ++g) {
#pragma unroll
    for (int i = 0; i < kVec; ++i) acc[g][i] = 0.f;
  }
  for (int base = p0; base < p1; base += kRows * kUnroll) {
    uint4 vv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int p = base + u * kRows + row;
      vv[u] = p >= p1 ? make_uint4(0, 0, 0, 0)
                      : (p == newp ? vn[col] : a.vc[pool_at(p)]);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int p = base + u * kRows + row;
      if (p < p1) {
        float vf[kVec];
        unpack8(vv[u], vf);
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const float w = s_p[g][p - p0];
#pragma unroll
          for (int i = 0; i < kVec; ++i) acc[g][i] = fmaf(w, vf[i], acc[g][i]);
        }
      }
    }
  }
  // the rows of a warp, then the warps
#pragma unroll
  for (int off = kCols; off < 32; off <<= 1) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        acc[g][i] += __shfl_xor_sync(0xffffffffu, acc[g][i], off);
      }
    }
  }
  if (lane < kCols) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        s_red[warp][g][col * kVec + i] = acc[g][i];
      }
    }
  }
  __syncthreads();
  for (int e = tid; e < G * D; e += kThreads) {
    const int g = e / D, d = e % D;
    float o = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) o += s_red[w][g][d];
    const size_t bh = (size_t)b * a.H + h * G + g;
    if (a.n_splits == 1) {
      out[bh * D + d] = __float2bfloat16_rn(o / s_l[g]);
    } else {
      a.part_acc[(bh * a.n_splits + s) * D + d] = o;
      if (d == 0) {
        a.part_ml[(bh * a.n_splits + s) * 2] = s_m[g];
        a.part_ml[(bh * a.n_splits + s) * 2 + 1] = s_l[g];
      }
    }
  }
}

// One CTA of D threads for each (query head, lane): the splits' partial
// outputs merged under their common max, in f32.
template <int D>
__global__ void __launch_bounds__(D)
paged_attn_combine_kernel(const Args a) {
  const int hq = blockIdx.x, b = blockIdx.y, d = threadIdx.x;
  const size_t bh = (size_t)b * a.H + hq;
  if (!a.active[b]) {
    a.out[bh * D + d] = __float2bfloat16_rn(0.f);
    return;
  }
  const int n = attended(a, appended(a, b));
  const int ns = (n + a.split - 1) / a.split;
  const float* ml = a.part_ml + bh * a.n_splits * 2;
  const float* acc = a.part_acc + bh * a.n_splits * D + d;
  float m = -FLT_MAX;
  for (int i = 0; i < ns; ++i) m = fmaxf(m, ml[2 * i]);
  float l = 0.f, o = 0.f;
  for (int i = 0; i < ns; ++i) {
    const float w = expf(ml[2 * i] - m);
    l = fmaf(ml[2 * i + 1], w, l);
    o = fmaf(acc[(size_t)i * D], w, o);
  }
  a.out[bh * D + d] = __float2bfloat16_rn(o / l);
}

template <int D, int G>
cudaError_t launch(const Args& a, int B, cudaStream_t stream) {
  paged_attn_split_kernel<D, G>
      <<<dim3(a.n_splits, a.Hkv, B), kThreads, 0, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || a.n_splits == 1) return err;
  paged_attn_combine_kernel<D><<<dim3(a.H, B), D, 0, stream>>>(a);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_group(const Args& a, int B, int group,
                         cudaStream_t stream) {
  switch (group) {
    case 1: return launch<D, 1>(a, B, stream);
    case 2: return launch<D, 2>(a, B, stream);
    case 4: return launch<D, 4>(a, B, stream);
    case 8: return launch<D, 8>(a, B, stream);
    default: return cudaErrorInvalidValue;
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

extern "C" {

// bf16 q, k, v, pool planes and out; head_dim 64 or 128; group = H / Hkv
// in {1, 2, 4, 8}.  q [B, H, D],
// k/v [B, Hkv, D], kc/vc [N, bs, Hkv, D], out [B, H, D], all contiguous and
// 16-byte aligned; tables [B, M] and lengths [B] int64, active [B] bool.
// `split` positions a CTA (at most 512), n_splits = ceil(M * bs / split);
// with n_splits > 1, part_acc [B, H, n_splits, D] and part_ml [B, H,
// n_splits, 2] f32 scratch.  Returns the cudaError_t of the launches (0 on
// success); cudaErrorInvalidValue for what the kernels do not take.
int tik_paged_attn(int head_dim, int group, const void* q,
                   const void* k, const void* v, void* kc, void* vc,
                   const void* tables, const void* lengths,
                   const void* active, void* out, void* part_acc,
                   void* part_ml, int B, int H, int Hkv, int M, int bs,
                   int split, int n_splits, float scale, void* stream) {
  if (B <= 0 || B > 65535 || Hkv <= 0 || Hkv > 65535 || group <= 0 ||
      H != Hkv * group || M <= 0 || bs <= 0 || split <= 0 ||
      split > kMaxSplit || (long long)M * bs > INT_MAX ||
      n_splits != (int)(((long long)M * bs + split - 1) / split) ||
      (n_splits > 1 && (part_acc == nullptr || part_ml == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (!aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(kc) ||
      !aligned16(vc)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a;
  a.q = static_cast<const uint4*>(q);
  a.k_new = static_cast<const uint4*>(k);
  a.v_new = static_cast<const uint4*>(v);
  a.kc = static_cast<uint4*>(kc);
  a.vc = static_cast<uint4*>(vc);
  a.tables = static_cast<const int64_t*>(tables);
  a.lengths = static_cast<const int64_t*>(lengths);
  a.active = static_cast<const uint8_t*>(active);
  a.out = static_cast<__nv_bfloat16*>(out);
  a.part_acc = static_cast<float*>(part_acc);
  a.part_ml = static_cast<float*>(part_ml);
  a.H = H;
  a.Hkv = Hkv;
  a.M = M;
  a.bs = bs;
  a.split = split;
  a.n_splits = n_splits;
  a.scale = scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (head_dim == 64) {
    return static_cast<int>(launch_group<64>(a, B, group, st));
  }
  if (head_dim == 128) {
    return static_cast<int>(launch_group<128>(a, B, group, st));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* tik_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
