// Fused MoE router gating for Hopper: softmax -> top-k -> renormalise.
//
// Replaces the Pallas kernel src/repro/kernels/moe_gating.py::topk_gating
// (_gating_kernel).  It computes what that kernel computes, per token row
// of logits (T, E) f32:
//   p = softmax(logits)  (e = exp(x - max), p = e / sum e);
//   k argmaxes of p, ties going to the lower expert index, each taken
//   expert set to -1 before the next;
//   probs = the k kept p, divided by their sum (taken in order);
// giving probs (T, k) f32 and idx (T, k) int32.
//
// Bound: bytes.  It reads T*E*4 bytes and writes T*k*8, and does O(k*E)
// operations a row; at T = 4096, E = 16 that is 0.33 MB, 0.1 us at the
// card's memory rate, so in practice the launch and one row's chain of
// dependent steps (load, trees, the picks, the store) set its time, and
// at E = 128 the instructions a row (an expf and a division an expert).
//
// Design: a row takes a group of G consecutive lanes of a warp, sized to
// E (G = 4 at E <= 16, so 8 rows a warp; G = 8 above, 16 experts a lane
// at E = 128).  Lane g of a group holds the 16-byte chunks c = g + G*i
// (i < NV) of its row, experts 4c .. 4c+3, read as one float4 each (the
// vector route) or as four checked scalars where E % 4 != 0 or the base
// is not 16-byte aligned (the scalar route, the same template).  The
// max and the sum are xor trees of log2(G) levels within the group, so
// every lane of a group ends with the same bits; exp is expf and p a
// division, as in PyTorch's softmax.  Each (value, expert) is one 64-bit
// key, the value's bits over the complement of the index: values are
// >= 0, so the keys order them descending and, on a tie, the index
// ascending -- a strict total order.  For k <= 2 each lane keeps its best
// two keys and each tree level merges two sorted pairs: exactly the k
// sequential argmaxes, ties included, in one tree.  The tree runs on
// e = exp(x - max), and only the picks are divided: p = e / sum is e
// over one sum, so the order by p is the order by e except where two e
// round to one p.  That can reorder the picks only where the two picks'
// e differ by less than 2^-20, or an expert outside them has an e
// within 2^-20 below the last pick's, or the last pick is tiny (a
// subnormal p).  A warp where any group meets one divides every e and
// runs the tree on p, so the picks always equal those of k argmaxes of
// p, rounding ties included.
// For 2 < k <= 32 the group runs k max-trees over its p keys, the taken
// key zeroed after each.  The group's first lane writes the row's picks
// (one float2 and one int2 store at k = 2).  Rows past T compute the
// last row's values and store nothing, so whole groups stay in every
// shuffle.  No atomics.
//
// The backward (topk_gating_bwd_rows) has no Pallas counterpart: the JAX
// package differentiates its oracle through the kernel's call.  It is the
// VJP of the function above for the forward's picks (idx, probs) and
// dprobs (T, k) f32, per row:
//   s = sum of the picked p (in pick order, as the forward's total);
//   dp = (dprobs_j - sum_j probs_j dprobs_j) / s at expert idx_j, else 0;
//   dlogits = p * (dp - sum_e p_e dp_e)     (T, E) f32.
// Bound: bytes, as the forward: it reads logits and the three (T, k)
// arrays and writes dlogits, T * (8E + 12k) bytes; at Phi-3.5-MoE's
// training call (T = 8192, E = 16, k = 2) ~1.2 MB, 0.4 us at 3.35 TB/s,
// under the launch floor.  Design: the forward's groups and its softmax
// (row_softmax, so the same bits); every lane reads the row's k picks
// (one int2 / float2 each at k = 2 on the vector route) and takes each
// picked p from the lane that holds it by one shuffle; s, the dot
// product and sum_e p_e dp_e (only the picks' terms are not 0) are taken
// in pick order; dlogits goes out as float4 stores.  No atomics: two
// launches give the same bits.
//
// Built by nvcc for sm_90a into a shared library with a plain C interface
// (repro_torch/kernels/_build.py); the entry points return
// cudaGetLastError() so the Python wrapper raises on a refused launch.
// tools/gating_turns.py times this build against an earlier source and
// against the designs not kept, this source under -D flags that the port
// never sets: MOE_GATING_THREADS (threads a block), MOE_GATING_G16 and
// MOE_GATING_G128 (lanes a row at E <= 16 and at 64 < E <= 128),
// MOE_GATING_ONLINE (the max and the sum in one (m, s) tree) and
// MOE_GATING_PSELECT (every e divided and the picks taken on p; the GPU
// tests' reference for the picks).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#ifndef MOE_GATING_THREADS
#define MOE_GATING_THREADS 128
#endif
#ifndef MOE_GATING_G16
#define MOE_GATING_G16 4
#endif
#ifndef MOE_GATING_G128
#define MOE_GATING_G128 8
#endif

namespace {

constexpr int kThreads = MOE_GATING_THREADS;
constexpr int kMaxK = 32;
typedef unsigned long long u64;

template <int G>
__device__ __forceinline__ float group_max(float v) {
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

template <int G>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ u64 umax(u64 a, u64 b) { return a > b ? a : b; }
__device__ __forceinline__ u64 umin(u64 a, u64 b) { return a < b ? a : b; }

// (p, expert) as one key: larger p first, then the lower expert.  A pad
// (p = 0, expert >= E) loses to every expert; 0 loses to every key.
__device__ __forceinline__ u64 key(float p, int e) {
  return (u64)__float_as_uint(p) << 32 | (unsigned)~e;
}
__device__ __forceinline__ float key_p(u64 k) {
  return __uint_as_float((unsigned)(k >> 32));
}
__device__ __forceinline__ int key_e(u64 k) { return (int)~(unsigned)k; }

// The expert at lane g's chunk i, element j.
template <int G>
__device__ __forceinline__ int expert(int g, int i, int j) {
  return 4 * (g + G * i) + j;
}

// e = exp(x - max) of one row, the group's lane g holding its chunks,
// and the row's sum e (every lane of the group with the same bits).
// Pads (experts >= E) are read as -inf, so e = 0 there.
template <int G, int NV, int VEC>
__device__ __forceinline__ float row_exp(const float* __restrict__ x, int E,
                                         int g, float (&e)[NV][4]) {
  float mx = -INFINITY;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int c = g + G * i;
    if (VEC) {
      const float4 v = 4 * c < E
          ? __ldg(reinterpret_cast<const float4*>(x) + c)
          : make_float4(-INFINITY, -INFINITY, -INFINITY, -INFINITY);
      e[i][0] = v.x; e[i][1] = v.y; e[i][2] = v.z; e[i][3] = v.w;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        e[i][j] = 4 * c + j < E ? __ldg(x + 4 * c + j) : -INFINITY;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) mx = fmaxf(mx, e[i][j]);
  }
#ifdef MOE_GATING_ONLINE
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < NV; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) sum += expf(e[i][j] - mx);
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1) {
    const float om = __shfl_xor_sync(0xffffffffu, mx, off);
    const float os = __shfl_xor_sync(0xffffffffu, sum, off);
    const float m = fmaxf(mx, om);
    sum = (mx == -INFINITY ? 0.f : sum * expf(mx - m))
        + (om == -INFINITY ? 0.f : os * expf(om - m));
    mx = m;
  }
#pragma unroll
  for (int i = 0; i < NV; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) e[i][j] = expf(e[i][j] - mx);
#else
  mx = group_max<G>(mx);
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < NV; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      e[i][j] = expf(e[i][j] - mx);
      sum += e[i][j];
    }
  sum = group_sum<G>(sum);
#endif
  return sum;
}

// p = softmax of one row (pads: p = 0).  The backward calls it, and the
// forward divides as it does, so the backward's p has the forward's bits.
template <int G, int NV, int VEC>
__device__ __forceinline__ void row_softmax(const float* __restrict__ x,
                                            int E, int g, float (&p)[NV][4]) {
  const float sum = row_exp<G, NV, VEC>(x, E, g, p);
#pragma unroll
  for (int i = 0; i < NV; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) p[i][j] = p[i][j] / sum;
}

// The best K <= 2 keys of (v, expert) over the group, in order: each
// lane's best two, then a tree whose levels merge two sorted pairs.
template <int G, int NV, int K>
__device__ __forceinline__ void top2(const float (&v)[NV][4], int g, u64& k1,
                                     u64& k2) {
  k1 = k2 = 0;
#pragma unroll
  for (int i = 0; i < NV; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const u64 kk = key(v[i][j], expert<G>(g, i, j));
      if constexpr (K == 2) k2 = umax(k2, umin(k1, kk));
      k1 = umax(k1, kk);
    }
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1) {
    const u64 o1 = __shfl_xor_sync(0xffffffffu, k1, off);
    if constexpr (K == 2) {
      const u64 o2 = __shfl_xor_sync(0xffffffffu, k2, off);
      k2 = umax(umin(k1, o1), umax(k2, o2));
    }
    k1 = umax(k1, o1);
  }
}

// K = 1 or 2: the top-2 tree; K = 0: k passes (2 < k <= 32).
template <int G, int NV, int VEC, int K>
__global__ void __launch_bounds__(kThreads)
topk_gating_rows(const float* __restrict__ logits, float* __restrict__ probs,
                 int* __restrict__ idx, int T, int E, int k) {
  const int g = threadIdx.x % G;
  const int row0 = blockIdx.x * (kThreads / G) + threadIdx.x / G;
  const int row = min(row0, T - 1);          // whole groups shuffle
  const bool writer = g == 0 && row0 < T;

  if constexpr (K == 1 || K == 2) {
    // The picks by e, then p = e / sum for the picks alone.  p is e over
    // one sum, so it never ranks below a smaller e, and two p are equal
    // only where their e lie within 2^-22 of each other (while p is not
    // subnormal).  So the picks by p equal those by e unless the two
    // picks' e differ but are that close (their p may tie, and then the
    // lower index and any expert tied with it go first), or an expert
    // outside them has an e that close below the last pick's (it may win
    // on its index), or the last pick is tiny.  Equal e are no risk: the
    // tree has already put the lower index first.  A warp where any
    // group meets one divides every e and picks by p.
    float e[NV][4];
    const float sum = row_exp<G, NV, VEC>(logits + (long long)row * E, E,
                                          g, e);
    u64 k1, k2;
    top2<G, NV, K>(e, g, k1, k2);
    const float e1 = key_p(k1), eK = key_p(K == 2 ? k2 : k1);
    const float lo = eK * (1.f - 0x1p-20f);
    bool near = !(eK >= 0x1p-100f)
        || (K == 2 && eK < e1 && eK >= e1 * (1.f - 0x1p-20f));
#pragma unroll
    for (int i = 0; i < NV; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) near |= e[i][j] >= lo && e[i][j] < eK;
#ifdef MOE_GATING_PSELECT
    near = true;                  // always by p
#endif
    if (__any_sync(0xffffffffu, near)) {
#pragma unroll
      for (int i = 0; i < NV; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) e[i][j] = e[i][j] / sum;
      top2<G, NV, K>(e, g, k1, k2);
    } else {
      k1 = key(key_p(k1) / sum, key_e(k1));
      if constexpr (K == 2) k2 = key(key_p(k2) / sum, key_e(k2));
    }
    if (writer) {
      const float p1 = key_p(k1);
      if constexpr (K == 1) {
        probs[row] = p1 / p1;
        idx[row] = key_e(k1);
      } else {
        const float p2 = key_p(k2), tot = p1 + p2;
        *reinterpret_cast<float2*>(probs + 2LL * row) =
            make_float2(p1 / tot, p2 / tot);
        *reinterpret_cast<int2*>(idx + 2LL * row) =
            make_int2(key_e(k1), key_e(k2));
      }
    }
  } else {
    float p[NV][4];
    row_softmax<G, NV, VEC>(logits + (long long)row * E, E, g, p);
    u64 keys[NV][4];
#pragma unroll
    for (int i = 0; i < NV; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) keys[i][j] = key(p[i][j], expert<G>(g, i, j));
    float* pr = probs + (long long)row * k;
    int* ir = idx + (long long)row * k;
    float tot = 0.f;
    for (int t = 0; t < k; ++t) {
      u64 b = 0;
#pragma unroll
      for (int i = 0; i < NV; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) b = umax(b, keys[i][j]);
#pragma unroll
      for (int off = G / 2; off > 0; off >>= 1)
        b = umax(b, __shfl_xor_sync(0xffffffffu, b, off));
#pragma unroll
      for (int i = 0; i < NV; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (keys[i][j] == b) keys[i][j] = 0;    // taken
      const float pt = key_p(b);
      if (writer) { pr[t] = pt; ir[t] = key_e(b); }
      tot += pt;
    }
    if (writer)
      for (int t = 0; t < k; ++t) pr[t] = pr[t] / tot;
  }
}

// dlogits of one row a group; the forward's softmax, recomputed.
template <int G, int NV, int VEC, int K>
__global__ void __launch_bounds__(kThreads)
topk_gating_bwd_rows(const float* __restrict__ logits,
                     const float* __restrict__ probs,
                     const int* __restrict__ idx,
                     const float* __restrict__ dprobs,
                     float* __restrict__ dlogits, int T, int E, int k) {
  constexpr int KA = K ? K : kMaxK;
  const int kk = K ? K : k;
  const int g = threadIdx.x % G;
  const int row0 = blockIdx.x * (kThreads / G) + threadIdx.x / G;
  const int row = min(row0, T - 1);          // whole groups shuffle
  const int base = (threadIdx.x & 31) - g;   // the group's first lane
  float p[NV][4];
  row_softmax<G, NV, VEC>(logits + (long long)row * E, E, g, p);

  // the row's picks, read by every lane of the group; the dot in pick
  // order
  int ej[KA];
  float dj[KA];
  float dot = 0.f;
  const long long pk = (long long)row * kk;
  if constexpr (VEC && K == 2) {
    const int2 e2 = *reinterpret_cast<const int2*>(idx + pk);
    const float2 q2 = *reinterpret_cast<const float2*>(probs + pk);
    const float2 d2 = *reinterpret_cast<const float2*>(dprobs + pk);
    ej[0] = e2.x; ej[1] = e2.y;
    dj[0] = d2.x; dj[1] = d2.y;
    dot = fmaf(q2.y, d2.y, fmaf(q2.x, d2.x, 0.f));
  } else {
#pragma unroll
    for (int j = 0; j < KA; ++j) {
      if (j >= kk) break;
      ej[j] = idx[pk + j];
      dj[j] = dprobs[pk + j];
      dot = fmaf(probs[pk + j], dj[j], dot);
    }
  }
  // each picked p from the lane that holds it; s in pick order
  float pj[KA];
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < KA; ++j) {
    if (j >= kk) break;
    float mine = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
        if (expert<G>(g, i, jj) == ej[j]) mine = p[i][jj];
    pj[j] = __shfl_sync(0xffffffffu, mine, base + ((ej[j] >> 2) & (G - 1)));
    s += pj[j];
  }
  float pdp = 0.f;                           // dj becomes dp at idx_j
#pragma unroll
  for (int j = 0; j < KA; ++j) {
    if (j >= kk) break;
    dj[j] = (dj[j] - dot) / s;
    pdp = fmaf(pj[j], dj[j], pdp);
  }
  if (row0 >= T) return;
  float* out = dlogits + (long long)row * E;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    float o[4];
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int e = expert<G>(g, i, jj);
      float dp = 0.f;
#pragma unroll
      for (int j = 0; j < KA; ++j) {
        if (j >= kk) break;
        if (ej[j] == e) dp = dj[j];
      }
      o[jj] = p[i][jj] * (dp - pdp);
    }
    const int c = g + G * i;
    if (VEC) {
      if (4 * c < E)
        reinterpret_cast<float4*>(out)[c] = make_float4(o[0], o[1], o[2],
                                                        o[3]);
    } else {
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
        if (4 * c + jj < E) out[4 * c + jj] = o[jj];
    }
  }
}

template <int G, int NV, int VEC>
cudaError_t launch_fwd(const float* logits, float* probs, int* idx, int T,
                       int E, int k, cudaStream_t stream) {
  static_assert(32 % G == 0 && kThreads % 32 == 0, "a group within a warp");
  const int blocks = (T + kThreads / G - 1) / (kThreads / G);
  if (k == 1)
    topk_gating_rows<G, NV, VEC, 1><<<blocks, kThreads, 0, stream>>>(
        logits, probs, idx, T, E, k);
  else if (k == 2)
    topk_gating_rows<G, NV, VEC, 2><<<blocks, kThreads, 0, stream>>>(
        logits, probs, idx, T, E, k);
  else
    topk_gating_rows<G, NV, VEC, 0><<<blocks, kThreads, 0, stream>>>(
        logits, probs, idx, T, E, k);
  return cudaGetLastError();
}

template <int G, int NV, int VEC>
cudaError_t launch_bwd(const float* logits, const float* probs,
                       const int* idx, const float* dprobs, float* dlogits,
                       int T, int E, int k, cudaStream_t stream) {
  const int blocks = (T + kThreads / G - 1) / (kThreads / G);
  if (k == 1)
    topk_gating_bwd_rows<G, NV, VEC, 1><<<blocks, kThreads, 0, stream>>>(
        logits, probs, idx, dprobs, dlogits, T, E, k);
  else if (k == 2)
    topk_gating_bwd_rows<G, NV, VEC, 2><<<blocks, kThreads, 0, stream>>>(
        logits, probs, idx, dprobs, dlogits, T, E, k);
  else
    topk_gating_bwd_rows<G, NV, VEC, 0><<<blocks, kThreads, 0, stream>>>(
        logits, probs, idx, dprobs, dlogits, T, E, k);
  return cudaGetLastError();
}

// The (G, NV) of E's bucket, then the route: F(G, NV, VEC).
#define MOE_GATING_DISPATCH(E, vec, F)                                      \
  ((E) <= 16 ? ((vec) ? F(MOE_GATING_G16, 4 / MOE_GATING_G16, 1)          \
                      : F(MOE_GATING_G16, 4 / MOE_GATING_G16, 0))         \
   : (E) <= 32 ? ((vec) ? F(8, 1, 1) : F(8, 1, 0))                          \
   : (E) <= 64 ? ((vec) ? F(8, 2, 1) : F(8, 2, 0))                          \
   : ((vec) ? F(MOE_GATING_G128, 32 / MOE_GATING_G128, 1)                  \
            : F(MOE_GATING_G128, 32 / MOE_GATING_G128, 0)))

bool aligned(const void* ptr, int bytes) {
  return reinterpret_cast<uintptr_t>(ptr) % bytes == 0;
}

}  // namespace

extern "C" {

// logits (T, E) f32 contiguous -> probs (T, k) f32, idx (T, k) int32
// (fresh, so 8-byte aligned rows at k = 2).  1 <= k <= min(E, 32),
// E <= 128; vector != 0 takes 16-byte loads, and needs E % 4 == 0 and a
// 16-byte-aligned base (kernels/moe_gating.py::route).
int topk_gating_launch(const void* logits, void* probs, void* idx, int T,
                       int E, int k, int vector, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* x = static_cast<const float*>(logits);
  float* p = static_cast<float*>(probs);
  int* i = static_cast<int*>(idx);
  if (T < 1 || k < 1 || k > E || k > kMaxK || E > 128)
    return cudaErrorInvalidValue;
  if (vector && (E % 4 || !aligned(x, 16))) return cudaErrorMisalignedAddress;
#define MOE_GATING_FWD(G, NV, VEC) launch_fwd<G, NV, VEC>(x, p, i, T, E, k, s)
  return MOE_GATING_DISPATCH(E, vector, MOE_GATING_FWD);
#undef MOE_GATING_FWD
}

// logits (T, E), probs and dprobs (T, k) f32, idx (T, k) int32, all
// contiguous (the forward's outputs) -> dlogits (T, E) f32.  The same
// limits as the forward; vector != 0 also needs dlogits 16-byte aligned
// and, at k = 2, idx, probs and dprobs 8-byte aligned.
int topk_gating_bwd_launch(const void* logits, const void* probs,
                           const void* idx, const void* dprobs,
                           void* dlogits, int T, int E, int k, int vector,
                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* x = static_cast<const float*>(logits);
  const float* p = static_cast<const float*>(probs);
  const int* i = static_cast<const int*>(idx);
  const float* d = static_cast<const float*>(dprobs);
  float* g = static_cast<float*>(dlogits);
  if (T < 1 || k < 1 || k > E || k > kMaxK || E > 128)
    return cudaErrorInvalidValue;
  if (vector && (E % 4 || !aligned(x, 16) || !aligned(g, 16)
                 || (k == 2 && !(aligned(p, 8) && aligned(i, 8)
                                 && aligned(d, 8)))))
    return cudaErrorMisalignedAddress;
#define MOE_GATING_BWD(G, NV, VEC) \
  launch_bwd<G, NV, VEC>(x, p, i, d, g, T, E, k, s)
  return MOE_GATING_DISPATCH(E, vector, MOE_GATING_BWD);
#undef MOE_GATING_BWD
}

const char* moe_gating_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
