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
// card's memory rate, so in practice the launch sets its time.
// Design: one warp per token row, all E logits in registers (lane l holds
// experts l, l + 32, ...: E <= 32 * PER_LANE, PER_LANE in {1, 2, 4}, so E
// up to 128 as llama4 needs).  Max and sum are warp shuffle reductions;
// each of the k argmaxes reduces (value, index) pairs across the warp, the
// larger value winning and, on a tie, the lower index, so idx equals the
// plain version's exactly.  exp is expf, as in PyTorch's softmax, so the
// exponentials, and with them the order of the probabilities, are the
// same.  Lane i < k writes the i-th pick.  No atomics.
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
// under the launch floor.  Design: one warp a row as the forward; the
// row's softmax is recomputed from the logits with the forward's code
// (the same bits); lane j < k holds pick j and broadcasts it; the two
// sums over the row are warp shuffle reductions in a fixed order.  No
// atomics: two launches give the same bits.
//
// Built by nvcc for sm_90a into a shared library with a plain C interface
// (repro_torch/kernels/_build.py); the entry points return
// cudaGetLastError() so the Python wrapper raises on a refused launch.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

template <int PER_LANE>
__global__ void __launch_bounds__(kThreads)
topk_gating_rows(const float* __restrict__ logits, float* __restrict__ probs,
                 int* __restrict__ idx, int T, int E, int k) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= T) return;                        // whole warps leave together
  const float* x = logits + (long long)row * E;

  float p[PER_LANE];
  float mx = -INFINITY;
#pragma unroll
  for (int i = 0; i < PER_LANE; ++i) {
    const int e = lane + 32 * i;
    p[i] = e < E ? x[e] : -INFINITY;
    mx = fmaxf(mx, p[i]);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < PER_LANE; ++i) {
    p[i] = lane + 32 * i < E ? expf(p[i] - mx) : 0.f;
    sum += p[i];
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    sum += __shfl_xor_sync(0xffffffffu, sum, off);
#pragma unroll
  for (int i = 0; i < PER_LANE; ++i)
    p[i] = lane + 32 * i < E ? p[i] / sum : -INFINITY;   // pads never win

  float mine_p = 0.f, tot = 0.f;
  int mine_i = 0;
  for (int t = 0; t < k; ++t) {
    float bv = -INFINITY;
    int bi = 0x7fffffff;
#pragma unroll
    for (int i = 0; i < PER_LANE; ++i)       // experts rise with i
      if (p[i] > bv) { bv = p[i]; bi = lane + 32 * i; }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
      if (ov > bv || (ov == bv && oi < bi)) { bv = ov; bi = oi; }
    }
#pragma unroll
    for (int i = 0; i < PER_LANE; ++i)
      if (lane + 32 * i == bi) p[i] = -1.f;
    if (lane == t) { mine_p = bv; mine_i = bi; }
    tot += bv;
  }
  if (lane < k) {
    probs[(long long)row * k + lane] = mine_p / tot;
    idx[(long long)row * k + lane] = mine_i;
  }
}

// dlogits of one row a warp; the forward's softmax, recomputed.
template <int PER_LANE>
__global__ void __launch_bounds__(kThreads)
topk_gating_bwd_rows(const float* __restrict__ logits,
                     const float* __restrict__ probs,
                     const int* __restrict__ idx,
                     const float* __restrict__ dprobs,
                     float* __restrict__ dlogits, int T, int E, int k) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= T) return;                        // whole warps leave together
  const float* x = logits + (long long)row * E;

  float p[PER_LANE];
  float mx = -INFINITY;
#pragma unroll
  for (int i = 0; i < PER_LANE; ++i) {
    const int e = lane + 32 * i;
    p[i] = e < E ? x[e] : -INFINITY;
    mx = fmaxf(mx, p[i]);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < PER_LANE; ++i) {
    p[i] = lane + 32 * i < E ? expf(p[i] - mx) : 0.f;
    sum += p[i];
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    sum += __shfl_xor_sync(0xffffffffu, sum, off);
#pragma unroll
  for (int i = 0; i < PER_LANE; ++i)
    p[i] = lane + 32 * i < E ? p[i] / sum : 0.f;

  // lane j < k holds pick j
  const long long pk = (long long)row * k + lane;
  const int my_e = lane < k ? idx[pk] : -1;
  const float my_d = lane < k ? dprobs[pk] : 0.f;
  float dot = lane < k ? probs[pk] * my_d : 0.f;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    dot += __shfl_xor_sync(0xffffffffu, dot, off);
  float dp[PER_LANE];
  bool sel[PER_LANE];
#pragma unroll
  for (int i = 0; i < PER_LANE; ++i) { dp[i] = 0.f; sel[i] = false; }
  float s = 0.f;
  for (int j = 0; j < k; ++j) {
    const int e = __shfl_sync(0xffffffffu, my_e, j);
    const float d = __shfl_sync(0xffffffffu, my_d, j);
    float pe = 0.f;
#pragma unroll
    for (int i = 0; i < PER_LANE; ++i)
      if (lane + 32 * i == e) { pe = p[i]; dp[i] = d; sel[i] = true; }
    s += __shfl_sync(0xffffffffu, pe, e & 31);     // in pick order
  }
  float pdp = 0.f;
#pragma unroll
  for (int i = 0; i < PER_LANE; ++i) {
    dp[i] = sel[i] ? (dp[i] - dot) / s : 0.f;
    pdp = fmaf(p[i], dp[i], pdp);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    pdp += __shfl_xor_sync(0xffffffffu, pdp, off);
  float* out = dlogits + (long long)row * E;
#pragma unroll
  for (int i = 0; i < PER_LANE; ++i) {
    const int e = lane + 32 * i;
    if (e < E) out[e] = p[i] * (dp[i] - pdp);
  }
}

template <int PER_LANE>
cudaError_t launch_bwd(const float* logits, const float* probs,
                       const int* idx, const float* dprobs, float* dlogits,
                       int T, int E, int k, cudaStream_t stream) {
  const int blocks = (T + kWarps - 1) / kWarps;
  topk_gating_bwd_rows<PER_LANE><<<blocks, kThreads, 0, stream>>>(
      logits, probs, idx, dprobs, dlogits, T, E, k);
  return cudaGetLastError();
}

template <int PER_LANE>
cudaError_t launch(const float* logits, float* probs, int* idx, int T, int E,
                   int k, cudaStream_t stream) {
  const int blocks = (T + kWarps - 1) / kWarps;
  topk_gating_rows<PER_LANE><<<blocks, kThreads, 0, stream>>>(
      logits, probs, idx, T, E, k);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// logits (T, E) f32 contiguous -> probs (T, k) f32, idx (T, k) int32.
// 1 <= k <= min(E, 32), E <= 128; the wrapper checks both.
int topk_gating_launch(const void* logits, void* probs, void* idx, int T,
                       int E, int k, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* x = static_cast<const float*>(logits);
  float* p = static_cast<float*>(probs);
  int* i = static_cast<int*>(idx);
  if (k < 1 || k > E || k > 32 || E > 128) return cudaErrorInvalidValue;
  if (E <= 32) return launch<1>(x, p, i, T, E, k, s);
  if (E <= 64) return launch<2>(x, p, i, T, E, k, s);
  return launch<4>(x, p, i, T, E, k, s);
}

// logits (T, E), probs and dprobs (T, k) f32, idx (T, k) int32, all
// contiguous (the forward's outputs) -> dlogits (T, E) f32.  The same
// limits as the forward.
int topk_gating_bwd_launch(const void* logits, const void* probs,
                           const void* idx, const void* dprobs,
                           void* dlogits, int T, int E, int k, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* x = static_cast<const float*>(logits);
  const float* p = static_cast<const float*>(probs);
  const int* i = static_cast<const int*>(idx);
  const float* d = static_cast<const float*>(dprobs);
  float* g = static_cast<float*>(dlogits);
  if (k < 1 || k > E || k > 32 || E > 128) return cudaErrorInvalidValue;
  if (E <= 32) return launch_bwd<1>(x, p, i, d, g, T, E, k, s);
  if (E <= 64) return launch_bwd<2>(x, p, i, d, g, T, E, k, s);
  return launch_bwd<4>(x, p, i, d, g, T, E, k, s);
}

const char* moe_gating_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
