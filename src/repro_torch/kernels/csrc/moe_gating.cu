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
// Built by nvcc for sm_90a into a shared library with a plain C interface
// (repro_torch/kernels/_build.py); the entry point returns
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

const char* moe_gating_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
