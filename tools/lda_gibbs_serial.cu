// The serial design of the collapsed Gibbs sweep, kept to be timed beside
// the port's pipelined kernel (src/repro_torch/kernels/csrc/lda_gibbs.cu)
// by tools/lda_gibbs_designs.py.  Same semantics and launch interface
// (without the threads and ring-depth arguments), same bits.
//
// One block of 256 threads a worker walks its active tokens: the next
// token's ids are loaded a step ahead, its B and D rows only after the
// current token's update; every thread computes its topics' logits (Philox
// and four full-precision logf a topic) after the previous decision; the
// warps' bests meet in shared memory, thread 0 reduces them, writes B, D,
// z and s~, and a second barrier releases the block.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint2 k) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k.x += 0x9E3779B9u;
      k.y += 0xBB67AE85u;
    }
    const unsigned lo0 = 0xD2511F53u * c.x;
    const unsigned hi0 = __umulhi(0xD2511F53u, c.x);
    const unsigned lo1 = 0xCD9E8D57u * c.z;
    const unsigned hi1 = __umulhi(0xCD9E8D57u, c.z);
    c = make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
  }
  return c;
}

// u = (2 (x >> 9) + 1) 2^-24 in (0, 1), exact in f32; g = -log(-log u)
__device__ __forceinline__ float gumbel_of(unsigned x) {
  const float u = (float)(((x >> 9) << 1) | 1u) * 0x1p-24f;
  return -logf(-logf(u));
}

__device__ __forceinline__ void philox_gumbel4(float g[4], int chunk,
                                               int slot, int p, int phase,
                                               unsigned long long seed) {
  const uint4 w = philox4x32_10(
      make_uint4((unsigned)chunk, (unsigned)slot, (unsigned)p,
                 (unsigned)phase),
      make_uint2((unsigned)(seed & 0xFFFFFFFFull), (unsigned)(seed >> 32)));
  g[0] = gumbel_of(w.x);
  g[1] = gumbel_of(w.y);
  g[2] = gumbel_of(w.z);
  g[3] = gumbel_of(w.w);
}

// (val, idx) pair order of jnp.argmax: larger value, then lower index
__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

__global__ void __launch_bounds__(kThreads)
lda_gibbs_kernel(const int* __restrict__ words, const int* __restrict__ docs,
                 int* __restrict__ z, const int* __restrict__ order,
                 const int* __restrict__ offsets, float* B, float* D,
                 const float* __restrict__ s, float* __restrict__ s_tilde,
                 const float* __restrict__ gumbel, int T, int K, int n_blocks,
                 int rotate, int block_vocab, long long slab_floats, int dpw,
                 int phase, int L, float vg, float alpha, float gamma,
                 unsigned long long seed) {
  extern __shared__ float smem[];
  float* st = smem;                       // s~ (K)
  float* ls = smem + K;                   // logf(vg + s~) (K)
  __shared__ float red_v[kWarps];
  __shared__ int red_i[kWarps];

  const int p = blockIdx.x;
  const int tid = threadIdx.x;
  const int block = (p + phase) % n_blocks;
  const long long slab = rotate ? block : p;
  const int* op = order + (long long)p * T;
  const int start = offsets[(long long)p * (n_blocks + 1) + block];
  const int count = offsets[(long long)p * (n_blocks + 1) + block + 1] - start;
  float* Bp = B + slab * slab_floats;
  float* Dp = D + (long long)p * dpw * K;
  const int* wp = words + (long long)p * T;
  const int* dp = docs + (long long)p * T;
  int* zp = z + (long long)p * T;
  const int vbase = block * block_vocab;
  const int chunks = (K + 3) >> 2;

  for (int k = tid; k < K; k += kThreads) {
    st[k] = s[k];
    ls[k] = logf(vg + s[k]);
  }
  __syncthreads();

  // the first token's ids; each later token's are loaded a step ahead
  int slot = 0, v = 0, d = 0, zi = 0;
  if (count > 0) {
    slot = op[start];
    v = wp[slot] - vbase;
    d = dp[slot];
    zi = zp[slot];
  }
  for (int j = 0; j < count; ++j) {
    int nslot = 0, nv = 0, nd = 0, nzi = 0;
    if (j + 1 < count) {
      nslot = op[start + j + 1];
      nv = wp[nslot] - vbase;
      nd = dp[nslot];
      nzi = zp[nslot];
    }
    const float* brow = Bp + (long long)v * K;
    const float* drow = Dp + (long long)d * K;
    const float* grow = gumbel ? gumbel + ((long long)p * L + j) * K : nullptr;
    float best = -INFINITY;
    int bestk = K;
    for (int c = tid; c < chunks; c += kThreads) {
      float g[4];
      if (grow) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          g[e] = (4 * c + e < K) ? grow[4 * c + e] : 0.f;
      } else {
        philox_gumbel4(g, c, slot, p, phase, seed);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int k = 4 * c + e;
        if (k < K) {
          const float a = (k == zi) ? 1.f : 0.f;
          const float lsk = (k == zi) ? logf(vg + (st[k] - 1.f)) : ls[k];
          const float logit = (logf(gamma + (brow[k] - a)) - lsk) +
                              logf(alpha + (drow[k] - a));
          const float x = g[e] + logit;
          if (better(x, k, best, bestk)) {
            best = x;
            bestk = k;
          }
        }
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_down_sync(0xFFFFFFFFu, best, off);
      const int oi = __shfl_down_sync(0xFFFFFFFFu, bestk, off);
      if (better(ov, oi, best, bestk)) {
        best = ov;
        bestk = oi;
      }
    }
    if ((tid & 31) == 0) {
      red_v[tid >> 5] = best;
      red_i[tid >> 5] = bestk;
    }
    __syncthreads();
    if (tid == 0) {
      best = red_v[0];
      bestk = red_i[0];
      for (int w = 1; w < kWarps; ++w)
        if (better(red_v[w], red_i[w], best, bestk)) {
          best = red_v[w];
          bestk = red_i[w];
        }
      const int zn = bestk < K ? bestk : 0;
      if (zn != zi) {
        float* bw = Bp + (long long)v * K;
        float* dw = Dp + (long long)d * K;
        bw[zi] -= 1.f;
        bw[zn] += 1.f;
        dw[zi] -= 1.f;
        dw[zn] += 1.f;
        st[zi] -= 1.f;
        st[zn] += 1.f;
        ls[zi] = logf(vg + st[zi]);
        ls[zn] = logf(vg + st[zn]);
      }
      zp[slot] = zn;
    }
    __syncthreads();
    slot = nslot;
    v = nv;
    d = nd;
    zi = nzi;
  }
  for (int k = tid; k < K; k += kThreads) s_tilde[(long long)p * K + k] = st[k];
}

}  // namespace

extern "C" {

int lda_gibbs_launch(const int* words, const int* docs, int* z,
                     const int* order, const int* offsets, float* B, float* D,
                     const float* s, float* s_tilde, const float* gumbel, int P,
                     int T, int K, int n_blocks, int rotate, int block_vocab,
                     long long slab_floats, int dpw, int phase, int L, float vg,
                     float alpha, float gamma, unsigned long long seed,
                     void* stream) {
  const size_t smem = 2 * (size_t)K * sizeof(float);
  static size_t smem_set = 48 * 1024;  // above 48 KB only once raised
  if (smem > smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        lda_gibbs_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    smem_set = smem;
  }
  lda_gibbs_kernel<<<P, kThreads, smem, (cudaStream_t)stream>>>(
      words, docs, z, order, offsets, B, D, s, s_tilde, gumbel, T, K, n_blocks,
      rotate, block_vocab, slab_floats, dpw, phase, L, vg, alpha, gamma, seed);
  return (int)cudaGetLastError();
}

const char* lda_gibbs_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
