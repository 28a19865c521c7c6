// Flash attention forward for Hopper: online softmax over streamed K/V tiles.
//
// Replaces the Pallas kernel src/repro/kernels/flash_attention.py::
// flash_attention (_flash_kernel).  It computes what that kernel computes:
// out[b, h, i] = softmax_j(scale * q[b, h, i] . k[b, h / G, j]) v[b, h / G, j]
// over the keys j that query i sees, with
//   * GQA by index: query head h reads kv head h / G, G = Hq / Hkv, and no
//     repeated K/V is made in memory;
//   * q the suffix of the kv timeline: query row i sits at absolute
//     position i + (Skv - Sq), so prefill and decode-shaped calls mask
//     alike; causal sees j <= pos, a window sees pos - j < window;
//   * f32 math on bf16 or f32 inputs, the output in the input type;
//   * a row that sees no key writes 0 (the TPU kernel's lsum == 0 guard).
//
// Bound: at the prefill shapes (Sq = Skv = 1024, D = 128, causal) the
// function needs 4*B*Hq*D*Sq(Sq+1)/2 operations on 2*(B*Hq + 2*B*Hkv)*S*D
// bytes, far above the card's ridge: it is bound by operations.  This
// first kernel keeps both products on the FP32 cores (f32 math, as the
// plain version), so its bound here is the FP32 rate, not the tensor
// cores'.
//
// Design: one block of 256 threads per (q tile of 64 rows, query head,
// batch); the TPU's sequential kv grid axis becomes a loop inside the
// block.  The block converts its Q tile to f32 (pre-scaled) in shared
// memory once, then streams 64-key K and V tiles through shared memory.
// Thread (ty, tx) owns 4 query rows (4ty..4ty+3) and, of the 64x64 score
// tile, the 4 columns tx + 16j; the 16 threads of a row group reduce the
// row max and sum by warp shuffles and keep the running (m, l) of their
// rows in registers, and each accumulates its 4 rows of the output in the
// columns tx + 16j.  Shared rows are padded by one float so the column
// reads of K hit 16 different banks; at D = 128 a block takes 113 KB, so
// two blocks share an SM.  Tiles wholly outside the causal /
// window mask are never loaded: the loop runs over the visible kv tiles
// only, and blocks start with the heaviest (last) q tiles.  No atomics:
// two launches give the same bits.
//
// Built by nvcc for sm_90a into a shared library with a plain C interface
// (repro_torch/kernels/_build.py); the entry point returns
// cudaGetLastError() so the Python wrapper raises on a refused launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // keys per streamed tile
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

struct Strides {            // in elements; the head_dim stride is 1
  long long b, h, s;
};

static_assert(kBQ == kBK, "load_tile moves 64-row tiles of Q, K and V");

// Load rows [row0, row0 + 64) of one (b, h) slice into an f32 tile with
// rows of LD floats; rows past `rows` and columns past D are zero.
template <typename T, int DP, int LD>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src,
                                          Strides st, int row0, int rows,
                                          int D, float mul) {
  for (int idx = threadIdx.x; idx < kBK * DP; idx += kThreads) {
    const int r = idx / DP;
    const int c = idx % DP;
    const int row = row0 + r;
    float x = 0.f;
    if (row < rows && c < D) x = to_f32(src[(long long)row * st.s + c]) * mul;
    dst[r * LD + c] = x;
  }
}

// Shared memory of one block, in floats: Q and K rows padded by one float
// (their columns are read across threads), V and P rows read along.
template <int DP>
constexpr int smem_floats() {
  return (kBQ + kBK) * (DP + 1) + kBK * DP + kBQ * (kBK + 1);
}

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ o, Strides qs, Strides ks,
          Strides vs, Strides os, int G, int Sq, int Skv, int D, int causal,
          int window, float scale) {
  constexpr int NJ = DP / 16;                  // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;                            // [kBQ][DP + 1]
  float* Ks = Qs + kBQ * (DP + 1);             // [kBK][DP + 1]
  float* Vs = Ks + kBK * (DP + 1);             // [kBK][DP]
  float* Ps = Vs + kBK * DP;                   // [kBQ][kBK + 1]

  const int qt = gridDim.x - 1 - blockIdx.x;   // heaviest tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / G;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int q0 = qt * kBQ;
  const int offs = Skv - Sq;

  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + hk * ks.h;
  const T* vb = v + b * vs.b + hk * vs.h;
  load_tile<T, DP, DP + 1>(Qs, qb, qs, q0, Sq, D, scale);

  // the kv tiles any row of this q tile sees
  const int q_lo = q0 + offs;                  // absolute position, row 0
  const int q_hi = q_lo + kBQ - 1;
  const int nkt = (Skv + kBK - 1) / kBK;
  int kt_end = nkt;
  if (causal) kt_end = q_hi < 0 ? 0 : min(nkt, q_hi / kBK + 1);
  int kt_begin = 0;
  if (window > 0) {
    const int lo = q_lo - window + 1;          // first key row 0 sees
    if (lo > 0) kt_begin = lo / kBK;
  }

  float m[4], l[4], acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  }

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();                           // previous tile consumed
    load_tile<T, DP, DP + 1>(Ks, kb, ks, k0, Skv, D, 1.f);
    load_tile<T, DP, DP>(Vs, vb, vs, k0, Skv, D, 1.f);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < DP; ++d) {
      float a[4], c[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Qs[(4 * ty + i) * (DP + 1) + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) c[j] = Ks[(tx + 16 * j) * (DP + 1) + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], c[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + 4 * ty + i + offs;
      bool vis[4];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = k0 + tx + 16 * j;
        vis[j] = key < Skv && (!causal || key <= qpos) &&
                 (window <= 0 || qpos - key < window);
        if (!vis[j]) s[i][j] = kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = vis[j] ? __expf(s[i][j] - m_new) : 0.f;
        Ps[(4 * ty + i) * (kBK + 1) + tx + 16 * j] = p;
        rs += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      const float alpha = __expf(m[i] - m_new);
      l[i] = alpha * l[i] + rs;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();                           // P tile complete

#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = Ps[(4 * ty + i) * (kBK + 1) + kk];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float x = Vs[kk * DP + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(p[i], x, acc[i][j]);
      }
    }
  }

  T* ob = o + b * os.b + h * os.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * ty + i;
    if (row >= Sq) continue;
    const float inv = l[i] > 0.f ? 1.f / l[i] : 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = tx + 16 * j;
      if (c < D) ob[(long long)row * os.s + c] = from_f32<T>(acc[i][j] * inv);
    }
  }
}

template <typename T, int DP>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int Hq, int Hkv, int Sq, int Skv, int D,
                   const long long* st, int causal, int window, float scale,
                   cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats<DP>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd<T, DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + kBQ - 1) / kBQ, Hq, B);
  flash_fwd<T, DP><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o),
      Strides{st[0], st[1], st[2]}, Strides{st[3], st[4], st[5]},
      Strides{st[6], st[7], st[8]}, Strides{st[9], st[10], st[11]},
      Hq / Hkv, Sq, Skv, D, causal, window, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const void* q, const void* k, const void* v, void* o,
                       int B, int Hq, int Hkv, int Sq, int Skv, int D,
                       const long long* st, int causal, int window,
                       float scale, cudaStream_t stream) {
  if (D <= 64)
    return launch<T, 64>(q, k, v, o, B, Hq, Hkv, Sq, Skv, D, st, causal,
                         window, scale, stream);
  if (D <= 128)
    return launch<T, 128>(q, k, v, o, B, Hq, Hkv, Sq, Skv, D, st, causal,
                          window, scale, stream);
  return launch<T, 256>(q, k, v, o, B, Hq, Hkv, Sq, Skv, D, st, causal,
                        window, scale, stream);
}

}  // namespace

extern "C" {

// q, o: (B, Hq, Sq, D); k, v: (B, Hkv, Skv, D), each with the head_dim
// stride 1 and the (batch, head, seq) strides in `strides` (12 values in
// elements: q, k, v, o).  dtype 0 = float32, 1 = bfloat16.  window <= 0
// means no window.  D <= 256, Hq % Hkv == 0; the wrapper checks both.
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* o, int dtype, int B, int Hq, int Hkv, int Sq,
                           int Skv, int D, const long long* strides,
                           int causal, int window, float scale,
                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D < 1 || D > 256 || Hkv < 1 || Hq % Hkv) return cudaErrorInvalidValue;
  if (dtype == 0)
    return dispatch_d<float>(q, k, v, o, B, Hq, Hkv, Sq, Skv, D, strides,
                             causal, window, scale, s);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(q, k, v, o, B, Hq, Hkv, Sq, Skv, D,
                                     strides, causal, window, scale, s);
  return cudaErrorInvalidValue;
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
