// Diagonal selective scan (Mamba2-style SSM) for Hopper.
//
// Replaces the Pallas kernel src/repro/kernels/ssm_scan.py::ssm_scan
// (_ssm_kernel).  It computes what that kernel computes, for every batch
// row b and channel c, over the steps t = 0 .. S-1:
//   h_t = exp(dt_t * A_c) * h_{t-1} + (dt_t * x_t) * B_t      (N values)
//   y_t = <h_t, C_t>_N
// with h_{-1} = h0 (zeros when none is given), all in f32 registers
// whatever the input type; y is stored in x's type, the final h in f32.
//
// Bound: operations.  Each (b, t, c, n) costs one multiply and two FMAs
// (5 operations) on the FP32 cores.  At the prefill shapes of
// Zamba2-2.7B (B 4, S 1,000, C 5,120, N 64) that is 6.6 GFLOP, 98 us at
// the H100 SXM's 67 TFLOP/s, against ~134 MB of inputs and outputs
// (x, dt, y 41 MB each in bf16; B, C 1 MB; h0, h 5.2 MB each), 40 us at
// 3.35 TB/s.
//
// Design: the TPU kernel walked the sequence as a sequential grid axis
// with the (C, N) state tile in VMEM scratch, padded to whole chunks.
// Here nothing carries between blocks, so each block loops over all S
// steps itself, unpadded, and the parallelism is batch x channels: one
// thread owns one (b, c) and keeps its N state values in registers
// (N rounded up to NB in {16, 32, 64}; the padded lanes see B = C = 0 and
// stay 0).  Neighbouring threads take neighbouring channels, so the loads
// of x and dt and the stores of y coalesce along the contiguous last
// axis.  The block stages kT time steps of B_t and C_t, shared by all its
// channels, in shared memory (converted to f32 once); every thread reads
// the same address, a broadcast without bank conflicts.  Each thread
// loads its kT values of x and dt into registers before the tile's
// steps, so the loads are in flight together and not one a step.  y is a
// register sum over n (four partial sums, so the chain of dependent FMAs
// is a quarter as long): no shuffles.  expf, not __expf, as the plain
// version.  No atomics: two launches give the same bits.  Blocks of 64
// threads give 320 blocks at the prefill shapes, ~2.4 per SM.
//
// Built by nvcc for sm_90a into a shared library with a plain C interface
// (repro_torch/kernels/_build.py); the entry point returns
// cudaGetLastError() so the Python wrapper raises on a refused launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 64;   // channels per block
constexpr int kT = 16;         // time steps staged per tile

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

struct Strides {               // in elements; the last axis has stride 1
  long long b, s;
};

template <typename T, int NB>
__global__ void __launch_bounds__(kThreads)
ssm_scan_fwd(const T* __restrict__ x, const T* __restrict__ dt,
             const float* __restrict__ A, const T* __restrict__ Bm,
             const T* __restrict__ Cm, const float* __restrict__ h0,
             T* __restrict__ y, float* __restrict__ hout, Strides sx,
             Strides sdt, Strides sbm, Strides scm, Strides sy, int S, int C,
             int N) {
  __shared__ __align__(16) float sB[kT][NB];
  __shared__ __align__(16) float sC[kT][NB];
  const int b = blockIdx.y;
  const int c = blockIdx.x * kThreads + threadIdx.x;
  const bool live = c < C;
  const long long hrow = ((long long)b * C + c) * N;

  float h[NB];
#pragma unroll
  for (int n = 0; n < NB; ++n)
    h[n] = (live && h0 != nullptr && n < N) ? h0[hrow + n] : 0.f;
  const float a = live ? A[c] : 0.f;
  const T* xb = x + b * sx.b + c;
  const T* db = dt + b * sdt.b + c;
  const T* bb = Bm + b * sbm.b;
  const T* cb = Cm + b * scm.b;
  T* yb = y + b * sy.b + c;

  for (int t0 = 0; t0 < S; t0 += kT) {
    __syncthreads();               // the previous tile's reads are done
    for (int i = threadIdx.x; i < kT * NB; i += kThreads) {
      const int tt = i / NB, n = i % NB, t = t0 + tt;
      const bool ok = t < S && n < N;
      sB[tt][n] = ok ? to_f32(bb[t * sbm.s + n]) : 0.f;
      sC[tt][n] = ok ? to_f32(cb[t * scm.s + n]) : 0.f;
    }
    float xr[kT], dr[kT];
#pragma unroll
    for (int tt = 0; tt < kT; ++tt) {
      const int t = t0 + tt;
      const bool ok = live && t < S;
      xr[tt] = ok ? to_f32(xb[t * sx.s]) : 0.f;
      dr[tt] = ok ? to_f32(db[t * sdt.s]) : 0.f;
    }
    __syncthreads();
    const int steps = min(kT, S - t0);
#pragma unroll
    for (int tt = 0; tt < kT; ++tt) {
      if (tt >= steps) break;
      const float decay = expf(dr[tt] * a);
      const float dx = dr[tt] * xr[tt];
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int n = 0; n < NB; ++n) {
        h[n] = fmaf(decay, h[n], dx * sB[tt][n]);
        acc[n & 3] = fmaf(h[n], sC[tt][n], acc[n & 3]);
      }
      if (live)
        yb[(t0 + tt) * sy.s] = from_f32<T>((acc[0] + acc[1]) +
                                           (acc[2] + acc[3]));
    }
  }
  if (live) {
#pragma unroll
    for (int n = 0; n < NB; ++n)
      if (n < N) hout[hrow + n] = h[n];
  }
}

template <typename T, int NB>
cudaError_t launch(const void* x, const void* dt, const void* A,
                   const void* Bm, const void* Cm, const void* h0, void* y,
                   void* hout, int B, int S, int C, int N,
                   const long long* st, cudaStream_t stream) {
  const dim3 grid((C + kThreads - 1) / kThreads, B);
  ssm_scan_fwd<T, NB><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dt),
      static_cast<const float*>(A), static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), static_cast<const float*>(h0),
      static_cast<T*>(y), static_cast<float*>(hout), Strides{st[0], st[1]},
      Strides{st[2], st[3]}, Strides{st[4], st[5]}, Strides{st[6], st[7]},
      Strides{st[8], st[9]}, S, C, N);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_n(const void* x, const void* dt, const void* A,
                       const void* Bm, const void* Cm, const void* h0,
                       void* y, void* hout, int B, int S, int C, int N,
                       const long long* st, cudaStream_t stream) {
  if (N <= 16)
    return launch<T, 16>(x, dt, A, Bm, Cm, h0, y, hout, B, S, C, N, st,
                         stream);
  if (N <= 32)
    return launch<T, 32>(x, dt, A, Bm, Cm, h0, y, hout, B, S, C, N, st,
                         stream);
  return launch<T, 64>(x, dt, A, Bm, Cm, h0, y, hout, B, S, C, N, st,
                       stream);
}

}  // namespace

extern "C" {

// x, dt, y: (B, S, C); Bm, Cm: (B, S, N), each with the last-axis stride 1
// and the (batch, seq) strides in `strides` (10 values in elements: x, dt,
// Bm, Cm, y).  A: (C,) f32; h0 (may be null: zeros) and hout: (B, C, N)
// f32 contiguous.  dtype 0 = float32, 1 = bfloat16 (x, dt, Bm, Cm, y).
// 1 <= N <= 64 and B <= 65535; the wrapper checks both.
int ssm_scan_launch(const void* x, const void* dt, const void* A,
                    const void* Bm, const void* Cm, const void* h0, void* y,
                    void* hout, int dtype, int B, int S, int C, int N,
                    const long long* strides, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N < 1 || N > 64 || B < 1 || B > 65535 || C < 1 || S < 0)
    return cudaErrorInvalidValue;
  if (dtype == 0)
    return dispatch_n<float>(x, dt, A, Bm, Cm, h0, y, hout, B, S, C, N,
                             strides, s);
  if (dtype == 1)
    return dispatch_n<__nv_bfloat16>(x, dt, A, Bm, Cm, h0, y, hout, B, S, C,
                                     N, strides, s);
  return cudaErrorInvalidValue;
}

const char* ssm_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
