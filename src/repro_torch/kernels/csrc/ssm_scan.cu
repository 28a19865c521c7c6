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
// with the (C, N) state tile in VMEM scratch.  Here nothing carries
// between blocks, so each block loops over all S steps itself, and the
// parallelism is batch x channels x states:
// - kL lanes share one channel, each keeping NB / kL of its states in
//   registers (N rounded up to NB; padded states see B = C = 0 and stay
//   0).  Lane `sub` holds the float4 groups sub, sub + kL, ... of the
//   states, so the kL lanes of a channel read neighbouring 16-byte words
//   of B_t and C_t from shared memory (no bank conflicts; the channels
//   of a warp read the same words, a broadcast).  Each thread takes kCPT
//   channels, so one read of B_t and C_t serves kCPT channels' FMAs.
//   kL = 8, kCPT = 2 and 128 threads (32 channels a block, 640 blocks at
//   the prefill shapes) ran fastest of the splits measured (kL 2 to 16,
//   kCPT 1 to 4, 64 to 256 threads, kT 8 to 32, 2 to 4 stages; see
//   PERF.md).
// - The kT steps of a tile are unrolled, and each lane keeps its partial
//   y_t (four partial sums) in registers; after the tile the kL lanes of
//   a channel reduce them by recursive halving with xor shuffles in a
//   fixed order (log2 kL rounds, kT / 2 + kT / 4 + ... shuffles a channel,
//   not log2 kL a step).  A tile past the end of S runs its spare steps
//   with decay 1 and input 0, which leave h as it is.
// - A block of kThreads takes kCB channels and walks S in tiles of kT
//   steps.  x, dt, B and C of a tile arrive by cp.async (16-byte copies)
//   into a ring of kStages tiles, so tile k+1 loads while tile k runs.
//   A view whose base or strides are not 16-byte aligned, or a ragged
//   edge, takes plain element loads in the same kernel.
// - Before a tile's steps the block computes exp(dt * A) and dt * x of
//   each (step, channel) once (not once a lane) and converts B and C to
//   f32, into shared memory.  y of a tile is staged in shared memory and
//   stored after the tile, each row of kCB channels contiguous.
// expf, not __expf, as the plain version.  No atomics: two launches give
// the same bits.
//
// Built by nvcc for sm_90a into a shared library with a plain C interface
// (repro_torch/kernels/_build.py); the entry point returns
// cudaGetLastError() so the Python wrapper raises on a refused launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr int kL = 8;                  // lanes a channel
constexpr int kCPT = 2;                // channels a thread
constexpr int kSlots = kThreads / kL;  // threads' channel slots a block
constexpr int kCB = kSlots * kCPT;     // channels a block
constexpr int kT = 16;                 // steps a tile
constexpr int kStages = 2;             // tiles in the cp.async ring
static_assert(32 % kL == 0 && kThreads % 32 == 0, "lanes split a warp");
static_assert(kThreads % kCB == 0, "the pre-pass keeps one channel a thread");
static_assert(kT * kCB % kThreads == 0 && kT % kL == 0, "whole passes");

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

__device__ __forceinline__ void cp_async_16(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

struct Strides {               // in elements; the last axis has stride 1
  long long b, s;
};

// Rows [0, rows) of a slab (row stride ss elements, columns [0, cols)
// valid) into dst of (kT, W) elements: 16-byte cp.async where `vec` and
// the chunk is whole, element loads otherwise.  Columns at or past cols
// are left as they are (the reader masks them).
template <typename T, int W>
__device__ __forceinline__ void load_rows(T* dst, const T* src, long long ss,
                                          int rows, int cols, bool vec) {
  constexpr int E = 16 / sizeof(T);       // elements a chunk
  constexpr int CH = W / E;               // chunks a row
  static_assert(W % E == 0, "rows are whole chunks");
#pragma unroll
  for (int j = 0; j < (kT * CH + kThreads - 1) / kThreads; ++j) {
    const int i = threadIdx.x + j * kThreads;
    const int tt = i / CH, c = (i % CH) * E;
    if (tt >= rows || c >= cols) continue;
    T* d = dst + tt * W + c;
    const T* s = src + tt * ss + c;
    if (vec && c + E <= cols) {
      cp_async_16(d, s);
    } else {
      for (int e = 0; e < E && c + e < cols; ++e) d[e] = s[e];
    }
  }
}

// One round (mask M) of the recursive halving of the lanes' partial y:
// each lane keeps HALF of its steps and adds its partner's share of them,
// then recurses.  Returns the first step lane `sub` ends with.
template <int HALF, int M>
__device__ __forceinline__ int lane_steps(float (&yp)[kCPT][kT], int sub) {
  if constexpr (M < kL) {
    const bool up = sub & M;
#pragma unroll
    for (int k2 = 0; k2 < kCPT; ++k2)
#pragma unroll
      for (int j = 0; j < HALF; ++j) {
        const float send = up ? yp[k2][j] : yp[k2][j + HALF];
        const float keep = up ? yp[k2][j + HALF] : yp[k2][j];
        yp[k2][j] = keep + __shfl_xor_sync(0xffffffffu, send, M);
      }
    return (up ? HALF : 0) + lane_steps<HALF / 2, 2 * M>(yp, sub);
  } else {
    return 0;
  }
}

template <int NB>
__host__ __device__ constexpr int raw_elems() {  // a ring stage: x, dt, B, C
  return 2 * kT * kCB + 2 * kT * NB;
}

template <typename T, int NB>
__host__ __device__ constexpr size_t smem_bytes() {
  return kStages * raw_elems<NB>() * sizeof(T)  // ring
         + 2 * kT * NB * sizeof(float)          // B, C in f32
         + kT * kCB * sizeof(float2)            // (exp(dt A), dt x)
         + kT * kCB * sizeof(float);            // y
}

// vec bits: 1 x, 2 dt, 4 Bm, 8 Cm may take 16-byte copies.
template <typename T, int NB>
__global__ void __launch_bounds__(kThreads)
ssm_scan_fwd(const T* __restrict__ x, const T* __restrict__ dt,
             const float* __restrict__ A, const T* __restrict__ Bm,
             const T* __restrict__ Cm, const float* __restrict__ h0,
             T* __restrict__ y, float* __restrict__ hout, Strides sx,
             Strides sdt, Strides sbm, Strides scm, Strides sy, int S, int C,
             int N, int vec) {
  constexpr int NPL = NB / kL;         // states a lane
  constexpr int NQ = NPL / 4;          // float4 groups a lane
  static_assert(NPL % 4 == 0, "a lane holds whole float4 groups");
  extern __shared__ __align__(16) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);
  float* sB = reinterpret_cast<float*>(smem + kStages * raw_elems<NB>() *
                                                  sizeof(T));
  float* sC = sB + kT * NB;
  float2* sDX = reinterpret_cast<float2*>(sC + kT * NB);
  float* sY = reinterpret_cast<float*>(sDX + kT * kCB);

  const int b = blockIdx.y;
  const int c0 = blockIdx.x * kCB;
  const int cols = min(kCB, C - c0);
  const int sub = threadIdx.x % kL;
  const int slot = threadIdx.x / kL;
  const T* xb = x + b * sx.b + c0;
  const T* db = dt + b * sdt.b + c0;
  const T* bb = Bm + b * sbm.b;
  const T* cb = Cm + b * scm.b;
  T* yb = y + b * sy.b + c0;

  // this thread's states: channel slot + kSlots * k, state
  // 4 * (sub + kL * q) + e
  float h[kCPT][NPL];
#pragma unroll
  for (int k = 0; k < kCPT; ++k) {
    const int cl = slot + kSlots * k;
    const float* hr = h0 + ((long long)b * C + c0 + cl) * N;
#pragma unroll
    for (int q = 0; q < NQ; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int n = 4 * (sub + kL * q) + e;
        h[k][4 * q + e] =
            (h0 != nullptr && cl < cols && n < N) ? hr[n] : 0.f;
      }
  }
  // the pre-pass keeps one channel a thread
  const int pcl = threadIdx.x % kCB;
  const float a = pcl < cols ? A[c0 + pcl] : 0.f;

  const int tiles = (S + kT - 1) / kT;
  auto fetch = [&](int k) {
    T* st = ring + (k % kStages) * raw_elems<NB>();
    const int t0 = k * kT, rows = min(kT, S - t0);
    load_rows<T, kCB>(st, xb + t0 * sx.s, sx.s, rows, cols, vec & 1);
    load_rows<T, kCB>(st + kT * kCB, db + t0 * sdt.s, sdt.s, rows, cols,
                      vec & 2);
    load_rows<T, NB>(st + 2 * kT * kCB, bb + t0 * sbm.s, sbm.s, rows, N,
                     vec & 4);
    load_rows<T, NB>(st + 2 * kT * kCB + kT * NB, cb + t0 * scm.s, scm.s,
                     rows, N, vec & 8);
  };
  auto store_y = [&](int k) {          // sY of tile k to y
    const int t0 = k * kT, rows = min(kT, S - t0);
#pragma unroll
    for (int j = 0; j < kT * kCB / kThreads; ++j) {
      const int i = threadIdx.x + j * kThreads;
      const int tt = i / kCB;
      if (tt < rows && pcl < cols)
        yb[(t0 + tt) * sy.s + pcl] = from_f32<T>(sY[i]);
    }
  };

#pragma unroll
  for (int k = 0; k < kStages - 1; ++k) {
    if (k < tiles) fetch(k);
    cp_async_commit();
  }
  for (int k = 0; k < tiles; ++k) {
    cp_async_wait<kStages - 2>();      // this thread's copies of tile k
    __syncthreads();                   // everyone's; tile k-1's steps done
    const int steps = min(kT, S - k * kT);
    const T* st = ring + (k % kStages) * raw_elems<NB>();
    if (k > 0) store_y(k - 1);
    // past the last step (and past the last channel) decay 1 and input 0
    // keep h as it is; B = C = 0 there
#pragma unroll
    for (int j = 0; j < kT * kCB / kThreads; ++j) {
      const int i = threadIdx.x + j * kThreads;
      float2 v = make_float2(1.f, 0.f);
      if (i / kCB < steps && pcl < cols) {
        const float d = to_f32(st[kT * kCB + i]);
        v = make_float2(expf(d * a), d * to_f32(st[i]));
      }
      sDX[i] = v;
    }
#pragma unroll
    for (int j = 0; j < (kT * NB + kThreads - 1) / kThreads; ++j) {
      const int i = threadIdx.x + j * kThreads;
      if (i >= kT * NB) break;
      const bool ok = i / NB < steps && i % NB < N;
      sB[i] = ok ? to_f32(st[2 * kT * kCB + i]) : 0.f;
      sC[i] = ok ? to_f32(st[2 * kT * kCB + kT * NB + i]) : 0.f;
    }
    if (k + kStages - 1 < tiles) fetch(k + kStages - 1);
    cp_async_commit();
    __syncthreads();                   // sB, sC, sDX of tile k are ready

    // all kT steps, unrolled; each lane's share of y_t stays in registers
    float yp[kCPT][kT];
#pragma unroll
    for (int tt = 0; tt < kT; ++tt) {
      const float4* b4 = reinterpret_cast<const float4*>(sB + tt * NB);
      const float4* c4 = reinterpret_cast<const float4*>(sC + tt * NB);
      float2 dx[kCPT];
      float acc[kCPT][4];
#pragma unroll
      for (int k2 = 0; k2 < kCPT; ++k2) {
        dx[k2] = sDX[tt * kCB + slot + kSlots * k2];
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[k2][e] = 0.f;
      }
#pragma unroll
      for (int q = 0; q < NQ; ++q) {
        const float4 bv = b4[sub + kL * q];
        const float4 cv = c4[sub + kL * q];
        const float bs[4] = {bv.x, bv.y, bv.z, bv.w};
        const float cs[4] = {cv.x, cv.y, cv.z, cv.w};
#pragma unroll
        for (int k2 = 0; k2 < kCPT; ++k2)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float& hv = h[k2][4 * q + e];
            hv = fmaf(dx[k2].x, hv, dx[k2].y * bs[e]);
            acc[k2][e] = fmaf(hv, cs[e], acc[k2][e]);
          }
      }
#pragma unroll
      for (int k2 = 0; k2 < kCPT; ++k2)
        yp[k2][tt] = (acc[k2][0] + acc[k2][1]) + (acc[k2][2] + acc[k2][3]);
    }
    // Sum y over a channel's kL lanes by recursive halving: in the round
    // of mask m each lane keeps half of its steps and adds its partner's
    // share of them (a + b is b + a to the bit, so both partners agree).
    // Lane sub ends with the kT / kL steps from `base` on.
    const int base = lane_steps<kT / 2, 1>(yp, sub);
#pragma unroll
    for (int k2 = 0; k2 < kCPT; ++k2)
#pragma unroll
      for (int j = 0; j < kT / kL; ++j)
        if (base + j < steps)
          sY[(base + j) * kCB + slot + kSlots * k2] = yp[k2][j];
  }
  cp_async_wait<0>();
  __syncthreads();
  if (tiles > 0) store_y(tiles - 1);

#pragma unroll
  for (int k = 0; k < kCPT; ++k) {
    const int cl = slot + kSlots * k;
    if (cl >= cols) continue;
    float* hr = hout + ((long long)b * C + c0 + cl) * N;
#pragma unroll
    for (int q = 0; q < NQ; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int n = 4 * (sub + kL * q) + e;
        if (n < N) hr[n] = h[k][4 * q + e];
      }
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

template <typename T, int NB>
cudaError_t launch(const void* x, const void* dt, const void* A,
                   const void* Bm, const void* Cm, const void* h0, void* y,
                   void* hout, int B, int S, int C, int N,
                   const long long* st, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<T, NB>();
  cudaError_t err = cudaFuncSetAttribute(
      ssm_scan_fwd<T, NB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  // a tensor takes 16-byte copies when its base and its batch and
  // sequence strides are 16-byte aligned
  const void* seq[4] = {x, dt, Bm, Cm};
  int vec = 0;
  for (int i = 0; i < 4; ++i) {
    const bool ok = aligned16(seq[i]) && st[2 * i] * sizeof(T) % 16 == 0 &&
                    st[2 * i + 1] * sizeof(T) % 16 == 0;
    vec |= ok << i;
  }
  const dim3 grid((C + kCB - 1) / kCB, B);
  ssm_scan_fwd<T, NB><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dt),
      static_cast<const float*>(A), static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), static_cast<const float*>(h0),
      static_cast<T*>(y), static_cast<float*>(hout), Strides{st[0], st[1]},
      Strides{st[2], st[3]}, Strides{st[4], st[5]}, Strides{st[6], st[7]},
      Strides{st[8], st[9]}, S, C, N, vec);
  return cudaGetLastError();
}

// N rounded up to a bucket that splits into whole float4 groups a lane
constexpr int bucket(int nb) { return nb < 4 * kL ? 4 * kL : nb; }

template <typename T>
cudaError_t dispatch_n(const void* x, const void* dt, const void* A,
                       const void* Bm, const void* Cm, const void* h0,
                       void* y, void* hout, int B, int S, int C, int N,
                       const long long* st, cudaStream_t stream) {
  if (N <= 16)
    return launch<T, bucket(16)>(x, dt, A, Bm, Cm, h0, y, hout, B, S, C, N,
                                 st, stream);
  if (N <= 32)
    return launch<T, bucket(32)>(x, dt, A, Bm, Cm, h0, y, hout, B, S, C, N,
                                 st, stream);
  return launch<T, bucket(64)>(x, dt, A, Bm, Cm, h0, y, hout, B, S, C, N,
                               st, stream);
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
