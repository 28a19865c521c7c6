// Hopper kernels for the two hot spots of the STRADS Lasso round.
//
// lasso_partial: the push partials z[w, u] = sum_i X[w, i, u] * r[w, i].
//   Replaces the Pallas kernel src/repro/kernels/lasso_cd.py::lasso_partial
//   (_partial_kernel).  Bound: memory.  It reads each of the W*n*(U+1) input
//   floats once and does 2 operations per X element, far below the card's
//   ridge.  Design: the TPU walked the row tiles in order on one core with a
//   resident accumulator; here every block takes one row tile of block_n rows
//   at once.  A warp's 32 lanes are 32 neighbouring columns, so each warp
//   reads whole row segments (coalesced), and the 8 warps of a block take
//   interleaved rows.  Each block writes one U-vector of partials to scratch
//   and a second kernel sums the tiles in a fixed order.  No atomics, so the
//   result is the same bits on every run.
//
// gram_block: the rho-filter Gram block G[w] = X[w]^T X[w], X[w] of (n, U').
//   Replaces the Pallas kernel src/repro/kernels/lasso_cd.py::gram_block
//   (_gram_kernel).  Bound: operations.  G is symmetric, so the function
//   needs only its upper triangle, W*n*U'*(U'+1) operations on the FP32
//   cores (the tensor cores would need TF32, which would break parity with
//   the f32 reference).  Design: the same split over row tiles as
//   lasso_partial.  A block owns one 64x64 tile of G on or above the
//   diagonal for one row tile; it stages 16 rows of its two 64-column
//   panels in shared memory and each of its 256 threads keeps a 4x4
//   register tile of sums.  Ragged rows and columns are masked with zeros.
//   Each block writes its partial tile to scratch; a fixed-order second
//   pass sums the row tiles of each upper entry and writes it to both
//   halves of G, so G is symmetric to the bit.
//
// Both take a leading worker axis W (grid z), so one launch serves every
// worker and returns per-worker partials; the caller sums over W.
// Built by nvcc for sm_90a into a shared library with a plain C interface
// (see repro_torch/kernels/_build.py); every entry point returns
// cudaGetLastError() so the Python wrapper can raise on a refused launch.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__global__ void __launch_bounds__(kThreads)
lasso_partial_tiles(const float* __restrict__ X, const float* __restrict__ r,
                    float* __restrict__ partials, int n, int U, int block_n,
                    int T) {
  const int t = blockIdx.x;
  const int w = blockIdx.z;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int row0 = t * block_n;
  const int row1 = min(row0 + block_n, n);
  const float* Xw = X + (size_t)w * n * U;
  const float* rw = r + (size_t)w * n;
  float* out = partials + ((size_t)w * T + t) * U;
  __shared__ float red[kWarps][32];
  for (int c0 = 0; c0 < U; c0 += 32) {
    const int c = c0 + lane;
    float acc = 0.f;
    if (c < U) {
      for (int i = row0 + warp; i < row1; i += kWarps)
        acc = fmaf(Xw[(size_t)i * U + c], rw[i], acc);
    }
    red[warp][lane] = acc;
    __syncthreads();
    if (warp == 0 && c < U) {
      float s = 0.f;
#pragma unroll
      for (int k = 0; k < kWarps; ++k) s += red[k][lane];
      out[c] = s;
    }
    __syncthreads();
  }
}

constexpr int kTile = 64;   // edge of the output tile a block owns
constexpr int kChunk = 16;  // rows staged in shared memory per step

__global__ void __launch_bounds__(kThreads)
gram_tiles(const float* __restrict__ X, float* __restrict__ partials, int n,
           int U, int block_n, int T, int tiles_per_dim) {
  const int t = blockIdx.x;
  // blockIdx.y numbers the tiles (ta, tb) with ta <= tb, row by row
  int ta = 0, p = blockIdx.y;
  while (p >= tiles_per_dim - ta) {
    p -= tiles_per_dim - ta;
    ++ta;
  }
  const int a0 = ta * kTile;
  const int b0 = (ta + p) * kTile;
  const int w = blockIdx.z;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int row0 = t * block_n;
  const int row1 = min(row0 + block_n, n);
  const float* Xw = X + (size_t)w * n * U;
  __shared__ __align__(16) float As[kChunk][kTile];
  __shared__ __align__(16) float Bs[kChunk][kTile];
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = row0; k0 < row1; k0 += kChunk) {
    for (int e = threadIdx.x; e < kChunk * kTile; e += kThreads) {
      const int kr = e / kTile;
      const int c = e % kTile;
      const int row = k0 + kr;
      const bool in_rows = row < row1;
      const float* xr = Xw + (size_t)row * U;
      As[kr][c] = (in_rows && a0 + c < U) ? xr[a0 + c] : 0.f;
      Bs[kr][c] = (in_rows && b0 + c < U) ? xr[b0 + c] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      const float4 av = *reinterpret_cast<const float4*>(&As[k][ty * 4]);
      const float4 bv = *reinterpret_cast<const float4*>(&Bs[k][tx * 4]);
      const float a[4] = {av.x, av.y, av.z, av.w};
      const float b[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  float* out = partials + ((size_t)w * T + t) * U * U;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int a = a0 + ty * 4 + i;
    if (a >= U) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int b = b0 + tx * 4 + j;
      if (b < U) out[(size_t)a * U + b] = acc[i][j];
    }
  }
}

// out[w, m] = sum_{t < T} partials[w, t, m], summed in order of t.
__global__ void __launch_bounds__(kThreads)
sum_tiles(const float* __restrict__ partials, float* __restrict__ out, int T,
          int M) {
  const int m = blockIdx.x * kThreads + threadIdx.x;
  const int w = blockIdx.y;
  if (m >= M) return;
  const float* p = partials + (size_t)w * T * M + m;
  float s = 0.f;
  for (int t = 0; t < T; ++t) s += p[(size_t)t * M];
  out[(size_t)w * M + m] = s;
}

// G[w, a, b] = G[w, b, a] = sum_{t < T} partials[w, t, a, b] for a <= b,
// summed in order of t; entries below the diagonal of partials are unread.
__global__ void __launch_bounds__(kThreads)
sum_gram_tiles(const float* __restrict__ partials, float* __restrict__ G,
               int T, int U) {
  const int m = blockIdx.x * kThreads + threadIdx.x;
  const int w = blockIdx.y;
  const int M = U * U;
  if (m >= M) return;
  const int a = m / U;
  const int b = m % U;
  if (a > b) return;
  const float* p = partials + (size_t)w * T * M + m;
  float s = 0.f;
  for (int t = 0; t < T; ++t) s += p[(size_t)t * M];
  float* Gw = G + (size_t)w * M;
  Gw[(size_t)a * U + b] = s;
  Gw[(size_t)b * U + a] = s;
}

}  // namespace

extern "C" {

// z (W, U) <- per-worker X^T r for X (W, n, U), r (W, n); partials is
// scratch of W * ceil(n / block_n) * U floats.
int lasso_partial_launch(const float* X, const float* r, float* partials,
                         float* z, int W, int n, int U, int block_n,
                         cudaStream_t stream) {
  const int T = (n + block_n - 1) / block_n;
  lasso_partial_tiles<<<dim3(T, 1, W), kThreads, 0, stream>>>(
      X, r, partials, n, U, block_n, T);
  const int err = (int)cudaGetLastError();
  if (err) return err;
  sum_tiles<<<dim3((U + kThreads - 1) / kThreads, W), kThreads, 0, stream>>>(
      partials, z, T, U);
  return (int)cudaGetLastError();
}

// G (W, U, U) <- per-worker X^T X for X (W, n, U); partials is scratch of
// W * ceil(n / block_n) * U * U floats.
int gram_block_launch(const float* X, float* partials, float* G, int W,
                      int n, int U, int block_n, cudaStream_t stream) {
  const int T = (n + block_n - 1) / block_n;
  const int tiles = (U + kTile - 1) / kTile;
  gram_tiles<<<dim3(T, tiles * (tiles + 1) / 2, W), kThreads, 0, stream>>>(
      X, partials, n, U, block_n, T, tiles);
  const int err = (int)cudaGetLastError();
  if (err) return err;
  sum_gram_tiles<<<dim3((U * U + kThreads - 1) / kThreads, W), kThreads, 0,
                   stream>>>(partials, G, T, U);
  return (int)cudaGetLastError();
}

const char* lasso_cd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
