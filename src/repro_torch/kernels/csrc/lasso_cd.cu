// Hopper kernels for the two hot spots of the STRADS Lasso round.
//
// lasso_partial: the push partials z[w, u] = sum_i X[w, i, u] * r[w, i].
//   Replaces the Pallas kernel src/repro/kernels/lasso_cd.py::lasso_partial
//   (_partial_kernel).  Bound: memory.  It reads each of the W*n*(U+1) input
//   floats once and does 2 operations per X element, far below the card's
//   ridge.  At the main path's shapes (W 4, n 12,500, U 32) that is 6.6 MB,
//   1.97 us at 3.35 TB/s, so one launch is the whole budget.  Design: the
//   TPU walked the row tiles in order on one core with a resident
//   accumulator; here every block takes one row tile of block_n rows at
//   once, in ONE launch:
//   - A warp's lanes split into RPW rows of CW lanes (CW the power of two
//     at or above U/4, at most 32); each lane reads 16 bytes (4 columns)
//     of a row with a float4 load when U % 4 == 0 and X is 16-byte
//     aligned, or one float of a row otherwise (a branch inside the same
//     kernel).  Eight rows a lane are unrolled, so eight loads are in
//     flight before the first FMA.  r[i] is one load a row, broadcast to
//     the lanes that share the row.
//   - The block sums its lanes' row sums with xor shuffles and its warps in
//     shared memory, in a fixed order, and writes U partials to a
//     workspace of W * T * U floats.
//   - It then draws a ticket from a per-worker counter (integer atomicAdd
//     after __threadfence()).  The block that draws the last ticket sums
//     the worker's T partials in a fixed order (t strided over the block's
//     threads, then the threads in order), writes z, and sets the counter
//     back to 0, so the next call and every replay of a captured CUDA
//     graph start clean.  No float atomics, so every run gives the same
//     bits.
//   The launch is latency-bound at these shapes (one wave of loads, then
//   the ticket and the last block's sum), not bandwidth-bound.  One
//   thread-block cluster a worker, summing its blocks' partials through
//   distributed shared memory, was measured as the alternative
//   (tools/lasso_partial_designs.py): slower at W = 4 and much slower at
//   W = 1, where 16 SMs carry a worker, so it was not kept (PERF.md).
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
// worker and returns per-worker results; the caller sums over W.
// Built by nvcc for sm_90a into a shared library with a plain C interface
// (see repro_torch/kernels/_build.py); every entry point returns
// cudaGetLastError() so the Python wrapper can raise on a refused launch.

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

constexpr int kUnroll = 8;  // rows a lane has in flight

// One lane's share of a row tile: columns [V*g, V*g + V) of rows row,
// row + rstep, ... below row1, each times r, summed into acc.  Loads go
// out kUnroll rows at a time (past row1 predicated off), then the FMAs.
template <int V>
__device__ __forceinline__ void tile_rows(const float* __restrict__ Xw,
                                          const float* __restrict__ rw,
                                          float (&acc)[4], int U, int g,
                                          int row, int row1, int rstep) {
  using Vec = typename std::conditional<V == 4, float4, float>::type;
  const float* col = Xw + (size_t)g * V;
  for (; row < row1; row += kUnroll * rstep) {
    Vec xv[kUnroll];
    float rv[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const int i = row + k * rstep;
      if (i < row1) {
        xv[k] = __ldg(reinterpret_cast<const Vec*>(col + (size_t)i * U));
        rv[k] = __ldg(rw + i);
      } else {
        xv[k] = Vec{};
        rv[k] = 0.f;
      }
    }
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const float* xs = reinterpret_cast<const float*>(&xv[k]);
#pragma unroll
      for (int v = 0; v < V; ++v) acc[v] = fmaf(xs[v], rv[k], acc[v]);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
lasso_partial_fused(const float* __restrict__ X, const float* __restrict__ r,
                    float* __restrict__ work,
                    unsigned int* __restrict__ ticket,
                    float* __restrict__ z, int n, int U, int block_n, int T,
                    int vec) {
  const int t = blockIdx.x;
  const int w = blockIdx.z;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int V = vec ? 4 : 1;
  const int G = (U + V - 1) / V;   // column groups (vec: U % 4 == 0)
  int CW = 1;                      // lanes a row
  while (CW < G && CW < 32) CW <<= 1;
  const int RPW = 32 / CW;         // rows a warp takes at once
  const int sub = lane & (CW - 1);
  const int row0 = t * block_n;
  const int row1 = min(row0 + block_n, n);
  const int rstep = kWarps * RPW;
  const float* Xw = X + (size_t)w * n * U;
  const float* rw = r + (size_t)w * n;
  float* part = work + ((size_t)w * T + t) * U;
  __shared__ float red[kWarps][128];
  __shared__ bool last;

  for (int g0 = 0; g0 < G; g0 += CW) {
    const int g = g0 + sub;
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    if (g < G) {
      const int row = row0 + warp * RPW + lane / CW;
      if (vec)
        tile_rows<4>(Xw, rw, acc, U, g, row, row1, rstep);
      else
        tile_rows<1>(Xw, rw, acc, U, g, row, row1, rstep);
    }
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      if (v >= V) break;
      for (int off = CW; off < 32; off <<= 1)
        acc[v] += __shfl_xor_sync(0xffffffffu, acc[v], off);
      if (lane < CW) red[warp][lane * V + v] = acc[v];
    }
    __syncthreads();
    for (int c = threadIdx.x; c < CW * V && g0 * V + c < U; c += kThreads) {
      float s = 0.f;
#pragma unroll
      for (int k = 0; k < kWarps; ++k) s += red[k][c];
      part[g0 * V + c] = s;
    }
    __syncthreads();
  }

  // The last block of worker w to finish sums the worker's T partials.
  if (threadIdx.x < CW * V) __threadfence();   // the threads that wrote
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(ticket + w, 1u) == (unsigned)T - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const float* pw = work + (size_t)w * T * U;
  float* sred = &red[0][0];
  if (U <= kThreads) {
    const int J = kThreads / U;   // threads a column
    const int j = threadIdx.x / U, u = threadIdx.x % U;
    if (j < J) {
      float s = 0.f;
#pragma unroll 4
      for (int tt = j; tt < T; tt += J) s += __ldcg(pw + (size_t)tt * U + u);
      sred[j * U + u] = s;
    }
    __syncthreads();
    if (threadIdx.x < U) {
      float s = 0.f;
      for (int k = 0; k < J; ++k) s += sred[k * U + threadIdx.x];
      z[(size_t)w * U + threadIdx.x] = s;
    }
  } else {
    for (int u = threadIdx.x; u < U; u += kThreads) {
      float s = 0.f;
      for (int tt = 0; tt < T; ++tt) s += __ldcg(pw + (size_t)tt * U + u);
      z[(size_t)w * U + u] = s;
    }
  }
  if (threadIdx.x == 0) ticket[w] = 0;
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

// z (W, U) <- per-worker X^T r for X (W, n, U), r (W, n), in one launch.
// work is scratch of at least W * ceil(n / block_n) * U floats; ticket is W
// counters that are 0 before the call and 0 again after it.  Calls that
// share work and ticket must run in order (one stream).
int lasso_partial_launch(const float* X, const float* r, float* work,
                         unsigned int* ticket, float* z, int W, int n, int U,
                         int block_n, cudaStream_t stream) {
  const int T = (n + block_n - 1) / block_n;
  const int vec = U % 4 == 0 && (reinterpret_cast<uintptr_t>(X) & 15u) == 0;
  lasso_partial_fused<<<dim3(T, 1, W), kThreads, 0, stream>>>(
      X, r, work, ticket, z, n, U, block_n, T, vec);
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
