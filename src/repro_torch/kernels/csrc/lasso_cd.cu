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
//   the f32 reference); at W 4, n 12,500, U' 128 that is 825.6 MFLOP,
//   12.3 us at 67 TFLOP/s, against 7.6 us for the 25.6 MB of X.  Design,
//   ONE launch (gram_fused):
//   - The rows are split by the card, not by block_n: S slices a worker,
//     in thread-block clusters of C = 4 or 8 consecutive slices, so that
//     the grid is one wave of what the card holds (kernels/lasso_cd.py::
//     _gram_plan; an H100 SXM holds 120 such blocks, not 132, since
//     clusters stay inside a GPC).  block_n is only checked: every value
//     gives the same function, as on the TPU.
//   - Columns come in panels of 128.  A job is a diagonal panel (the 136
//     8x8 tiles on or above its diagonal: 1.05x the triangle's operations)
//     or half of an off-diagonal panel pair (128 tiles); U' <= 128 is one
//     diagonal job.  Each thread keeps one 8x8 register tile: 64 FMAs for
//     four 16-byte shared loads.  Threads 0-127 (warps 0-3) take 128 tiles
//     over every row; warps 4-7 take the diagonal job's other 8 tiles,
//     each lane one sixteenth of the rows, so every SM sub-partition gets
//     one full warp and one light one and no warp idles below the
//     diagonal.  Ragged rows and columns (U' = 37, 130) load as zeros; a
//     stage's last rows past the slice are skipped 8 at a time.
//   - Rows arrive 32 at a time by cp.async into a ring of 3 stages (one
//     barrier a stage), 16-byte copies when U' % 4 == 0 and X is 16-byte
//     aligned, else 4-byte copies in the same kernel.  A stage stores tile
//     column j's 8 floats at quads j and 16 + j of the row, so the lanes
//     of a warp read distinct banks or the same address.
//   - The sum over slices is deterministic and needs no float atomics.
//     Each block pushes its partial, by 16-byte stores into distributed
//     shared memory, to the blocks of its cluster (block r owns entries
//     [r * 64/C, (r+1) * 64/C) of every tile), which sum the C partials in
//     rank order into a workspace of W * jobs * (S/C) * 8704 floats (0.97
//     MB at W 4, C 4, S 28).  Thread 0 then draws a ticket from the
//     counter of (worker, job, r) (an acquire-release atomicAdd after the
//     block's barrier); the last of the S/C clusters sums the S/C pieces
//     in order, all its loads in flight at once, writes both halves of G
//     (symmetric to the bit) and resets the counter, so every call and
//     every CUDA-graph replay starts clean and gives the same bits.
//   What bounds it (measured on an H100, PERF.md): the main loop issues
//   FMAs at ~60 % of the FP32 rate (cutting its shared loads 8-fold gains
//   6 %, so shared memory is not the limit; two blocks an SM gain
//   nothing), 120 of 132 SMs take a cluster, and the cluster sum, ticket
//   and last sum add ~8 us after the main loop.
//
// Both take a leading worker axis W (grid z), so one launch serves every
// worker and returns per-worker results; the caller sums over W.
// Built by nvcc for sm_90a into a shared library with a plain C interface
// (see repro_torch/kernels/_build.py); every entry point returns
// cudaGetLastError() so the Python wrapper can raise on a refused launch.

#include <cooperative_groups.h>
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

namespace cg = cooperative_groups;

constexpr int kPanel = 128;          // columns of a panel
constexpr int kRows = 32;            // rows of a stage
constexpr int kGramStages = 3;       // stages in the cp.async ring
constexpr int kStageFloats = kRows * kPanel;
constexpr int kHeavy = 128;          // threads with one tile over every row
constexpr int kDiagTiles = 136;      // 8x8 tiles on or above the diagonal
constexpr int kOffTiles = 128;       // tiles of half an off-diagonal pair
constexpr int kPart = 64 * kDiagTiles;   // floats of a block's partial
constexpr int kCluster = 8;          // slices summed in one cluster
constexpr int kLight = kThreads - kHeavy;            // 128 light lanes
constexpr int kLightTiles = kDiagTiles - kHeavy;     // 8 tiles
constexpr int kLightGroups = kLight / kLightTiles;   // 16 row groups
static_assert(kLightGroups * kLightTiles == kLight && kRows % kLightGroups == 0,
              "the light lanes split the rows of a stage evenly");
static_assert(kOffTiles == kHeavy, "off-diagonal jobs use the heavy warps");
// float4s of a piece (at most kPart / 4 floats, clusters of 4) a thread sums
constexpr int kFinalX = (kPart / 4 / 4 + kThreads - 1) / kThreads;
static_assert(kPart + 4 * 64 * kLightTiles <= kGramStages * kStageFloats,
              "the partial and the light sums fit in the ring");

__device__ __forceinline__ void cp_async_z(float* dst, const float* src,
                                           bool vec, bool ok) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  if (vec)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(src), "r"(ok ? 16 : 0)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
                 "l"(src), "r"(ok ? 4 : 0)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// atomicAdd(p, 1) with acquire-release semantics at device scope.
__device__ __forceinline__ unsigned int ticket_acq_rel(unsigned int* p) {
  unsigned int old;
  asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], 1;\n"
               : "=r"(old)
               : "l"(p)
               : "memory");
  return old;
}

// Tile t = (ti, tj), ti <= tj, of a diagonal panel's 16 x 16 grid of 8x8
// tiles: bands of 4 tile rows, each band column by column.  The last 8
// (in band 3's diagonal 4x4 block) are the light lanes'.
__device__ __forceinline__ void diag_tile(int t, int& ti, int& tj) {
  ti = tj = 0;
  for (int b = 0; b < 4; ++b)
    for (int j = 4 * b; j < 16; ++j) {
      const int c = min(j - 4 * b + 1, 4);
      if (t < c) {
        ti = 4 * b + t;
        tj = j;
        return;
      }
      t -= c;
    }
}

// Rows [row, row + kRows) of panel columns [col0, col0 + kPanel) into a
// stage, zeros at or past row1 or U.  Quad q of a row (columns 4q..4q+3)
// sits at position ((q & 1) << 4) | (q >> 1): tile column j's 8 floats at
// positions j and 16 + j.
__device__ __forceinline__ void stage_panel(float* dst, const float* Xw,
                                            int U, int row, int row1,
                                            int col0, bool vec) {
  if (vec) {
#pragma unroll
    for (int m = 0; m < kStageFloats / 4 / kThreads; ++m) {
      const int idx = threadIdx.x + m * kThreads;
      const int k = idx >> 5, p = idx & 31;        // p: position in the row
      const int q = ((p & 15) << 1) | (p >> 4);
      const int r = row + k, c = col0 + 4 * q;
      const bool ok = r < row1 && c < U;
      cp_async_z(dst + k * kPanel + 4 * p, ok ? Xw + (size_t)r * U + c : Xw,
                 true, ok);
    }
  } else {
#pragma unroll 4
    for (int m = 0; m < kStageFloats / kThreads; ++m) {
      const int idx = threadIdx.x + m * kThreads;
      const int k = idx >> 7, e = idx & 127;       // e: column in the panel
      const int q = e >> 2;
      const int p = ((q & 1) << 4) | (q >> 1);
      const int r = row + k, c = col0 + e;
      const bool ok = r < row1 && c < U;
      cp_async_z(dst + k * kPanel + 4 * p + (e & 3),
                 ok ? Xw + (size_t)r * U + c : Xw, false, ok);
    }
  }
}

// acc[r][c] += A[k][r] * B[k][c] over rows k = k0, k0 + STEP, ... (N of
// them) of a stage; A and B point at the thread's tile row and column.
template <int N, int STEP>
__device__ __forceinline__ void tile_fma(float (&acc)[8][8],
                                         const float* A, const float* B,
                                         int k0) {
#pragma unroll
  for (int kk = 0; kk < N; ++kk) {
    const int k = (k0 + kk * STEP) * kPanel;
    const float4 a0 = *reinterpret_cast<const float4*>(A + k);
    const float4 a1 = *reinterpret_cast<const float4*>(A + k + 64);
    const float4 b0 = *reinterpret_cast<const float4*>(B + k);
    const float4 b1 = *reinterpret_cast<const float4*>(B + k + 64);
    const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[r][c] = fmaf(a[r], b[c], acc[r][c]);
  }
}

// Grid (S, jobs, W) in clusters of C = 4 or 8 consecutive slices;
// groups = S / C.
__global__ void __launch_bounds__(kThreads, 1)
gram_fused(const float* __restrict__ X, float* __restrict__ work,
           unsigned int* __restrict__ ticket, float* __restrict__ G, int n,
           int U, int panels, int groups, int vec) {
  extern __shared__ __align__(16) float sm[];
  __shared__ unsigned char tab[kDiagTiles][2];
  __shared__ bool last;
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int s = blockIdx.x, S = gridDim.x;
  const int job = blockIdx.y, jobs = gridDim.y, w = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31;

  // the job: diagonal panel pa, or half h of the panel pair pa < pb
  int pa = job, pb = job, h = 0;
  if (job >= panels) {
    int p = (job - panels) >> 1;
    h = (job - panels) & 1;
    pa = 0;
    while (p >= panels - 1 - pa) {
      p -= panels - 1 - pa;
      ++pa;
    }
    pb = pa + 1 + p;
  }
  const bool diag = pa == pb;
  const int NT = diag ? kDiagTiles : kOffTiles;
  const bool heavy = tid < kHeavy;
  const int L = tid - kHeavy;          // light lane: tile kHeavy + (L & 7),
  const int g = L >> 3;                // rows g and g + 16 of each stage
  int ti, tj;
  const int t = heavy ? tid : kHeavy + (L & 7);
  if (diag) {
    diag_tile(t, ti, tj);
    if (heavy || L < kLightTiles) {
      tab[t][0] = (unsigned char)ti;
      tab[t][1] = (unsigned char)tj;
    }
  } else {
    ti = 8 * h + (t >> 4);
    tj = t & 15;
  }

  const int rps = (n + S - 1) / S;
  const int row0 = min(n, s * rps), row1 = min(n, row0 + rps);
  const int chunks = (row1 - row0 + kRows - 1) / kRows;
  const float* Xw = X + (size_t)w * n * U;
  const int bOff = diag ? 0 : kGramStages * kStageFloats;  // B's stages
  float acc[8][8];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[r][c] = 0.f;

  for (int c = 0; c < kGramStages - 1; ++c) {
    if (c < chunks) {
      float* d = sm + c * kStageFloats;
      stage_panel(d, Xw, U, row0 + c * kRows, row1, pa * kPanel, vec);
      if (!diag)
        stage_panel(d + bOff, Xw, U, row0 + c * kRows, row1, pb * kPanel,
                    vec);
    }
    cp_async_commit();
  }
  const float* A = sm + 4 * ti;
  const float* B = sm + bOff + 4 * tj;
  for (int c = 0; c < chunks; ++c) {
    cp_async_wait<kGramStages - 2>();  // this thread's copies of stage c
    __syncthreads();                   // everyone's; stage c-1 is done
    const int nc = c + kGramStages - 1;
    if (nc < chunks) {
      float* d = sm + (nc % kGramStages) * kStageFloats;
      stage_panel(d, Xw, U, row0 + nc * kRows, row1, pa * kPanel, vec);
      if (!diag)
        stage_panel(d + bOff, Xw, U, row0 + nc * kRows, row1, pb * kPanel,
                    vec);
    }
    cp_async_commit();
    const int off = (c % kGramStages) * kStageFloats;
    const int rows = min(kRows, row1 - row0 - c * kRows);  // the rest: zeros
    if (heavy) {
#pragma unroll 1
      for (int k0 = 0; k0 < rows; k0 += 8)
        tile_fma<8, 1>(acc, A + off, B + off, k0);
    } else if (diag) {
      tile_fma<kRows / kLightGroups, kLightGroups>(acc, A + off, B + off, g);
    }
  }
  cp_async_wait<0>();
  __syncthreads();                     // the ring is free

  // the light lanes' 16 row groups, summed in order: 4 sums a light lane
  float lv[64 * kLightTiles / kLight];
  float* light = sm + kPart;           // [4 warps][64][8 tiles]
  if (!heavy && diag) {
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        float v = acc[r][c];
        v += __shfl_xor_sync(0xffffffffu, v, 8);
        v += __shfl_xor_sync(0xffffffffu, v, 16);
        if (lane < 8) light[(((L >> 5) * 64) + 8 * r + c) * 8 + lane] = v;
      }
  }
  __syncthreads();
  if (!heavy && diag)
#pragma unroll
    for (int m = 0; m < 64 * kLightTiles / kLight; ++m) {
      const int x = L + m * kLight, e = x >> 3, lt = x & 7;
      float v = 0.f;
#pragma unroll
      for (int k = 0; k < kLight / 32; ++k) v += light[(k * 64 + e) * 8 + lt];
      lv[m] = v;
    }
  cluster.sync();                      // every block's ring is free

  // Entry e = 8r + c of tile t belongs to block e / EP of the cluster.
  // A piece (NT * EP floats) holds entry e' = e % EP of tile t at
  // ((e' / 4) * NT + t) * 4 + e' % 4, so a warp's float4 stores are
  // contiguous; block `rank`'s piece lands at rank * piece of the owner.
  const int EP = 64 / C, piece = EP * NT;
  if (heavy) {
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      float* dst = cluster.map_shared_rank(sm, (8 * r) / EP) + rank * piece +
                   (((8 * r) % EP / 4) * NT + tid) * 4;
      *reinterpret_cast<float4*>(dst) =
          make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
      *reinterpret_cast<float4*>(dst + 4 * NT) =
          make_float4(acc[r][4], acc[r][5], acc[r][6], acc[r][7]);
    }
  } else if (diag) {
#pragma unroll
    for (int m = 0; m < 64 * kLightTiles / kLight; ++m) {
      const int x = L + m * kLight, e = (x >> 3) % EP, lt = x & 7;
      cluster.map_shared_rank(sm, (x >> 3) / EP)[
          rank * piece + ((e / 4) * NT + kHeavy + lt) * 4 + e % 4] = lv[m];
    }
  }
  cluster.sync();                      // every piece has arrived

  // this block's piece summed over the cluster in rank order
  const size_t wj = (size_t)w * jobs + job;
  float* out = work + (wj * groups + s / C) * kPart + rank * piece;
  for (int x = 4 * tid; x < piece; x += 4 * kThreads) {
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int q = 0; q < C; ++q) {
      const float4 u = *reinterpret_cast<const float4*>(sm + q * piece + x);
      v.x += u.x;
      v.y += u.y;
      v.z += u.z;
      v.w += u.w;
    }
    *reinterpret_cast<float4*>(out + x) = v;
  }

  // the last cluster of (w, job) to finish piece `rank` sums it over the
  // clusters in order and writes both halves of G.  After the barrier,
  // thread 0's ticket (an acquire-release atomic at device scope) releases
  // the block's stores and acquires those of the clusters before it.
  __syncthreads();
  unsigned int* tk = ticket + wj * C + rank;
  if (tid == 0) last = ticket_acq_rel(tk) == (unsigned)groups - 1;
  __syncthreads();
  if (!last) return;
  const float* pw = work + wj * groups * kPart + rank * piece;
  float* Gw = G + (size_t)w * U * U;
  float4 v[kFinalX];
#pragma unroll
  for (int m = 0; m < kFinalX; ++m) v[m] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int q0 = 0; q0 < groups; q0 += 8) {
    float4 u[kFinalX][8];                // every load in flight, then the
#pragma unroll                           // sums in order of q
    for (int m = 0; m < kFinalX; ++m)
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int x = 4 * (tid + m * kThreads);
        u[m][k] = x < piece && q0 + k < groups
                      ? __ldcg(reinterpret_cast<const float4*>(
                            pw + (size_t)(q0 + k) * kPart + x))
                      : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
    for (int m = 0; m < kFinalX; ++m)
#pragma unroll
      for (int k = 0; k < 8; ++k)
        if (q0 + k < groups) {
          v[m].x += u[m][k].x;
          v[m].y += u[m][k].y;
          v[m].z += u[m][k].z;
          v[m].w += u[m][k].w;
        }
  }
#pragma unroll
  for (int m = 0; m < kFinalX; ++m) {
    const int x = 4 * (tid + m * kThreads);
    if (x >= piece) break;
    // entries e .. e+3 of tile tt: one row of its 8x8 tile
    const int tt = (x / 4) % NT, e = rank * EP + (x / 4) / NT * 4;
    int i, j;
    if (diag) {
      i = tab[tt][0];
      j = tab[tt][1];
    } else {
      i = 8 * h + (tt >> 4);
      j = tt & 15;
    }
    const int a = pa * kPanel + 8 * i + (e >> 3);
    const int b = pb * kPanel + 8 * j + (e & 7);
    const float vs[4] = {v[m].x, v[m].y, v[m].z, v[m].w};
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (a <= b + k && b + k < U) {
        Gw[(size_t)a * U + b + k] = vs[k];
        Gw[(size_t)(b + k) * U + a] = vs[k];
      }
  }
  if (tid == 0) *tk = 0;
}

// Allows gram_fused its ring (two panels' stages) on the current device.
cudaError_t gram_opt_in() {
  static bool opted[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e || (dev < 64 && opted[dev])) return e;
  e = cudaFuncSetAttribute(gram_fused,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           2 * kGramStages * kStageFloats * 4);
  if (!e && dev < 64) opted[dev] = true;
  return e;
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

// *slots <- the blocks of gram_fused (a diagonal job) that the current
// card runs at once in clusters of 4.
int gram_block_slots(int* slots) {
  cudaError_t e = gram_opt_in();
  if (e) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(4, 1, 1);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = kGramStages * kStageFloats * 4;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 4;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  e = cudaOccupancyMaxActiveClusters(&clusters, (void*)gram_fused, &cfg);
  *slots = 4 * clusters;
  return (int)e;
}

// G (W, U, U) <- per-worker X^T X for X (W, n, U), in one launch of S
// slices a worker in clusters of C (4 or 8; S a multiple of C).  With
// P = ceil(U / 128) panels and P * P jobs, work is scratch of at least
// W * P * P * (S / C) * 8704 floats and ticket W * P * P * C counters
// that are 0 before the call and 0 again after it.  Calls that share work
// and ticket must run in order (one stream).
int gram_block_launch(const float* X, float* work, unsigned int* ticket,
                      float* G, int W, int n, int U, int S, int C,
                      cudaStream_t stream) {
  const int panels = (U + kPanel - 1) / kPanel;
  if ((C != 4 && C != 8) || S <= 0 || S % C) return (int)cudaErrorInvalidValue;
  cudaError_t e = gram_opt_in();
  if (e) return (int)e;
  const int vec = U % 4 == 0 && (reinterpret_cast<uintptr_t>(X) & 15u) == 0;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(S, panels * panels, W);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = (panels > 1 ? 2 : 1) * kGramStages * kStageFloats * 4;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, gram_fused, X, work, ticket, G, n, U, panels,
                         S / C, vec);
  return (int)(e ? e : cudaGetLastError());
}

const char* lasso_cd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
