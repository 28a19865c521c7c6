// The sLSTM kernels of the port as they were before the tagged exchange:
// one grid barrier a step (a counter in device memory, a release add and
// an acquire spin), h_{t-1} reloaded from hs after it in the forward, all
// of dg_t reloaded in the backward.  Kept beside tools/slstm_stamps.py,
// which builds it with -DSLSTM_STAMPS to time each phase of a step and
// compares it with src/repro_torch/kernels/csrc/slstm_scan.cu.  The
// interface is the shipped source's as it was (slstm_scan_plan,
// slstm_scan_fwd_launch, slstm_scan_bwd_launch, slstm_barriers_launch
// with one unsigned counter of scratch), plus slstm_stamps.
//
// With -DSLSTM_STAMPS thread 0 of every block sums the clock64 cycles of
// each phase of a step over the launch:
//   forward:  0 gx prefetch issued, 1 h_{t-1} reloaded, 2 the product,
//             3 the cell and its stores, 4 the barrier
//   backward: 0 the step's prefetch landed, 1 the cell and the dG store,
//             2 the barrier, 3 the dG reload, 4 the product
// and writes them with its step count to g_stamps[kernel][block].
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

#ifdef SLSTM_STAMPS
constexpr int kStampBlocks = 1024, kStampPhases = 6;
__device__ long long g_stamps[2][kStampBlocks][kStampPhases + 1];
#define STAMP_BEGIN long long st_t = clock64(), st_acc[kStampPhases] = {}, \
  st_steps = 0
#define STAMP(ph) do { if (threadIdx.x == 0) { const long long st_n = \
  clock64(); st_acc[ph] += st_n - st_t; st_t = st_n; } } while (0)
#define STAMP_STEP ++st_steps
#define STAMP_END(kern) do { if (threadIdx.x == 0 && \
  blockIdx.x < kStampBlocks) { for (int p = 0; p < kStampPhases; ++p) \
  g_stamps[kern][blockIdx.x][p] = st_acc[p]; \
  g_stamps[kern][blockIdx.x][kStampPhases] = st_steps; } } while (0)
#else
#define STAMP_BEGIN do {} while (0)
#define STAMP(ph) do {} while (0)
#define STAMP_STEP do {} while (0)
#define STAMP_END(kern) do {} while (0)
#endif

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRT = 4;                 // batch rows of a warp's tile
constexpr int kCT = 4;                 // columns of a warp's tile
constexpr int kMaxParts = kWarps;      // the most warps one tile's k splits over
constexpr unsigned long long kSpinNs = 10ull * 1000 * 1000 * 1000;
constexpr int kBwdStage = 11;          // floats a unit a step the backward
                                       // prefetches: g (4), dhs, c n m of
                                       // t and of t - 1

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void red_release(unsigned* p, unsigned v) {
  asm volatile("red.release.gpu.global.add.u32 [%0], %1;"
               :: "l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ unsigned long long globaltimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;"
               :: "r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_prev() {   // all but the newest
  asm volatile("cp.async.wait_group 1;" ::: "memory");
}

// Every block of the grid has arrived `target` times in all.  The writes
// each block made before arriving are visible to every block after.
__device__ __forceinline__ void grid_barrier(unsigned* count,
                                             unsigned target) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    red_release(count, 1u);
    const unsigned long long t0 = globaltimer();
    while (ld_acquire(count) < target)
      if (globaltimer() - t0 > kSpinNs) __trap();
    __threadfence();
  }
  __syncthreads();
}

__device__ __forceinline__ float sigmoidf_(float x) {
  return 1.f / (1.f + expf(-x));
}

__device__ __forceinline__ float logsigmoidf_(float x) {   // as torch's
  return fminf(x, 0.f) - log1pf(expf(-fabsf(x)));
}

__device__ __forceinline__ float tie_weight(float a, float b) {
  return a > b ? 1.f : (a == b ? 0.5f : 0.f);
}

// out[r * Cn + c] = sum_k X[r * ldx + k] * W[c * ldw + k] for r < R,
// c < Cn, k < K, by the whole block: warps take tiles of kRT x kCT
// outputs and a part of k (as many parts as leave no warp idle, at most
// kMaxParts), lanes stride k by 32, the lanes' sums meet by xor shuffles
// and the parts' in `red` (kMaxParts x R x Cn floats), added in part
// order.  Ends with the block synchronised.
__device__ void block_matvec(const float* X, int ldx, const float* W,
                             int ldw, int R, int Cn, int K, float* red,
                             float* out) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ct = (Cn + kCT - 1) / kCT;
  const int tiles = ((R + kRT - 1) / kRT) * ct;
  const int parts = max(1, min(kMaxParts, kWarps / tiles));
  const int chunk = ((K + parts - 1) / parts + 31) / 32 * 32;
  for (int w = warp; w < tiles * parts; w += kWarps) {
    const int tile = w % tiles, part = w / tiles;
    const int r0 = (tile / ct) * kRT, c0 = (tile % ct) * kCT;
    const int k1 = min(K, (part + 1) * chunk);
    float acc[kRT][kCT];
#pragma unroll
    for (int r = 0; r < kRT; ++r)
#pragma unroll
      for (int c = 0; c < kCT; ++c) acc[r][c] = 0.f;
    for (int k = part * chunk + lane; k < k1; k += 32) {
      float x[kRT], wv[kCT];
#pragma unroll
      for (int r = 0; r < kRT; ++r)
        x[r] = r0 + r < R ? X[(r0 + r) * ldx + k] : 0.f;
#pragma unroll
      for (int c = 0; c < kCT; ++c)
        wv[c] = c0 + c < Cn ? W[(c0 + c) * ldw + k] : 0.f;
#pragma unroll
      for (int r = 0; r < kRT; ++r)
#pragma unroll
        for (int c = 0; c < kCT; ++c) acc[r][c] = fmaf(x[r], wv[c], acc[r][c]);
    }
#pragma unroll
    for (int r = 0; r < kRT; ++r)
#pragma unroll
      for (int c = 0; c < kCT; ++c) {
        float v = acc[r][c];
#pragma unroll
        for (int off = 16; off; off >>= 1)
          v += __shfl_xor_sync(0xffffffffu, v, off);
        acc[r][c] = v;
      }
    if (lane == 0) {
#pragma unroll
      for (int r = 0; r < kRT; ++r)
#pragma unroll
        for (int c = 0; c < kCT; ++c)
          if (r0 + r < R && c0 + c < Cn)
            red[(part * R + r0 + r) * Cn + c0 + c] = acc[r][c];
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < R * Cn; i += kThreads) {
    float s = red[i];
    for (int p = 1; p < parts; ++p) s += red[p * R * Cn + i];
    out[i] = s;
  }
  __syncthreads();
}

// Shared memory of the forward, in floats: W_r's 4u columns (rows of
// d + 1), h_{t-1}, the parts' sums, the pre-activations, gx_t twice (the
// step's and the next one's), c n m.
__host__ __device__ inline long long fwd_smem_floats(int B, int d, int u) {
  return 4LL * u * (d + 1) + (long long)B * d + (kMaxParts + 3LL) * B * 4 * u
         + 3LL * B * u;
}

// ... of the backward: W_r's u rows (4d), dg_t (B x 4d), the parts' sums,
// dh_{t-1}'s part, the prefetched step twice, dc dn dm.
__host__ __device__ inline long long bwd_smem_floats(int B, int d, int u) {
  return 4LL * u * d + 4LL * B * d + (kMaxParts + 1LL) * B * u
         + 2LL * kBwdStage * B * u + 3LL * B * u;
}

// gx_t of the block's B x 4u columns into dst (cp.async; the caller
// commits).
__device__ __forceinline__ void fetch_gx(float* dst, const float* gx, int B,
                                         int S, int d, int u, int nu, int j0,
                                         int t) {
  const int U4 = 4 * u;
  for (int i = threadIdx.x; i < B * U4; i += kThreads) {
    const int b = i / U4, lc = i - b * U4, q = lc / u, jj = lc - q * u;
    if (jj < nu)
      cp_async4(dst + i, gx + ((size_t)b * S + t) * 4 * d + q * d + j0 + jj);
  }
}

__global__ void __launch_bounds__(kThreads, 1)
slstm_fwd(const float* __restrict__ gx, const float* __restrict__ wr,
          const float* __restrict__ bias, const float* __restrict__ c0,
          const float* __restrict__ n0, const float* __restrict__ m0,
          const float* __restrict__ h0, float* hs, float* __restrict__ cout,
          float* __restrict__ nout, float* __restrict__ mout,
          float* __restrict__ hout, float* __restrict__ Gs,
          float* __restrict__ Cs, float* __restrict__ Ns,
          float* __restrict__ Ms, unsigned* count, int Ball, int S, int d,
          int u, int rows) {
  extern __shared__ float smem[];
  const int U4 = 4 * u, dp = d + 1;
  float* w_s = smem;                               // [4u][d + 1]
  float* h_s = w_s + (size_t)U4 * dp;              // [rows][d]
  float* red = h_s + (size_t)rows * d;             // [parts][rows][4u]
  float* pre = red + (size_t)kMaxParts * rows * U4;  // [rows][4u]
  float* gx_s = pre + (size_t)rows * U4;           // [2][rows][4u]
  float* st = gx_s + 2 * (size_t)rows * U4;        // c, n, m: [3][rows][u]
  const int j0 = blockIdx.x * u, nu = min(u, d - j0);
  unsigned met = 0;                                // barriers passed
  STAMP_BEGIN;

  for (int i = threadIdx.x; i < d * U4; i += kThreads) {
    const int k = i / U4, lc = i - k * U4, q = lc / u, jj = lc - q * u;
    w_s[lc * dp + k] = jj < nu ? wr[(size_t)k * 4 * d + q * d + j0 + jj] : 0.f;
  }
  for (int b0 = 0; b0 < Ball; b0 += rows) {
  // chunk b0: its rows' slices of every (B, ...) tensor
  const int B = min(rows, Ball - b0), P = B * u;
  const float* gx_c = gx + (size_t)b0 * S * 4 * d;
  float* hs_c = hs + (size_t)b0 * S * d;
  const size_t s0 = (size_t)b0 * d, sS = (size_t)b0 * S;
  __syncthreads();             // the chunk before is done with the buffers
  fetch_gx(gx_s, gx_c, B, S, d, u, nu, j0, 0);
  cp_async_commit();
  for (int i = threadIdx.x; i < P; i += kThreads) {
    const int b = i / u, jj = i - b * u;
    const bool given = c0 != nullptr && jj < nu;
    const size_t at = s0 + (size_t)b * d + j0 + jj;
    st[i] = given ? c0[at] : 0.f;
    st[P + i] = given ? n0[at] : 0.f;
    st[2 * P + i] = given ? m0[at] : -INFINITY;
  }

  for (int t = 0; t < S; ++t) {
    float* gnow = gx_s + (t & 1) * B * U4;
    if (t + 1 < S)
      fetch_gx(gx_s + ((t + 1) & 1) * B * U4, gx_c, B, S, d, u, nu, j0,
               t + 1);
    cp_async_commit();
    STAMP_STEP;
    STAMP(0);
    for (int i = threadIdx.x; i < B * d; i += kThreads) {
      const int b = i / d, k = i - b * d;
      h_s[i] = t ? __ldcg(hs_c + ((size_t)b * S + t - 1) * d + k)
                 : (h0 ? h0[s0 + i] : 0.f);
    }
    __syncthreads();
    STAMP(1);
    block_matvec(h_s, d, w_s, dp, B, U4, d, red, pre);
    STAMP(2);
    cp_async_wait_prev();
    __syncthreads();
    for (int i = threadIdx.x; i < P; i += kThreads) {
      const int b = i / u, jj = i - b * u;
      if (jj >= nu) continue;
      const int j = j0 + jj;
      float g[4];
#pragma unroll
      for (int q = 0; q < 4; ++q)
        g[q] = (gnow[b * U4 + q * u + jj] + pre[b * U4 + q * u + jj])
               + bias[q * d + j];
      const float c = st[i], n = st[P + i], m = st[2 * P + i];
      const float z = tanhf(g[0]), o = sigmoidf_(g[3]);
      const float logf_ = logsigmoidf_(g[2]);
      const float m_new = fmaxf(logf_ + m, g[1]);
      const float fa = expf(logf_ + m - m_new), ia = expf(g[1] - m_new);
      const float c_new = fa * c + ia * z, n_new = fa * n + ia;
      const float h = o * c_new / fmaxf(n_new, 1.f);
      st[i] = c_new;
      st[P + i] = n_new;
      st[2 * P + i] = m_new;
      const size_t row = sS + (size_t)b * S + t;
      hs[row * d + j] = h;
      if (Gs) {
#pragma unroll
        for (int q = 0; q < 4; ++q) Gs[row * 4 * d + q * d + j] = g[q];
        Cs[row * d + j] = c_new;
        Ns[row * d + j] = n_new;
        Ms[row * d + j] = m_new;
      }
      if (t == S - 1) {
        const size_t at = s0 + (size_t)b * d + j;
        cout[at] = c_new;
        nout[at] = n_new;
        mout[at] = m_new;
        hout[at] = h;
      }
    }
    STAMP(3);
    if (t + 1 < S) grid_barrier(count, ++met * gridDim.x);
    STAMP(4);
  }
  }
  STAMP_END(0);
}

// Step t's g, dhs, c n m and the state before it (t - 1's; none at t = 0)
// of the block's B x u units into dst (cp.async; the caller commits).
__device__ __forceinline__ void fetch_bwd(float* dst, const float* Gs,
                                          const float* Cs, const float* Ns,
                                          const float* Ms, const float* dhs,
                                          int B, int S, int d, int u, int nu,
                                          int j0, int t) {
  const int P = B * u;
  for (int i = threadIdx.x; i < P; i += kThreads) {
    const int b = i / u, jj = i - b * u;
    if (jj >= nu) continue;
    const size_t row = (size_t)b * S + t, at = row * d + j0 + jj;
#pragma unroll
    for (int q = 0; q < 4; ++q)
      cp_async4(dst + q * P + i, Gs + row * 4 * d + q * d + j0 + jj);
    cp_async4(dst + 4 * P + i, dhs + at);
    cp_async4(dst + 5 * P + i, Cs + at);
    cp_async4(dst + 6 * P + i, Ns + at);
    cp_async4(dst + 7 * P + i, Ms + at);
    if (t) {
      cp_async4(dst + 8 * P + i, Cs + at - d);
      cp_async4(dst + 9 * P + i, Ns + at - d);
      cp_async4(dst + 10 * P + i, Ms + at - d);
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1)
slstm_bwd(const float* __restrict__ wr, const float* __restrict__ c0,
          const float* __restrict__ n0, const float* __restrict__ m0,
          const float* __restrict__ Gs, const float* __restrict__ Cs,
          const float* __restrict__ Ns, const float* __restrict__ Ms,
          const float* __restrict__ dhs, const float* __restrict__ dcT,
          const float* __restrict__ dnT, const float* __restrict__ dmT,
          const float* __restrict__ dhT, float* dG, float* __restrict__ dc0,
          float* __restrict__ dn0, float* __restrict__ dm0,
          float* __restrict__ dh0, unsigned* count, int Ball, int S, int d,
          int u, int rows) {
  extern __shared__ float smem[];
  const int D4 = 4 * d, Pr = rows * u;
  float* w_s = smem;                               // [u][4d]
  float* dg_s = w_s + (size_t)u * D4;              // [rows][4d]
  float* red = dg_s + (size_t)rows * D4;           // [parts][rows][u]
  float* dhr = red + (size_t)kMaxParts * Pr;       // [rows][u]
  float* pf = dhr + Pr;                            // [2][11][rows][u]
  float* st = pf + 2 * (size_t)kBwdStage * Pr;     // dc, dn, dm: [3][rows][u]
  const int j0 = blockIdx.x * u, nu = min(u, d - j0);
  unsigned met = 0;                                // barriers passed
  STAMP_BEGIN;

  for (int i = threadIdx.x; i < u * D4; i += kThreads) {
    const int jj = i / D4, col = i - jj * D4;
    w_s[i] = jj < nu ? wr[(size_t)(j0 + jj) * D4 + col] : 0.f;
  }
  for (int b0 = 0; b0 < Ball; b0 += rows) {
  // chunk b0: its rows' slices of every (B, ...) tensor
  const int B = min(rows, Ball - b0), P = B * u;
  const size_t s0 = (size_t)b0 * d, sS = (size_t)b0 * S;
  const float* Gs_c = Gs + sS * D4;
  const float* Cs_c = Cs + sS * d;
  const float* Ns_c = Ns + sS * d;
  const float* Ms_c = Ms + sS * d;
  const float* dhs_c = dhs + sS * d;
  float* dG_c = dG + sS * D4;
  __syncthreads();             // the chunk before is done with the buffers
  fetch_bwd(pf + ((S - 1) & 1) * kBwdStage * P, Gs_c, Cs_c, Ns_c, Ms_c, dhs_c,
            B, S, d, u, nu, j0, S - 1);
  cp_async_commit();
  for (int i = threadIdx.x; i < P; i += kThreads) {
    const int b = i / u, jj = i - b * u;
    const bool ok = jj < nu;
    const size_t at = s0 + (size_t)b * d + j0 + jj;
    st[i] = ok && dcT ? dcT[at] : 0.f;
    st[P + i] = ok && dnT ? dnT[at] : 0.f;
    st[2 * P + i] = ok && dmT ? dmT[at] : 0.f;
    dhr[i] = ok && dhT ? dhT[at] : 0.f;
  }

  for (int t = S - 1; t >= 0; --t) {
    const float* now = pf + (t & 1) * kBwdStage * P;
    if (t > 0)
      fetch_bwd(pf + ((t - 1) & 1) * kBwdStage * P, Gs_c, Cs_c, Ns_c, Ms_c,
                dhs_c, B, S, d, u, nu, j0, t - 1);
    cp_async_commit();
    cp_async_wait_prev();
    __syncthreads();
    STAMP_STEP;
    STAMP(0);
    for (int i = threadIdx.x; i < P; i += kThreads) {
      const int b = i / u, jj = i - b * u;
      if (jj >= nu) continue;
      const int j = j0 + jj;
      const float zi = now[i], ii = now[P + i], fi = now[2 * P + i],
                  oi = now[3 * P + i];
      const float c_t = now[5 * P + i], n_t = now[6 * P + i],
                  m_t = now[7 * P + i];
      float c_p = 0.f, n_p = 0.f, m_p = -INFINITY;
      if (t) {
        c_p = now[8 * P + i];
        n_p = now[9 * P + i];
        m_p = now[10 * P + i];
      } else if (c0) {
        c_p = c0[s0 + (size_t)b * d + j];
        n_p = n0[s0 + (size_t)b * d + j];
        m_p = m0[s0 + (size_t)b * d + j];
      }
      const float z = tanhf(zi), o = sigmoidf_(oi);
      const float a = logsigmoidf_(fi) + m_p;
      const float fa = expf(a - m_t), ia = expf(ii - m_t);
      const float D = fmaxf(n_t, 1.f);
      const float h_t = o * c_t / D;
      const float dh = now[4 * P + i] + dhr[i];
      const float q = dh / D;
      const float d_o = q * c_t;
      const float dc = st[i] + q * o;
      const float dn = st[P + i] + (-dh * (h_t / D)) * tie_weight(n_t, 1.f);
      const float dfa = dc * c_p + dn * n_p;
      const float dia = dc * z + dn;
      const float ea = dfa * fa, ei = dia * ia;
      const float dmt = st[2 * P + i] - ea - ei;
      const float wa = tie_weight(a, ii);
      const float da = ea + dmt * wa;
      const float di = ei + dmt * (1.f - wa);
      const float dg[4] = {dc * ia * (1.f - z * z), di,
                           da * sigmoidf_(-fi), d_o * o * (1.f - o)};
      const size_t row = (size_t)b * S + t;
#pragma unroll
      for (int k = 0; k < 4; ++k) dG_c[row * D4 + k * d + j] = dg[k];
      st[i] = dc * fa;
      st[P + i] = dn * fa;
      st[2 * P + i] = da;
    }
    STAMP(1);
    if (t == 0 && dh0 == nullptr) break;
    grid_barrier(count, ++met * gridDim.x);
    STAMP(2);
    for (int i = threadIdx.x; i < B * D4; i += kThreads) {
      const int b = i / D4, col = i - b * D4;
      dg_s[i] = __ldcg(dG_c + ((size_t)b * S + t) * D4 + col);
    }
    __syncthreads();
    STAMP(3);
    block_matvec(dg_s, D4, w_s, D4, B, u, D4, red, dhr);
    STAMP(4);
  }
  if (dh0 != nullptr) {
    for (int i = threadIdx.x; i < P; i += kThreads) {
      const int b = i / u, jj = i - b * u;
      if (jj >= nu) continue;
      const size_t at = s0 + (size_t)b * d + j0 + jj;
      dc0[at] = st[i];
      dn0[at] = st[P + i];
      dm0[at] = st[2 * P + i];
      dh0[at] = dhr[i];
    }
  }
  }
  STAMP_END(1);
}

// S grid barriers and nothing else, on the forward's grid: the floor of
// the chain of steps.
__global__ void __launch_bounds__(kThreads, 1)
slstm_barriers(unsigned* count, int S) {
  for (int t = 0; t + 1 < S; ++t)
    grid_barrier(count, (unsigned)(t + 1) * gridDim.x);
}

int sm_count(int* sms, int* optin) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (!e) e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (!e)
    e = cudaDeviceGetAttribute(optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  return e;
}

// `blocks` blocks of `kernel` on the card's `sms` SMs, all resident at
// once, after zeroing the barrier's counter; a grid that cannot be
// resident is refused (by the occupancy API here, and by CUDA).
template <typename Kernel, typename... Args>
int launch_coop(Kernel kernel, int blocks, int sms, long long smem,
                unsigned* count, cudaStream_t stream, Args... args) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (!e) e = cudaMemsetAsync(count, 0, sizeof(unsigned), stream);
  if (e) return e;
  int resident = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, kernel,
                                                    kThreads, (size_t)smem);
  if (e) return e;
  if (resident * sms < blocks) return cudaErrorCooperativeLaunchTooLarge;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, args...);
  return e ? e : cudaGetLastError();
}

// The rows of a chunk of B when a block's shared memory is base + per_row
// floats a row and may hold `optin` bytes: as few chunks as fit, their
// rows equal but the last's; 0 when not even one row fits.
int chunk_rows(int B, long long base, long long per_row, int optin) {
  const long long most = (optin / 4 - base) / per_row;
  if (most < 1) return 0;
  const long long chunks = (B + most - 1) / most;
  return (int)((B + chunks - 1) / chunks);
}

}  // namespace

extern "C" {

// The grid for B batch rows and d hidden units on the current card: u
// units a block, `blocks` blocks, the rows of a chunk of the forward and
// of the backward (0: the kernel cannot take d), the shared memory of
// each a block in bytes (at a chunk's rows, or at one row when it does
// not fit), the card's SMs and its opt-in shared memory a block.
// Returns a CUDA error, or 0.
int slstm_scan_plan(int B, int d, int* u, int* blocks, int* rows_fwd,
                    int* rows_bwd, long long* smem_fwd, long long* smem_bwd,
                    int* sms, int* optin) {
  if (B < 1 || d < 1) return cudaErrorInvalidValue;
  const int e = sm_count(sms, optin);
  if (e) return e;
  *u = (d + *sms - 1) / *sms;
  *blocks = (d + *u - 1) / *u;
  const long long f0 = fwd_smem_floats(0, d, *u), b0 = bwd_smem_floats(0, d, *u);
  *rows_fwd = chunk_rows(B, f0, fwd_smem_floats(1, d, *u) - f0, *optin);
  *rows_bwd = chunk_rows(B, b0, bwd_smem_floats(1, d, *u) - b0, *optin);
  *smem_fwd = 4 * fwd_smem_floats(*rows_fwd ? *rows_fwd : 1, d, *u);
  *smem_bwd = 4 * bwd_smem_floats(*rows_bwd ? *rows_bwd : 1, d, *u);
  return 0;
}

// gx (B, S, 4d), wr (d, 4d), bias (4d), hs (B, S, d) and every state
// (B, d): f32, contiguous.  c0, n0, m0, h0 null together (c = n = h = 0,
// m = -inf) or all given; Gs (B, S, 4d), Cs, Ns, Ms (B, S, d) null
// together (inference) or all given.  count: one unsigned of scratch.
// S >= 1; the wrapper checks shapes and that one row fits.
int slstm_scan_fwd_launch(const void* gx, const void* wr, const void* bias,
                          const void* c0, const void* n0, const void* m0,
                          const void* h0, void* hs, void* cout, void* nout,
                          void* mout, void* hout, void* Gs, void* Cs,
                          void* Ns, void* Ms, void* count, int B, int S,
                          int d, void* stream) {
  int u, blocks, rf, rb, sms, optin;
  long long sf, sb;
  int e = slstm_scan_plan(B, d, &u, &blocks, &rf, &rb, &sf, &sb, &sms, &optin);
  if (e) return e;
  if (S < 1 || rf < 1) return cudaErrorInvalidValue;
  return launch_coop(
      slstm_fwd, blocks, sms, sf, static_cast<unsigned*>(count),
      static_cast<cudaStream_t>(stream), (const float*)gx, (const float*)wr,
      (const float*)bias, (const float*)c0, (const float*)n0,
      (const float*)m0, (const float*)h0, (float*)hs, (float*)cout,
      (float*)nout, (float*)mout, (float*)hout, (float*)Gs, (float*)Cs,
      (float*)Ns, (float*)Ms, static_cast<unsigned*>(count), B, S, d, u, rf);
}

// The forward's wr, initial state (null: the default) and saved Gs, Cs,
// Ns, Ms; dhs (B, S, d); dcT, dnT, dmT, dhT (B, d), the final state's
// gradients, each null for zeros.  Writes dG (B, S, 4d) and, when dh0 is
// not null, dc0, dn0, dm0, dh0 (B, d), the initial state's.
int slstm_scan_bwd_launch(const void* wr, const void* c0, const void* n0,
                          const void* m0, const void* Gs, const void* Cs,
                          const void* Ns, const void* Ms, const void* dhs,
                          const void* dcT, const void* dnT, const void* dmT,
                          const void* dhT, void* dG, void* dc0, void* dn0,
                          void* dm0, void* dh0, void* count, int B, int S,
                          int d, void* stream) {
  int u, blocks, rf, rb, sms, optin;
  long long sf, sb;
  int e = slstm_scan_plan(B, d, &u, &blocks, &rf, &rb, &sf, &sb, &sms, &optin);
  if (e) return e;
  if (S < 1 || rb < 1) return cudaErrorInvalidValue;
  return launch_coop(
      slstm_bwd, blocks, sms, sb, static_cast<unsigned*>(count),
      static_cast<cudaStream_t>(stream), (const float*)wr, (const float*)c0,
      (const float*)n0, (const float*)m0, (const float*)Gs, (const float*)Cs,
      (const float*)Ns, (const float*)Ms, (const float*)dhs,
      (const float*)dcT, (const float*)dnT, (const float*)dmT,
      (const float*)dhT, (float*)dG, (float*)dc0, (float*)dn0, (float*)dm0,
      (float*)dh0, static_cast<unsigned*>(count), B, S, d, u, rb);
}

// S - 1 grid barriers on the forward's grid for one chunk of (B, d),
// nothing else.
int slstm_barriers_launch(void* count, int B, int S, int d, void* stream) {
  int u, blocks, rf, rb, sms, optin;
  long long sf, sb;
  int e = slstm_scan_plan(B, d, &u, &blocks, &rf, &rb, &sf, &sb, &sms, &optin);
  if (e) return e;
  if (S < 1 || rf < 1) return cudaErrorInvalidValue;
  return launch_coop(slstm_barriers, blocks, sms, sf,
                     static_cast<unsigned*>(count),
                     static_cast<cudaStream_t>(stream),
                     static_cast<unsigned*>(count), S);
}

// The stamps of the last launches: g_stamps as n long longs into out
// (host memory); an error when the build has no stamps.
int slstm_stamps(long long* out, long long n) {
#ifdef SLSTM_STAMPS
  if (n > (long long)(sizeof(g_stamps) / sizeof(long long)))
    return cudaErrorInvalidValue;
  cudaError_t e = cudaDeviceSynchronize();
  return e ? e : cudaMemcpyFromSymbol(out, g_stamps, n * sizeof(long long));
#else
  (void)out;
  (void)n;
  return cudaErrorNotSupported;
#endif
}

const char* slstm_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
