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
//   * f32 softmax on bf16 or f32 inputs, the output in the input type;
//   * a row that sees no key writes 0 (the TPU kernel's lsum == 0 guard).
//
// Two kernels, picked by dtype in flash_attention_launch:
//
// bf16: flash_fwd_bf16, on the tensor cores.  Bound: at the prefill shapes
// (Sq = Skv = 1024, D = 128, causal) the function needs 4*B*Hq*D*pairs
// operations on 2*(B*Hq + 2*B*Hkv)*S*D bytes, ~700 operations a byte: far
// above the card's ridge, so it is bound by the bf16 tensor-core rate for
// both products, with the softmax's exponentials (one per visible pair, on
// the special-function units) a second floor at about half of it.  (At
// D = 80 with Hq = Hkv the bytes weigh a little more than the products.)
// Route: mma.sync.m16n8k16 (bf16 in, f32 accumulate) in FlashAttention-2's
// register layout, not wgmma.  A wgmma version (QK^T from shared memory,
// PV with P from registers, no-swizzle core-matrix tiles, also software
// pipelined) passed every check on the card but ran slower: with cp.async
// loads into one or two 64-row warpgroups a block its K/V tiles, not its
// products, set the pace.  Beating this kernel with wgmma takes TMA loads
// from a producer warp into a deeper ring and swizzled tiles.
// Design:
//   * one block of 4 warps per (q tile, query head, batch row), flattened
//     into a 1-D grid with the q tile slowest and heaviest first, so every
//     head's longest causal tiles start before any short one; the heads of
//     one GQA group are neighbours and share K/V tiles in L2;
//   * each warp owns 16 * MT query rows (MT = 2 for D <= 128: a K or V
//     fragment read from shared memory feeds two products);
//   * the Q tile and a ring of two K and two V stages of 64 keys live in
//     shared memory, rows padded by 16 bytes so ldmatrix reads hit 32
//     distinct banks; K/V tile j+1 arrives by cp.async (16 bytes a thread)
//     while tile j is computed, one barrier a tile;
//   * S = Q K^T: Q by ldmatrix, K by ldmatrix (its rows are contiguous
//     along D, the B operand's layout), f32 accumulators;
//   * softmax in f32 registers: the scores are scaled by scale * log2(e)
//     after the product (Q is not rounded again), the row max is taken
//     across the 4 threads of a quad, p = 2^(s - m) by ex2.approx; the
//     running max (and the rescale of O) moves only when a row's max rises
//     by more than 2^8, which keeps p below 2^8 and the result exact; p is
//     rounded to bf16 only as the A operand of P V, repacked from the S
//     accumulators in registers without shared memory;
//   * O += P V: V by ldmatrix.trans; O in f32 registers;
//   * masks are built only on tiles that cut the causal diagonal, the
//     window's edge or the end of the keys; there a masked score is set to
//     a finite sentinel and its p is set to 0 explicitly, so a row that
//     sees no key of a loaded tile adds nothing; a warp whose rows see no
//     key of a tile skips it;
//   * head dims in buckets of DP in {64, 80, 96, 128, 256}: a D that is
//     not DP is zero-filled to DP in shared memory, never read past D;
//   * the output goes through the warp's own Q rows in shared memory and
//     out in 16-byte stores;
//   * a view whose base or (batch, head, row) strides are not 16-byte
//     aligned, or D % 8 != 0, takes 2-byte loads and stores inside the same
//     kernel (a uniform branch), so the wrapper makes no copy.
//
// f32: flash_fwd_f32, for f32 inputs, on the FP32 cores (f32 parity runs
// hold it to 1e-4; TF32 would not meet that).  One block of 256
// threads per (q tile of 64 rows, head, batch); the Q tile (pre-scaled) and
// 64-key K and V tiles in f32 shared memory; thread (ty, tx) owns 4 rows
// and the columns tx + 16j of the 64x64 score tile; only visible kv tiles
// are loaded, heaviest q tiles first.
//
// Neither kernel uses atomics or splits the keys: two launches give the
// same bits.  Built by nvcc for sm_90a into a shared library with a plain C
// interface (repro_torch/kernels/_build.py); the entry point returns
// cudaGetLastError() so the Python wrapper raises on a refused launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kBK = 64;        // keys per streamed tile (both kernels)

struct Strides {            // in elements; the head_dim stride is 1
  long long b, h, s;
};

// The visible kv tiles [begin, end) of the query rows whose absolute
// positions are q_lo..q_hi.
__device__ __forceinline__ void visible_tiles(int q_lo, int q_hi, int Skv,
                                              int causal, int window,
                                              int& begin, int& end) {
  const int nkt = (Skv + kBK - 1) / kBK;
  end = nkt;
  if (causal) end = q_hi < 0 ? 0 : min(nkt, q_hi / kBK + 1);
  begin = 0;
  if (window > 0) {
    const int lo = q_lo - window + 1;          // first key row q_lo sees
    if (lo > 0) begin = lo / kBK;
  }
}

// ---------------------------------------------------------------------------
// f32 inputs: the FP32-core kernel
// ---------------------------------------------------------------------------

constexpr int kThreadsF32 = 256;
constexpr int kBQF32 = 64;     // query rows per block

// Load rows [row0, row0 + 64) of one (b, h) slice into an f32 tile with
// rows of LD floats; rows past `rows` and columns past D are zero.
template <int DP, int LD>
__device__ __forceinline__ void load_tile_f32(float* dst,
                                              const float* __restrict__ src,
                                              Strides st, int row0, int rows,
                                              int D, float mul) {
  for (int idx = threadIdx.x; idx < kBK * DP; idx += kThreadsF32) {
    const int r = idx / DP;
    const int c = idx % DP;
    const int row = row0 + r;
    float x = 0.f;
    if (row < rows && c < D) x = src[(long long)row * st.s + c] * mul;
    dst[r * LD + c] = x;
  }
}

// Shared memory of one block, in floats: Q and K rows padded by one float
// (their columns are read across threads), V and P rows read along.
template <int DP>
constexpr int smem_floats_f32() {
  return (kBQF32 + kBK) * (DP + 1) + kBK * DP + kBQF32 * (kBK + 1);
}

template <int DP>
__global__ void __launch_bounds__(kThreadsF32)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o,
              float* __restrict__ lse, Strides qs, Strides ks, Strides vs,
              Strides os, int G, int Sq, int Skv, int D, int causal,
              int window, float scale) {
  constexpr int NJ = DP / 16;                  // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;                            // [kBQF32][DP + 1]
  float* Ks = Qs + kBQF32 * (DP + 1);          // [kBK][DP + 1]
  float* Vs = Ks + kBK * (DP + 1);             // [kBK][DP]
  float* Ps = Vs + kBK * DP;                   // [kBQF32][kBK + 1]

  const int qt = gridDim.x - 1 - blockIdx.x;   // heaviest tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / G;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int q0 = qt * kBQF32;
  const int offs = Skv - Sq;

  const float* qb = q + b * qs.b + h * qs.h;
  const float* kb = k + b * ks.b + hk * ks.h;
  const float* vb = v + b * vs.b + hk * vs.h;
  load_tile_f32<DP, DP + 1>(Qs, qb, qs, q0, Sq, D, scale);

  int kt_begin, kt_end;
  visible_tiles(q0 + offs, q0 + offs + kBQF32 - 1, Skv, causal, window,
                kt_begin, kt_end);

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
    load_tile_f32<DP, DP + 1>(Ks, kb, ks, k0, Skv, D, 1.f);
    load_tile_f32<DP, DP>(Vs, vb, vs, k0, Skv, D, 1.f);
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

  float* ob = o + b * os.b + h * os.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * ty + i;
    if (row >= Sq) continue;
    const float inv = l[i] > 0.f ? 1.f / l[i] : 0.f;
    if (lse != nullptr && tx == 0)
      lse[((long long)b * gridDim.y + h) * Sq + row] =
          l[i] > 0.f ? m[i] + logf(l[i]) : -INFINITY;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = tx + 16 * j;
      if (c < D) ob[(long long)row * os.s + c] = acc[i][j] * inv;
    }
  }
}

template <int DP>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o,
                       float* lse, int B, int Hq, int Hkv, int Sq, int Skv,
                       int D,
                       const long long* st, int causal, int window,
                       float scale, cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats_f32<DP>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_f32<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + kBQF32 - 1) / kBQF32, Hq, B);
  flash_fwd_f32<DP><<<grid, kThreadsF32, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse,
      Strides{st[0], st[1], st[2]}, Strides{st[3], st[4], st[5]},
      Strides{st[6], st[7], st[8]}, Strides{st[9], st[10], st[11]},
      Hq / Hkv, Sq, Skv, D, causal, window, scale);
  return cudaGetLastError();
}

cudaError_t dispatch_f32(const void* q, const void* k, const void* v,
                         void* o, float* lse, int B, int Hq, int Hkv, int Sq,
                         int Skv, int D, const long long* st, int causal,
                         int window, float scale, cudaStream_t stream) {
  if (D <= 64)
    return launch_f32<64>(q, k, v, o, lse, B, Hq, Hkv, Sq, Skv, D, st,
                          causal, window, scale, stream);
  if (D <= 128)
    return launch_f32<128>(q, k, v, o, lse, B, Hq, Hkv, Sq, Skv, D, st,
                           causal, window, scale, stream);
  return launch_f32<256>(q, k, v, o, lse, B, Hq, Hkv, Sq, Skv, D, st,
                         causal, window, scale, stream);
}

// ---------------------------------------------------------------------------
// bf16 inputs: the tensor-core kernel
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;

// A row keeps its running max m until a tile raises it by more than this
// (in log2 units): p = 2^(s - m) then stays below 2^8, which f32 sums and
// bf16 operands hold as exactly as values below 1, and the output's
// rescale by 2^(m_old - m_new) runs only on the tiles that raise it.
constexpr float kRescaleLog2 = 8.f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Four 8x8 b16 matrices; lane l gives the row address of matrix l / 8, row
// l % 8, and receives of matrix i (in r[i]) row l / 4, columns 2(l % 4)
// and 2(l % 4) + 1 (.trans: column l / 4, rows 2(l % 4) and 2(l % 4) + 1).
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c (16x8 f32) += a (16x16 bf16, row) * b (16x8 bf16, col).  With g = lane
// / 4 and t = lane % 4: a = {(g, 2t..), (g+8, 2t..), (g, 2t+8..),
// (g+8, 2t+8..)}, b = {(k 2t.., n g), (k 2t+8.., n g)}, c = {(g, 2t),
// (g, 2t+1), (g+8, 2t), (g+8, 2t+1)}.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 x = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&x);
}

// 2^x in one special-function instruction (results below 2^-126 are 0).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Rows [row0, row0 + ROWS) of one (b, h) slice, columns [0, DP), into
// shared rows of LDS elements; rows past `rows` and columns past D are
// zero.  vec: row addresses are 16-byte aligned and D % 8 == 0, so 16-byte
// chunks go by cp.async; otherwise by 2-byte loads.
template <int ROWS, int DP, int LDS>
__device__ __forceinline__ void load_tile(bf16* dst,
                                          const bf16* __restrict__ src,
                                          long long stride, int row0,
                                          int rows, int D, bool vec) {
  if (vec) {
    constexpr int CH = DP / 8;
    static_assert(ROWS * CH % kThreads == 0, "whole chunks a thread");
#pragma unroll
    for (int it = 0; it < ROWS * CH / kThreads; ++it) {
      const int i = threadIdx.x + it * kThreads;
      const int r = i / CH;
      const int c = (i % CH) * 8;
      const int row = row0 + r;
      bf16* d = dst + r * LDS + c;
      if (row < rows && c < D)
        cp_async_16(smem_addr(d), src + row * stride + c);
      else
        *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
    }
  } else {
    for (int i = threadIdx.x; i < ROWS * DP; i += kThreads) {
      const int r = i / DP;
      const int c = i % DP;
      const int row = row0 + r;
      dst[r * LDS + c] = row < rows && c < D ? src[row * stride + c]
                                             : __float2bfloat16(0.f);
    }
  }
}

// One tile's online-softmax step for a warp's rows: scale the scores s to
// log2 units, mask them (kMask), update the running max m (only when some
// row of the warp rises by more than kRescaleLog2) and the per-thread
// partial sum l, rescale the output accumulators when m moved, and leave p
// in s.  pos0: absolute position of row g of the warp's first m tile;
// key0: key of the thread's first score column.
template <bool kMask, int MT, int NO>
__device__ __forceinline__ void online_softmax(float (&s)[MT][8][4],
                                               float (&m)[MT][2],
                                               float (&l)[MT][2],
                                               float (&acc)[MT][NO][4],
                                               float scale_log2, int pos0,
                                               int key0, int Skv, int causal,
                                               int window) {
  bool vis[MT][2][8][2];
  float mx[MT][2];
  bool rise = false;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {           // rows g and g + 8
      const int pos = pos0 + 16 * mt + 8 * hr;
      float x_max = kNegInf;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = s[mt][j][2 * hr + e];
          x *= scale_log2;
          vis[mt][hr][j][e] = true;
          if (kMask) {
            const int key = key0 + 8 * j + e;
            vis[mt][hr][j][e] = key < Skv && (!causal || key <= pos) &&
                                (window <= 0 || pos - key < window);
            if (!vis[mt][hr][j][e]) x = kNegInf;
          }
          x_max = fmaxf(x_max, x);
        }
      }
      x_max = fmaxf(x_max, __shfl_xor_sync(0xffffffffu, x_max, 1));
      x_max = fmaxf(x_max, __shfl_xor_sync(0xffffffffu, x_max, 2));
      mx[mt][hr] = x_max;
      rise |= x_max > m[mt][hr] + kRescaleLog2;
    }
  }
  if (__any_sync(0xffffffffu, rise)) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const float m_new = fmaxf(m[mt][hr], mx[mt][hr]);
        const float alpha = ex2(m[mt][hr] - m_new);
        m[mt][hr] = m_new;
        l[mt][hr] *= alpha;
#pragma unroll
        for (int dn = 0; dn < NO; ++dn) {
          acc[mt][dn][2 * hr] *= alpha;
          acc[mt][dn][2 * hr + 1] *= alpha;
        }
      }
    }
  }
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = s[mt][j][2 * hr + e];
          x = vis[mt][hr][j][e] ? ex2(x - m[mt][hr]) : 0.f;
          rs += x;
        }
      }
      l[mt][hr] += rs;
    }
  }
}

template <int DP, int MT>
constexpr int smem_bytes_bf16() {
  return (16 * MT * kWarps + 4 * kBK) * (DP + 8) * 2;
}

// DP: head-dim bucket; MT: 16-row m tiles a warp; MB: blocks an SM for the
// register budget (__launch_bounds__).
template <int DP, int MT, int MB>
__global__ void __launch_bounds__(kThreads, MB)
flash_fwd_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, bf16* __restrict__ o,
               float* __restrict__ lse, Strides qs, Strides ks, Strides vs,
               Strides os, int B, int Hq, int G,
               int Sq, int Skv, int D, int causal, int window,
               float scale_log2, int vec) {
  constexpr int WR = 16 * MT;                  // query rows a warp
  constexpr int BQ = WR * kWarps;              // query rows a block
  constexpr int LDS = DP + 8;                  // padded shared row
  constexpr int KD = DP / 16;                  // k steps of Q K^T
  constexpr int NO = DP / 8;                   // n tiles of O
  static_assert(DP % 16 == 0 && kBK == 64, "fragment layout");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);  // [BQ][LDS]
  bf16* sK = sQ + BQ * LDS;                      // [2][kBK][LDS]
  bf16* sV = sK + 2 * kBK * LDS;                 // [2][kBK][LDS]

  const int nbh = B * Hq;
  const int qt = gridDim.x / nbh - 1 - blockIdx.x / nbh;  // heaviest first
  const int h = blockIdx.x % nbh % Hq;
  const int b = blockIdx.x % nbh / Hq;
  const int hk = h / G;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int q0 = qt * BQ;
  const int offs = Skv - Sq;

  const bf16* qb = q + b * qs.b + h * qs.h;
  const bf16* kb = k + b * ks.b + hk * ks.h;
  const bf16* vb = v + b * vs.b + hk * vs.h;

  int kt_begin, kt_end;
  visible_tiles(q0 + offs, min(q0 + BQ, Sq) - 1 + offs, Skv, causal, window,
                kt_begin, kt_end);
  const int nt = kt_end - kt_begin;

  // this warp's rows: [wr0, wr0 + WR) of the tile, absolute positions
  // w_lo..w_hi (rows past Sq left out)
  const int wr0 = warp * WR;
  const int w_lo = q0 + wr0 + offs;
  const int w_hi = min(q0 + wr0 + WR, Sq) - 1 + offs;
  const bool w_rows = q0 + wr0 < Sq;

  load_tile<BQ, DP, LDS>(sQ, qb, qs.s, q0, Sq, D, vec);
  if (nt > 0) {
    load_tile<kBK, DP, LDS>(sK, kb, ks.s, kt_begin * kBK, Skv, D, vec);
    load_tile<kBK, DP, LDS>(sV, vb, vs.s, kt_begin * kBK, Skv, D, vec);
  }
  cp_async_commit();

  float acc[MT][NO][4], m[MT][2], l[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      m[mt][hr] = kNegInf;
      l[mt][hr] = 0.f;
    }
#pragma unroll
    for (int dn = 0; dn < NO; ++dn)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][dn][e] = 0.f;
  }

  for (int i = 0; i < nt; ++i) {
    const int k0 = (kt_begin + i) * kBK;
    cp_async_wait_all();                       // tile i (and Q) landed here
    __syncthreads();                           // ... and everywhere; tile
                                               // i - 1's stage is free
    if (i + 1 < nt) {                          // tile i + 1 into that stage,
      const int st = (i + 1) & 1;              // copied while i is computed
      load_tile<kBK, DP, LDS>(sK + st * kBK * LDS, kb, ks.s, k0 + kBK, Skv,
                              D, vec);
      load_tile<kBK, DP, LDS>(sV + st * kBK * LDS, vb, vs.s, k0 + kBK, Skv,
                              D, vec);
      cp_async_commit();
    }

    const bf16* cK = sK + (i & 1) * kBK * LDS;
    const bf16* cV = sV + (i & 1) * kBK * LDS;
    // does any row of this warp see a key of this tile?
    const bool any = w_rows && (!causal || k0 <= w_hi) &&
                     (window <= 0 || k0 + kBK - 1 > w_lo - window);
    if (!any) continue;

    float s[MT][8][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[mt][j][e] = 0.f;

    // S = Q K^T over D, 16 at a time
#pragma unroll
    for (int kd = 0; kd < KD; ++kd) {
      uint32_t a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        ldmatrix_x4(a[mt], smem_addr(sQ + (wr0 + 16 * mt + (lane & 15)) *
                                              LDS + 16 * kd +
                                          (lane >> 4) * 8));
#pragma unroll
      for (int np = 0; np < 4; ++np) {         // keys 16 np .. 16 np + 15
        uint32_t bk[4];
        ldmatrix_x4(bk, smem_addr(cK + (16 * np + (lane & 7) +
                                        (lane >> 4) * 8) * LDS +
                                  16 * kd + ((lane >> 3) & 1) * 8));
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_bf16(s[mt][2 * np], a[mt], bk[0], bk[1]);
          mma_bf16(s[mt][2 * np + 1], a[mt], bk[2], bk[3]);
        }
      }
    }

    const bool full = k0 + kBK <= Skv && (!causal || k0 + kBK - 1 <= w_lo) &&
                      (window <= 0 || k0 > w_hi - window);
    if (full)
      online_softmax<false, MT, NO>(s, m, l, acc, scale_log2, 0, 0, 0, 0, 0);
    else
      online_softmax<true, MT, NO>(s, m, l, acc, scale_log2, w_lo + g,
                                   k0 + 2 * t, Skv, causal, window);

    // O += P V over the tile's keys, 16 at a time; P from registers
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t pa[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        pa[mt][0] = pack_bf16(s[mt][2 * kk][0], s[mt][2 * kk][1]);
        pa[mt][1] = pack_bf16(s[mt][2 * kk][2], s[mt][2 * kk][3]);
        pa[mt][2] = pack_bf16(s[mt][2 * kk + 1][0], s[mt][2 * kk + 1][1]);
        pa[mt][3] = pack_bf16(s[mt][2 * kk + 1][2], s[mt][2 * kk + 1][3]);
      }
#pragma unroll
      for (int dp = 0; dp < DP / 16; ++dp) {   // columns 16 dp .. 16 dp + 15
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, smem_addr(cV + (16 * kk + (lane & 15)) * LDS +
                                        16 * dp + (lane >> 4) * 8));
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_bf16(acc[mt][2 * dp], pa[mt], bv[0], bv[1]);
          mma_bf16(acc[mt][2 * dp + 1], pa[mt], bv[2], bv[3]);
        }
      }
    }
  }
  cp_async_wait_all();
  __syncthreads();                             // Q's copies done everywhere

  // normalise, stage the warp's rows in its own Q rows, store
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      float sum = l[mt][hr];
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      const float inv = sum > 0.f ? 1.f / sum : 0.f;
      const int r = q0 + wr0 + 16 * mt + 8 * hr + g;
      if (lse != nullptr && t == 0 && r < Sq)   // m, sum in log2 units
        lse[((long long)b * Hq + h) * Sq + r] =
            sum > 0.f ? (m[mt][hr] + log2f(sum)) * kLn2 : -INFINITY;
      bf16* row = sQ + (wr0 + 16 * mt + 8 * hr + g) * LDS + 2 * t;
#pragma unroll
      for (int dn = 0; dn < NO; ++dn)
        *reinterpret_cast<uint32_t*>(row + 8 * dn) =
            pack_bf16(acc[mt][dn][2 * hr] * inv,
                      acc[mt][dn][2 * hr + 1] * inv);
    }
  }
  __syncwarp();
  bf16* ob = o + b * os.b + h * os.h;
  if (vec) {
    constexpr int CH = DP / 8;
#pragma unroll
    for (int it = 0; it < WR * CH / 32; ++it) {
      const int i = lane + 32 * it;
      const int r = i / CH;
      const int c = (i % CH) * 8;
      const int row = q0 + wr0 + r;
      if (row < Sq && c < D)
        *reinterpret_cast<uint4*>(ob + row * os.s + c) =
            *reinterpret_cast<const uint4*>(sQ + (wr0 + r) * LDS + c);
    }
  } else {
    for (int i = lane; i < WR * DP; i += 32) {
      const int r = i / DP;
      const int c = i % DP;
      const int row = q0 + wr0 + r;
      if (row < Sq && c < D) ob[row * os.s + c] = sQ[(wr0 + r) * LDS + c];
    }
  }
}

// scale * log2(e), rounded once from double: the forward's and the
// backward's exponent scale are the same float.
float log2_scale(float scale) { return (float)(scale * 1.4426950408889634); }

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

template <int DP, int MT, int MB>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o,
                        float* lse, int B, int Hq, int Hkv, int Sq, int Skv,
                        int D,
                        const long long* st, int causal, int window,
                        float scale, cudaStream_t stream) {
  constexpr int BQ = 16 * MT * kWarps;
  const int smem = smem_bytes_bf16<DP, MT>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_bf16<DP, MT, MB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  const long long blocks = (long long)((Sq + BQ - 1) / BQ) * Hq * B;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  bool vec = D % 8 == 0 && aligned16(q) && aligned16(k) && aligned16(v) &&
             aligned16(o);
  for (int i = 0; i < 12; ++i) vec = vec && st[i] % 8 == 0;
  flash_fwd_bf16<DP, MT, MB><<<(unsigned)blocks, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), lse,
      Strides{st[0], st[1], st[2]}, Strides{st[3], st[4], st[5]},
      Strides{st[6], st[7], st[8]}, Strides{st[9], st[10], st[11]}, B, Hq,
      Hq / Hkv, Sq, Skv, D, causal, window,
      log2_scale(scale), (int)vec);
  return cudaGetLastError();
}

// Head-dim buckets: D runs in the smallest DP >= D.
cudaError_t dispatch_bf16(const void* q, const void* k, const void* v,
                          void* o, float* lse, int B, int Hq, int Hkv, int Sq,
                          int Skv, int D, const long long* st, int causal,
                          int window, float scale, cudaStream_t stream) {
  if (D <= 64)
    return launch_bf16<64, 2, 2>(q, k, v, o, lse, B, Hq, Hkv, Sq, Skv, D, st,
                                 causal, window, scale, stream);
  if (D <= 80)
    return launch_bf16<80, 2, 2>(q, k, v, o, lse, B, Hq, Hkv, Sq, Skv, D, st,
                                 causal, window, scale, stream);
  if (D <= 96)
    return launch_bf16<96, 2, 2>(q, k, v, o, lse, B, Hq, Hkv, Sq, Skv, D, st,
                                 causal, window, scale, stream);
  if (D <= 128)
    return launch_bf16<128, 2, 2>(q, k, v, o, lse, B, Hq, Hkv, Sq, Skv, D,
                                  st, causal, window, scale, stream);
  return launch_bf16<256, 1, 1>(q, k, v, o, lse, B, Hq, Hkv, Sq, Skv, D, st,
                                causal, window, scale, stream);
}

// ---------------------------------------------------------------------------
// Backward: dq, dk, dv from q, k, v, o, dO and the forward's lse
// ---------------------------------------------------------------------------
//
// With P = exp(scale q k^T - lse) (the forward's softmax, made again from
// its row log-sum-exp), dP = dO v^T and delta_i = sum_d dO_i o_i:
//   dS = P * (dP - delta),  dv = P^T dO,  dk = scale dS^T q,  dq = scale dS k.
// Three launches on the caller's stream: flash_bwd_delta (delta, one warp a
// row), the dk/dv kernel (one block per kv tile of 64 keys, kv head and
// batch row, walking the G query heads of its group and every q tile that
// sees the tile) and the dq kernel (one block per q tile of 64 rows, query
// head and batch row, walking the kv tiles the forward walks).  Each
// gradient element is summed by one thread in one order and written once:
// no atomics, so two runs give the same bits.  bf16 runs on the tensor
// cores (mma.sync.m16n8k16, f32 accumulators, the forward's fragment
// layout; P and dS rounded to bf16 only as operands), f32 on the FP32
// cores.  Rows that see no key have lse = -inf; their pairs are masked, so
// their gradients are 0.  The wrapper refuses head dims above 128.

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

constexpr int kBQB = 64;       // query rows a backward tile (both dtypes)

// delta[(b * Hq + h) * Sq + i] = sum_d dO[b, h, i, d] o[b, h, i, d]: 8 rows a
// block of 256 threads, one warp a row.
template <typename T>
__global__ void __launch_bounds__(256)
flash_bwd_delta(const T* __restrict__ o, const T* __restrict__ dout,
                float* __restrict__ delta, Strides os, Strides ds, int Hq,
                int Sq, int D, long long rows) {
  const long long row = (long long)blockIdx.x * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const int i = (int)(row % Sq);
  const long long bh = row / Sq;
  const int h = (int)(bh % Hq);
  const long long b = bh / Hq;
  const T* orow = o + b * os.b + h * os.h + (long long)i * os.s;
  const T* drow = dout + b * ds.b + h * ds.h + (long long)i * ds.s;
  float acc = 0.f;
  for (int c = lane; c < D; c += 32) acc += to_f32(orow[c]) * to_f32(drow[c]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[row] = acc;
}

// The q rows [lo, hi] (clamped to the tile grid) that see some key of kv
// tile [k0, k0 + 64): causal needs pos >= k0, a window pos < k0 + 63 +
// window.  Returns the q tiles [begin, end).
__device__ __forceinline__ void seeing_tiles(int k0, int Sq, int Skv,
                                             int causal, int window,
                                             int& begin, int& end) {
  const int offs = Skv - Sq;
  int lo = causal ? k0 - offs : 0;
  int hi = window > 0 ? k0 + kBK - 2 + window - offs : Sq - 1;
  lo = max(lo, 0);
  hi = min(hi, Sq - 1);
  begin = lo / kBQB;
  end = hi < lo ? begin : hi / kBQB + 1;
}

__device__ __forceinline__ bool sees(int key, int pos, int Skv, int causal,
                                     int window) {
  return key < Skv && (!causal || key <= pos) &&
         (window <= 0 || pos - key < window);
}

// ---- f32, FP32 cores ------------------------------------------------------

template <int DP>
constexpr int smem_floats_bwd_f32() {
  return 4 * kBK * (DP + 1) + 2 * kBK * (kBK + 1) + 2 * kBK;
}

// One block of 256 threads per (kv tile, kv head, batch row); thread
// (ty, tx) owns keys 4 ty + i and the columns tx + 16 j of each tile.
template <int DP>
__global__ void __launch_bounds__(kThreadsF32)
flash_bwd_dkdv_f32(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, const float* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, float* __restrict__ dk,
                   float* __restrict__ dv, Strides qs, Strides ks, Strides vs,
                   Strides dos, Strides dks, Strides dvs, int Hq, int G,
                   int Sq, int Skv, int D, int causal, int window,
                   float scale) {
  constexpr int NJ = DP / 16;
  constexpr int LD = DP + 1;
  extern __shared__ float smem[];
  float* Ks = smem;                  // [64][LD]
  float* Vs = Ks + kBK * LD;         // [64][LD]
  float* Qs = Vs + kBK * LD;         // [64][LD]
  float* Os = Qs + kBK * LD;         // dO, [64][LD]
  float* Ps = Os + kBK * LD;         // P^T, [64 keys][65]
  float* Ss = Ps + kBK * (kBK + 1);  // dS^T, [64 keys][65]
  float* Ls = Ss + kBK * (kBK + 1);  // lse, [64]
  float* Ds = Ls + kBK;              // delta, [64]

  const int kt = blockIdx.x;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int k0 = kt * kBK;
  const int offs = Skv - Sq;
  load_tile_f32<DP, LD>(Ks, k + b * ks.b + hk * ks.h, ks, k0, Skv, D, 1.f);
  load_tile_f32<DP, LD>(Vs, v + b * vs.b + hk * vs.h, vs, k0, Skv, D, 1.f);
  int qt_begin, qt_end;
  seeing_tiles(k0, Sq, Skv, causal, window, qt_begin, qt_end);

  float ak[4][NJ], av[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) ak[i][j] = av[i][j] = 0.f;

  for (int gi = 0; gi < G; ++gi) {
    const int h = hk * G + gi;
    const float* qb = q + b * qs.b + h * qs.h;
    const float* ob = dout + b * dos.b + h * dos.h;
    const long long rb = ((long long)b * Hq + h) * Sq;
    for (int qt = qt_begin; qt < qt_end; ++qt) {
      const int q0 = qt * kBQB;
      __syncthreads();                         // previous tile consumed
      load_tile_f32<DP, LD>(Qs, qb, qs, q0, Sq, D, 1.f);
      load_tile_f32<DP, LD>(Os, ob, dos, q0, Sq, D, 1.f);
      if (threadIdx.x < kBQB) {
        const int row = q0 + threadIdx.x;
        Ls[threadIdx.x] = row < Sq ? lse[rb + row] : 0.f;
        Ds[threadIdx.x] = row < Sq ? delta[rb + row] : 0.f;
      }
      __syncthreads();

      float st[4][4], dp[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) st[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < DP; ++d) {
        float a[4], c[4], e[4], f[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          a[i] = Ks[(4 * ty + i) * LD + d];
          e[i] = Vs[(4 * ty + i) * LD + d];
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          c[j] = Qs[(tx + 16 * j) * LD + d];
          f[j] = Os[(tx + 16 * j) * LD + d];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            st[i][j] = fmaf(a[i], c[j], st[i][j]);
            dp[i][j] = fmaf(e[i], f[j], dp[i][j]);
          }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int key = k0 + 4 * ty + i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int qr = tx + 16 * j;
          const bool vis = q0 + qr < Sq &&
                           sees(key, q0 + qr + offs, Skv, causal, window);
          const float p = vis ? expf(st[i][j] * scale - Ls[qr]) : 0.f;
          Ps[(4 * ty + i) * (kBK + 1) + qr] = p;
          Ss[(4 * ty + i) * (kBK + 1) + qr] = p * (dp[i][j] - Ds[qr]);
        }
      }
      __syncthreads();                         // P^T, dS^T complete
#pragma unroll 4
      for (int r = 0; r < kBQB; ++r) {
        float p[4], s2[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          p[i] = Ps[(4 * ty + i) * (kBK + 1) + r];
          s2[i] = Ss[(4 * ty + i) * (kBK + 1) + r];
        }
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const float o_ = Os[r * LD + tx + 16 * j];
          const float q_ = Qs[r * LD + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            av[i][j] = fmaf(p[i], o_, av[i][j]);
            ak[i][j] = fmaf(s2[i], q_, ak[i][j]);
          }
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + 4 * ty + i;
    if (key >= Skv) continue;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = tx + 16 * j;
      if (c >= D) continue;
      dk[b * dks.b + hk * dks.h + (long long)key * dks.s + c] =
          ak[i][j] * scale;
      dv[b * dvs.b + hk * dvs.h + (long long)key * dvs.s + c] = av[i][j];
    }
  }
}

// One block of 256 threads per (q tile, query head, batch row); thread
// (ty, tx) owns rows 4 ty + i and the columns tx + 16 j.
template <int DP>
__global__ void __launch_bounds__(kThreadsF32)
flash_bwd_dq_f32(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, float* __restrict__ dq,
                 Strides qs, Strides ks, Strides vs, Strides dos,
                 Strides dqs, int G, int Sq, int Skv, int D, int causal,
                 int window, float scale) {
  constexpr int NJ = DP / 16;
  constexpr int LD = DP + 1;
  extern __shared__ float smem[];
  float* Qs = smem;                  // [64][LD]
  float* Os = Qs + kBK * LD;         // dO, [64][LD]
  float* Ks = Os + kBK * LD;         // [64][LD]
  float* Vs = Ks + kBK * LD;         // [64][LD]
  float* Ss = Vs + kBK * LD;         // dS, [64 rows][65]
  float* Ls = Ss + 2 * kBK * (kBK + 1);
  float* Ds = Ls + kBK;

  const int qt = gridDim.x - 1 - blockIdx.x;   // heaviest tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / G;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int q0 = qt * kBQB;
  const int offs = Skv - Sq;
  const long long rb = ((long long)b * gridDim.y + h) * Sq;
  load_tile_f32<DP, LD>(Qs, q + b * qs.b + h * qs.h, qs, q0, Sq, D, 1.f);
  load_tile_f32<DP, LD>(Os, dout + b * dos.b + h * dos.h, dos, q0, Sq, D,
                        1.f);
  if (threadIdx.x < kBQB) {
    const int row = q0 + threadIdx.x;
    Ls[threadIdx.x] = row < Sq ? lse[rb + row] : 0.f;
    Ds[threadIdx.x] = row < Sq ? delta[rb + row] : 0.f;
  }
  const float* kb = k + b * ks.b + hk * ks.h;
  const float* vb = v + b * vs.b + hk * vs.h;
  int kt_begin, kt_end;
  visible_tiles(q0 + offs, min(q0 + kBQB, Sq) - 1 + offs, Skv, causal,
                window, kt_begin, kt_end);

  float aq[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) aq[i][j] = 0.f;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();                           // previous tile consumed
    load_tile_f32<DP, LD>(Ks, kb, ks, k0, Skv, D, 1.f);
    load_tile_f32<DP, LD>(Vs, vb, vs, k0, Skv, D, 1.f);
    __syncthreads();
    float st[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) st[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DP; ++d) {
      float a[4], c[4], e[4], f[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = Qs[(4 * ty + i) * LD + d];
        e[i] = Os[(4 * ty + i) * LD + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        c[j] = Ks[(tx + 16 * j) * LD + d];
        f[j] = Vs[(tx + 16 * j) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          st[i][j] = fmaf(a[i], c[j], st[i][j]);
          dp[i][j] = fmaf(e[i], f[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = 4 * ty + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = k0 + tx + 16 * j;
        const bool vis = q0 + r < Sq &&
                         sees(key, q0 + r + offs, Skv, causal, window);
        const float p = vis ? expf(st[i][j] * scale - Ls[r]) : 0.f;
        Ss[r * (kBK + 1) + tx + 16 * j] = p * (dp[i][j] - Ds[r]);
      }
    }
    __syncthreads();                           // dS complete
#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      float s2[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) s2[i] = Ss[(4 * ty + i) * (kBK + 1) + c];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float k_ = Ks[c * LD + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) aq[i][j] = fmaf(s2[i], k_, aq[i][j]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * ty + i;
    if (row >= Sq) continue;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = tx + 16 * j;
      if (c < D)
        dq[b * dqs.b + h * dqs.h + (long long)row * dqs.s + c] =
            aq[i][j] * scale;
    }
  }
}

// ---- bf16, tensor cores ---------------------------------------------------

template <int DP>
constexpr int smem_bytes_bwd_bf16() {
  return (2 * kBK + 4 * kBQB) * (DP + 8) * 2 + 4 * kBQB * 4;
}

// The 16x16 A operand of rows (g, g + 8) and k columns 16 kk .. 16 kk + 15,
// repacked from the f32 accumulators of n tiles 2 kk and 2 kk + 1.
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4],
                                         const float (&c)[8][4], int kk) {
  a[0] = pack_bf16(c[2 * kk][0], c[2 * kk][1]);
  a[1] = pack_bf16(c[2 * kk][2], c[2 * kk][3]);
  a[2] = pack_bf16(c[2 * kk + 1][0], c[2 * kk + 1][1]);
  a[3] = pack_bf16(c[2 * kk + 1][2], c[2 * kk + 1][3]);
}

// c[8][4] (16 rows x 64 columns) = A (the warp's 16 rows of sA) B^T, with B
// the 64 rows of sB, both [rows][LDS] with D along the row.
template <int DP, int LDS>
__device__ __forceinline__ void mma_abt(float (&c)[8][4], const bf16* sA,
                                        const bf16* sB, int lane) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[j][e] = 0.f;
#pragma unroll
  for (int kd = 0; kd < DP / 16; ++kd) {
    uint32_t a[4];
    ldmatrix_x4(a, smem_addr(sA + (lane & 15) * LDS + 16 * kd +
                             (lane >> 4) * 8));
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      uint32_t bk[4];
      ldmatrix_x4(bk, smem_addr(sB + (16 * np + (lane & 7) +
                                      (lane >> 4) * 8) * LDS +
                                16 * kd + ((lane >> 3) & 1) * 8));
      mma_bf16(c[2 * np], a, bk[0], bk[1]);
      mma_bf16(c[2 * np + 1], a, bk[2], bk[3]);
    }
  }
}

// acc[NO][4] (16 rows x DP) += A (16 x 64, from accumulators c) B, with B
// the 64 rows of sB ([rows][LDS], D along the row).
template <int DP, int LDS>
__device__ __forceinline__ void mma_ab(float (&acc)[DP / 8][4],
                                       const float (&c)[8][4], const bf16* sB,
                                       int lane) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    uint32_t a[4];
    acc_to_a(a, c, kk);
#pragma unroll
    for (int dp = 0; dp < DP / 16; ++dp) {
      uint32_t bv[4];
      ldmatrix_x4_trans(bv, smem_addr(sB + (16 * kk + (lane & 15)) * LDS +
                                      16 * dp + (lane >> 4) * 8));
      mma_bf16(acc[2 * dp], a, bv[0], bv[1]);
      mma_bf16(acc[2 * dp + 1], a, bv[2], bv[3]);
    }
  }
}

// Rows (g, g + 8) x columns 2t, 2t + 1 of each 8-column tile of acc, times
// mul, to rows row0 + g (+ 8) of dst (4-byte stores; D is even).
template <int NO>
__device__ __forceinline__ void store_rows(bf16* dst, long long stride,
                                           const float (&acc)[NO][4],
                                           float mul, int row0, int rows,
                                           int D, int g, int t) {
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int row = row0 + g + 8 * hr;
    if (row >= rows) continue;
#pragma unroll
    for (int dn = 0; dn < NO; ++dn) {
      const int c = 8 * dn + 2 * t;
      if (c < D)
        *reinterpret_cast<uint32_t*>(dst + row * stride + c) = pack_bf16(
            acc[dn][2 * hr] * mul, acc[dn][2 * hr + 1] * mul);
    }
  }
}

// One block of 4 warps per (kv tile, kv head, batch row); warp w owns keys
// k0 + 16 w .. + 15.  K and V stay in shared memory; Q, dO, lse and delta
// of the next (query head, q tile) arrive by cp.async while this one is
// computed (two stages).  S^T = K Q^T and dP^T = V dO^T come out in the
// accumulator layout with keys as rows, so P^T and dS^T feed dV += P^T dO
// and dK += dS^T Q as A operands straight from registers.
template <int DP, int MB>
__global__ void __launch_bounds__(kThreads, MB)
flash_bwd_dkdv_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, bf16* __restrict__ dk,
                    bf16* __restrict__ dv, Strides qs, Strides ks, Strides vs,
                    Strides dos, Strides dks, Strides dvs, int B, int Hq,
                    int Hkv, int G, int Sq, int Skv, int D, int causal,
                    int window, float scale_log2, float scale, int vec) {
  constexpr int LDS = DP + 8;
  constexpr int NO = DP / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sK = reinterpret_cast<bf16*>(smem_raw);  // [kBK][LDS]
  bf16* sV = sK + kBK * LDS;                     // [kBK][LDS]
  bf16* sQ = sV + kBK * LDS;                     // [2][kBQB][LDS]
  bf16* sO = sQ + 2 * kBQB * LDS;                // dO, [2][kBQB][LDS]
  float* sL = reinterpret_cast<float*>(sO + 2 * kBQB * LDS);  // [2][kBQB]
  float* sD = sL + 2 * kBQB;                                  // [2][kBQB]

  const int nbh = B * Hkv;
  const int kt = blockIdx.x / nbh;             // causal: heaviest first
  const int hk = blockIdx.x % nbh % Hkv;
  const int b = blockIdx.x % nbh / Hkv;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int k0 = kt * kBK;
  const int offs = Skv - Sq;
  const int w_klo = k0 + 16 * warp;            // this warp's keys
  const int w_khi = w_klo + 15;

  int qt_begin, qt_end;
  seeing_tiles(k0, Sq, Skv, causal, window, qt_begin, qt_end);
  const int nq = qt_end - qt_begin;
  const int n = G * nq;

  // stage st <- (query head hk G + i / nq, q tile qt_begin + i % nq)
  auto load_q = [&](int i, int st) {
    const int h = hk * G + i / nq;
    const int q0 = (qt_begin + i % nq) * kBQB;
    load_tile<kBQB, DP, LDS>(sQ + st * kBQB * LDS, q + b * qs.b + h * qs.h,
                             qs.s, q0, Sq, D, vec);
    load_tile<kBQB, DP, LDS>(sO + st * kBQB * LDS,
                             dout + b * dos.b + h * dos.h, dos.s, q0, Sq, D,
                             vec);
    if (threadIdx.x < kBQB) {
      const int row = q0 + threadIdx.x;
      const long long r = ((long long)b * Hq + h) * Sq + row;
      sL[st * kBQB + threadIdx.x] = row < Sq ? lse[r] * kLog2e : 0.f;
      sD[st * kBQB + threadIdx.x] = row < Sq ? delta[r] : 0.f;
    }
  };

  load_tile<kBK, DP, LDS>(sK, k + b * ks.b + hk * ks.h, ks.s, k0, Skv, D,
                          vec);
  load_tile<kBK, DP, LDS>(sV, v + b * vs.b + hk * vs.h, vs.s, k0, Skv, D,
                          vec);
  if (n > 0) load_q(0, 0);
  cp_async_commit();

  float adk[NO][4], adv[NO][4];
#pragma unroll
  for (int dn = 0; dn < NO; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) adk[dn][e] = adv[dn][e] = 0.f;

  for (int i = 0; i < n; ++i) {
    cp_async_wait_all();                       // stage i landed here
    __syncthreads();                           // ... and everywhere
    if (i + 1 < n) {
      load_q(i + 1, (i + 1) & 1);
      cp_async_commit();
    }
    const int q0 = (qt_begin + i % nq) * kBQB;
    const bf16* cQ = sQ + (i & 1) * kBQB * LDS;
    const bf16* cO = sO + (i & 1) * kBQB * LDS;
    const float* cL = sL + (i & 1) * kBQB;
    const float* cD = sD + (i & 1) * kBQB;
    const int p_lo = q0 + offs;                // positions of the q tile
    const int p_hi = min(q0 + kBQB, Sq) - 1 + offs;
    const bool any = w_klo < Skv && (!causal || w_klo <= p_hi) &&
                     (window <= 0 || p_lo - w_khi < window);
    if (!any) continue;
    const bool full = w_khi < Skv && q0 + kBQB <= Sq &&
                      (!causal || w_khi <= p_lo) &&
                      (window <= 0 || p_hi - w_klo < window);

    float s[8][4], dp[8][4];
    mma_abt<DP, LDS>(s, sK + 16 * warp * LDS, cQ, lane);    // S^T
    mma_abt<DP, LDS>(dp, sV + 16 * warp * LDS, cO, lane);   // dP^T
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qr = 8 * j + 2 * t + (e & 1);
        bool vis = true;
        if (!full)
          vis = q0 + qr < Sq && sees(w_klo + g + 8 * (e >> 1),
                                     q0 + qr + offs, Skv, causal, window);
        const float p = vis ? ex2(s[j][e] * scale_log2 - cL[qr]) : 0.f;
        s[j][e] = p;
        dp[j][e] = p * (dp[j][e] - cD[qr]);
      }
    }
    mma_ab<DP, LDS>(adv, s, cO, lane);         // dV += P^T dO
    mma_ab<DP, LDS>(adk, dp, cQ, lane);        // dK += dS^T Q
  }
  cp_async_wait_all();
  store_rows<NO>(dk + b * dks.b + hk * dks.h, dks.s, adk, scale, w_klo, Skv,
                 D, g, t);
  store_rows<NO>(dv + b * dvs.b + hk * dvs.h, dvs.s, adv, 1.f, w_klo, Skv,
                 D, g, t);
}

// One block of 4 warps per (q tile, query head, batch row); warp w owns
// rows q0 + 16 w .. + 15.  Q and dO stay in shared memory; K and V tiles
// stream in two stages, as in the forward.
template <int DP, int MB>
__global__ void __launch_bounds__(kThreads, MB)
flash_bwd_dq_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, const bf16* __restrict__ dout,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta, bf16* __restrict__ dq,
                  Strides qs, Strides ks, Strides vs, Strides dos,
                  Strides dqs, int B, int Hq, int G, int Sq, int Skv, int D,
                  int causal, int window, float scale_log2, float scale,
                  int vec) {
  constexpr int LDS = DP + 8;
  constexpr int NO = DP / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);  // [kBQB][LDS]
  bf16* sO = sQ + kBQB * LDS;                    // dO, [kBQB][LDS]
  bf16* sK = sO + kBQB * LDS;                    // [2][kBK][LDS]
  bf16* sV = sK + 2 * kBK * LDS;                 // [2][kBK][LDS]

  const int nbh = B * Hq;
  const int qt = gridDim.x / nbh - 1 - blockIdx.x / nbh;  // heaviest first
  const int h = blockIdx.x % nbh % Hq;
  const int b = blockIdx.x % nbh / Hq;
  const int hk = h / G;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int q0 = qt * kBQB;
  const int offs = Skv - Sq;
  const bf16* kb = k + b * ks.b + hk * ks.h;
  const bf16* vb = v + b * vs.b + hk * vs.h;

  int kt_begin, kt_end;
  visible_tiles(q0 + offs, min(q0 + kBQB, Sq) - 1 + offs, Skv, causal, window,
                kt_begin, kt_end);
  const int nt = kt_end - kt_begin;
  const int w_r0 = q0 + 16 * warp;             // this warp's rows
  const int w_lo = w_r0 + offs;
  const int w_hi = min(w_r0 + 16, Sq) - 1 + offs;
  const bool w_rows = w_r0 < Sq;

  float rl[2], rd[2];                          // lse (log2 units), delta
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int row = w_r0 + g + 8 * hr;
    const long long r = ((long long)b * Hq + h) * Sq + row;
    rl[hr] = row < Sq ? lse[r] * kLog2e : 0.f;
    rd[hr] = row < Sq ? delta[r] : 0.f;
  }

  load_tile<kBQB, DP, LDS>(sQ, q + b * qs.b + h * qs.h, qs.s, q0, Sq, D, vec);
  load_tile<kBQB, DP, LDS>(sO, dout + b * dos.b + h * dos.h, dos.s, q0, Sq, D,
                           vec);
  if (nt > 0) {
    load_tile<kBK, DP, LDS>(sK, kb, ks.s, kt_begin * kBK, Skv, D, vec);
    load_tile<kBK, DP, LDS>(sV, vb, vs.s, kt_begin * kBK, Skv, D, vec);
  }
  cp_async_commit();

  float adq[NO][4];
#pragma unroll
  for (int dn = 0; dn < NO; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) adq[dn][e] = 0.f;

  for (int i = 0; i < nt; ++i) {
    const int k0 = (kt_begin + i) * kBK;
    cp_async_wait_all();
    __syncthreads();
    if (i + 1 < nt) {
      const int st = (i + 1) & 1;
      load_tile<kBK, DP, LDS>(sK + st * kBK * LDS, kb, ks.s, k0 + kBK, Skv,
                              D, vec);
      load_tile<kBK, DP, LDS>(sV + st * kBK * LDS, vb, vs.s, k0 + kBK, Skv,
                              D, vec);
      cp_async_commit();
    }
    const bf16* cK = sK + (i & 1) * kBK * LDS;
    const bf16* cV = sV + (i & 1) * kBK * LDS;
    const bool any = w_rows && (!causal || k0 <= w_hi) &&
                     (window <= 0 || k0 + kBK - 1 > w_lo - window);
    if (!any) continue;
    const bool full = k0 + kBK <= Skv && w_r0 + 16 <= Sq &&
                      (!causal || k0 + kBK - 1 <= w_lo) &&
                      (window <= 0 || k0 > w_hi - window);

    float s[8][4], dp[8][4];
    mma_abt<DP, LDS>(s, sQ + 16 * warp * LDS, cK, lane);    // S
    mma_abt<DP, LDS>(dp, sO + 16 * warp * LDS, cV, lane);   // dP
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hr = e >> 1;
        bool vis = true;
        if (!full)
          vis = w_r0 + g + 8 * hr < Sq &&
                sees(k0 + 8 * j + 2 * t + (e & 1), w_lo + g + 8 * hr, Skv,
                     causal, window);
        const float p = vis ? ex2(s[j][e] * scale_log2 - rl[hr]) : 0.f;
        dp[j][e] = p * (dp[j][e] - rd[hr]);
      }
    }
    mma_ab<DP, LDS>(adq, dp, cK, lane);        // dQ += dS K
  }
  cp_async_wait_all();
  store_rows<NO>(dq + b * dqs.b + h * dqs.h, dqs.s, adq, scale, w_r0, Sq, D,
                 g, t);
}

// strides: 24 values in elements, (batch, head, seq) of q, k, v, o, dO, dq,
// dk, dv.
template <typename T>
cudaError_t launch_delta(const void* o, const void* dout, float* delta,
                         int B, int Hq, int Sq, int D, const long long* st,
                         cudaStream_t stream) {
  const long long rows = (long long)B * Hq * Sq;
  const long long blocks = (rows + 7) / 8;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  flash_bwd_delta<T><<<(unsigned)blocks, 256, 0, stream>>>(
      static_cast<const T*>(o), static_cast<const T*>(dout), delta,
      Strides{st[9], st[10], st[11]}, Strides{st[12], st[13], st[14]}, Hq,
      Sq, D, rows);
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch_bwd_f32(const void* q, const void* k, const void* v,
                           const void* dout, const float* lse,
                           const float* delta, void* dq, void* dk, void* dv,
                           int B, int Hq, int Hkv, int Sq, int Skv, int D,
                           const long long* st, int causal, int window,
                           float scale, cudaStream_t stream) {
  const int smem = sizeof(float) * smem_floats_bwd_f32<DP>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkdv_f32<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(flash_bwd_dq_f32<DP>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
  if (err != cudaSuccess) return err;
  const Strides qs{st[0], st[1], st[2]}, ks{st[3], st[4], st[5]},
      vs{st[6], st[7], st[8]}, dos{st[12], st[13], st[14]},
      dqs{st[15], st[16], st[17]}, dks{st[18], st[19], st[20]},
      dvs{st[21], st[22], st[23]};
  const float* fq = static_cast<const float*>(q);
  const float* fk = static_cast<const float*>(k);
  const float* fv = static_cast<const float*>(v);
  const float* fo = static_cast<const float*>(dout);
  flash_bwd_dkdv_f32<DP><<<dim3((Skv + kBK - 1) / kBK, Hkv, B), kThreadsF32,
                           smem, stream>>>(
      fq, fk, fv, fo, lse, delta, static_cast<float*>(dk),
      static_cast<float*>(dv), qs, ks, vs, dos, dks, dvs, Hq, Hq / Hkv, Sq,
      Skv, D, causal, window, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_dq_f32<DP><<<dim3((Sq + kBQB - 1) / kBQB, Hq, B), kThreadsF32,
                         smem, stream>>>(
      fq, fk, fv, fo, lse, delta, static_cast<float*>(dq), qs, ks, vs, dos,
      dqs, Hq / Hkv, Sq, Skv, D, causal, window, scale);
  return cudaGetLastError();
}

template <int DP, int MB>
cudaError_t launch_bwd_bf16(const void* q, const void* k, const void* v,
                            const void* dout, const float* lse,
                            const float* delta, void* dq, void* dk, void* dv,
                            int B, int Hq, int Hkv, int Sq, int Skv, int D,
                            const long long* st, int causal, int window,
                            float scale, cudaStream_t stream) {
  const int smem = smem_bytes_bwd_bf16<DP>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkdv_bf16<DP, MB>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(flash_bwd_dq_bf16<DP, MB>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
  if (err != cudaSuccess) return err;
  const long long kv_blocks = (long long)((Skv + kBK - 1) / kBK) * Hkv * B;
  const long long q_blocks = (long long)((Sq + kBQB - 1) / kBQB) * Hq * B;
  if (kv_blocks > INT_MAX || q_blocks > INT_MAX) return cudaErrorInvalidValue;
  bool vec = D % 8 == 0 && aligned16(q) && aligned16(k) && aligned16(v) &&
             aligned16(dout);
  for (int i = 0; i < 9; ++i) vec = vec && st[i] % 8 == 0;
  for (int i = 12; i < 15; ++i) vec = vec && st[i] % 8 == 0;
  const Strides qs{st[0], st[1], st[2]}, ks{st[3], st[4], st[5]},
      vs{st[6], st[7], st[8]}, dos{st[12], st[13], st[14]},
      dqs{st[15], st[16], st[17]}, dks{st[18], st[19], st[20]},
      dvs{st[21], st[22], st[23]};
  const bf16* bq = static_cast<const bf16*>(q);
  const bf16* bk = static_cast<const bf16*>(k);
  const bf16* bv = static_cast<const bf16*>(v);
  const bf16* bo = static_cast<const bf16*>(dout);
  const float sl2 = log2_scale(scale);
  flash_bwd_dkdv_bf16<DP, MB><<<(unsigned)kv_blocks, kThreads, smem,
                                stream>>>(
      bq, bk, bv, bo, lse, delta, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), qs, ks, vs, dos, dks, dvs, B, Hq, Hkv,
      Hq / Hkv, Sq, Skv, D, causal, window, sl2, scale, (int)vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_dq_bf16<DP, MB><<<(unsigned)q_blocks, kThreads, smem, stream>>>(
      bq, bk, bv, bo, lse, delta, static_cast<bf16*>(dq), qs, ks, vs, dos,
      dqs, B, Hq, Hq / Hkv, Sq, Skv, D, causal, window, sl2, scale,
      (int)vec);
  return cudaGetLastError();
}

cudaError_t dispatch_bwd(const void* q, const void* k, const void* v,
                         const void* o, const void* dout, const float* lse,
                         float* delta, void* dq, void* dk, void* dv,
                         int dtype, int B, int Hq, int Hkv, int Sq, int Skv,
                         int D, const long long* st, int causal, int window,
                         float scale, cudaStream_t s) {
  cudaError_t err =
      dtype == 0 ? launch_delta<float>(o, dout, delta, B, Hq, Sq, D, st, s)
                 : launch_delta<bf16>(o, dout, delta, B, Hq, Sq, D, st, s);
  if (err != cudaSuccess) return err;
  if (dtype == 0) {
    if (D <= 64)
      return launch_bwd_f32<64>(q, k, v, dout, lse, delta, dq, dk, dv, B, Hq,
                                Hkv, Sq, Skv, D, st, causal, window, scale, s);
    return launch_bwd_f32<128>(q, k, v, dout, lse, delta, dq, dk, dv, B, Hq,
                               Hkv, Sq, Skv, D, st, causal, window, scale, s);
  }
  if (D <= 64)
    return launch_bwd_bf16<64, 2>(q, k, v, dout, lse, delta, dq, dk, dv, B, Hq,
                                  Hkv, Sq, Skv, D, st, causal, window, scale,
                                  s);
  if (D <= 80)
    return launch_bwd_bf16<80, 2>(q, k, v, dout, lse, delta, dq, dk, dv, B, Hq,
                                  Hkv, Sq, Skv, D, st, causal, window, scale,
                                  s);
  return launch_bwd_bf16<128, 1>(q, k, v, dout, lse, delta, dq, dk, dv, B, Hq,
                                 Hkv, Sq, Skv, D, st, causal, window, scale,
                                 s);
}

}  // namespace

extern "C" {

// q, o: (B, Hq, Sq, D); k, v: (B, Hkv, Skv, D), each with the head_dim
// stride 1 and the (batch, head, seq) strides in `strides` (12 values in
// elements: q, k, v, o).  dtype 0 = float32 (the FP32-core kernel), 1 =
// bfloat16 (the tensor-core kernel).  window <= 0 means no window.
// D <= 256, Hq % Hkv == 0; the wrapper checks both.  lse: null, or
// (B, Hq, Sq) contiguous f32 that receives each row's natural-log
// log-sum-exp of the scaled scores (-inf for a row that sees no key).
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* o, void* lse, int dtype, int B, int Hq,
                           int Hkv, int Sq, int Skv, int D,
                           const long long* strides, int causal, int window,
                           float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D < 1 || D > 256 || Hkv < 1 || Hq % Hkv) return cudaErrorInvalidValue;
  float* l = static_cast<float*>(lse);
  if (dtype == 0)
    return dispatch_f32(q, k, v, o, l, B, Hq, Hkv, Sq, Skv, D, strides,
                        causal, window, scale, s);
  if (dtype == 1)
    return dispatch_bf16(q, k, v, o, l, B, Hq, Hkv, Sq, Skv, D, strides,
                         causal, window, scale, s);
  return cudaErrorInvalidValue;
}

// The backward of flash_attention_launch: dq (B, Hq, Sq, D), dk and dv
// (B, Hkv, Skv, D) from q, k, v, the forward's o and lse, and dO (the
// gradient of o).  strides: 24 values, (batch, head, seq) of q, k, v, o,
// dO, dq, dk, dv; head_dim strides 1; dq, dk, dv 4-byte aligned rows.
// delta: (B, Hq, Sq) f32 workspace.  D <= 128 and even; the wrapper
// checks.  Three launches on `stream`.
int flash_attention_bwd_launch(const void* q, const void* k, const void* v,
                               const void* o, const void* dout,
                               const void* lse, void* delta, void* dq,
                               void* dk, void* dv, int dtype, int B, int Hq,
                               int Hkv, int Sq, int Skv, int D,
                               const long long* strides, int causal,
                               int window, float scale, void* stream) {
  if (D < 1 || D > 128 || D % 2 || Hkv < 1 || Hq % Hkv || dtype < 0 ||
      dtype > 1)
    return cudaErrorInvalidValue;
  return dispatch_bwd(q, k, v, o, dout, static_cast<const float*>(lse),
                      static_cast<float*>(delta), dq, dk, dv, dtype, B, Hq,
                      Hkv, Sq, Skv, D, strides, causal, window, scale,
                      static_cast<cudaStream_t>(stream));
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
