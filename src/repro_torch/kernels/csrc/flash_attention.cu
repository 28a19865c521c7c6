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

#include <cuda.h>  // CUtensorMap and its enums; the driver is not linked
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
// No kernel here uses atomics: each gradient element is summed in one
// block in one order and written once, so two runs give the same bits.
// Rows that see no key have lse = -inf and gradient 0.  The wrapper
// refuses head dims above 128.  Three routes, picked by bwd_route (the
// wrapper's bwd_route is its mirror) from the dtype, head dim and
// alignment, never from a failed launch:
//
// wgmma (bf16 at D = 64, 80 or 128, q, k, v, o, dO with 16-byte aligned
// bases and strides; MiniCPM-2B's training call, GQA 32/8 at 64 and 128,
// HuBERT-XLarge's and Zamba2-2.7B's head dim 80): flash_bwd_prep, then
// flash_bwd_dkdv_wgmma and flash_bwd_dq_wgmma (the section "bf16 on
// Hopper" below).  Bound at the training shape (4, 2048,
// 48, 64) causal: operations, 10 D a visible pair (five products of 2 D)
// at 989 TFLOP/s, 0.261 ms; the bytes take 0.04 ms.  This split design
// runs seven products (S and dP twice), 3.6e11 operations, and the
// exponentials twice (8.6e8 of them, 0.23 ms at the card's 16 a clock an
// SM).  On an H100 80GB HBM3 at 700 W (tools/attn_bwd_turns.py, versions
// in turns in one process): 0.97 ms against the mma.sync kernels' 2.30
// and SDPA's backward 0.84; dK/dV 0.57, dQ 0.37, prep 0.04.  What holds
// it (tools/attn_bwd_stamps.py): a dK/dV step of a warpgroup takes ~2,300
// cycles against ~1,000 of tensor-core work at peak for both warpgroups;
// the exponentials and the softmax arithmetic (~850), issuing behind the
// other warpgroup's products (~500) and the first stages of each block
// (~290) take the rest.  The steps to this design, each timed in turns
// with the one before: the first version 1.76; the exponentials under
// dP^T and dS under dV 1.74 (against 1.77); the consumers' turns and a
// vector prep pass 1.70; no branch around each pair's ex2 (the mask's
// branch made every exponential wait for the last) 1.02 (against 1.69);
// three dQ consumers at D = 64 0.97 (against 1.02).  Tried and not kept:
//   * the fused design (FA3's deterministic mode): dQ_part = dS K in the
//     dK/dV block from a shared dS^T tile, added to an f32 dq_acc in the
//     kv tiles' order under per-q-tile counters (blocks taken by ticket,
//     a head's kv tiles and q tiles last first): right and equal to the
//     bit, but 3.61 ms against the split's 1.70 of then: the ordered
//     read-add-write chains the 16 kv tiles of every q tile and stalls the
//     consumer that holds it, and the consumers meet at the dS^T tile
//     every step;
//   * 128-row steps at D = 64 (m64n128 first products, dV/dK over k =
//     128): 1.78 against 1.70 (the exponentials no longer overlap dP^T,
//     and dK/dV spilled);
//   * three dK/dV consumers at D = 64 (192 keys a block): 1.01 against
//     0.97, 48 bytes spilled at 160 registers;
//   * K_w, V_w (Q_w, dO_w in dQ) as register A operands loaded by
//     ldmatrix: 0.98 against 1.02, with wrong gradients, not pursued.
// Head dim 80: 160 bytes a row are not a whole 128-byte swizzle row, so a
// tile is laid out as at D = 128, two 64-column halves, and the second
// box's columns 80..127 lie past the tensor map's inner extent (80): TMA
// fills them with zeros without reading memory.  The products are those
// of D = 80: S and dP take 5 k16 steps (4 on the first half, 1 on the
// second), and dV, dK, dQ are m64n80k16 (N = D read MN-major across both
// halves, `lbo` apart); the stores write the 80 columns.  Tried in turns
// (tools/attn_bwd_turns.py) and not kept: the D = 128 kernels on the same
// zero-filled tiles (1.6x the products) and dQ on 2 consumer warpgroups;
// PERF.md has their times.
//
// mma_sync (every other bf16 call: D not 64, 80 or 128, unaligned views):
// flash_bwd_delta, then the dk/dv kernel (one block per kv tile of 64
// keys, kv head and batch row, walking the G query heads of its group and
// every q tile that sees the tile) and the dq kernel (one block per q tile
// of 64 rows, query head and batch row, walking the kv tiles the forward
// walks), on mma.sync.m16n8k16 with f32 accumulators in the forward's
// fragment layout (P and dS rounded to bf16 only as operands).
//
// f32: the same three launches on the FP32 cores.

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

// ---- bf16 on Hopper: a TMA ring, warp-specialised wgmma -------------------
//
// Two kernels, one block an SM: consumer warpgroups, each on its own
// 64-row slab, and a last warpgroup that produces, one thread issuing TMA
// copies (its registers lowered to 24 by setmaxnreg, the consumers' raised
// to what that frees).  Tiles land 128-byte swizzled (64 bf16 = one
// 128-byte row; D = 80 and 128 as two 64-column halves) in shared memory, where
// wgmma reads them through descriptors.  A ring of kRing stages, each with
// a full barrier (the producer's expect_tx, then TMA's bytes) and an empty
// one (one arrival from each consumer thread), replaces the block-wide
// waits of the mma.sync kernels.  Named barriers take the consumers in
// turns through each step's first products.

constexpr int kWg = 128;                 // threads a warpgroup
constexpr int kWsThreads = 3 * kWg;      // dK/dV: consumers 0, 1; producer 2
constexpr int kSlab = 64;                // rows of a box, an m64 slab, a
                                         // streamed tile
constexpr int kKvTile = 2 * kSlab;       // keys a dK/dV block
constexpr int kRing = 4;                 // stages of the streamed ring
constexpr int kSwRow = 128;              // bytes of one swizzled row
constexpr int kBwdPad = 384;             // the padded lse/delta rows: a
                                         // multiple of a dQ block's rows

// Columns a tile row takes in shared memory: whole 64-column halves.
__host__ __device__ constexpr int bwd_width(int DP) {
  return (DP + 63) / 64 * 64;
}

// dQ's consumer warpgroups: 3 where their registers fit 160 a thread
// (D = 64, 80), 2 at D = 128.
__host__ __device__ constexpr int dq_consumers(int DP) {
  return DP == 128 ? 2 : 3;
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// One box of a 4-D tensor map (D, S, H, B) at (c0, c1, c2, c3) into shared
// memory, its bytes counted on `bar`.  Rows past S land as zeros.
__device__ __forceinline__ void tma_load_4d(uint32_t dst,
                                            const CUtensorMap* map, int c0,
                                            int c1, int c2, int c3,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(bar)
      : "memory");
}

// `bytes` (a multiple of 16, both addresses 16-byte aligned) into shared
// memory, counted on `bar`.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// Rows [row, row + 64) of the (h, b) slice of `map`, all DP columns, into
// rows [r_off, r_off + 64) of a tile of ROWS rows laid out as
// bwd_width(DP) / 64 column halves of ROWS swizzled rows each.
template <int DP, int ROWS>
__device__ __forceinline__ void tma_slab(const CUtensorMap* map, uint32_t tile,
                                         int r_off, int row, int h, int b,
                                         uint32_t bar) {
#pragma unroll
  for (int c = 0; c < bwd_width(DP) / 64; ++c)
    tma_load_4d(tile + (c * ROWS + r_off) * kSwRow, map, 64 * c, row, h, b,
                bar);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pin registers that an in-flight wgmma reads or writes: the compiler may
// not move them across this point.
template <int N>
__device__ __forceinline__ void keep(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void keep(uint32_t (&a)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

// The wgmma descriptor of a 128-byte-swizzled bf16 operand at `addr` (the
// layout TMA writes: 16-byte chunk c of row r at chunk c ^ (r % 8), 8-row
// atoms of 1,024 bytes, which set the stride between 8-row groups).
// K-major operands (K along the 128-byte row) step 32 bytes a k16 step;
// MN-major ones (MN along the row) step 16 rows, 2,048 bytes, and `lbo`
// is the distance from one 64-column half of the tile to the next.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         (uint64_t)((lbo >> 4) & 0x3FFF) << 16 | (uint64_t)(1024 >> 4) << 32 |
         (uint64_t)1 << 62;
}

// Named barriers 1 .. NC take the NC consumer warpgroups in turns through
// the first products of a step: warpgroup w waits on 1 + w, issues, and
// lets the next go (1 + (w + 1) % NC), so one's exponentials run under
// another's products instead of beside them.
__device__ __forceinline__ void turn_wait(int wg) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(1 + wg) : "memory");
}

__device__ __forceinline__ void turn_pass(int wg, int nc) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(1 + (wg + 1) % nc) : "memory");
}

// d (64 x 64, f32) (+)= A (64 x 16, K-major in shared memory) B^T (B:
// 64 x 16, K-major in shared memory); `accumulate` 0 overwrites d.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 64, f32) (+)= A (64 x 16, bf16 pairs in registers, the
// mma.sync A layout a warp) B (16 x 64, MN-major in shared memory);
// `accumulate` 0 overwrites d.
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

// d (64 x 80, f32) (+)= A (64 x 16, bf16 pairs in registers, the mma.sync
// A layout a warp) B (16 x 80, MN-major in shared memory: columns 0..63 in
// one 64-column half, 64..79 in the next, `lbo` on); `accumulate` 0
// overwrites d.
__device__ __forceinline__ void wgmma_rs_n80(float (&d)[40],
                                            const uint32_t (&a)[4],
                                            uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39}, "
      "{%40, %41, %42, %43}, %44, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

// d (64 x 128, f32) (+)= A (64 x 16, bf16 pairs in registers, the
// mma.sync A layout a warp) B (16 x 128, MN-major in shared memory);
// `accumulate` 0 overwrites d.
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}


#ifdef FA_BWD_STAMPS
// Phase timers of the wgmma route's consumers (tools/attn_bwd_stamps.py):
// lane 0 of each consumer warp sums the clock64 cycles of each phase of
// its loop (slot kBwdPhases: its steps), for blocks below 4096; kernel 0
// is flash_bwd_dkdv_wgmma, 1 flash_bwd_dq_wgmma.
constexpr int kBwdPhases = 9;
__device__ long long fa_bwd_stamps[2 * 4096 * 16 * (kBwdPhases + 1)];
#define BWD_STAMP_INIT() \
  long long stamp_t = clock64(), stamp_sum[kBwdPhases] = {};
#define BWD_STAMP(i)                      \
  do {                                    \
    const long long t_ = clock64();       \
    stamp_sum[i] += t_ - stamp_t;         \
    stamp_t = t_;                         \
  } while (0)
#define BWD_STAMP_END(kern, steps)                                          \
  do {                                                                      \
    long long* o_ = fa_bwd_stamps +                                         \
        (((kern) * 4096 + blockIdx.x) * 16 + threadIdx.x / 32) *            \
            (kBwdPhases + 1);                                               \
    if (threadIdx.x % 32 == 0 && blockIdx.x < 4096) {                       \
      for (int i_ = 0; i_ < kBwdPhases; ++i_) o_[i_] = stamp_sum[i_];       \
      o_[kBwdPhases] = (steps);                                             \
    }                                                                       \
  } while (0)
#else
#define BWD_STAMP_INIT()
#define BWD_STAMP(i)
#define BWD_STAMP_END(kern, steps)
#endif

// Whether some (`any`) or every (`full`) pair of the keys [k0, k1] and the
// query rows [r0, r1] (at positions r + offs) is visible; `whole`: the two
// ranges are whole 64-row slabs (no key past Skv, no row past Sq).
__device__ __forceinline__ void slab_cover(int k0, int k1, int r0, int r1,
                                           int offs, int causal, int window,
                                           bool whole, bool& any,
                                           bool& full) {
  const int p0 = r0 + offs, p1 = r1 + offs;
  any = k0 <= k1 && r0 <= r1 && (!causal || k0 <= p1) &&
        (window <= 0 || p0 - k1 < window);
  full = whole && (!causal || k1 <= p0) && (window <= 0 || p1 - k0 < window);
}

// The 64-row q tiles [begin, end) whose rows see some key of [k0, k1].
__device__ __forceinline__ void seeing_slabs(int k0, int k1, int Sq, int Skv,
                                             int causal, int window,
                                             int& begin, int& end) {
  const int offs = Skv - Sq;
  int lo = causal ? k0 - offs : 0;
  int hi = window > 0 ? k1 + window - 1 - offs : Sq - 1;
  lo = max(lo, 0);
  hi = min(hi, Sq - 1);
  begin = lo / kSlab;
  end = hi < lo ? begin : hi / kSlab + 1;
}

// The 32 f32 of an m64n64 accumulator as the A operand of the next
// product (k = the 64 columns): a[kk] holds columns 16 kk .. 16 kk + 15.
__device__ __forceinline__ void acc_to_a4(uint32_t (&a)[4][4],
                                          const float (&c)[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      a[kk][r] = pack_bf16(c[8 * kk + 2 * r], c[8 * kk + 2 * r + 1]);
}

template <int DP>
__device__ __forceinline__ void wgmma_rs(float (&d)[DP / 2],
                                         const uint32_t (&a)[4], uint64_t db);

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  wgmma_rs_n64(d, a, db, 1);
}

template <>
__device__ __forceinline__ void wgmma_rs<80>(float (&d)[40],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  wgmma_rs_n80(d, a, db, 1);
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  wgmma_rs_n128(d, a, db, 1);
}

// Rows row0 + 16 wi + g (+ 8) of an m64nDP accumulator (columns 8 j + 2 t,
// + 1 in acc[4 j + 2 hr + {0, 1}]), times mul, to dst (rows past `rows`
// and columns past `cols` left out).
template <int DP>
__device__ __forceinline__ void store_slab(bf16* dst, long long stride,
                                           const float (&acc)[DP / 2],
                                           float mul, int row0, int rows,
                                           int cols, int g, int t) {
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int row = row0 + g + 8 * hr;
    if (row >= rows) continue;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j)
      if (8 * j < cols)
        *reinterpret_cast<uint32_t*>(dst + row * stride + 8 * j + 2 * t) =
            pack_bf16(acc[4 * j + 2 * hr] * mul,
                      acc[4 * j + 2 * hr + 1] * mul);
  }
}

// Shared memory of flash_bwd_dkdv_wgmma, in bytes from a 1,024-aligned base.
template <int DP>
struct DkdvSmem {
  static constexpr int W = bwd_width(DP);          // columns a tile row
  static constexpr int kTile = kKvTile * W * 2;    // K or V, kept
  static constexpr int kStage = kSlab * W * 2;     // Q or dO, streamed
  static constexpr int K = 0, V = kTile, Q = 2 * kTile,
                       O = Q + kRing * kStage, L = O + kRing * kStage,
                       Dl = L + kRing * kSlab * 4, Bar = Dl + kRing * kSlab * 4,
                       bytes = Bar + (2 * kRing + 1) * 8 + 1024;
};

// Shared memory of flash_bwd_dq_wgmma with NC consumer warpgroups.
template <int DP, int NC>
struct DqSmem {
  static constexpr int W = bwd_width(DP);          // columns a tile row
  static constexpr int kTile = NC * kSlab * W * 2;   // Q or dO, kept
  static constexpr int kStage = kSlab * W * 2;     // K or V, streamed
  static constexpr int Q = 0, O = kTile, K = 2 * kTile,
                       V = K + kRing * kStage, Bar = V + kRing * kStage,
                       bytes = Bar + (2 * kRing + 1) * 8 + 1024;
};

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return p + ((1024u - (smem_addr(p) & 1023u)) & 1023u);
}

// dK and dV: one block per (kv tile of 128 keys, kv head, batch row), the
// kv tiles of a head side by side (heaviest first) so the blocks that
// stream one head's Q and dO run together and share them in L2.  K and V
// are loaded once; the producer streams (Q, dO, lse, delta) of every
// (query head of the group, q tile of 64 rows) that sees the tile.
// Consumer w owns keys k0 + 64 w .. + 63:
//   S^T = K_w Q^T, dP^T = V_w dO^T   (SS wgmma m64n64k16, D / 16 steps),
//   P^T = 2^(S^T scale_log2 - lse_log2), dS^T = P^T (dP^T - delta)  (f32),
//   dV += P^T dO, dK += dS^T Q       (RS wgmma m64nDk16, 4 steps; P^T,
//                                     dS^T rounded to bf16 in registers,
//                                     Q and dO read MN-major).
// ll, dl: lse * log2(e) (+inf on a row that sees no key or lies past Sq)
// and delta (0 there), (B, Hq, Sq_pad) from flash_bwd_prep.
template <int DP>
__global__ void __launch_bounds__(kWsThreads, 1)
flash_bwd_dkdv_wgmma(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv,
                     const __grid_constant__ CUtensorMap tdo,
                     const float* __restrict__ ll,
                     const float* __restrict__ dl, bf16* __restrict__ dk,
                     bf16* __restrict__ dv, Strides dks, Strides dvs, int Hq,
                     int Hkv, int G, int Sq, int Sq_pad, int Skv, int D,
                     int causal, int window, float scale_log2, float scale) {
  using Sm = DkdvSmem<DP>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* sm = align1024(smem_raw);
  const uint32_t base = smem_addr(sm);
  const uint32_t full0 = base + Sm::Bar, empty0 = full0 + 8 * kRing,
                 kv_bar = empty0 + 8 * kRing;

  const int nkt = (Skv + kKvTile - 1) / kKvTile;
  const int kt = blockIdx.x % nkt;
  const int hk = blockIdx.x / nkt % Hkv;
  const int b = blockIdx.x / nkt / Hkv;
  const int k0 = kt * kKvTile;
  const int offs = Skv - Sq;
  int qt_begin, qt_end;
  seeing_slabs(k0, min(k0 + kKvTile, Skv) - 1, Sq, Skv, causal, window,
               qt_begin, qt_end);
  const int nq = qt_end - qt_begin;
  const int n = G * nq;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kRing; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 2 * kWg);
    }
    mbar_init(kv_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / kWg;
  if (wg == 2) {                                // producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 2 * kWg && n > 0) {
      mbar_expect_tx(kv_bar, 2 * Sm::kTile);
      for (int r = 0; r < kKvTile; r += kSlab) {
        tma_slab<DP, kKvTile>(&tk, base + Sm::K, r, k0 + r, hk, b, kv_bar);
        tma_slab<DP, kKvTile>(&tv, base + Sm::V, r, k0 + r, hk, b, kv_bar);
      }
      for (int i = 0; i < n; ++i) {
        const int st = i % kRing;
        const uint32_t full = full0 + 8 * st;
        mbar_wait(empty0 + 8 * st, ((i / kRing) & 1) ^ 1);
        const int h = hk * G + i / nq;
        const int q0 = (qt_begin + i % nq) * kSlab;
        mbar_expect_tx(full, 2 * Sm::kStage + 2 * kSlab * 4);
        tma_slab<DP, kSlab>(&tq, base + Sm::Q + st * Sm::kStage, 0, q0, h, b,
                            full);
        tma_slab<DP, kSlab>(&tdo, base + Sm::O + st * Sm::kStage, 0, q0, h, b,
                            full);
        const long long r = ((long long)b * Hq + h) * Sq_pad + q0;
        bulk_load(base + Sm::L + st * kSlab * 4, ll + r, kSlab * 4, full);
        bulk_load(base + Sm::Dl + st * kSlab * 4, dl + r, kSlab * 4, full);
      }
    }
  } else {                                      // consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int tid = threadIdx.x % kWg;
    const int wi = tid / 32;
    const int lane = tid % 32;
    const int g = lane >> 2;
    const int t = lane & 3;
    const int kw0 = k0 + kSlab * wg;            // this warpgroup's keys
    const int kw1 = min(kw0 + kSlab, Skv) - 1;
    const int key0 = kw0 + 16 * wi + g;         // this thread's rows
    float dv_acc[DP / 2], dk_acc[DP / 2];
#pragma unroll
    for (int x = 0; x < DP / 2; ++x) dv_acc[x] = dk_acc[x] = 0.f;
    // A of S^T and dP^T: this warpgroup's 64 rows of K and V
    const uint64_t ka = sw128_desc(base + Sm::K + wg * kSlab * kSwRow, 0);
    const uint64_t va = sw128_desc(base + Sm::V + wg * kSlab * kSwRow, 0);
    if (n > 0) mbar_wait(kv_bar, 0);
    BWD_STAMP_INIT();

    for (int i = 0; i < n; ++i) {
      const int st = i % kRing;
      const int q0 = (qt_begin + i % nq) * kSlab;
      bool any, full;
      slab_cover(kw0, kw1, q0, min(q0 + kSlab, Sq) - 1, offs, causal, window,
                 kw0 + kSlab <= Skv && q0 + kSlab <= Sq, any, full);
      const uint32_t qs = base + Sm::Q + st * Sm::kStage;
      const uint32_t os = base + Sm::O + st * Sm::kStage;
      mbar_wait(full0 + 8 * st, (i / kRing) & 1);
      BWD_STAMP(0);
      if (i > 0 || wg == 1) turn_wait(wg);      // warpgroup 0 goes first
      BWD_STAMP(1);
      if (any) {
        float s[32], dp[32];                      // set by the first k step
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < DP / 16; ++kk)      // S^T = K_w Q^T
          wgmma_ss_n64(s, ka + (((kk / 4) * kKvTile * kSwRow +
                                 (kk % 4) * 32) >> 4),
                       sw128_desc(qs + (kk / 4) * kSlab * kSwRow +
                                      (kk % 4) * 32, 0),
                       kk > 0);
        wgmma_commit();
#pragma unroll
        for (int kk = 0; kk < DP / 16; ++kk)      // dP^T = V_w dO^T
          wgmma_ss_n64(dp, va + (((kk / 4) * kKvTile * kSwRow +
                                  (kk % 4) * 32) >> 4),
                       sw128_desc(os + (kk / 4) * kSlab * kSwRow +
                                      (kk % 4) * 32, 0),
                       kk > 0);
        wgmma_commit();
        turn_pass(wg, 2);
        BWD_STAMP(2);
        const float* cL = reinterpret_cast<const float*>(
            sm + Sm::L + st * kSlab * 4);
        const float* cD = reinterpret_cast<const float*>(
            sm + Sm::Dl + st * kSlab * 4);
        wgmma_wait<1>();                          // S^T here, dP^T running
        keep(s);
        BWD_STAMP(3);
        // P^T: keys key0 (+ 8) as rows, q rows 8 j + 2 t (+ 1) as columns;
        // a masked pair's exponent is -inf, so its P is 0 without a branch
        // around the ex2 (one per pair would serialise them)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float2 l2 =
              *reinterpret_cast<const float2*>(cL + 8 * j + 2 * t);
#pragma unroll
          for (int e = 0; e < 4; ++e)
            s[4 * j + e] =
                s[4 * j + e] * scale_log2 - ((e & 1) ? l2.y : l2.x);
        }
        if (!full) {
#pragma unroll
          for (int x = 0; x < 32; ++x) {
            const int qr = 8 * (x / 4) + 2 * t + (x & 1);
            if (!(q0 + qr < Sq && sees(key0 + 8 * ((x >> 1) & 1),
                                       q0 + qr + offs, Skv, causal, window)))
              s[x] = -INFINITY;
          }
        }
#pragma unroll
        for (int x = 0; x < 32; ++x) s[x] = ex2(s[x]);
        uint32_t pa[4][4], da[4][4];
        acc_to_a4(pa, s);
        keep(dv_acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)            // dV += P^T dO
          wgmma_rs<DP>(dv_acc, pa[kk],
                       sw128_desc(os + kk * 16 * kSwRow, kSlab * kSwRow));
        wgmma_commit();
        BWD_STAMP(4);
        wgmma_wait<1>();                          // dP^T here, dV running
        keep(dp);
        BWD_STAMP(5);
#pragma unroll
        for (int j = 0; j < 8; ++j) {             // dS^T = P^T (dP^T - delta)
          const float2 d2 =
              *reinterpret_cast<const float2*>(cD + 8 * j + 2 * t);
#pragma unroll
          for (int e = 0; e < 4; ++e)
            dp[4 * j + e] =
                s[4 * j + e] * (dp[4 * j + e] - ((e & 1) ? d2.y : d2.x));
        }
        acc_to_a4(da, dp);
        keep(dk_acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)            // dK += dS^T Q
          wgmma_rs<DP>(dk_acc, da[kk],
                       sw128_desc(qs + kk * 16 * kSwRow, kSlab * kSwRow));
        wgmma_commit();
        BWD_STAMP(6);
        wgmma_wait<0>();
        BWD_STAMP(7);
        keep(dv_acc);
        keep(dk_acc);
        keep(pa);
        keep(da);
      } else {
        turn_pass(wg, 2);
      }
      mbar_arrive(empty0 + 8 * st);
      BWD_STAMP(8);
    }
    if (wg == 0 && n > 0) turn_wait(wg);        // warpgroup 1's last pass
    BWD_STAMP_END(0, n);
    store_slab<DP>(dk + b * dks.b + hk * dks.h, dks.s, dk_acc, scale,
                   kw0 + 16 * wi, Skv, D, g, t);
    store_slab<DP>(dv + b * dvs.b + hk * dvs.h, dvs.s, dv_acc, 1.f,
                   kw0 + 16 * wi, Skv, D, g, t);
  }
}

// dQ: one block per (q tile of 64 NC rows, query head, batch row), the q
// tiles of a head side by side (heaviest first) and the heads of a GQA
// group next to each other, so they share K and V in L2.  NC consumer
// warpgroups (3 at D = 64, whose registers fit 160 a thread, 2 at D =
// 128) and a producer.  Q and dO are loaded once; the producer streams
// (K, V) tiles of 64 keys, the ones the forward walks.  Consumer w owns
// rows q0 + 64 w .. + 63:
//   S = Q_w K^T, dP = dO_w V^T   (SS wgmma m64n64k16, D / 16 steps),
//   P, dS = P (dP - delta)        (f32; lse and delta in registers),
//   dQ += dS K                    (RS wgmma m64nDk16, 4 steps; K MN-major).
template <int DP, int NC>
__global__ void __launch_bounds__((NC + 1) * kWg, 1)
flash_bwd_dq_wgmma(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv,
                   const __grid_constant__ CUtensorMap tdo,
                   const float* __restrict__ ll, const float* __restrict__ dl,
                   bf16* __restrict__ dq, Strides dqs, int Hq, int G, int Sq,
                   int Sq_pad, int Skv, int D, int causal, int window,
                   float scale_log2, float scale) {
  using Sm = DqSmem<DP, NC>;
  constexpr int QT = NC * kSlab;                // q rows a block
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* sm = align1024(smem_raw);
  const uint32_t base = smem_addr(sm);
  const uint32_t full0 = base + Sm::Bar, empty0 = full0 + 8 * kRing,
                 q_bar = empty0 + 8 * kRing;

  const int nqt = (Sq + QT - 1) / QT;
  const int qt = nqt - 1 - blockIdx.x % nqt;   // heaviest first
  const int h = blockIdx.x / nqt % Hq;
  const int b = blockIdx.x / nqt / Hq;
  const int hk = h / G;
  const int q0 = qt * QT;
  const int offs = Skv - Sq;
  int kt_begin, kt_end;
  visible_tiles(q0 + offs, min(q0 + QT, Sq) - 1 + offs, Skv, causal,
                window, kt_begin, kt_end);
  const int nt = kt_end - kt_begin;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kRing; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, NC * kWg);
    }
    mbar_init(q_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / kWg;
  if (wg == NC) {                               // producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == NC * kWg && nt > 0) {
      mbar_expect_tx(q_bar, 2 * Sm::kTile);
      for (int r = 0; r < QT; r += kSlab) {
        tma_slab<DP, QT>(&tq, base + Sm::Q, r, q0 + r, h, b, q_bar);
        tma_slab<DP, QT>(&tdo, base + Sm::O, r, q0 + r, h, b, q_bar);
      }
      for (int i = 0; i < nt; ++i) {
        const int st = i % kRing;
        const uint32_t full = full0 + 8 * st;
        mbar_wait(empty0 + 8 * st, ((i / kRing) & 1) ^ 1);
        const int k0 = (kt_begin + i) * kSlab;
        mbar_expect_tx(full, 2 * Sm::kStage);
        tma_slab<DP, kSlab>(&tk, base + Sm::K + st * Sm::kStage, 0, k0, hk, b,
                            full);
        tma_slab<DP, kSlab>(&tv, base + Sm::V + st * Sm::kStage, 0, k0, hk, b,
                            full);
      }
    }
  } else {                                      // consumers
    // the registers the producer gives up: 240 a thread for 2 consumer
    // warpgroups, 160 for 3
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
        NC == 2 ? 240 : 160));
    const int tid = threadIdx.x % kWg;
    const int wi = tid / 32;
    const int lane = tid % 32;
    const int g = lane >> 2;
    const int t = lane & 3;
    const int r0 = q0 + kSlab * wg;             // this warpgroup's rows
    const int r1 = min(r0 + kSlab, Sq) - 1;
    const int row0 = r0 + 16 * wi + g;          // this thread's rows
    float rl[2], rd[2];
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {            // row < Sq_pad: padded
      const long long r = ((long long)b * Hq + h) * Sq_pad + row0 + 8 * hr;
      rl[hr] = ll[r];
      rd[hr] = dl[r];
    }
    float dq_acc[DP / 2];
#pragma unroll
    for (int x = 0; x < DP / 2; ++x) dq_acc[x] = 0.f;
    // A of S and dP: this warpgroup's 64 rows of Q and dO
    const uint64_t qa = sw128_desc(base + Sm::Q + wg * kSlab * kSwRow, 0);
    const uint64_t oa = sw128_desc(base + Sm::O + wg * kSlab * kSwRow, 0);
    if (nt > 0) mbar_wait(q_bar, 0);
    BWD_STAMP_INIT();

    for (int i = 0; i < nt; ++i) {
      const int st = i % kRing;
      const int k0 = (kt_begin + i) * kSlab;
      bool any, full;
      slab_cover(k0, min(k0 + kSlab, Skv) - 1, r0, r1, offs, causal, window,
                 k0 + kSlab <= Skv && r0 + kSlab <= Sq, any, full);
      const uint32_t ks = base + Sm::K + st * Sm::kStage;
      const uint32_t vs = base + Sm::V + st * Sm::kStage;
      mbar_wait(full0 + 8 * st, (i / kRing) & 1);
      BWD_STAMP(0);
      if (i > 0 || wg > 0) turn_wait(wg);       // warpgroup 0 goes first
      BWD_STAMP(1);
      if (any) {
        float s[32], dp[32];                      // set by the first k step
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < DP / 16; ++kk)      // S = Q_w K^T
          wgmma_ss_n64(s, qa + (((kk / 4) * QT * kSwRow +
                                 (kk % 4) * 32) >> 4),
                       sw128_desc(ks + (kk / 4) * kSlab * kSwRow +
                                      (kk % 4) * 32, 0),
                       kk > 0);
        wgmma_commit();
#pragma unroll
        for (int kk = 0; kk < DP / 16; ++kk)      // dP = dO_w V^T
          wgmma_ss_n64(dp, oa + (((kk / 4) * QT * kSwRow +
                                  (kk % 4) * 32) >> 4),
                       sw128_desc(vs + (kk / 4) * kSlab * kSwRow +
                                      (kk % 4) * 32, 0),
                       kk > 0);
        wgmma_commit();
        turn_pass(wg, NC);
        BWD_STAMP(2);
        wgmma_wait<1>();                          // S here, dP running
        keep(s);
        BWD_STAMP(3);
        // P: rows row0 (+ 8), keys k0 + 8 j + 2 t (+ 1) as columns; a
        // masked pair's exponent is -inf (no branch around the ex2)
#pragma unroll
        for (int x = 0; x < 32; ++x)
          s[x] = s[x] * scale_log2 - rl[(x >> 1) & 1];
        if (!full) {
#pragma unroll
          for (int x = 0; x < 32; ++x) {
            const int hr = (x >> 1) & 1;
            if (!(row0 + 8 * hr < Sq &&
                  sees(k0 + 8 * (x / 4) + 2 * t + (x & 1),
                       row0 + 8 * hr + offs, Skv, causal, window)))
              s[x] = -INFINITY;
          }
        }
#pragma unroll
        for (int x = 0; x < 32; ++x) s[x] = ex2(s[x]);
        BWD_STAMP(4);
        wgmma_wait<0>();
        keep(dp);
        BWD_STAMP(5);
#pragma unroll
        for (int x = 0; x < 32; ++x)              // dS = P (dP - delta)
          dp[x] = s[x] * (dp[x] - rd[(x >> 1) & 1]);
        uint32_t da[4][4];
        acc_to_a4(da, dp);
        keep(dq_acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)            // dQ += dS K
          wgmma_rs<DP>(dq_acc, da[kk],
                       sw128_desc(ks + kk * 16 * kSwRow, kSlab * kSwRow));
        wgmma_commit();
        BWD_STAMP(6);
        wgmma_wait<0>();
        BWD_STAMP(7);
        keep(dq_acc);
        keep(da);
      } else {
        turn_pass(wg, NC);
      }
      mbar_arrive(empty0 + 8 * st);
      BWD_STAMP(8);
    }
    if (wg == 0 && nt > 0) turn_wait(wg);       // the last one's last pass
    BWD_STAMP_END(1, nt);
    store_slab<DP>(dq + b * dqs.b + h * dqs.h, dqs.s, dq_acc, scale,
                   r0 + 16 * wi, Sq, D, g, t);
  }
}

// Before the wgmma kernels: ll = lse * log2(e) (+inf where lse = -inf, a
// row that sees no key, and on the rows past Sq) and dl = delta (0 past
// Sq), both (B, Hq, Sq_pad) so the producer's 256-byte copies stay inside
// one (b, h) row and 16-byte aligned.  prep_lanes(DP) threads a row (D / 8
// rounded up to a power of two), each reading 16 bytes of o and of dO (the
// route's views are 16-byte aligned) below column D.
__host__ __device__ constexpr int prep_lanes(int DP) {
  return DP <= 64 ? 8 : 16;
}

template <int DP>
__global__ void __launch_bounds__(256)
flash_bwd_prep(const bf16* __restrict__ o, const bf16* __restrict__ dout,
               const float* __restrict__ lse, float* __restrict__ ll,
               float* __restrict__ dl, Strides os, Strides ds, int Hq, int Sq,
               int Sq_pad, int D, long long rows) {
  constexpr int CH = prep_lanes(DP);           // threads a row
  static_assert(8 * CH >= DP && 4 * CH < DP, "a power of two >= D / 8");
  const long long idx = (long long)blockIdx.x * 256 + threadIdx.x;
  const long long row = idx / CH;
  const int c = (int)(idx % CH) * 8;
  const int i = (int)(row % Sq_pad);
  const long long bh = row / Sq_pad;
  float acc = 0.f;
  if (row < rows && i < Sq && c < D) {
    const int h = (int)(bh % Hq);
    const long long b = bh / Hq;
    const uint4 ov = *reinterpret_cast<const uint4*>(
        o + b * os.b + h * os.h + (long long)i * os.s + c);
    const uint4 dv = *reinterpret_cast<const uint4*>(
        dout + b * ds.b + h * ds.h + (long long)i * ds.s + c);
    const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
    const __nv_bfloat162* d2 = reinterpret_cast<const __nv_bfloat162*>(&dv);
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const float2 a = __bfloat1622float2(o2[x]);
      const float2 e = __bfloat1622float2(d2[x]);
      acc += a.x * e.x + a.y * e.y;
    }
  }
#pragma unroll
  for (int off = CH / 2; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (row < rows && c == 0) {
    const float l = i < Sq ? lse[bh * Sq + i] : -INFINITY;
    ll[row] = l == -INFINITY ? INFINITY : l * kLog2e;
    dl[row] = acc;
  }
}

// cuTensorMapEncodeTiled from the driver the runtime already loaded, so
// the library links nothing beyond the runtime.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The tensor map of a bf16 (B, H, S, D) view with element strides st over
// (batch, head, seq): dims (D, S, H, B), boxes of 64 x 64 rows, 128-byte
// swizzle, rows past S read as zeros.  An extent-1 dim is never stepped,
// so its stride is given as 16 bytes.
bool tensor_map(CUtensorMap* map, const void* base, int B, int H, int S,
                int D, Strides st) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)H,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {S > 1 ? (cuuint64_t)st.s * 2 : 16,
                                 H > 1 ? (cuuint64_t)st.h * 2 : 16,
                                 B > 1 ? (cuuint64_t)st.b * 2 : 16};
  const cuuint32_t box[4] = {64, kSlab, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Whether a (B, H, S) view with element strides st can be a TMA source: a
// 16-byte aligned base and strides of whole 16 bytes (an extent-1 dim's
// stride aside).
bool tma_view(const void* p, int B, int H, int S, const long long* st) {
  return aligned16(p) && (B == 1 || st[0] % 8 == 0) &&
         (H == 1 || st[1] % 8 == 0) && (S == 1 || st[2] % 8 == 0);
}

// The route of a backward call (repro_torch/kernels/flash_attention.py::
// bwd_route is its mirror): 0 the f32 kernels; for bf16, 2 the TMA/wgmma
// kernels when D is 64, 80 or 128 and q, k, v, o and dO are TMA views (o
// for the prep pass's 16-byte loads), else 1, the mma.sync kernels (other
// head dims, unaligned views).
int bwd_route(const void* q, const void* k, const void* v, const void* o,
              const void* dout, int dtype, int B, int Hq, int Hkv, int Sq,
              int Skv, int D, const long long* st) {
  if (dtype == 0) return 0;
  const bool tma = (D == 64 || D == 80 || D == 128) &&
                   tma_view(q, B, Hq, Sq, st) &&
                   tma_view(k, B, Hkv, Skv, st + 3) &&
                   tma_view(v, B, Hkv, Skv, st + 6) &&
                   tma_view(o, B, Hq, Sq, st + 9) &&
                   tma_view(dout, B, Hq, Sq, st + 12);
  return tma ? 2 : 1;
}

// The wgmma route: the prep pass, then the dK/dV and the dQ kernels, on
// tiles of DP columns; D (<= DP) the head dim the tensor maps read and the
// stores write.
template <int DP>
cudaError_t launch_bwd_wgmma(const void* q, const void* k, const void* v,
                             const void* o, const void* dout,
                             const float* lse, float* ll, float* dl, void* dq,
                             void* dk, void* dv, int B, int Hq, int Hkv,
                             int Sq, int Skv, int D, int Sq_pad,
                             const long long* st, int causal, int window,
                             float scale, cudaStream_t stream) {
  const Strides qs{st[0], st[1], st[2]}, ks{st[3], st[4], st[5]},
      vs{st[6], st[7], st[8]}, os{st[9], st[10], st[11]},
      dos{st[12], st[13], st[14]}, dqs{st[15], st[16], st[17]},
      dks{st[18], st[19], st[20]}, dvs{st[21], st[22], st[23]};
  CUtensorMap tq, tk, tv, tdo;
  if (D > DP || !tensor_map(&tq, q, B, Hq, Sq, D, qs) ||
      !tensor_map(&tk, k, B, Hkv, Skv, D, ks) ||
      !tensor_map(&tv, v, B, Hkv, Skv, D, vs) ||
      !tensor_map(&tdo, dout, B, Hq, Sq, D, dos))
    return cudaErrorInvalidValue;
  const long long rows = (long long)B * Hq * Sq_pad;
  const long long prep_blocks = (rows * prep_lanes(DP) + 255) / 256;
  const long long kv_blocks =
      (long long)((Skv + kKvTile - 1) / kKvTile) * Hkv * B;
  constexpr int NC = dq_consumers(DP);
  const long long q_blocks =
      (long long)((Sq + NC * kSlab - 1) / (NC * kSlab)) * Hq * B;
  if (prep_blocks > INT_MAX || kv_blocks > INT_MAX || q_blocks > INT_MAX)
    return cudaErrorInvalidValue;
  constexpr int kv_smem = DkdvSmem<DP>::bytes,
                q_smem = DqSmem<DP, NC>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkdv_wgmma<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kv_smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(flash_bwd_dq_wgmma<DP, NC>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               q_smem);
  if (err != cudaSuccess) return err;
  flash_bwd_prep<DP><<<(unsigned)prep_blocks, 256, 0, stream>>>(
      static_cast<const bf16*>(o), static_cast<const bf16*>(dout), lse, ll,
      dl, os, dos, Hq, Sq, Sq_pad, D, rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const float sl2 = log2_scale(scale);
  flash_bwd_dkdv_wgmma<DP><<<(unsigned)kv_blocks, kWsThreads, kv_smem,
                             stream>>>(
      tq, tk, tv, tdo, ll, dl, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), dks, dvs, Hq, Hkv, Hq / Hkv, Sq, Sq_pad, Skv,
      D, causal, window, sl2, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_dq_wgmma<DP, NC><<<(unsigned)q_blocks, (NC + 1) * kWg, q_smem,
                             stream>>>(
      tq, tk, tv, tdo, ll, dl, static_cast<bf16*>(dq), dqs, Hq, Hq / Hkv, Sq,
      Sq_pad, Skv, D, causal, window, sl2, scale);
  return cudaGetLastError();
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
                         float* delta, float* ll, void* dq, void* dk, void* dv,
                         int dtype, int route, int B, int Hq, int Hkv, int Sq,
                         int Skv, int D, int Sq_pad, const long long* st,
                         int causal, int window, float scale,
                         cudaStream_t s) {
  if (route != bwd_route(q, k, v, o, dout, dtype, B, Hq, Hkv, Sq, Skv, D,
                         st))
    return cudaErrorInvalidValue;
  if (route == 2) {
    if (Sq_pad < Sq || Sq_pad % kBwdPad) return cudaErrorInvalidValue;
    if (D == 64)
      return launch_bwd_wgmma<64>(q, k, v, o, dout, lse, ll, delta, dq, dk,
                                  dv, B, Hq, Hkv, Sq, Skv, D, Sq_pad, st,
                                  causal, window, scale, s);
    if (D == 80)
      return launch_bwd_wgmma<80>(q, k, v, o, dout, lse, ll, delta, dq, dk,
                                  dv, B, Hq, Hkv, Sq, Skv, D, Sq_pad, st,
                                  causal, window, scale, s);
    return launch_bwd_wgmma<128>(q, k, v, o, dout, lse, ll, delta, dq, dk, dv,
                                 B, Hq, Hkv, Sq, Skv, D, Sq_pad, st, causal,
                                 window, scale, s);
  }
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
// route: the caller's bwd_route, which must be this file's (0 f32, 1
// mma.sync, 2 wgmma).  Routes 0 and 1: delta is a (B, Hq, Sq) f32
// workspace, lse2 unused, three launches.  Route 2: delta and lse2 are
// (B, Hq, sq_pad) f32 workspaces, sq_pad a multiple of 384 >= Sq, three
// launches.  D <= 128 and even; the wrapper checks.  All on `stream`.
int flash_attention_bwd_launch(const void* q, const void* k, const void* v,
                               const void* o, const void* dout,
                               const void* lse, void* delta, void* lse2,
                               void* dq, void* dk, void* dv, int dtype,
                               int route, int B, int Hq, int Hkv, int Sq,
                               int Skv, int D, int sq_pad,
                               const long long* strides, int causal,
                               int window, float scale, void* stream) {
  if (D < 1 || D > 128 || D % 2 || Hkv < 1 || Hq % Hkv || dtype < 0 ||
      dtype > 1)
    return cudaErrorInvalidValue;
  return dispatch_bwd(q, k, v, o, dout, static_cast<const float*>(lse),
                      static_cast<float*>(delta), static_cast<float*>(lse2),
                      dq, dk, dv, dtype, route, B, Hq, Hkv, Sq, Skv, D,
                      sq_pad, strides, causal, window, scale,
                      static_cast<cudaStream_t>(stream));
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

#ifdef FA_BWD_STAMPS
int flash_attention_bwd_stamps(long long* out, long long n) {
  return (int)cudaMemcpyFromSymbol(out, fa_bwd_stamps,
                                   n * sizeof(long long));
}
#endif

}  // extern "C"
