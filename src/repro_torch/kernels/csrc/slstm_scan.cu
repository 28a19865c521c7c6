// The sLSTM recurrence of xLSTM (arXiv:2405.04517) for Hopper, forward and
// backward, each one persistent grid of co-resident blocks.
//
// Replaces no Pallas kernel: the JAX package runs the recurrence as the
// lax.scan of src/repro/models/xlstm.py:261-265 (slstm_apply over
// scan_utils.chunked_scan), which XLA compiles into one device loop, and
// differentiates it by autodiff.  Per step t and batch row b, with g split
// into its z, i, f, o quarters of d columns each:
//   g   = gx_t + h_{t-1} W_r + bias                  (W_r: d x 4d, dense)
//   m_t = max(logsig(f) + m_{t-1}, i)
//   c_t = e^{logsig(f) + m_{t-1} - m_t} c_{t-1} + e^{i - m_t} tanh(z)
//   n_t = e^{logsig(f) + m_{t-1} - m_t} n_{t-1} + e^{i - m_t}
//   h_t = sigmoid(o) c_t / max(n_t, 1)
// all in f32 (the plain version is kernels/ref.py::slstm_scan_ref).  The
// state given as null pointers is c = n = h = 0, m = -inf.
//
// Bound: the chain of S steps.  h @ W_r is 2 B d 4d operations a step
// (18.9 MFLOP at B 4, d 768), 0.58 ms over 2,048 steps at 67 TFLOP/s in
// f32, and the bytes (gx, hs, W_r once) are ~0.1 GB; but every step needs
// the whole of h_{t-1}, so the S steps run one after another, each at
// least one exchange between SMs through L2.  W_r in f32 is 9.44 MB at
// d 768: no SM holds it, so it is spread over the card, one block an SM
// (u = ceil(d / SMs) hidden units a block: 6 at d 768 on 132 SMs, 128
// blocks; the last block's spare units masked), each block keeping the 4u
// columns of W_r that its units' gates read for the whole call.  At
// d <= 768 and 4u <= 24 (xLSTM-125M's 768 on an H100) that slice lives in
// registers, 72 floats a thread, staged once through shared memory (rows
// of W_r read whole); otherwise it stays in shared memory as
// [4u][dpad + 4] and each product loads it in panels of 24 columns x 768
// k into the same registers: one code path, one layout (dpad = 128
// ceil(d / 128)).
//
// The exchange: one L2 round trip a step, no counter and no fence.  A
// block publishes what the others need as 64-bit words {value, tag} into
// a two-slot ring (slot tag & 1); a 64-bit store is single-copy atomic,
// so a value and its tag arrive together.  A reader loads its words 16
// bytes a load, up to 6 loads a thread in flight at once, and loads
// again, all together, only the pairs whose tags are not yet the step's.
// The tag counts the exchanges of the launch across chunks of rows, and
// the ring is zeroed by a cudaMemsetAsync before the launch (a graph
// captures the memset), so no word left by an earlier call, chunk or
// replay ever matches.  Two slots suffice: a block writes exchange e + 2
// into slot e & 1 only after it has read all of e + 1, which every block
// published only after it had read all of e.  A spin over 10 s traps, so
// a fault ends the launch instead of hanging the card.  The launch is
// cooperative (cudaLaunchAttributeCooperative): CUDA refuses a grid that
// cannot be resident at once rather than letting a spin wait forever.
//
// Forward step (slstm_fwd): the product g = h_{t-1} W_r for the block's
// B x 4u pre-activations in plain f32 FMAs (no TF32: the plain version's
// product is f32), 4 rows at a time, every warp busy: warp w takes
// columns w + 8 j, lane l the k of quads l + 32 i; the lanes' sums meet by
// a reduce-scatter of 18 shuffles a warp.  Then the cell on the block's
// B x u units, gx_t having arrived by cp.async (issued right after the
// step before published); h_t published at once as {h, tag} into rows of
// dpad words; then the saves (hs, and under grad g, c, n, m of every
// step: 176 MB at B 4, S 2,048, d 768) and the final state, which nothing
// waits on until the kernel ends; then the gather of all B x d words.
//
// Backward (slstm_bwd), a reverse sweep on the same grid holding the same
// 4u columns of W_r.  At step t a block forms dg_t of its 4u columns from
// dh_t (dhs_t plus the recurrent part) and the carried dc, dn, dm,
// following autograd's chain through the cell exactly
// (kernels/ref.py::slstm_scan_bwd_ref: both max() split a tie's gradient
// evenly, which the first step from no state always meets at max(n, 1);
// m_{t-1} = -inf gives fa = 0 and a < i, so no inf - inf or 0 * inf).
// From its own dg_t, with no exchange, it forms its partial of
// dh_{t-1} = dg_t W_r^T over all d units (B x d values, thread k holding
// the 4u weights of units k, k + 256, k + 512: the forward's product
// transposed, no sums across threads), stages them in shared memory by
// owning block and publishes each owner's segment side by side, three
// partials to a pair of words with 16-bit tags (bwd_publish); then it
// writes dG (the gradient of gx) off the path; then it reads the blocks'
// segments for its own u units (128 x 9 pairs at B 4, one region of
// 18 KB that no other block reads) and sums them for each unit in a fixed
// order (lanes over blocks, then a shuffle tree).  g_t, c, n, m of step t
// and t - 1 arrive by cp.async a step ahead.  dW_r = H_prev^T dG and
// dbias = sum dG are one large product and a sum each, left to torch as
// the JAX package leaves them to XLA.  No atomics on data: two runs give
// the same bits.  expf, tanhf, log1pf, not their fast forms, as the plain
// version.  The hot loops divide by a multiply (Div).
//
// Batch rows in chunks: the buffers that grow with B (h_{t-1} in the
// forward, the blocks' partials in the backward) must fit a block's
// shared memory, which at d 768 leaves room for 67 rows in the forward
// and 60 in the backward.  Rows are independent, so a launch takes B as
// ceil(B / most) chunks of equal rows (the last may be shorter) and runs
// the whole chain of each chunk in turn, W_r loaded once: one launch a
// call at any B, its time the chunks' chains end to end
// (slstm_scan_plan names the rows of a chunk and the rings' bytes).
//
// With -DSLSTM_STAMPS thread 0 of every block sums the clock64 cycles of
// each phase of its steps (tools/slstm_stamps.py reads them):
//   forward:  0 the step's start, 1 the product, 2 the cell, the publish
//             and the next gx prefetch issued, 3 the saves, 4 the gather
//   backward: 0 the step's prefetch landed, 1 the cell, 2 the product,
//             the staging and the publish, 3 the dG store, 4 the gather,
//             5 the sum
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 4;               // batch rows a product pass takes
constexpr int kColsW = 3;              // forward: columns a warp holds
constexpr int kPanelC = kColsW * kWarps;  // columns of W_r a panel holds
constexpr int kQuads = 6;              // forward: k quads a lane holds
constexpr int kPanelK = kQuads * 128;  // k a panel holds
constexpr int kKB = kPanelK / kThreads;  // backward: k a thread holds
constexpr int kBatch = 6;              // 16-byte loads a thread has in flight
constexpr int kSum = 3;                // backward: units a warp sums at once
constexpr unsigned long long kSpinNs = 10ull * 1000 * 1000 * 1000;
constexpr int kBwdStage = 11;          // floats a unit a step the backward
                                       // prefetches: g (4), dhs, c n m of
                                       // t and of t - 1

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

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}

// v with the exchange's tag, as one single-copy-atomic 64-bit store.
__device__ __forceinline__ void publish(unsigned long long* p, float v,
                                        unsigned tag) {
  const unsigned long long w =
      (static_cast<unsigned long long>(tag) << 32) | __float_as_uint(v);
  asm volatile("st.relaxed.gpu.global.b64 [%0], %1;" :: "l"(p), "l"(w)
               : "memory");
}

__device__ __forceinline__ ulonglong2 load_pair(const unsigned long long* p) {
  ulonglong2 v;
  asm volatile("ld.relaxed.gpu.global.v2.b64 {%0, %1}, [%2];"
               : "=l"(v.x), "=l"(v.y) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ bool tagged(unsigned long long w, unsigned tag) {
  return static_cast<unsigned>(w >> 32) == tag;
}

// The pairs [0, pairs) of 64-bit words at src that need(p) names, each
// handed to take(p, pair) until take accepts it (its tags are the
// step's).  The block's threads take pairs (16-byte loads) kB at a time
// each, all in flight together; a round loads again, together, only the
// pairs not yet taken.  src is 16-byte aligned.
template <int kB = kBatch, class Need, class Take>
__device__ __forceinline__ void gather(const unsigned long long* src,
                                       int pairs, Need need, Take take) {
#pragma unroll 1
  for (int p0 = threadIdx.x; p0 < pairs; p0 += kThreads * kB) {
    unsigned todo = 0;
#pragma unroll
    for (int q = 0; q < kB; ++q) {
      const int p = p0 + q * kThreads;
      if (p < pairs && need(p)) todo |= 1u << q;
    }
    const unsigned long long t0 = globaltimer();
    while (todo) {
      ulonglong2 v[kB];
#pragma unroll
      for (int q = 0; q < kB; ++q)
        if (todo >> q & 1) v[q] = load_pair(src + 2 * (p0 + q * kThreads));
#pragma unroll
      for (int q = 0; q < kB; ++q)
        if ((todo >> q & 1) && take(p0 + q * kThreads, v[q]))
          todo &= ~(1u << q);
      if (todo && globaltimer() - t0 > kSpinNs) __trap();
    }
  }
}

// The forward's exchange of h for one chunk: pairs of words of the slot's
// [B][dpad] into h_s (same layout); words past d are never written.
__device__ __forceinline__ void gather_h(const unsigned long long* slot,
                                         float* h_s, int B, int d, int dpad,
                                         unsigned tag) {
  const auto real = [=](int wd) { return d == dpad || wd % dpad < d; };
  gather(slot, B * dpad / 2, [&](int p) { return real(2 * p); },
         [&](int p, ulonglong2 v) {
           const bool two = real(2 * p + 1);
           if (!tagged(v.x, tag) || (two && !tagged(v.y, tag))) return false;
           h_s[2 * p] = __uint_as_float(static_cast<unsigned>(v.x));
           if (two) h_s[2 * p + 1] = __uint_as_float(static_cast<unsigned>(v.y));
           return true;
         });
}

// n / d by a multiply, exact for 0 <= n < 2^32 / d: the hot loops' index
// arithmetic without a division's ~25 dependent instructions.
struct Div {
  unsigned long long m;
  __device__ explicit Div(int d) : m(((1ull << 32) + d - 1) / d) {}
  __device__ int operator()(int n) const {
    return static_cast<int>((static_cast<unsigned long long>(n) * m) >> 32);
  }
};

__device__ __forceinline__ float sigmoidf_(float x) {
  return 1.f / (1.f + expf(-x));
}

__device__ __forceinline__ float logsigmoidf_(float x) {   // as torch's
  return fminf(x, 0.f) - log1pf(expf(-fabsf(x)));
}

__device__ __forceinline__ float tie_weight(float a, float b) {
  return a > b ? 1.f : (a == b ? 0.5f : 0.f);
}

__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// The column of W_r (of 4d) that the block's local column c (of 4u) is,
// or -1 for a spare unit's.
__device__ __forceinline__ int wr_col(int c, int C, int u, int nu, int d,
                                      int j0, Div by_u) {
  const int q = by_u(c), jj = c - q * u;
  return c < C && jj < nu ? q * d + j0 + jj : -1;
}

// The row stride of the block's slice of W_r in shared memory, [4u][dpad
// + 4]: 16-byte rows that do not all start on one bank.
__host__ __device__ inline int w_stride(int dpad) { return dpad + 4; }

// 4 rows x kColsW columns of partial sums on every lane → the full sums
// of row (lane >> 3) on every lane of that octet: two halving steps of a
// reduce-scatter (xor 16 keeps rows 0-1 or 2-3, xor 8 one of those), then
// a xor tree over the octet.
__device__ __forceinline__ void reduce_rows(float (&acc)[kRows][kColsW],
                                            float (&out)[kColsW]) {
  const unsigned all = 0xffffffffu;
  const bool hi16 = threadIdx.x & 16, hi8 = threadIdx.x & 8;
  float half[2][kColsW];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int j = 0; j < kColsW; ++j) {
      const float mine = hi16 ? acc[2 + r][j] : acc[r][j];
      const float give = hi16 ? acc[r][j] : acc[2 + r][j];
      half[r][j] = mine + __shfl_xor_sync(all, give, 16);
    }
#pragma unroll
  for (int j = 0; j < kColsW; ++j) {
    const float mine = hi8 ? half[1][j] : half[0][j];
    const float give = hi8 ? half[0][j] : half[1][j];
    out[j] = mine + __shfl_xor_sync(all, give, 8);
  }
#pragma unroll
  for (int off = 4; off; off >>= 1)
#pragma unroll
    for (int j = 0; j < kColsW; ++j)
      out[j] += __shfl_xor_sync(all, out[j], off);
}

// The forward's registers of W_r: w[j][i] holds rows k = 128 (6 kp + i)
// + 4 lane .. + 3 of local column warp + 8 j + 24 cp, from w_s.
__device__ __forceinline__ void fwd_panel(float4 (&w)[kColsW][kQuads],
                                          const float* w_s, int cp, int kp,
                                          int C, int dpad) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int kq = dpad / 128, sw = w_stride(dpad);
#pragma unroll
  for (int j = 0; j < kColsW; ++j) {
    const int c = cp * kPanelC + warp + kWarps * j;
#pragma unroll
    for (int i = 0; i < kQuads; ++i) {
      const int qi = kp * kQuads + i;
      w[j][i] = c < C && qi < kq
                    ? lds4(w_s + (size_t)c * sw + 128 * qi + 4 * lane)
                    : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
}

// pre[r][c] = sum_k h[r][k] W_r[k][col(c)] for r < R, c < C: warp w takes
// columns w + 8 j of each panel, lane l the k of quads l + 32 i, summed
// in k order on the lane, then over lanes by reduce_rows.  kRes: the one
// panel is already in w.  Ends with the block synchronised.
template <bool kRes>
__device__ __forceinline__ void fwd_product(
    const float* h_s, const float* w_s, float4 (&w)[kColsW][kQuads], int R,
    int C, int dpad, float* pre) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int kq = dpad / 128;
  const int cps = kRes ? 1 : (C + kPanelC - 1) / kPanelC;
  const int kps = kRes ? 1 : (kq + kQuads - 1) / kQuads;
#pragma unroll 1
  for (int cp = 0; cp < cps; ++cp)
#pragma unroll 1
    for (int r0 = 0; r0 < R; r0 += kRows) {
      float acc[kRows][kColsW];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int j = 0; j < kColsW; ++j) acc[r][j] = 0.f;
#pragma unroll 1
      for (int kp = 0; kp < kps; ++kp) {
        if (!kRes) fwd_panel(w, w_s, cp, kp, C, dpad);
#pragma unroll
        for (int i = 0; i < kQuads; ++i) {
          const int qi = kp * kQuads + i;
          if (qi >= kq) break;
          float4 hv[kRows];
#pragma unroll
          for (int r = 0; r < kRows; ++r)
            hv[r] = r0 + r < R
                        ? lds4(h_s + (size_t)(r0 + r) * dpad + 128 * qi
                               + 4 * lane)
                        : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
          for (int j = 0; j < kColsW; ++j)
#pragma unroll
            for (int r = 0; r < kRows; ++r) {
              float a = acc[r][j];
              a = fmaf(hv[r].x, w[j][i].x, a);
              a = fmaf(hv[r].y, w[j][i].y, a);
              a = fmaf(hv[r].z, w[j][i].z, a);
              acc[r][j] = fmaf(hv[r].w, w[j][i].w, a);
            }
        }
      }
      float out[kColsW];
      reduce_rows(acc, out);
      const int r = r0 + (lane >> 3);
      if ((lane & 7) == 0 && r < R)
#pragma unroll
        for (int j = 0; j < kColsW; ++j) {
          const int c = cp * kPanelC + warp + kWarps * j;
          if (c < C) pre[r * C + c] = out[j];
        }
    }
  __syncthreads();
}

// The block's slice of W_r into shared memory as [4u][w_stride(dpad)]
// (zero past d and for spare units), read a row of W_r at a time, 8 loads
// a thread in flight.
__device__ void load_w_shared(float* w_s, const float* wr, int C, int u,
                              int nu, int d, int dpad, int j0, Div by_u) {
  const Div by_C(C);
  const int sw = w_stride(dpad), n = C * dpad;
#pragma unroll 1
  for (int i0 = threadIdx.x; i0 < n; i0 += 8 * kThreads) {
    float v[8];
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int i = i0 + q * kThreads, k = by_C(i), c = i - k * C;
      const int col = wr_col(c, C, u, nu, d, j0, by_u);
      v[q] = i < n && col >= 0 && k < d ? wr[(size_t)k * 4 * d + col] : 0.f;
    }
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int i = i0 + q * kThreads, k = by_C(i);
      if (i < n) w_s[(size_t)(i - k * C) * sw + k] = v[q];
    }
  }
}

// Shared memory of the forward, in floats: W_r's 4u columns (unless in
// registers), h_{t-1} (rows of dpad), the pre-activations, gx_t twice
// (the step's and the next one's), c n m h.
__host__ __device__ inline long long fwd_smem_floats(int B, int dpad, int u,
                                                     bool res) {
  return (res ? 0LL : 4LL * u * w_stride(dpad)) + (long long)B * dpad
         + 3LL * B * 4 * u + 4LL * B * u;
}

// ... of the backward: W_r's 4u columns (unless in registers), dg_t
// (B x 4u), the partials of dh_{t-1} (blocks segments of 3 T <= B u + 6
// floats: the block's own, staged, then the blocks' for its units),
// dh_{t-1}'s recurrent part, the prefetched step twice, dc dn dm.
__host__ __device__ inline long long bwd_smem_floats(int B, int dpad, int u,
                                                     int blocks, bool res) {
  return (res ? 0LL : 4LL * u * w_stride(dpad)) + 4LL * B * u
         + (long long)blocks * (B * u + 6) + (long long)B * u
         + 2LL * kBwdStage * B * u + 3LL * B * u;
}

__host__ __device__ inline int padded_d(int d) {
  return (d + 127) / 128 * 128;
}

// W_r's slice in registers: d within one panel's k and 4u within its
// columns.
__host__ __device__ inline bool w_in_registers(int d, int u) {
  return d <= kPanelK && 4 * u <= kPanelC;
}

// The triples of a block's segment in another's region of the backward's
// ring: its partials for the B x u units (B nu_X of them, b nu_X + jj),
// three to a pair of words (bwd_publish), odd so that the reader's rows
// of blocks (3 floats a triple) do not fall on one bank.
__host__ __device__ inline int bwd_triples(int B, int u) {
  return ((B * u + 2) / 3) | 1;
}

// Words a destination block's region of the backward's ring holds: a
// segment of bwd_triples pairs from each block, for `rows` rows.
__host__ __device__ inline long long bwd_region_words(int blocks, int rows,
                                                      int u) {
  return 2LL * blocks * bwd_triples(rows, u);
}

// gx_t of the block's B x 4u columns into dst (cp.async; the caller
// commits).
__device__ __forceinline__ void fetch_gx(float* dst, const float* gx, int B,
                                         int S, int d, int u, int nu, int j0,
                                         int t, Div by_u) {
  const int U4 = 4 * u;
#pragma unroll 1
  for (int i = threadIdx.x; i < B * U4; i += kThreads) {
    const int bq = by_u(i), b = bq >> 2, q = bq & 3, jj = i - bq * u;
    if (jj < nu)
      cp_async4(dst + i, gx + ((size_t)b * S + t) * 4 * d + q * d + j0 + jj);
  }
}

template <bool kRes>
__global__ void __launch_bounds__(kThreads, 1)
slstm_fwd(const float* __restrict__ gx, const float* __restrict__ wr,
          const float* __restrict__ bias, const float* __restrict__ c0,
          const float* __restrict__ n0, const float* __restrict__ m0,
          const float* __restrict__ h0, float* __restrict__ hs,
          float* __restrict__ cout, float* __restrict__ nout,
          float* __restrict__ mout, float* __restrict__ hout,
          float* __restrict__ Gs, float* __restrict__ Cs,
          float* __restrict__ Ns, float* __restrict__ Ms,
          unsigned long long* ring, int Ball, int S, int d, int u,
          int rows) {
  extern __shared__ float4 smem4[];
  const int C = 4 * u, dpad = padded_d(d);
  float* w_s = reinterpret_cast<float*>(smem4);    // [4u][dpad + 4]
  float* h_s = w_s + (kRes ? 0 : (size_t)C * w_stride(dpad));  // [rows][dpad]
  float* pre = h_s + (size_t)rows * dpad;          // [rows][4u]
  float* gx_s = pre + (size_t)rows * C;            // [2][rows][4u]
  float* st = gx_s + 2 * (size_t)rows * C;         // c, n, m, h: [4][rows][u]
  const int j0 = blockIdx.x * u, nu = min(u, d - j0);
  const Div by_u(u);
  unsigned met = 0;                                // exchanges passed
  float4 w[kColsW][kQuads];
  load_w_shared(w_s, wr, C, u, nu, d, dpad, j0, by_u);
  if (kRes) {                  // into registers; the buffers then take w_s
    __syncthreads();
    fwd_panel(w, w_s, 0, 0, C, dpad);
  }
  STAMP_BEGIN;

  for (int b0 = 0; b0 < Ball; b0 += rows) {
  // chunk b0: its rows' slices of every (B, ...) tensor
  const int B = min(rows, Ball - b0), P = B * u;
  const float* gx_c = gx + (size_t)b0 * S * 4 * d;
  const size_t s0 = (size_t)b0 * d, sS = (size_t)b0 * S;
  __syncthreads();             // the chunk before is done with the buffers
  fetch_gx(gx_s, gx_c, B, S, d, u, nu, j0, 0, by_u);
  cp_async_commit();
#pragma unroll 1
  for (int i = threadIdx.x; i < P; i += kThreads) {
    const int b = by_u(i), jj = i - b * u;
    const bool given = c0 != nullptr && jj < nu;
    const size_t at = s0 + (size_t)b * d + j0 + jj;
    st[i] = given ? c0[at] : 0.f;
    st[P + i] = given ? n0[at] : 0.f;
    st[2 * P + i] = given ? m0[at] : -INFINITY;
  }
#pragma unroll 4
  for (int i = threadIdx.x; i < B * dpad; i += kThreads) {
    const int b = i / dpad, k = i - b * dpad;
    h_s[i] = h0 != nullptr && k < d ? h0[s0 + (size_t)b * d + k] : 0.f;
  }
  __syncthreads();

  for (int t = 0; t < S; ++t) {
    float* gnow = gx_s + (t & 1) * B * C;
    STAMP_STEP;
    STAMP(0);
    fwd_product<kRes>(h_s, w_s, w, B, C, dpad, pre);
    STAMP(1);
    cp_async_wait_all();
    __syncthreads();
    const bool more = t + 1 < S;
    const unsigned tag = met + 1;
    unsigned long long* slot = ring + (size_t)(tag & 1) * rows * dpad;
#pragma unroll 1
    for (int i = threadIdx.x; i < P; i += kThreads) {
      const int b = by_u(i), jj = i - b * u;
      if (jj >= nu) continue;
      const int j = j0 + jj;
      float g[4];
#pragma unroll
      for (int q = 0; q < 4; ++q)
        g[q] = (gnow[b * C + q * u + jj] + pre[b * C + q * u + jj])
               + bias[q * d + j];
      const float c = st[i], n = st[P + i], m = st[2 * P + i];
      const float z = tanhf(g[0]), o = sigmoidf_(g[3]);
      const float logf_ = logsigmoidf_(g[2]);
      const float m_new = fmaxf(logf_ + m, g[1]);
      const float fa = expf(logf_ + m - m_new), ia = expf(g[1] - m_new);
      const float c_new = fa * c + ia * z, n_new = fa * n + ia;
      const float h = o * c_new / fmaxf(n_new, 1.f);
      if (more) publish(slot + (size_t)b * dpad + j, h, tag);
      st[i] = c_new;
      st[P + i] = n_new;
      st[2 * P + i] = m_new;
      st[3 * P + i] = h;
#pragma unroll
      for (int q = 0; q < 4; ++q) gnow[b * C + q * u + jj] = g[q];
    }
    // gx_{t+1} into the buffer step t - 1 used (its saves ended before the
    // exchange's barrier)
    if (more) {
      fetch_gx(gx_s + ((t + 1) & 1) * B * C, gx_c, B, S, d, u, nu, j0, t + 1,
               by_u);
      cp_async_commit();
    }
    STAMP(2);
    // the saves, off the path: each thread its own units of the loop above
#pragma unroll 1
    for (int i = threadIdx.x; i < P; i += kThreads) {
      const int b = by_u(i), jj = i - b * u;
      if (jj >= nu) continue;
      const int j = j0 + jj;
      const size_t row = sS + (size_t)b * S + t;
      hs[row * d + j] = st[3 * P + i];
      if (Gs) {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          Gs[row * 4 * d + q * d + j] = gnow[b * C + q * u + jj];
        Cs[row * d + j] = st[i];
        Ns[row * d + j] = st[P + i];
        Ms[row * d + j] = st[2 * P + i];
      }
      if (!more) {
        const size_t at = s0 + (size_t)b * d + j;
        cout[at] = st[i];
        nout[at] = st[P + i];
        mout[at] = st[2 * P + i];
        hout[at] = st[3 * P + i];
      }
    }
    STAMP(3);
    if (more) {
      ++met;
      gather_h(slot, h_s, B, d, dpad, tag);
      __syncthreads();
    }
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
                                          int j0, int t, Div by_u) {
  const int P = B * u;
#pragma unroll 1
  for (int i = threadIdx.x; i < P; i += kThreads) {
    const int b = by_u(i), jj = i - b * u;
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

// The backward's registers of W_r: wb[i][c] = W_r[k][col(c)] for
// k = tid + 256 (3 kp + i) and local column c + 24 cp, from w_s.
__device__ __forceinline__ void bwd_panel(float (&wb)[kKB][kPanelC],
                                          const float* w_s, int cp, int kp,
                                          int C, int d, int dpad) {
  const int sw = w_stride(dpad);
#pragma unroll
  for (int i = 0; i < kKB; ++i) {
    const int k = threadIdx.x + kThreads * (kp * kKB + i);
#pragma unroll
    for (int c = 0; c < kPanelC; ++c) {
      const int cc = cp * kPanelC + c;
      wb[i][c] = cc < C && k < d ? w_s[(size_t)cc * sw + k] : 0.f;
    }
  }
}

// The block's partials of dh_{t-1} = dg_t W_r^T over every unit k (thread
// k of each 256 holding 3 k), summed over the block's 4u columns in
// order, into stage[3 X T + b nu_X + (k - X u)] for the block X owning
// unit k (T = bwd_triples(B, u)); kRes: unit[i] holds X, k - X u, nu_X
// of the thread's k.
template <bool kRes>
__device__ __forceinline__ void bwd_product(
    const float* dg_s, const float* w_s, float (&wb)[kKB][kPanelC],
    const int3 (&unit)[kKB], int B, int C, int u, int d, int dpad,
    float* stage) {
  const int kps = kRes ? 1 : (d + kPanelK - 1) / kPanelK;
  const int cps = kRes ? 1 : (C + kPanelC - 1) / kPanelC;
  const int L = 3 * bwd_triples(B, u);
#pragma unroll 1
  for (int r0 = 0; r0 < B; r0 += kRows)
#pragma unroll 1
    for (int kp = 0; kp < kps; ++kp) {
      float acc[kRows][kKB];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int i = 0; i < kKB; ++i) acc[r][i] = 0.f;
#pragma unroll 1
      for (int cp = 0; cp < cps; ++cp) {
        if (!kRes) bwd_panel(wb, w_s, cp, kp, C, d, dpad);
#pragma unroll
        for (int c4 = 0; c4 < kPanelC; c4 += 4) {
          const int cc = cp * kPanelC + c4;
          if (cc >= C) break;                      // 4u: whole quads
          float4 g[kRows];
#pragma unroll
          for (int r = 0; r < kRows; ++r)
            g[r] = r0 + r < B ? lds4(dg_s + (r0 + r) * C + cc)
                              : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
          for (int i = 0; i < kKB; ++i)
#pragma unroll
            for (int r = 0; r < kRows; ++r) {
              float a = acc[r][i];
              a = fmaf(g[r].x, wb[i][c4], a);
              a = fmaf(g[r].y, wb[i][c4 + 1], a);
              a = fmaf(g[r].z, wb[i][c4 + 2], a);
              acc[r][i] = fmaf(g[r].w, wb[i][c4 + 3], a);
            }
        }
      }
#pragma unroll
      for (int i = 0; i < kKB; ++i) {
        const int k = threadIdx.x + kThreads * (kp * kKB + i);
        if (k >= d) continue;
        const int X = kRes ? unit[i].x : k / u;
        const int nuX = kRes ? unit[i].z : min(u, d - X * u);
        float* seg = stage + (size_t)X * L + (kRes ? unit[i].y : k - X * u);
#pragma unroll
        for (int r = 0; r < kRows; ++r)
          if (r0 + r < B) seg[(r0 + r) * nuX] = acc[r][i];
      }
    }
}

// The 16-bit tag of exchange `tag`: never 0 (the zeroed ring) and never
// that of the exchange two before (what a slot held).
__device__ __forceinline__ unsigned tag16(unsigned tag) {
  return tag % 65535u + 1u;
}

// The staged segments (stage, blocks x 3T floats) published as tagged
// words: triple (v0, v1, v2) as the 16 bytes {v0 | v2's high half << 32 |
// t << 48, v1 | v2's low half << 32 | t << 48}, each 64-bit word
// single-copy atomic with its 16-bit tag t; segment X to triples
// [blockIdx.x T, (blockIdx.x + 1) T) of region X, each half-warp one
// segment, its lanes side by side.
__device__ __forceinline__ void bwd_publish(const float* stage, int B, int u,
                                            int nb, unsigned long long* slot,
                                            long long region, unsigned tag) {
  const int T = bwd_triples(B, u), warp = threadIdx.x >> 5;
  const int half = (threadIdx.x >> 4) & 1, lane = threadIdx.x & 15;
  const unsigned long long t = static_cast<unsigned long long>(tag16(tag))
                               << 48;
#pragma unroll 1
  for (int X = 2 * warp + half; X < nb; X += 2 * kWarps)
#pragma unroll 1
    for (int p = lane; p < T; p += 16) {
      const float* v = stage + 3 * (X * T + p);
      const unsigned long long v2 = __float_as_uint(v[2]);
      const unsigned long long w0 =
          t | (v2 >> 16) << 32 | __float_as_uint(v[0]);
      const unsigned long long w1 =
          t | (v2 & 0xffffu) << 32 | __float_as_uint(v[1]);
      unsigned long long* at = slot + (size_t)X * region
                               + 2 * ((size_t)blockIdx.x * T + p);
      asm volatile("st.relaxed.gpu.global.v2.b64 [%0], {%1, %2};"
                   :: "l"(at), "l"(w0), "l"(w1) : "memory");
    }
}

template <bool kRes>
__global__ void __launch_bounds__(kThreads, 1)
slstm_bwd(const float* __restrict__ wr, const float* __restrict__ c0,
          const float* __restrict__ n0, const float* __restrict__ m0,
          const float* __restrict__ Gs, const float* __restrict__ Cs,
          const float* __restrict__ Ns, const float* __restrict__ Ms,
          const float* __restrict__ dhs, const float* __restrict__ dcT,
          const float* __restrict__ dnT, const float* __restrict__ dmT,
          const float* __restrict__ dhT, float* __restrict__ dG,
          float* __restrict__ dc0, float* __restrict__ dn0,
          float* __restrict__ dm0, float* __restrict__ dh0,
          unsigned long long* ring, int Ball, int S, int d, int u,
          int rows) {
  extern __shared__ float4 smem4[];
  const int C = 4 * u, D4 = 4 * d, dpad = padded_d(d), nb = gridDim.x;
  const int Pr = rows * u;
  float* w_s = reinterpret_cast<float*>(smem4);    // [4u][dpad + 4]
  float* dg_s = w_s + (kRes ? 0 : (size_t)C * w_stride(dpad));  // [rows][4u]
  float* red = dg_s + (size_t)rows * C;            // [blocks][segment]
  float* dhr = red + (size_t)nb * (Pr + 6);        // [rows][u]
  float* pf = dhr + Pr;                            // [2][11][rows][u]
  float* st = pf + 2 * (size_t)kBwdStage * Pr;     // dc, dn, dm: [3][rows][u]
  const int j0 = blockIdx.x * u, nu = min(u, d - j0);
  const Div by_u(u), by_nu(nu);
  const long long region = bwd_region_words(nb, rows, u);
  unsigned met = 0;                                // exchanges passed
  float wb[kKB][kPanelC];
  int3 unit[kKB];                      // the owner of each of the thread's k
#pragma unroll
  for (int i = 0; i < kKB; ++i) {
    const int k = threadIdx.x + kThreads * i, X = k / u;
    unit[i] = make_int3(X, k - X * u, min(u, d - X * u));
  }
  load_w_shared(w_s, wr, C, u, nu, d, dpad, j0, by_u);
  if (kRes) {                  // into registers; the buffers then take w_s
    __syncthreads();
    bwd_panel(wb, w_s, 0, 0, C, d, dpad);
  }
  STAMP_BEGIN;

  for (int b0 = 0; b0 < Ball; b0 += rows) {
  // chunk b0: its rows' slices of every (B, ...) tensor
  const int B = min(rows, Ball - b0), P = B * u, Pn = B * nu;
  const size_t s0 = (size_t)b0 * d, sS = (size_t)b0 * S;
  const float* Gs_c = Gs + sS * D4;
  const float* Cs_c = Cs + sS * d;
  const float* Ns_c = Ns + sS * d;
  const float* Ms_c = Ms + sS * d;
  const float* dhs_c = dhs + sS * d;
  float* dG_c = dG + sS * D4;
  __syncthreads();             // the chunk before is done with the buffers
  fetch_bwd(pf + ((S - 1) & 1) * kBwdStage * P, Gs_c, Cs_c, Ns_c, Ms_c, dhs_c,
            B, S, d, u, nu, j0, S - 1, by_u);
  cp_async_commit();
#pragma unroll 1
  for (int i = threadIdx.x; i < P; i += kThreads) {
    const int b = by_u(i), jj = i - b * u;
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
                dhs_c, B, S, d, u, nu, j0, t - 1, by_u);
    cp_async_commit();
    cp_async_wait_prev();
    __syncthreads();
    STAMP_STEP;
    STAMP(0);
#pragma unroll 1
    for (int i = threadIdx.x; i < P; i += kThreads) {
      const int b = by_u(i), jj = i - b * u;
      if (jj >= nu) {
#pragma unroll
        for (int q = 0; q < 4; ++q) dg_s[b * C + q * u + jj] = 0.f;
        continue;
      }
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
      const float q_ = dh / D;
      const float d_o = q_ * c_t;
      const float dc = st[i] + q_ * o;
      const float dn = st[P + i] + (-dh * (h_t / D)) * tie_weight(n_t, 1.f);
      const float dfa = dc * c_p + dn * n_p;
      const float dia = dc * z + dn;
      const float ea = dfa * fa, ei = dia * ia;
      const float dmt = st[2 * P + i] - ea - ei;
      const float wa = tie_weight(a, ii);
      const float da = ea + dmt * wa;
      const float di = ei + dmt * (1.f - wa);
      dg_s[b * C + jj] = dc * ia * (1.f - z * z);
      dg_s[b * C + u + jj] = di;
      dg_s[b * C + 2 * u + jj] = da * sigmoidf_(-fi);
      dg_s[b * C + 3 * u + jj] = d_o * o * (1.f - o);
      st[i] = dc * fa;
      st[P + i] = dn * fa;
      st[2 * P + i] = da;
    }
    __syncthreads();
    STAMP(1);
    const bool more = t > 0 || dh0 != nullptr;
    const unsigned tag = met + 1;
    unsigned long long* slot = ring + (size_t)(tag & 1) * nb * region;
    if (more) {
      bwd_product<kRes>(dg_s, w_s, wb, unit, B, C, u, d, dpad, red);
      __syncthreads();
      bwd_publish(red, B, u, nb, slot, region, tag);
    }
    STAMP(2);
#pragma unroll 1
    for (int i = threadIdx.x; i < B * C; i += kThreads) {   // dG, off the path
      const int bq = by_u(i), b = bq >> 2, q = bq & 3, jj = i - bq * u;
      if (jj < nu) dG_c[((size_t)b * S + t) * D4 + q * d + j0 + jj] = dg_s[i];
    }
    STAMP(3);
    if (!more) break;
    ++met;
    __syncthreads();                   // the staged partials are all out
    {
      const unsigned t16 = tag16(tag);
      gather(slot + blockIdx.x * region, nb * bwd_triples(B, u),
             [](int) { return true; }, [&](int q, ulonglong2 v) {
               if (v.x >> 48 != t16 || v.y >> 48 != t16) return false;
               red[3 * q] = __uint_as_float(static_cast<unsigned>(v.x));
               red[3 * q + 1] = __uint_as_float(static_cast<unsigned>(v.y));
               red[3 * q + 2] = __uint_as_float(static_cast<unsigned>(
                   (v.x >> 32 & 0xffffu) << 16 | (v.y >> 32 & 0xffffu)));
               return true;
             });
    }
    __syncthreads();
    STAMP(4);
    {  // dh_{t-1}'s recurrent part of each unit, kSum units a warp at once:
       // lanes over the blocks in order, then a xor tree
      const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll 1
      for (int o0 = warp * kSum; o0 < Pn; o0 += kWarps * kSum) {
        float sum[kSum];
#pragma unroll
        for (int m = 0; m < kSum; ++m) sum[m] = 0.f;
#pragma unroll 4
        for (int Y = lane; Y < nb; Y += 32)
#pragma unroll
          for (int m = 0; m < kSum; ++m)
            if (o0 + m < Pn)
              sum[m] += red[(size_t)Y * 3 * bwd_triples(B, u) + o0 + m];
#pragma unroll
        for (int off = 16; off; off >>= 1)
#pragma unroll
          for (int m = 0; m < kSum; ++m)
            sum[m] += __shfl_xor_sync(0xffffffffu, sum[m], off);
        if (lane == 0)
#pragma unroll
          for (int m = 0; m < kSum; ++m)
            if (o0 + m < Pn) {
              const int b = by_nu(o0 + m);
              dhr[b * u + (o0 + m - b * nu)] = sum[m];
            }
      }
    }
    __syncthreads();
    STAMP(5);
  }
  if (dh0 != nullptr) {
#pragma unroll 1
    for (int i = threadIdx.x; i < P; i += kThreads) {
      const int b = by_u(i), jj = i - b * u;
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

// S - 1 exchanges of the forward's h on its grid for one chunk of (B, d)
// (each block publishes its B x u words, then gathers all B x d) and
// nothing else: the floor of a chunk's chain of steps.
__global__ void __launch_bounds__(kThreads, 1)
slstm_exchange(unsigned long long* ring, int B, int S, int d, int u) {
  extern __shared__ float4 smem4[];
  float* h_s = reinterpret_cast<float*>(smem4);    // [B][dpad]
  const int dpad = padded_d(d), j0 = blockIdx.x * u, nu = min(u, d - j0);
  const Div by_u(u);
#pragma unroll 1
  for (int i = threadIdx.x; i < B * dpad; i += kThreads) h_s[i] = 0.f;
  __syncthreads();
  for (unsigned tag = 1; tag < (unsigned)S; ++tag) {
    unsigned long long* slot = ring + (size_t)(tag & 1) * B * dpad;
#pragma unroll 1
    for (int i = threadIdx.x; i < B * u; i += kThreads) {
      const int b = by_u(i), jj = i - b * u;
      if (jj < nu) {
        const size_t at = (size_t)b * dpad + j0 + jj;
        publish(slot + at, h_s[at] + 1.f, tag);
      }
    }
    gather_h(slot, h_s, B, d, dpad, tag);
    __syncthreads();
  }
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
// once, after zeroing the exchange's ring (ring_bytes of it; none when
// the launch exchanges nothing); a grid that cannot be resident is
// refused (by the occupancy API here, and by CUDA).
template <typename Kernel, typename... Args>
int launch_coop(Kernel kernel, int blocks, int sms, long long smem,
                void* ring, long long ring_bytes, cudaStream_t stream,
                Args... args) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (!e && ring_bytes > 0)
    e = cudaMemsetAsync(ring, 0, (size_t)ring_bytes, stream);
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
// not fit), the bytes of each one's exchange ring, whether W_r's slice
// stays in registers (1) or in shared memory (0), the card's SMs and its
// opt-in shared memory a block.  Returns a CUDA error, or 0.
int slstm_scan_plan(int B, int d, int* u, int* blocks, int* rows_fwd,
                    int* rows_bwd, long long* smem_fwd, long long* smem_bwd,
                    long long* ring_fwd, long long* ring_bwd, int* in_regs,
                    int* sms, int* optin) {
  if (B < 1 || d < 1) return cudaErrorInvalidValue;
  const int e = sm_count(sms, optin);
  if (e) return e;
  *u = (d + *sms - 1) / *sms;
  *blocks = (d + *u - 1) / *u;
  const int dpad = padded_d(d), nb = *blocks;
  const bool res = w_in_registers(d, *u);
  *in_regs = res;
  const long long f0 = fwd_smem_floats(0, dpad, *u, res);
  const long long b0 = bwd_smem_floats(0, dpad, *u, nb, res);
  *rows_fwd = chunk_rows(B, f0, fwd_smem_floats(1, dpad, *u, res) - f0,
                         *optin);
  *rows_bwd = chunk_rows(B, b0, bwd_smem_floats(1, dpad, *u, nb, res) - b0,
                         *optin);
  const int rf = *rows_fwd ? *rows_fwd : 1, rb = *rows_bwd ? *rows_bwd : 1;
  // W_r's slice passes through the buffers' space on its way to registers
  const long long wf = res ? 4LL * *u * w_stride(dpad) : 0;
  const long long ff = fwd_smem_floats(rf, dpad, *u, res);
  const long long bf = bwd_smem_floats(rb, dpad, *u, nb, res);
  *smem_fwd = 4 * (ff > wf ? ff : wf);
  *smem_bwd = 4 * (bf > wf ? bf : wf);
  *ring_fwd = 8LL * 2 * rf * dpad;
  *ring_bwd = 8LL * 2 * nb * bwd_region_words(nb, rb, *u);
  return 0;
}

#define SLSTM_PLAN                                                          \
  int u, blocks, rf, rb, res, sms, optin;                                   \
  long long sf, sb, ringf, ringb;                                           \
  int e = slstm_scan_plan(B, d, &u, &blocks, &rf, &rb, &sf, &sb, &ringf,    \
                          &ringb, &res, &sms, &optin);                      \
  if (e) return e;

// gx (B, S, 4d), wr (d, 4d), bias (4d), hs (B, S, d) and every state
// (B, d): f32, contiguous.  c0, n0, m0, h0 null together (c = n = h = 0,
// m = -inf) or all given; Gs (B, S, 4d), Cs, Ns, Ms (B, S, d) null
// together (inference) or all given.  ring: the plan's ring_fwd bytes of
// scratch, 16-byte aligned.  S >= 1; the wrapper checks shapes and that
// one row fits.
int slstm_scan_fwd_launch(const void* gx, const void* wr, const void* bias,
                          const void* c0, const void* n0, const void* m0,
                          const void* h0, void* hs, void* cout, void* nout,
                          void* mout, void* hout, void* Gs, void* Cs,
                          void* Ns, void* Ms, void* ring, int B, int S,
                          int d, void* stream) {
  SLSTM_PLAN
  if (S < 1 || rf < 1) return cudaErrorInvalidValue;
  auto kernel = res ? slstm_fwd<true> : slstm_fwd<false>;
  return launch_coop(
      kernel, blocks, sms, sf, ring, S > 1 ? ringf : 0,
      static_cast<cudaStream_t>(stream), (const float*)gx, (const float*)wr,
      (const float*)bias, (const float*)c0, (const float*)n0,
      (const float*)m0, (const float*)h0, (float*)hs, (float*)cout,
      (float*)nout, (float*)mout, (float*)hout, (float*)Gs, (float*)Cs,
      (float*)Ns, (float*)Ms, static_cast<unsigned long long*>(ring), B, S,
      d, u, rf);
}

// The forward's wr, initial state (null: the default) and saved Gs, Cs,
// Ns, Ms; dhs (B, S, d); dcT, dnT, dmT, dhT (B, d), the final state's
// gradients, each null for zeros.  Writes dG (B, S, 4d) and, when dh0 is
// not null, dc0, dn0, dm0, dh0 (B, d), the initial state's.  ring: the
// plan's ring_bwd bytes of scratch, 16-byte aligned.
int slstm_scan_bwd_launch(const void* wr, const void* c0, const void* n0,
                          const void* m0, const void* Gs, const void* Cs,
                          const void* Ns, const void* Ms, const void* dhs,
                          const void* dcT, const void* dnT, const void* dmT,
                          const void* dhT, void* dG, void* dc0, void* dn0,
                          void* dm0, void* dh0, void* ring, int B, int S,
                          int d, void* stream) {
  SLSTM_PLAN
  if (S < 1 || rb < 1) return cudaErrorInvalidValue;
  auto kernel = res ? slstm_bwd<true> : slstm_bwd<false>;
  return launch_coop(
      kernel, blocks, sms, sb, ring, S > 1 || dh0 ? ringb : 0,
      static_cast<cudaStream_t>(stream), (const float*)wr, (const float*)c0,
      (const float*)n0, (const float*)m0, (const float*)Gs, (const float*)Cs,
      (const float*)Ns, (const float*)Ms, (const float*)dhs,
      (const float*)dcT, (const float*)dnT, (const float*)dmT,
      (const float*)dhT, (float*)dG, (float*)dc0, (float*)dn0, (float*)dm0,
      (float*)dh0, static_cast<unsigned long long*>(ring), B, S, d, u, rb);
}

// S - 1 exchanges of the forward's h for one chunk of (B, d) on its grid,
// nothing else; ring: the plan's ring_fwd bytes.
int slstm_barriers_launch(void* ring, int B, int S, int d, void* stream) {
  SLSTM_PLAN
  if (S < 1 || rf < 1) return cudaErrorInvalidValue;
  return launch_coop(slstm_exchange, blocks, sms,
                     4LL * rf * padded_d(d), ring, S > 1 ? ringf : 0,
                     static_cast<cudaStream_t>(stream),
                     static_cast<unsigned long long*>(ring), rf, S, d, u);
}

#ifdef SLSTM_STAMPS
// The stamps of the last launches: g_stamps as n long longs into out
// (host memory).
int slstm_stamps(long long* out, long long n) {
  if (n > (long long)(sizeof(g_stamps) / sizeof(long long)))
    return cudaErrorInvalidValue;
  cudaError_t e = cudaDeviceSynchronize();
  return e ? e : cudaMemcpyFromSymbol(out, g_stamps, n * sizeof(long long));
}
#endif

const char* slstm_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
