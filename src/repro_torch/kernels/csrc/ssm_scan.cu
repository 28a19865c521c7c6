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
// The backward (ssm_scan_bwd, then ssm_scan_bwd_sum) has no Pallas
// counterpart: the JAX package differentiates its oracle, under
// jax.checkpoint pieces that keep a piece's boundary state and take its
// steps again.  With a_t = exp(dt_t A), u_t = dt_t x_t and g_t the
// gradient of h_t (seeded by the final state's), in reverse:
//   g_t = dy_t C_t + a_{t+1} g_{t+1};  dC_t = sum_c dy_t[c] h_t[c, :];
//   dB_t = sum_c g_t[c, :] u_t[c];  du_t = <g_t, B_t>;
//   da_t = <g_t, h_{t-1}>;  dx = du dt;  ddt = du x + da a A;
//   dA = sum_{b,t} da a dt;  dh0 = a_0 g_0.
// h_{t-1} cannot be had from h_t by dividing by a_t: dt A reaches -300 a
// step at the reference's init, and a underflows to 0.  So the forward,
// when a gradient is wanted (hsave not null), writes the state before
// every tile of kT = 16 steps: ceil(S / 16) - 1 states of B x C x N f32,
// 655 MB at Zamba2-2.7B's training call (B 4, S 2,000, C 5,120, N 64),
// where the JAX package's pieces keep one a piece; the model's group
// checkpoint keeps six layers' worth live (3.9 GB) while it takes a
// group's backward.  16 is the forward's own tile, so saving costs it
// one float4 store a thread a tile and no change of design; a wider
// spacing would need a second recompute level or shared memory the
// block does not have (a tile's states are kT x kCB x NB x 4 = 128 KB).
// Bound: operations.  14 a (b, t, c, n): the state again (a multiply and
// an FMA, 3), then an FMA each for dC, g, dB, du and da (10) and the
// decay's multiply (1); at Zamba2's call 36.7 GFLOP, 0.55 ms at 67
// TFLOP/s, against 1.08 GB of compulsory bytes (x, dt, dy, dx, ddt in
// bf16, B, C, dB, dC, and the saved states read once), 0.32 ms.
// Design: a block takes the forward's 32 channels of one batch row with
// its thread layout and walks the tiles from the last.  Per tile it
// loads x, dt, dy, B and C by cp.async (the next tile's copies in flight
// while this one runs) and walks it as two halves of 8 steps, the later
// first: for the later half it takes the state at step 8 again in
// registers from the tile's boundary (8 steps of the forward, 3 more
// operations a (b, t, c, n) in each 16-step tile, +11 % on the 14 the
// bound counts), then for each half the 8 states into shared memory (each
// thread its own, 64 KB at N = 64), summing dC over the warp's channels on
// the way (shuffles by recursive halving across the warp's four channel
// slots); then walks the half's steps in reverse with g in registers, du
// and da each lane's share (summed over a channel's lanes after the tile,
// as the forward's y) and dB summed over the warp as dC.  A half's dB and
// dC go out as this block's partial rows (the four warps added in order),
// dA's sum over the block's steps as a partial of its batch row; the
// second kernel adds the C / 32 partials of dB and dC and the B of dA in
// order.  No atomics: two launches give the same bits, and every f32 sum
// runs in the order of a one-pass walk of the whole tile, so the halves
// change no bit.  Shared memory: 110 KB a block at N = 64 in bf16 (a
// whole tile's 16 states would take 194 KB and leave one block an SM), so
// two blocks of 4 warps share an SM and one's shuffles and barriers run
// under the other's arithmetic (ssm_scan_bwd_occupancy reports the count;
// PERF.md has the times, tools/ssm_bwd_turns.py takes them).  Saving the
// state every 8 steps instead takes no step again but doubles the saved
// states and slows the forward more than it speeds the backward.
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

// The boundary states (the forward's, read by the backward) in each
// thread's own order: slot `tile` of the state before that tile, float4
// group (k2, q) of thread `threadIdx.x` of block (blockIdx.x, blockIdx.y),
// so a warp writes and reads 512 contiguous bytes at a time.  The grid is
// the same in both kernels.
template <int NQ, typename P>
__device__ __forceinline__ P* state_slot(P* hs, int tile) {
  return hs + (((long long)tile * gridDim.y + blockIdx.y) * gridDim.x +
               blockIdx.x) * (kCPT * NQ * kThreads) + threadIdx.x;
}

template <int NQ>
__device__ __forceinline__ void save_state(float4* hs, int tile,
                                           const float (&h)[kCPT][4 * NQ]) {
  float4* d = state_slot<NQ>(hs, tile);
#pragma unroll
  for (int k2 = 0; k2 < kCPT; ++k2)
#pragma unroll
    for (int q = 0; q < NQ; ++q)
      d[(k2 * NQ + q) * kThreads] =
          make_float4(h[k2][4 * q], h[k2][4 * q + 1], h[k2][4 * q + 2],
                      h[k2][4 * q + 3]);
}

// vec bits: 1 x, 2 dt, 4 Bm, 8 Cm may take 16-byte copies.
template <typename T, int NB>
__global__ void __launch_bounds__(kThreads)
ssm_scan_fwd(const T* __restrict__ x, const T* __restrict__ dt,
             const float* __restrict__ A, const T* __restrict__ Bm,
             const T* __restrict__ Cm, const float* __restrict__ h0,
             T* __restrict__ y, float* __restrict__ hout,
             float4* __restrict__ hsave, Strides sx, Strides sdt,
             Strides sbm, Strides scm, Strides sy, int S, int C, int N,
             int vec) {
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
    if (hsave != nullptr && k > 0)     // the state before tile k
      save_state<NQ>(hsave, k - 1, h);
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

// ---------------------------------------------------------------------------
// The backward
// ---------------------------------------------------------------------------

constexpr int kWarps = kThreads / 32;
static_assert(kSlots % kWarps == 0 && 32 / kL == 4,
              "four channel slots a warp (lane bits 3 and 4)");

constexpr int kTB = kT / 2;            // steps a backward half-tile
static_assert(kTB % kL == 0, "a half-tile's steps split over the lanes");

template <int NB>
__host__ __device__ constexpr int bwd_raw_elems() {  // x, dt, dy, B, C
  return 3 * kT * kCB + 2 * kT * NB;
}

template <typename T, int NB>
__host__ __device__ constexpr size_t bwd_smem_bytes() {
  return (size_t)kTB * kCB * NB * sizeof(float)        // a half's states
         + kT * kCB * sizeof(float4)                   // (a, u, dy, dt)
         + kT * kCB * sizeof(float2)                   // (dx, ddt)
         + 2 * kTB * NB * sizeof(float)                // B, C in f32
         + 2 * kWarps * kTB * NB * sizeof(float)       // dB, dC by warp
         + kStages * bwd_raw_elems<NB>() * sizeof(T);  // ring
}

// Sums v over the four channel slots of a warp (lane bits 3 and 4) by
// recursive halving: the lane ends with NPL / 4 of the NPL sums, those
// from the returned index on.
template <int NPL>
__device__ __forceinline__ int slot_sum(float (&v)[NPL], int lane) {
  constexpr int H1 = NPL / 2, H2 = NPL / 4;
  const bool up1 = lane & 8, up2 = lane & 16;
#pragma unroll
  for (int j = 0; j < H1; ++j) {
    const float send = up1 ? v[j] : v[j + H1];
    const float keep = up1 ? v[j + H1] : v[j];
    v[j] = keep + __shfl_xor_sync(0xffffffffu, send, 8);
  }
#pragma unroll
  for (int j = 0; j < H2; ++j) {
    const float send = up2 ? v[j] : v[j + H2];
    const float keep = up2 ? v[j + H2] : v[j];
    v[j] = keep + __shfl_xor_sync(0xffffffffu, send, 16);
  }
  return (up1 ? H1 : 0) + (up2 ? H2 : 0);
}

template <int V>
struct Half {                          // a half-tile's index, as a type
  static constexpr int value = V;
};

// The gradients of ssm_scan_fwd.  A block takes the forward's kCB channels
// of one batch row, with the same thread layout, and walks the tiles from
// the last to the first; the forward's state before each tile (hsave, or
// h0 for the first) lets it take the tile's states again.  g, the
// gradient of the state carried from the later steps, stays in registers
// (seeded by dh, the final state's gradient).  A tile of kT steps is
// walked as two halves of kTB steps, the later first, so that shared
// memory holds kTB states a thread, not kT, and two blocks fit an SM.
// Per tile:
//  0. (a, u, dy, dt) of the kT steps into sP; B and C of a half in f32
//     into sB, sC;
//  1. when the tile has steps in its later half: the state before that
//     half again, in registers, from the tile's boundary (kTB steps of the
//     forward's recurrence in its own expressions, so the same bits);
//  2. each half, the later first: its states again, each thread's own
//     into sH; dC_t = sum_c dy_t[c] h_t[c, :] summed over the warp's
//     channels into sRC (the two channels of a thread, then the four
//     slots of a warp); then its steps in reverse: g_t = dy_t C_t + g,
//     du_t = <g_t, B_t>, da_t = <g_t, h_{t-1}> (each lane's share, as the
//     forward's y, kept for the tile's kT steps), dB_t = sum_c g_t[c, :]
//     u_t[c] by warp into sRB, then g = a_t g_t; the half's dB and dC go
//     out (the four warps added in order) to this block's partial rows
//     pB, pC (parts, B, S, N);
//  3. du and da summed over a channel's lanes by recursive halving over
//     the tile's kT steps; dx, ddt into sO, a_t dt_t da_t into the lane's
//     sum for dA.
// Every f32 sum runs in the order a walk of the whole tile in one pass
// takes (du and da are summed over the lanes once a tile, over its kT
// steps), so the halves change no bit of the outputs.  dx, ddt go out at the top of the next tile; dA's sum over the
// block's steps to pA (B, C).  ssm_scan_bwd_sum adds the parts in order.
// vec bits as the forward's, and 16 for dy.
template <typename T, int NB>
__global__ void __launch_bounds__(kThreads)
ssm_scan_bwd(const T* __restrict__ x, const T* __restrict__ dt,
             const float* __restrict__ A, const T* __restrict__ Bm,
             const T* __restrict__ Cm, const float* __restrict__ h0,
             const float4* __restrict__ hsave, const T* __restrict__ dy,
             const float* __restrict__ dh, T* __restrict__ dx,
             T* __restrict__ ddt, float* __restrict__ dh0,
             float* __restrict__ pB, float* __restrict__ pC,
             float* __restrict__ pA, Strides sx, Strides sdt, Strides sbm,
             Strides scm, Strides sdy, Strides sdx, int S, int C, int N,
             int vec) {
  constexpr int NPL = NB / kL;         // states a lane
  constexpr int NQ = NPL / 4;          // float4 groups a lane
  constexpr int HSTEP = kCPT * NQ * kThreads;   // float4s of sH a step
  static_assert(NPL % 4 == 0, "a lane holds whole float4 groups");
  static_assert(kTB * NB % kThreads == 0, "whole passes over a half's N");
  extern __shared__ __align__(16) unsigned char smem[];
  float4* sH = reinterpret_cast<float4*>(smem);
  float4* sP = sH + kTB * HSTEP;
  float2* sO = reinterpret_cast<float2*>(sP + kT * kCB);
  float* sB = reinterpret_cast<float*>(sO + kT * kCB);
  float* sC = sB + kTB * NB;
  float* sRB = sC + kTB * NB;
  float* sRC = sRB + kWarps * kTB * NB;
  T* ring = reinterpret_cast<T*>(sRC + kWarps * kTB * NB);

  const int b = blockIdx.y;
  const int c0 = blockIdx.x * kCB;
  const int cols = min(kCB, C - c0);
  const int sub = threadIdx.x % kL;
  const int slot = threadIdx.x / kL;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x / 32;
  const T* xb = x + b * sx.b + c0;
  const T* db = dt + b * sdt.b + c0;
  const T* bb = Bm + b * sbm.b;
  const T* cb = Cm + b * scm.b;
  const T* gb = dy + b * sdy.b + c0;
  T* dxb = dx + b * sdx.b + c0;
  T* ddtb = ddt + b * sdx.b + c0;
  const long long part = (long long)gridDim.y * S * N;   // (B, S, N)
  float* pBb = pB + blockIdx.x * part + (long long)b * S * N;
  float* pCb = pC + blockIdx.x * part + (long long)b * S * N;

  float g[kCPT][NPL];
  float ak[kCPT], dA_acc[kCPT];
#pragma unroll
  for (int k2 = 0; k2 < kCPT; ++k2) {
    const int cl = slot + kSlots * k2;
    ak[k2] = cl < cols ? A[c0 + cl] : 0.f;
    dA_acc[k2] = 0.f;
    const float* gr = dh + ((long long)b * C + c0 + cl) * N;
#pragma unroll
    for (int q = 0; q < NQ; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int n = 4 * (sub + kL * q) + e;
        g[k2][4 * q + e] =
            (dh != nullptr && cl < cols && n < N) ? gr[n] : 0.f;
      }
  }
  const int pcl = threadIdx.x % kCB;   // the pre-pass's channel
  const float a = pcl < cols ? A[c0 + pcl] : 0.f;

  const int tiles = (S + kT - 1) / kT;
  auto fetch = [&](int k) {
    T* st = ring + (k % kStages) * bwd_raw_elems<NB>();
    const int t0 = k * kT, rows = min(kT, S - t0);
    load_rows<T, kCB>(st, xb + t0 * sx.s, sx.s, rows, cols, vec & 1);
    load_rows<T, kCB>(st + kT * kCB, db + t0 * sdt.s, sdt.s, rows, cols,
                      vec & 2);
    load_rows<T, kCB>(st + 2 * kT * kCB, gb + t0 * sdy.s, sdy.s, rows, cols,
                      vec & 16);
    load_rows<T, NB>(st + 3 * kT * kCB, bb + t0 * sbm.s, sbm.s, rows, N,
                     vec & 4);
    load_rows<T, NB>(st + 3 * kT * kCB + kT * NB, cb + t0 * scm.s, scm.s,
                     rows, N, vec & 8);
  };
  auto flush_o = [&](int k) {          // tile k's dx, ddt
    const int t0 = k * kT, rows = min(kT, S - t0);
#pragma unroll
    for (int j = 0; j < kT * kCB / kThreads; ++j) {
      const int i = threadIdx.x + j * kThreads;
      const int tt = i / kCB;
      if (tt < rows && pcl < cols) {
        const float2 o = sO[i];
        dxb[(t0 + tt) * sdx.s + pcl] = from_f32<T>(o.x);
        ddtb[(t0 + tt) * sdx.s + pcl] = from_f32<T>(o.y);
      }
    }
  };
  auto flush_bc = [&](int t0) {        // the dB, dC parts of a half-tile
    const int rows = min(kTB, S - t0);
#pragma unroll
    for (int j = 0; j < kTB * NB / kThreads; ++j) {
      const int i = threadIdx.x + j * kThreads;
      const int tt = i / NB, n = i % NB;
      if (tt < rows && n < N) {
        float vb = sRB[i], vc = sRC[i];
#pragma unroll
        for (int w = 1; w < kWarps; ++w) {
          vb += sRB[w * kTB * NB + i];
          vc += sRC[w * kTB * NB + i];
        }
        pBb[(long long)(t0 + tt) * N + n] = vb;
        pCb[(long long)(t0 + tt) * N + n] = vc;
      }
    }
  };
  // B and C of the tile's steps o .. o + kTB - 1 in f32, 0 past the last
  // step and past N
  auto convert_bc = [&](const T* st, int o, int steps) {
#pragma unroll
    for (int j = 0; j < kTB * NB / kThreads; ++j) {
      const int i = threadIdx.x + j * kThreads;
      const bool ok = o + i / NB < steps && i % NB < N;
      sB[i] = ok ? to_f32(st[3 * kT * kCB + o * NB + i]) : 0.f;
      sC[i] = ok ? to_f32(st[3 * kT * kCB + kT * NB + o * NB + i]) : 0.f;
    }
  };
  float h[kCPT][NPL];
  auto boundary = [&](int j) {         // h: saved state j, or h0 (j < 0)
    if (j >= 0) {
      const float4* src = state_slot<NQ>(hsave, j);
#pragma unroll
      for (int k2 = 0; k2 < kCPT; ++k2)
#pragma unroll
        for (int q = 0; q < NQ; ++q) {
          const float4 v = src[(k2 * NQ + q) * kThreads];
          h[k2][4 * q] = v.x;
          h[k2][4 * q + 1] = v.y;
          h[k2][4 * q + 2] = v.z;
          h[k2][4 * q + 3] = v.w;
        }
    } else {
#pragma unroll
      for (int k2 = 0; k2 < kCPT; ++k2) {
        const int cl = slot + kSlots * k2;
        const float* hr = h0 + ((long long)b * C + c0 + cl) * N;
#pragma unroll
        for (int q = 0; q < NQ; ++q)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int n = 4 * (sub + kL * q) + e;
            h[k2][4 * q + e] =
                (h0 != nullptr && cl < cols && n < N) ? hr[n] : 0.f;
          }
      }
    }
  };
  // each lane's share of du, da for the tile's kT steps
  float du[kCPT][kT], da[kCPT][kT];
  // 2. the half-tile of steps O .. O + kTB - 1, h the state before it
  auto walk = [&](auto half) {
    constexpr int O = decltype(half)::value * kTB;
#pragma unroll
    for (int tt = 0; tt < kTB; ++tt) {  // the states again; dC by warp
      float4* hs = sH + tt * HSTEP + threadIdx.x;
      const float4* b4 = reinterpret_cast<const float4*>(sB + tt * NB);
      float4 p[kCPT];
#pragma unroll
      for (int k2 = 0; k2 < kCPT; ++k2)
        p[k2] = sP[(O + tt) * kCB + slot + kSlots * k2];
      float v[NPL];
#pragma unroll
      for (int q = 0; q < NQ; ++q) {
#pragma unroll
        for (int k2 = 0; k2 < kCPT; ++k2)
          hs[(k2 * NQ + q) * kThreads] =
              make_float4(h[k2][4 * q], h[k2][4 * q + 1], h[k2][4 * q + 2],
                          h[k2][4 * q + 3]);
        const float4 bv = b4[sub + kL * q];
        const float bs[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
#pragma unroll
          for (int k2 = 0; k2 < kCPT; ++k2) {
            float& hv = h[k2][4 * q + e];
            hv = fmaf(p[k2].x, hv, p[k2].y * bs[e]);
          }
          float s = p[0].z * h[0][4 * q + e];
#pragma unroll
          for (int k2 = 1; k2 < kCPT; ++k2)
            s = fmaf(p[k2].z, h[k2][4 * q + e], s);
          v[4 * q + e] = s;
        }
      }
      const int first = slot_sum<NPL>(v, lane);
#pragma unroll
      for (int j = 0; j < NPL / 4; ++j) {
        const int jj = first + j;
        sRC[(warp * kTB + tt) * NB + 4 * (sub + kL * (jj / 4)) + jj % 4] =
            v[j];
      }
    }
#pragma unroll
    for (int tt = kTB - 1; tt >= 0; --tt) {   // the steps in reverse
      const float4* hs = sH + tt * HSTEP + threadIdx.x;
      const float4* b4 = reinterpret_cast<const float4*>(sB + tt * NB);
      const float4* c4 = reinterpret_cast<const float4*>(sC + tt * NB);
      float4 p[kCPT];
      float su[kCPT][4], sa[kCPT][4];
#pragma unroll
      for (int k2 = 0; k2 < kCPT; ++k2) {
        p[k2] = sP[(O + tt) * kCB + slot + kSlots * k2];
#pragma unroll
        for (int e = 0; e < 4; ++e) su[k2][e] = sa[k2][e] = 0.f;
      }
      float w[NPL];
#pragma unroll
      for (int q = 0; q < NQ; ++q) {
        const float4 bv = b4[sub + kL * q];
        const float4 cv = c4[sub + kL * q];
        const float bs[4] = {bv.x, bv.y, bv.z, bv.w};
        const float cs[4] = {cv.x, cv.y, cv.z, cv.w};
        float hp[kCPT][4];
#pragma unroll
        for (int k2 = 0; k2 < kCPT; ++k2) {
          const float4 v = hs[(k2 * NQ + q) * kThreads];
          hp[k2][0] = v.x;
          hp[k2][1] = v.y;
          hp[k2][2] = v.z;
          hp[k2][3] = v.w;
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float s = 0.f;
#pragma unroll
          for (int k2 = 0; k2 < kCPT; ++k2) {
            float& gv = g[k2][4 * q + e];
            gv = fmaf(p[k2].z, cs[e], gv);           // g_t
            su[k2][e] = fmaf(gv, bs[e], su[k2][e]);
            sa[k2][e] = fmaf(gv, hp[k2][e], sa[k2][e]);
            s = k2 == 0 ? gv * p[0].y : fmaf(gv, p[k2].y, s);
            gv *= p[k2].x;                           // a_t g_t
          }
          w[4 * q + e] = s;
        }
      }
#pragma unroll
      for (int k2 = 0; k2 < kCPT; ++k2) {
        du[k2][O + tt] = (su[k2][0] + su[k2][1]) + (su[k2][2] + su[k2][3]);
        da[k2][O + tt] = (sa[k2][0] + sa[k2][1]) + (sa[k2][2] + sa[k2][3]);
      }
      const int first = slot_sum<NPL>(w, lane);
#pragma unroll
      for (int j = 0; j < NPL / 4; ++j) {
        const int jj = first + j;
        sRB[(warp * kTB + tt) * NB + 4 * (sub + kL * (jj / 4)) + jj % 4] =
            w[j];
      }
    }
  };

  if (tiles > 0) fetch(tiles - 1);
  cp_async_commit();
  for (int it = 0; it < tiles; ++it) {
    const int k = tiles - 1 - it;
    cp_async_wait<kStages - 2>();      // this thread's copies of tile k
    __syncthreads();                   // everyone's; tile k+1 is done
    if (it > 0) {
      flush_o(k + 1);
      flush_bc((k + 1) * kT);
    }
    const int steps = min(kT, S - k * kT);
    const T* st = ring + (k % kStages) * bwd_raw_elems<NB>();

    // 0. the forward's pre-pass (the same expressions, so the same
    // states), with dy and dt beside; past the last step and channel
    // decay 1 and input 0 keep h and g as they are
#pragma unroll
    for (int j = 0; j < kT * kCB / kThreads; ++j) {
      const int i = threadIdx.x + j * kThreads;
      float4 v = make_float4(1.f, 0.f, 0.f, 0.f);
      if (i / kCB < steps && pcl < cols) {
        const float d = to_f32(st[kT * kCB + i]);
        v = make_float4(expf(d * a), d * to_f32(st[i]),
                        to_f32(st[2 * kT * kCB + i]), d);
      }
      sP[i] = v;
    }
    convert_bc(st, 0, steps);
    if (k > 0) fetch(k - 1);
    cp_async_commit();
    __syncthreads();                   // sP, the earlier half's sB, sC

    if (steps > kTB) {
      boundary(k - 1);                 // 1. the later half's first state
#pragma unroll
      for (int tt = 0; tt < kTB; ++tt) {
        const float4* b4 = reinterpret_cast<const float4*>(sB + tt * NB);
        float4 p[kCPT];
#pragma unroll
        for (int k2 = 0; k2 < kCPT; ++k2)
          p[k2] = sP[tt * kCB + slot + kSlots * k2];
#pragma unroll
        for (int q = 0; q < NQ; ++q) {
          const float4 bv = b4[sub + kL * q];
          const float bs[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
          for (int e = 0; e < 4; ++e)
#pragma unroll
            for (int k2 = 0; k2 < kCPT; ++k2) {
              float& hv = h[k2][4 * q + e];
              hv = fmaf(p[k2].x, hv, p[k2].y * bs[e]);
            }
        }
      }
    }
    if (steps > kTB) {
      __syncthreads();                 // the earlier half's sB read
      convert_bc(st, kTB, steps);
      __syncthreads();
      walk(Half<1>{});                 // 2. the later half
      __syncthreads();                 // its sRB, sRC written, sB, sC read
      flush_bc(k * kT + kTB);
      convert_bc(st, 0, steps);
      __syncthreads();
    } else {                           // no step there: nothing to add
#pragma unroll
      for (int k2 = 0; k2 < kCPT; ++k2)
#pragma unroll
        for (int tt = kTB; tt < kT; ++tt) du[k2][tt] = da[k2][tt] = 0.f;
    }
    boundary(k - 1);
    walk(Half<0>{});                   // 2. the earlier half

    // 3. du, da over a channel's lanes; dx, ddt and dA's terms
    const int base = lane_steps<kT / 2, 1>(du, sub);
    lane_steps<kT / 2, 1>(da, sub);
#pragma unroll
    for (int k2 = 0; k2 < kCPT; ++k2) {
      const int cl = slot + kSlots * k2;
#pragma unroll
      for (int j = 0; j < kT / kL; ++j) {
        const int tt = base + j;
        if (tt < steps && cl < cols) {
          const float4 p = sP[tt * kCB + cl];          // (a, u, dy, dt)
          const float xv = to_f32(st[tt * kCB + cl]);
          const float gl = da[k2][j] * p.x;            // d(dt A)
          sO[tt * kCB + cl] =
              make_float2(du[k2][j] * p.w, fmaf(du[k2][j], xv, gl * ak[k2]));
          dA_acc[k2] = fmaf(gl, p.w, dA_acc[k2]);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();
  if (tiles > 0) {
    flush_o(0);
    flush_bc(0);
  }

#pragma unroll
  for (int k2 = 0; k2 < kCPT; ++k2) {
    const int cl = slot + kSlots * k2;
    // dA: the channel's kL lanes summed in a fixed order (a + b is b + a
    // to the bit, so every lane ends with the same value)
    float v = dA_acc[k2];
#pragma unroll
    for (int m = 1; m < kL; m <<= 1) v += __shfl_xor_sync(0xffffffffu, v, m);
    if (cl >= cols) continue;
    if (sub == 0) pA[(long long)b * C + c0 + cl] = v;
    if (dh0 == nullptr) continue;
    float* hr = dh0 + ((long long)b * C + c0 + cl) * N;   // a_0 g_0
#pragma unroll
    for (int q = 0; q < NQ; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int n = 4 * (sub + kL * q) + e;
        if (n < N) hr[n] = g[k2][4 * q + e];
      }
  }
}

// dB, dC (B, S, N) = the parts of pB, pC summed in order; dA (C,) = pA
// (B, C) summed over the batch in order.  Bytes: each part read once.
template <typename T>
__global__ void ssm_scan_bwd_sum(const float* __restrict__ pB,
                                 const float* __restrict__ pC,
                                 const float* __restrict__ pA,
                                 T* __restrict__ dB, T* __restrict__ dC,
                                 float* __restrict__ dA, int parts,
                                 long long rows, int B, int C) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < rows + C; i += stride) {
    if (i < rows) {
      float vb = 0.f, vc = 0.f;
      for (int k = 0; k < parts; ++k) {
        vb += pB[k * rows + i];
        vc += pC[k * rows + i];
      }
      dB[i] = from_f32<T>(vb);
      dC[i] = from_f32<T>(vc);
    } else {
      const int c = static_cast<int>(i - rows);
      float v = 0.f;
      for (int b = 0; b < B; ++b) v += pA[(long long)b * C + c];
      dA[c] = v;
    }
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// a tensor takes 16-byte copies when its base and its batch and sequence
// strides are 16-byte aligned
template <typename T>
int vec_bits(const void* const* ptrs, int n, const long long* st) {
  int vec = 0;
  for (int i = 0; i < n; ++i) {
    const bool ok = aligned16(ptrs[i]) && st[2 * i] * sizeof(T) % 16 == 0 &&
                    st[2 * i + 1] * sizeof(T) % 16 == 0;
    vec |= ok << i;
  }
  return vec;
}

template <typename T, int NB>
cudaError_t launch(const void* x, const void* dt, const void* A,
                   const void* Bm, const void* Cm, const void* h0, void* y,
                   void* hout, void* hsave, int B, int S, int C, int N,
                   const long long* st, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<T, NB>();
  cudaError_t err = cudaFuncSetAttribute(
      ssm_scan_fwd<T, NB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const void* seq[4] = {x, dt, Bm, Cm};
  const int vec = vec_bits<T>(seq, 4, st);
  const dim3 grid((C + kCB - 1) / kCB, B);
  ssm_scan_fwd<T, NB><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dt),
      static_cast<const float*>(A), static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), static_cast<const float*>(h0),
      static_cast<T*>(y), static_cast<float*>(hout),
      static_cast<float4*>(hsave), Strides{st[0], st[1]},
      Strides{st[2], st[3]}, Strides{st[4], st[5]}, Strides{st[6], st[7]},
      Strides{st[8], st[9]}, S, C, N, vec);
  return cudaGetLastError();
}

struct BwdArgs {
  const void *x, *dt, *A, *Bm, *Cm, *h0, *hsave, *dy, *dh;
  void *dx, *ddt, *dA, *dB, *dC, *dh0, *work;
};

// The backward's shared memory a block, set on the kernel with the
// carveout that gives shared memory all it can (so that two blocks fit).
template <typename T, int NB>
cudaError_t bwd_attributes() {
  constexpr size_t smem = bwd_smem_bytes<T, NB>();
  cudaError_t err = cudaFuncSetAttribute(
      ssm_scan_bwd<T, NB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(ssm_scan_bwd<T, NB>,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

template <typename T, int NB>
cudaError_t bwd_occupancy(int* blocks, long long* smem) {
  cudaError_t err = bwd_attributes<T, NB>();
  if (err != cudaSuccess) return err;
  *smem = (long long)bwd_smem_bytes<T, NB>();
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, ssm_scan_bwd<T, NB>, kThreads, bwd_smem_bytes<T, NB>());
}

template <typename T, int NB>
cudaError_t launch_bwd(const BwdArgs& g, int B, int S, int C, int N,
                       const long long* st, cudaStream_t stream) {
  constexpr size_t smem = bwd_smem_bytes<T, NB>();
  cudaError_t err = bwd_attributes<T, NB>();
  if (err != cudaSuccess) return err;
  const void* seq[5] = {g.x, g.dt, g.Bm, g.Cm, g.dy};
  const int vec = vec_bits<T>(seq, 5, st);
  const dim3 grid((C + kCB - 1) / kCB, B);
  const long long rows = (long long)B * S * N;
  float* pB = static_cast<float*>(g.work);
  float* pC = pB + grid.x * rows;
  float* pA = pC + grid.x * rows;
  ssm_scan_bwd<T, NB><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(g.x), static_cast<const T*>(g.dt),
      static_cast<const float*>(g.A), static_cast<const T*>(g.Bm),
      static_cast<const T*>(g.Cm), static_cast<const float*>(g.h0),
      static_cast<const float4*>(g.hsave), static_cast<const T*>(g.dy),
      static_cast<const float*>(g.dh), static_cast<T*>(g.dx),
      static_cast<T*>(g.ddt), static_cast<float*>(g.dh0), pB, pC, pA,
      Strides{st[0], st[1]}, Strides{st[2], st[3]}, Strides{st[4], st[5]},
      Strides{st[6], st[7]}, Strides{st[8], st[9]}, Strides{st[10], st[11]},
      S, C, N, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long items = rows + C;
  const int blocks = (int)((items + 255) / 256 < 132 * 16
                               ? (items + 255) / 256 : 132 * 16);
  ssm_scan_bwd_sum<T><<<blocks, 256, 0, stream>>>(
      pB, pC, pA, static_cast<T*>(g.dB), static_cast<T*>(g.dC),
      static_cast<float*>(g.dA), grid.x, rows, B, C);
  return cudaGetLastError();
}

// N rounded up to a bucket that splits into whole float4 groups a lane
constexpr int bucket(int nb) { return nb < 4 * kL ? 4 * kL : nb; }
int bucket_of(int N) { return N <= 32 ? bucket(32) : bucket(64); }

template <typename T>
cudaError_t dispatch_n(const void* x, const void* dt, const void* A,
                       const void* Bm, const void* Cm, const void* h0,
                       void* y, void* hout, void* hsave, int B, int S, int C,
                       int N, const long long* st, cudaStream_t stream) {
  if (N <= 16)
    return launch<T, bucket(16)>(x, dt, A, Bm, Cm, h0, y, hout, hsave, B, S,
                                 C, N, st, stream);
  if (N <= 32)
    return launch<T, bucket(32)>(x, dt, A, Bm, Cm, h0, y, hout, hsave, B, S,
                                 C, N, st, stream);
  return launch<T, bucket(64)>(x, dt, A, Bm, Cm, h0, y, hout, hsave, B, S,
                               C, N, st, stream);
}

template <typename T>
cudaError_t dispatch_bwd(const BwdArgs& g, int B, int S, int C, int N,
                         const long long* st, cudaStream_t stream) {
  if (N <= 32) return launch_bwd<T, bucket(32)>(g, B, S, C, N, st, stream);
  return launch_bwd<T, bucket(64)>(g, B, S, C, N, st, stream);
}

}  // namespace

extern "C" {

// x, dt, y: (B, S, C); Bm, Cm: (B, S, N), each with the last-axis stride 1
// and the (batch, seq) strides in `strides` (10 values in elements: x, dt,
// Bm, Cm, y).  A: (C,) f32; h0 (may be null: zeros) and hout: (B, C, N)
// f32 contiguous.  hsave (may be null): ssm_scan_state_floats(...) f32,
// the states before tiles 1, 2, ... for the backward.  dtype 0 = float32,
// 1 = bfloat16 (x, dt, Bm, Cm, y).  1 <= N <= 64 and B <= 65535; the
// wrapper checks both.
int ssm_scan_launch(const void* x, const void* dt, const void* A,
                    const void* Bm, const void* Cm, const void* h0, void* y,
                    void* hout, void* hsave, int dtype, int B, int S, int C,
                    int N, const long long* strides, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N < 1 || N > 64 || B < 1 || B > 65535 || C < 1 || S < 0)
    return cudaErrorInvalidValue;
  if (dtype == 0)
    return dispatch_n<float>(x, dt, A, Bm, Cm, h0, y, hout, hsave, B, S, C,
                             N, strides, s);
  if (dtype == 1)
    return dispatch_n<__nv_bfloat16>(x, dt, A, Bm, Cm, h0, y, hout, hsave, B,
                                     S, C, N, strides, s);
  return cudaErrorInvalidValue;
}

// The forward's saved states: one (B, C, N) state (channels padded to the
// block's kCB, states to the bucket) before every tile of kT steps but
// the first.
long long ssm_scan_state_floats(int B, int S, int C, int N) {
  const long long tiles = (S + kT - 1) / kT;
  if (tiles <= 1) return 0;
  return (tiles - 1) * B * ((C + kCB - 1) / kCB) * kCB * bucket_of(N);
}

// The backward's scratch: the dB and dC parts (C / kCB of (B, S, N)
// each) and dA's (B, C).
long long ssm_scan_bwd_work_floats(int B, int S, int C, int N) {
  return 2LL * ((C + kCB - 1) / kCB) * B * S * N + (long long)B * C;
}

// The forward's inputs, h0 (may be null) and hsave as it filled them; dy
// (B, S, C) in x's type with its strides; dh (B, C, N) f32 contiguous (may
// be null: zeros) -> dx, ddt (B, S, C) in x's type, strides shared; dB,
// dC (B, S, N) contiguous in x's type; dA (C,) f32; dh0 (B, C, N) f32 (may
// be null); work: ssm_scan_bwd_work_floats(...) f32.  `strides`: 12
// values, x, dt, Bm, Cm, dy, dx.
int ssm_scan_bwd_launch(const void* x, const void* dt, const void* A,
                        const void* Bm, const void* Cm, const void* h0,
                        const void* hsave, const void* dy, const void* dh,
                        void* dx, void* ddt, void* dA, void* dB, void* dC,
                        void* dh0, void* work, int dtype, int B, int S, int C,
                        int N, const long long* strides, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N < 1 || N > 64 || B < 1 || B > 65535 || C < 1 || S < 0 ||
      (S > kT && hsave == nullptr))
    return cudaErrorInvalidValue;
  const BwdArgs g{x, dt, A, Bm, Cm, h0, hsave, dy, dh,
                  dx, ddt, dA, dB, dC, dh0, work};
  if (dtype == 0) return dispatch_bwd<float>(g, B, S, C, N, strides, s);
  if (dtype == 1)
    return dispatch_bwd<__nv_bfloat16>(g, B, S, C, N, strides, s);
  return cudaErrorInvalidValue;
}

// The backward kernel's resident blocks an SM (the occupancy API, at its
// 128 threads and shared memory) and its shared memory a block, in bytes,
// for dtype (0 float32, 1 bfloat16) and N as ssm_scan_bwd_launch takes
// them.
int ssm_scan_bwd_occupancy(int dtype, int N, int* blocks, long long* smem) {
  if (N < 1 || N > 64 || dtype < 0 || dtype > 1) return cudaErrorInvalidValue;
  if (dtype == 0)
    return N <= 32 ? bwd_occupancy<float, bucket(32)>(blocks, smem)
                   : bwd_occupancy<float, bucket(64)>(blocks, smem);
  return N <= 32 ? bwd_occupancy<__nv_bfloat16, bucket(32)>(blocks, smem)
                 : bwd_occupancy<__nv_bfloat16, bucket(64)>(blocks, smem);
}

const char* ssm_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
