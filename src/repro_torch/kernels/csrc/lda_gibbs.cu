// The collapsed Gibbs sweep of STRADS LDA, one thread block a worker,
// software-pipelined.
//
// Replaces: the `lax.scan` of `_gibbs_scan` and `_full_gibbs_scan` in the
// JAX package's `apps/lda.py`.  It has no Pallas kernel: the JAX package
// left the scan to XLA.  Eager PyTorch would run it as ~15 launches a
// token, so the port writes the sweep as one kernel.
//
// What it computes (the plain version is `lda_gibbs_ref` in
// `kernels/ref.py`): worker p samples, in slot order, the tokens whose
// word lies in vocabulary block b = (p + phase) % n_blocks, against the
// word-topic slab B[b] (STRADS, `rotate`) or B[p] (the data-parallel
// baseline's replica), its doc-topic rows D[p] and its own copy s~ of the
// topic totals s.  Per token: remove its topic zi; logits
//     (log(gamma + B[v]) - log(vg + s~)) + log(alpha + D[d])
// with full-precision logf (no fast math); the new topic is the first
// argmax of Gumbel noise + logits (ties to the lower topic, as
// jnp.argmax); add it back.  The slots of inactive tokens are exact no-ops
// in the reference, so only the active ones are walked: `order` lists each
// worker's slots sorted by block (stable), `offsets` where each block
// starts.  Counts are f32 integers (exact below 2^24).
//
// Noise: an explicit Gumbel tensor (P, L, K), row j for the worker's j-th
// active token, or Philox-4x32-10 keyed on (seed, phase, worker, slot):
// topic k is word k % 4 at counter (k / 4, slot, p, phase).
//
// What bounds it.  Operations: per topic of a token, four full-precision
// logf (two in the Gumbel draw, log(gamma + B), log(alpha + D)) at ~41
// operations each, 132 GFLOP a round at the NYTimes shape (K = 1,000,
// ~778k tokens), 1.98 ms at 67 TFLOP/s; the bytes (the distinct rows a
// round touches, read once) take 0.43 ms.  But one block walks a worker's
// tokens in order, so a round takes at least the longest chain's work on
// one SM (6,980 tokens x 1,000 topics x 170 operations at 67/132 TFLOP/s
// = 2.34 ms), and every token pays the latency of its decision: the
// block's argmax, then the update the next token depends on.  The design
// keeps only that on the chain:
// - Ownership.  Sampling thread t owns the 4-topic chunks c = t (mod NT):
//   it alone reads and writes columns 4c..4c+3 of B, D, s~ and the logs
//   of s~, so no barrier guards the counts.
// - Noise threads beside them (NG).  They draw the Philox Gumbel rows two
//   tokens ahead and copy the B, D (and explicit noise) rows into a ring
//   of NS token slots in shared memory by cp.async, NS-2 tokens ahead,
//   waiting on their own copies before the barrier that precedes a
//   slot's use.  A copy may or may not see the updates of the tokens
//   sampled while it was in flight, so before a row is used its owner
//   overwrites the entries those tokens changed (same word or same
//   document) with the values they wrote, oldest first: right either way.
// - The next token's logits before the current decision.  Each sampling
//   thread computes token j+1's noisy logits and its best of them before
//   the block's barrier of token j.  Token j then changes at most two
//   topics: their owners patch token j+1's rows and redo those two
//   entries; every other entry stands.
// - Few logf on the chain.  log(gamma + n) and log(alpha + n) for integer
//   n < kTab come from tables built once a launch with the same logf (the
//   same bits); log(vg + s~), log(vg + s~ + 1) and log(vg + s~ - 1) are
//   kept per topic, so a count that moves by one shifts them and only the
//   new end takes a logf.  Every logit keeps the plain version's order of
//   operations, so the bits are the same.
// - One barrier a token: warp bests by redux.sync on an order-preserving
//   key, double-buffered warp slots, every thread reduces the slots
//   itself, and the owners' writes of B, D and z are not waited on.
// At the NYTimes shape a round takes 7.37 ms when few tokens change topic
// and 11.6 ms when nearly all do (a first sweep from a random start); the
// serial design, tools/lda_gibbs_serial.cu, 16.42 and 18.04 ms in the
// same process (NVIDIA H100 80GB HBM3 at 700 W, tools/lda_gibbs_designs.py).
// A topic change costs ~0.6 us of the chain: the owners' update, which
// the block's next barrier waits for.  Without noise threads (NS = 2, K
// from ~3,000 to ~4,700) the sampling threads draw the noise and copy
// their own columns; where no slot fits (NS = 0, larger K) the owners
// read each row at its turn.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#ifdef LDA_GIBBS_STAMPS
// Per-block phase timers (tools/lda_gibbs_designs.py): thread 0 and the
// first noise thread sum the %globaltimer nanoseconds of each phase over
// their block's tokens.
constexpr int kStamps = 8;
__device__ unsigned long long lda_stamps[4096 * kStamps];
__device__ __forceinline__ unsigned long long gtime() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#define STAMP_INIT()                                                   \
  unsigned long long stamp_t = gtime(), stamp_sum[kStamps] = {};
#define STAMP(i)                                                       \
  do {                                                                 \
    const unsigned long long t_ = gtime();                             \
    stamp_sum[i] += t_ - stamp_t;                                      \
    stamp_t = t_;                                                      \
  } while (0)
#define STAMP_END(nt)                                                  \
  do {                                                                 \
    const int who_ = threadIdx.x == 0 ? 0                              \
                     : (blockDim.x > (nt) && threadIdx.x == (nt)) ? 1 : -1; \
    if (who_ >= 0)                                                     \
      for (int i_ = 0; i_ < kStamps; ++i_)                             \
        lda_stamps[(blockIdx.x * 2 + who_) * kStamps + i_] = stamp_sum[i_]; \
  } while (0)
#else
#define STAMP_INIT()
#define STAMP(i)
#define STAMP_END(nt)
#endif

namespace {

constexpr int kTab = 2048;   // count logs tabled for counts below this
constexpr int kLog = 16;     // tokens of post-update values kept (> NS + 1)

struct Args {
  const int* words;
  const int* docs;
  int* z;
  const int* order;
  const int* offsets;
  float* B;
  float* D;
  const float* s;
  float* s_tilde;
  const float* gumbel;
  int T, K, n_blocks, rotate, block_vocab;
  long long slab_floats;
  int dpw, phase, L, vec;
  float vg, alpha, gamma;
  unsigned long long seed;
};

// dynamic shared memory of one block: the ring (NS slots of three rows),
// the next token's logits, log(vg + s~ +- 1) (with a ring), s~,
// log(vg + s~), two tables, 2·NT token ids, and kLog tokens' changed
// topics and their four post-update counts
size_t smem_bytes(int K, int NT, int NS) {
  const size_t Kp = 4 * (size_t)((K + 3) / 4);
  const size_t floats =
      (NS ? Kp * (3 * (size_t)NS + 3) : 0) + 2 * Kp + 2 * kTab;
  return floats * 4 + 2 * (size_t)NT * 16 + kLog * 4 + kLog * 16;
}

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint2 k) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k.x += 0x9E3779B9u;
      k.y += 0xBB67AE85u;
    }
    const unsigned lo0 = 0xD2511F53u * c.x;
    const unsigned hi0 = __umulhi(0xD2511F53u, c.x);
    const unsigned lo1 = 0xCD9E8D57u * c.z;
    const unsigned hi1 = __umulhi(0xCD9E8D57u, c.z);
    c = make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
  }
  return c;
}

// u = (2 (x >> 9) + 1) 2^-24 in (0, 1), exact in f32; g = -log(-log u)
__device__ __forceinline__ float gumbel_of(unsigned x) {
  const float u = (float)(((x >> 9) << 1) | 1u) * 0x1p-24f;
  return -logf(-logf(u));
}

__device__ __forceinline__ float4 philox_gumbel4(int chunk, int slot, int p,
                                                 int phase,
                                                 unsigned long long seed) {
  const uint4 w = philox4x32_10(
      make_uint4((unsigned)chunk, (unsigned)slot, (unsigned)p,
                 (unsigned)phase),
      make_uint2((unsigned)(seed & 0xFFFFFFFFull), (unsigned)(seed >> 32)));
  return make_float4(gumbel_of(w.x), gumbel_of(w.y), gumbel_of(w.z),
                     gumbel_of(w.w));
}

__device__ __forceinline__ float at(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

// the table's logf(add + x) for an integer count 0 <= x < kTab, without a
// branch: x + 2^23 holds x in its low mantissa bits; `miss` is set for
// any other x (the caller recomputes those with logf)
__device__ __forceinline__ float log_count(const float* tab, float x,
                                           bool& miss) {
  const float big = x + 8388608.f;
  const int n = __float_as_int(big) - 0x4B000000;
  const bool hit = (unsigned)n < (unsigned)kTab && big - 8388608.f == x;
  miss |= !hit;
  return tab[hit ? n : 0];
}

// g + ((log(gamma + (b - r)) - lsk) + log(alpha + (d - r))), the counts'
// logs from the tables; `miss` is set where a count is not in them
__device__ __forceinline__ float table_logit(const float* tabB,
                                             const float* tabD, float g,
                                             float b, float d, float r,
                                             float lsk, bool& miss) {
  return g + ((log_count(tabB, b - r, miss) - lsk) +
              log_count(tabD, d - r, miss));
}

// logf and a logit off the hot loops: called where a count misses the
// tables, for the two topics a token changes, and at the start
__device__ __noinline__ float log_cold(float x) { return logf(x); }

__device__ __noinline__ float logit_cold(float g, float b, float d, float lsk,
                                         float gamma, float alpha) {
  return g + ((logf(gamma + b) - lsk) + logf(alpha + d));
}

// a float's order as an unsigned key (-0 taken as +0, so equal floats
// have equal keys); the argmax is the largest key, then the lowest index
__device__ __forceinline__ unsigned order_key(float x) {
  const unsigned u = __float_as_uint(x + 0.f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ void warp_best(unsigned& key, unsigned& idx) {
  const unsigned m = __reduce_max_sync(0xFFFFFFFFu, key);
  idx = __reduce_min_sync(0xFFFFFFFFu, key == m ? idx : 0xFFFFFFFFu);
  key = m;
}

__device__ __forceinline__ void cp_async_4(float* dst, const float* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_16(float* dst, const float* src) {
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

// columns k0..k0+3 (below K) of a global row into the same columns of a
// shared row: one 16-byte copy when every row is 16-byte aligned (`vec`)
__device__ __forceinline__ void copy_chunk(float* dst, const float* row,
                                           int k0, int K, bool vec) {
  if (vec) {
    cp_async_16(dst + k0, row + k0);
  } else {
    for (int e = 0; e < 4 && k0 + e < K; ++e)
      cp_async_4(dst + k0 + e, row + k0 + e);
  }
}

// NT sampling threads (the owners) and NG noise threads, which draw the
// Philox Gumbel noise two tokens ahead and copy the rows into the ring
// (NG = 0: the owners do both); NS ring slots (0: no ring, each row read
// at its turn)
template <int NT, int NS, int NG>
__global__ void __launch_bounds__(NT + NG, 1) lda_gibbs_kernel(const Args a) {
  static_assert(NT % 32 == 0 && (NT & (NT - 1)) == 0 && NT + NG <= 1024,
                "a power of two of sampling warps");
  static_assert(NS == 0 || (NS >= 2 && NS + 2 <= kLog), "ring depth");
  static_assert(NG == 0 || NS >= 4, "noise threads copy rows 2 tokens ahead");
  constexpr int NW = NT / 32;
  constexpr int IDS = 2 * NT;                 // token ids kept: two batches
  extern __shared__ __align__(16) float smem[];
  __shared__ __align__(16) unsigned red_key[2][NW], red_idx[2][NW];

  const int K = a.K, chunks = (K + 3) >> 2, Kp = 4 * chunks;
  float* ring = smem;                         // NS x (B row, D row, noise)
  float* y = ring + (size_t)NS * 3 * Kp;      // the next token's logits
  float* lsp = y + (NS ? Kp : 0);             // logf(vg + (s~ + 1))
  float* lsm = lsp + (NS ? Kp : 0);           // logf(vg + (s~ - 1))
  float* st = lsm + (NS ? Kp : 0);            // s~
  float* ls = st + Kp;                        // logf(vg + s~)
  float* tabB = ls + Kp;                      // logf(gamma + n)
  float* tabD = tabB + kTab;                  // logf(alpha + n)
  int4* ids = reinterpret_cast<int4*>(tabD + kTab);  // (slot, v, d, zi)
  int* znlog = reinterpret_cast<int*>(ids + IDS);    // new topics
  float* post = reinterpret_cast<float*>(znlog + kLog);  // 4 counts a token

  const int p = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31;
  const bool sampler = tid < NT;
  const int rid = sampler ? tid : tid - NT;   // the thread within its role
  const int block = (p + a.phase) % a.n_blocks;
  const long long slab = a.rotate ? block : p;
  const int* op = a.order + (long long)p * a.T;
  const int start = a.offsets[(long long)p * (a.n_blocks + 1) + block];
  const int count =
      a.offsets[(long long)p * (a.n_blocks + 1) + block + 1] - start;
  float* Bp = a.B + slab * a.slab_floats;
  float* Dp = a.D + (long long)p * a.dpw * K;
  const int* wp = a.words + (long long)p * a.T;
  const int* dp = a.docs + (long long)p * a.T;
  int* zp = a.z + (long long)p * a.T;
  const float* gp = a.gumbel ? a.gumbel + (long long)p * a.L * K : nullptr;
  const int vbase = block * a.block_vocab;
  const bool vec = a.vec;
  STAMP_INIT();

  auto own = [&](int k) { return ((k >> 2) & (NT - 1)) == rid; };
  // the logit of topic k plus its noise g, from its counts b and d, for a
  // token whose topic zi is removed: the plain version's operations
  auto logit = [&](float g, float b, float d, int k, int zi) {
    const float r = (k == zi) ? 1.f : 0.f;
    const float lsk = (k == zi) ? log_cold(a.vg + (st[k] - 1.f)) : ls[k];
    return logit_cold(g, b - r, d - r, lsk, a.gamma, a.alpha);
  };

  if (sampler) {
    for (int c = rid; c < chunks; c += NT)
      for (int k = 4 * c; k < 4 * c + 4 && k < K; ++k) {
        st[k] = a.s[k];
        ls[k] = log_cold(a.vg + a.s[k]);
        if (NS) {
          lsp[k] = log_cold(a.vg + (a.s[k] + 1.f));
          lsm[k] = log_cold(a.vg + (a.s[k] - 1.f));
        }
      }
    if (rid < count) {
      const int sl = op[start + rid];
      ids[rid] = make_int4(sl, wp[sl] - vbase, dp[sl], zp[sl]);
    }
  }
  for (int n = tid; n < kTab; n += NT + NG) {
    tabB[n] = logf(a.gamma + (float)n);
    tabD[n] = logf(a.alpha + (float)n);
  }
  __syncthreads();

  // the ids of the next batch of NT tokens, one token a sampling thread,
  // in three steps a batch ahead of their use: the slot, then its word,
  // doc and topic, then into shared memory (seen after that barrier)
  int nslot = 0;
  int4 nid = make_int4(0, 0, 0, 0);
  auto ids_stage = [&](int j) {
    const int r = j & (NT - 1);
    const int m = (j - r) + NT + rid;
    if ((r & (NT / 4 - 1)) == 0 && r <= NT / 2 && m < count) {
      if (r == 0) {
        nslot = op[start + m];
      } else if (r == NT / 4) {
        nid = make_int4(nslot, wp[nslot] - vbase, dp[nslot], zp[nslot]);
      } else {
        ids[m & (IDS - 1)] = nid;
      }
    }
  };
  // the new topic: every sampling thread reduces the warps' bests
  auto block_best = [&](int buf) {  // (the sampling warps' slots)
    unsigned key = lane < NW ? red_key[buf][lane] : 0u;
    unsigned idx = lane < NW ? red_idx[buf][lane] : 0xFFFFFFFFu;
    warp_best(key, idx);
    return idx < (unsigned)K ? (int)idx : 0;
  };

  if constexpr (NS > 0) {
    auto slot_of = [&](int m) { return ring + (size_t)(m % NS) * 3 * Kp; };
    // token m's rows into its ring slot (this thread's chunks: a sampling
    // thread's own, or a noise thread's share); one group a token
    auto fetch = [&](int m) {
      if (m < count) {
        const int4 id = ids[m & (IDS - 1)];
        float* rb = slot_of(m);
        const float* brow = Bp + (long long)id.y * K;
        const float* drow = Dp + (long long)id.z * K;
        for (int c = rid; c < chunks; c += sampler ? NT : NG) {
          copy_chunk(rb, brow, 4 * c, K, vec);
          copy_chunk(rb + Kp, drow, 4 * c, K, vec);
          if (gp) copy_chunk(rb + 2 * Kp, gp + (long long)m * K, 4 * c, K, vec);
        }
      }
      cp_async_commit();
    };
    // a noise thread's chunks of token m's Philox Gumbel row
    auto noise = [&](int m) {
      const int slot = ids[m & (IDS - 1)].x;
      float* rg = slot_of(m) + 2 * Kp;
      for (int c = rid; c < chunks; c += NG)
        *reinterpret_cast<float4*>(rg + 4 * c) =
            philox_gumbel4(c, slot, p, a.phase, a.seed);
    };
    // my best (key, topic) of y over my chunks
    auto my_best = [&](unsigned& key, unsigned& idx) {
      key = 0u;
      idx = 0xFFFFFFFFu;
      for (int c = rid; c < chunks; c += NT) {
        const float4 x = *reinterpret_cast<const float4*>(y + 4 * c);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const unsigned kk = order_key(at(x, e));
          if (4 * c + e < K && kk > key) {
            key = kk;
            idx = 4 * c + e;
          }
        }
      }
    };
    // the logit of topic k (mine) of the token in ring slot nb, whose
    // topic is zi, from the current counts
    auto redo = [&](const float* nb, int k, int zi) {
      const bool rm = k == zi;
      bool miss = false;
      const float lsk = rm ? lsm[k] : ls[k];
      const float x = table_logit(tabB, tabD, nb[2 * Kp + k], nb[k],
                                  nb[Kp + k], rm ? 1.f : 0.f, lsk, miss);
      return miss ? logit(nb[2 * Kp + k], nb[k], nb[Kp + k], k, zi) : x;
    };
    // token m's logits into y, and my best of them.  `pending` bit b:
    // token m-2-b changed a topic I own, and token m's copies may have
    // missed it
    int last_zn = 0;
    auto prepare = [&](int m, unsigned pending, unsigned& key,
                       unsigned& idx) {
      const int4 id = ids[m & (IDS - 1)];
      float* rb = slot_of(m);
      while (pending) {                       // oldest first
        const int b = 31 - __clz(pending);
        pending &= ~(1u << b);
        const int i = m - 2 - b;
        const int4 pi = ids[i & (IDS - 1)];
        const int zn = b == 0 ? last_zn : znlog[i & (kLog - 1)];
        const float* pv = post + 4 * (i & (kLog - 1));
        if (pi.y == id.y) {
          if (own(pi.w)) rb[pi.w] = pv[0];
          if (own(zn)) rb[zn] = pv[1];
        }
        if (pi.z == id.z) {
          if (own(pi.w)) rb[Kp + pi.w] = pv[2];
          if (own(zn)) rb[Kp + zn] = pv[3];
        }
      }
      const int zi = id.w;
      const float lsr = own(zi) ? lsm[zi] : 0.f;  // logf(vg + (s~[zi] - 1))
      key = 0u;
      idx = 0xFFFFFFFFu;
      for (int c = rid; c < chunks; c += NT) {
        float4 g;
        if (NG == 0 && !gp) {
          g = philox_gumbel4(c, id.x, p, a.phase, a.seed);
          *reinterpret_cast<float4*>(rb + 2 * Kp + 4 * c) = g;
        } else {
          g = *reinterpret_cast<const float4*>(rb + 2 * Kp + 4 * c);
        }
        const float4 b = *reinterpret_cast<const float4*>(rb + 4 * c);
        const float4 d = *reinterpret_cast<const float4*>(rb + Kp + 4 * c);
        const float4 l = *reinterpret_cast<const float4*>(ls + 4 * c);
        float out[4];
        bool miss = false;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool rm = 4 * c + e == zi;
          bool m_ = false;                    // (columns past K: no miss)
          out[e] = table_logit(tabB, tabD, at(g, e), at(b, e), at(d, e),
                               rm ? 1.f : 0.f, rm ? lsr : at(l, e), m_);
          miss |= m_ && 4 * c + e < K;
        }
        if (miss) {                           // a count past the tables
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (4 * c + e < K)
              out[e] = logit(at(g, e), at(b, e), at(d, e), 4 * c + e, zi);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const unsigned kk = order_key(out[e]);
          if (4 * c + e < K && kk > key) {
            key = kk;
            idx = 4 * c + e;
          }
        }
        *reinterpret_cast<float4*>(y + 4 * c) =
            make_float4(out[0], out[1], out[2], out[3]);
      }
    };

    unsigned mine = 0;   // bit b: token j-1-b changed a topic I own
    unsigned key = 0u, idx = 0xFFFFFFFFu, nkey = 0u, nidx = 0xFFFFFFFFu;
    // With noise threads they also copy the rows: at token j, those of
    // token j+NS-2 (into token j-2's slot, free since the last barrier),
    // and they wait for token j+2's before the barrier that precedes its
    // use.  Without, each sampling thread copies its own columns NS tokens
    // ahead and waits for them itself.
    if (NG == 0) {
      for (int m = 0; m < NS; ++m) fetch(m);
    } else if (!sampler) {
      for (int m = 0; m + 2 < NS; ++m) fetch(m);
      if (!gp)
        for (int m = 0; m < 2 && m < count; ++m) noise(m);
      cp_async_wait<(NG ? NS - 4 : 0)>();
    }
    __syncthreads();
    if (sampler && count > 0) {
      if (NG == 0) cp_async_wait<NS - 1>();
      prepare(0, 0u, key, idx);
    }
    STAMP(7);
    for (int j = 0; j < count; ++j) {
      if (sampler) {
        warp_best(key, idx);
        if (lane == 0) {
          red_key[j & 1][rid >> 5] = key;
          red_idx[j & 1][rid >> 5] = idx;
        }
        STAMP(0);
        ids_stage(j);
        STAMP(1);
        if (j + 1 < count) {
          if (NG == 0) cp_async_wait<NS - 2>();
          STAMP(2);
          prepare(j + 1, mine & ((1u << NS) - 1), nkey, nidx);
        }
      } else {
        fetch(j + NS - 2);
        if (!gp && j + 2 < count) noise(j + 2);
        cp_async_wait<(NG ? NS - 4 : 0)>();
      }
      STAMP(3);
      __syncthreads();
      if (!sampler) {
        STAMP(4);
      } else {
        const int4 id = ids[j & (IDS - 1)];
        const int zn = block_best(j & 1);
        STAMP(4);
        const int zi = id.w;
        bool changed = false;
        if (zn != zi) {
          const bool oi = own(zi), on = own(zn);
          if (oi || on) {
            changed = true;
            const float* rb = slot_of(j);
            float* pv = post + 4 * (j & (kLog - 1));
            if (oi) {
              pv[0] = rb[zi] - 1.f;
              pv[2] = rb[Kp + zi] - 1.f;
              Bp[(long long)id.y * K + zi] = pv[0];
              Dp[(long long)id.z * K + zi] = pv[2];
              st[zi] -= 1.f;               // the logs shift down a count
              lsp[zi] = ls[zi];
              ls[zi] = lsm[zi];
              lsm[zi] = logf(a.vg + (st[zi] - 1.f));
            }
            if (on) {
              pv[1] = rb[zn] + 1.f;
              pv[3] = rb[Kp + zn] + 1.f;
              Bp[(long long)id.y * K + zn] = pv[1];
              Dp[(long long)id.z * K + zn] = pv[3];
              st[zn] += 1.f;               // and up
              lsm[zn] = ls[zn];
              ls[zn] = lsp[zn];
              lsp[zn] = logf(a.vg + (st[zn] + 1.f));
            }
            if (j + 1 < count) {  // token j+1: patch its rows, redo 2 logits
              const int4 nx = ids[(j + 1) & (IDS - 1)];
              float* nb = slot_of(j + 1);
              if (nx.y == id.y) {
                if (oi) nb[zi] = pv[0];
                if (on) nb[zn] = pv[1];
              }
              if (nx.z == id.z) {
                if (oi) nb[Kp + zi] = pv[2];
                if (on) nb[Kp + zn] = pv[3];
              }
              // my best of token j+1 moves only if a redone entry was it
              bool rescan = false;
              if (oi) {
                y[zi] = redo(nb, zi, nx.w);
                rescan |= (unsigned)zi == nidx;
              }
              if (on) {
                y[zn] = redo(nb, zn, nx.w);
                rescan |= (unsigned)zn == nidx;
              }
              if (rescan) {
                my_best(nkey, nidx);
              } else {
                for (int t = 0; t < 2; ++t) {
                  const int k = t ? zn : zi;
                  const unsigned kk = order_key(y[k]);
                  if ((t ? on : oi) &&
                      (kk > nkey || (kk == nkey && (unsigned)k < nidx))) {
                    nkey = kk;
                    nidx = k;
                  }
                }
              }
            }
          }
          if (tid == 0) zp[id.x] = zn;
        }
        if (tid == 0) znlog[j & (kLog - 1)] = zn;
        mine = (mine << 1) | (changed ? 1u : 0u);
        last_zn = zn;
        STAMP(5);
        if (NG == 0) fetch(j + NS);
        key = nkey;
        idx = nidx;
        STAMP(6);
      }
    }
    cp_async_wait<0>();
  } else {
    STAMP(7);
    for (int j = 0; j < count; ++j) {
      const int4 id = ids[j & (IDS - 1)];
      const int zi = id.w;
      const float* brow = Bp + (long long)id.y * K;
      const float* drow = Dp + (long long)id.z * K;
      const float* grow = gp ? gp + (long long)j * K : nullptr;
      unsigned key = 0u, idx = 0xFFFFFFFFu;
      float bz = 0.f, dz = 0.f, bn = 0.f, dn = 0.f;  // counts at zi, my best
      for (int c = rid; c < chunks; c += NT) {
        float4 g;
        if (grow) {
          g = make_float4(grow[4 * c], 4 * c + 1 < K ? grow[4 * c + 1] : 0.f,
                          4 * c + 2 < K ? grow[4 * c + 2] : 0.f,
                          4 * c + 3 < K ? grow[4 * c + 3] : 0.f);
        } else {
          g = philox_gumbel4(c, id.x, p, a.phase, a.seed);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int k = 4 * c + e;
          if (k < K) {
            const float b = brow[k], d = drow[k];
            const unsigned kk = order_key(logit(at(g, e), b, d, k, zi));
            if (k == zi) {
              bz = b;
              dz = d;
            }
            if (kk > key) {
              key = kk;
              idx = k;
              bn = b;
              dn = d;
            }
          }
        }
      }
      warp_best(key, idx);
      if (lane == 0) {
        red_key[j & 1][rid >> 5] = key;
        red_idx[j & 1][rid >> 5] = idx;
      }
      STAMP(0);
      ids_stage(j);
      STAMP(1);
      __syncthreads();
      const int zn = block_best(j & 1);
      STAMP(4);
      if (zn != zi) {
        if (own(zi)) {
          Bp[(long long)id.y * K + zi] = bz - 1.f;
          Dp[(long long)id.z * K + zi] = dz - 1.f;
          st[zi] -= 1.f;
          ls[zi] = logf(a.vg + st[zi]);
        }
        if (own(zn)) {   // zn is my best: bn, dn are its counts
          Bp[(long long)id.y * K + zn] = bn + 1.f;
          Dp[(long long)id.z * K + zn] = dn + 1.f;
          st[zn] += 1.f;
          ls[zn] = logf(a.vg + st[zn]);
        }
        if (tid == 0) zp[id.x] = zn;
      }
      STAMP(5);
    }
  }
  if (sampler)
    for (int c = rid; c < chunks; c += NT)
      for (int k = 4 * c; k < 4 * c + 4 && k < K; ++k)
        a.s_tilde[(long long)p * K + k] = st[k];
  STAMP_END(NT);
}

template <int NT, int NS, int NG>
int launch(const Args& a, int P, cudaStream_t stream) {
  const size_t smem = smem_bytes(a.K, NT, NS);
  static size_t smem_set = 48 * 1024;  // above 48 KB only once raised
  if (smem > smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        lda_gibbs_kernel<NT, NS, NG>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    smem_set = smem;
  }
  lda_gibbs_kernel<NT, NS, NG><<<P, NT + NG, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// the built variants (block threads, ring depth, sampling threads, noise
// threads).  The port launches the deepest ring of kDepths that fits, at
// 512 threads (256 sampling, 256 noise; 256 sampling alone below 4
// slots), or the ring-less variant at 256.
#ifdef LDA_GIBBS_DESIGNS
#define LDA_VARIANTS(X)                                                   \
  X(256, 0, 256, 0) X(256, 2, 256, 0) X(512, 4, 256, 256)                 \
  X(512, 6, 256, 256) X(512, 8, 256, 256) X(512, 10, 256, 256)            \
  X(384, 6, 128, 256) X(256, 6, 256, 0) X(1024, 6, 512, 512)
#else
#define LDA_VARIANTS(X)                                                   \
  X(256, 0, 256, 0) X(256, 2, 256, 0) X(512, 4, 256, 256)                 \
  X(512, 6, 256, 256)
#endif
constexpr int kDepths[] = {6, 4, 2};

}  // namespace

extern "C" {

// bytes of dynamic shared memory a block of the variant takes, or -1 if
// the variant is not built; threads 0 is the port's choice for the depth
long long lda_gibbs_smem_bytes(int K, int threads, int depth) {
  if (threads == 0) threads = depth >= 4 ? 512 : 256;
#define LDA_SMEM(bt, ns, nt, ng) \
  if (threads == bt && depth == ns) return (long long)smem_bytes(K, nt, ns);
  LDA_VARIANTS(LDA_SMEM)
#undef LDA_SMEM
  return -1;
}

// the ring depth the port launches at K topics on the current card: the
// deepest of kDepths whose block fits its shared memory, else 0
int lda_gibbs_depth(int K) {
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  for (int d : kDepths)
    if (lda_gibbs_smem_bytes(K, 0, d) <= (long long)optin - 1024) return d;
  return 0;
}

int lda_gibbs_launch(const int* words, const int* docs, int* z,
                     const int* order, const int* offsets, float* B, float* D,
                     const float* s, float* s_tilde, const float* gumbel, int P,
                     int T, int K, int n_blocks, int rotate, int block_vocab,
                     long long slab_floats, int dpw, int phase, int L, float vg,
                     float alpha, float gamma, unsigned long long seed,
                     int threads, int depth, void* stream) {
  const uintptr_t bases = reinterpret_cast<uintptr_t>(B) |
                          reinterpret_cast<uintptr_t>(D) |
                          reinterpret_cast<uintptr_t>(gumbel);
  const int vec = K % 4 == 0 && bases % 16 == 0;
  const Args a{words, docs,  z,     order, offsets,     B,           D,
               s,     s_tilde, gumbel, T,  K,           n_blocks,    rotate,
               block_vocab, slab_floats, dpw, phase, L, vec, vg, alpha, gamma,
               seed};
  if (threads == 0) threads = depth >= 4 ? 512 : 256;
#define LDA_LAUNCH(bt, ns, nt, ng)  \
  if (threads == bt && depth == ns) \
    return launch<nt, ns, ng>(a, P, (cudaStream_t)stream);
  LDA_VARIANTS(LDA_LAUNCH)
#undef LDA_LAUNCH
  return (int)cudaErrorInvalidValue;
}

const char* lda_gibbs_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

#ifdef LDA_GIBBS_STAMPS
int lda_gibbs_stamps(unsigned long long* out, int n) {
  return (int)cudaMemcpyFromSymbol(out, lda_stamps,
                                   n * sizeof(unsigned long long));
}
#endif

}  // extern "C"
