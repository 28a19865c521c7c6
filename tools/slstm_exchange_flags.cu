// The exchange of the sLSTM forward's h_t alone, by per-block release
// flags: the design that src/repro_torch/kernels/csrc/slstm_scan.cu did
// not keep, timed beside its tagged words by tools/slstm_stamps.py.
//
// The forward's grid (u units a block, one block an SM, 256 threads)
// runs S - 1 exchanges of B x d floats and nothing else.  At exchange e a
// block writes its B x u values into slot e & 1 of a two-slot buffer,
// meets its own threads at bar.sync, and one thread publishes e in the
// block's flag with st.release.gpu.  A reader's first `blocks` threads
// each spin on one flag with ld.acquire.gpu until it reads e, the block
// meets at bar.sync, and then every thread loads its share of the B x d
// values (ld.relaxed.gpu) into shared memory: two dependent L2 round
// trips, where the tagged words take one.  A spin over 10 s traps.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr unsigned long long kSpinNs = 10ull * 1000 * 1000 * 1000;

__device__ __forceinline__ unsigned long long globaltimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(unsigned* p, unsigned v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;"
               :: "l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ float ld_relaxed(const float* p) {
  float v;
  asm volatile("ld.relaxed.gpu.global.f32 %0, [%1];"
               : "=f"(v) : "l"(p) : "memory");
  return v;
}

__global__ void __launch_bounds__(kThreads, 1)
slstm_exchange_flags(float* buf, unsigned* flags, int B, int S, int d,
                     int u) {
  extern __shared__ float h_s[];                   // [B][d]
  const int j0 = blockIdx.x * u, nu = min(u, d - j0);
  for (int e = 1; e < S; ++e) {
    float* slot = buf + (size_t)(e & 1) * B * d;
    for (int i = threadIdx.x; i < B * u; i += kThreads) {
      const int b = i / u, jj = i - b * u;
      if (jj < nu) slot[(size_t)b * d + j0 + jj] = h_s[b * d + j0 + jj] + 1.f;
    }
    __syncthreads();
    if (threadIdx.x == 0) st_release(flags + blockIdx.x, (unsigned)e);
    if (threadIdx.x < gridDim.x) {
      const unsigned long long t0 = globaltimer();
      while (ld_acquire(flags + threadIdx.x) < (unsigned)e)
        if (globaltimer() - t0 > kSpinNs) __trap();
    }
    __syncthreads();
    for (int i = threadIdx.x; i < B * d; i += kThreads)
      h_s[i] = ld_relaxed(slot + i);
    __syncthreads();
  }
}

}  // namespace

extern "C" {

// S - 1 flag exchanges of (B, d) on `blocks` blocks of u units (the
// forward's grid); buf holds 2 B d floats, flags `blocks` unsigneds,
// both zeroed here first.
int slstm_exchange_flags_launch(void* buf, void* flags, int B, int S, int d,
                                int u, int blocks, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = sizeof(float) * B * d;
  cudaError_t e = cudaFuncSetAttribute(
      slstm_exchange_flags, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (!e) e = cudaMemsetAsync(flags, 0, sizeof(unsigned) * blocks, st);
  if (!e) e = cudaMemsetAsync(buf, 0, 2 * smem, st);
  if (e) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, slstm_exchange_flags, (float*)buf,
                         (unsigned*)flags, B, S, d, u);
  return e ? e : cudaGetLastError();
}

}  // extern "C"
