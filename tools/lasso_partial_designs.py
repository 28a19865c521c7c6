#!/usr/bin/env python3
"""Device times of two one-launch designs of ``lasso_partial`` on one card.

    python3 tools/lasso_partial_designs.py [--seed 0]

* ``ticket``: the port's kernel (``src/repro_torch/kernels/csrc/
  lasso_cd.cu``): one block a row tile, the last block of a worker to
  finish sums the worker's partials (a per-worker counter).
* ``cluster``: the alternative, kept here only to measure it: one thread
  block cluster of 16 blocks a worker, each block summing a contiguous
  sixteenth of the rows, block 0 summing the 16 partials through
  distributed shared memory in rank order.

Both are held against the plain version, then timed eager (CUDA events
over back-to-back calls) and on the device alone (calls captured in a
CUDA graph and replayed), beside ``torch.matmul``, at W = 4 (n = 12,500)
and W = 1 (n = 50,000), U = 32: the Lasso round's shapes.  Prints the
card's name and power limit first.  Needs a card and nvcc.
"""
from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CLUSTER_CU = r"""
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cstdint>
namespace cg = cooperative_groups;
constexpr int kThreads = 256, kWarps = kThreads / 32, kUnroll = 8;

// rows [row0, row1) of one worker, U % 4 == 0 and X 16-byte aligned
__global__ void __launch_bounds__(kThreads)
lasso_partial_cluster(const float* __restrict__ X, const float* __restrict__ r,
                      float* __restrict__ z, int n, int U) {
  cg::cluster_group cl = cg::this_cluster();
  const int CS = cl.num_blocks(), rank = cl.block_rank(), w = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int G = U / 4;
  int CW = 1;
  while (CW < G && CW < 32) CW <<= 1;
  const int RPW = 32 / CW, rstep = kWarps * RPW;
  const int chunk = (n + CS - 1) / CS;
  const int row0 = min(n, rank * chunk), row1 = min(n, row0 + chunk);
  const float* Xw = X + (size_t)w * n * U;
  const float* rw = r + (size_t)w * n;
  __shared__ float red[kWarps][128];
  __shared__ float part[128];
  for (int g0 = 0; g0 < G; g0 += CW) {
    const int g = g0 + (lane & (CW - 1));
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    if (g < G) {
      for (int row = row0 + warp * RPW + lane / CW; row < row1;
           row += kUnroll * rstep) {
        float4 xv[kUnroll];
        float rv[kUnroll];
#pragma unroll
        for (int k = 0; k < kUnroll; ++k) {
          const int i = row + k * rstep;
          xv[k] = i < row1 ? __ldg(reinterpret_cast<const float4*>(
                                 Xw + (size_t)i * U + 4 * g))
                           : make_float4(0.f, 0.f, 0.f, 0.f);
          rv[k] = i < row1 ? __ldg(rw + i) : 0.f;
        }
#pragma unroll
        for (int k = 0; k < kUnroll; ++k) {
          acc.x = fmaf(xv[k].x, rv[k], acc.x);
          acc.y = fmaf(xv[k].y, rv[k], acc.y);
          acc.z = fmaf(xv[k].z, rv[k], acc.z);
          acc.w = fmaf(xv[k].w, rv[k], acc.w);
        }
      }
    }
    float a[4] = {acc.x, acc.y, acc.z, acc.w};
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      for (int off = CW; off < 32; off <<= 1)
        a[v] += __shfl_xor_sync(0xffffffffu, a[v], off);
      if (lane < CW) red[warp][lane * 4 + v] = a[v];
    }
    __syncthreads();
    for (int c = threadIdx.x; c < CW * 4 && g0 * 4 + c < U; c += kThreads) {
      float s = 0.f;
      for (int k = 0; k < kWarps; ++k) s += red[k][c];
      part[g0 * 4 + c] = s;
    }
    __syncthreads();
  }
  cl.sync();
  if (rank == 0)
    for (int u = threadIdx.x; u < U; u += kThreads) {
      float s = 0.f;
      for (int q = 0; q < CS; ++q) s += cl.map_shared_rank(part, q)[u];
      z[(size_t)w * U + u] = s;
    }
  cl.sync();
}

extern "C" int lasso_partial_cluster_launch(const float* X, const float* r,
                                            float* z, int W, int n, int U,
                                            cudaStream_t stream) {
  constexpr int CS = 16;
  if (U % 4 || U > 128 || (reinterpret_cast<uintptr_t>(X) & 15u))
    return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      lasso_partial_cluster,
      cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(CS, 1, W);
  cfg.blockDim = dim3(kThreads);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CS;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, lasso_partial_cluster, X, r, z, n, U);
  return e ? e : cudaGetLastError();
}
"""


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("needs an NVIDIA card", file=sys.stderr)
        return 2
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    import chip_smoke as cs
    from repro_torch.kernels import _build, lasso_cd, ref

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip())
    out = _build.build_dir()
    out.mkdir(parents=True, exist_ok=True)
    src, lib = out / "lasso_partial_cluster.cu", out / "liblasso_cluster.so"
    src.write_text(CLUSTER_CU)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
                    str(src)], check=True, capture_output=True, text=True)
    clib = ctypes.CDLL(str(lib))
    p, i = ctypes.c_void_p, ctypes.c_int
    clib.lasso_partial_cluster_launch.argtypes = [p, p, p, i, i, i, p]
    clib.lasso_partial_cluster_launch.restype = i

    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    for W, n in ((4, 12500), (1, 50000)):
        U = 32
        X = torch.randn((W, n, U), generator=gen, device="cuda")
        r = torch.randn((W, n), generator=gen, device="cuda")
        want = ref.lasso_partial_ref(X, r)

        def cluster():
            z = torch.empty((W, U), device="cuda")
            err = clib.lasso_partial_cluster_launch(
                X.data_ptr(), r.data_ptr(), z.data_ptr(), W, n, U,
                torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"cluster launch failed: {err}")
            return z
        designs = {"ticket": lambda: lasso_cd.lasso_partial(X, r),
                   "cluster": cluster,
                   "matmul": lambda: torch.matmul(X.mT, r.unsqueeze(-1))}
        for name, fn in designs.items():
            got = fn().reshape(W, U)
            err = (got - want).abs().max().item()
            tol = cs.KERNEL_TOL * max(1.0, want.abs().max().item())
            if err > tol:
                raise SystemExit(f"{name} at W={W}: error {err} > {tol}")
            print(f"W={W} n={n} U={U} {name:8s} eager "
                  f"{cs.time_ms(torch, fn):.5f} ms, device "
                  f"{cs.graph_ms(torch, fn):.5f} ms, then "
                  f"{cs.graph_ms(torch, fn):.5f} ms; max abs err {err:.2e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
