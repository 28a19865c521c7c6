#!/usr/bin/env python3
"""Where the time of ``gram_block``'s kernel goes, on one card.

    python3 tools/gram_block_designs.py

Builds ``gram_fused`` (``src/repro_torch/kernels/csrc/lasso_cd.cu``)
with per-block ``%globaltimer`` stamps added (start; main loop done;
before and after each cluster barrier; the cluster sum written; the last
cluster's sum done), and variants of it that are wrong on purpose, kept
only to measure what bounds the kernel:

* ``stamped``: the kernel as it is, with the stamps;
* ``noload``: the main loop issues no copies after the first two stages
  (it computes on stale shared memory): the FMA loop alone;
* ``lds8``: the main loop reads one row of shared memory for every 8 it
  multiplies: 8-fold fewer shared loads for the same FMAs.

Each runs at the Lasso round's shapes, (4, 12,500, 128) and (1, 50,000,
128), under the port's launch plan (``kernels/lasso_cd.py::_gram_plan``)
and the other cluster size.  Printed: the blocks the card holds at once
in clusters of 4 (``gram_block_slots``), the device time (calls captured
in a CUDA graph, ``chip_smoke.py::graph_ms``), the error against the
plain version, and the median of each phase over the blocks; then the
instruction mix of the port's kernel's loops (``cuobjdump -sass``) and
the SM clock and power (``nvidia-smi``) while the port's kernel runs for
4 s.  Prints the card's name and power limit first.  Needs a card and
nvcc.
"""
from __future__ import annotations

import collections
import ctypes
import os
import re
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STAMPS = 9                     # globaltimer words a block writes

PRELUDE = r"""
__device__ unsigned long long g_stamp[1 << 16];
__device__ __forceinline__ unsigned long long gtime() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %globaltimer;" : "=l"(t));
  return t;
}
"""
SLOT = "((blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x) * 9"
# (text in the kernel, text it becomes): the stamps
STAMPED = [
    ("  cg::cluster_group cluster = cg::this_cluster();\n  const int C",
     "  const unsigned long long t0 = gtime();\n"
     "  cg::cluster_group cluster = cg::this_cluster();\n  const int C"),
    ("  __syncthreads();                     // the ring is free",
     "  __syncthreads();                     // the ring is free\n"
     "  const unsigned long long t1 = gtime();"),
    ("  cluster.sync();                      // every block's ring is free",
     "  const unsigned long long t2 = gtime();\n  cluster.sync();\n"
     "  const unsigned long long t3 = gtime();"),
    ("  cluster.sync();                      // every piece has arrived",
     "  const unsigned long long t4 = gtime();\n  cluster.sync();\n"
     "  const unsigned long long t5 = gtime();"),
    ("\n  // the last cluster of (w, job) to finish piece",
     f"\n  if (threadIdx.x == 0) {{ const unsigned long long s_[8] = "
     f"{{t0, t1, t2, t3, t4, t5, gtime(), 0ull}};\n"
     f"    for (int k = 0; k < 8; ++k) g_stamp[{SLOT} + k] = s_[k]; }}\n"
     f"  // the last cluster of (w, job) to finish piece"),
    ("  if (tid == 0) *tk = 0;\n}",
     f"  if (tid == 0) {{ *tk = 0; g_stamp[{SLOT} + 7] = gtime(); }}\n}}"),
]
VARIANTS = {
    "stamped": [],
    "noload": [("    if (nc < chunks) {\n      float* d = sm + (nc % kGramStages)",
                "    if (false) {\n      float* d = sm + (nc % kGramStages)")],
    "lds8": [("    const int k = (k0 + kk * STEP) * kPanel;",
              "    const int k = k0 * kPanel;")],
}
EPILOGUE = r"""
extern "C" int gram_stamps(unsigned long long* out, int n) {
  return (int)cudaMemcpyFromSymbol(out, g_stamp, n * 8);
}
"""
PHASES = (("main loop", 0, 1), ("light sums", 1, 2), ("cluster barrier 1", 2, 3),
          ("push", 3, 4), ("cluster barrier 2", 4, 5), ("cluster sum", 5, 6))


def build(name: str, subs, out, _build) -> ctypes.CDLL:
    src = (_build.CSRC / "lasso_cd.cu").read_text()
    src = src.replace("namespace cg = cooperative_groups;",
                      "namespace cg = cooperative_groups;\n" + PRELUDE)
    for a, b in STAMPED + subs:
        if a not in src:
            raise SystemExit(f"{name}: the kernel no longer has {a!r}")
        src = src.replace(a, b)
    cu, so = out / f"gram_{name}.cu", out / f"libgram_{name}.so"
    cu.write_text(src + EPILOGUE)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so),
                    str(cu)], check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(so))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.gram_block_launch.argtypes = [p, p, p, p, i, i, i, i, i, p]
    lib.gram_block_slots.argtypes = [p]
    lib.gram_stamps.argtypes = [p, i]
    return lib


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("needs an NVIDIA card", file=sys.stderr)
        return 2
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    import chip_smoke as cs
    from repro_torch.kernels import _build, lasso_cd, ref
    torch.backends.cuda.matmul.allow_tf32 = False

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip())
    out = _build.build_dir()
    out.mkdir(parents=True, exist_ok=True)
    libs = {name: build(name, subs, out, _build)
            for name, subs in VARIANTS.items()}
    slots = ctypes.c_int(0)
    libs["stamped"].gram_block_slots(ctypes.byref(slots))
    print(f"blocks held at once in clusters of 4: {slots.value} "
          f"(SMs: {torch.cuda.get_device_properties(0).multi_processor_count})")

    gen = torch.Generator(device="cuda").manual_seed(0)
    work = torch.zeros(1 << 22, device="cuda")
    tickets = torch.zeros(4096, dtype=torch.int32, device="cuda")
    for W, n, U in ((4, 12500, 128), (1, 50000, 128)):
        X = torch.randn((W, n, U), generator=gen, device="cuda")
        want = ref.gram_ref(X)
        C0, S0, _, _ = lasso_cd._gram_plan(W, n, U, slots.value)
        C1 = 12 - C0                                # the other size
        per = max(1, slots.value // (C1 * W))
        for name, lib in libs.items():
            for C, S in ((C0, S0), (C1, C1 * per)):
                G = torch.empty((W, U, U), device="cuda")

                def call():
                    err = lib.gram_block_launch(
                        X.data_ptr(), work.data_ptr(), tickets.data_ptr(),
                        G.data_ptr(), W, n, U, S, C,
                        torch.cuda.current_stream().cuda_stream)
                    if err:
                        raise RuntimeError(f"launch failed: {err}")
                call()
                torch.cuda.synchronize()
                err = (G - want).abs().max().item()
                device_ms = cs.graph_ms(torch, call)
                call()
                torch.cuda.synchronize()
                blocks = W * S
                buf = (ctypes.c_ulonglong * (blocks * STAMPS))()
                lib.gram_stamps(buf, blocks * STAMPS)
                st = [buf[b * STAMPS:(b + 1) * STAMPS] for b in range(blocks)]

                def med(v):
                    return sorted(v)[len(v) // 2]
                rows = -(-n // S)
                phases = {k: med([(s[j] - s[i]) / 1e3 for s in st])
                          for k, i, j in PHASES}
                last = [(s[7] - s[6]) / 1e3 for s in st if s[7] > s[6]]
                t0 = min(s[0] for s in st)
                print(f"{name:8s} W={W} n={n} U={U} C={C} S={S} "
                      f"({'plan' if (C, S) == (C0, S0) else 'other'}): "
                      f"device {device_ms:.5f} ms, max abs err {err:.3g}; "
                      f"latest start {max(s[0] - t0 for s in st) / 1e3:.2f} us; "
                      f"main loop {phases['main loop'] / -(-rows // 32):.3f} "
                      f"us a 32-row stage; median us: " + ", ".join(
                          f"{k} {v:.2f}" for k, v in phases.items())
                      + f", last cluster's sum {med(last) if last else 0:.2f}")
    loops(_build)
    clocks(torch, lasso_cd)
    return 0


def loops(_build) -> None:
    """Opcode counts of each loop (a backward branch) of gram_fused."""
    _build.build(["lasso_cd"])
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", _build.build_log["lasso_cd"]["path"]],
                          capture_output=True, text=True).stdout
    m = re.search(r"Function : \S*gram_fused\S*\n(.*?)(?=\n\s+Function : |\Z)",
                  sass, re.S)
    if not m:
        print("gram_fused not found in the SASS")
        return
    ins = re.findall(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][\w.]*)([^;]*);",
                     m.group(1))
    for k, (addr, op, rest) in enumerate(ins):
        b = re.search(r"0x([0-9a-f]+)", rest) if op == "BRA" else None
        if b and int(b.group(1), 16) < int(addr, 16):
            body = [o for a, o, _ in ins
                    if int(b.group(1), 16) <= int(a, 16) <= int(addr, 16)]
            if "FFMA" in body:
                print(f"loop at 0x{int(b.group(1), 16):x}: {len(body)} "
                      f"instructions, " + ", ".join(
                          f"{o} {c}" for o, c in
                          collections.Counter(body).most_common(6)))


def clocks(torch, lasso_cd) -> None:
    """nvidia-smi's SM clock and power every 250 ms while graphs of 200
    gram_block calls replay for 4 s."""
    X = torch.randn((4, 12500, 128), device="cuda")
    lasso_cd.gram_block(X)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(200):
            lasso_cd.gram_block(X)
    smi = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                            "--format=csv,noheader", "-lms", "250"],
                           stdout=subprocess.PIPE, text=True)
    t0 = time.time()
    while time.time() - t0 < 4:
        g.replay()
    torch.cuda.synchronize()
    smi.terminate()
    samples = smi.communicate()[0].strip().splitlines()
    print("SM clock, power under load: " + "; ".join(samples[2:-1]))


if __name__ == "__main__":
    sys.exit(main())
