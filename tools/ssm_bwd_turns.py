#!/usr/bin/env python3
"""The selective scan's backward on one card: the port's ``ssm_scan_bwd``
against another build of ``csrc/ssm_scan.cu``, in turns in one process.

    python3 tools/ssm_bwd_turns.py [--other PATH] [--seed 0]

* ``port``: ``repro_torch.kernels.ssm_scan.ssm_scan_bwd`` (the backward
  kernel and ``ssm_scan_bwd_sum``) on the states its own forward saved.
* ``other`` (with ``--other``): a ``ssm_scan.cu`` of another design, such
  as the parent commit's unpacked under the git-ignored ``build/``,
  compiled here with the port's nvcc flags and called through its own C
  entry points, its forward saving its own states.  A design not kept is
  timed again from a saved copy of its source.  Nothing of the port
  reaches it.

At Zamba2-2.7B's training call (x, dt (4, 2000, 5120) bf16, B, C (4,
2000, 64), no h0, no final-state gradient) both are held against the f32
plain version (``kernels/ref.py::ssm_scan_bwd_ref``: 1e-3 of each
output's largest plus the output's own bf16 rounding, 2^-8 of the
element), each run twice for equal bits, and the two compared bit for
bit; then timed as device ms (5 calls in a CUDA graph, replayed 4 times)
in the order other, port, port, other.  The port's resident blocks an SM
and shared memory a block come from the occupancy API
(``ssm_scan_bwd_occupancy``), its registers and spills from ptxas; each
build's forward, saving its states, is timed in the same turns (a
design that saves more states pays there).
Prints the card's name and power limit first and one JSON line last.
Needs a card and nvcc.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PEAK_F32_FLOPS = 67e12
FLOPS = 14                    # a (b, t, c, n): the bound's count (ssm_scan.cu)
TOL = 1e-3
SHAPE = (4, 2000, 5120, 64)   # B, S, C, N: Zamba2-2.7B's training call


def graph_ms(torch, fn, calls: int = 5, replays: int = 4) -> float:
    """Device ms of one call: ``calls`` calls in a CUDA graph (after a
    warm-up call on the capture stream), replayed ``replays`` times
    between CUDA events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g, stream=side):
        for _ in range(calls):
            fn()
    g.replay()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(replays):
        g.replay()
    b.record()
    torch.cuda.synchronize()
    del g
    return a.elapsed_time(b) / (calls * replays)


def pick(log: str) -> dict:
    """ptxas's registers and spill stores of each ssm_scan_bwd
    instantiation in an ``nvcc -Xptxas -v`` report, by mangled name."""
    out, name = {}, None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            name = ln.split("'")[1] if "ssm_scan_bwd" in ln else None
            name = name and name[name.index("ssm_scan_bwd"):][:40]
        elif name and "spill stores" in ln:
            out[name] = ln.strip()
        elif name and "Used" in ln:
            out[name] += "; " + ln.split(":", 1)[1].strip()
    return out


def build_other(path: str, nvcc_flags) -> ctypes.CDLL:
    out = os.path.join(ROOT, "build", "ssm_bwd_other")
    os.makedirs(out, exist_ok=True)
    lib = os.path.join(out, f"libssm_scan_other_{os.getpid()}.so")
    proc = subprocess.run(["/usr/local/cuda/bin/nvcc", *nvcc_flags, "-o",
                           lib, path], capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on {path}:\n{proc.stdout}"
                           f"{proc.stderr}")
    dll = ctypes.CDLL(lib)
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    dll.ssm_scan_launch.argtypes = [p] * 9 + [i] * 5 + [p, p]
    dll.ssm_scan_launch.restype = i
    dll.ssm_scan_bwd_launch.argtypes = [p] * 16 + [i] * 5 + [p, p]
    dll.ssm_scan_bwd_launch.restype = i
    for fn in (dll.ssm_scan_state_floats, dll.ssm_scan_bwd_work_floats):
        fn.argtypes = [i, i, i, i]
        fn.restype = ll
    dll.ptxas = proc.stdout + proc.stderr
    return dll


def other_bwd(torch, dll, x, dt, A, Bm, Cm, dy):
    """The other build's forward (saving its states) and backward, no h0
    and no final-state gradient: returns (a closure that runs the
    forward again, one that runs the backward into the same outputs and
    returns (dx, ddt, dA, dB, dC), the saved states' bytes)."""
    Bsz, S, C = x.shape
    N = Bm.shape[-1]
    dev = x.device
    stream = lambda: torch.cuda.current_stream().cuda_stream
    st10 = (ctypes.c_longlong * 10)(*(s for t in (x, dt, Bm, Cm, x)
                                      for s in t.stride()[:2]))
    states = torch.empty(dll.ssm_scan_state_floats(Bsz, S, C, N),
                         dtype=torch.float32, device=dev)
    y = torch.empty_like(x)
    h = torch.empty((Bsz, C, N), dtype=torch.float32, device=dev)

    def fwd():
        e = dll.ssm_scan_launch(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
            Cm.data_ptr(), None, y.data_ptr(), h.data_ptr(),
            states.data_ptr(), 1, Bsz, S, C, N, st10, stream())
        if e:
            raise RuntimeError(f"the other build's forward: CUDA error {e}")
    fwd()
    dx, ddt = torch.empty_like(x), torch.empty_like(x)
    dB, dC = torch.empty_like(Bm), torch.empty_like(Cm)
    dA = torch.empty((C,), dtype=torch.float32, device=dev)
    work = torch.empty(dll.ssm_scan_bwd_work_floats(Bsz, S, C, N),
                       dtype=torch.float32, device=dev)
    st12 = (ctypes.c_longlong * 12)(*(s for t in (x, dt, Bm, Cm, dy, dx)
                                      for s in t.stride()[:2]))

    def run():
        e = dll.ssm_scan_bwd_launch(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
            Cm.data_ptr(), None, states.data_ptr(), dy.data_ptr(), None,
            dx.data_ptr(), ddt.data_ptr(), dA.data_ptr(), dB.data_ptr(),
            dC.data_ptr(), None, work.data_ptr(), 1, Bsz, S, C, N, st12,
            stream())
        if e:
            raise RuntimeError(f"the other build's backward: CUDA error {e}")
        return dx, ddt, dA, dB, dC
    return fwd, run, states.numel() * 4


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--other", help="another ssm_scan.cu")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("ssm_bwd_turns: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels import ssm_scan as tss
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()[0]
    print(smi)
    _build.build(["ssm_scan"])
    dll = (build_other(os.path.abspath(args.other), _build.NVCC_FLAGS)
           if args.other else None)
    B, S, C, N = SHAPE
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    rnd = lambda *s: torch.randn(s, generator=gen, device="cuda")
    x = rnd(B, S, C).bfloat16()
    dt = torch.nn.functional.softplus(rnd(B, S, C) - 1.0).bfloat16()
    A = -torch.exp(rnd(C))
    Bm, Cm = rnd(B, S, N).bfloat16(), rnd(B, S, N).bfloat16()
    dy = rnd(B, S, C).bfloat16()
    _, _, states = tss.ssm_scan(x, dt, A, Bm, Cm, save_states=True)
    runs = {"port": lambda: tss.ssm_scan_bwd(x, dt, A, Bm, Cm, None,
                                             states, dy)[:5]}
    fwds = {"port": lambda: tss.ssm_scan(x, dt, A, Bm, Cm,
                                         save_states=True)}
    state_bytes = {"port": states.numel() * 4}
    if dll is not None:
        fwds["other"], runs["other"], state_bytes["other"] = other_bwd(
            torch, dll, x, dt, A, Bm, Cm, dy)
    want = ref.ssm_scan_bwd_ref(x.float(), dt.float(), A, Bm.float(),
                                Cm.float(), None, dy.float())[:5]
    names = ("dx", "ddt", "dA", "dB", "dC")
    blocks, smem = tss.ssm_scan_bwd_occupancy(torch.bfloat16, N)
    row = {"card": smi, "other": args.other, "shape": [B, S, C, N],
           "dtype": "bfloat16", "port_blocks_per_sm": blocks,
           "port_smem_bytes": smem}
    got = {}
    for name, fn in runs.items():
        a = [t.clone() for t in fn()]
        b = fn()
        torch.cuda.synchronize()
        row[f"{name}_same_bits"] = all(torch.equal(u, v)
                                       for u, v in zip(a, b))
        worst = 0.0
        for n, u, w in zip(names, a, want):
            w = w.float()
            lim = TOL * w.abs().max().item() + (
                2.0 ** -8 * w.abs() if u.dtype == torch.bfloat16 else 0.0)
            over = ((u.float() - w).abs() / lim).max().item()
            row[f"{name}_{n}_err_over_limit"] = over
            worst = max(worst, over)
        row[f"{name}_worst_err_over_limit"] = worst
        got[name] = a
    del want
    if dll is not None:
        row["port_equals_other_bits"] = {
            n: torch.equal(u, v) for n, u, v in zip(names, got["port"],
                                                    got["other"])}
    del got
    order = ["other", "port", "port", "other"] if dll else ["port"] * 2
    row["turns"] = [(n, graph_ms(torch, runs[n])) for n in order]
    for n in runs:
        ms = [m for name, m in row["turns"] if name == n]
        row[f"{n}_device_ms"] = sum(ms) / len(ms)
    row["forward_saving_states_turns"] = [(n, graph_ms(torch, fwds[n]))
                                          for n in order]
    for n in runs:
        ms = [m for name, m in row["forward_saving_states_turns"]
              if name == n]
        row[f"{n}_forward_saving_states_device_ms"] = sum(ms) / len(ms)
        row[f"{n}_states_bytes"] = state_bytes[n]
    row["bound_ms"] = FLOPS * B * S * C * N / PEAK_F32_FLOPS * 1e3
    row["port_bound_share"] = row["bound_ms"] / row["port_device_ms"]
    row["port_ptxas"] = pick(_build.build_log["ssm_scan"]["ptxas"])
    if dll is not None:
        row["other_ptxas"] = pick(dll.ptxas)
    ok = (row["port_same_bits"] and row["port_worst_err_over_limit"] <= 1.0
          and blocks >= 2)
    row["ok"] = ok
    print(json.dumps(row))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
