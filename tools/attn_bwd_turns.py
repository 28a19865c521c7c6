#!/usr/bin/env python3
"""The flash-attention backward on one card: the port's kernels against
another build of ``csrc/flash_attention.cu``, in turns, with SDPA's
backward beside them.

    python3 tools/attn_bwd_turns.py [--other PATH [--other-abi route]
                                     [--other-route mma_sync]]
                                    [--shapes all|d64|d80] [--seed 0]

* ``port``: ``repro_torch.kernels.flash_attention.flash_attention_bwd``
  as the training step calls it (its route printed beside it).
* ``other`` (with ``--other``): a ``flash_attention.cu`` of an earlier
  design, such as the parent commit's unpacked under the git-ignored
  ``build/``, compiled here with the port's nvcc flags and called through
  its own C entry point: the ABI before the wgmma route (no route code,
  no second workspace), or with ``--other-abi route`` the port's own, on
  the port's route for the call or on ``--other-route`` (``mma_sync``:
  the route an earlier source took at head dim 80).  A design not kept
  is timed again from a saved copy of its source.  Nothing of the port
  reaches it.
* ``sdpa``: ``F.scaled_dot_product_attention`` with the call's causal
  flag, its backward as the device time of forward + ``autograd.grad``
  less the forward's, each a CUDA graph.  A yardstick only: the port
  never calls it.

At each shape (``--shapes d64``: MiniCPM-2B's training call (4, 2048,
48, 64) bf16 causal and GQA 32/8 at head dim 128; ``d80``: HuBERT-
XLarge's (4, 1500, 16, 80) non-causal and Zamba2-2.7B's (4, 2000, 32,
80) causal; ``all`` both) both backwards are first held against the f32
plain version (``kernels/ref.py::attention_bwd_ref``, within 2e-2 of
each gradient's largest magnitude) and run twice for equal bits; then
timed as device ms (20 calls in a CUDA graph, replayed 10 times) in the
order other, port, port, other, and each kernel's own device ms read from
a profiler window of 5 calls.  Prints the card's name and power limit
first and one JSON line last.  Needs a card and nvcc.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12
TOL = 2e-2
# (B, S, Hq, Hkv, D, causal): MiniCPM-2B's training call, GQA 32/8 at
# D = 128; HuBERT-XLarge's and Zamba2-2.7B's training calls at D = 80
SHAPES = {"d64": [(4, 2048, 48, 48, 64, True), (1, 2048, 32, 8, 128, True)],
          "d80": [(4, 1500, 16, 16, 80, False),
                  (4, 2000, 32, 32, 80, True)]}
SHAPES["all"] = SHAPES["d64"] + SHAPES["d80"]


def graph_ms(torch, fn, calls: int = 20, replays: int = 10) -> float:
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


def kernel_ms(torch, fn, calls: int = 5) -> dict:
    """Each kernel's device ms a call over ``calls`` calls, from
    torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", 0) or 0
        if us > 0:
            out[e.key[:60]] = us / 1e3 / calls
    return out


def build_other(path: str, nvcc_flags, abi: str, route: str) -> ctypes.CDLL:
    out = os.path.join(ROOT, "build", "attn_bwd_other")
    os.makedirs(out, exist_ok=True)
    lib = os.path.join(out, f"libflash_attention_other_{os.getpid()}.so")
    nvcc = "/usr/local/cuda/bin/nvcc"
    proc = subprocess.run([nvcc, *nvcc_flags, "-o", lib, path],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on {path}:\n{proc.stdout}"
                           f"{proc.stderr}")
    dll = ctypes.CDLL(lib)
    dll.ptxas = proc.stdout + proc.stderr
    dll.route = route
    p, i = ctypes.c_void_p, ctypes.c_int
    dll.flash_attention_bwd_launch.argtypes = (
        [p] * 10 + [i] * 7 + [p, i, i, ctypes.c_float, p] if abi == "mma"
        else [p] * 11 + [i] * 9 + [p, i, i, ctypes.c_float, p])
    dll.flash_attention_bwd_launch.restype = i
    dll.abi = abi
    return dll


def other_bwd(torch, tfa, dll, q, k, v, o, lse, dout, causal: bool):
    """The other build's backward on (B, H, S, D) views."""
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]

    def empty(S, H):
        return torch.empty((B, S, H, D), dtype=q.dtype,
                           device=q.device).transpose(1, 2)
    dq, dk, dv = empty(Sq, Hq), empty(Skv, Hkv), empty(Skv, Hkv)
    st = (ctypes.c_longlong * 24)(*(
        s for x in (q, k, v, o, dout, dq, dk, dv) for s in x.stride()[:3]))
    ptrs = [x.data_ptr() for x in (q, k, v, o, dout, lse)]
    stream = torch.cuda.current_stream().cuda_stream
    if dll.abi == "mma":
        delta = torch.empty((B, Hq, Sq), dtype=torch.float32,
                            device=q.device)
        err = dll.flash_attention_bwd_launch(
            *ptrs, delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), 1, B, Hq, Hkv, Sq, Skv, D, st, int(causal), 0,
            D ** -0.5, stream)
    else:
        route = (tfa.bwd_route(q, k, v, o, dout) if dll.route == "port"
                 else dll.route)
        rows = tfa.bwd_rows(Sq, route)
        delta = torch.empty((B, Hq, rows), dtype=torch.float32,
                            device=q.device)
        lse2 = torch.empty_like(delta)
        err = dll.flash_attention_bwd_launch(
            *ptrs, delta.data_ptr(), lse2.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), 1, tfa.BWD_ROUTES.index(route), B,
            Hq, Hkv, Sq, Skv, D, rows, st, int(causal), 0, D ** -0.5, stream)
    if err:
        raise RuntimeError(f"the other build's backward: CUDA error {err}")
    return dq, dk, dv


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--other", help="an earlier flash_attention.cu")
    ap.add_argument("--other-abi", choices=("mma", "route"), default="mma",
                    help="its backward entry point: before the wgmma route "
                         "(mma) or the port's (route)")
    ap.add_argument("--other-route", choices=("port", "mma_sync"),
                    default="port", help="the route the other build takes "
                    "(with --other-abi route)")
    ap.add_argument("--shapes", choices=sorted(SHAPES), default="all")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        print("attn_bwd_turns: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels import flash_attention as tfa
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()[0]
    print(smi)
    _build.build(["flash_attention"])
    ptxas = [ln.strip() for ln in
             _build.build_log["flash_attention"]["ptxas"].splitlines()
             if "wgmma" in ln or "spill" in ln or "Used" in ln]
    dll = (build_other(os.path.abspath(args.other), _build.NVCC_FLAGS,
                       args.other_abi, args.other_route)
           if args.other else None)
    t = lambda x: x.transpose(1, 2)
    out = {"card": smi, "other": args.other, "shapes": []}
    if dll is not None:
        out["other_ptxas"] = [
            ln.strip() for ln in dll.ptxas.splitlines()
            if "wgmma" in ln or "spill" in ln or "Used" in ln]
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    for B, S, Hq, Hkv, D, causal in SHAPES[args.shapes]:
        q, k, v = (torch.randn((B, S, H, D), generator=gen, device="cuda")
                   .to(torch.bfloat16) for H in (Hq, Hkv, Hkv))
        dout = torch.randn((B, S, Hq, D), generator=gen,
                           device="cuda").to(torch.bfloat16)
        o, lse = tfa.flash_attention(t(q), t(k), t(v), causal=causal,
                                     return_lse=True)
        lse_ref = ref.attention_lse_ref(q, k, causal=causal, window=None,
                                        dtype=torch.float32)
        want = ref.attention_bwd_ref(q, k, v, t(o), dout, lse_ref,
                                     causal=causal, window=None,
                                     dtype=torch.float32)
        runs = {"port": lambda: tfa.flash_attention_bwd(
            t(q), t(k), t(v), o, lse, t(dout), causal=causal)}
        if dll is not None:
            runs["other"] = lambda: other_bwd(torch, tfa, dll, t(q), t(k),
                                              t(v), o, lse, t(dout), causal)
        row = {"shape": [B, S, Hq, Hkv, D], "causal": causal,
               "route": tfa.bwd_route(t(q), t(k), t(v), o, t(dout))}
        for name, fn in runs.items():
            a, b = fn(), fn()
            torch.cuda.synchronize()
            row[f"{name}_same_bits"] = all(torch.equal(x, y)
                                           for x, y in zip(a, b))
            for g, w, x in zip("qkv", want, a):
                err = (t(x).float() - w).abs().max().item()
                row[f"{name}_d{g}_rel_err"] = err / w.abs().max().item()
            if name == "port":
                first = a
            else:
                row["port_vs_other_max_abs"] = [
                    (x.float() - y.float()).abs().max().item()
                    for x, y in zip(first, a)]
            del a, b
        del want, first
        qs, ks, vs = (t(x).detach().requires_grad_() for x in (q, k, v))

        def sdpa_fwd_bwd():
            y = F.scaled_dot_product_attention(qs, ks, vs, is_causal=causal,
                                               enable_gqa=Hq != Hkv)
            torch.autograd.grad(y, (qs, ks, vs), t(dout))

        def sdpa_fwd():
            with torch.no_grad():
                F.scaled_dot_product_attention(qs, ks, vs, is_causal=causal,
                                               enable_gqa=Hq != Hkv)
        order = ["other", "port", "port", "other"] if dll else ["port"] * 2
        row["turns"] = [(n, graph_ms(torch, runs[n])) for n in order]
        for n in runs:
            ms = [m for name, m in row["turns"] if name == n]
            row[f"{n}_device_ms"] = sum(ms) / len(ms)
        row["sdpa_fwd_bwd_device_ms"] = graph_ms(torch, sdpa_fwd_bwd)
        row["sdpa_fwd_device_ms"] = graph_ms(torch, sdpa_fwd)
        row["sdpa_bwd_device_ms"] = (row["sdpa_fwd_bwd_device_ms"]
                                     - row["sdpa_fwd_device_ms"])
        row["kernels_ms"] = {n: kernel_ms(torch, fn) for n, fn in runs.items()}
        pairs = B * (S * (S + 1) // 2 if causal else S * S) * Hq
        t_ops = 10.0 * D * pairs / PEAK_BF16_FLOPS
        t_bytes = (2 * (4 * B * S * Hq * D + 4 * B * S * Hkv * D)
                   + 4 * B * Hq * S) / PEAK_BYTES_PER_S
        row["bound_ms"] = max(t_ops, t_bytes) * 1e3
        row["port_bound_share"] = row["bound_ms"] / row["port_device_ms"]
        print(json.dumps(row))
        out["shapes"].append(row)
        del q, k, v, dout, o, lse, qs, ks, vs
        torch.cuda.empty_cache()
    out["ptxas"] = ptxas
    ok = all(r["port_same_bits"] and all(r[f"port_d{g}_rel_err"] <= TOL
                                         for g in "qkv")
             for r in out["shapes"])
    out["ok"] = ok
    print(json.dumps(out))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
