#!/usr/bin/env python3
"""The MoE gating kernels on one card: the port's ``topk_gating`` and
``topk_gating_bwd`` against another build of ``csrc/moe_gating.cu`` and
against the designs not kept, in turns in one process.

    python3 tools/gating_turns.py [--other PATH] [--variants]
                                  [--rounds 5] [--seed 0]

* ``port``: ``repro_torch.kernels.moe_gating.topk_gating`` /
  ``topk_gating_bwd`` as the model calls them (the route printed beside
  each shape).
* ``other`` (with ``--other``): a ``moe_gating.cu`` of an earlier design,
  such as the parent commit's unpacked under the git-ignored ``build/``
  (``git show HEAD~1:src/repro_torch/kernels/csrc/moe_gating.cu``),
  compiled here with the port's nvcc flags and called through its own C
  entry points (the ABI before the route argument).  Nothing of the port
  reaches it.
* ``--variants``: the designs not kept, the port's own ``moe_gating.cu``
  compiled with the ``-D`` flags of :data:`VARIANTS` (lanes a row at E =
  16 and E = 128, threads a block, the max and sum folded into one (m,
  s) tree, every e divided and the picks taken on p), called through
  the port's C entry points on the port's route.

At the five main-path shapes of :data:`SHAPES` (logits drawn from a seed
and rounded to bf16, as the router's f32 copy of its bf16 product is;
dprobs drawn from the seed) every build is first held against the plain
version (``kernels/ref.py``: indices equal and probabilities within
1e-5; dlogits within 1e-6) and run twice for equal bits.  Then each
build is timed as device ms (20 calls in a CUDA graph, replayed 10
times, as ``chip_smoke.py::graph_ms``) in the order build, port, port,
build, ``--rounds`` times, medians kept; eager ms (200 calls between
CUDA events, the host's Python and ctypes included) for the port and
the other build; the launch floor (one ``add_`` node in a graph) beside
them; each build's own kernel µs from a profiler window last.  Prints
the card's name and power limit first and one JSON line last, and
writes it to ``chiprun_out/gating_turns.json``.  Needs a card and nvcc.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PEAK_BYTES_PER_S = 3.35e12
GATE_TOL, GATE_BWD_TOL = 1e-5, 1e-6
# name, kernel, T, E, k: the main path's gating calls (Phi-3.5-MoE and
# Llama-4 Maverick serving at batch 4 × prompt 1,024, Phi's training at
# 4 × 2,048)
SHAPES = [("phi prefill", "fwd", 4096, 16, 2),
          ("llama4 prefill", "fwd", 4096, 128, 1),
          ("phi training", "bwd", 8192, 16, 2),
          ("phi decode", "fwd", 4, 16, 2),
          ("llama4 decode", "fwd", 4, 128, 1)]
# the port's source under other choices; a variant that names the port's
# own choice is a second build of the port, the turns' noise
VARIANTS = {"g16_2": ["-DMOE_GATING_G16=2"],
            "g16_1": ["-DMOE_GATING_G16=1"],
            "g128_8": ["-DMOE_GATING_G128=8"],
            "g128_16": ["-DMOE_GATING_G128=16"],
            "g128_32": ["-DMOE_GATING_G128=32"],
            "threads_256": ["-DMOE_GATING_THREADS=256"],
            "threads_64": ["-DMOE_GATING_THREADS=64"],
            "pselect": ["-DMOE_GATING_PSELECT"],
            "online": ["-DMOE_GATING_ONLINE"]}
# the variants that take the port's sums (the same lanes a row) and
# divisions: their picks and probabilities equal the port's to the bit,
# rounding ties included
SAME_BITS = ("threads_256", "threads_64", "pselect")


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


def eager_ms(torch, fn, iters: int = 200, warmup: int = 10) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def kernel_us(torch, fn, calls: int = 20) -> dict:
    """Each kernel's own device µs a call over ``calls`` calls, from
    torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return {e.key[:70]: e.self_device_time_total / calls
            for e in prof.key_averages()
            if getattr(e, "self_device_time_total", 0)}


def ptxas(log: str) -> dict:
    """Registers and spill bytes of each gating kernel in an ``nvcc
    -Xptxas -v`` report, by its mangled name's tail."""
    out, name = {}, None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            name = ln.split("'")[1]
            name = name[name.index("topk_gating"):] if "topk_gating" in \
                name else None
        elif name and "spill stores" in ln:
            out.setdefault(name, {})["spill_store_bytes"] = int(
                re.search(r"(\d+) bytes spill stores", ln).group(1))
        elif name and "Used" in ln and "registers" in ln:
            out.setdefault(name, {})["registers"] = int(
                ln.split("Used")[1].split()[0])
    return out


def build(jobs: dict) -> dict:
    """tag → (source, nvcc flags), compiled all at once → tag → CDLL."""
    out = os.path.join(ROOT, "build", "gating_turns")
    os.makedirs(out, exist_ok=True)
    procs = {}
    for tag, (path, flags) in jobs.items():
        lib = os.path.join(out, f"libmoe_gating_{tag}_{os.getpid()}.so")
        procs[tag] = (lib, subprocess.Popen(
            ["/usr/local/cuda/bin/nvcc", *flags, "-o", lib, path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    dlls = {}
    for tag, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {tag}:\n{log}")
        dlls[tag] = ctypes.CDLL(lib)
        dlls[tag].ptxas = ptxas(log)
    return dlls


def bind(dll, routed: bool) -> None:
    """The C entry points' argument types: with the route argument (the
    port's ABI) or without (the earlier one)."""
    p, i = ctypes.c_void_p, ctypes.c_int
    extra = [i] if routed else []
    dll.topk_gating_launch.argtypes = [p, p, p, i, i, i, *extra, p]
    dll.topk_gating_launch.restype = i
    dll.topk_gating_bwd_launch.argtypes = [p] * 5 + [i, i, i, *extra, p]
    dll.topk_gating_bwd_launch.restype = i
    dll.routed = routed


def caller(torch, tmg, dll, kind: str, logits, k: int, picks):
    """A call of ``dll``'s forward or backward at these inputs, outputs
    made as the port's wrapper makes them."""
    T, E = logits.shape
    stream = lambda: torch.cuda.current_stream().cuda_stream
    if kind == "fwd":
        vec = [int(tmg.route(logits) == "vector")] if dll.routed else []

        def fwd():
            probs = torch.empty((T, k), dtype=torch.float32,
                                device=logits.device)
            idx = torch.empty((T, k), dtype=torch.int32,
                              device=logits.device)
            err = dll.topk_gating_launch(logits.data_ptr(), probs.data_ptr(),
                                         idx.data_ptr(), T, E, k, *vec,
                                         stream())
            if err:
                raise RuntimeError(f"topk_gating_launch: CUDA error {err}")
            return probs, idx
        return fwd
    probs, idx, dprobs = picks
    vec = ([int(tmg.route(logits, idx, probs, dprobs) == "vector")]
           if dll.routed else [])

    def bwd():
        dlogits = torch.empty_like(logits)
        err = dll.topk_gating_bwd_launch(
            logits.data_ptr(), probs.data_ptr(), idx.data_ptr(),
            dprobs.data_ptr(), dlogits.data_ptr(), T, E, k, *vec, stream())
        if err:
            raise RuntimeError(f"topk_gating_bwd_launch: CUDA error {err}")
        return (dlogits,)
    return bwd


# rows whose p tie by rounding (tests/test_torch_kernels.py::GATING_TIES):
# {expert: d} with logits d ulps below the max 0.75, the rest 30-35 below
TIES = [{5: 0, 3: 1, 4: 1, 7: 64}, {5: 0, 3: 1, 9: 6},
        {0: 0, 9: 0, 4: 1, 12: 64}]


def tie_logits(torch, T: int, E: int) -> list:
    """One (T, E) tensor a pattern of :data:`TIES`, its rows alike but
    for the rest, so each pattern fills whole warps."""
    out = []
    for j, pattern in enumerate(TIES):
        g = torch.Generator().manual_seed(T + E + j)
        x = 0.75 - 30 - 5 * torch.rand((T, E), generator=g)
        for e, d in pattern.items():
            x[:, e] = 0.75 - d * 2.0 ** -24
        out.append(x.cuda())
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--other", help="an earlier moe_gating.cu")
    ap.add_argument("--variants", action="store_true",
                    help="also time the port's source under VARIANTS' flags")
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("gating_turns: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels import moe_gating as tmg
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()[0]
    print(smi)
    _build.build(["moe_gating"])
    src = str(_build.CSRC / "moe_gating.cu")
    jobs = {}
    if args.other:
        jobs["other"] = (os.path.abspath(args.other), _build.NVCC_FLAGS)
    if args.variants:
        jobs.update({name: (src, [*_build.NVCC_FLAGS, *flags])
                     for name, flags in VARIANTS.items()})
    builds = build(jobs)
    for name, dll in builds.items():
        bind(dll, routed=name != "other")
    one = torch.zeros(1, device="cuda")
    floor = statistics.median(graph_ms(torch, lambda: one.add_(1.0))
                              for _ in range(args.rounds))
    out = {"card": smi, "other": args.other, "launch_floor_ms": floor,
           "port_ptxas": ptxas(_build.build_log["moe_gating"]["ptxas"]),
           "ptxas": {n: d.ptxas for n, d in builds.items()}, "shapes": []}
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    for name, kind, T, E, k in SHAPES:
        logits = torch.randn((T, E), generator=gen, device="cuda") \
            .bfloat16().float()
        pr, ir = ref.topk_gating_ref(logits, k)
        picks = None
        if kind == "fwd":
            port = lambda: tmg.topk_gating(logits, k)
            want = None
            route = tmg.route(logits)
        else:
            dprobs = torch.randn((T, k), generator=gen, device="cuda")
            picks = (pr, ir, dprobs)
            port = lambda: (tmg.topk_gating_bwd(logits, ir, pr, dprobs),)
            want = ref.topk_gating_bwd_ref(logits, ir, pr, dprobs)
            route = tmg.route(logits, ir, pr, dprobs)
        runs = {"port": port}
        runs.update({n: caller(torch, tmg, d, kind, logits, k, picks)
                     for n, d in builds.items()})
        row = {"shape": name, "kernel": ("topk_gating" if kind == "fwd"
                                         else "topk_gating_bwd"),
               "T": T, "E": E, "k": k, "route": route, "checks": {}}
        for n, fn in runs.items():
            a, b = fn(), fn()
            torch.cuda.synchronize()
            same = all(torch.equal(x, y) for x, y in zip(a, b))
            if kind == "fwd":
                err = (a[0] - pr).abs().max().item()
                ok = same and torch.equal(a[1], ir) and err <= GATE_TOL
            else:
                err = (a[0] - want).abs().max().item()
                ok = same and err <= GATE_BWD_TOL
            row["checks"][n] = {"ok": ok, "same_bits": same,
                                "max_abs_err": err}
        if kind == "fwd":
            # rounding ties: each variant of the port's arithmetic gives
            # the port's bits (the picks by e against those by p)
            ties = tie_logits(torch, 999, E)
            want_t = [tmg.topk_gating(x, k) for x in ties]
            for n in builds:
                got_t = [caller(torch, tmg, builds[n], kind, x, k, None)()
                         for x in ties]
                same = all(torch.equal(a, b) for g, w in zip(got_t, want_t)
                           for a, b in zip(g, w))
                row["checks"][n]["ties_equal_port"] = same
                if n in SAME_BITS:
                    row["checks"][n]["ok"] &= same
        turns = {n: [] for n in runs}
        for _ in range(args.rounds):
            for n in builds:
                for m in (n, "port", "port", n):
                    turns[m].append(graph_ms(torch, runs[m]))
            if not builds:
                turns["port"].append(graph_ms(torch, port))
        row["device_ms"] = {n: statistics.median(v) for n, v in
                            turns.items()}
        row["device_ms_spread"] = {n: [min(v), max(v)] for n, v in
                                   turns.items()}
        row["vs_port"] = {n: row["device_ms"][n] / row["device_ms"]["port"]
                          for n in builds}
        row["eager_ms"] = {n: eager_ms(torch, runs[n])
                           for n in ("port", "other") if n in runs}
        nbytes = (T * (4 * E + 8 * k) if kind == "fwd"
                  else T * (8 * E + 12 * k))
        row["bound_ms"] = nbytes / PEAK_BYTES_PER_S * 1e3
        row["floor_share"] = {n: max(row["bound_ms"], floor) / ms
                              for n, ms in row["device_ms"].items()}
        print(json.dumps(row))
        out["shapes"].append(row)
    for row, (name, kind, T, E, k) in zip(out["shapes"], SHAPES):
        if name.endswith("decode"):
            continue                       # the profiler last: it slows
        logits = torch.randn((T, E), generator=gen,    # later launches
                             device="cuda").bfloat16().float()
        pr, ir = ref.topk_gating_ref(logits, k)
        picks = (pr, ir, torch.randn((T, k), generator=gen, device="cuda"))
        fns = {"port": (lambda: tmg.topk_gating(logits, k)) if kind == "fwd"
               else (lambda: tmg.topk_gating_bwd(logits, ir, pr, picks[2]))}
        if "other" in builds:
            fns["other"] = caller(torch, tmg, builds["other"], kind, logits,
                                  k, picks)
        row["kernel_us"] = {n: kernel_us(torch, fn) for n, fn in fns.items()}
    out["ok"] = all(c["ok"] for r in out["shapes"]
                    for c in r["checks"].values())
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "gating_turns.json"),
              "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out))
    return 0 if out["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
