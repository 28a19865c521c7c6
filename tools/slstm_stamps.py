#!/usr/bin/env python3
"""Where a step of the sLSTM kernels goes, in the counter-barrier design
and in the port's tagged exchange, and the exchange floors of each.

    python3 tools/slstm_stamps.py [--shape 4,2048,768] [--seed 0]
                                  [--designs barrier,tagged]

Builds, all at once, ``tools/slstm_scan_barrier.cu`` (the design with one
grid barrier a step and a serial reload of h_{t-1}, or of all of dg_t)
and ``src/repro_torch/kernels/csrc/slstm_scan.cu`` (the port's), each
with ``-DSLSTM_STAMPS`` (thread 0 of every block sums the ``clock64``
cycles of each phase of its steps), the barrier design also without,
and ``tools/slstm_exchange_flags.cu`` (the exchange by per-block release
flags).  At layer 3's training call of xLSTM-125M (4 × 2,048 × 768, no
state, saving what the backward reads) it runs each design's forward and
backward, checks them against the plain versions (``kernels/ref.py``:
forward within 1e-4 of max(1, max|plain|), backward within 1e-3 of
max|plain|) and the port's stamped build against the port to the bit,
and prints for each kernel the mean cycles a step of each phase over all
blocks, their shares, and the device ms (calls replayed from a CUDA
graph) of the stamped and the unstamped build.  Then the exchange
floors on the forward's grid, S − 1 exchanges of B × d values and
nothing else: the counter barrier, the tagged words
(``slstm_scan.barriers``) and the release flags.  A phase that waits
can surface in the next one.  Prints the card's name and power limit
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
PHASES = {
    "barrier": {"fwd": ("gx prefetch", "h reload", "product",
                        "cell and stores", "barrier"),
                "bwd": ("prefetch", "cell and dG store", "barrier",
                        "dG reload", "product")},
    "tagged": {"fwd": ("step start", "product",
                       "cell, publish, gx prefetch", "saves", "gather"),
               "bwd": ("prefetch", "cell", "product, staging, publish",
                       "dG store", "gather", "sum")},
}
STAMP_BLOCKS, STAMP_PHASES = 1024, 6
FWD_TOL, BWD_TOL = 1e-4, 1e-3


def build(_build, jobs):
    """{name: CDLL} of nvcc builds (name, source, extra flags), all
    started together."""
    out_dir = _build.build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = []
    for name, src, flags in jobs:
        so = out_dir / f"lib{name}.so"
        procs.append((name, so, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, *flags, "-o", str(so),
             str(src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    libs = {}
    for name, so, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        libs[name] = ctypes.CDLL(str(so))
    return libs


def type_barrier_lib(lib):
    p, i = ctypes.c_void_p, ctypes.c_int
    ip, llp = ctypes.POINTER(i), ctypes.POINTER(ctypes.c_longlong)
    lib.slstm_scan_plan.argtypes = [i, i, ip, ip, ip, ip, llp, llp, ip, ip]
    lib.slstm_scan_fwd_launch.argtypes = [p] * 17 + [i, i, i, p]
    lib.slstm_scan_bwd_launch.argtypes = [p] * 19 + [i, i, i, p]
    lib.slstm_barriers_launch.argtypes = [p, i, i, i, p]
    if hasattr(lib, "slstm_stamps"):
        lib.slstm_stamps.argtypes = [p, ctypes.c_longlong]
    return lib


def barrier_calls(torch, lib, gx, wr, bias):
    """(forward, backward) of the barrier design on these inputs, each a
    function of no arguments that launches and returns its outputs."""
    B, S, d4 = gx.shape
    d, dev = d4 // 4, gx.device
    f32 = lambda *s: torch.empty(s, dtype=torch.float32, device=dev)
    hs, fin = f32(B, S, d), [f32(B, d) for _ in range(4)]
    saved = [f32(B, S, 4 * d)] + [f32(B, S, d) for _ in range(3)]
    dG, count = f32(B, S, 4 * d), torch.empty(1, dtype=torch.int32,
                                              device=dev)
    stream = lambda: torch.cuda.current_stream().cuda_stream
    dhs = torch.randn(hs.shape, generator=torch.Generator(
        device=dev).manual_seed(13), device=dev)

    def fwd():
        err = lib.slstm_scan_fwd_launch(
            gx.data_ptr(), wr.data_ptr(), bias.data_ptr(), None, None, None,
            None, hs.data_ptr(), *(t.data_ptr() for t in fin),
            *(t.data_ptr() for t in saved), count.data_ptr(), B, S, d,
            stream())
        if err:
            raise RuntimeError(f"barrier design's forward: CUDA error {err}")
        return hs, tuple(fin), tuple(saved)

    def bwd():
        err = lib.slstm_scan_bwd_launch(
            wr.data_ptr(), None, None, None, *(t.data_ptr() for t in saved),
            dhs.data_ptr(), None, None, None, None, dG.data_ptr(), None,
            None, None, None, count.data_ptr(), B, S, d, stream())
        if err:
            raise RuntimeError(f"barrier design's backward: CUDA error {err}")
        return dG, dhs
    return fwd, bwd


def read_stamps(torch, lib, kernel: int, names) -> dict:
    n = 2 * STAMP_BLOCKS * (STAMP_PHASES + 1)
    buf = torch.zeros(n, dtype=torch.int64)
    err = lib.slstm_stamps(buf.data_ptr(), n)
    if err:
        raise RuntimeError(f"reading the stamps: CUDA error {err}")
    x = buf.view(2, STAMP_BLOCKS, STAMP_PHASES + 1)[kernel].double()
    x = x[x[:, -1] > 0]
    steps = x[:, -1].sum().item()
    per = {ph: x[:, j].sum().item() / steps for j, ph in enumerate(names)}
    total = sum(per.values())
    return {"blocks": x.shape[0], "steps_a_block": steps / x.shape[0],
            "cycles_a_step": per, "cycles_sum": total,
            "share": {ph: c / total for ph, c in per.items()}}


def errors(pairs, tol, scale_floor: float) -> float:
    """The largest |got − want| / max(scale_floor, max|want|) of pairs;
    raises past tol."""
    worst = 0.0
    for name, a, b in pairs:
        e = ((a - b).abs().max() / max(scale_floor, b.abs().max().item())
             ).item()
        if not e <= tol:
            raise RuntimeError(f"{name}: error {e} past {tol}")
        worst = max(worst, e)
    return worst


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--shape", default="4,2048,768")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--designs", default="barrier,tagged")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("slstm_stamps: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    from attn_bwd_turns import graph_ms
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels import slstm_scan as tsl
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()[0]
    print(smi)
    designs = args.designs.split(",")
    tools = os.path.join(ROOT, "tools")
    jobs = [("slstm_flags", os.path.join(tools, "slstm_exchange_flags.cu"),
             ())]
    if "barrier" in designs:
        src = os.path.join(tools, "slstm_scan_barrier.cu")
        jobs += [("slstm_barrier_stamps", src, ("-DSLSTM_STAMPS",)),
                 ("slstm_barrier", src, ())]
    if "tagged" in designs:
        jobs.append(("slstm_tagged_stamps", _build.CSRC / "slstm_scan.cu",
                     ("-DSLSTM_STAMPS",)))
    libs = build(_build, jobs)
    torch.backends.cuda.matmul.allow_tf32 = False

    B, S, d = (int(x) for x in args.shape.split(","))
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    gx = torch.randn((B, S, 4 * d), generator=gen, device="cuda")
    wr = torch.randn((d, 4 * d), generator=gen, device="cuda") * (0.5 / d
                                                                   ** 0.5)
    bias = torch.randn((4 * d,), generator=gen, device="cuda") * 0.5
    hr, fr, sr = ref.slstm_scan_ref(gx, wr, bias, None, save=True)
    res = {"card": smi, "shape": [B, S, d]}

    def check(name, fwd, bwd):
        hs, fin, saved = fwd()
        fe = errors([(f"{name} forward {k}", a, b) for k, a, b in zip(
            ("hs", "c", "n", "m", "h", "G", "C", "N", "M"),
            (hs,) + tuple(fin) + tuple(saved), (hr,) + fr + sr)],
            FWD_TOL, 1.0)
        dG, dhs = bwd()
        dGr, _ = ref.slstm_scan_bwd_ref(wr, None, sr, dhs)
        be = errors([(f"{name} backward dG", dG, dGr)], BWD_TOL, 1e-30)
        return fe, be

    def report(name, lib, fwd, bwd, plain_fwd, plain_bwd):
        fe, be = check(name, fwd, bwd)
        fwd()
        torch.cuda.synchronize()
        out = {"fwd_max_rel_err": fe, "bwd_max_rel_err": be}
        for k, kern, call, plain in ((0, "fwd", fwd, plain_fwd),
                                     (1, "bwd", bwd, plain_bwd)):
            call()
            torch.cuda.synchronize()
            st = read_stamps(torch, lib, k, PHASES[name][kern])
            st["stamped_device_ms"] = graph_ms(torch, call, calls=2,
                                               replays=3)
            st["device_ms"] = graph_ms(torch, plain, calls=2, replays=3)
            st["us_a_step"] = st["device_ms"] * 1e3 / S
            st["ns_a_step"] = {ph: s * st["us_a_step"] * 1e3
                               for ph, s in st["share"].items()}
            out[kern] = st
            print(f"{name} {kern}: " + ", ".join(
                f"{ph} {c:.0f}" for ph, c in st["cycles_a_step"].items())
                + f"; sum {st['cycles_sum']:.0f} cycles a step; stamped "
                f"{st['stamped_device_ms']:.3f} ms, unstamped "
                f"{st['device_ms']:.3f} ms ({st['us_a_step']:.3f} us a step)")
        res[name] = out

    if "barrier" in designs:
        lib = type_barrier_lib(libs["slstm_barrier_stamps"])
        plain = type_barrier_lib(libs["slstm_barrier"])
        f, b = barrier_calls(torch, lib, gx, wr, bias)
        pf, pb = barrier_calls(torch, plain, gx, wr, bias)
        report("barrier", lib, f, b, pf, pb)
        count = torch.empty(1, dtype=torch.int32, device="cuda")

        def floor():
            err = plain.slstm_barriers_launch(
                count.data_ptr(), B, S, d,
                torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"barrier floor: CUDA error {err}")
        res["floor_barrier_device_ms"] = graph_ms(torch, floor, calls=2,
                                                  replays=3)
    if "tagged" in designs:
        lib = tsl.typed(libs["slstm_tagged_stamps"])
        dhs = torch.randn(hr.shape, generator=torch.Generator(
            device="cuda").manual_seed(13), device="cuda")

        def with_lib(which, fn):
            def call():
                real, tsl._lib = tsl._lib, lambda: which
                try:
                    return fn()
                finally:
                    tsl._lib = real
            return call
        fwd_fn = lambda: tsl.slstm_scan(gx, wr, bias, None, save=True)
        f = with_lib(lib, fwd_fn)
        saved_port = fwd_fn()[2]
        bwd_fn = lambda: (tsl.slstm_scan_bwd(wr, None, saved_port, dhs, None,
                                             want_dstate=False)[0], dhs)
        b = with_lib(lib, bwd_fn)
        flat = lambda o: (o[0],) + o[1] + o[2]
        same = (all(torch.equal(x, y) for x, y in zip(flat(f()),
                                                      flat(fwd_fn())))
                and torch.equal(b()[0], bwd_fn()[0]))
        report("tagged", lib, f, b, fwd_fn, bwd_fn)
        res["tagged"]["stamped_equals_port"] = same
        res["floor_tagged_device_ms"] = graph_ms(
            torch, lambda: tsl.barriers(B, S, d, gx.device), calls=2,
            replays=3)

    flags = libs["slstm_flags"]
    p, i = ctypes.c_void_p, ctypes.c_int
    flags.slstm_exchange_flags_launch.argtypes = [p, p, i, i, i, i, i, p]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    u = -(-d // sms)
    blocks = -(-d // u)
    buf = torch.empty(2 * B * d, dtype=torch.float32, device="cuda")
    fl = torch.empty(blocks, dtype=torch.int32, device="cuda")

    def flag_floor():
        err = flags.slstm_exchange_flags_launch(
            buf.data_ptr(), fl.data_ptr(), B, S, d, u, blocks,
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"flags floor: CUDA error {err}")
    res["floor_flags_device_ms"] = graph_ms(torch, flag_floor, calls=2,
                                            replays=3)
    for k in [k for k in res if k.startswith("floor_")]:
        res[k.replace("device_ms", "us_an_exchange")] = res[k] * 1e3 / (S - 1)
        print(f"{k}: {res[k]:.4f} ms, "
              f"{res[k] * 1e3 / (S - 1):.3f} us an exchange")
    ok = res.get("tagged", {}).get("stamped_equals_port", True)
    print(json.dumps(res))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
