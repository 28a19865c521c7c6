#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py [--seed 0] [--n 50000] [--J 50000]

1. Prints the card (name and power limit from nvidia-smi) and the torch
   and CUDA versions.
2. Builds the port's CUDA kernels from the checkout with nvcc and prints
   the build time and the ``-Xptxas -v`` report.
3. Builds the STRADS Lasso data on the card (dense f32 X of n × J, the
   recipe of ``synthetic_correlated``, from ``--seed``), then holds each
   kernel against its plain PyTorch version at the main path's shapes and
   at ragged ones, times it with CUDA events, and prints one ``kernels``
   JSON line (time, bound, plain and library times, launches).
4. Drives the main path through the port's entry points: the plan
   ``examples/plans/lasso_pallas.json`` as checked in (scan, 16 rounds,
   W = 4, the CUDA kernels), the same plan on the loop executor, on
   W = 1, and with ``kind="reference"``.  It checks that both kernels
   were launched, that loop ≡ scan bit for bit, that the other runs agree
   within the stated tolerance and that the objective is finite and
   falls; then times where a round goes and runs the repo's convergence
   check (``tests/test_lasso.py``) on the card at a small size.

Any failure exits nonzero before the last line.  The last line is
``{"ok": true, "device": {...}}``.  Everything measured is also written
to ``chiprun_out/chip_smoke.json``.  Float32 products run in full f32
(``allow_tf32`` is set False for matmul and cuDNN).
"""
from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
PEAK_BYTES_PER_S = 3.35e12     # H100 SXM HBM3, data sheet
PEAK_F32_FLOPS = 67e12         # H100 SXM FP32 outside the tensor cores
KERNEL_TOL = 1e-4              # max |kernel − plain| ≤ KERNEL_TOL·max(1, max|plain|)
STATE_TOL = 1e-4               # |β|, |r| between runs that sum in another order
DEVICE = "cuda"
SOURCE = "src/repro_torch/kernels/csrc/lasso_cd.cu"
REPLACES = {"lasso_partial": "src/repro/kernels/lasso_cd.py:50",
            "gram_block": "src/repro/kernels/lasso_cd.py:94"}


class SmokeFailure(Exception):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def time_ms(torch, fn, iters: int = 200, warmup: int = 10) -> float:
    """Mean device time of one call, from CUDA events over ``iters`` calls
    after ``warmup`` calls."""
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


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    tb, tf = nbytes / PEAK_BYTES_PER_S, flops / PEAK_F32_FLOPS
    return max(tb, tf) * 1e3, ("bytes" if tb >= tf else "operations")


def max_err(torch, got, want) -> tuple[float, float]:
    err = (got - want).abs().max().item()
    return err, KERNEL_TOL * max(1.0, want.abs().max().item())


def kernel_phase(torch, lc, ref, X, y, W: int, U: int, UP: int, seed: int):
    """Each kernel against its plain version at the main path's shapes
    (candidate columns gathered out of the real X) and at ragged ones."""
    n, J = X.shape
    gen = torch.Generator().manual_seed(seed)
    Xw = X.view(W, n // W, J)
    rw = y.view(W, n // W)
    cand = torch.randperm(J, generator=gen)[:UP].to(X.device)
    Xc = Xw.index_select(-1, cand)                  # (W, n/W, U′)
    Xb = Xw.index_select(-1, cand[:U])              # (W, n/W, U)
    ragged_X = torch.randn((4, 1001, 37), generator=gen).to(X.device)
    ragged_r = torch.randn((4, 1001), generator=gen).to(X.device)
    cases = {
        "lasso_partial": dict(
            fn=lambda: lc.lasso_partial(Xb, rw),
            plain=lambda: ref.lasso_partial_ref(Xb, rw),
            library=lambda: torch.matmul(Xb.mT, rw.unsqueeze(-1)),
            ragged=(lambda: lc.lasso_partial(ragged_X, ragged_r),
                    lambda: ref.lasso_partial_ref(ragged_X, ragged_r)),
            nbytes=4 * (W * (n // W) * (U + 1) + W * U),
            flops=2 * W * (n // W) * U),
        "gram_block": dict(
            fn=lambda: lc.gram_block(Xc),
            plain=lambda: ref.gram_ref(Xc),
            library=lambda: torch.matmul(Xc.mT, Xc),
            ragged=(lambda: lc.gram_block(ragged_X),
                    lambda: ref.gram_ref(ragged_X)),
            # G is symmetric: the upper triangle, U′(U′+1)/2 entries of
            # 2·n/W operations each, is all the function needs
            nbytes=4 * (W * (n // W) * UP + W * UP * UP),
            flops=W * (n // W) * UP * (UP + 1)),
    }
    out = {}
    for name, c in cases.items():
        before = lc.LAUNCHES[name]
        got, want = c["fn"](), c["plain"]()
        torch.cuda.synchronize()
        check(lc.LAUNCHES[name] == before + 1,
              f"{name}: the wrapper did not launch its kernel")
        check(torch.equal(got, c["fn"]()), f"{name}: two launches differ")
        err, tol = max_err(torch, got, want)
        check(err <= tol, f"{name}: max abs err {err} > {tol} at the main "
                          f"path's shapes")
        rg, rw_ = c["ragged"]
        rerr, rtol = max_err(torch, rg(), rw_())
        check(rerr <= rtol, f"{name}: max abs err {rerr} > {rtol} at "
                            f"ragged shapes (4, 1001, 37)")
        ms = time_ms(torch, c["fn"])
        plain_ms = time_ms(torch, c["plain"])
        library_ms = time_ms(torch, c["library"])
        ms_again = time_ms(torch, c["fn"])
        bms, by = bound(c["nbytes"], c["flops"])
        out[name] = {
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[name], "launches": None,
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bms, "bound_by": by, "library_ms": library_ms,
            "tolerance": tol, "ragged_max_abs_err": rerr,
            "ms_repeat": ms_again, "bound_share": bms / ms,
            "shape": list(Xc.shape if name == "gram_block" else Xb.shape)}
    return out


def run_plan(torch, lasso, cfg, plan, X, y, seed: int):
    """One run of a plan through the port's entry points; returns the
    report, its wall time and the objective trace."""
    eng = lasso.make_engine(cfg, workers=plan.workers, device=DEVICE)
    data = eng.shard_data({"X": X, "y": y})
    state = eng.init_state(y=y)
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(seed)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rep = eng.execute(state, data, gen, plan,
                      collect=eng.app.objective_collect())
    torch.cuda.synchronize()
    return eng, rep, time.perf_counter() - t0


def round_breakdown(torch, eng, state, data, seed: int, reps: int = 5):
    """Where one round's time goes: each step of the round body run on
    its own between synchronisations, timed by CUDA events (device time
    including the host's enqueue time, as the eager round pays it)."""
    app = eng.app
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(seed + 1)
    carry = eng.init_sched_carry()
    J = app.num_schedulable()
    times: dict = {}
    for t in range(reps):
        def step(name, fn):
            torch.cuda.synchronize()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            out = fn()
            b.record()
            torch.cuda.synchronize()
            times.setdefault(name, []).append(a.elapsed_time(b))
            return out
        g = step("noise", lambda: -torch.log(-torch.log(torch.rand(
            (J,), generator=gen, device=DEVICE).clamp_min_(1e-38))))
        cand = step("propose", lambda: app.propose(state, carry, g, t, 0))
        Xc = step("gather_candidates",
                  lambda: data["X"].index_select(-1, cand))
        Gw = step("gram_block", lambda: app.kernels.gram_block(Xc))
        G = step("sum_workers", lambda: Gw.sum(0))
        sched = step("rho_filter", lambda: app.schedule(state, carry, cand,
                                                        G, t, 0))
        Xb = step("gather_block",
                  lambda: data["X"].index_select(-1, sched["idx"]))
        zw = step("lasso_partial",
                  lambda: app.kernels.lasso_partial(Xb, state["r"]))
        z = zw.sum(0)
        new = step("pull", lambda: app.pull(state, sched, z, None, data, 0))
        carry = step("carry_update", lambda: app.sched_update(
            carry, state, new, sched, 0))
        state = new
    return {k: sorted(v)[len(v) // 2] for k, v in times.items()}


def profile_rounds(torch, lasso, cfg, plan, X, y, seed: int):
    """Device busy share over a 4-round window, from torch.profiler: the
    summed time of the device's own events (kernels, copies) over the
    window's wall time (the profiler's host overhead included)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    eng = lasso.make_engine(cfg, workers=plan.workers, device=DEVICE)
    data = eng.shard_data({"X": X, "y": y})
    state = eng.init_state(y=y)
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(seed)
    short = type(plan).from_json(dict(plan.to_json(), rounds=4))
    eng.execute(state, data, gen, short)                  # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.execute(state, data, gen, short)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    per_name: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            d, c = per_name.get(e.name, (0.0, 0))
            per_name[e.name] = (d + e.time_range.elapsed_us(), c + 1)
    busy_us = sum(d for d, _ in per_name.values())
    rows = sorted(((d, k, c) for k, (d, c) in per_name.items()),
                  reverse=True)
    return {"wall_ms": wall_us / 1e3, "device_busy_ms": busy_us / 1e3,
            "device_idle_share": (1 - busy_us / wall_us) if busy_us else None,
            "top": [{"name": k, "device_ms": d / 1e3, "count": c}
                    for d, k, c in rows[:15]]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--n", type=int, default=50_000)
    ap.add_argument("--J", type=int, default=50_000)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs a card",
              file=sys.stderr)
        return 2
    src = os.path.join(ROOT, "src")
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        print(f"chip_smoke: {src}/repro_torch not found; run from a "
              f"checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, src)
    from repro_torch.apps import lasso
    from repro_torch.core import ExecutionPlan
    from repro_torch.kernels import KernelSpec, _build, ref
    from repro_torch.kernels import lasso_cd as lc

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    result: dict = {}

    # 1. the card
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else ""
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}; allow_tf32=False "
          f"(matmul and cuDNN)")
    result["card"] = card
    result["versions"] = {"torch": torch.__version__,
                          "cuda": torch.version.cuda}

    # 2. the build
    t0 = time.perf_counter()
    _build.build(["lasso_cd"])
    build_s = time.perf_counter() - t0
    ptxas = [ln.strip() for ln in _build.build_log["lasso_cd"]["ptxas"]
             .splitlines() if "ptxas info" in ln or "spill" in ln]
    print(f"build: lasso_cd.cu in {build_s:.2f} s (nvcc "
          f"{' '.join(_build.NVCC_FLAGS)})")
    for ln in ptxas:
        print(f"  {ln}")
    result["build"] = {"seconds": build_s, "ptxas": ptxas}

    # 3. data on the card, then the kernels against their plain versions
    n, J = args.n, args.J
    W, U, UP, LAM, RHO = 4, 32, 128, 0.02, 0.3
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    X, y, _ = lasso.synthetic_correlated_device(args.seed, n, J, k_true=16,
                                                device=DEVICE)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    gen_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"data: X ({n}, {J}) f32 = {X.numel() * 4 / 1e9:.2f} GB on the "
          f"card, built in {gen_s:.2f} s from seed {args.seed}")
    check(bool(torch.isfinite(X).all()) and bool(torch.isfinite(y).all()),
          "the data is not finite")
    torch.cuda.reset_peak_memory_stats()
    kern = kernel_phase(torch, lc, ref, X, y, W, U, UP, args.seed)
    kern_peak_gb = torch.cuda.max_memory_allocated() / 1e9

    # 4. the main path
    with open(os.path.join(ROOT, "examples", "plans",
                           "lasso_pallas.json")) as f:
        plan = ExecutionPlan.from_json(json.load(f))
    check(plan.executor == "scan" and plan.workers == W
          and plan.kernels.kind == "pallas", f"unexpected plan {plan}")
    cfg = lasso.LassoConfig(num_features=J, lam=LAM, block_size=U,
                            num_candidates=UP, rho=RHO)
    loop_plan = ExecutionPlan.from_json(dict(plan.to_json(),
                                             executor="loop"))
    w1_plan = ExecutionPlan.from_json(dict(plan.to_json(), workers=1))
    ref_plan = ExecutionPlan.from_json(dict(
        plan.to_json(), kernels=KernelSpec(kind="reference").to_json()))
    # warm-up (library handles, allocator), not counted or timed
    run_plan(torch, lasso, cfg, ExecutionPlan.from_json(
        dict(plan.to_json(), rounds=2)), X, y, args.seed)
    runs = {}
    torch.cuda.reset_peak_memory_stats()
    lc.reset_launch_counts()
    for name, p in (("scan_w4", plan), ("loop_w4", loop_plan),
                    ("scan_w1", w1_plan)):
        before = dict(lc.LAUNCHES)
        eng, rep, secs = run_plan(torch, lasso, cfg, p, X, y, args.seed)
        runs[name] = (rep, secs)
        for k in lc.LAUNCHES:
            check(lc.LAUNCHES[k] - before[k] == p.rounds,
                  f"{name}: {k} launched {lc.LAUNCHES[k] - before[k]} "
                  f"times in {p.rounds} rounds")
    launches = dict(lc.LAUNCHES)
    for k, v in launches.items():
        check(v > 0, f"the main path never launched {k}")
        kern[k]["launches"] = v
    before = dict(lc.LAUNCHES)
    _, rep_ref, secs_ref = run_plan(torch, lasso, cfg, ref_plan, X, y,
                                    args.seed)
    check(lc.LAUNCHES == before, "the reference run launched a kernel")
    runs["scan_w4_reference"] = (rep_ref, secs_ref)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    a, b = runs["scan_w4"][0], runs["loop_w4"][0]
    check(torch.equal(a.state["beta"], b.state["beta"])
          and torch.equal(a.state["r"], b.state["r"])
          and torch.equal(a.trace, b.trace),
          "loop and scan differ on the card")
    diffs = {}
    for name in ("scan_w1", "scan_w4_reference"):
        o = runs[name][0]
        db = (o.state["beta"] - a.state["beta"]).abs().max().item()
        dr = (o.state["r"].reshape(-1)
              - a.state["r"].reshape(-1)).abs().max().item()
        diffs[name] = {"beta": db, "r": dr}
        check(db <= STATE_TOL and dr <= STATE_TOL,
              f"{name} differs from scan_w4: |Δβ| {db}, |Δr| {dr} "
              f"> {STATE_TOL}")
    obj0 = 0.5 * float((y.double() ** 2).sum())
    trace = a.trace.double().cpu().numpy()
    check(trace.shape == (plan.rounds,) and all(map(math.isfinite, trace)),
          "the objective trace is not finite")
    check(trace[-1] < obj0, f"the objective did not fall: {trace[-1]} >= "
                            f"{obj0}")
    main = {
        "plan": plan.to_json(), "n": n, "J": J, "lam": LAM, "U": U,
        "U_prime": UP, "rho": RHO,
        "rounds_per_s": {k: plan.rounds / s for k, (_, s) in runs.items()},
        "seconds": {k: s for k, (_, s) in runs.items()},
        "peak_memory_gb": peak_gb, "data_build_peak_memory_gb": gen_peak_gb,
        "kernel_check_peak_memory_gb": kern_peak_gb, "launches": launches,
        "objective_start": obj0, "objective_end": float(trace[-1]),
        "max_diff_vs_scan_w4": diffs, "loop_equals_scan": True,
        "data_seconds": gen_s,
    }
    # the per-kernel line, then the main path's numbers
    print(json.dumps({"kernels": list(kern.values())}))
    print("main path: " + json.dumps(main))

    eng = lasso.make_engine(cfg, workers=W, device=DEVICE)
    data = eng.shard_data({"X": X, "y": y})
    main["breakdown_ms"] = round_breakdown(torch, eng, runs["scan_w4"][0]
                                           .state, data, args.seed)
    print("round breakdown (ms): " + json.dumps(main["breakdown_ms"]))
    prof = profile_rounds(torch, lasso, cfg, plan, X, y, args.seed)
    print("profile (4 rounds): " + json.dumps(
        {k: v for k, v in prof.items() if k != "top"}))
    del X, y, data, runs, eng

    # the repo's own convergence check (tests/test_lasso.py) on the card
    import numpy as np
    rs = np.random.default_rng(0)
    Xs, ys, _ = lasso.synthetic_correlated(rs, n=150, J=60, k_true=5)
    scfg = lasso.LassoConfig(num_features=60, lam=LAM, block_size=8,
                             num_candidates=32, rho=0.3, eta=1e-2)
    before = dict(lc.LAUNCHES)
    st, _ = lasso.fit(scfg, Xs, ys, plan=ExecutionPlan(
        executor="scan", rounds=400, workers=2,
        kernels=KernelSpec.default_for("pallas")), device=DEVICE)
    check(all(lc.LAUNCHES[k] - before[k] == 400 for k in lc.LAUNCHES),
          "the small run did not go through the kernels")

    def obj(bv):
        return 0.5 * np.sum((ys - Xs @ bv) ** 2) + LAM * np.sum(np.abs(bv))

    got = float(obj(st["beta"].cpu().numpy()))
    want = float(obj(lasso.reference_cd(Xs, ys, LAM, 100)))
    check(got <= want * 1.05 + 1e-6, f"small run: objective {got} not "
                                     f"within 5% of reference_cd's {want}")
    print(f"small run (n=150, J=60, 400 rounds, W=2, CUDA kernels): "
          f"objective {got:.6f} vs reference_cd {want:.6f}")

    result.update(kernels=list(kern.values()), main=main, profile=prof,
                  small={"objective": got, "reference_cd": want})
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke.json"),
              "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
