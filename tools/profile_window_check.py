#!/usr/bin/env python3
"""Does a torch.profiler window keep every kernel launched inside it?

    python3 tools/profile_window_check.py [--steps 5] [--age 25] \
        [--spaced 64] [--gap-ms 1]

Runs 4 rounds of STRADS LDA at the NYTimes shape of ``chip_smoke.py``
(K = 1,000, W = 128: one ``lda_gibbs`` launch of ~7.4 ms a round, then 6
short torch kernels) inside a profiler window, ``--steps`` times,
``--age`` seconds apart, so the process ages as ``chip_smoke.py``'s does
by the time it reads its windows.  Five windows each step:

* ``bare``: the rounds start as soon as the window opens;
* ``margins``: the window is open 0.5 s before the rounds and after them;
* ``primed``: the window first launches 64 empty kernels
  (``torch.cuda._sleep(0)``) back to back and waits for them, then runs
  the rounds;
* ``spaced``: the window first launches ``--spaced`` empty kernels, each
  waited for and followed by ``--gap-ms`` of host time, runs the rounds,
  then launches as many again the same way;
* ``guarded``: ``chip_smoke.profile_window`` itself (its lead and tail
  guards, a window taken again when it lost any record of the call),
  which must hold each of the 4 ``lda_gibbs`` launches.

A loss by time (the device's timestamps behind the host's clock, so the
records of the first moments of a window seem to come before it opens)
drops all of ``primed``'s primers at once and only the first
``spaced`` ones, as many as the gap fits in that time; a loss by count
drops as many of either.  Each window also gives the least and the
median of (a kernel's device start − its launch call's host start) over
the kernels it kept: a negative value is that clock offset.

Prints the card's name and power limit, then one JSON line a window: the
process's age, the window, the ``lda_gibbs`` launches it kept of 4, the
device events of the rounds it kept of 28, the primers it kept before
and after the rounds, for ``spaced`` the host ms from the window's open
to the launch of the first primer kept, the offsets in µs and its first
three device events (name, start ms after the first, length ms), the
kernel-launch calls it recorded (of primers + 28) and how many of those
lost their kernel's record; for ``guarded`` what each window it took
kept of the call and of its guards.  The last
line counts the ``guarded`` windows that needed another attempt.
Needs a card and nvcc.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def lda_rounds(torch, cs, rounds: int = 4):
    """``rounds`` rounds of STRADS LDA at the NYTimes shape, as a
    function."""
    from repro_torch.apps import lda
    from repro_torch.core import ExecutionPlan
    cfg = lda.LDAConfig(vocab=cs.NYTIMES["vocab"], num_topics=cs.LDA_TOPICS,
                        num_workers=cs.LDA_WORKERS,
                        tokens_per_worker=cs.LDA_TOKENS_PER_WORKER,
                        docs_per_worker=cs.LDA_DOCS_PER_WORKER)
    words, docs, z0 = lda.synthetic_corpus_device(0, cfg, device="cuda")
    eng = lda.make_engine(cfg, device="cuda")
    data = eng.shard_data({"words": words, "docs": docs})
    state = eng.init_state(words=words, docs=docs, z0=z0)
    plan = ExecutionPlan(executor="scan", rounds=rounds)
    return lambda: eng.execute(state, data, None, plan)


def guarded(torch, cs, fn) -> dict:
    """``chip_smoke.profile_window`` over ``fn``, every ``lda_gibbs``
    launch in it."""
    from repro_torch.kernels import lda_gibbs as lg
    out = cs.profile_window(torch, fn, {"lda_gibbs": (
        lg.LAUNCHES, ("lda_gibbs_kernel",))})
    return {"lda_gibbs_kept": out["kernel_events"]["lda_gibbs"],
            "attempts": out["attempts"], "windows": out["windows"],
            "device_idle_share": out["device_idle_share"]}


def spaced_primers(torch, n: int, gap_s: float) -> list:
    """Launch ``n`` empty kernels, each waited for and followed by
    ``gap_s`` of host time; the host perf_counter at each launch."""
    at = []
    for _ in range(n):
        at.append(time.perf_counter())
        torch.cuda._sleep(0)
        torch.cuda.synchronize()
        time.sleep(gap_s)
    return at


def clock_offsets(prof) -> dict:
    """Least and median (device start − launch call's host start) in µs
    over the kernels the window kept, matched by correlation id."""
    from torch.autograd import DeviceType
    evs = prof.profiler.kineto_results.events()
    launch = {e.correlation_id(): e.start_ns() for e in evs
              if e.device_type() == DeviceType.CPU
              and "LaunchKernel" in e.name()}
    off = sorted((e.start_ns() - launch[e.correlation_id()]) / 1e3
                 for e in evs if e.device_type() == DeviceType.CUDA
                 and e.correlation_id() in launch)
    return {"offset_min_us": off[0] if off else None,
            "offset_median_us": off[len(off) // 2] if off else None,
            "offsets_matched": len(off)}


def launch_records(prof) -> dict:
    """The kernel-launch calls the window recorded, and how many of them
    lost their kernel's record."""
    from torch.autograd import DeviceType
    evs = prof.profiler.kineto_results.events()
    kept = {e.correlation_id() for e in evs
            if e.device_type() == DeviceType.CUDA}
    launches = [e.correlation_id() for e in evs
                if e.device_type() == DeviceType.CPU
                and "LaunchKernel" in e.name()]
    return {"launch_records": len(launches),
            "launches_without_kernel": sum(c not in kept for c in launches)}


def window(torch, fn, margin: float, primers: int, spaced: int = 0,
           gap_s: float = 0.0) -> dict:
    """The device events a profiler window around ``fn`` kept."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t_open = time.perf_counter()
        for _ in range(primers):
            torch.cuda._sleep(0)
        lead = spaced_primers(torch, spaced, gap_s)
        torch.cuda.synchronize()
        time.sleep(margin)
        t_fn = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        t_end = time.perf_counter()
        spaced_primers(torch, spaced, gap_s)
        time.sleep(margin)
    dev = sorted((e.time_range.start, e.time_range.elapsed_us(), e.name)
                 for e in prof.events() if e.device_type == DeviceType.CUDA)
    rounds = [x for x in dev if "spin_kernel" not in x[2]]
    t0 = rounds[0][0] if rounds else 0
    before = sum("spin_kernel" in n for s, _, n in dev if s < t0)
    after = len(dev) - len(rounds) - before
    out = {"lda_gibbs_kept": sum("lda_gibbs_kernel" in n
                                 for _, _, n in rounds),
           "round_events_kept": len(rounds),
           "primers_kept_before": before, "primers_kept_after": after,
           "rounds_ms": (t_end - t_fn) * 1e3, **clock_offsets(prof),
           **launch_records(prof),
           "first": [(n[:40], round((s - t0) / 1e3, 3), round(d / 1e3, 3))
                     for s, d, n in rounds[:3]]}
    if spaced:
        lost = spaced - before
        out["lost_span_ms"] = ((lead[lost] - t_open) * 1e3
                               if lost < spaced else None)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--age", type=float, default=25.0)
    ap.add_argument("--spaced", type=int, default=64)
    ap.add_argument("--gap-ms", type=float, default=1.0)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("profile_window_check: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]
    import chip_smoke as cs
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    t_start = time.perf_counter()
    rounds = lda_rounds(torch, cs)
    rounds()                                   # build and warm
    retaken = 0
    for step in range(args.steps):
        if step:
            time.sleep(args.age)
        out = guarded(torch, cs, rounds)
        retaken += out["attempts"] > 1
        print(json.dumps({"age_s": round(time.perf_counter() - t_start),
                          "window": "guarded", "lda_gibbs_launched": 4,
                          **out}), flush=True)
        for label, margin, primers, spaced in (
                ("bare", 0.0, 0, 0), ("margins", 0.5, 0, 0),
                ("primed", 0.0, 64, 0), ("spaced", 0.0, 0, args.spaced)):
            out = window(torch, rounds, margin, primers, spaced,
                         args.gap_ms / 1e3)
            print(json.dumps({"age_s": round(time.perf_counter() - t_start),
                              "window": label, "lda_gibbs_launched": 4,
                              "round_events": 28,
                              "primers": primers + 2 * spaced, **out}),
                  flush=True)
    print(json.dumps({"guarded_windows": args.steps,
                      "taken_again": retaken}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
