#!/usr/bin/env python3
"""Does a torch.profiler window keep every kernel launched inside it?

    python3 tools/profile_window_check.py [--steps 5] [--age 25]

Runs 4 rounds of STRADS LDA at the NYTimes shape of ``chip_smoke.py``
(K = 1,000, W = 128: one ``lda_gibbs`` launch of ~16 ms a round, then 6
short torch kernels) inside a profiler window, ``--steps`` times,
``--age`` seconds apart, so the process ages as ``chip_smoke.py``'s does
by the time it reads its windows.  Three windows each step:

* ``bare``: the rounds start as soon as the window opens;
* ``margins``: the window is open 0.5 s before the rounds and after them;
* ``primed``: the window first launches ``chip_smoke.PROFILE_PRIMERS``
  empty kernels (``torch.cuda._sleep(0)``) and waits for them, then runs
  the rounds (as ``chip_smoke.profile_window`` does).

Prints the card's name and power limit, then one JSON line a window: the
process's age, the window, the ``lda_gibbs`` launches it kept of 4, the
device events of the rounds it kept of 28, the primers it kept and its
first three device events (name, start ms after the first, length ms).
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


def window(torch, fn, margin: float, primers: int) -> dict:
    """The device events a profiler window around ``fn`` kept."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(primers):
            torch.cuda._sleep(0)
        torch.cuda.synchronize()
        time.sleep(margin)
        fn()
        torch.cuda.synchronize()
        time.sleep(margin)
    dev = sorted((e.time_range.start, e.time_range.elapsed_us(), e.name)
                 for e in prof.events() if e.device_type == DeviceType.CUDA)
    rounds = [x for x in dev if "spin_kernel" not in x[2]]
    t0 = rounds[0][0] if rounds else 0
    return {"lda_gibbs_kept": sum("lda_gibbs_kernel" in n
                                  for _, _, n in rounds),
            "round_events_kept": len(rounds),
            "primers_kept": len(dev) - len(rounds),
            "first": [(n[:40], round((s - t0) / 1e3, 3), round(d / 1e3, 3))
                      for s, d, n in rounds[:3]]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--age", type=float, default=25.0)
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
    for step in range(args.steps):
        if step:
            time.sleep(args.age)
        for label, margin, primers in (("bare", 0.0, 0),
                                       ("margins", 0.5, 0),
                                       ("primed", 0.0, cs.PROFILE_PRIMERS)):
            out = window(torch, rounds, margin, primers)
            print(json.dumps({"age_s": round(time.perf_counter() - t_start),
                              "window": label, "lda_gibbs_launched": 4,
                              "round_events": 28, "primers": primers,
                              **out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
