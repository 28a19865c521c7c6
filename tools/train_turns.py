#!/usr/bin/env python3
"""Training steps on one card: the port against another checkout of the
repo (such as the parent commit's, unpacked under the git-ignored
``build/``), in turns, each run in a process of its own.

    python3 tools/train_turns.py --other-root build/parent_tree \\
        [--arch hubert-xlarge --seq 1500] [--steps 10] [--rounds 2]
        [--bwd-shape 4,1500,16,80,0]
    python3 tools/train_turns.py --swap-bwd build/parent/flash_attention.cu \\
        [--arch hubert-xlarge --seq 1500] [--pairs 40]

Each run is ``repro_torch.launch.train.main`` of the checkout's own
``src/`` at the arch's full size, bf16, batch 4 × ``--seq``, ``--steps``
plain steps; it prints the host-clock ms of each step (to a sync after
the step, as ``chip_smoke.py`` times them) and the median of steps 2 on
(the first step builds, and one early step takes ~2× while the
allocator grows). Runs go other, port, port, other, ``--rounds`` times,
so both meet the host's drift alike; each round gives one difference
(the mean of its two port runs less the mean of its two other runs), and
the line reports their mean and its 95 % interval (Student's t over the
rounds). With ``--bwd-shape B,S,H,D,causal`` each run then times the
host side of the checkout's own ``flash_attention_bwd`` at that bf16
call (the ms from the call to its return, the card idle before it, over
50 calls after 5 warm-up calls): what the step's host pays for each
backward it launches.

With ``--swap-bwd`` one process trains the port and swaps only the
attention backward: each step runs either the port's
``flash_attention_bwd`` or another build's (an earlier
``flash_attention.cu``, on the ``mma.sync`` route its head dim took
there, called as ``tools/attn_bwd_turns.py`` calls it).  After one
warm-up step of each, ``--pairs`` pairs of steps follow, the order in a
pair drawn from ``--seed``; the line reports each side's median step and
the mean of the pairs' differences with its 95 % interval.  This holds
the process, its allocator and its host threads the same for both
sides, so the runs' spread drops out.

Prints the card's name and power limit first and one JSON line last.
Needs a card.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

RUN = r"""
import json, statistics, sys, time
import torch
sys.path.insert(0, sys.argv[1] + "/src")
from repro_torch.launch import train
ms, last = [], [None]
def on_step(i, state, metrics):
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    now = time.perf_counter()
    if last[0] is not None:
        ms.append((now - last[0]) * 1e3)
    last[0] = now
hist = train.main(sys.argv[3:], on_step=on_step)
host = None
if sys.argv[2]:
    from repro_torch.kernels import flash_attention as fa
    B, S, H, D, causal = (int(a) for a in sys.argv[2].split(","))
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v, do = (torch.randn((B, S, H, D), generator=gen, device="cuda")
                   .to(torch.bfloat16).transpose(1, 2) for _ in range(4))
    o, lse = fa.flash_attention(q, k, v, causal=bool(causal),
                                return_lse=True)
    host = []
    for i in range(55):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fa.flash_attention_bwd(q, k, v, o, lse, do, causal=bool(causal))
        if i >= 5:
            host.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    host = statistics.median(host)
print("STEPS " + json.dumps({"step_ms": ms, "bwd_host_ms": host,
                             "losses": [h["loss"] for h in hist]}))
"""

# Student's t at 97.5 % by degrees of freedom (the next lower entry is
# taken between them)
T975 = {1: 12.706, 2: 4.303, 3: 3.182, 4: 2.776, 5: 2.571, 6: 2.447,
        7: 2.365, 8: 2.306, 9: 2.262, 10: 2.228, 15: 2.131, 20: 2.086,
        30: 2.042, 40: 2.021, 60: 2.000, 120: 1.980}


def interval(diffs: list) -> list:
    """The 95 % interval of the mean of ``diffs`` (Student's t)."""
    t = T975[max(d for d in T975 if d <= len(diffs) - 1)]
    m = statistics.mean(diffs)
    half = t * statistics.stdev(diffs) / len(diffs) ** 0.5
    return [m - half, m + half]


def run(root: str, bwd_shape: str, argv: list) -> dict:
    proc = subprocess.run([sys.executable, "-c", RUN, root, bwd_shape,
                           *argv],
                          capture_output=True, text=True, cwd=root)
    if proc.returncode:
        raise RuntimeError(f"training in {root} failed:\n{proc.stdout}"
                           f"{proc.stderr}")
    line = [ln for ln in proc.stdout.splitlines()
            if ln.startswith("STEPS ")][-1]
    out = json.loads(line[len("STEPS "):])
    out["median_ms_from_2"] = statistics.median(out["step_ms"][1:])
    return out


def swap_run(args, argv: list) -> dict:
    """The port's training in this process, its attention backward
    swapped step by step with ``args.swap_bwd``'s build (module doc)."""
    import random
    import time
    import torch
    sys.path.insert(0, os.path.join(ROOT, "src"))
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import attn_bwd_turns as abt
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as tfa
    from repro_torch.launch import train
    _build.build(["flash_attention"])
    dll = abt.build_other(os.path.abspath(args.swap_bwd), _build.NVCC_FLAGS,
                          "route", "mma_sync")
    port_bwd = tfa.flash_attention_bwd

    def bwd(q, k, v, out, lse, dout, *, causal=True, window=None,
            scale=None):
        if side[0] == "port":
            return port_bwd(q, k, v, out, lse, dout, causal=causal,
                            window=window, scale=scale)
        if (window is not None or scale not in (None, q.shape[-1] ** -0.5)
                or tfa.bwd_route(q, k, v, out, dout) == "f32"):
            raise ValueError("--swap-bwd: the other build is called only "
                             "for bf16, no window, the default scale")
        return abt.other_bwd(torch, tfa, dll, q, k, v, out, lse, dout,
                             causal)
    rng = random.Random(args.seed)
    plan = []
    for _ in range(args.pairs):
        pair = ["other", "port"]
        rng.shuffle(pair)
        plan += pair
    sides = ["port", "other"] + plan   # a warm-up step of each first
    side = [sides[0]]
    ms, last = [], [None]

    def on_step(i, state, metrics):
        torch.cuda.synchronize()
        now = time.perf_counter()
        if last[0] is not None:
            ms.append((now - last[0]) * 1e3)
        last[0] = now
        side[0] = sides[min(len(ms), len(sides) - 1)]
    tfa.flash_attention_bwd = bwd
    try:
        hist = train.main(argv, on_step=on_step)
    finally:
        tfa.flash_attention_bwd = port_bwd
    timed = list(zip(plan, ms[2:]))
    diffs = [(a[1] - b[1]) * (1 if a[0] == "port" else -1)
             for a, b in zip(timed[::2], timed[1::2])]
    row = {"swap_bwd": args.swap_bwd, "step_ms": ms, "sides": sides,
           "losses": [h["loss"] for h in hist],
           "port_minus_other_ms": statistics.mean(diffs),
           "port_minus_other_ms_median": statistics.median(diffs),
           "port_minus_other_ms_95": interval(diffs)}
    for name in ("port", "other"):
        row[f"{name}_median_ms"] = statistics.median(
            m for n, m in timed if n == name)
    return row


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--other-root", help="another checkout of the repo")
    ap.add_argument("--swap-bwd", help="another flash_attention.cu whose "
                    "backward replaces the port's every other step")
    ap.add_argument("--pairs", type=int, default=40)
    ap.add_argument("--arch", default="hubert-xlarge")
    ap.add_argument("--seq", type=int, default=1500)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--bwd-shape", default="",
                    help="B,S,H,D,causal of a bf16 attention backward whose "
                    "host side each run times")
    args = ap.parse_args()
    if (args.other_root is None) == (args.swap_bwd is None):
        ap.error("give --other-root or --swap-bwd")
    import torch
    if not torch.cuda.is_available():
        print("train_turns: needs a CUDA card", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()[0]
    print(smi)
    steps = 2 + 2 * args.pairs if args.swap_bwd else args.steps
    argv = ["--arch", args.arch, "--preset", "full", "--batch", "4",
            "--seq", str(args.seq), "--steps", str(steps),
            "--log-every", str(steps), "--seed", str(args.seed)]
    if args.swap_bwd:
        row = {"card": smi, "arch": args.arch, "seq": args.seq,
               **swap_run(args, argv)}
        row["ok"] = row["losses"][-1] < row["losses"][0]
        print(json.dumps(row))
        return 0 if row["ok"] else 1
    roots = {"other": os.path.abspath(args.other_root), "port": ROOT}
    turns = []
    for _ in range(args.rounds):
        for name in ("other", "port", "port", "other"):
            r = run(roots[name], args.bwd_shape, argv)
            turns.append((name, r["median_ms_from_2"], r["step_ms"],
                          r["losses"][0], r["losses"][-1],
                          r["bwd_host_ms"]))
            print(json.dumps(turns[-1]))
    row = {"card": smi, "arch": args.arch, "seq": args.seq,
           "steps": args.steps, "other_root": args.other_root,
           "turns": turns}
    for name in roots:
        ms = [t[1] for t in turns if t[0] == name]
        row[f"{name}_median_ms"] = statistics.median(ms)
        row[f"{name}_tokens_per_s"] = 4 * args.seq / (
            row[f"{name}_median_ms"] / 1e3)
        if args.bwd_shape:
            row[f"{name}_bwd_host_ms"] = statistics.median(
                t[5] for t in turns if t[0] == name)
    diffs = []
    for r in range(args.rounds):
        four = turns[4 * r:4 * r + 4]
        diffs.append(statistics.mean(t[1] for t in four if t[0] == "port")
                     - statistics.mean(t[1] for t in four
                                       if t[0] == "other"))
    row["port_minus_other_ms_by_round"] = diffs
    row["port_minus_other_ms"] = statistics.mean(diffs)
    if len(diffs) > 1:
        row["port_minus_other_ms_95"] = interval(diffs)
    row["ok"] = all(t[4] < t[3] for t in turns)
    print(json.dumps(row))
    return 0 if row["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
