#!/usr/bin/env python3
"""xLSTM-125M's decode step on one card with the sLSTM kernel and with the
plain cell, in turns in one process.

    python3 tools/slstm_decode_turns.py [--rounds 6] [--steps 32] [--seed 0]

At full width and depth (12 layers, sLSTM at 3 and 9), bf16, batch 4,
after a 1,024-token prefill, ``models.model.decode_step`` runs ``--steps``
times a round on the host clock to a sync, with every sLSTM call taking
``kernel`` (``ops.slstm_scan``: one launch of ``slstm_fwd``, the card's
route) or ``plain`` (``ops.slstm_scan_plain``: the cell's torch ops, what
the card ran before the kernel), in the order kernel, plain, plain,
kernel, ... .  A decode step is host-bound, so this reads what each
route costs the host.  Prints the card's name and power limit first and
one JSON line last: ms a step by route (each round's mean), the medians,
and their tok/s at batch 4.  Needs a card and nvcc.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--steps", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("slstm_decode_turns: needs a card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels import ops
    from repro_torch.launch import serve_lm
    from repro_torch.models import model as M
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip())
    srv = serve_lm.build(serve_lm.parse_args([
        "--arch", "xlstm-125m", "--preset", "full", "--batch", "4",
        "--prompt-len", "1024", "--gen", str(args.steps), "--seed",
        str(args.seed)]))
    cfg = srv.cfg
    routes = {"kernel": ops.slstm_scan, "plain": ops.slstm_scan_plain}
    per_step: dict = {r: [] for r in routes}
    with torch.inference_mode():
        lg, cache = M.prefill(cfg, srv.params, srv.batch,
                              cache_len=srv.cache_len)
        tok = lg[:, :cfg.vocab_size].argmax(-1)
        pos = srv.batch["tokens"].shape[1]

        def run(route: str) -> float:
            ops.slstm_scan = routes[route]
            try:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for i in range(args.steps):
                    M.decode_step(cfg, srv.params, cache, tok, pos + i)
                torch.cuda.synchronize()
                return (time.perf_counter() - t0) * 1e3 / args.steps
            finally:
                ops.slstm_scan = routes["kernel"]
        run("kernel")
        run("plain")                          # warm both
        for r in range(args.rounds):
            order = ("kernel", "plain") if r % 2 == 0 else ("plain", "kernel")
            for route in order:
                per_step[route].append(run(route))
    med = {r: statistics.median(v) for r, v in per_step.items()}
    print(json.dumps({"card": smi.stdout.strip(), "batch": 4,
                      "prompt": 1024, "steps_a_round": args.steps,
                      "ms_a_step": per_step, "median_ms_a_step": med,
                      "tok_per_s_at_median": {r: 4e3 / m
                                              for r, m in med.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
