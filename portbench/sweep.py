"""Find a serving cell's knee: one window at each offered rate, each in a
process of its own as a benchmark run is, on the card.

    python3 portbench/sweep.py --workload <name> --rates 100,200,400 \
        --seconds 20 [--seed <n>]

For each rate it prints one JSON line: the queries due, the share
answered before the window's closing boundary, p50 and p95 from due to
ready, the backlog (queries waiting at a boundary, before its flush) over
the window's middle and last thirds, and the rounds/s trained.  The knee
is the highest rate that

- answers at least 99 % of the queries due before the closing boundary;
- has no growing backlog: the last third's mean no longer than the
  middle third's by more than a quarter and a batch (the queue at a
  boundary holds a cycle's arrivals, and the cycles of a sound window
  drift by some percent);
- keeps its p95 within 1.5 × the p95 at the lowest rate swept, the
  latency limit (at the lowest rate a query waits about one boundary
  cycle).

Its last line is ``{"workload", "knee_rate_per_s"}``.  Not part of a
benchmark run; 0.8 × the knee is the rate written into the traffic file.
"""
import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
LATENCY_LIMIT = 1.5


def backlog(pending):
    """(middle third's mean, last third's mean) of the queue lengths."""
    n = len(pending)
    if n < 3:
        return float(pending[0]) if pending else 0.0, \
            float(pending[-1]) if pending else 0.0
    mid = pending[n // 3: 2 * n // 3]
    end = pending[2 * n // 3:]
    return sum(mid) / len(mid), sum(end) / len(end)


def one(workload: str, rate: float, seconds: float, seed: int) -> dict:
    """One window at ``rate`` in this process."""
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import numpy as np
    from portbench import harness, traffic
    entry = harness.cell_entry(harness.load_benchmark(), workload)
    mix = traffic.load(entry["traffic"])
    mix["arrivals"]["rate_per_s"] = rate
    run = harness.Run(workload, seed, seconds, False, mix=mix)
    win = run.measure()
    lat = win.latencies_ms
    done = lat[~np.isnan(lat)]
    mid, end = backlog(win.pending)
    return {"workload": workload, "rate_per_s": rate, "due": win.due,
            "answered_before_close": win.answered_open / max(win.due, 1),
            "answered": win.answered / max(win.due, 1),
            "p50_ms": float(np.median(done)) if done.size else None,
            "p95_ms": harness.p95(lat),
            "backlog_middle": mid, "backlog_end": end,
            "growing": bool(end > 1.25 * mid
                            + run.frontend.spec.max_batch),
            "boundaries": len(win.pending),
            "rounds_per_s": win.rounds / win.seconds,
            "window_s": win.seconds,
            "late_submit_ms": float(win.late_submit_ms)}


def knee(records: list):
    """The highest rate that meets the three conditions above."""
    if not records:
        return None
    limit = LATENCY_LIMIT * min(records, key=lambda r: r["rate_per_s"])[
        "p95_ms"]
    ok = [r["rate_per_s"] for r in records
          if r["answered_before_close"] >= 0.99 and not r["growing"]
          and r["p95_ms"] <= limit]
    return max(ok) if ok else None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--seed", type=int, default=20_000_000_011)
    ap.add_argument("--one", action="store_true",
                    help="measure the single rate given in this process")
    args = ap.parse_args(argv)
    rates = [float(r) for r in args.rates.split(",")]
    if args.one:
        print(json.dumps(one(args.workload, rates[0], args.seconds,
                             args.seed)), flush=True)
        return 0
    records = []
    for rate in rates:
        out = subprocess.run(
            [sys.executable, __file__, "--one", "--workload", args.workload,
             "--rates", str(rate), "--seconds", str(args.seconds), "--seed",
             str(args.seed)], capture_output=True, text=True, timeout=900)
        if out.returncode:
            print(out.stderr[-2000:], file=sys.stderr)
            continue
        line = out.stdout.strip().splitlines()[-1]
        records.append(json.loads(line))
        print(line, flush=True)
    print(json.dumps({"workload": args.workload,
                      "knee_rate_per_s": knee(records)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
