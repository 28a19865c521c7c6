"""Summarize, validate, and re-export saved telemetry artifacts, from
the JAX package's ``launch/trace.py``.

    PYTHONPATH=src python -m repro_torch.launch.trace <artifact.json> [...]
    PYTHONPATH=src python -m repro_torch.launch.trace <artifact.json> --check
    PYTHONPATH=src python -m repro_torch.launch.trace <artifact.json> \
        --chrome out.trace.json --jsonl out.jsonl

An artifact is any JSON file carrying a
:class:`~repro_torch.obs.report.RunReport` — a bare ``report.to_json()``
dump, or a record that embeds one anywhere (the JAX package's dry-run
``"run_report"``, a benchmark entry's ``"telemetry"``).  The report JSON
is the same in both packages, so either package's reports read here.
The CLI prints each report's
:meth:`~repro_torch.obs.report.RunReport.summary` and, with ``--check``,
enforces the observability contract offline:

* the file parses and the spec round-trips
  (:func:`~repro_torch.obs.report.report_from_json`);
* the device-counter identities hold — per-phase round totals sum to
  the run's rounds and the ρ-filter ledger balances
  (``accepted + killed == proposed``, all non-negative);
* the host event log is strictly nested with non-negative durations
  (:func:`~repro_torch.obs.events.validate_spans`) — exactly what a Chrome
  trace viewer needs to render it as a flame graph.

``--chrome``/``--jsonl`` re-export the (first) report's event log; the
Chrome file loads in ``chrome://tracing`` / Perfetto.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import sys
from typing import List, Optional, Tuple

from ..obs.events import validate_spans, write_chrome_trace, write_jsonl
from ..obs.report import RunReport, report_from_json


def extract_report_dicts(obj) -> List[dict]:
    """Every RunReport dict found in a loaded artifact — the object
    itself when it *is* one (a ``to_json()`` dump has spec + executor +
    counters), else a full recursive walk, so embedded sections (a
    dry-run record's ``"run_report"``, a benchmark entry's
    ``"telemetry"``) are found wherever the artifact put them."""
    if isinstance(obj, dict):
        if ("spec" in obj and "executor" in obj and "counters" in obj
                and isinstance(obj["spec"], dict)):
            return [obj]
        return [d for v in obj.values()
                for d in extract_report_dicts(v)]
    if isinstance(obj, list):
        return [d for item in obj for d in extract_report_dicts(item)]
    return []


def check_report(rep: RunReport) -> Optional[str]:
    """``None`` when the report honors the counter identities and the
    span-nesting contract, else the first violated clause."""
    c = rep.counters
    if c:
        for k in ("rounds", "sched_size", "proposed", "accepted",
                  "killed"):
            if c.get(k, 0) < 0:
                return f"counter {k!r} is negative ({c[k]})"
        if sum(c.get("rounds_per_phase", [])) != c.get("rounds", 0):
            return (f"phase-counter totals {c['rounds_per_phase']} do "
                    f"not sum to rounds {c['rounds']}")
        if c.get("accepted", 0) + c.get("killed", 0) != \
                c.get("proposed", 0):
            return (f"rho-filter ledger unbalanced: accepted "
                    f"{c['accepted']} + killed {c['killed']} != proposed "
                    f"{c['proposed']}")
    err = validate_spans(rep.events)
    if err is not None:
        return err
    if rep.ssp is not None:
        hist = [int(v) for v in rep.ssp.hist]
        if any(v < 0 for v in hist):
            return f"ssp staleness histogram has negative bins {hist}"
        if c and sum(hist) != c.get("rounds", 0):
            return (f"ssp staleness histogram covers {sum(hist)} rounds "
                    f"but the counters ran {c['rounds']}")
    return None


def load_reports(path: str) -> Tuple[List[RunReport], Optional[str]]:
    """(reports, error) for one artifact file — parse errors come back
    as the error string instead of raising, so --check can report them
    uniformly."""
    try:
        with open(path) as f:
            obj = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        return [], f"unreadable ({e})"
    dicts = extract_report_dicts(obj)
    if not dicts:
        return [], "no RunReport section found"
    try:
        return [report_from_json(d) for d in dicts], None
    except (KeyError, ValueError, TypeError) as e:
        return [], f"malformed RunReport ({e!r})"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Summarize (and --check) the RunReport telemetry "
                    "recorded in saved artifact JSON files.")
    ap.add_argument("paths", nargs="+",
                    help="artifact JSON paths or globs")
    ap.add_argument("--check", action="store_true",
                    help="exit 1 unless every report parses, its counter "
                         "identities hold, and its spans are strictly "
                         "nested with non-negative durations")
    ap.add_argument("--chrome", default="",
                    help="write the first report's event log as a Chrome "
                         "trace-event file (chrome://tracing / Perfetto)")
    ap.add_argument("--jsonl", default="",
                    help="write the first report's event log as JSONL")
    args = ap.parse_args(argv)

    files: List[str] = []
    for p in args.paths:
        hits = sorted(glob.glob(p))
        files.extend(hits if hits else [p])

    bad: List[str] = []
    first: Optional[RunReport] = None
    for path in files:
        name = os.path.basename(path)
        reports, err = load_reports(path)
        if err is not None:
            print(f"{name}: {err}")
            bad.append(name)
            continue
        for rep in reports:
            if first is None:
                first = rep
            verdict = check_report(rep)
            print(f"{name}:")
            for line in rep.summary().splitlines():
                print(f"  {line}")
            if verdict is None:
                print("  [ok]")
            else:
                print(f"  [INVALID: {verdict}]")
                bad.append(name)
    if not files:
        print("no artifacts matched")
        return 1
    if first is not None:
        if args.chrome:
            print(f"chrome trace → "
                  f"{write_chrome_trace(first.events, args.chrome)}")
        if args.jsonl:
            print(f"jsonl → {write_jsonl(first.events, args.jsonl)}")
    elif args.chrome or args.jsonl:
        print("nothing to export: no report parsed")
        return 1
    if args.check and bad:
        print(f"--check failed: {len(bad)}/{len(files)} artifact(s) "
              f"with missing, malformed, or invalid telemetry: "
              f"{sorted(set(bad))}")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
