"""Host-side structured events: the :class:`Recorder`, from the JAX
package's ``obs/events.py``.

The device counters (:mod:`repro_torch.obs.counters`) answer *what the
rounds did*; the Recorder answers *what the host runtime did around
them*: partition rebalances with before/after load spreads, checkpoint
writes, and wall-clock spans around every execution phase.  The port
compiles no program, so it records no ``cache_miss`` event.

Events are typed dicts with a microsecond timestamp relative to the
Recorder's start:

* **instants** — ``{"name", "ph": "i", "ts", "args"}``;
* **spans** — ``{"name", "ph": "X", "ts", "dur", "args"}``, produced by
  the ``span()`` context manager.  A span closes only after everything
  it opened, so exported spans are strictly nested with non-negative
  durations.

Exports: ``to_json_events()`` (the portable list a
:class:`~repro_torch.obs.report.RunReport` carries), JSONL (one event a
line), and the Chrome trace-event format (``chrome://tracing`` /
Perfetto, :func:`chrome_trace`).  ``profiler=True`` also opens a
``torch.profiler.record_function(name)`` range around every span, so the
host phases show up inside a ``torch.profiler`` trace of the card.
Span times are the host's: an eager span ends when its ops are enqueued,
not when the card has run them.
"""
from __future__ import annotations

import contextlib
import json
import time
from typing import List, Optional


class Recorder:
    """Collects typed instants and strictly nested wall-clock spans."""

    def __init__(self, profiler: bool = False):
        self.profiler = profiler
        self._t0 = time.perf_counter_ns()
        self._events: List[dict] = []
        self._stack: List[dict] = []   # open spans (strict nesting)

    def _now_us(self) -> float:
        return (time.perf_counter_ns() - self._t0) / 1e3

    # -- recording -----------------------------------------------------------

    def instant(self, name: str, **args) -> dict:
        """Record a point event (a rebalance, a serving read …)."""
        ev = {"name": name, "ph": "i", "ts": self._now_us(), "args": args}
        self._events.append(ev)
        return ev

    @contextlib.contextmanager
    def span(self, name: str, **args):
        """Record a wall-clock phase span.  Spans opened inside close
        first (context-manager discipline), so the export is strictly
        nested by construction."""
        ev = {"name": name, "ph": "X", "ts": self._now_us(), "dur": 0.0,
              "args": args}
        self._stack.append(ev)
        ann = contextlib.nullcontext()
        if self.profiler:
            import torch.profiler
            ann = torch.profiler.record_function(name)
        try:
            with ann:
                yield ev
        finally:
            ev["dur"] = max(0.0, self._now_us() - ev["ts"])
            self._stack.pop()
            self._events.append(ev)

    # -- export --------------------------------------------------------------

    def to_json_events(self) -> List[dict]:
        """The portable event list (instants + completed spans), sorted
        by start time — what a RunReport carries and the JSONL/Chrome
        exports derive from."""
        return sorted((dict(ev) for ev in self._events),
                      key=lambda e: (e["ts"], -e.get("dur", 0.0)))

    def write_jsonl(self, path: str) -> str:
        return write_jsonl(self.to_json_events(), path)

    def write_chrome_trace(self, path: str) -> str:
        return write_chrome_trace(self.to_json_events(), path)


# ---------------------------------------------------------------------------
# Format helpers (usable on saved event lists too — the trace CLI)
# ---------------------------------------------------------------------------

def write_jsonl(events: List[dict], path: str) -> str:
    """One event dict a line."""
    with open(path, "w") as f:
        for ev in events:
            f.write(json.dumps(ev) + "\n")
    return path


def chrome_trace(events: List[dict], pid: int = 0, tid: int = 0) -> dict:
    """The Chrome trace-event JSON (``chrome://tracing`` / Perfetto):
    spans become complete ("X") events, instants stay instant ("i")
    events, timestamps and durations in microseconds."""
    out = []
    for ev in events:
        rec = {"name": ev["name"], "ph": ev.get("ph", "i"),
               "ts": ev["ts"], "pid": pid, "tid": tid,
               "cat": "strads", "args": ev.get("args", {})}
        if rec["ph"] == "X":
            rec["dur"] = ev.get("dur", 0.0)
        else:
            rec["s"] = "t"
        out.append(rec)
    return {"traceEvents": out, "displayTimeUnit": "ms"}


def write_chrome_trace(events: List[dict], path: str,
                       pid: int = 0, tid: int = 0) -> str:
    with open(path, "w") as f:
        json.dump(chrome_trace(events, pid=pid, tid=tid), f, indent=1)
    return path


def validate_spans(events: List[dict]) -> Optional[str]:
    """``None`` when every span has a non-negative duration and the span
    set is strictly nested (any two spans are disjoint or one contains
    the other); else a readable reason — the ``launch/trace --check``
    predicate."""
    spans = [ev for ev in events if ev.get("ph") == "X"]
    for ev in spans:
        if ev.get("dur", 0.0) < 0.0:
            return f"span {ev['name']!r} has negative duration {ev['dur']}"
        if ev.get("ts", 0.0) < 0.0:
            return f"span {ev['name']!r} starts before the run ({ev['ts']})"
    spans = sorted(spans, key=lambda e: (e["ts"], -e["dur"]))
    stack: List[dict] = []
    for ev in spans:
        while stack and ev["ts"] >= stack[-1]["ts"] + stack[-1]["dur"]:
            stack.pop()
        if stack:
            parent = stack[-1]
            if ev["ts"] + ev["dur"] > parent["ts"] + parent["dur"]:
                return (f"span {ev['name']!r} overlaps its enclosing "
                        f"{parent['name']!r} without nesting inside it")
        stack.append(ev)
    return None


__all__ = ["Recorder", "chrome_trace", "validate_spans",
           "write_chrome_trace", "write_jsonl"]
