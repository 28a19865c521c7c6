"""Host-side structured events: the :class:`Recorder`, from the JAX
package's ``obs/events.py``.

The device counters (:mod:`repro_torch.obs.counters`) answer *what the
rounds did*; the Recorder answers *what the host runtime did around
them*: partition rebalances with before/after load spreads, checkpoint
writes, wall-clock spans around every execution phase, and timers of
the phases of every round.  The port compiles no program, so it records
no ``cache_miss`` event.

Events are typed dicts with a microsecond timestamp from the Recorder's
origin (:attr:`Recorder.origin_ns`, the epoch clock that
``torch.profiler`` events carry, read together with the monotonic clock
the Recorder stamps by):

* **instants** — ``{"name", "ph": "i", "ts", "args"}``;
* **spans** — ``{"name", "ph": "X", "ts", "dur", "args", "id",
  "parent"}``, produced by the ``span()`` context manager.  ``id`` is
  the span's number in its Recorder and ``parent`` the ``id`` of the
  span open around it (``None`` at the top).  A span closes only after
  everything it opened, so exported spans are strictly nested with
  non-negative durations.  A span opened with ``device=True`` also
  carries ``device_dur``: the µs between two CUDA events recorded on
  the current stream at its open and close (``None`` off CUDA).  Callers
  may set more top-level keys on the dict the span yields.

**Timers** (:meth:`Recorder.timer`) are for work too frequent to keep as
events (the phases of every round): a count, the host seconds and the
device seconds (CUDA events, as above) a name, read by
:meth:`Recorder.timers`.  They are not events, so a
:class:`~repro_torch.obs.report.RunReport` never carries them.

Every span and timer opens a ``torch.profiler.record_function`` range
named ``strads.<name>`` when the Recorder has ``profiler=True`` or a
profiler session is live, so the host phases show up inside a
``torch.profiler`` trace of the card.  No range is opened otherwise (a
range costs ~10 µs even with no session).  Span times are the host's:
an eager span ends when its ops are enqueued, not when the card has run
them; ``device_dur`` and the timers' device seconds are the card's.
CUDA events are resolved only on export or when the timers are read,
never in between, so recording costs no host sync.

Exports: ``to_json_events()`` (the portable list a
:class:`~repro_torch.obs.report.RunReport` carries, times from the
origin), JSONL (one event a line), and the Chrome trace-event format
(``chrome://tracing`` / Perfetto, :func:`chrome_trace`);
:meth:`Recorder.write_chrome_trace` writes absolute µs on the epoch
clock, which a ``torch.profiler`` export's ``ts`` are after adding its
``baseTimeNanoseconds``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import time
from typing import Dict, List, Optional

import torch
import torch.autograd.profiler as _autograd_profiler

#: the prefix of the ``record_function`` ranges that mirror spans and
#: timers on a profiler's trace
RANGE_PREFIX = "strads."
#: pending device intervals a timer keeps before folding completed ones
_FOLD_AT = 4096


_NULL_CTX = contextlib.nullcontext()


def no_timer(name: str, n: int = 1):
    """:meth:`Recorder.timer`'s shape with no Recorder: a no-op."""
    return _NULL_CTX


def profiler_live() -> bool:
    """True while a ``torch.profiler`` (or autograd profiler) session is
    recording — one flag read."""
    return _autograd_profiler._is_profiler_enabled


def _device_mark():
    """A timing event recorded on the current CUDA stream, or ``None``
    when the process has not initialised CUDA."""
    if not torch.cuda.is_initialized():
        return None
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


def _elapsed_s(start, end) -> float:
    return start.elapsed_time(end) / 1e3


@dataclasses.dataclass
class _TimerStat:
    count: int = 0
    host_ns: int = 0
    device_s: float = 0.0
    on_device: bool = False
    pending: list = dataclasses.field(default_factory=list)

    def fold(self, block: bool) -> None:
        """Add the device time of the pending intervals that have
        completed (all of them, after a sync, when ``block``)."""
        if block and self.pending:
            self.pending[-1][1].synchronize()
        done = 0
        for start, end in self.pending:
            if not block and not end.query():
                break
            self.device_s += _elapsed_s(start, end)
            done += 1
        del self.pending[:done]


class Recorder:
    """Collects typed instants, strictly nested wall-clock spans, and
    per-name timers, on one clock with an epoch origin."""

    def __init__(self, profiler: bool = False):
        self.profiler = profiler
        a = time.perf_counter_ns()
        #: the epoch ns (``time.time_ns``, the clock of ``torch.profiler``
        #: events) at which ``ts`` is 0
        self.origin_ns = time.time_ns()
        self._t0 = (a + time.perf_counter_ns()) // 2
        self._events: List[dict] = []
        self._stack: List[dict] = []   # open spans (strict nesting)
        self._next_id = 0
        self._device_spans: List[tuple] = []   # (ev, start, end) to resolve
        self._timers: Dict[str, _TimerStat] = {}

    def _now_us(self) -> float:
        return (time.perf_counter_ns() - self._t0) / 1e3

    def _mirror(self, name: str):
        if self.profiler or _autograd_profiler._is_profiler_enabled:
            return torch.profiler.record_function(RANGE_PREFIX + name)
        return _NULL_CTX

    # -- recording -----------------------------------------------------------

    def instant(self, name: str, **args) -> dict:
        """Record a point event (a rebalance, a serving read …)."""
        ev = {"name": name, "ph": "i", "ts": self._now_us(), "args": args}
        self._events.append(ev)
        return ev

    @contextlib.contextmanager
    def span(self, name: str, device: bool = False, **args):
        """Record a wall-clock phase span (and with ``device=True`` its
        device time).  Spans opened inside close first (context-manager
        discipline), so the export is strictly nested by construction."""
        ev = {"name": name, "ph": "X", "ts": self._now_us(), "dur": 0.0,
              "args": args, "id": self._next_id,
              "parent": self._stack[-1]["id"] if self._stack else None}
        self._next_id += 1
        self._stack.append(ev)
        start = _device_mark() if device else None
        try:
            with self._mirror(name):
                yield ev
        finally:
            if device:
                self._device_spans.append(
                    (ev, start, _device_mark() if start is not None else None))
            ev["dur"] = max(0.0, self._now_us() - ev["ts"])
            self._stack.pop()
            self._events.append(ev)

    @contextlib.contextmanager
    def timer(self, name: str, n: int = 1):
        """Time one interval of ``name``: its host time, and on CUDA its
        device time.  ``n`` is what the interval adds to the count (an
        SSP window's schedules time ``s + 1`` rounds at once)."""
        stat = self._timers.get(name)
        if stat is None:
            stat = self._timers[name] = _TimerStat()
        with self._mirror(name):
            start = _device_mark()
            t0 = time.perf_counter_ns()
            try:
                yield
            finally:
                stat.host_ns += time.perf_counter_ns() - t0
                stat.count += n
                if start is not None:
                    stat.on_device = True
                    stat.pending.append((start, _device_mark()))
                    if len(stat.pending) >= _FOLD_AT:
                        stat.fold(block=False)

    # -- reading -------------------------------------------------------------

    @property
    def num_events(self) -> int:
        """Events completed so far (``to_json_events(start=)`` skips
        them)."""
        return len(self._events)

    def timers(self) -> Dict[str, dict]:
        """``{name: {"count", "host_s", "device_s"}}`` of every timer
        (``device_s`` is ``None`` off CUDA).  Waits for the device to
        reach the last interval's end."""
        out = {}
        for name, st in self._timers.items():
            st.fold(block=True)
            out[name] = {"count": st.count, "host_s": st.host_ns / 1e9,
                         "device_s": st.device_s if st.on_device else None}
        return out

    # -- export --------------------------------------------------------------

    def to_json_events(self, start: int = 0) -> List[dict]:
        """The portable event list (instants + completed spans), sorted
        by start time — what a RunReport carries and the JSONL/Chrome
        exports derive from.  ``start`` skips the events completed
        before the Recorder held that many (one ``execute``'s events on
        a Recorder that outlives it)."""
        for ev, a, b in self._device_spans:
            ev["device_dur"] = None
            if a is not None:
                b.synchronize()
                ev["device_dur"] = _elapsed_s(a, b) * 1e6
        self._device_spans.clear()
        return sorted((dict(ev) for ev in self._events[start:]),
                      key=lambda e: (e["ts"], -e.get("dur", 0.0)))

    def write_jsonl(self, path: str) -> str:
        return write_jsonl(self.to_json_events(), path)

    def write_chrome_trace(self, path: str) -> str:
        """The Chrome trace at absolute epoch µs, to lay over a
        ``torch.profiler`` export of the same process."""
        return write_chrome_trace(self.to_json_events(), path,
                                  origin_us=self.origin_ns / 1e3)


# ---------------------------------------------------------------------------
# Format helpers (usable on saved event lists too — the trace CLI)
# ---------------------------------------------------------------------------

#: top-level keys of an event shown among a Chrome event's args
_CHROME_EXTRA = ("id", "parent", "device_dur", "requests", "waits_us")


def write_jsonl(events: List[dict], path: str) -> str:
    """One event dict a line."""
    with open(path, "w") as f:
        for ev in events:
            f.write(json.dumps(ev) + "\n")
    return path


def chrome_trace(events: List[dict], pid: int = 0, tid: int = 0,
                 origin_us: float = 0.0) -> dict:
    """The Chrome trace-event JSON (``chrome://tracing`` / Perfetto):
    spans become complete ("X") events, instants stay instant ("i")
    events, timestamps (plus ``origin_us``) and durations in
    microseconds."""
    out = []
    for ev in events:
        args = dict(ev.get("args", {}))
        args.update((k, ev[k]) for k in _CHROME_EXTRA if k in ev)
        rec = {"name": ev["name"], "ph": ev.get("ph", "i"),
               "ts": ev["ts"] + origin_us, "pid": pid, "tid": tid,
               "cat": "strads", "args": args}
        if rec["ph"] == "X":
            rec["dur"] = ev.get("dur", 0.0)
        else:
            rec["s"] = "t"
        out.append(rec)
    return {"traceEvents": out, "displayTimeUnit": "ms"}


def write_chrome_trace(events: List[dict], path: str,
                       pid: int = 0, tid: int = 0,
                       origin_us: float = 0.0) -> str:
    with open(path, "w") as f:
        json.dump(chrome_trace(events, pid=pid, tid=tid,
                               origin_us=origin_us), f, indent=1)
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


__all__ = ["RANGE_PREFIX", "Recorder", "chrome_trace", "no_timer",
           "profiler_live", "validate_spans", "write_chrome_trace",
           "write_jsonl"]
