"""The device trace of a measured window and its reduction.

:class:`Session` wraps the window in a ``torch.profiler`` session.  A
session on the card loses kernel records near its start, more the older
the process, while the launch calls' own records are kept; so before the
window it launches a lead guard of empty kernels (``GUARD_SPACED``, each
waited for and ``GUARD_GAP_S`` apart, then ``GUARD_PRIMERS`` back to
back) and after it ``GUARD_TAIL`` more.  The technique is
``chip_smoke.py::profile_window``'s at commit 8dacd7b (its constants
``PROFILE_SPACED``, ``PROFILE_GAP_S``, ``PROFILE_PRIMERS`` and
``PROFILE_TAIL``); this copy takes the window once and reports what was
lost instead of taking it again.

:func:`reduce` turns the session's events into what the per-layer
readers take: the window's length, the seconds in which an operation ran
on the device, its launch calls, device time by operation, and the idle
gaps by what the host was doing.
"""
from __future__ import annotations

import bisect
import contextlib
import dataclasses
import time
from typing import Dict, List, Optional, Tuple

GUARD_SPACED = 32
GUARD_GAP_S = 1e-3
GUARD_PRIMERS = 512
GUARD_TAIL = 64

WINDOW = "portbench.window"
#: the host phases the window marks (``portbench.<phase>``)
PREFIX = "portbench."
#: launch calls of the CUDA runtime and driver
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx", "cudaLaunchCooperativeKernel",
                "cudaGraphLaunch", "cuGraphLaunch")
#: idle gaps labelled one by one, longest first; the rest are summed
LABELLED_GAPS = 500


@dataclasses.dataclass
class Event:
    """One profiler record: ``cpu`` (host op, range or API call) or
    ``device`` (kernel, copy, fill), times in ns on one clock."""
    kind: str
    name: str
    start: int
    dur: int
    corr: int = 0

    @property
    def end(self) -> int:
        return self.start + self.dur


@dataclasses.dataclass
class Reduced:
    window_s: float
    busy_s: float
    launches: int
    lost: int
    ops: Dict[str, Tuple[float, int]]          # name -> (seconds, count)
    gaps: List[Tuple[str, float]]              # host label -> seconds


class Session:
    """``with Session(torch) as s: ... with s.window(): <window>``; then
    ``s.events()``."""

    def __init__(self, torch):
        self.torch = torch
        self._prof = None

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile
        torch = self.torch
        torch.cuda.synchronize()
        self._prof = profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA])
        self._prof.__enter__()
        for _ in range(GUARD_SPACED):
            torch.cuda._sleep(0)
            torch.cuda.synchronize()
            time.sleep(GUARD_GAP_S)
        for _ in range(GUARD_PRIMERS):
            torch.cuda._sleep(0)
        torch.cuda.synchronize()
        return self

    @contextlib.contextmanager
    def window(self):
        from torch.profiler import record_function
        with record_function(WINDOW):
            yield
            self.torch.cuda.synchronize()

    def __exit__(self, *exc):
        torch = self.torch
        for _ in range(GUARD_TAIL):
            torch.cuda._sleep(0)
        torch.cuda.synchronize()
        return self._prof.__exit__(*exc)

    def events(self) -> List[Event]:
        from torch.autograd import DeviceType
        out = []
        for e in self._prof.profiler.kineto_results.events():
            kind = "device" if e.device_type() == DeviceType.CUDA else (
                "cpu" if e.device_type() == DeviceType.CPU else None)
            if kind is not None:
                out.append(Event(kind, e.name(), e.start_ns(),
                                 e.duration_ns(), e.correlation_id()))
        return out


def mark(name: Optional[str]):
    """A ``portbench.<name>`` range in a traced window, else nothing."""
    if name is None:
        return contextlib.nullcontext()
    from torch.profiler import record_function
    return record_function(PREFIX + name)


def _union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[List[int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def _innermost(evs: List[Event], starts: List[int], t: int,
               limit: int = 4096) -> Optional[Event]:
    """The record open at ``t`` that started last (``evs`` sorted by
    start, ``starts`` their starts), looking back at most ``limit``."""
    i = bisect.bisect_right(starts, t)
    for e in reversed(evs[max(0, i - limit):i]):
        if e.end > t:
            return e
    return None


def _label(phases, pstarts, others, ostarts, t: int) -> str:
    """What the host was doing at ``t``: the innermost ``portbench.``
    phase and the innermost other host record open then."""
    p = _innermost(phases, pstarts, t)
    o = _innermost(others, ostarts, t)
    return (f"{p.name[len(PREFIX):] if p else 'none'}: "
            f"{o.name if o else 'idle'}")


def reduce(events: List[Event]) -> Reduced:
    """The window's numbers from a :class:`Session`'s events."""
    win = [e for e in events if e.kind == "cpu" and e.name == WINDOW]
    if not win:
        raise RuntimeError("the trace holds no measured window")
    lo, hi = win[0].start, win[0].end
    cpu = sorted((e for e in events if e.kind == "cpu"
                  and lo <= e.start <= hi), key=lambda e: e.start)
    calls = {e.corr for e in cpu if e.name.startswith("cu") and e.corr}
    launches = [e.corr for e in cpu if e.name in LAUNCH_CALLS]
    # a host range (record_function) is mirrored on the device under its
    # own name: no operation ran there
    host_names = {e.name for e in cpu}
    dev = [e for e in events if e.kind == "device" and e.corr in calls
           and e.name not in host_names]
    kept = {e.corr for e in dev}
    ops: Dict[str, Tuple[float, int]] = {}
    for e in dev:
        s, c = ops.get(e.name, (0.0, 0))
        ops[e.name] = (s + e.dur / 1e9, c + 1)
    busy = _union([(max(e.start, lo), min(e.end, hi)) for e in dev
                   if e.end > lo and e.start < hi])
    busy_s = sum(e - s for s, e in busy) / 1e9
    edges = [lo] + [x for iv in busy for x in iv] + [hi]
    gaps = sorted(((edges[i + 1] - edges[i], edges[i])
                   for i in range(0, len(edges), 2)
                   if edges[i + 1] > edges[i]), reverse=True)
    phases = [e for e in cpu
              if e.name.startswith(PREFIX) and e.name != WINDOW]
    others = [e for e in cpu if not e.name.startswith(PREFIX)]
    pstarts = [e.start for e in phases]
    ostarts = [e.start for e in others]
    by_label: Dict[str, float] = {}
    for dur, start in gaps[:LABELLED_GAPS]:
        lab = _label(phases, pstarts, others, ostarts, start + dur // 2)
        by_label[lab] = by_label.get(lab, 0.0) + dur / 1e9
    rest = sum(d for d, _ in gaps[LABELLED_GAPS:]) / 1e9
    if rest:
        by_label["shorter gaps"] = by_label.get("shorter gaps", 0.0) + rest
    return Reduced(window_s=(hi - lo) / 1e9, busy_s=busy_s,
                   launches=len(launches),
                   lost=sum(c not in kept for c in launches),
                   ops=ops,
                   gaps=sorted(by_label.items(), key=lambda kv: -kv[1]))
