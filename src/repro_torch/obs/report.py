"""The uniform per-run metrics surface: :class:`RunReport`, from the JAX
package's ``obs/report.py``.

``ExecutionReport.telemetry`` is one of these for every executor
whenever the plan carries a :class:`~repro_torch.obs.spec.TelemetrySpec`:
the resolved spec, the device counters summarized to host ints, the host
event log (``kind="trace"``), and for SSP runs the
:class:`~repro_torch.ps.telemetry.SSPTelemetry` staleness and byte
section (per-chunk summaries merged).

A RunReport is JSON-first, and its JSON is the JAX package's key for
key: a report written by either package reads in the other's trace CLI
(``python -m repro_torch.launch.trace``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, List

from .counters import summarize_counters
from .events import write_chrome_trace, write_jsonl
from .spec import TelemetrySpec


@dataclasses.dataclass
class RunReport:
    """One instrumented run, summarized uniformly across executors.

    spec:      the resolved :class:`TelemetrySpec` of the run.
    executor:  the plan's executor name.
    rounds:    rounds the plan executed.
    counters:  host-int summary of the device counters (see
               :func:`repro_torch.obs.counters.summarize_counters`).
    events:    the host event log (instants + strictly nested spans,
               microsecond timestamps); ``[]`` under ``kind="counters"``.
    ssp:       the :class:`repro_torch.ps.telemetry.SSPTelemetry`
               section (staleness histogram + byte accounting); ``None``
               for the BSP executors.
    """
    spec: TelemetrySpec
    executor: str
    rounds: int
    counters: dict = dataclasses.field(default_factory=dict)
    events: List[dict] = dataclasses.field(default_factory=list)
    ssp: Any = None

    @classmethod
    def build(cls, spec: TelemetrySpec, executor: str, rounds: int,
              device_counters: Any = None, recorder: Any = None,
              ssp: Any = None, first_event: int = 0) -> "RunReport":
        """Assemble from the run's raw pieces: the device counters off the
        final carry, the live Recorder (or None) with the number of its
        events that came before the run, and the SSP summary (or
        None)."""
        return cls(spec=spec, executor=executor, rounds=rounds,
                   counters=summarize_counters(device_counters),
                   events=(recorder.to_json_events(first_event)
                           if recorder is not None else []),
                   ssp=ssp)

    # -- export --------------------------------------------------------------

    def to_json(self) -> dict:
        return {"spec": self.spec.to_json(),
                "executor": self.executor,
                "rounds": self.rounds,
                "counters": dict(self.counters),
                "events": [dict(ev) for ev in self.events],
                "ssp": self.ssp.to_json() if self.ssp is not None
                else None}

    def summary(self) -> str:
        """One line a layer — what the trace CLI prints."""
        lines = [f"{self.executor}: {self.rounds} rounds "
                 f"(telemetry kind={self.spec.kind!r})"]
        c = self.counters
        if c:
            lines.append(
                f"  counters: rounds/phase {c['rounds_per_phase']}  "
                f"sched_size {c['sched_size']}  rho-filter "
                f"{c['accepted']}/{c['proposed']} kept "
                f"({c['killed']} killed)")
        if self.events:
            spans = [e for e in self.events if e.get("ph") == "X"]
            inst = len(self.events) - len(spans)
            lines.append(f"  events: {len(spans)} spans, {inst} "
                         f"instants")
            for e in spans:
                if not _enclosed(e, spans):
                    lines.append(f"    {e['name']}: "
                                 f"{e['dur'] / 1e3:.2f} ms")
        if self.ssp is not None:
            s = self.ssp
            lines.append(
                f"  ssp: staleness<= {s.max_staleness}/"
                f"{s.staleness_bound}  hist {list(map(int, s.hist))}  "
                f"flushes {s.flushes}  pushed {s.bytes_pushed}B")
        return "\n".join(lines)

    def write_jsonl(self, path: str) -> str:
        return write_jsonl(self.events, path)

    def write_chrome_trace(self, path: str) -> str:
        return write_chrome_trace(self.events, path)


def _enclosed(ev: dict, spans: List[dict]) -> bool:
    return any(o is not ev and o["ts"] <= ev["ts"]
               and ev["ts"] + ev["dur"] <= o["ts"] + o["dur"]
               for o in spans)


def report_from_json(obj: dict) -> RunReport:
    """Rebuild a RunReport from ``to_json()`` output (the SSP section
    stays a plain dict, readable as attributes); the trace CLI uses this
    to summarize, check and re-export saved artifacts."""
    spec = TelemetrySpec.from_json(obj["spec"])
    return RunReport(spec=spec, executor=obj["executor"],
                     rounds=int(obj["rounds"]),
                     counters=dict(obj.get("counters") or {}),
                     events=list(obj.get("events") or []),
                     ssp=_DictSection(obj["ssp"]) if obj.get("ssp")
                     else None)


class _DictSection:
    """A saved SSP section, readable as attributes for summary()."""

    def __init__(self, d: dict):
        self._d = dict(d)

    def __getattr__(self, name):
        try:
            return self._d[name]
        except KeyError:
            raise AttributeError(name) from None

    def to_json(self) -> dict:
        return dict(self._d)


__all__ = ["RunReport", "report_from_json"]
