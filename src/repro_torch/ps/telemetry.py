"""SSP telemetry: the staleness histogram of the reads served and push
and pull byte accounting, from the JAX package's ``ps/telemetry.py``.

The histogram half (``staleness_init``/``observe_read``) lives in
:mod:`repro_torch.obs.counters`, as in the JAX package, and is
re-exported here under its historical names.  The port's round counter
and cache clock are host ints, so the histogram counts, on the host, the
reads the executor actually served: that is what the staleness-invariant
tests assert over.  Byte counts come from the shapes of the partials and
the server's leaves.  Under a plan-level
:class:`~repro_torch.obs.spec.TelemetrySpec` an :class:`SSPTelemetry`
becomes the ``ssp`` section of the run's
:class:`~repro_torch.obs.report.RunReport`, and chunked
(``checkpoint_every``) runs merge their per-chunk summaries with
:func:`merge_summaries`.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np

from ..obs.counters import observe_read, staleness_init

__all__ = ["SSPTelemetry", "device_init", "observe_read", "staleness_init",
           "summarize", "merge_summaries"]

# historical name of the relocated histogram half (repro_torch.obs.counters)
device_init = staleness_init


@dataclasses.dataclass
class SSPTelemetry:
    """One SSP run, summarized."""
    staleness_bound: int
    rounds: int
    flushes: int
    hist: np.ndarray          # rounds whose reads were k clocks stale
    max_staleness: int        # observed; must be <= staleness_bound
    clocks: np.ndarray        # final per-worker vector clock
    bytes_pushed: int         # partial-update bytes summed at flushes
    bytes_deferred_peak: int  # largest pending buffer between flushes
    bytes_pulled: int         # server bytes refreshed into worker caches

    def to_json(self) -> dict:
        d = dataclasses.asdict(self)
        d["hist"] = [int(v) for v in self.hist]
        d["clocks"] = [int(v) for v in self.clocks]
        return d


def summarize(telem: Dict[str, object], info: dict, *, staleness: int,
              rounds: int, flushes: int, clocks) -> SSPTelemetry:
    """Join the histogram with the byte accounting the executor kept in
    ``info`` (``bytes_pushed``, ``deferred_bytes_peak``,
    ``shared_bytes``)."""
    return SSPTelemetry(
        staleness_bound=staleness,
        rounds=rounds,
        flushes=flushes,
        hist=np.asarray(telem["hist"]),
        max_staleness=int(telem["max_staleness"]),
        clocks=np.asarray(clocks.cpu() if hasattr(clocks, "cpu")
                          else clocks),
        bytes_pushed=int(info.get("bytes_pushed", 0)),
        bytes_deferred_peak=int(info.get("deferred_bytes_peak", 0)),
        bytes_pulled=int(info.get("shared_bytes", 0)) * flushes,
    )


def merge_summaries(parts: List[SSPTelemetry]) -> SSPTelemetry:
    """Join per-chunk summaries of one chunked (``checkpoint_every``)
    run: counts and histograms add, the observed max is the max of
    maxes, and the final chunk's vector clocks are the run's."""
    if not parts:
        raise ValueError("merge_summaries needs at least one summary")
    head = parts[0]
    for p in parts[1:]:
        if p.staleness_bound != head.staleness_bound:
            raise ValueError(
                f"cannot merge SSP summaries across staleness bounds "
                f"{head.staleness_bound} != {p.staleness_bound}")
    return SSPTelemetry(
        staleness_bound=head.staleness_bound,
        rounds=sum(p.rounds for p in parts),
        flushes=sum(p.flushes for p in parts),
        hist=np.sum([np.asarray(p.hist) for p in parts], axis=0),
        max_staleness=max(p.max_staleness for p in parts),
        clocks=np.asarray(parts[-1].clocks),
        bytes_pushed=sum(p.bytes_pushed for p in parts),
        bytes_deferred_peak=max(p.bytes_deferred_peak for p in parts),
        bytes_pulled=sum(p.bytes_pulled for p in parts),
    )
