"""Observability of the port, from the JAX package's ``obs/``.

Three layers behind one declarative :class:`TelemetrySpec` on the
:class:`~repro_torch.core.plan.ExecutionPlan`:

* :mod:`repro_torch.obs.counters` — int32 counters on the engine's
  device, carried through every executor's rounds (per-phase rounds,
  schedule sizes, the ρ-filter ledger), bit-neutral to model state and
  read on the host once, at the end;
* :mod:`repro_torch.obs.events` — the host-side :class:`Recorder` of
  typed instants and strictly nested wall-clock spans, exportable as
  JSONL and Chrome-trace files;
* :mod:`repro_torch.obs.report` — :class:`RunReport`, the
  ``ExecutionReport.telemetry`` every executor returns under a spec,
  with the SSP staleness section merged in for ``ssp`` plans
  (``python -m repro_torch.launch.trace`` summarizes and checks saved
  ones, the JAX package's too).
"""
from .counters import (init_counters, observe_read, observe_round,
                       staleness_init, summarize_counters)
from .events import (Recorder, chrome_trace, validate_spans,
                     write_chrome_trace, write_jsonl)
from .report import RunReport, report_from_json
from .spec import TELEMETRY_KINDS, TelemetrySpec

__all__ = [
    "TELEMETRY_KINDS", "TelemetrySpec", "Recorder", "RunReport",
    "chrome_trace", "init_counters", "observe_read", "observe_round",
    "report_from_json", "staleness_init", "summarize_counters",
    "validate_spans", "write_chrome_trace", "write_jsonl",
]
