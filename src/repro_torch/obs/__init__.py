"""Telemetry specs of the port (counters and traces are still to be
ported: ROADMAP.md queue 1, step 10)."""
from .spec import TELEMETRY_KINDS, TelemetrySpec

__all__ = ["TELEMETRY_KINDS", "TelemetrySpec"]
