"""Bounded-staleness parameter-server subsystem (the SSP executor), from
the JAX package's ``ps/``.

Layers, bottom up: ``server`` (server-/worker-resident split of the state
over ``core/kvstore``, vector clocks), ``cache`` (worker-local stale
caches and the SSP consistency gate), ``ssp`` (the executor,
``StradsEngine.run_ssp``), ``telemetry`` (staleness histograms, push and
pull byte accounting).
"""
from .cache import StaleCache
from .server import ParameterServer, init_clocks, min_clock, tick
from .ssp import SSPCarry, rounds_per_step, run_ssp
from .telemetry import SSPTelemetry, merge_summaries, summarize

__all__ = [
    "StaleCache", "ParameterServer", "init_clocks", "min_clock", "tick",
    "SSPCarry", "rounds_per_step", "run_ssp", "SSPTelemetry",
    "merge_summaries", "summarize",
]
