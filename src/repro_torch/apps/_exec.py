"""Thin plan adapter for the app-level ``fit`` drivers (from the JAX
package's ``apps/_exec.py``): one plan out of either ``plan=`` or
``num_rounds=``/``trace_every=``."""
from __future__ import annotations

from typing import List, Optional, Tuple

from ..core import ExecutionPlan


def resolve_plan(plan: Optional[ExecutionPlan], *,
                 num_rounds: Optional[int] = None,
                 trace_every: Optional[int] = None) -> ExecutionPlan:
    """``plan`` as given, or a loop plan of ``num_rounds`` rounds that
    traces every ``trace_every`` rounds."""
    if plan is not None:
        if num_rounds is not None and num_rounds != plan.rounds:
            raise ValueError(f"num_rounds={num_rounds} contradicts "
                             f"plan.rounds={plan.rounds}; drop one")
        if trace_every:
            raise ValueError("trace cadence comes from plan.collect_every "
                             "when a plan is passed")
        if plan.telemetry or plan.checkpoint_every:
            raise ValueError(
                "fit() has no telemetry/checkpoint surface — it would "
                "silently drop plan.telemetry / plan.checkpoint_every; "
                "drive StradsEngine.execute(..., ckpt_dir=...) directly "
                "for those plan fields")
        return plan
    if num_rounds is None:
        raise ValueError("fit needs num_rounds (or a plan= carrying "
                         "rounds)")
    return ExecutionPlan(executor="loop", rounds=num_rounds,
                         collect_every=trace_every or 0)


def trace_points(num_rounds: int, trace_every: int) -> List[int]:
    """The round indices a host-loop trace callback would record."""
    return [t for t in range(num_rounds)
            if t % trace_every == 0 or t == num_rounds - 1]


def decimate(values, num_rounds: int,
             trace_every: int) -> List[Tuple[int, float]]:
    """Per-round collect output → the host-loop-style (t, float) trace."""
    return [(t, float(values[t]))
            for t in trace_points(num_rounds, trace_every)]
