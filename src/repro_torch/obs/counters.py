"""Device-side telemetry counters, from the JAX package's
``obs/counters.py``.

A small dict of int32 tensors on the engine's device rides the executor
carry (``EngineCarry.obs`` / ``SSPCarry.obs``) and is folded forward once
a round, from the round's *schedule* alone — never from model state or
the noise stream, so an instrumented run is bit-identical to an
uninstrumented one.

Counters
--------
``rounds``     (phase_period,) — rounds executed per static phase; the
               total equals the rounds the plan ran.
``sched_size`` scheduled entries admitted across the run (for masked
               schedules the mask popcount; for dense schedules the
               static schedule width).
``proposed``/``accepted``/``killed``
               the ρ-dependency-filter ledger (paper §3.3): candidates
               the scheduler proposed (U′ a round for the dynamic
               kinds), survivors of the filter, and the filtered ones —
               ``accepted + killed == proposed`` by construction.

:func:`observe_round` reads no device value on the host: every update is
a device op (a popcount, adds of host ints), so the rounds stay free of
host syncs.  :func:`summarize_counters` reads them once, at the end.
Each update makes new tensors: a carry handed back to the caller keeps
its counts while a later chunk folds on.

The SSP staleness histogram (``staleness_init``/``observe_read``) lives
here too, as in the JAX package.  The port's SSP windows are a host loop
with host-int clocks, so it is counted on the host, over the reads the
executor actually served.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

_SCALARS = ("sched_size", "proposed", "accepted", "killed")


def init_counters(phase_period: int, device="cpu") -> Dict[str, torch.Tensor]:
    """A fresh counter dict for an app whose phases cycle with period
    ``phase_period`` (1 = phaseless), on ``device``."""
    out = {"rounds": torch.zeros((phase_period,), dtype=torch.int32,
                                 device=device)}
    for k in _SCALARS:
        out[k] = torch.zeros((), dtype=torch.int32, device=device)
    return out


def _leaves(tree: Any) -> list:
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def observe_round(counters: Dict[str, torch.Tensor], sched: Any, phase: int,
                  num_candidates: int = 0) -> Dict[str, torch.Tensor]:
    """Fold one executed round's schedule into the counters (a new dict
    of new tensors).

    Boolean leaves of the schedule are keep-masks (the ρ-filter's
    survivors): their popcount is the round's accepted count,
    ``num_candidates`` (the scheduler's static U′; 0 for policies without
    a proposal pool) the proposed count, and the difference the killed
    count.  Schedules without masks (rotation, MF's rank blocks) add
    their static width to ``sched_size`` and keep the ledger balanced
    with ``proposed == accepted``."""
    c = dict(counters)
    rounds = c["rounds"].clone()
    rounds.narrow(0, phase, 1).add_(1)
    c["rounds"] = rounds
    leaves = _leaves(sched)
    masks = [x for x in leaves
             if torch.is_tensor(x) and x.dtype == torch.bool]
    if masks:
        acc = masks[0].sum(dtype=torch.int32)
        for m in masks[1:]:
            acc = acc + m.sum(dtype=torch.int32)
        prop = num_candidates if num_candidates else acc
        c["sched_size"] = c["sched_size"] + acc
        c["accepted"] = c["accepted"] + acc
        c["proposed"] = c["proposed"] + prop
        c["killed"] = c["killed"] + (prop - acc)
    else:
        width = int(sum(int(np.prod(tuple(x.shape) if torch.is_tensor(x)
                                    else np.shape(x), dtype=np.int64))
                        for x in leaves))
        # no filter ran: the ledger stays balanced at proposed == accepted
        for k in ("sched_size", "proposed", "accepted"):
            c[k] = c[k] + width
    return c


def summarize_counters(counters: Optional[Dict[str, Any]]) -> dict:
    """Host ints out of the device counters (an empty dict for an
    uninstrumented run).  One copy to the host for the whole dict."""
    if counters is None:
        return {}
    flat = torch.cat([counters["rounds"].reshape(-1)]
                     + [counters[k].reshape(1) for k in _SCALARS]
                     ).cpu().tolist()
    per_phase = [int(v) for v in flat[:-len(_SCALARS)]]
    out = {"rounds": int(sum(per_phase)), "rounds_per_phase": per_phase}
    out.update({k: int(v) for k, v in zip(_SCALARS, flat[-len(_SCALARS):])})
    return out


# ---------------------------------------------------------------------------
# SSP staleness histogram (counted on the host)
# ---------------------------------------------------------------------------

def staleness_init(staleness: int) -> Dict[str, object]:
    """The histogram over observed read staleness (bins 0..s) and the
    running max."""
    return {"hist": np.zeros((staleness + 1,), np.int64),
            "max_staleness": 0}


def observe_read(telem: Dict[str, object], clock: int,
                 cache_clock: int) -> Dict[str, object]:
    """Record one SSP round's read: how stale was the cache it was served
    from?  (In place; returns ``telem``.)"""
    st = int(clock) - int(cache_clock)
    telem["hist"][st] += 1
    telem["max_staleness"] = max(telem["max_staleness"], st)
    return telem


__all__ = ["init_counters", "observe_read", "observe_round",
           "staleness_init", "summarize_counters"]
