"""The :class:`Partitioner` protocol (the partition-injection contract),
a copy of the JAX package's ``part/protocol.py``.

The engine drives it on the host, at the ``plan.checkpoint_every``
chunk boundaries of :meth:`repro_torch.core.StradsEngine.execute`:

    assignment = partitioner.init_assignment()          # once per run
    stats      = partitioner.init_stats()               # None if stateless
    # ... a chunk of rounds runs ...
    stats      = partitioner.measure(stats, assignment, activity)
    if partitioner.should_rebalance(stats, assignment, t):
        assignment' = partitioner.propose_assignment(stats, assignment)

``activity`` is the (J,) numpy |Δsignal| of the app's
``partition_signal`` over the chunk, or ``None`` when the app declares
no signal.  Everything is numpy on the host, and ``propose_assignment``
is deterministic given (stats, assignment), which is what makes a
mid-run rebalance resumable from a checkpoint.
"""
from __future__ import annotations

from typing import Any, Optional, Protocol, runtime_checkable

import numpy as np

from .assignment import Assignment

Stats = Any     # partitioner activity state (host-side numpy, or None)


@runtime_checkable
class Partitioner(Protocol):
    """The pluggable partition policy (built from a
    :class:`~repro_torch.part.spec.PartitionerSpec` by
    :func:`~repro_torch.part.build_partitioner`)."""

    def init_assignment(self) -> Assignment: ...

    def init_stats(self) -> Stats: ...

    def measure(self, stats: Stats, assignment: Assignment,
                activity: Optional[np.ndarray]) -> Stats: ...

    def should_rebalance(self, stats: Stats, assignment: Assignment,
                         t: int) -> bool: ...

    def propose_assignment(self, stats: Stats,
                           assignment: Assignment) -> Assignment: ...


class PartitionerBase:
    """Stateless defaults: no stats, never rebalances, identity
    proposal."""

    def init_stats(self) -> Optional[Any]:
        return None

    def measure(self, stats, assignment, activity):
        return stats

    def should_rebalance(self, stats, assignment, t) -> bool:
        return False

    def propose_assignment(self, stats, assignment) -> Assignment:
        return assignment


def greedy_balance(weights: np.ndarray, num_workers: int,
                   version: int = 0) -> Assignment:
    """Greedy least-loaded bin-packing with balanced capacities — one
    implementation for both balancing kinds (sizes for
    ``size_balanced``, the activity EMA for ``load_balanced``).

    Variables are placed heaviest-first onto the least-loaded worker
    that still has capacity; capacities are the balanced variable counts
    ``ceil``/``floor(J/U)``.  Ties break by lowest index / lowest worker
    id, exactly as the JAX package's (a stable sort, then ``argmin``)."""
    w = np.asarray(weights, np.float64)
    J = w.shape[0]
    if num_workers < 1:
        raise ValueError(f"num_workers must be >= 1; got {num_workers}")
    base, extra = divmod(J, num_workers)
    capacity = np.full((num_workers,), base, np.int64)
    capacity[:extra] += 1
    # stable heaviest-first: ties keep index order
    order = np.argsort(-w, kind="stable")
    owner = np.empty((J,), np.int64)
    loads = np.zeros((num_workers,), np.float64)
    filled = np.zeros((num_workers,), np.int64)
    for j in order:
        open_w = np.flatnonzero(filled < capacity)
        u = open_w[np.argmin(loads[open_w])]     # argmin ties → lowest id
        owner[j] = u
        loads[u] += w[j]
        filled[u] += 1
    return Assignment(owner=tuple(int(o) for o in owner),
                      num_workers=num_workers, version=version)
