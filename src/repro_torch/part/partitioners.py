"""The three partitioners behind one protocol, copied from the JAX
package's ``part/partitioners.py``:

* :class:`StaticPartitioner` — the frozen contiguous partition (the
  rotation scheduler's block bounds); never moves.
* :class:`SizeBalancedPartitioner` — greedy bin-packing on per-variable
  bytes once at init; never moves afterwards.
* :class:`LoadBalancedPartitioner` — an EMA of the per-variable activity
  |Δsignal| the app's ``partition_signal`` exposes, greedily re-binned
  to equalise per-worker load at chunk boundaries.

All run on the host in numpy and share :func:`greedy_balance`.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from .assignment import Assignment, contiguous_assignment
from .protocol import PartitionerBase, greedy_balance
from .spec import PartitionerSpec


@dataclasses.dataclass(frozen=True)
class StaticPartitioner(PartitionerBase):
    """The frozen contiguous partition — never measures, never moves."""
    num_vars: int
    num_workers: int

    def init_assignment(self) -> Assignment:
        return contiguous_assignment(self.num_vars, self.num_workers)


@dataclasses.dataclass(frozen=True)
class SizeBalancedPartitioner(PartitionerBase):
    """Greedy byte-balanced bins at init; static afterwards.  ``sizes``
    is the per-variable byte vector (the app's ``partition_sizes()``;
    ``None`` = uniform, which degenerates to balanced counts)."""
    num_vars: int
    num_workers: int
    sizes: Optional[tuple] = None

    def init_assignment(self) -> Assignment:
        sizes = (np.ones((self.num_vars,), np.float64)
                 if self.sizes is None
                 else np.asarray(self.sizes, np.float64))
        if sizes.shape != (self.num_vars,):
            raise ValueError(f"sizes must have shape ({self.num_vars},); "
                             f"got {sizes.shape}")
        return greedy_balance(sizes, self.num_workers)


@dataclasses.dataclass(frozen=True)
class LoadBalancedPartitioner(PartitionerBase):
    """Activity-EMA load balancing at chunk boundaries.

    Starts from the contiguous static assignment; each chunk folds the
    observed per-variable activity into the EMA (``stats["ema"]``), and
    a boundary at round t rebalances when the cadence admits it
    (``t % rebalance_every == 0``; 0 = every boundary) and the current
    assignment's load spread over the EMA exceeds
    ``imbalance_threshold``."""
    num_vars: int
    num_workers: int
    rebalance_every: int = 0
    ema: float = 0.0
    imbalance_threshold: float = 0.0

    def init_assignment(self) -> Assignment:
        return contiguous_assignment(self.num_vars, self.num_workers)

    def init_stats(self) -> dict:
        return {"ema": np.zeros((self.num_vars,), np.float64)}

    def measure(self, stats, assignment, activity):
        if activity is None:
            return stats
        a = np.asarray(activity, np.float64)
        if a.shape != (self.num_vars,):
            raise ValueError(f"activity must have shape "
                             f"({self.num_vars},); got {a.shape}")
        prev = stats["ema"]
        return {"ema": self.ema * prev + (1.0 - self.ema) * a}

    def should_rebalance(self, stats, assignment, t) -> bool:
        if self.rebalance_every and t % self.rebalance_every:
            return False
        if not float(stats["ema"].sum()):
            return False            # nothing measured yet
        return assignment.spread(stats["ema"]) > self.imbalance_threshold

    def propose_assignment(self, stats, assignment) -> Assignment:
        return greedy_balance(stats["ema"], self.num_workers,
                              version=assignment.version + 1)


def build_partitioner(spec: PartitionerSpec, *, num_vars: int,
                      num_workers: int, sizes=None):
    """The policy a :class:`PartitionerSpec` declares, for an app with
    ``num_vars`` partitionable variables (``num_schedulable()``) over
    ``num_workers`` workers; ``sizes`` is the optional per-variable byte
    vector (``partition_sizes()``)."""
    if not isinstance(spec, PartitionerSpec):
        raise TypeError(f"build_partitioner wants a PartitionerSpec; got "
                        f"{type(spec).__name__}")
    if not isinstance(num_vars, int) or num_vars < 1:
        raise ValueError(f"num_vars must be a positive int; got "
                         f"{num_vars!r}")
    if spec.kind == "static":
        return StaticPartitioner(num_vars, num_workers)
    if spec.kind == "size_balanced":
        return SizeBalancedPartitioner(
            num_vars, num_workers,
            sizes=None if sizes is None else tuple(float(s) for s in sizes))
    # "load_balanced" (spec validation admits nothing else)
    return LoadBalancedPartitioner(
        num_vars=num_vars, num_workers=num_workers,
        rebalance_every=spec.rebalance_every, ema=spec.ema,
        imbalance_threshold=spec.imbalance_threshold)
