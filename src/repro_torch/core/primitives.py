"""STRADS primitives: ``schedule``, ``push``, ``pull`` (+ automatic ``sync``).

The round anatomy is the JAX package's (``core/primitives.py``):

    cand  = propose(state, carry, noise, t, phase)
    stats = tree_psum( schedule_stats(data, state, cand, phase) )
    sched = schedule(state, carry, cand, stats, t, phase)
    z, local = push(data, state, sched, phase)
    state = pull(state, sched, tree_psum(z), local, data, phase)
    carry = sched_update(carry, state_before, state, sched, phase)

Workers are a leading axis, not a device mesh: every row-sharded leaf of
the data and the state carries shape (W, n/W, …), ``push`` and
``schedule_stats`` return per-worker partials with that leading axis, and
the JAX ``psum`` over the ``data`` axis becomes :func:`tree_psum`, a
``.sum(0)``.  The same layout runs on the CPU and on one card.

Scheduling policy, partition policy and the kernel backend arrive by
injection, as in the JAX package: the engine resolves the plan's
``SchedulerSpec``, ``PartitionerSpec`` and ``KernelSpec`` (or the app's
defaults) and calls ``use_scheduler`` / ``use_partition`` /
``use_kernels``; the engine also sets ``app.device``.  The scheduler's
carry (e.g. the Δβ priority history) is engine-owned.

The partition-injection contract: the engine builds the partitioner from
``num_schedulable()`` and ``partition_sizes()``, rejects kinds outside
``supported_partitioner_kinds``, and hands the variable→worker
:class:`~repro_torch.part.Assignment` to ``use_partition``.  It checks
for a rebalance on the host at the ``plan.checkpoint_every`` chunk
boundaries, where the ``load_balanced`` kind reads the |Δ| of
``partition_signal(state)`` over the chunk; an app without a signal
cannot host that kind.

The serving-injection contract: serving (:mod:`repro_torch.serve`) reads
the state through a :class:`~repro_torch.serve.ModelView` whose
consistency a :class:`~repro_torch.serve.ServeSpec` declares.  Apps opt
in with one primitive, ``query(state, batch) -> result``: one batched
inference request against a (possibly stale) state view, the leaves of
``batch`` and of the result carrying a leading request axis.  It reads
the state and never writes it.

The ingest-injection contract: streaming (:mod:`repro_torch.stream`)
writes new observations into a running job at host-synced chunk
boundaries.  Apps opt in with two primitives:

* ``ingest_specs() -> {"leaves": (...), "valid": fn | None}`` — which
  data leaves stream (every delta carries all of them) and, for the
  ``"extend"`` kind, how to derive the per-row validity mask of a data
  dict (``valid(data) -> (rows,)`` bool tensor; ``None``: no validity
  channel, so ``supported_stream_kinds`` must exclude ``"extend"``);
* ``ingest(data, state, rows, delta) -> (data, state)`` — write the
  ``rows`` (host int64 global rows, flat over the worker layout, unique)
  of the streamable leaves with ``delta["data"]`` and bring the derived
  state of those rows up to date (Lasso's r, MF's R, LDA's counts).
  Delta arrays are numpy or tensors on any device.  The port writes into
  the tensors it is handed and touches only the named rows (no
  whole-leaf copies); ``state=None`` applies the data-leaf writes only.

``supported_stream_kinds`` (``None`` = any) is checked when the stream
is bound, as the scheduler kinds are.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch


class StradsAppBase:
    """Convenience base with the common defaults.  ``schedule_stats`` is
    only invoked when the injected scheduler needs statistics."""

    phase_period: int = 1

    #: the injected Scheduler (set by the engine)
    scheduler = None
    #: which SchedulerSpec kinds this app can consume (None = any)
    supported_scheduler_kinds = None
    #: the injected kernel backend (set by the engine)
    kernels = None
    #: which KernelSpec kinds this app can dispatch (None = any)
    supported_kernel_kinds = None
    #: the injected variable→worker Assignment (set by the engine; None
    #: when no partitioner is resolved)
    assignment = None
    #: which PartitionerSpec kinds this app can host (None = any)
    supported_partitioner_kinds = None
    #: the engine's device (set by the engine)
    device = torch.device("cpu")
    #: True: without a caller's noise source the engine hands ``propose``
    #: no noise, and the app draws its own (MF keys its draws on the
    #: H/W cycle, so both halves of a cycle schedule the same block)
    own_noise = False

    def static_phase(self, t: int) -> int:
        return 0

    def default_scheduler_spec(self) -> Optional[Any]:
        return None

    def num_schedulable(self) -> int:
        raise NotImplementedError(
            f"{type(self).__name__} must define num_schedulable() to "
            f"accept an injected SchedulerSpec")

    def use_scheduler(self, scheduler) -> None:
        self.scheduler = scheduler

    def default_partitioner_spec(self) -> Optional[Any]:
        """The partition policy when the plan names none (``None``: the
        app has no variable-ownership story)."""
        return None

    def use_partition(self, assignment) -> None:
        """Receive the engine's Assignment (``None`` clears it)."""
        self.assignment = assignment

    def partition_signal(self, state):
        """A (num_schedulable(),) per-variable statistic whose |Δ| over a
        chunk is the load balancer's activity measure (Lasso's β);
        ``None`` = no signal, so no ``load_balanced`` partitioner."""
        return None

    def partition_sizes(self):
        """Per-variable byte sizes for ``size_balanced`` (``None`` =
        uniform)."""
        return None

    def var_roles(self) -> dict:
        """Leaf-path → VarSpec role declarations beyond placement (only
        ``"priority"``: a scheduling-priority table kept in the app's
        state, which the SSP window masks for in-flight exclusion through
        :class:`~repro_torch.core.kvstore.VarTable`).  Apps with an
        injected scheduler keep priorities in the engine's carry and need
        none.  Default: none."""
        return {}

    def default_kernel_spec(self) -> Optional[Any]:
        return None

    def use_kernels(self, kernels) -> None:
        self.kernels = kernels

    # -- the primitives ------------------------------------------------------

    def propose(self, state, carry, noise, t, phase):
        return None

    def schedule_stats(self, data, state, candidates, phase):
        return None

    def schedule(self, state, carry, candidates, stats, t, phase):
        return candidates

    def push(self, data, state, sched, phase):
        raise NotImplementedError

    def pull(self, state, sched, z, local, data, phase):
        raise NotImplementedError

    def sched_update(self, carry, before, after, sched, phase):
        return carry

    def query(self, state, batch):
        """One batched inference request against a (possibly stale) state
        view — the serving-injection contract (see the module
        docstring).  Default: the app declares no query primitive and
        cannot be served."""
        raise NotImplementedError(
            f"{type(self).__name__} declares no query() primitive — "
            f"serving (repro_torch.serve) needs one; see the "
            f"serving-injection contract in repro_torch.core.primitives")

    #: which StreamSpec kinds this app can ingest (None = any; apps
    #: without a validity channel cannot host "extend")
    supported_stream_kinds = None

    def ingest_specs(self) -> dict:
        """``{"leaves": (...), "valid": fn | None}`` — the
        ingest-injection contract (see the module docstring).  Default:
        the app declares no ingest primitives and cannot stream."""
        raise NotImplementedError(
            f"{type(self).__name__} declares no ingest_specs() primitive "
            f"— streaming (repro_torch.stream) needs one; see the "
            f"ingest-injection contract in repro_torch.core.primitives")

    def ingest(self, data, state, rows, delta):
        """Write the ``rows`` slots of the streamable leaves with
        ``delta["data"]`` and bring derived state up to date — the
        ingest-injection contract (see the module docstring).  Default:
        the app declares no ingest primitive and cannot stream."""
        raise NotImplementedError(
            f"{type(self).__name__} declares no ingest() primitive — "
            f"streaming (repro_torch.stream) needs one; see the "
            f"ingest-injection contract in repro_torch.core.primitives")


@dataclasses.dataclass(frozen=True)
class RoundResult:
    """Output of one BSP round."""
    state: Any
    sched: Any
    sched_carry: Any = None   # post-round engine-owned carry


def tree_psum(tree: Any) -> Any:
    """Sum every tensor leaf of nested dicts/lists/tuples over its
    leading worker axis (the pull aggregation, the JAX package's
    ``psum`` over ``data``)."""
    if isinstance(tree, dict):
        return {k: tree_psum(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_psum(v) for v in tree)
    return None if tree is None else tree.sum(0)
