"""The declarative execution surface: :class:`ExecutionPlan`.

A copy of the JAX package's ``core/plan.py``: the same fields, the same
construction-time validation and error text, the same exact JSON
round-trip, so every ``examples/plans/*.json`` parses to the same dict in
both packages.  :meth:`repro_torch.core.StradsEngine.execute` consumes it
and returns an :class:`ExecutionReport`; the executors and plan fields
the port does not run yet are rejected there, never silently ignored.
"""
from __future__ import annotations

import dataclasses
import json
import warnings
from typing import Any, Optional, Union

from ..kernels.spec import KernelSpec
from ..obs.spec import TelemetrySpec
from ..part.spec import PartitionerSpec
from ..sched.spec import SchedulerSpec

EXECUTORS = ("loop", "scan", "pipelined", "ssp")

# The one place the executor-name error is worded (the same text as the
# JAX package's, which the parity tests compare).
_EXECUTOR_MSG = ("executor must be 'loop', 'scan', 'pipelined' or 'ssp'; "
                 "got {!r}")


@dataclasses.dataclass(frozen=True)
class ExecutionPlan:
    """Everything the engine needs to know about *how* to run R rounds.

    Fields
    ------
    executor:        ``"loop"`` (host loop, per-round dispatch),
                     ``"scan"`` (R rounds without a host sync, BSP),
                     ``"pipelined"`` (scan + one-round-stale schedule
                     prefetch), ``"ssp"`` (bounded staleness).
    rounds:          total BSP/SSP rounds the plan executes.
    staleness:       SSP bound ``s`` (reads ≤ s rounds stale); > 0 only
                     valid with ``executor="ssp"``.
    pipeline_depth:  explicit schedule-prefetch depth.  ``None`` derives
                     it from the executor (scan→0, pipelined→1); a
                     nonzero value requires ``executor="pipelined"``.
    phase_unroll:    rounds unrolled per scan step, as a multiple of the
                     app's ``phase_period`` (1 = one phase cycle per scan
                     step — the default and the bit-identical baseline).
                     Only meaningful for the scanned executors.
    telemetry:       the observability policy, as a declarative
                     :class:`~repro_torch.obs.spec.TelemetrySpec` (kind ∈
                     counters | trace).  ``False`` (the default) runs
                     uninstrumented; a spec makes **every** executor
                     return a :class:`~repro_torch.obs.RunReport` as
                     ``ExecutionReport.telemetry`` (device counters,
                     host events under ``kind="trace"``, and the SSP
                     staleness/byte section for ssp plans) — final model
                     state stays bit-identical either way.  The
                     deprecated bool form still works: ``True`` warns
                     and normalizes to ``TelemetrySpec(kind="counters")``.
    checkpoint_every: checkpoint cadence in rounds for
                     ``StradsEngine.execute(..., ckpt_dir=...)`` (0 = no
                     checkpointing); must tile the executor's step length.
    collect_every:   trace cadence in rounds for the app-level ``fit``
                     adapters (0 = no trace).  ``execute`` itself collects
                     per round whenever a collect fn is passed; this field
                     records the decimation cadence consumers apply.
    donate:          donate the input state buffers to the executor.
    workers:         expected ``data``-mesh width (placement override).
                     ``None`` = whatever mesh the engine was built with;
                     a value is validated against the engine's mesh and
                     used by drivers (``dryrun --plan``) to *build* the
                     mesh.
    scheduler:       the scheduling policy, as a declarative
                     :class:`~repro_torch.sched.spec.SchedulerSpec` (kind ∈
                     round_robin | random | rotation | dynamic_priority |
                     block_structural plus its parameters).  ``None`` =
                     the app's ``default_scheduler_spec()``; a value is
                     resolved and injected by ``StradsEngine.execute``,
                     so ``fit(plan=...)`` overrides policy without
                     touching app config.
    partitioner:     the partition policy, as a declarative
                     :class:`~repro_torch.part.spec.PartitionerSpec` (kind ∈
                     static | size_balanced | load_balanced plus its
                     parameters).  ``None`` = the app's
                     ``default_partitioner_spec()``; the resolved
                     partitioner owns the variable→worker
                     variable→worker assignment, and the
                     engine checks it for rebalances at the
                     ``checkpoint_every`` chunk boundaries — the other
                     half of the paper's primitive pair, swappable from
                     the plan exactly like the scheduler.
    kernels:         the compute backend serving the round body's
                     hot-spots, as a declarative
                     :class:`~repro_torch.kernels.spec.KernelSpec` (kind ∈
                     reference | pallas plus tile knobs).  ``None`` =
                     the app's ``default_kernel_spec()`` (falling back
                     to ``reference`` — the bit-identical
                     pre-KernelSpec behavior); a value is resolved via
                     ``repro_torch.kernels.build_kernels`` and injected by
                     ``StradsEngine.execute``, with the Pallas kind
                     selecting the hand-written CUDA kernels —
                     the third leg of the "everything is a plan edit"
                     surface.
    """

    executor: str = "scan"
    rounds: int = 1
    staleness: int = 0
    pipeline_depth: Optional[int] = None
    phase_unroll: int = 1
    telemetry: Union[bool, TelemetrySpec] = False
    checkpoint_every: int = 0
    collect_every: int = 0
    donate: bool = True
    workers: Optional[int] = None
    scheduler: Optional[SchedulerSpec] = None
    partitioner: Optional[PartitionerSpec] = None
    kernels: Optional[KernelSpec] = None

    def __post_init__(self):
        if self.executor not in EXECUTORS:
            raise ValueError(_EXECUTOR_MSG.format(self.executor))
        if not isinstance(self.rounds, int) or self.rounds < 1:
            raise ValueError(f"rounds must be a positive int; got "
                             f"{self.rounds!r}")
        if not isinstance(self.staleness, int) or self.staleness < 0:
            raise ValueError(f"staleness must be an int >= 0; got "
                             f"{self.staleness!r}")
        if self.staleness > 0 and self.executor != "ssp":
            raise ValueError(
                f"staleness={self.staleness} requires executor='ssp'; got "
                f"executor={self.executor!r}")
        if self.pipeline_depth is not None:
            if self.pipeline_depth not in (0, 1):
                raise ValueError(f"pipeline_depth must be 0 or 1, got "
                                 f"{self.pipeline_depth}")
            if self.pipeline_depth > 0 and self.executor != "pipelined":
                raise ValueError(
                    f"pipeline_depth={self.pipeline_depth} requires "
                    f"executor='pipelined'; got {self.executor!r}")
            if self.pipeline_depth == 0 and self.executor == "pipelined":
                raise ValueError("executor='pipelined' means "
                                 "pipeline_depth=1; leave it None or pass 1")
        if not isinstance(self.phase_unroll, int) or self.phase_unroll < 1:
            raise ValueError(f"phase_unroll must be a positive int; got "
                             f"{self.phase_unroll!r}")
        if self.phase_unroll > 1 and self.executor not in ("scan",
                                                           "pipelined"):
            raise ValueError(
                f"phase_unroll={self.phase_unroll} only applies to the "
                f"scanned executors; got executor={self.executor!r}")
        # telemetry graduated from a bool to a TelemetrySpec; True used
        # to raise off-ssp ("telemetry=True requires executor='ssp'") —
        # now every executor carries engine-wide counters, so the bool
        # form only warns and normalizes onto the spec it implies.
        if self.telemetry is None:
            object.__setattr__(self, "telemetry", False)
        if isinstance(self.telemetry, bool):
            if self.telemetry:
                warnings.warn(
                    "plan.telemetry=True (bool) is deprecated; pass a "
                    "repro_torch.obs.TelemetrySpec — it no longer requires "
                    "executor='ssp' (True maps to kind='counters', the "
                    "engine-wide device counters, on every executor)",
                    DeprecationWarning, stacklevel=3)
                object.__setattr__(self, "telemetry",
                                   TelemetrySpec(kind="counters"))
        elif not isinstance(self.telemetry, TelemetrySpec):
            raise ValueError(
                f"telemetry must be a bool or a repro_torch.obs.TelemetrySpec "
                f"(its own __post_init__ validates the kind); got "
                f"{type(self.telemetry).__name__}")
        for field in ("checkpoint_every", "collect_every"):
            v = getattr(self, field)
            if not isinstance(v, int) or v < 0:
                raise ValueError(f"{field} must be an int >= 0; got {v!r}")
        if not isinstance(self.donate, bool):
            raise ValueError(f"donate must be a bool; got {self.donate!r}")
        if self.workers is not None and (not isinstance(self.workers, int)
                                         or self.workers < 1):
            raise ValueError(f"workers must be None or a positive int; "
                             f"got {self.workers!r}")
        if self.scheduler is not None \
                and not isinstance(self.scheduler, SchedulerSpec):
            raise ValueError(
                f"scheduler must be None or a repro_torch.sched.SchedulerSpec "
                f"(its own __post_init__ validates the policy); got "
                f"{type(self.scheduler).__name__}")
        if self.partitioner is not None \
                and not isinstance(self.partitioner, PartitionerSpec):
            raise ValueError(
                f"partitioner must be None or a repro_torch.part.PartitionerSpec "
                f"(its own __post_init__ validates the policy); got "
                f"{type(self.partitioner).__name__}")
        if self.kernels is not None \
                and not isinstance(self.kernels, KernelSpec):
            raise ValueError(
                f"kernels must be None or a repro_torch.kernels.KernelSpec "
                f"(its own __post_init__ validates the backend); got "
                f"{type(self.kernels).__name__}")

    # -- derived views -------------------------------------------------------

    @property
    def depth(self) -> int:
        """The schedule-prefetch depth this plan's executor runs at."""
        if self.pipeline_depth is not None:
            return self.pipeline_depth
        return 1 if self.executor == "pipelined" else 0

    # -- serialization -------------------------------------------------------

    def to_json(self) -> dict:
        """A plain JSON-safe dict (every field, defaults included) —
        ``from_json(to_json(p)) == p`` exactly."""
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, obj) -> "ExecutionPlan":
        """Rebuild from ``to_json`` output, a JSON string, or a partial
        dict (missing fields take their defaults; unknown keys raise)."""
        if isinstance(obj, (str, bytes)):
            obj = json.loads(obj)
        if not isinstance(obj, dict):
            raise TypeError(f"ExecutionPlan.from_json wants a dict or JSON "
                            f"string; got {type(obj).__name__}")
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(obj) - known
        if unknown:
            raise ValueError(f"unknown ExecutionPlan field(s): "
                             f"{sorted(unknown)}")
        if isinstance(obj.get("scheduler"), dict):
            obj = dict(obj,
                       scheduler=SchedulerSpec.from_json(obj["scheduler"]))
        if isinstance(obj.get("partitioner"), dict):
            obj = dict(obj, partitioner=PartitionerSpec.from_json(
                obj["partitioner"]))
        if isinstance(obj.get("kernels"), dict):
            obj = dict(obj, kernels=KernelSpec.from_json(obj["kernels"]))
        if isinstance(obj.get("telemetry"), dict):
            obj = dict(obj, telemetry=TelemetrySpec.from_json(
                obj["telemetry"]))
        return cls(**obj)


@dataclasses.dataclass
class ExecutionReport:
    """Uniform result of ``StradsEngine.execute``.

    state:      final model state (worker layout: row-sharded leaves carry
                a leading worker axis).
    trace:      stacked per-round ``collect`` outputs (leading axis =
                rounds executed this call), or ``None`` without a collect
                fn.
    telemetry:  with ``plan.telemetry`` set, a
                :class:`~repro_torch.obs.RunReport`: the resolved spec,
                the device counters summarized to host ints, the host
                events (``kind="trace"``) and, for ``ssp`` plans, the
                staleness and byte section (``.ssp``, the chunks'
                summaries merged); ``None`` without a spec.
    carry:      resumable :class:`repro_torch.core.engine.EngineCarry`
                (:class:`repro_torch.ps.SSPCarry` for ``ssp``); pass it
                back to ``execute`` to continue the same plan bit-exactly.
    plan:       the plan that produced this report.
    stream:     the final stream-cursor payload (flat numpy int64:
                ``cursor``/``rows_in``/``rows_dropped``/``fill0``) when
                the run streamed data in via ``execute(..., stream=,
                source=)``; ``None`` for unstreamed runs.  The same dict
                rides each checkpoint as its ``"stream"`` subtree.
    """
    state: Any
    trace: Any = None
    telemetry: Any = None
    carry: Any = None
    plan: Optional[ExecutionPlan] = None
    stream: Optional[dict] = None
