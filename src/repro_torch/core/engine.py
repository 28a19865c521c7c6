"""The STRADS round executors of the port: ``loop``, ``scan``,
``pipelined`` and ``ssp``.

One round is the JAX package's (``core/engine.py``)

    propose → schedule_stats → Σ_workers → schedule → push → Σ_workers → pull

with the workers as a leading tensor axis (see
:mod:`repro_torch.core.primitives`), so the JAX ``shard_map`` + ``psum``
pair becomes per-worker partials and a ``.sum(0)``.

:meth:`StradsEngine.execute` is the one entry point, driven by an
:class:`~repro_torch.core.plan.ExecutionPlan`.  ``loop`` and ``scan``
run the same round body in a Python loop, so ``loop`` ≡ ``scan`` bit for
bit, as in the JAX package.  ``loop`` takes a per-round host callback;
``scan`` takes none and never syncs with the host (capturing its rounds
as one CUDA graph is later work).  ``pipelined`` is the paper's
pipelined scheduler (the JAX ``run_scanned(pipeline_depth=1)``): the
schedule of round t+1 is made from the state and scheduler carry before
round t's update, so each round runs a schedule one round stale.  The
port runs it in program order on the current CUDA stream (the kernels'
cached workspaces assume one stream); the prefetch has no data
dependency on the round, which is what a second stream could overlap.
Apps whose rounds cycle through static phases (``phase_period``: MF's
H/W alternation is 2, LDA's rotation U) run on all three; ``scan`` and
``pipelined`` hold them to the JAX scan's rule that a run starts on a
phase boundary, and ``pipelined`` to its rule that the rounds divide
into ``phase_period × phase_unroll``.  ``ssp`` is the bounded-staleness
executor of :mod:`repro_torch.ps` (``run_ssp``): reads of the state's
whole (server-resident) leaves are served from a cache up to
``plan.staleness`` rounds stale and the pushes are summed over the
workers once a window of s + 1 rounds; its steps of lcm(s + 1,
``phase_period``) rounds align its runs, chunks and resumes.

Streaming ingest rides the same chunk boundaries
(``execute(..., stream=, source=)``, :mod:`repro_torch.stream`): the run
goes in spans of the gcd of ``plan.checkpoint_every`` and
``stream.ingest_every`` (or whichever is set), each span's boundary
ingests at its top and checkpoints at its bottom, and the app's
``ingest`` writes the named rows into the data and state tensors the
engine runs on.  A pipelined run keeps the schedule in flight across a
boundary (made before the ingest, as in the JAX package); an ``ssp``
run's boundaries are its window flushes.

Telemetry is injected like the policies (``plan.telemetry``, a
:class:`~repro_torch.obs.TelemetrySpec`): device counters
(:mod:`repro_torch.obs.counters`) ride the carry as ``obs`` and are
folded once a round from the round's schedule on every executor, and
``kind="trace"`` records the host events of an ``execute`` (its span,
the executor's span a chunk, ``checkpoint`` spans, ``rebalance``
instants) on a :class:`~repro_torch.obs.Recorder`.  The report's
``telemetry`` is then a :class:`~repro_torch.obs.RunReport`.  The port
compiles nothing, so there is no program cache and no ``cache_miss``
event.

The Recorder is the engine's :attr:`StradsEngine.recorder`: one a
caller attaches (the serving layer attaches the one it is given), else
one the engine attaches itself when an ``execute`` starts inside a
``torch.profiler`` session (kept until one starts with no session and
no trace plan), else under ``kind="trace"`` one for that ``execute``
alone.  While one is live every round records four timers on it:
``round``, ``schedule`` (noise, ``propose``, ``schedule_stats`` and Σ,
``schedule``), ``push`` (``push`` and Σ) and ``pull`` (``pull`` and
``sched_update``), each with its host time and, on CUDA, its device
time (:meth:`~repro_torch.obs.Recorder.timer`).  With none a round costs
one ``is None`` test; a timed run equals an untimed one to the bit.

Partition policy is injected like the scheduler (the partitioning
contract of :mod:`repro_torch.core.primitives`): the resolved
partitioner owns the variable→worker
:class:`~repro_torch.part.Assignment`, and the engine checks for a
rebalance on the host at the ``plan.checkpoint_every`` chunk boundaries
of ``execute``, where it also writes a ``{"state", "carry",
"assignment"}`` checkpoint (:mod:`repro_torch.checkpoint`).  A run
resumed with ``carry=`` and ``partition=`` continues bit-exactly.

Randomness: the JAX engine splits a PRNG key per round and draws the
scheduler's Gumbel noise from it.  The port draws one (J,) Gumbel vector
per round from a ``torch.Generator`` on the engine's device, or takes it
from a ``noise(t)`` source the caller passes (the parity tests feed the
JAX package's own draws that way).  Round t's schedule takes the t-th
draw on every executor, so ``pipelined`` and ``ssp`` differ from
``scan`` through staleness alone; the pipelined generator is one draw
ahead at the end of a run (the prefetched schedule's).  An app that
keys its draws itself (``own_noise``: MF draws once per H/W cycle) gets
``None`` when the caller passes no source.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import warnings
from typing import Any, Callable, Optional

import numpy as np
import torch

from ..checkpoint import save_checkpoint
from ..kernels import KernelSpec, build_kernels
from ..obs import RunReport, counters as obs_counters
from ..obs.events import Recorder, no_timer, profiler_live
from ..part import Assignment, PartitionerSpec, build_partitioner
from ..sched import SchedulerSpec, build_scheduler
from .kvstore import DATA_AXIS, KVStore, place, store_from_tree
from .plan import ExecutionPlan, ExecutionReport
from .primitives import RoundResult, StradsAppBase, tree_psum

_UNSET = object()
_TINY = float(np.finfo(np.float32).tiny)
_NULL_CTX = contextlib.nullcontext()   # reusable no-op span


def resolve_device(device) -> torch.device:
    """``torch.device(device)``, refusing CUDA when no card is present
    (the port never falls back to the CPU on its own)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass "
                           "device='cpu' to run on the CPU")
    return dev


@dataclasses.dataclass(frozen=True)
class EngineCarry:
    """Resumable carry: the next round index, the engine-owned scheduler
    carry (e.g. the Δβ priority history; ``None`` for stateless
    policies), the state of the noise generator (``None`` when the
    noise came from a caller's source), and for a pipelined run
    (``depth`` 1) the prefetched schedule of round ``t`` (``sched``;
    ``None`` for apps whose schedule is implicit, as LDA's rotation).
    Under a plan-level telemetry spec ``obs`` holds the device counters
    (:mod:`repro_torch.obs.counters`; ``None`` uninstrumented), carried
    through chunks and resumes.  It round-trips through
    :mod:`repro_torch.checkpoint` (``carry/.obs/rounds``, … as the JAX
    package writes them)."""
    t: int
    sched_carry: Any = None
    rng_state: Optional[torch.Tensor] = None
    sched: Any = None
    depth: int = 0
    obs: Any = None


class StradsEngine:
    """Runs a StradsApp's BSP rounds over W workers on one device.

    Parameters
    ----------
    app:         the STRADS application.
    data_specs:  ``{leaf: "data" | None}`` — ``"data"`` leaves are split
                 by rows over the workers (the paper's 1/P split).
    state_specs: the same for the model state (``None`` = replicated).
    workers:     W, the number of workers (``plan.workers`` must agree).
    device:      where everything runs; ``"cuda"`` unless the caller
                 asks for the CPU.
    scheduler:   optional :class:`SchedulerSpec` overriding the app's
                 default (plan > constructor > app).
    kernels:     optional :class:`KernelSpec` overriding the app's
                 default (plan > constructor > app > ``reference``).
    """

    def __init__(self, app, data_specs: dict, state_specs: dict = None, *,
                 workers: int = 1, device="cuda",
                 scheduler: Optional[SchedulerSpec] = None,
                 kernels: Optional[KernelSpec] = None):
        if not isinstance(workers, int) or isinstance(workers, bool) \
                or workers < 1:
            raise ValueError(f"workers must be a positive int; got "
                             f"{workers!r}")
        self.app = app
        self.device = resolve_device(device)
        self.workers = workers
        self.data_specs = data_specs
        self.state_specs = state_specs or {}
        self._spec_override = scheduler
        self._kern_override = kernels
        self._active_spec = _UNSET
        self._active_part_spec = None
        self._active_kern_spec = None
        self.partitioner = None
        self._assignment: Optional[Assignment] = None
        self._initial_assignment: Optional[Assignment] = None
        self._part_stats = None
        #: the model store, built by ``place_state`` / ``init_state``
        self.kvstore: Optional[KVStore] = None
        self._recorder: Optional[Recorder] = None
        self._own_recorder = False   # attached by execute, not a caller
        app.device = self.device
        self.set_kernels(None)
        self.set_scheduler(None)
        self.set_partitioner(None)

    # -- observability hooks (the telemetry-injection contract) --------------

    @property
    def recorder(self) -> Optional[Recorder]:
        """The attached :class:`~repro_torch.obs.Recorder` (``None`` by
        default): the engine records its spans, instants and round
        timers on it.  Set it to attach one; ``None`` detaches."""
        return self._recorder

    @recorder.setter
    def recorder(self, rec: Optional[Recorder]):
        self._recorder = rec
        self._own_recorder = False

    def _timer(self):
        """The live Recorder's ``timer``, else a no-op of its shape."""
        rec = self._recorder
        return rec.timer if rec is not None else no_timer

    def _obs_event(self, name: str, **args):
        """Record a host event when a Recorder is live; a no-op
        otherwise."""
        if self._recorder is not None:
            self._recorder.instant(name, **args)

    def _obs_span(self, name: str, **args):
        """A wall-clock phase span under a live Recorder, else a null
        context."""
        if self._recorder is not None:
            return self._recorder.span(name, **args)
        return _NULL_CTX

    def _obs_num_candidates(self) -> int:
        """The active scheduler's static proposal-pool size U′ (0 for
        policies without one): the ρ-filter ledger's 'proposed' term."""
        return int(getattr(self.scheduler, "num_candidates", 0) or 0)

    # -- injection (plan > constructor > app > reference) --------------------

    def set_scheduler(self, spec: Optional[SchedulerSpec] = None):
        """Resolve a :class:`SchedulerSpec` (``None`` → the constructor
        spec, else the app's ``default_scheduler_spec()``), build it and
        inject it into the app.  Returns the active scheduler."""
        if spec is None:
            spec = self._spec_override
        resolved = spec if spec is not None else self._app_default(
            "default_scheduler_spec")
        if resolved == self._active_spec:
            return self.scheduler
        sched = None
        if resolved is not None:
            kinds = getattr(self.app, "supported_scheduler_kinds", None)
            if kinds is not None and resolved.kind not in kinds:
                raise ValueError(
                    f"{type(self.app).__name__} cannot consume a "
                    f"{resolved.kind!r} scheduler (it supports "
                    f"{sorted(kinds)}); fix the plan's SchedulerSpec")
            sched = build_scheduler(resolved,
                                    num_vars=self.app.num_schedulable(),
                                    num_workers=self.workers)
        self.app.use_scheduler(sched)
        self._active_spec = resolved
        self._needs_stats = getattr(
            self.app, "needs_schedule_stats",
            type(self.app).schedule_stats
            is not StradsAppBase.schedule_stats)
        return sched

    # -- partition injection (the partitioning contract) ---------------------

    def set_partitioner(self, spec: Optional[PartitionerSpec] = None):
        """Resolve a :class:`PartitionerSpec` (``None`` → the app's
        ``default_partitioner_spec()``) into a
        partitioner and inject its initial assignment into the app.
        Idempotent for an unchanged spec: it then keeps the current
        assignment and activity stats, so an in-process resume continues
        the partition trajectory.  Returns the active partitioner (or
        ``None`` for apps with no partition story)."""
        resolved = spec if spec is not None else self._app_default(
            "default_partitioner_spec")
        if resolved == self._active_part_spec:
            return self.partitioner
        if resolved is None:
            self.partitioner = None
            self._active_part_spec = None
            self._part_stats = None
            self._install_assignment(None)
            return None
        kinds = getattr(self.app, "supported_partitioner_kinds", None)
        if kinds is not None and resolved.kind not in kinds:
            raise ValueError(
                f"{type(self.app).__name__} cannot host a "
                f"{resolved.kind!r} partitioner (it supports "
                f"{sorted(kinds)}); fix the plan's PartitionerSpec")
        if resolved.kind == "load_balanced" \
                and not self._has_partition_signal():
            raise ValueError(
                f"kind='load_balanced' needs a per-variable activity "
                f"signal, but {type(self.app).__name__} does not define "
                f"partition_signal(state); declare one (see "
                f"repro_torch.core.primitives) or use a static kind")
        sizes_fn = getattr(self.app, "partition_sizes", None)
        part = build_partitioner(
            resolved, num_vars=self.app.num_schedulable(),
            num_workers=self.workers,
            sizes=sizes_fn() if callable(sizes_fn) else None)
        self.partitioner = part
        self._active_part_spec = resolved
        self._part_stats = part.init_stats()
        # kept: rebuilding it is a host loop over every variable, and
        # each fresh execute resets to it
        self._initial_assignment = part.init_assignment()
        self._install_assignment(self._initial_assignment)
        return part

    def _has_partition_signal(self) -> bool:
        fn = getattr(type(self.app), "partition_signal", None)
        return (fn is not None
                and fn is not StradsAppBase.partition_signal)

    def _install_assignment(self, assignment: Optional[Assignment]):
        # The JAX engine keys its compiled programs on the assignment and
        # rebinds them here; the eager port compiles nothing, so a move
        # only reaches the app.
        self._assignment = assignment
        self.app.use_partition(assignment)

    @property
    def partitioner_spec(self) -> Optional[PartitionerSpec]:
        """The resolved spec of the active partitioner."""
        return self._active_part_spec

    @property
    def partition_assignment(self) -> Optional[Assignment]:
        """The active variable→worker assignment (``None`` without a
        partitioner)."""
        return self._assignment

    @property
    def partition_stats(self):
        """The partitioner's host-side activity state (the load
        balancer's per-variable EMA; ``None`` for stateless kinds)."""
        return self._part_stats

    def reset_partition(self):
        """Back to the partitioner's initial assignment and fresh stats —
        what a fresh (carry-less, payload-less) ``execute`` does, so
        rebalances of a previous run never leak into a new one."""
        part = self.partitioner
        if part is None:
            return
        self._part_stats = part.init_stats()
        if self._assignment is not self._initial_assignment:
            self._install_assignment(self._initial_assignment)

    def apply_assignment(self, assignment: Assignment, state: Any = None):
        """Adopt a new assignment mid-run: the KV store re-derives its
        specs (:meth:`~repro_torch.core.kvstore.KVStore.repartition`; on
        one card the built-in apps' state comes back unchanged) and the
        app receives it via ``use_partition``.  Returns the state when
        one is passed."""
        out = None
        if self.kvstore is not None:
            out = self.kvstore.repartition(assignment, state)
        elif state is not None:
            out = state
        self._install_assignment(assignment)
        return out

    def partition_payload(self) -> Optional[dict]:
        """The ``"assignment"`` subtree of a chunked run's checkpoint:
        the assignment arrays plus the partitioner's activity stats
        (``stats_<name>``), flat numpy.  ``None`` without a
        partitioner."""
        if self._assignment is None:
            return None
        payload = dict(self._assignment.payload())
        if isinstance(self._part_stats, dict):
            for k, v in self._part_stats.items():
                payload[f"stats_{k}"] = np.asarray(v)
        return payload

    def restore_partition(self, payload: dict):
        """Resume the partition trajectory from a checkpoint's
        ``"assignment"`` payload (``execute(..., partition=...)``): the
        saved assignment is re-applied and the activity stats restored,
        so the resumed run replays the remaining rebalance decisions
        bit-exactly."""
        if self.partitioner is None:
            raise ValueError(
                "restore_partition needs an active partitioner (the "
                "plan/app resolved none) — was this checkpoint written "
                "under a different plan?")
        asgn = Assignment.from_payload(
            {k: payload[k] for k in ("owner", "num_workers", "version")})
        if asgn.num_workers != self.workers:
            raise ValueError(
                f"checkpointed assignment spans {asgn.num_workers} "
                f"workers but the engine has {self.workers} workers")
        num_vars = self.partitioner.num_vars
        if asgn.num_vars != num_vars:
            raise ValueError(
                f"checkpointed assignment covers {asgn.num_vars} "
                f"variables but this app partitions {num_vars} — was "
                f"this checkpoint written for a different model size?")
        stats = {k[len("stats_"):]: np.asarray(v)
                 for k, v in payload.items() if k.startswith("stats_")}
        fresh = self.partitioner.init_stats()
        if (stats or fresh is not None) and set(stats) != \
                set(fresh or {}):
            raise ValueError(
                f"checkpointed partition stats {sorted(stats)} do not "
                f"match the resolved {self._active_part_spec.kind!r} "
                f"partitioner's {sorted(fresh or {})} — the "
                f"PartitionerSpec must match across resume")
        if stats:
            self._part_stats = stats
        self.apply_assignment(asgn)

    def _partition_signal_snapshot(self, state) -> Optional[np.ndarray]:
        """Host copy of the app's per-variable partition signal (a copy:
        the next chunk may write the state in place)."""
        if self.partitioner is None:
            return None
        sig = self.app.partition_signal(state)
        if sig is None:
            return None
        return np.array(sig.detach().cpu())

    def _partition_step(self, state, sig_before, t: int,
                        allow_move: bool = True):
        """One chunk-boundary partition check: fold the chunk's activity
        |Δsignal| into the partitioner's stats and rebalance when the
        policy says so.  Returns ``(state, sig_after)``: the chunk-end
        snapshot is the next chunk's baseline (``sig_before=None`` — a
        stateless policy or no app signal — skips the snapshot, and so
        the host sync).  ``allow_move=False`` measures but never moves:
        the final boundary, after which no round runs."""
        part = self.partitioner
        sig_after = (self._partition_signal_snapshot(state)
                     if sig_before is not None else None)
        activity = (np.abs(sig_after - sig_before)
                    if sig_after is not None else None)
        self._part_stats = part.measure(self._part_stats,
                                        self._assignment, activity)
        if allow_move and part.should_rebalance(
                self._part_stats, self._assignment, t):
            new = part.propose_assignment(self._part_stats,
                                          self._assignment)
            if new.owner != self._assignment.owner:
                # the rebalance event carries the measured before/after
                # load spreads (the imbalance the move was for)
                weights = (self._part_stats.get("ema")
                           if isinstance(self._part_stats, dict) else None)
                if weights is not None:
                    self._obs_event(
                        "rebalance", t=t,
                        spread_before=self._assignment.spread(weights),
                        spread_after=new.spread(weights),
                        version=new.version)
                else:
                    self._obs_event("rebalance", t=t, version=new.version)
                state = self.apply_assignment(new, state)
        return state, sig_after

    def set_kernels(self, spec: Optional[KernelSpec] = None):
        """Resolve a :class:`KernelSpec` (``None`` → the constructor spec,
        else the app's ``default_kernel_spec()``, else ``reference``)
        into a backend and inject it.  Returns the backend."""
        if spec is None:
            spec = self._kern_override
        resolved = spec if spec is not None else self._app_default(
            "default_kernel_spec")
        if resolved is None:
            resolved = KernelSpec(kind="reference")
        if resolved == self._active_kern_spec:
            return self.kernels
        kinds = getattr(self.app, "supported_kernel_kinds", None)
        if kinds is not None and resolved.kind not in kinds:
            raise ValueError(
                f"{type(self.app).__name__} cannot dispatch a "
                f"{resolved.kind!r} kernel backend (it supports "
                f"{sorted(kinds)}); fix the plan's KernelSpec")
        backend = build_kernels(resolved)
        self.app.use_kernels(backend)
        self._active_kern_spec = resolved
        return backend

    @property
    def phase_period(self) -> int:
        """Length of the app's static-phase cycle (1 = phaseless)."""
        return int(getattr(self.app, "phase_period", 1))

    def _app_default(self, name: str):
        fn = getattr(self.app, name, None)
        return fn() if callable(fn) else None

    @property
    def scheduler(self):
        return getattr(self.app, "scheduler", None)

    @property
    def kernels(self):
        return getattr(self.app, "kernels", None)

    def init_sched_carry(self):
        """A fresh scheduler carry (``None`` for stateless policies)."""
        sched = self.scheduler
        return sched.init_carry(self.device) if sched is not None else None

    def mark_sched_carry(self, carry, candidates):
        """The SSP in-flight exclusion over the scheduler carry (identity
        without an injected scheduler; priority tables kept in the state
        go through :class:`~repro_torch.core.kvstore.VarTable`)."""
        sched = self.scheduler
        return (sched.mark_scheduled(carry, candidates)
                if sched is not None else carry)

    def app_roles(self) -> dict:
        """The app's VarSpec role map (``var_roles()``: ``"priority"``
        leaves the SSP window masks for in-flight exclusion when an app
        keeps its priority table in its state)."""
        fn = getattr(self.app, "var_roles", None)
        return dict(fn()) if callable(fn) else {}

    # -- placement -----------------------------------------------------------

    def shard_data(self, data: dict) -> dict:
        """Move data leaves to the device; ``"data"`` leaves take the
        (W, n/W, …) worker layout (a view — no copy on the device)."""
        return {k: place(k, v, self.data_specs.get(k), self.workers,
                         self.device)
                for k, v in data.items()}

    def place_state(self, state: dict) -> dict:
        """Place a state through a :class:`KVStore` built from it — the
        one source of variable placement and byte accounting
        (``self.kvstore.bytes_per_device()`` afterwards)."""
        specs = {k: self.state_specs.get(k) for k in state}
        self.kvstore = store_from_tree(self.workers, state, specs,
                                       roles=self.app_roles())
        return self.kvstore.place_tree(state, self.device)

    def init_state(self, **app_kwargs) -> dict:
        """``app.init_state(**app_kwargs)``, placed like the data."""
        return self.place_state(self.app.init_state(**app_kwargs))

    def unshard(self, state: dict) -> dict:
        """Merge the worker axis of row-sharded state leaves back:
        (W, n/W, …) → (n, …)."""
        return {k: (v.reshape(-1, *v.shape[2:])
                    if self.state_specs.get(k) == DATA_AXIS else v)
                for k, v in state.items()}

    # -- the round -----------------------------------------------------------

    def _noise(self, generator, noise, t: int):
        """The round's (J,) Gumbel draw, or ``None`` for policies that
        need none."""
        sched = self.scheduler
        if sched is None or not sched.needs_noise:
            return None
        if noise is not None:
            return torch.as_tensor(noise(t), dtype=torch.float32,
                                   device=self.device)
        if self.app.own_noise:
            return None
        u = torch.rand((self.app.num_schedulable(),), generator=generator,
                       device=self.device)
        return -torch.log(-torch.log(u.clamp_min_(_TINY)))

    def _make_schedule(self, state, carry, data, noise, t, phase):
        """propose → [schedule_stats → Σ_workers] → schedule."""
        app = self.app
        cand = app.propose(state, carry, noise, t, phase)
        stats = (tree_psum(app.schedule_stats(data, state, cand, phase))
                 if self._needs_stats else None)
        return app.schedule(state, carry, cand, stats, t, phase)

    def _update(self, state, data, sched, sc, phase, tm=no_timer):
        """push → Σ_workers → pull (the BSP update + sync) →
        ``sched_update``, under the ``push`` and ``pull`` timers.  Returns
        the new state and scheduler carry."""
        app = self.app
        with tm("push"):
            z, local = app.push(data, state, sched, phase)
            z = tree_psum(z)
        with tm("pull"):
            new_state = app.pull(state, sched, z, local, data, phase)
            return new_state, app.sched_update(sc, state, new_state, sched,
                                               phase)

    def _generator(self, generator):
        if generator is None:
            generator = torch.Generator(device=self.device)
            generator.manual_seed(0)
        elif generator.device.type != self.device.type:
            raise ValueError(f"the generator lies on {generator.device} but "
                             f"the engine runs on {self.device}")
        return generator

    def run_round(self, state, data, generator=None, t: int = 0,
                  sched_carry: Any = _UNSET,
                  noise: Optional[Callable] = None) -> RoundResult:
        """One BSP round.  ``sched_carry`` defaults to a fresh
        ``init_carry``; thread ``result.sched_carry`` back in to keep a
        stateful policy's priorities evolving across rounds."""
        if sched_carry is _UNSET:
            sched_carry = self.init_sched_carry()
        tm = self._timer()
        with tm("round"):
            phase = self.app.static_phase(t)
            with tm("schedule"):
                g = self._noise(generator, noise, t)
                sched = self._make_schedule(state, sched_carry, data, g, t,
                                            phase)
            new_state, new_carry = self._update(state, data, sched,
                                                sched_carry, phase, tm)
        return RoundResult(state=new_state, sched=sched,
                           sched_carry=new_carry)

    def run(self, state, data, generator, num_rounds: int, callback=None):
        """``num_rounds`` BSP rounds on the loop executor with the default
        policies — exactly ``execute(plan(executor="loop"))``."""
        if num_rounds < 1:
            return state
        self.set_scheduler(None)
        self.set_kernels(None)
        plan = ExecutionPlan(executor="loop", rounds=num_rounds)
        return self.execute(state, data, generator, plan,
                            callback=callback).state

    def run_ssp(self, state, data, generator, num_rounds: int, *,
                staleness: int = 0, **kw):
        """The bounded-staleness executor (:func:`repro_torch.ps.run_ssp`):
        reads of whole (server-resident) leaves served from a cache up to
        ``staleness`` rounds old, pushes summed over the workers at the
        flush.  ``staleness=0`` equals ``scan`` to the bit."""
        from ..ps.ssp import run_ssp
        return run_ssp(self, state, data, generator, num_rounds,
                       staleness=staleness, **kw)

    # -- the entry point -----------------------------------------------------

    def execute(self, state, data, generator, plan: ExecutionPlan, *,
                collect: Optional[Callable[[Any], Any]] = None,
                callback=None, carry: Optional[EngineCarry] = None,
                noise: Optional[Callable[[int], Any]] = None,
                ckpt_dir: Optional[str] = None,
                partition: Optional[dict] = None,
                stream=None, source=None,
                stream_state: Optional[dict] = None) -> ExecutionReport:
        """Run an :class:`ExecutionPlan` and return an
        :class:`ExecutionReport`.

        ``generator`` (a ``torch.Generator`` on the engine's device;
        ``None`` = a fresh one seeded 0) draws the per-round scheduler
        noise; ``noise(t) -> (J,)`` replaces it with a caller's source.
        ``collect(state)`` runs after every round and the report's
        ``trace`` stacks its outputs.  ``callback(t, state, result)`` is
        the host-loop hook (``executor="loop"`` only; return True to stop
        early).  ``carry`` resumes a previous report's run of the same
        plan: rounds ``carry.t .. plan.rounds`` run with the carried
        scheduler carry, generator state, (pipelined) in-flight schedule
        and (ssp: an :class:`~repro_torch.ps.SSPCarry`) vector clocks.

        ``plan.partitioner`` selects the partition policy (``None``: the
        app's default).  A fresh run (no ``carry``) starts from the
        partitioner's initial assignment; ``partition=`` (a checkpoint's
        ``"assignment"`` payload) restores a saved one and its stats.

        ``ckpt_dir`` + ``plan.checkpoint_every`` chunk the run: every
        ``checkpoint_every`` rounds (a multiple of the executor's step
        length) the partitioner checks for a rebalance and a
        ``{"state", "carry", "assignment"}`` checkpoint is written as
        ``ckpt_dir/step_%08d.npz`` (the ``"assignment"`` subtree when a
        partitioner is active).  Restore it with
        :func:`repro_torch.checkpoint.restore_checkpoint` and pass its
        ``carry`` and ``assignment`` back to resume bit-exactly.

        ``plan.telemetry`` (a :class:`~repro_torch.obs.TelemetrySpec`)
        instruments the run without changing a bit of it: the carry's
        ``obs`` holds the device counters (continued from ``carry.obs``
        on a resume), ``kind="trace"`` records host spans and instants,
        and the report's ``telemetry`` is a
        :class:`~repro_torch.obs.RunReport` (for ``ssp`` plans with the
        chunks' staleness summaries merged into its ``ssp``).  Without a
        spec it is ``None``.

        ``stream`` (a :class:`~repro_torch.stream.StreamSpec`) +
        ``source`` (a :class:`~repro_torch.stream.DataSource`) ingest
        data deltas at host-synced boundaries ``t % stream.ingest_every
        == 0`` (a multiple of the executor's step length), before the
        span that starts there and after the checkpoint of the span that
        ends there.  The app's ``ingest`` writes the rows into ``data``'s
        tensors and the boundary state's, in place: copy what you replay
        from.  An ``EmptySource`` run equals an unstreamed one to the
        bit.  ``stream_state`` resumes the ring cursor from a
        checkpoint's ``"stream"`` payload (pair it with
        :func:`repro_torch.stream.replay_data` when the resumed process
        no longer holds the streamed data); the report's ``stream`` is
        the final cursor."""
        if not isinstance(plan, ExecutionPlan):
            raise TypeError(f"execute() wants an ExecutionPlan; got "
                            f"{type(plan).__name__}")
        # telemetry: counters ride the carry on every executor; host
        # events and round timers go to the attached Recorder, else to
        # one the engine attaches while a profiler session is live, else
        # under the trace kind to one for this execute alone
        tspec = plan.telemetry or None
        traced = tspec is not None and tspec.events
        if profiler_live():
            if self._recorder is None:
                self._recorder, self._own_recorder = Recorder(), True
        elif self._own_recorder and not traced:
            self._recorder, self._own_recorder = None, False
        rec, temporary = self._recorder, False
        if rec is None and traced:
            rec = self._recorder = Recorder(profiler=tspec.profiler)
            temporary = True
        first_event = rec.num_events if rec is not None else 0
        # the run gets this frame's reference to the start state: a
        # caller that drops its own (the serve loop) frees it after the
        # first round
        held, state = [state], None
        try:
            with (rec.span("execute", executor=plan.executor,
                           rounds=plan.rounds) if rec is not None
                  else _NULL_CTX):
                rep = self._run_plan(
                    held.pop(), data, generator, plan, collect, callback,
                    carry, noise, ckpt_dir, partition, stream, source,
                    stream_state)
        finally:
            if temporary:
                self._recorder = None
        if tspec is None:
            rep.telemetry = None
            return rep
        parts = rep.telemetry if isinstance(rep.telemetry, list) else (
            [rep.telemetry] if rep.telemetry is not None else [])
        if len(parts) > 1:
            from ..ps.telemetry import merge_summaries
            ssp = merge_summaries(parts)
        else:
            ssp = parts[0] if parts else None
        rep.telemetry = RunReport.build(
            tspec, plan.executor, int(rep.carry.t),
            device_counters=getattr(rep.carry, "obs", None),
            recorder=rec if traced else None, first_event=first_event,
            ssp=ssp)
        return rep

    def _run_plan(self, state, data, generator, plan, collect, callback,
                  carry, noise, ckpt_dir, partition, stream, source,
                  stream_state) -> ExecutionReport:
        """:meth:`execute` inside its span: the plan's checks, policies
        and resume, then its chunks or its one span."""
        if plan.workers is not None and plan.workers != self.workers:
            raise ValueError(
                f"plan.workers={plan.workers} but the engine has "
                f"{self.workers} '{DATA_AXIS}' workers")
        if callback is not None and plan.executor != "loop":
            raise ValueError("callback is a host-loop hook; it requires "
                             f"executor='loop' (got {plan.executor!r})")
        self.set_scheduler(plan.scheduler)
        self.set_partitioner(plan.partitioner)
        self.set_kernels(plan.kernels)
        if partition is not None:
            self.restore_partition(partition)
        elif carry is None:
            # fresh run: rebalances of a previous execute of the same
            # spec must not leak in (in-process resumes keep them)
            self.reset_partition()
        generator = self._generator(generator)
        t_done = 0
        if carry is not None:
            from ..ps.ssp import SSPCarry
            if plan.executor == "ssp" and not isinstance(carry, SSPCarry):
                raise ValueError("resuming an ssp plan needs the SSPCarry "
                                 "a previous ssp report returned")
            if plan.executor in ("scan", "pipelined") \
                    and not isinstance(carry, EngineCarry):
                raise ValueError("resuming a scanned plan needs the "
                                 "EngineCarry a previous scan/pipelined "
                                 "report returned")
            if not isinstance(carry, (EngineCarry, SSPCarry)):
                raise ValueError(f"carry must be the EngineCarry or "
                                 f"SSPCarry a previous report returned; "
                                 f"got {type(carry).__name__}")
            depth = getattr(carry, "depth", 0)
            if plan.executor == "pipelined" and depth != 1:
                raise ValueError("resuming a pipelined plan needs the "
                                 "carried in-flight schedule (carry.depth "
                                 "is 0 — was this carry produced by a "
                                 "different executor?)")
            if plan.executor != "pipelined" and depth:
                raise ValueError("carry.sched only resumes the pipelined "
                                 "executor (pipeline_depth=1)")
            if (self.init_sched_carry() is None) != (carry.sched_carry
                                                     is None):
                raise ValueError(
                    "carry.sched_carry does not match the plan's resolved "
                    "scheduler (stateful vs stateless) — the "
                    "SchedulerSpec must match across resume")
            t_done = int(carry.t)
            if not 0 <= t_done < plan.rounds:
                raise ValueError(f"carry.t={t_done} leaves no rounds of the "
                                 f"plan's {plan.rounds} to run")
            if carry.rng_state is not None:
                generator.set_state(carry.rng_state)
        if ckpt_dir and not plan.checkpoint_every:
            raise ValueError("ckpt_dir was passed but plan.checkpoint_"
                             "every=0 — no checkpoint would ever be "
                             "written; set a cadence in the plan")
        if plan.checkpoint_every and not ckpt_dir:
            raise ValueError("plan.checkpoint_every="
                             f"{plan.checkpoint_every} but no ckpt_dir "
                             "was passed — the run would silently never "
                             "checkpoint")
        chunk = plan.checkpoint_every if ckpt_dir else 0
        if (stream is None) != (source is None):
            raise ValueError("stream= (a StreamSpec) and source= (a "
                             "DataSource) come as a pair — got only one")
        ingestor = None
        if stream is not None:
            from ..stream import Ingestor
            ingestor = Ingestor(stream, source)
            if stream_state is not None:
                ingestor.restore(stream_state)
            ingestor.bind(self, data)
        elif stream_state is not None:
            raise ValueError("stream_state resumes a streamed run; pass "
                             "the stream=/source= pair with it")
        pspec = self._active_part_spec
        if chunk and pspec is not None and pspec.rebalance_every \
                and pspec.rebalance_every % chunk:
            raise ValueError(
                f"partitioner.rebalance_every={pspec.rebalance_every} "
                f"must be a multiple of plan.checkpoint_every={chunk} — "
                f"repartition checks only run at chunk boundaries, so a "
                f"misaligned cadence would silently (almost) never fire")
        if not chunk and ingestor is None and pspec is not None \
                and pspec.kind == "load_balanced":
            warnings.warn(
                "a load_balanced partitioner only rebalances at "
                "checkpoint chunk boundaries; without plan."
                "checkpoint_every + ckpt_dir the assignment stays "
                "at its initial (static) value for the whole run",
                UserWarning, stacklevel=3)
        held, state = [state], None
        if chunk or ingestor is not None:
            return self._execute_chunked(
                held.pop(), data, generator, plan, t_done, carry, collect,
                callback, noise, chunk, ckpt_dir, ingestor)
        return self._execute_span(held.pop(), data, generator, plan,
                                  plan.rounds - t_done, t_done, carry,
                                  collect, callback, noise)

    def _execute_chunked(self, state, data, generator, plan, t_done: int,
                         carry, collect, callback, noise, chunk: int,
                         ckpt_dir: Optional[str],
                         ingestor=None) -> ExecutionReport:
        """The boundary-chunked run (checkpoint cadence, ingest cadence,
        or their gcd when both are set): spans from boundary to boundary,
        each boundary ingesting at its top; at the checkpoint boundaries
        (every boundary without a checkpoint cadence) the partition check
        and, with ``ckpt_dir``, a checkpoint at its bottom.  Under an ssp
        plan with telemetry the report's ``telemetry`` is the list of the
        spans' staleness summaries (``execute`` merges them)."""
        ing_every = ingestor.spec.ingest_every if ingestor is not None \
            else 0
        step_len = self._step_length(plan)
        if chunk and chunk % step_len:
            raise ValueError(
                f"plan.checkpoint_every={chunk} must be a multiple of the "
                f"{plan.executor!r} executor's step length {step_len} "
                f"(phase/window alignment), so every chunk resumes on a "
                f"step boundary")
        if ing_every and ing_every % step_len:
            raise ValueError(
                f"stream.ingest_every={ing_every} must be a multiple of "
                f"the {plan.executor!r} executor's step length {step_len} "
                f"(phase/window alignment), so every ingest boundary is "
                f"host-synced")
        if plan.executor in ("pipelined", "ssp") \
                and plan.rounds % step_len:
            # fail before any chunk runs — the same plan without ckpt_dir
            # is rejected upfront by the executor itself
            raise ValueError(
                f"plan.rounds={plan.rounds} must be a multiple of the "
                f"{plan.executor!r} executor's step length {step_len}; "
                f"the final checkpoint chunk would be unrunnable")
        # with both cadences set, spans run boundary to boundary; a plain
        # checkpointed run keeps span == chunk
        span = (math.gcd(chunk, ing_every) if chunk and ing_every
                else (chunk or ing_every))
        stops: list = []                        # callback early-stop marker
        cb = callback
        if callback is not None:
            def cb(t, s, out, _orig=callback):
                r = _orig(t, s, out)
                if r:
                    stops.append(t)
                return r
        traces = []
        ssp_parts: list = []
        t = t_done
        # the activity baseline costs a host sync, so only a stateful
        # policy takes it; each later chunk reuses the previous boundary's
        sig0 = (self._partition_signal_snapshot(state)
                if self._part_stats is not None else None)
        while t < plan.rounds:
            if ingestor is not None:
                # ingest at the top, checkpoint at the bottom: the
                # checkpoint at t precedes the ingest at t, so a resumed
                # run ingests boundary t as the uninterrupted one did
                state, data = ingestor.step(self, state, data, t)
            # hand the span the only reference this loop has to its start
            # state (not this variable, nor the last span's report or
            # checkpoint payload), so its first round can free it as an
            # unchunked run's does: MF's R is 9.3 GB at the chip shape
            held, state, rep, payload = [state], None, None, None
            rep = self._execute_span(held.pop(), data, generator, plan,
                                     min(span, plan.rounds - t), t, carry,
                                     collect, cb, noise)
            state, carry = rep.state, rep.carry
            if rep.trace is not None:
                traces.append(rep.trace)
            if rep.telemetry is not None:
                ssp_parts.append(rep.telemetry)
            t = int(carry.t)
            at_chunk = (not chunk or t % chunk == 0 or t >= plan.rounds
                        or bool(stops))
            if self.partitioner is not None and at_chunk:
                # after the last chunk no round runs: measure, never move
                state, sig0 = self._partition_step(
                    state, sig0, t, allow_move=t < plan.rounds)
            if ckpt_dir and at_chunk:
                payload = {"state": state, "carry": carry}
                if self.partitioner is not None:
                    payload["assignment"] = self.partition_payload()
                if ingestor is not None:
                    payload["stream"] = ingestor.payload()
                with self._obs_span("checkpoint", t=t):
                    save_checkpoint(ckpt_dir, t, payload)
            if stops:                           # honored across chunks
                break
        return ExecutionReport(state=state, trace=_concat(traces),
                               telemetry=ssp_parts or None, carry=carry,
                               plan=plan,
                               stream=(ingestor.payload()
                                       if ingestor is not None else None))

    def _step_length(self, plan: ExecutionPlan) -> int:
        """Rounds one step of the plan's executor covers — the alignment
        unit of checkpoint chunks and resume points."""
        if plan.executor == "ssp":
            from ..ps.ssp import rounds_per_step
            return rounds_per_step(self, plan.staleness)
        if plan.executor in ("scan", "pipelined"):
            return self.phase_period * plan.phase_unroll
        return 1                                # loop: any round

    def _carry(self, t: int, sc, generator, noise, sched=None,
               depth: int = 0, obs=None) -> EngineCarry:
        return EngineCarry(t=t, sched_carry=sc,
                           rng_state=(None if noise is not None
                                      else generator.get_state()),
                           sched=sched, depth=depth, obs=obs)

    def _execute_span(self, state, data, generator, plan: ExecutionPlan,
                      rounds: int, t0: int, prev_carry, collect, callback,
                      noise) -> ExecutionReport:
        """One contiguous span of a plan (the whole plan, or one
        checkpoint chunk) on the executor it names.  Under an ssp plan
        with telemetry the report's ``telemetry`` is the span's raw
        :class:`~repro_torch.ps.telemetry.SSPTelemetry`."""
        sc = (prev_carry.sched_carry if prev_carry is not None
              else self.init_sched_carry())
        # device counters: the previous chunk's (bit-exact through
        # chunking and resumes), else fresh when the plan is instrumented
        obs = getattr(prev_carry, "obs", None)
        if obs is None and plan.telemetry:
            obs = obs_counters.init_counters(self.phase_period, self.device)
        # ssp and pipelined get the only reference this frame has to the
        # start state, so they can free it after its first round (see
        # _execute_chunked); loop and scan rebind it below
        held, state = [state], None
        if plan.executor == "ssp":
            from ..ps.ssp import run_ssp
            with self._obs_span("ssp", t0=t0, rounds=rounds,
                                staleness=plan.staleness):
                state, *rest = run_ssp(
                    self, held.pop(), data, generator, rounds,
                    staleness=plan.staleness, collect=collect,
                    with_telemetry=bool(plan.telemetry), t0=t0,
                    clocks=getattr(prev_carry, "clocks", None),
                    sched_carry0=sc, obs0=obs, return_carry=True,
                    noise=noise)
            trace = rest.pop(0) if collect is not None else None
            telem = rest.pop(0) if plan.telemetry else None
            return ExecutionReport(state=state, trace=trace,
                                   telemetry=telem, carry=rest.pop(0),
                                   plan=plan)
        period = self.phase_period
        if plan.executor != "loop" and t0 % period:
            raise ValueError(f"t0 must be a multiple of the phase period "
                             f"({period}) so phases stay static; got {t0}")
        if plan.executor == "pipelined":
            with self._obs_span("pipelined", t0=t0, rounds=rounds):
                return self._execute_pipelined(held.pop(), data, generator,
                                               plan, rounds, t0, prev_carry,
                                               sc, collect, noise, obs)
        # loop and scan share this body; scan has no callback and nothing
        # in it reads a device value on the host
        ys: list = []
        executed = 0
        num_cand = self._obs_num_candidates()
        state = held.pop()
        with self._obs_span(plan.executor, t0=t0, rounds=rounds):
            for k in range(rounds):
                t = t0 + k
                out = self.run_round(state, data, generator, t,
                                     sched_carry=sc, noise=noise)
                state, sc = out.state, out.sched_carry
                if obs is not None:
                    obs = obs_counters.observe_round(obs, out.sched,
                                                     t % period, num_cand)
                executed = k + 1
                if collect is not None:
                    ys.append(collect(state))
                if callback is not None and callback(t, state, out):
                    break
        return ExecutionReport(
            state=state, trace=_stack(ys) if ys else None, plan=plan,
            carry=self._carry(t0 + executed, sc, generator, noise,
                              obs=obs))

    def _execute_pipelined(self, state, data, generator, plan, rounds: int,
                           t0: int, prev_carry, sc, collect, noise,
                           obs=None) -> ExecutionReport:
        """The pipelined executor (the JAX package's depth-1 scan body):
        at round t the schedule of round t+1 is made from the state and
        scheduler carry before round t's update, then round t runs the
        schedule made a round earlier.  A fresh run makes one schedule
        more than it runs (round ``t0``'s, before the loop); a resumed
        run takes that one from ``prev_carry.sched``."""
        app = self.app
        period, unroll = self.phase_period, plan.phase_unroll
        if rounds % (period * unroll):
            raise ValueError(
                f"pipeline_depth=1 needs num_rounds divisible by the app's "
                f"phase_period ({period}) × unroll ({unroll}); got "
                f"{rounds}")
        if prev_carry is not None and prev_carry.depth == 1:
            sched = prev_carry.sched            # the in-flight schedule
        else:
            # the fresh run's extra schedule: outside every round's timers
            sched = self._make_schedule(
                state, sc, data, self._noise(generator, noise, t0), t0,
                app.static_phase(t0))
        ys: list = []
        num_cand = self._obs_num_candidates()
        tm = self._timer()
        for t in range(t0, t0 + rounds):
            with tm("round"):
                phase = app.static_phase(t)
                with tm("schedule"):
                    sched_next = self._make_schedule(
                        state, sc, data,
                        self._noise(generator, noise, t + 1), t + 1,
                        app.static_phase(t + 1))
                if obs is not None:
                    # count the schedule the round executes (the one-
                    # round-stale one), not the prefetch
                    obs = obs_counters.observe_round(obs, sched,
                                                     t % period, num_cand)
                new_state, sc = self._update(state, data, sched, sc, phase,
                                             tm)
            state, sched = new_state, sched_next
            if collect is not None:
                ys.append(collect(state))
        return ExecutionReport(
            state=state, trace=_stack(ys) if ys else None, plan=plan,
            carry=self._carry(t0 + rounds, sc, generator, noise,
                              sched=sched, depth=1, obs=obs))


def _stack(ys: list):
    first = ys[0]
    if isinstance(first, dict):
        return {k: _stack([y[k] for y in ys]) for k in first}
    return torch.stack([torch.as_tensor(y) for y in ys])


def _concat(traces: list):
    """Per-chunk stacked traces joined along the round axis."""
    if not traces:
        return None
    if isinstance(traces[0], dict):
        return {k: _concat([tr[k] for tr in traces]) for k in traces[0]}
    return torch.cat(traces)


__all__ = ["DATA_AXIS", "EngineCarry", "StradsEngine", "resolve_device"]
