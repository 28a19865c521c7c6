"""The STRADS round executors of the port: ``loop`` and ``scan``.

One round is the JAX package's (``core/engine.py``)

    propose → schedule_stats → Σ_workers → schedule → push → Σ_workers → pull

with the workers as a leading tensor axis (see
:mod:`repro_torch.core.primitives`), so the JAX ``shard_map`` + ``psum``
pair becomes per-worker partials and a ``.sum(0)``.

:meth:`StradsEngine.execute` is the one entry point, driven by an
:class:`~repro_torch.core.plan.ExecutionPlan`.  Both executors of this
port run the same round body in a Python loop, so ``loop`` ≡ ``scan``
bit for bit, as in the JAX package.  ``loop`` takes a per-round host
callback; ``scan`` takes none and never syncs with the host (capturing
its rounds as one CUDA graph is later work).  Apps whose rounds cycle
through static phases (``phase_period``: MF's H/W alternation is 2,
LDA's rotation U) run on both; ``scan`` holds them to the JAX scan's
rule that a run starts on a phase boundary.  Plan fields and executors
the port does not run yet raise ``NotImplementedError`` naming the
ROADMAP.md step that ports them; nothing silently runs something else.

Randomness: the JAX engine splits a PRNG key per round and draws the
scheduler's Gumbel noise from it.  The port draws one (J,) Gumbel vector
per round from a ``torch.Generator`` on the engine's device, or takes it
from a ``noise(t)`` source the caller passes (the parity tests feed the
JAX package's own draws that way).  An app that keys its draws itself
(``own_noise``: MF draws once per H/W cycle) gets ``None`` when the
caller passes no source.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import numpy as np
import torch

from ..kernels import KernelSpec, build_kernels
from ..sched import SchedulerSpec, build_scheduler
from .plan import ExecutionPlan, ExecutionReport
from .primitives import RoundResult, StradsAppBase, tree_psum

DATA_AXIS = "data"
_UNSET = object()
_TINY = float(np.finfo(np.float32).tiny)


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
    policies) and the state of the noise generator (``None`` when the
    noise came from a caller's source)."""
    t: int
    sched_carry: Any = None
    rng_state: Optional[torch.Tensor] = None


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
        self._active_kern_spec = None
        app.device = self.device
        self.set_kernels(None)
        self.set_scheduler(None)

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

    # -- placement -----------------------------------------------------------

    def _place(self, name: str, x, spec):
        x = torch.as_tensor(x, device=self.device)
        if x.is_floating_point():
            x = x.float()
        if spec != DATA_AXIS:
            return x
        n, W = x.shape[0], self.workers
        if n % W:
            raise ValueError(f"{name!r}: {n} rows do not split evenly over "
                             f"{W} workers")
        return x.reshape(W, n // W, *x.shape[1:])

    def shard_data(self, data: dict) -> dict:
        """Move data leaves to the device; ``"data"`` leaves take the
        (W, n/W, …) worker layout (a view — no copy on the device)."""
        return {k: self._place(k, v, self.data_specs.get(k))
                for k, v in data.items()}

    def init_state(self, **app_kwargs) -> dict:
        """``app.init_state(**app_kwargs)``, placed like the data."""
        state = self.app.init_state(**app_kwargs)
        return {k: self._place(k, v, self.state_specs.get(k))
                for k, v in state.items()}

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

    def _apply(self, state, data, sched, phase):
        """push → Σ_workers → pull (the BSP update + sync)."""
        z, local = self.app.push(data, state, sched, phase)
        return self.app.pull(state, sched, tree_psum(z), local, data, phase)

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
        phase = self.app.static_phase(t)
        g = self._noise(generator, noise, t)
        sched = self._make_schedule(state, sched_carry, data, g, t, phase)
        new_state = self._apply(state, data, sched, phase)
        new_carry = self.app.sched_update(sched_carry, state, new_state,
                                          sched, phase)
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
        scheduler carry and generator state."""
        if not isinstance(plan, ExecutionPlan):
            raise TypeError(f"execute() wants an ExecutionPlan; got "
                            f"{type(plan).__name__}")
        if plan.workers is not None and plan.workers != self.workers:
            raise ValueError(
                f"plan.workers={plan.workers} but the engine has "
                f"{self.workers} '{DATA_AXIS}' workers")
        if callback is not None and plan.executor != "loop":
            raise ValueError("callback is a host-loop hook; it requires "
                             f"executor='loop' (got {plan.executor!r})")
        _reject_unported(plan, ckpt_dir=ckpt_dir, partition=partition,
                         stream=stream, source=source,
                         stream_state=stream_state)
        self.set_scheduler(plan.scheduler)
        self.set_kernels(plan.kernels)
        generator = self._generator(generator)
        t0, sc = 0, self.init_sched_carry()
        if carry is not None:
            if not isinstance(carry, EngineCarry):
                raise ValueError(f"carry must be the EngineCarry a previous "
                                 f"report returned; got "
                                 f"{type(carry).__name__}")
            if (sc is None) != (carry.sched_carry is None):
                raise ValueError(
                    "carry.sched_carry does not match the plan's resolved "
                    "scheduler (stateful vs stateless) — the "
                    "SchedulerSpec must match across resume")
            t0, sc = int(carry.t), carry.sched_carry
            if not 0 <= t0 < plan.rounds:
                raise ValueError(f"carry.t={t0} leaves no rounds of the "
                                 f"plan's {plan.rounds} to run")
            if carry.rng_state is not None:
                generator.set_state(carry.rng_state)
        period = self.phase_period
        if plan.executor == "scan" and t0 % period:
            raise ValueError(f"t0 must be a multiple of the phase period "
                             f"({period}) so phases stay static; got {t0}")
        # loop and scan share this body; scan has no callback and nothing
        # in it reads a device value on the host
        ys: list = []
        t = t0
        for t in range(t0, plan.rounds):
            out = self.run_round(state, data, generator, t, sched_carry=sc,
                                 noise=noise)
            state, sc = out.state, out.sched_carry
            if collect is not None:
                ys.append(collect(state))
            if callback is not None and callback(t, state, out):
                break
        trace = _stack(ys) if ys else None
        return ExecutionReport(
            state=state, trace=trace, plan=plan,
            carry=EngineCarry(t=t + 1, sched_carry=sc,
                              rng_state=(None if noise is not None
                                         else generator.get_state())))


def _stack(ys: list):
    first = ys[0]
    if isinstance(first, dict):
        return {k: _stack([y[k] for y in ys]) for k in first}
    return torch.stack([torch.as_tensor(y) for y in ys])


# plan fields the port does not run yet → the ROADMAP.md step porting them
_STEP = {
    "pipelined": "queue 1, step 7 (the pipelined executor)",
    "ssp": "queue 1, step 9 (the SSP executor)",
    "checkpoint": "queue 1, step 6 (placement and checkpoints)",
    "partitioner": "queue 1, step 6 (placement and checkpoints)",
    "telemetry": "queue 1, step 10 (observability)",
    "stream": "queue 1, step 11 (serving and streaming)",
}


def _not_ported(what: str, key: str):
    return NotImplementedError(f"{what} is not ported yet: ROADMAP.md "
                               f"{_STEP[key]}")


def _reject_unported(plan: ExecutionPlan, *, ckpt_dir, partition, stream,
                     source, stream_state) -> None:
    if plan.executor in ("pipelined", "ssp"):
        raise _not_ported(f"executor={plan.executor!r}", plan.executor)
    if plan.checkpoint_every or ckpt_dir is not None:
        raise _not_ported("checkpointing (plan.checkpoint_every, "
                          "ckpt_dir)", "checkpoint")
    if plan.telemetry:
        raise _not_ported("plan.telemetry", "telemetry")
    if (plan.partitioner is not None
            and plan.partitioner.kind != "static") or partition is not None:
        raise _not_ported("a non-static partitioner", "partitioner")
    if stream is not None or source is not None or stream_state is not None:
        raise _not_ported("streaming ingest (stream=, source=)", "stream")


__all__ = ["DATA_AXIS", "EngineCarry", "StradsEngine", "resolve_device"]
