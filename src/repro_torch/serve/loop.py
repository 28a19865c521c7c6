"""The continuous-training loop: ``serve_while_training``, from the JAX
package's ``serve/loop.py``.

The loop interleaves :meth:`~repro_torch.core.StradsEngine.execute`
chunks with serving reads at the SSP flush boundaries: the plan is
chunked into spans of the executor's step length (for ``"ssp"``
``rounds_per_step = lcm(s+1, phase_period)``, one flush window, so every
publish point is a flush), each span resumes the previous one's
:class:`~repro_torch.core.EngineCarry`/``SSPCarry`` (the bit-exact
resume path checkpoints use; the noise generator's state rides it), and
between spans the committed state is published to the
:class:`~repro_torch.serve.view.ModelView` and the queued requests are
served.  The view is released before each chunk, so no read can see the
chunk's in-place writes.

Serving touches training only through ``publish`` (which copies what it
keeps) — never the noise stream, the scheduler carry or the state — so
the final trained state of a served run equals an unserved ``execute()``
of the same plan to the bit.

Requests fold in by due round: ``requests`` is a sequence of
``(t_due, payload)`` pairs, submitted at the first boundary whose clock
reaches ``t_due``.  Spans and instants ride a caller's
:class:`~repro_torch.obs.Recorder`, attached to the engine when the
engine has none, else the engine's
(:attr:`~repro_torch.core.StradsEngine.recorder`), so they make one
timeline: ``train_chunk`` spans around each ``execute`` (with its own
spans and round timers inside), ``serve_publish`` and ``serve_batch``
spans and ``serve_read`` / ``serve_refresh`` / ``serve_pin`` instants
between them.

Streaming ingest (``stream=``/``source=``) lands at the same boundaries:
boundary 0 ingests before the clock-0 publish, each later boundary after
its chunk and before its publish.  The ingest writes the state in place,
and the view was released before the chunk, so no published view holds
a tensor the ingest writes.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, List, Optional, Sequence, Tuple

from ..core.engine import _concat
from ..core.plan import ExecutionPlan, ExecutionReport
from .frontend import ServeFrontend, _percentiles
from .spec import ServeSpec
from .view import ModelView


@dataclasses.dataclass
class ServeReport:
    """What a serving run produced: the training report (``None`` for
    ``serve_only``), every response, and the measured serving record."""
    report: Optional[ExecutionReport]
    responses: List[Any]
    latencies_ms: List[float]
    reads: List[dict]
    spec: ServeSpec
    ingest: Optional[dict] = None

    def latency_percentiles(self) -> dict:
        return _percentiles(self.latencies_ms)

    def staleness_hist(self) -> dict:
        hist: dict = {}
        for r in self.reads:
            hist[r["staleness"]] = hist.get(r["staleness"], 0) + 1
        return hist

    def max_staleness_read(self) -> int:
        return max((r["staleness"] for r in self.reads), default=0)


def _resolve_spec(spec, plan: Optional[ExecutionPlan]) -> ServeSpec:
    if spec is not None:
        if not isinstance(spec, ServeSpec):
            raise TypeError(f"wanted a ServeSpec; got "
                            f"{type(spec).__name__}")
        return spec
    # the conventional default ties the serving bound to the training
    # one: an SSP plan's reads are already s-stale
    s = plan.staleness if plan is not None and plan.executor == "ssp" else 0
    return ServeSpec.default_for("stale", max_staleness=s)


def _check_requests(requests) -> List[Tuple[int, Any]]:
    out = []
    for item in requests:
        if not (isinstance(item, tuple) and len(item) == 2
                and isinstance(item[0], int)):
            raise TypeError("serve_while_training wants requests as "
                            "(t_due, payload) pairs; got "
                            f"{type(item).__name__}")
        out.append(item)
    return sorted(out, key=lambda it: it[0])


def serve_while_training(engine, state, data, generator,
                         plan: ExecutionPlan, *,
                         spec: Optional[ServeSpec] = None,
                         requests: Sequence[Tuple[int, Any]] = (),
                         collect=None, recorder=None,
                         chunk_rounds: Optional[int] = None,
                         noise: Optional[Callable[[int], Any]] = None,
                         stream=None, source=None,
                         stream_state: Optional[dict] = None
                         ) -> ServeReport:
    """Train ``plan`` to completion while serving ``requests`` between
    chunks.  Returns a :class:`ServeReport` whose ``report.state`` equals
    ``engine.execute(state, data, generator, plan).state`` to the bit
    (``generator``: a ``torch.Generator`` on the engine's device, or
    ``None`` for a fresh one seeded 0; ``noise(t)`` replaces its draws as
    in ``execute``).

    ``chunk_rounds`` overrides the publish cadence (a multiple of the
    executor's step length; default: one step — for SSP, one flush
    window).

    ``stream`` (a :class:`~repro_torch.stream.StreamSpec`) + ``source``
    ingest data deltas at the same boundaries serving publishes at: each
    boundary ``t`` ingests *before* the chunk covering ``[t, t+chunk)``
    runs and before the clock-``t`` publish, the ordering
    ``engine.execute(..., stream=)`` uses — so a served streamed run's
    trained state equals an unserved streamed one to the bit, and every
    published view includes all deltas due ≤ its clock.  As in
    ``execute``, the ingest writes into ``data``'s tensors and the
    state's.  The final cursor payload lands on the report as
    :attr:`ServeReport.ingest`."""
    spec = _resolve_spec(spec, plan)
    due = _check_requests(requests)
    step = engine._step_length(plan)
    chunk = chunk_rounds if chunk_rounds is not None else step
    if chunk < 1 or chunk % step:
        raise ValueError(f"chunk_rounds={chunk} must be a positive "
                         f"multiple of the {plan.executor!r} executor's "
                         f"step length {step}")
    for t_due, _ in due:
        if not 0 <= t_due <= plan.rounds:
            raise ValueError(f"request due round {t_due} outside the "
                             f"plan's 0..{plan.rounds}")
    if (stream is None) != (source is None):
        raise ValueError("stream= (a StreamSpec) and source= (a "
                         "DataSource) come as a pair — got only one")
    ing = None
    if stream is not None:
        from ..stream import Ingestor
        ing = Ingestor(stream, source)
        if stream_state is not None:
            ing.restore(stream_state)
        ing.bind(engine, data)
        if stream.ingest_every % chunk:
            raise ValueError(
                f"stream.ingest_every={stream.ingest_every} must be a "
                f"multiple of the serve chunk cadence {chunk} — ingest "
                f"boundaries land only where the loop syncs")
    elif stream_state is not None:
        raise ValueError("stream_state resumes a streamed run; pass "
                         "the stream=/source= pair with it")

    if recorder is None:
        recorder = engine.recorder
    view = ModelView(engine, spec, recorder=recorder)
    frontend = ServeFrontend(engine, view, spec, recorder=recorder)

    def pump(t: int, force: bool) -> None:
        while due and due[0][0] <= t:
            frontend.submit(due.pop(0)[1])
        frontend.flush(force=force)

    # boundary 0 ingests first, so the clock-0 publish (serving before
    # any training commits) already includes the deltas due at 0
    if ing is not None:
        state, data = ing.step(engine, state, data, 0)
    view.publish(state, 0)
    pump(0, force=False)

    carry = None
    traces = []
    t = 0
    rep = None
    while t < plan.rounds:
        target = min(t + chunk, plan.rounds)
        view.release()                    # training takes the state back
        span = (recorder.span("train_chunk", t0=t, t1=target)
                if recorder is not None else contextlib.nullcontext())
        with span:
            # hand the chunk the loop's only reference to its start state,
            # so its first round frees it (MF's R is 9.3 GB at the chip
            # shape)
            held, state, rep = [state], None, None
            rep = engine.execute(held.pop(), data, generator,
                                 dataclasses.replace(plan, rounds=target),
                                 collect=collect, carry=carry, noise=noise)
        state, carry = rep.state, rep.carry
        t = int(carry.t)
        if rep.trace is not None:
            traces.append(rep.trace)
        if ing is not None and t < plan.rounds:
            state, data = ing.step(engine, state, data, t)
        view.publish(state, t)
        pump(t, force=(t >= plan.rounds))

    report = ExecutionReport(state=state, trace=_concat(traces),
                             telemetry=rep.telemetry if rep is not None
                             else None, carry=carry, plan=plan,
                             stream=ing.payload() if ing is not None
                             else None)
    return ServeReport(report=report, responses=frontend.responses,
                       latencies_ms=frontend.latencies_ms,
                       reads=view.reads, spec=spec,
                       ingest=ing.payload() if ing is not None else None)


def serve_only(engine, state, *, spec: Optional[ServeSpec] = None,
               requests: Sequence[Any] = (), t: int = 0,
               recorder=None) -> ServeReport:
    """Serve ``requests`` (plain payloads, no due rounds) from a fixed
    trained state — the no-training baseline.  ``t`` stamps the clock
    the state is committed through."""
    spec = _resolve_spec(spec, None)
    view = ModelView(engine, spec, recorder=recorder)
    frontend = ServeFrontend(engine, view, spec, recorder=recorder)
    view.publish(state, t)
    for payload in requests:
        frontend.submit(payload)
    frontend.flush(force=True)
    return ServeReport(report=None, responses=frontend.responses,
                       latencies_ms=frontend.latencies_ms,
                       reads=view.reads, spec=spec)


__all__ = ["ServeReport", "serve_only", "serve_while_training"]
