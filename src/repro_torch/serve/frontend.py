"""The micro-batching request frontend: :class:`ServeFrontend`, from the
JAX package's ``serve/frontend.py``.

Requests (per-example payloads, e.g. ``{"x": (J,)}`` for Lasso predict)
queue up between training chunks; ``flush()`` assembles them into
batches of at most ``ServeSpec.max_batch``, reads a state view from the
:class:`~repro_torch.serve.view.ModelView`, and calls the app's batched
``query()`` primitive.  Batching policy:

* a *full* batch (``max_batch`` queued requests) is served at once;
* a *partial* batch waits up to ``batch_window_ms`` for more arrivals
  (measured from its oldest request), then is served anyway;
* ``flush(force=True)`` drains everything regardless of the window.

The JAX package jits the query once per (Assignment, KernelSpec) and
records a ``cache_miss`` when it compiles; the port runs ``app.query``
eagerly, so it has neither.  A response's latency (submit → result
ready) ends after the query has run on the device: the frontend
synchronizes the device before it stamps the time, or a latency would
measure only the enqueue.

Each request gets an id from the frontend's counter.  On a Recorder (the
one the frontend is given, attached to the engine when the engine has
none; else the engine's, looked up at each flush) each batch is a
``serve_batch`` span that carries its requests' ids (``requests``) and
each one's wait in the queue, from ``submit`` to the batch's start on
the frontend's clock, in µs (``waits_us``); the fold-in (``app.query``)
is the ``serve_query`` timer.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, Callable, List, Optional

import numpy as np
import torch

from ..obs.events import no_timer
from .spec import ServeSpec
from .view import ModelView


@dataclasses.dataclass
class Request:
    """One queued query: a per-example payload, its submit time and its
    id (the frontend's count of requests before it)."""
    payload: Any
    t_submit: float
    id: int = 0


@dataclasses.dataclass
class Response:
    """One served query: the per-example result slice + bookkeeping."""
    result: Any
    latency_ms: float
    staleness: int


def _stack(payloads: list, device):
    """The batch of per-example payloads: each leaf stacked along a new
    leading axis, on ``device`` (tensors stacked where they lie, host
    values through one numpy array)."""
    first = payloads[0]
    if isinstance(first, dict):
        return {k: _stack([p[k] for p in payloads], device) for k in first}
    if all(torch.is_tensor(p) for p in payloads):
        return torch.stack(payloads).to(device)
    return torch.as_tensor(np.stack([np.asarray(p) for p in payloads]),
                           device=device)


def _row(out, i: int):
    if isinstance(out, dict):
        return {k: _row(v, i) for k, v in out.items()}
    return out[i]


class ServeFrontend:
    """Queue → batch assembly → the app's batched query."""

    def __init__(self, engine, view: ModelView, spec: ServeSpec,
                 recorder: Optional[Any] = None,
                 clock: Callable[[], float] = time.monotonic):
        if view.spec != spec:
            raise ValueError("the frontend and its ModelView must share "
                             "one ServeSpec")
        self.engine = engine
        self.view = view
        self.spec = spec
        self._recorder = recorder
        if recorder is not None and engine.recorder is None:
            engine.recorder = recorder
        self._clock = clock
        self._queue: deque = deque()
        self._next_id = 0
        self.responses: List[Response] = []
        self.latencies_ms: List[float] = []

    @property
    def recorder(self):
        """The Recorder the frontend was given, else the engine's."""
        return (self._recorder if self._recorder is not None
                else self.engine.recorder)

    # -- queue ---------------------------------------------------------------

    def submit(self, payload) -> int:
        """Enqueue one per-example query payload (no leading batch axis:
        the frontend stacks); returns its request id."""
        rid = self._next_id
        self._next_id += 1
        self._queue.append(Request(payload, self._clock(), rid))
        return rid

    def pending(self) -> int:
        return len(self._queue)

    # -- batch assembly + serving --------------------------------------------

    def _take_batch(self, force: bool) -> Optional[List[Request]]:
        q, spec = self._queue, self.spec
        if not q:
            return None
        if len(q) < spec.max_batch and not force:
            waited_ms = (self._clock() - q[0].t_submit) * 1e3
            if waited_ms < spec.batch_window_ms:
                return None        # partial batch still inside its window
        n = min(len(q), spec.max_batch)
        return [q.popleft() for _ in range(n)]

    def _ready(self) -> None:
        """Wait until the device has run what was enqueued."""
        dev = self.engine.device
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def flush(self, force: bool = False) -> int:
        """Serve every batch the batching policy allows right now;
        returns the number of requests served."""
        served = 0
        while True:
            batch = self._take_batch(force)
            if batch is None:
                return served
            view_state, staleness = self.view.read()
            rec = self.recorder
            if rec is None:
                out = self._serve(batch, view_state, no_timer)
            else:
                start = self._clock()
                with rec.span("serve_batch", size=len(batch),
                              staleness=staleness) as ev:
                    ev["requests"] = [r.id for r in batch]
                    ev["waits_us"] = [(start - r.t_submit) * 1e6
                                      for r in batch]
                    out = self._serve(batch, view_state, rec.timer)
            done = self._clock()
            for i, req in enumerate(batch):
                lat = (done - req.t_submit) * 1e3
                self.latencies_ms.append(lat)
                self.responses.append(Response(
                    result=_row(out, i), latency_ms=lat,
                    staleness=staleness))
            served += len(batch)

    def _serve(self, batch: List[Request], view_state, tm):
        """The batch's payloads stacked, the fold-in (the ``serve_query``
        timer), and the wait for the device."""
        stacked = _stack([r.payload for r in batch], self.engine.device)
        with tm("serve_query"):
            out = self.engine.app.query(view_state, stacked)
        self._ready()
        return out

    # -- reporting -----------------------------------------------------------

    def latency_percentiles(self) -> dict:
        """``{"p50_ms", "p99_ms"}`` over every served request (NaN when
        nothing was served)."""
        return _percentiles(self.latencies_ms)


def _percentiles(latencies_ms: List[float]) -> dict:
    if not latencies_ms:
        return {"p50_ms": float("nan"), "p99_ms": float("nan")}
    lat = np.asarray(latencies_ms)
    return {"p50_ms": float(np.percentile(lat, 50)),
            "p99_ms": float(np.percentile(lat, 99))}


__all__ = ["Request", "Response", "ServeFrontend"]
