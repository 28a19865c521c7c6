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
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from collections import deque
from typing import Any, Callable, List, Optional

import numpy as np
import torch

from .spec import ServeSpec
from .view import ModelView


@dataclasses.dataclass
class Request:
    """One queued query: a per-example payload + submit time."""
    payload: Any
    t_submit: float


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
        self.recorder = recorder
        self._clock = clock
        self._queue: deque = deque()
        self.responses: List[Response] = []
        self.latencies_ms: List[float] = []

    # -- queue ---------------------------------------------------------------

    def submit(self, payload) -> None:
        """Enqueue one per-example query payload (no leading batch axis:
        the frontend stacks)."""
        self._queue.append(Request(payload, self._clock()))

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
            span = (self.recorder.span("serve_batch", size=len(batch),
                                       staleness=staleness)
                    if self.recorder is not None
                    else contextlib.nullcontext())
            with span:
                stacked = _stack([r.payload for r in batch],
                                 self.engine.device)
                out = self.engine.app.query(view_state, stacked)
                self._ready()
            done = self._clock()
            for i, req in enumerate(batch):
                lat = (done - req.t_submit) * 1e3
                self.latencies_ms.append(lat)
                self.responses.append(Response(
                    result=_row(out, i), latency_ms=lat,
                    staleness=staleness))
            served += len(batch)

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
