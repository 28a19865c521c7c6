"""The measured window: STRADS rounds through ``StradsEngine.execute`` in
chunks, and in a serving cell queries served between them.

The serving order is ``serve_while_training``'s
(``src/repro_torch/serve/loop.py`` at commit 8dacd7b): release the view,
run a chunk, publish, submit what is due, flush.  This copy differs in
what the program's loop cannot carry: a query is due by the wall clock
from the window's start (an open loop), not by round; the device is
synchronised after each chunk, so a boundary's clock is when its rounds
were done; and the latency of a query runs from when it was due to when
its result was ready on the host (the frontend synchronises before it
stamps a batch done); and the client takes its answers off the frontend
after each flush (:func:`consume`).

The window runs chunks until ``seconds`` have passed, then a closing
chunk: the cell's ``close_lead`` rounds, drawn from the seed, then the
snapshot its check replays from, then the configuration's
``close_rounds``.  The chunks end on a step, so without the lead the
replayed round would always be a step's first; a closing round off a
step runs on the ``loop`` executor, the same round body as ``scan``
(which starts only on a step).  In a serving cell the
closing boundary submits every query due by then and serves them all,
so every query due in the window is answered in it or counts as failed.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional

import numpy as np

from .trace import mark


@dataclasses.dataclass
class Window:
    seconds: float
    rounds: int
    t_first: int                       # the first round of the window
    due: int = 0                       # queries due in the window
    answered: int = 0
    answered_open: int = 0             # answered before the closing chunk
    latencies_ms: Optional[np.ndarray] = None
    pending: List[int] = dataclasses.field(default_factory=list)
    records: Dict[int, Any] = dataclasses.field(default_factory=dict)
    snapshot: Any = None
    publish_s: List[float] = dataclasses.field(default_factory=list)
    late_submit_ms: float = 0.0        # how late the loop submitted


def run(cell, chunk: int, seconds: float, *, offsets=None, payloads=None,
        frontend=None, sample=(), traced: bool = False) -> Window:
    """One window of ``cell`` (an ``apps.<kind>.Cell`` after its set-up);
    ``offsets``, ``payloads`` and ``frontend`` for a serving cell;
    ``sample`` the query indices whose answers the check records."""
    torch = cell.torch
    serving = frontend is not None
    view = frontend.view if serving else None
    n = len(offsets) if serving else 0
    lat = np.full((n,), np.nan)
    t_sub = np.zeros((n,))
    sample = set(sample)
    win = Window(seconds=0.0, rounds=0, t_first=cell.t)
    state = {"next": 0, "seen": 0}
    tag = (lambda name: mark(name)) if traced else (lambda name: mark(None))

    def boundary(start: float, force: bool) -> None:
        with tag("publish"):
            t0 = time.perf_counter()
            view.publish(cell.state, cell.t)
            if traced:
                torch_sync(torch)
                win.publish_s.append(time.perf_counter() - t0)
        now = time.perf_counter() - start
        with tag("submit"):
            i = state["next"]
            while i < n and offsets[i] <= now:
                t_sub[i] = time.perf_counter()
                frontend.submit(payloads[i])
                i += 1
            if i > state["next"]:
                win.late_submit_ms = max(
                    win.late_submit_ms,
                    (t_sub[state["next"]] - start - offsets[state["next"]])
                    * 1e3)
            state["next"] = i
        win.pending.append(frontend.pending())
        with tag("flush"):
            frontend.flush(force=force)
        fresh = consume(frontend)
        lo = state["seen"]
        state["seen"] += len(fresh)
        for j, resp in enumerate(fresh):
            q = lo + j
            lat[q] = (t_sub[q] + resp.latency_ms / 1e3 - start
                      - offsets[q]) * 1e3
        wanted = [lo + j for j in range(len(fresh)) if lo + j in sample]
        if wanted:
            vs, _ = view.read()
            for q in wanted:
                win.records[q] = cell.record(vs, payloads[q],
                                             fresh[q - lo].result)

    rest = (-cell.t) % cell.step_rounds
    if rest:         # a window before closed off a step: back onto one
        cell.run(rest, executor="loop")
        win.t_first = cell.t
    cell.mark_start()
    torch_sync(torch)
    start = time.perf_counter()
    while time.perf_counter() - start < seconds:
        if serving:
            view.release()
        with tag("chunk"):
            cell.run(chunk)
        if serving:
            boundary(start, force=False)
    win.answered_open = state["seen"]
    if serving:
        view.release()
    with tag("chunk"):
        if cell.close_lead:
            cell.run(cell.close_lead)
        win.snapshot = cell.snapshot()
        cell.run(cell.close_rounds,
                 executor="loop" if cell.t % cell.step_rounds else None)
    if serving:
        boundary(start, force=True)
    torch_sync(torch)
    win.seconds = time.perf_counter() - start
    win.rounds = cell.t - win.t_first
    if serving:
        win.due = state["next"]
        win.answered = state["seen"]
        win.latencies_ms = lat[:win.due]
    return win


def lead_rounds(seed: int, period: int) -> int:
    """A whole number below ``period`` drawn from the seed: how far past
    its last step the closing chunk runs before the snapshot, so that
    the replayed round falls at any phase of the step."""
    rng = np.random.default_rng([seed & 0xFFFFFFFFFFFFFFFF, 5])
    return int(rng.integers(period))


def consume(frontend) -> list:
    """The responses the last flush served, taken off the frontend as
    the client takes its answers: the frontend keeps every response it
    made, and each holds views of its batch's whole outputs, so an open
    loop that left them there would hold memory without end."""
    fresh = list(frontend.responses)
    frontend.responses.clear()
    frontend.latencies_ms.clear()
    return fresh


def torch_sync(torch) -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()
