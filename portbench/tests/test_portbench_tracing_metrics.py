"""The readers of the program's own spans and timers: each gives a finite
value in a small CPU window run with a Recorder attached to the engine,
and nothing without one.  Off the card a timer has no device seconds, so
these runs time the device with marks on the host's clock in place of
CUDA events."""
import dataclasses
import importlib
import math
import time

import pytest

from conftest import small_run
from portbench import harness

ROUND = ("round_host_ms", "round_schedule_ms", "round_push_ms",
         "round_pull_ms")
SERVE = ("serve_wait_p95_ms", "serve_publish_ms")


class _Mark:
    """A CUDA event's shape on the host's clock."""

    def __init__(self):
        self.t = time.perf_counter()

    def elapsed_time(self, end) -> float:
        return (end.t - self.t) * 1e3

    def query(self) -> bool:
        return True

    def synchronize(self) -> None:
        pass


def _read(name, ctx):
    return importlib.import_module(f"portbench.metrics.{name}").read(ctx)


def _window(workload, marks, monkeypatch):
    """(run, context) of a small window with a Recorder attached to the
    engine after set-up, as the traced window's profiler session or the
    serving frontend attaches one."""
    from repro_torch.obs import Recorder, events
    if marks:
        monkeypatch.setattr(events, "_device_mark", _Mark)
    run = small_run(workload)
    run.cell.engine.recorder = Recorder()
    win = run.measure()
    return run, harness.Context(workload, run.cell, win, None, {})


@pytest.mark.parametrize("workload", ["lda-nytimes.sweep",
                                      "mf-netflix.sweep",
                                      "lda-nytimes.serve"])
def test_each_reader_reads_its_cell(workload, monkeypatch):
    run, ctx = _window(workload, True, monkeypatch)
    serving = workload.endswith(".serve")
    for name in ROUND + SERVE:
        v = _read(name, ctx)
        if name in SERVE and not serving:
            assert v is None, name
            continue
        assert v is not None and math.isfinite(v) and v >= 0.0, (name, v)
    timers = run.cell.engine.recorder.timers()
    assert {timers[n]["count"] for n in ("round", "schedule", "push",
                                         "pull")} == {ctx.window.rounds}
    if serving:
        # a wait for every query the window answered
        waits = [w for ev in run.cell.engine.recorder.to_json_events()
                 if ev["name"] == "serve_batch" for w in ev["waits_us"]]
        assert len(waits) == ctx.window.answered > 0
    # the round readers read only the window's rounds
    other = dataclasses.replace(ctx, window=dataclasses.replace(
        ctx.window, rounds=ctx.window.rounds + 1))
    assert all(_read(name, other) is None for name in ROUND)


def test_no_device_time_off_the_card(monkeypatch):
    _, ctx = _window("lda-nytimes.serve", False, monkeypatch)
    assert _read("round_host_ms", ctx) > 0.0
    assert _read("serve_wait_p95_ms", ctx) >= 0.0
    for name in ("round_schedule_ms", "round_push_ms", "round_pull_ms",
                 "serve_publish_ms"):
        assert _read(name, ctx) is None, name


@pytest.mark.parametrize("workload", ["lda-nytimes.sweep",
                                      "lda-nytimes.serve"])
def test_nothing_to_read_without_a_recorder(workload):
    run = small_run(workload)
    ctx = harness.Context(workload, run.cell, run.measure(), None, {})
    assert run.cell.engine.recorder is None
    for name in ROUND + SERVE:
        assert _read(name, ctx) is None, name
