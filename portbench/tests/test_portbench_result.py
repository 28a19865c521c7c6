"""The result line's keys, the trace's reduction, and the look for JAX
after a run."""
import json
import subprocess
import sys
import types

from conftest import ROOT, small_run
from portbench import harness, trace


def _report(run):
    run.measure()
    return run.report(1.5)


class _Session:
    """A profiler session on the CPU: the window's events are made up."""

    def __init__(self, torch):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def window(self):
        import contextlib
        return contextlib.nullcontext()

    def events(self):
        return _events()


def _reduced():
    return trace.reduce(_events())


def _events():
    ev = trace.Event
    return [ev("cpu", trace.WINDOW, 0, 1_000_000),
              ev("cpu", "portbench.chunk", 10, 600_000),
              ev("cpu", "cudaLaunchKernel", 20, 5, corr=1),
              ev("cpu", "cudaLaunchKernel", 40, 5, corr=2),
              ev("cpu", "cudaLaunchKernel", 60, 5, corr=3),
              ev("cpu", "aten::sum", 700_000, 200_000),
              ev("device", "kern_a", 100, 400_000, corr=1),
              ev("device", "kern_b", 400_100, 100_000, corr=2),
              ev("device", "portbench.chunk", 10, 600_000, corr=4)]


def test_trace_reduction():
    r = _reduced()
    assert r.window_s == 1e-3 and r.launches == 3 and r.lost == 1
    assert r.busy_s == 500_000 / 1e9                  # the mirror is no op
    assert set(r.ops) == {"kern_a", "kern_b"}
    gaps = dict(r.gaps)
    assert abs(sum(gaps.values()) - 500_000 / 1e9) < 1e-15
    assert gaps["chunk: idle"] == 100 / 1e9           # before kern_a
    assert gaps["none: aten::sum"] == 499_900 / 1e9   # after the chunk


def test_last_line_keys():
    out = _report(small_run("lda-nytimes.sweep"))
    res = out["result"]
    assert list(res) == ["correct", "attempted", "failed", "metrics",
                         "device", "check"]
    assert res["correct"] is True
    assert set(res["metrics"]) == {"rounds_per_s", "setup_s"}
    assert res["check"]["count_mismatch"] == {"value": 0, "limit": 0}
    assert res["check"]["off_block_changes"] == {"value": 0, "limit": 0}
    assert list(res["check"])[:4] == ["score_gap", "count_mismatch",
                                      "off_block_changes", "unmoved_share"]
    json.dumps(res)


def test_last_line_keys_traced(monkeypatch):
    monkeypatch.setattr(harness.trace, "Session", _Session)
    monkeypatch.setattr(harness.loop, "mark", lambda name: _Session(0)
                        .window())
    out = _report(small_run("mf-netflix.serve", traced=True))
    res = out["result"]
    assert list(res) == ["correct", "attempted", "failed", "metrics",
                         "device", "breakdown", "check"]
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    assert {"busy_s", "window_s"} <= set(res["device"])
    # per-layer metrics only, and only those with something to read
    # per-layer metrics only; lda_gibbs_roofline finds no kernel in MF,
    # and the CPU window holds no publish span (those are synced on a card)
    assert {"device_idle_share", "host_launches_per_round", "round_mfu",
            "serve_batch_ms"} <= set(res["metrics"]) <= {
        "device_idle_share", "host_launches_per_round", "round_mfu",
        "serve_batch_ms", "publish_ms"}
    json.dumps(res)


def test_forbidden_modules_compared_whole():
    assert "repro" in harness.FORBIDDEN
    sys.modules["repro_torch_like"] = types.ModuleType("repro_torch_like")
    try:
        assert harness.loaded_forbidden() == [] or \
            "repro" not in harness.loaded_forbidden()
        sys.modules["jax.numpy"] = types.ModuleType("jax.numpy")
        assert "jax" in harness.loaded_forbidden()
    finally:
        sys.modules.pop("repro_torch_like", None)
        sys.modules.pop("jax.numpy", None)


def test_a_rehearsal_loads_no_jax():
    code = (
        "import sys; sys.path[:0] = [%r, %r]\n"
        "sys.path.insert(0, %r)\n"
        "from conftest import small_run\n"
        "from portbench import harness\n"
        "r = small_run('lda-nytimes.serve'); r.measure(); r.report(0.0)\n"
        "print(harness.loaded_forbidden())\n"
        % (str(ROOT), str(ROOT / "src"), str(ROOT / "portbench" / "tests")))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_run_py_refuses_without_a_card():
    out = subprocess.run([sys.executable, str(ROOT / "portbench" / "run.py"),
                          "--workload", "lda-nytimes.sweep", "--seed", "1",
                          "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300,
                         cwd=ROOT)
    assert out.returncode != 0 and out.stdout == ""
