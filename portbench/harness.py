"""One run of one cell: set-up, the measured window, the check, the
result line.

Everything a cell needs is found by name: the cell in ``BENCHMARK.json``
names its configuration (``configs/<file>.json``, whose ``kind`` names
``apps/<kind>.py``) and its traffic mix (``traffic/<name>.json``); each
per-layer metric is ``metrics/<name>.py``, a ``read(ctx)`` that returns
a number or ``None`` when the run holds nothing for it to read.
"""
from __future__ import annotations

import dataclasses
import importlib
import json
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from . import loop, trace, traffic

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
#: a query never answered, in the latency tail (it misses any limit)
UNANSWERED_MS = 1e9


@dataclasses.dataclass
class Context:
    """What a per-layer reader reads."""
    workload: str
    cell: object                     # the ``apps.<kind>.Cell`` that ran
    window: loop.Window
    trace: Optional[trace.Reduced]
    spans: Dict[str, List[float]]    # host spans of the window by name

    @property
    def rounds(self) -> range:
        """The rounds the window committed."""
        w = self.window
        return range(w.t_first, w.t_first + w.rounds)

    def device_seconds(self, part: str):
        """(seconds, calls) of the device operations whose name holds
        ``part`` in the traced window."""
        ops = [v for k, v in self.trace.ops.items() if part in k]
        return sum(s for s, _ in ops), sum(c for _, c in ops)


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def cell_entry(bench: dict, workload: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == workload:
            return w
    raise SystemExit(f"portbench: no workload {workload!r} in "
                     f"BENCHMARK.json")


def config_of(bench: dict, name: str) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return json.loads((ROOT / c["file"]).read_text())
    raise SystemExit(f"portbench: no config {name!r} in BENCHMARK.json")


def metrics_for(entries: List[dict], workload: str,
                reported: Optional[set] = None) -> List[dict]:
    """The metrics of ``entries`` that this cell reports: those listing it
    under ``workloads``, or without the key those whose ``moves`` it
    reports."""
    out = []
    for m in entries:
        if "workloads" in m:
            if workload in m["workloads"]:
                out.append(m)
        elif reported is None or m.get("moves") in reported:
            out.append(m)
    return out


def loaded_forbidden() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def card_state() -> str:
    """The card's name, power limit, SM clock and active throttle
    reasons as ``nvidia-smi`` reads them after the window."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,"
             "clocks_throttle_reasons.active", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def p95(latencies_ms: np.ndarray) -> float:
    lat = np.where(np.isnan(latencies_ms), UNANSWERED_MS, latencies_ms)
    return float(np.percentile(lat, 95))


class Run:
    """One cell's run: the set-up in the constructor, then
    :meth:`measure` (the window), :meth:`numbers` (the compared
    numbers) and :meth:`report` (the result line).  ``config`` and
    ``mix`` replace the files the cell names (small shapes for the CPU
    tests)."""

    def __init__(self, workload: str, seed: int, seconds: float,
                 traced: bool, *, device: str = "cuda", bench: dict = None,
                 config: dict = None, mix: dict = None):
        import torch
        self.torch = torch
        self.bench = bench = bench or load_benchmark()
        self.workload, self.seed, self.seconds = workload, seed, seconds
        self.traced = traced
        entry = cell_entry(bench, workload)
        self.cfg = cfg = config or config_of(bench, entry["config"])
        self.mix = mix = mix or traffic.load(entry["traffic"])
        kind = importlib.import_module(f"portbench.apps.{cfg['kind']}")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.on_card = torch.device(device).type == "cuda"

        self.cell = cell = kind.Cell(cfg, seed, device)
        cell.warm()
        self.chunk = cell.sweep_rounds if mix["chunk"] == "sweep" else \
            cell.step_rounds
        self.frontend = self.offsets = self.payloads = None
        self.recorder = None
        self.sample: set = set()
        if "arrivals" in mix:
            self._serving()
        loop.torch_sync(torch)

    def _serving(self) -> None:
        """The open loop's schedule and payloads, the view, and the
        frontend, with every batch size of the spec served once."""
        from repro_torch.obs import Recorder
        from repro_torch.serve import ModelView, ServeFrontend, ServeSpec
        cell, mix, seed = self.cell, self.mix, self.seed
        spec = ServeSpec(**mix["serve"])
        self.offsets = traffic.arrival_offsets(
            mix, seed, self.seconds + mix["schedule_extra_s"])
        n = len(self.offsets)
        size = traffic.sizes(mix, seed, n,
                             population=self.cfg.get("users", 0))
        self.payloads = cell.make_queries(mix["query"], size, seed)
        view = ModelView(cell.engine, spec)
        warm = ServeFrontend(cell.engine, view, spec)
        view.publish(cell.state, cell.t)
        for b in range(1, spec.max_batch + 1):
            for i in range(b):
                warm.submit(self.payloads[i])
            warm.flush(force=True)
        view.release()
        self.recorder = Recorder() if self.traced else None
        self.frontend = ServeFrontend(cell.engine, view, spec,
                                      recorder=self.recorder,
                                      clock=time.perf_counter)
        sure = int(np.searchsorted(self.offsets, 0.9 * self.seconds))
        rng = np.random.default_rng([seed & 0xFFFFFFFFFFFFFFFF, 3])
        pick = rng.choice(sure, size=min(self.cfg["check_sample"], sure),
                          replace=False)
        self.sample = {int(i) for i in pick} | {int(np.argmax(size[:sure]))}

    def measure(self) -> loop.Window:
        """The window; with tracing, inside a profiler session."""
        torch = self.torch
        kw = dict(offsets=self.offsets, payloads=self.payloads,
                  frontend=self.frontend, sample=self.sample)
        self.red = None
        if self.traced:
            with trace.Session(torch) as sess:
                with sess.window():
                    self.win = loop.run(self.cell, self.chunk, self.seconds,
                                        traced=True, **kw)
            self.red = trace.reduce(sess.events())
        else:
            self.win = loop.run(self.cell, self.chunk, self.seconds, **kw)
        self.peak = torch.cuda.max_memory_allocated() if self.on_card else 0
        return self.win

    def answers(self) -> list:
        return [self.win.records[q] for q in sorted(self.win.records)]

    def numbers(self) -> dict:
        """The compared numbers of the program's outputs."""
        self.cell.free_program()
        out = self.cell.training_numbers(self.win.snapshot)
        if self.frontend is not None:
            answers = self.answers()
            out.update(self.cell.query_numbers(answers))
            out["answers_checked"] = len(answers)
            out["failed"] = self.win.due - self.win.answered
        else:
            out["failed"] = 0
        return out

    def checks(self, numbers: dict) -> list:
        """(name, value, limit) of every compared number."""
        limits = dict(self.cfg["limits"], failed=0)
        out = [(n, v, limits[n]) for n, v in numbers.items() if n in limits]
        if "answers_checked" in numbers:
            out.append(("answers_checked", numbers["answers_checked"],
                        "at least 1"))
        return out

    def per_layer(self) -> dict:
        win, red = self.win, self.red
        e2e = {m["name"] for m in metrics_for(self.bench["end_to_end"],
                                               self.workload)}
        spans: Dict[str, List[float]] = {"publish": win.publish_s}
        if self.recorder is not None:
            spans["serve_batch"] = [ev["dur"] / 1e6 for ev in
                                    self.recorder.to_json_events()
                                    if ev["name"] == "serve_batch"]
        ctx = Context(self.workload, self.cell, win, red, spans)
        out = {}
        for m in metrics_for(self.bench["per_layer"], self.workload, e2e):
            reader = importlib.import_module(f"portbench.metrics.{m['name']}")
            v = reader.read(ctx)
            if v is not None:
                out[m["name"]] = {"value": v, "unit": m["unit"]}
        return out

    def report(self, setup_s: float) -> dict:
        """``{"result": <the result line's object>, "check": [(name,
        value, limit)], "diag": <more for standard error>}``."""
        torch, win, red = self.torch, self.win, self.red
        serving = self.frontend is not None
        values = {"rounds_per_s": win.rounds / win.seconds,
                  "setup_s": setup_s}
        if serving:
            values["query_p95_ms"] = p95(win.latencies_ms)
        if self.traced:
            metrics = self.per_layer()
        else:
            metrics = {m["name"]: {"value": values[m["name"]],
                                   "unit": m["unit"]}
                       for m in metrics_for(self.bench["end_to_end"],
                                            self.workload)}
        checks = self.checks(self.numbers())
        correct = all((v >= 1) if lim == "at least 1" else (v <= lim)
                      for _, v, lim in checks)
        device = {"platform": "gpu" if self.on_card else "cpu",
                  "kind": torch.cuda.get_device_name(0) if self.on_card
                  else "cpu",
                  "count": 1, "memory_peak_bytes": int(self.peak)}
        if self.on_card:
            device["card"] = card_state()
        result = {"correct": bool(correct),
                  "attempted": int(win.due if serving else win.rounds),
                  "failed": int(win.due - win.answered if serving else 0),
                  "metrics": metrics, "device": device}
        diag = {"rounds": win.rounds, "window_s": win.seconds,
                "chunk": self.chunk, "t_first": win.t_first,
                "setup_s": setup_s}
        if self.on_card:
            st = torch.cuda.memory_stats()
            diag.update({k: st.get(k) for k in (
                "num_alloc_retries", "num_device_alloc", "num_device_free",
                "reserved_bytes.all.peak")})
        if red is not None:
            device["busy_s"] = red.busy_s
            device["window_s"] = red.window_s
            ops = sorted(red.ops.items(), key=lambda kv: -kv[1][0])[:10]
            result["breakdown"] = {
                "device_ops": [[n[:160], s] for n, (s, _) in ops],
                "idle_gaps": [[n[:160], s] for n, s in red.gaps[:10]]}
            diag.update(trace_launches=red.launches, trace_lost=red.lost)
        result["check"] = {n: {"value": v, "limit": lim}
                           for n, v, lim in checks}
        if serving:
            lat = win.latencies_ms[~np.isnan(win.latencies_ms)]
            diag.update(due=win.due, answered=win.answered,
                        p50_ms=float(np.median(lat)) if lat.size else None,
                        p95_ms=values["query_p95_ms"],
                        pending=win.pending[-8:],
                        late_submit_ms=float(win.late_submit_ms))
        return {"result": result, "check": checks, "diag": diag}


def run_cell(workload: str, seed: int, seconds: float, traced: bool, *,
             t_start: float, **kw) -> dict:
    """Set up, measure and report one run; ``t_start`` is when the
    process started, the start of ``setup_s``."""
    run = Run(workload, seed, seconds, traced, **kw)
    setup_s = time.perf_counter() - t_start
    run.measure()
    return run.report(setup_s)
