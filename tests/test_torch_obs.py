"""Observability of the port (``repro_torch.obs``, the engine's telemetry,
``repro_torch.launch.trace``) against the JAX package's
(``tests/test_obs.py``).

The counters count schedules, so where a schedule is random the port is
fed the JAX draws (``test_torch_lasso.jax_draws``) and its counters must
equal the JAX package's ``summarize_counters`` exactly (integers).  An
instrumented run must equal an uninstrumented one to the bit.  Reports
cross between the packages through their JSON.  The span test runs the
JAX engine on 4 forced host devices in a subprocess (the
``load_balanced`` partitioner needs 4 workers there); its rebalance load
spreads are held to 1e-4 relative or 1e-6 absolute (the EMA of |Δβ| in
f32 sums in another order, and a balanced spread is a difference of
nearly equal loads).
"""
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.apps import lasso as jlasso
from repro.apps import lda as jlda
from repro.apps import mf as jmf
from repro.checkpoint import load_flat as jload_flat
from repro.core import ExecutionPlan as JPlan
from repro.core import single_device_mesh
from repro.launch import trace as jtrace
from repro.obs import TelemetrySpec as JSpec
from repro.obs import counters as jcounters
from repro_torch import convert
from repro_torch.apps import lasso, lda, mf
from repro_torch.checkpoint import restore_checkpoint
from repro_torch.core import EngineCarry, ExecutionPlan
from repro_torch.launch import trace as ttrace
from repro_torch.obs import (Recorder, RunReport, TelemetrySpec,
                             chrome_trace, init_counters, observe_round,
                             report_from_json, summarize_counters,
                             validate_spans)
from repro_torch.ps import SSPCarry
from test_torch_lasso import jax_draws
from test_torch_lda import CFG1, CFG4, _corpus
from test_torch_ssp import LASSO, MF_SIZE

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, J = 64, 40
SPREAD_RTOL = 1e-4       # rebalance load spreads: f32 sums in another order
SPREAD_ATOL = 1e-6       # … near 0 after a move: max − min of equal loads
EXECUTORS = ("loop", "scan", "pipelined", "ssp")
# (executor, staleness): the counter parity runs
RUNS = [("loop", 0), ("scan", 0), ("pipelined", 0), ("ssp", 1), ("ssp", 2)]
ROUNDS = {"lasso": 6, "mf": 12, "lda": 6}     # multiples of every step


@pytest.fixture(scope="module")
def lasso_problem():
    X, y, _ = jlasso.synthetic_correlated(np.random.default_rng(0), n=N,
                                          J=J, k_true=4)
    return X, y


@pytest.fixture(scope="module")
def mf_problem():
    return jmf.synthetic_ratings(np.random.default_rng(0), 24, 10,
                                 true_rank=3, density=0.5)


def _equal(a: dict, b: dict):
    assert set(a) == set(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


def _plan(executor, rounds, staleness=0, telemetry=False, **kw):
    return ExecutionPlan(executor=executor, rounds=rounds,
                         staleness=staleness, telemetry=telemetry, **kw)


def _jplan(executor, rounds, staleness=0, telemetry=False, **kw):
    return JPlan(executor=executor, rounds=rounds, staleness=staleness,
                 telemetry=telemetry, donate=False, **kw)


# ---------------------------------------------------------------------------
# Port runs of the three apps
# ---------------------------------------------------------------------------

def _port(app, plan, problems, workers=None, noise=None, recorder=None,
          **kw):
    """(engine, data, report) of one port run from a fresh start, with
    ``recorder`` attached to the engine."""
    if app == "lasso":
        X, y = problems["lasso"]
        eng = lasso.make_engine(lasso.LassoConfig(**LASSO),
                                workers=workers or 4, device="cpu")
        data = eng.shard_data({"X": X, "y": y})
        state = eng.init_state(y=y)
        gen = torch.Generator().manual_seed(3)
    elif app == "mf":
        A, mask = problems["mf"]
        eng = mf.make_engine(mf.MFConfig(**MF_SIZE), workers=workers or 2,
                             device="cpu")
        data = eng.shard_data({"A": A, "mask": mask})
        state = eng.init_state(A=A, mask=mask,
                               generator=torch.Generator().manual_seed(2))
        gen = None
    else:
        cfg_kw = CFG4 if workers == 4 else CFG1
        words, docs, z0 = _corpus(cfg_kw)
        eng = lda.make_engine(lda.LDAConfig(**cfg_kw), device="cpu")
        data = eng.shard_data({"words": words, "docs": docs})
        state = eng.init_state(words=words, docs=docs, z0=z0)
        gen = None
    eng.recorder = recorder
    rep = eng.execute(state, data, gen, plan, noise=noise, **kw)
    return eng, data, rep


@pytest.fixture(scope="module")
def problems(lasso_problem, mf_problem):
    return {"lasso": lasso_problem, "mf": mf_problem}


# ---------------------------------------------------------------------------
# The JAX package's counters on the same schedules
# ---------------------------------------------------------------------------

_JAX_COUNTERS: dict = {}


def _jax_counters(app, executor, staleness):
    """``summarize_counters`` of a JAX engine run (single device) of the
    same plan with ``TelemetrySpec(kind="counters")``."""
    key = (app, executor, staleness)
    if key in _JAX_COUNTERS:
        return _JAX_COUNTERS[key]
    R = ROUNDS[app]
    mesh = single_device_mesh()
    if app == "lasso":
        X, y, _ = jlasso.synthetic_correlated(np.random.default_rng(0),
                                              n=N, J=J, k_true=4)
        eng = jlasso.make_engine(jlasso.LassoConfig(**LASSO), mesh)
        data = eng.shard_data({"X": jnp.asarray(X), "y": jnp.asarray(y)})
        state = eng.init_state(jax.random.key(0), y=y)
    elif app == "mf":
        A, mask = jmf.synthetic_ratings(np.random.default_rng(0), 24, 10,
                                        true_rank=3, density=0.5)
        eng = jmf.make_engine(jmf.MFConfig(**MF_SIZE), mesh)
        data = eng.shard_data({"A": jnp.asarray(A),
                               "mask": jnp.asarray(mask)})
        state = eng.init_state(jax.random.key(0), A=jnp.asarray(A),
                               mask=jnp.asarray(mask))
    else:
        words, docs, z0 = _corpus(CFG1)
        eng = jlda.make_engine(jlda.LDAConfig(**CFG1), mesh)
        data = eng.shard_data({"words": jnp.asarray(words),
                               "docs": jnp.asarray(docs)})
        state = eng.init_state(jax.random.key(0), words=words, docs=docs,
                               z0=z0)
    rep = eng.execute(state, data, jax.random.key(0),
                      _jplan(executor, R, staleness,
                             JSpec(kind="counters")))
    _JAX_COUNTERS[key] = rep.telemetry.counters
    return rep.telemetry.counters


@pytest.mark.parametrize("executor,staleness", RUNS)
@pytest.mark.parametrize("app,workers", [("lasso", 1), ("lasso", 4),
                                         ("mf", 2), ("lda", 1)])
def test_counters_equal_the_jax_package(app, workers, executor, staleness,
                                        problems):
    R = ROUNDS[app]
    draws = jax_draws(R + 1, J) if app == "lasso" else None
    _, _, rep = _port(app, _plan(executor, R, staleness,
                                 TelemetrySpec(kind="counters")),
                      problems, workers=workers,
                      noise=(lambda t: draws[t]) if app == "lasso" else None)
    want = _jax_counters(app, executor, staleness)
    assert rep.telemetry.counters == want
    assert rep.telemetry.counters["rounds"] == R
    assert rep.telemetry.rounds == R and rep.telemetry.executor == executor
    if app == "lasso":
        assert want["proposed"] == R * LASSO["num_candidates"]
        assert 0 < want["accepted"] < want["proposed"]


@pytest.mark.parametrize("executor,staleness", RUNS)
def test_lda_four_worker_counters_equal_the_jax_fold(executor, staleness,
                                                     problems):
    """LDA at W = 4 (the JAX engine needs 4 devices for it): the port's
    counters equal the JAX ``observe_round`` folded over the same rounds
    (the rotation's schedule is implicit: no width, one count a phase)."""
    R = 12
    _, _, rep = _port("lda", _plan(executor, R, staleness,
                                   TelemetrySpec(kind="counters")),
                      problems, workers=4)
    c = jcounters.init_counters(4)
    for t in range(R):
        c = jcounters.observe_round(c, None, t % 4)
    assert rep.telemetry.counters == jcounters.summarize_counters(c)
    assert rep.telemetry.counters["rounds_per_phase"] == [3, 3, 3, 3]


def test_observe_round_equals_the_jax_fold_on_masks():
    """The ledger over masked and dense schedules, with and without a
    proposal pool, equals the JAX package's on the same schedules."""
    rng = np.random.default_rng(5)
    ours, theirs = init_counters(3), jcounters.init_counters(3)
    for t in range(9):
        m = rng.uniform(size=8) < 0.6
        idx = rng.integers(0, 20, size=8)
        for sched, cand in (({"idx": idx, "mask": m}, 12),
                            ({"idx": idx, "mask": m}, 0),
                            ({"ranks": idx[:5]}, 0), (None, 0)):
            tsched = None if sched is None else {
                k: torch.as_tensor(v) for k, v in sched.items()}
            jsched = None if sched is None else {
                k: jnp.asarray(v) for k, v in sched.items()}
            ours = observe_round(ours, tsched, t % 3, cand)
            theirs = jcounters.observe_round(theirs, jsched, t % 3, cand)
    assert summarize_counters(ours) == jcounters.summarize_counters(theirs)
    assert all(v.dtype == torch.int32 for v in ours.values())
    assert summarize_counters(None) == {}


# ---------------------------------------------------------------------------
# Telemetry is bit-neutral: 3 apps × 4 executors
# ---------------------------------------------------------------------------

SPECS = (False, TelemetrySpec(kind="counters"), TelemetrySpec(kind="trace"))


@pytest.mark.parametrize("executor", EXECUTORS)
@pytest.mark.parametrize("app", ["lasso", "mf", "lda"])
def test_instrumented_runs_equal_uninstrumented_to_the_bit(app, executor,
                                                           problems):
    R = 12
    s = 1 if executor == "ssp" else 0
    workers = 4 if app == "lda" else None
    reps = [_port(app, _plan(executor, R, s, spec), problems,
                  workers=workers)[2] for spec in SPECS]
    for rep in reps[1:]:
        _equal(reps[0].state, rep.state)
    assert reps[0].telemetry is None and reps[0].carry.obs is None
    for spec, rep in zip(SPECS[1:], reps[1:]):
        report = rep.telemetry
        assert isinstance(report, RunReport) and report.spec == spec
        assert report.counters["rounds"] == R
        assert (report.ssp is not None) == (executor == "ssp")
        assert (report.events != []) == spec.events
        assert ttrace.check_report(report) is None
        assert ttrace.check_report(report_from_json(report.to_json())) \
            is None
        assert rep.carry.obs["rounds"].dtype == torch.int32


def test_counters_read_no_device_value_per_round(problems, monkeypatch):
    """``observe_round`` never reads a tensor on the host: the rounds of
    an instrumented run call no ``item``/``tolist``/``__int__``."""
    calls = []
    for name in ("item", "tolist", "__int__", "__bool__"):
        orig = getattr(torch.Tensor, name)

        def spy(self, *a, _orig=orig, _name=name, **kw):
            calls.append(_name)
            return _orig(self, *a, **kw)
        monkeypatch.setattr(torch.Tensor, name, spy)
    ours = init_counters(2)
    sched = {"idx": torch.arange(4), "mask": torch.tensor([1, 0, 1, 1],
                                                          dtype=torch.bool)}
    for t in range(6):
        ours = observe_round(ours, sched, t % 2, 6)
        ours = observe_round(ours, {"ranks": torch.arange(3)}, t % 2)
    assert calls == []
    monkeypatch.undo()
    assert summarize_counters(ours)["accepted"] == 6 * 3 + 6 * 3


# ---------------------------------------------------------------------------
# Counters survive chunks, npz resumes and JAX checkpoints
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("executor,staleness", [("scan", 0), ("ssp", 1)])
def test_counters_bit_exact_through_chunking_and_resume(executor, staleness,
                                                        problems, tmp_path):
    spec = TelemetrySpec(kind="counters")
    R = 8
    draws = jax_draws(R, J)
    noise = lambda t: draws[t]                      # noqa: E731
    _, _, full = _port("lasso", _plan(executor, R, staleness, spec),
                       problems, noise=noise)
    plan = _plan(executor, R, staleness, spec, checkpoint_every=4)
    eng, data, chunked = _port("lasso", plan, problems, noise=noise,
                               ckpt_dir=str(tmp_path))
    _equal(full.state, chunked.state)
    assert chunked.telemetry.counters == full.telemetry.counters
    if executor == "ssp":
        # the per-chunk staleness summaries merge into one section
        assert chunked.telemetry.ssp.hist.tolist() == \
            full.telemetry.ssp.hist.tolist() == [4, 4]
        assert chunked.telemetry.ssp.flushes == full.telemetry.ssp.flushes
    # the counters ride the npz as carry/.obs/<name>, the JAX keys
    flat = np.load(str(tmp_path / "step_00000004.npz"))
    assert {k for k in flat.files if k.startswith("carry/.obs/")} == {
        "carry/.obs/rounds", "carry/.obs/sched_size", "carry/.obs/proposed",
        "carry/.obs/accepted", "carry/.obs/killed"}
    back = restore_checkpoint(str(tmp_path), 4, {"state": chunked.state,
                                                 "carry": chunked.carry})
    mid = back["carry"]
    assert int(mid.obs["rounds"].sum()) == 4
    resumed = eng.execute(back["state"], data, None, plan, carry=mid,
                          noise=noise, ckpt_dir=str(tmp_path / "resumed"))
    _equal(full.state, resumed.state)
    assert resumed.telemetry.counters == full.telemetry.counters


@pytest.mark.parametrize("executor,staleness", [("scan", 0), ("ssp", 1)])
def test_counters_resume_from_an_instrumented_jax_checkpoint(
        executor, staleness, lasso_problem, tmp_path):
    X, y = lasso_problem
    R = 8
    spec = JSpec(kind="counters")
    jeng = jlasso.make_engine(jlasso.LassoConfig(**LASSO),
                              single_device_mesh())
    jdata = jeng.shard_data({"X": jnp.asarray(X), "y": jnp.asarray(y)})
    jrep = jeng.execute(jeng.init_state(jax.random.key(0), y=y), jdata,
                        jax.random.key(0),
                        JPlan(executor=executor, rounds=R,
                              staleness=staleness, telemetry=spec,
                              checkpoint_every=4),
                        ckpt_dir=str(tmp_path))
    flat = jload_flat(str(tmp_path), 4)
    eng = lasso.make_engine(lasso.LassoConfig(**LASSO), workers=2,
                            device="cpu")
    state, carry, _ = convert.checkpoint_from_jax(flat, eng)
    assert isinstance(carry, SSPCarry if executor == "ssp" else EngineCarry)
    assert summarize_counters(carry.obs) == jcounters.summarize_counters(
        {k[len("carry/.obs/"):]: v for k, v in flat.items()
         if k.startswith("carry/.obs/")})
    assert carry.obs["rounds"].dtype == torch.int32
    draws = jax_draws(R, J)
    rep = eng.execute(state, eng.shard_data({"X": X, "y": y}), None,
                      _plan(executor, R, staleness,
                            TelemetrySpec(kind="counters")),
                      carry=carry, noise=lambda t: draws[t])
    assert rep.telemetry.counters == jrep.telemetry.counters
    np.testing.assert_allclose(rep.state["beta"].numpy(),
                               np.asarray(jrep.state["beta"]), atol=1e-5)


# ---------------------------------------------------------------------------
# The Recorder (cases of tests/test_obs.py)
# ---------------------------------------------------------------------------

def test_recorder_span_stack_discipline():
    rec = Recorder()
    with rec.span("outer", k=1):
        rec.instant("tick")
        with rec.span("inner"):
            pass
    ev = rec.to_json_events()
    assert [e["name"] for e in ev] == ["outer", "tick", "inner"]
    assert validate_spans(ev) is None
    doc = chrome_trace(ev)
    assert {e["name"] for e in doc["traceEvents"]} == \
        {"outer", "tick", "inner"}


def test_validate_spans_flags_violations():
    ok = [{"name": "a", "ph": "X", "ts": 0.0, "dur": 10.0, "args": {}},
          {"name": "b", "ph": "X", "ts": 2.0, "dur": 3.0, "args": {}}]
    assert validate_spans(ok) is None
    crossing = ok + [{"name": "c", "ph": "X", "ts": 4.0, "dur": 10.0,
                      "args": {}}]
    assert validate_spans(crossing) is not None
    negative = [{"name": "a", "ph": "X", "ts": 0.0, "dur": -1.0,
                 "args": {}}]
    assert validate_spans(negative) is not None


def test_profiler_spans_annotate_a_torch_profile():
    rec = Recorder(profiler=True)
    with torch.profiler.profile() as prof:
        with rec.span("execute"):
            with rec.span("scan"):
                torch.ones(4).sum()
    names = {e.key for e in prof.key_averages()}
    assert {"strads.execute", "strads.scan"} <= names
    assert validate_spans(rec.to_json_events()) is None


def test_chrome_trace_export_is_valid_and_nested(problems, tmp_path):
    plan = _plan("ssp", 8, 1, TelemetrySpec(kind="trace"),
                 checkpoint_every=4)
    _, _, rep = _port("lasso", plan, problems, ckpt_dir=str(tmp_path / "c"))
    events = rep.telemetry.events
    # chunking makes a hierarchy: execute > {ssp × 2, checkpoint × 2}
    names = [e["name"] for e in events if e.get("ph") == "X"]
    assert names.count("ssp") == 2 and names.count("checkpoint") == 2
    assert names[0] == "execute"
    assert validate_spans(events) is None
    out = rep.telemetry.write_chrome_trace(str(tmp_path / "t.json"))
    with open(out) as f:
        doc = json.load(f)
    assert doc["displayTimeUnit"] == "ms"
    tev = doc["traceEvents"]
    assert len(tev) == len(events)
    spans = [e for e in tev if e["ph"] == "X"]
    assert all(e["dur"] >= 0 and e["ts"] >= 0 for e in spans)
    for a in spans:
        for b in spans:
            if a is b:
                continue
            a0, a1 = a["ts"], a["ts"] + a["dur"]
            b0, b1 = b["ts"], b["ts"] + b["dur"]
            overlap = max(a0, b0) < min(a1, b1)
            nested = (a0 <= b0 and b1 <= a1) or (b0 <= a0 and a1 <= b1)
            assert not overlap or nested, (a["name"], b["name"])
    jsonl = rep.telemetry.write_jsonl(str(tmp_path / "t.jsonl"))
    with open(jsonl) as f:
        assert [json.loads(ln)["name"] for ln in f] == \
            [e["name"] for e in events]


def test_no_spec_means_no_report_and_counters_kind_no_events(problems):
    _, _, rep = _port("lasso", _plan("scan", 4), problems)
    assert rep.telemetry is None
    _, _, rep = _port("lasso", _plan("scan", 4, 0,
                                     TelemetrySpec(kind="counters")),
                      problems)
    assert rep.telemetry.events == []
    assert rep.telemetry.counters["rounds"] == 4


# ---------------------------------------------------------------------------
# The trace CLI's validator, and reports crossing between the packages
# ---------------------------------------------------------------------------

def _valid_report_dict():
    return {"spec": {"kind": "counters", "profiler": False},
            "executor": "scan", "rounds": 4,
            "counters": {"rounds": 4, "rounds_per_phase": [4],
                         "sched_size": 12, "proposed": 24,
                         "accepted": 12, "killed": 12},
            "events": [], "ssp": None}


def test_check_report_catches_what_the_jax_check_catches():
    cases = {"valid": _valid_report_dict()}
    unbalanced = _valid_report_dict()
    unbalanced["counters"]["killed"] = 13
    phases = _valid_report_dict()
    phases["counters"]["rounds_per_phase"] = [3]
    negative = _valid_report_dict()
    negative["counters"]["sched_size"] = -1
    crossing = _valid_report_dict()
    crossing["spec"] = {"kind": "trace", "profiler": False}
    crossing["events"] = [
        {"name": "a", "ph": "X", "ts": 0.0, "dur": 10.0, "args": {}},
        {"name": "b", "ph": "X", "ts": 5.0, "dur": 10.0, "args": {}}]
    short_hist = _valid_report_dict()
    short_hist["ssp"] = {"staleness_bound": 1, "rounds": 4, "flushes": 2,
                         "hist": [2, 1], "max_staleness": 1,
                         "clocks": [4], "bytes_pushed": 0,
                         "bytes_deferred_peak": 0, "bytes_pulled": 0}
    cases.update(unbalanced=unbalanced, phases=phases, negative=negative,
                 crossing=crossing, short_hist=short_hist)
    for name, d in cases.items():
        ours = ttrace.check_report(report_from_json(d))
        theirs = jtrace.check_report(jtrace.report_from_json(d))
        assert ours == theirs, name
        assert (ours is None) == (name == "valid"), name
    assert "ledger" in ttrace.check_report(report_from_json(unbalanced))


def test_extract_report_dicts_walks_nested_artifacts():
    rep = _valid_report_dict()
    artifact = {"engine": "lasso", "run_report": rep,
                "ssp": {"2": {"telemetry": rep}},
                "rows": [{"telemetry": rep}]}
    assert len(ttrace.extract_report_dicts(artifact)) == 3
    assert ttrace.extract_report_dicts({"no": "reports"}) == []
    assert ttrace.extract_report_dicts(rep) == [rep]


def _cli(main, argv, capsys):
    rc = main(argv)
    return rc, capsys.readouterr().out


@pytest.mark.parametrize("kind", ["counters", "trace"])
def test_reports_cross_between_the_packages(kind, lasso_problem, problems,
                                            tmp_path, capsys):
    """A JAX RunReport passes the port's ``--check`` with the JAX CLI's
    own summary, and a port RunReport passes the JAX CLI's."""
    X, y = lasso_problem
    R = 6
    jeng = jlasso.make_engine(jlasso.LassoConfig(**LASSO),
                              single_device_mesh())
    jdata = jeng.shard_data({"X": jnp.asarray(X), "y": jnp.asarray(y)})
    jrep = jeng.execute(jeng.init_state(jax.random.key(0), y=y), jdata,
                        jax.random.key(0),
                        _jplan("ssp", R, 2, JSpec(kind=kind)))
    draws = jax_draws(R, J)
    _, _, rep = _port("lasso", _plan("ssp", R, 2, TelemetrySpec(kind=kind)),
                      problems, workers=1, noise=lambda t: draws[t])
    paths = {}
    for name, report in (("jax", jrep.telemetry), ("port", rep.telemetry)):
        paths[name] = str(tmp_path / f"{name}.json")
        with open(paths[name], "w") as f:
            json.dump({"run_report": report.to_json()}, f)
    for name, path in paths.items():
        rc_t, out_t = _cli(ttrace.main, [path, "--check"], capsys)
        rc_j, out_j = _cli(jtrace.main, [path, "--check"], capsys)
        assert rc_t == rc_j == 0, (name, out_t, out_j)
        assert out_t == out_j and "[ok]" in out_t
    # the same run, read by either package: the same counters and ssp
    j = json.load(open(paths["jax"]))["run_report"]
    t = json.load(open(paths["port"]))["run_report"]
    assert t["counters"] == j["counters"]
    assert t["spec"] == j["spec"] and set(t) == set(j)
    for k in ("staleness_bound", "rounds", "flushes", "hist",
              "max_staleness", "clocks"):
        assert t["ssp"][k] == j["ssp"][k], k
    assert set(t["ssp"]) == set(j["ssp"])
    # --chrome / --jsonl re-export the port's event log
    rc, _ = _cli(ttrace.main, [paths["port"], "--chrome",
                               str(tmp_path / "c.json"), "--jsonl",
                               str(tmp_path / "e.jsonl")], capsys)
    assert rc == 0
    assert json.load(open(tmp_path / "c.json"))["traceEvents"] == \
        chrome_trace(rep.telemetry.events)["traceEvents"]
    # a broken report fails --check
    bad = dict(t, counters=dict(t["counters"], killed=-1))
    with open(tmp_path / "bad.json", "w") as f:
        json.dump(bad, f)
    rc, out = _cli(ttrace.main, [str(tmp_path / "bad.json"), "--check"],
                   capsys)
    assert rc == 1 and "INVALID" in out


# ---------------------------------------------------------------------------
# Spans and rebalance instants: the JAX package's, on lasso_loadbal.json
# ---------------------------------------------------------------------------

LOADBAL_N, LOADBAL_J = 64, 160

_JAX_LOADBAL = r"""
import json, os, sys, tempfile
import numpy as np
import jax, jax.numpy as jnp
from repro.apps import lasso
from repro.core import ExecutionPlan, worker_mesh
from repro.obs import TelemetrySpec
n, J = int(sys.argv[1]), int(sys.argv[2])
plan = ExecutionPlan.from_json(open(sys.argv[3]).read())
plan = ExecutionPlan.from_json(dict(plan.to_json(), telemetry=
    TelemetrySpec(kind="trace").to_json()))
X, y, _ = lasso.synthetic_correlated(np.random.default_rng(0), n=n, J=J,
                                     k_true=8)
sp = plan.scheduler
cfg = lasso.LassoConfig(num_features=J, lam=0.02, block_size=sp.block_size,
                        num_candidates=sp.num_candidates, rho=sp.rho)
eng = lasso.make_engine(cfg, worker_mesh(4))
data = eng.shard_data({"X": jnp.asarray(X), "y": jnp.asarray(y)})
with tempfile.TemporaryDirectory() as d:
    rep = eng.execute(eng.init_state(jax.random.key(0), y=y), data,
                      jax.random.key(0), plan, ckpt_dir=d)
print(json.dumps({"events": rep.telemetry.events,
                  "counters": rep.telemetry.counters}))
"""


def test_trace_kind_records_the_jax_spans_and_rebalances(tmp_path):
    path = os.path.join(ROOT, "examples", "plans", "lasso_loadbal.json")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    out = subprocess.run([sys.executable, "-c", _JAX_LOADBAL,
                          str(LOADBAL_N), str(LOADBAL_J), path], env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    want = json.loads(out.stdout.strip().splitlines()[-1])
    with open(path) as f:
        plan = ExecutionPlan.from_json(json.load(f))
    plan = ExecutionPlan.from_json(dict(
        plan.to_json(), telemetry=TelemetrySpec(kind="trace").to_json()))
    X, y, _ = jlasso.synthetic_correlated(np.random.default_rng(0),
                                          n=LOADBAL_N, J=LOADBAL_J,
                                          k_true=8)
    sp = plan.scheduler
    cfg = lasso.LassoConfig(num_features=LOADBAL_J, lam=0.02,
                            block_size=sp.block_size,
                            num_candidates=sp.num_candidates, rho=sp.rho)
    eng = lasso.make_engine(cfg, workers=4, device="cpu")
    draws = jax_draws(plan.rounds, LOADBAL_J)
    rep = eng.execute(eng.init_state(y=y), eng.shard_data({"X": X, "y": y}),
                      None, plan, noise=lambda t: draws[t],
                      ckpt_dir=str(tmp_path))
    got = rep.telemetry.events

    def spans(evs):
        return [(e["name"], e["args"]) for e in evs if e["ph"] == "X"]

    def rebalances(evs):
        return [e["args"] for e in evs if e["name"] == "rebalance"]

    assert spans(got) == spans(want["events"])
    assert [n for n, _ in spans(got)] == ["execute"] + [
        "scan", "checkpoint"] * 4
    ours, theirs = rebalances(got), rebalances(want["events"])
    assert [r["t"] for r in ours] == [r["t"] for r in theirs]
    assert [r["version"] for r in ours] == list(range(1, len(ours) + 1))
    assert len(ours) >= 2
    for a, b in zip(ours, theirs):
        assert a["version"] == b["version"]
        assert a["spread_after"] < a["spread_before"]
        for k in ("spread_before", "spread_after"):
            np.testing.assert_allclose(a[k], b[k], rtol=SPREAD_RTOL,
                                       atol=SPREAD_ATOL)
    # the port records no cache_miss: it compiles no program
    assert {e["name"] for e in got if e["ph"] == "i"} == {"rebalance"}
    assert "cache_miss" in {e["name"] for e in want["events"]}
    assert rep.telemetry.counters == want["counters"]
    assert validate_spans(got) is None


# ---------------------------------------------------------------------------
# The engine's Recorder: round timers, the profiler's clock, span ids
# ---------------------------------------------------------------------------

ROUND_TIMERS = ("round", "schedule", "push", "pull")


def _attached_run(app, executor, staleness, problems, rec):
    """A 12-round port run of ``app`` with ``rec`` attached."""
    return _port(app, _plan(executor, 12, staleness), problems,
                 workers=4 if app == "lda" else None, recorder=rec)


@pytest.mark.parametrize("executor,staleness", [
    ("loop", 0), ("scan", 0), ("pipelined", 0), ("ssp", 0), ("ssp", 1),
    ("ssp", 2)])
@pytest.mark.parametrize("app", ["lasso", "mf", "lda"])
def test_round_timers_count_the_rounds_and_change_no_bit(app, executor,
                                                         staleness,
                                                         problems):
    """Each of the four timers counts every round run (an SSP window's
    intervals count its s + 1 rounds), off CUDA with no device time, and
    the timed run equals the untimed one to the bit."""
    rec = Recorder()
    _, _, timed = _attached_run(app, executor, staleness, problems, rec)
    _, _, plain = _attached_run(app, executor, staleness, problems, None)
    _equal(plain.state, timed.state)
    timers = rec.timers()
    assert set(timers) == set(ROUND_TIMERS)
    for name in ROUND_TIMERS:
        assert timers[name]["count"] == 12, name
        assert timers[name]["device_s"] is None
        assert timers[name]["host_s"] > 0.0
    parts = sum(timers[n]["host_s"] for n in ("schedule", "push", "pull"))
    assert parts <= timers["round"]["host_s"]
    # an attached Recorder without a trace plan adds no report, and the
    # engine's spans land on it
    assert timed.telemetry is None
    assert {e["name"] for e in rec.to_json_events()} >= {"execute",
                                                         executor}


def test_a_recorder_reads_no_device_value_per_round(problems, monkeypatch):
    """``test_counters_read_no_device_value_per_round``'s check with a
    Recorder attached: its timers and spans read no tensor on the host,
    so a timed run calls ``item``/``tolist``/``__int__``/``__bool__`` as
    often as an untimed one."""
    calls = []
    for name in ("item", "tolist", "__int__", "__bool__"):
        orig = getattr(torch.Tensor, name)

        def spy(self, *a, _orig=orig, _name=name, **kw):
            calls.append(_name)
            return _orig(self, *a, **kw)
        monkeypatch.setattr(torch.Tensor, name, spy)
    counts = []
    for rec in (None, Recorder()):
        calls.clear()
        for executor, s in (("scan", 0), ("pipelined", 0), ("ssp", 1)):
            _attached_run("lasso", executor, s, problems, rec)
        counts.append(list(calls))
    assert counts[0] == counts[1]


def test_a_live_profiler_session_attaches_the_engines_recorder(problems):
    from repro_torch.obs.events import RANGE_PREFIX
    eng, data, rep = _port("lasso", _plan("scan", 4), problems)
    assert eng.recorder is None
    with torch.profiler.profile() as prof:
        rep = eng.execute(rep.state, data, None, _plan("scan", 4))
    rec = eng.recorder
    assert isinstance(rec, Recorder) and rep.telemetry is None
    names = {e.name() for e in prof.profiler.kineto_results.events()}
    want = {RANGE_PREFIX + n for n in ("execute", "scan") + ROUND_TIMERS}
    assert want <= names
    assert rec.timers()["round"]["count"] == 4
    # kept while sessions last, then detached by a run outside them
    with torch.profiler.profile():
        eng.execute(rep.state, data, None, _plan("scan", 4))
    assert eng.recorder is rec and rec.timers()["round"]["count"] == 8
    eng.execute(rep.state, data, None, _plan("scan", 4))
    assert eng.recorder is None
    # a caller's Recorder stays, session or not
    mine = Recorder()
    eng.recorder = mine
    with torch.profiler.profile():
        eng.execute(rep.state, data, None, _plan("scan", 4))
    eng.execute(rep.state, data, None, _plan("scan", 4))
    assert eng.recorder is mine and mine.timers()["round"]["count"] == 8


def test_a_trace_plan_reports_the_attached_recorders_run(problems):
    """Under ``kind="trace"`` with a Recorder attached, the report carries
    that execute's events, which stay on the Recorder."""
    rec = Recorder()
    with rec.span("outer"):
        eng, data, rep = _port("lasso", _plan("scan", 4), problems,
                               recorder=rec)
        rep = eng.execute(rep.state, data, None,
                          _plan("scan", 4, 0, TelemetrySpec(kind="trace")))
    names = [e["name"] for e in rep.telemetry.events]
    assert names == ["execute", "scan"]
    assert [e["name"] for e in rec.to_json_events()] == [
        "outer", "execute", "scan", "execute", "scan"]
    assert validate_spans(rep.telemetry.events) is None


def test_span_times_lie_on_the_profilers_clock():
    """``origin_ns + ts`` of a span lies within 1 ms of its mirrored
    range's start in a ``torch.profiler`` session."""
    rec = Recorder()
    with torch.profiler.profile() as prof:
        for _ in range(3):
            with rec.span("tick"):
                torch.ones(8).sum()
    starts = sorted(e.start_ns() for e in
                    prof.profiler.kineto_results.events()
                    if e.name() == "strads.tick")
    spans = [e for e in rec.to_json_events() if e["name"] == "tick"]
    assert len(starts) == len(spans) == 3
    for ev, start in zip(spans, starts):
        assert abs(rec.origin_ns + ev["ts"] * 1e3 - start) < 1e6
    # the Chrome export of the Recorder is on the same clock, in µs
    doc = chrome_trace(rec.to_json_events(), origin_us=rec.origin_ns / 1e3)
    assert abs(doc["traceEvents"][0]["ts"] * 1e3 - starts[0]) < 1e6


def test_every_spans_parent_is_the_span_around_it(problems, tmp_path):
    plan = _plan("ssp", 8, 1, TelemetrySpec(kind="trace"),
                 checkpoint_every=4)
    _, _, rep = _port("lasso", plan, problems, ckpt_dir=str(tmp_path))
    rec = Recorder()
    with rec.span("a"):
        with rec.span("b"):
            with rec.span("c"):
                pass
        with rec.span("d"):
            pass
    with rec.span("e"):
        pass
    for events in (rep.telemetry.events, rec.to_json_events()):
        spans = [e for e in events if e["ph"] == "X"]
        assert len({e["id"] for e in spans}) == len(spans)
        for ev in spans:
            around = [o for o in spans if o is not ev
                      and o["ts"] <= ev["ts"]
                      and ev["ts"] + ev["dur"] <= o["ts"] + o["dur"]]
            inner = min(around, key=lambda o: o["dur"], default=None)
            assert ev["parent"] == (inner["id"] if inner else None)
            assert "id" not in ev["args"] and "parent" not in ev["args"]


def test_timer_device_time_folds_without_a_sync(monkeypatch):
    """A timer folds its completed device intervals once it holds
    ``_FOLD_AT`` of them (event queries, no sync), and ``timers()``
    resolves the rest; spans opened with ``device=True`` carry the same
    device time as ``device_dur``."""
    from repro_torch.obs import events

    class Mark:
        clock = [0.0]

        def __init__(self):
            self.t = Mark.clock[0]
            Mark.clock[0] += 1.0         # a ms a mark
            self.done = True

        def elapsed_time(self, end):
            return end.t - self.t

        def query(self):
            return self.done

        def synchronize(self):
            self.done = True

    monkeypatch.setattr(events, "_device_mark", Mark)
    monkeypatch.setattr(events, "_FOLD_AT", 3)
    rec = Recorder()
    for _ in range(7):
        with rec.timer("t"):
            pass
    stat = rec._timers["t"]
    assert len(stat.pending) == 1 and stat.device_s == pytest.approx(6e-3)
    with rec.span("s", device=True):
        pass
    t = rec.timers()["t"]
    assert t["count"] == 7 and t["device_s"] == pytest.approx(7e-3)
    assert [e["device_dur"] for e in rec.to_json_events()] == [1e3]
