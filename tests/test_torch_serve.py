"""Serving of the port (``repro_torch.serve``, ``launch/serve.py``, the
Lasso ``query``) against the JAX package's (``tests/test_serve.py``).

Tolerances: Lasso's served ŷ within 1e-5 (relative, 1e-6 absolute) of
the JAX package's responses and of Xβ (f32 sums in another order); MF's
top-k items equal the numpy oracle's and its scores within 1e-5
relative; LDA's θ within 1e-5 of a float64 numpy fold-in.  MF's and
LDA's JAX ``query`` fail on this CPU (ROADMAP.md queue 3), so those two
are held to the oracles.  Training under serving equals an unserved
``execute`` to the bit.  Error texts are the JAX package's.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.apps import lasso as jlasso
from repro.core import ExecutionPlan as JPlan
from repro.core import single_device_mesh
from repro.serve import ModelView as JModelView
from repro.serve import ServeFrontend as JServeFrontend
from repro.serve import ServeSpec as JServeSpec
from repro.serve import serve_while_training as jserve_while_training
from repro_torch.apps import lasso, lda, mf
from repro_torch.core import ExecutionPlan, StradsAppBase
from repro_torch.launch import serve as tserve
from repro_torch.obs import Recorder, TelemetrySpec, validate_spans
from repro_torch.serve import (ModelView, ServeFrontend, ServeSpec,
                               StaleReadError, serve_only,
                               serve_while_training)
from test_torch_lasso import jax_draws
from test_torch_lda import CFG4, _corpus
from test_torch_ssp import MF_SIZE

RTOL, ATOL = 1e-5, 1e-6
N, J = 48, 24
LASSO = dict(num_features=J, lam=0.05, block_size=4, num_candidates=8,
             rho=0.5)


@pytest.fixture(scope="module")
def lasso_problem():
    X, y, _ = jlasso.synthetic_correlated(np.random.default_rng(0), n=N,
                                          J=J, k_true=4)
    return X, y


def _equal(a: dict, b: dict):
    assert set(a) == set(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


def _lasso(X, y, workers=2):
    eng = lasso.make_engine(lasso.LassoConfig(**LASSO), workers=workers,
                            device="cpu")
    return eng, eng.shard_data({"X": X, "y": y}), lambda: eng.init_state(
        y=y)


def _mf(workers=2):
    A, mask = mf.synthetic_ratings(np.random.default_rng(0), 24, 10,
                                   true_rank=3, density=0.5)
    eng = mf.make_engine(mf.MFConfig(**MF_SIZE, top_k=4), workers=workers,
                         device="cpu")
    return eng, eng.shard_data({"A": A, "mask": mask}), lambda: \
        eng.init_state(A=A, mask=mask,
                       generator=torch.Generator().manual_seed(2))


def _lda():
    words, docs, z0 = _corpus(CFG4)
    eng = lda.make_engine(lda.LDAConfig(**CFG4), device="cpu")
    return eng, eng.shard_data({"words": words, "docs": docs}), lambda: \
        eng.init_state(words=words, docs=docs, z0=z0)


# ---------------------------------------------------------------------------
# ServeSpec: validation and JSON equal to the JAX package's
# ---------------------------------------------------------------------------

BAD_SPECS = [dict(kind="fresh"), dict(kind="snapshot", max_staleness=2),
             dict(kind="stale", max_staleness=-1),
             dict(kind="stale", max_staleness=True),
             dict(kind="stale", max_batch=0),
             dict(kind="stale", batch_window_ms=-0.5),
             dict(kind="stale", batch_window_ms=True)]


@pytest.mark.parametrize("kw", BAD_SPECS)
def test_spec_rejects_what_the_jax_spec_rejects(kw):
    with pytest.raises(ValueError) as want:
        JServeSpec(**kw)
    with pytest.raises(ValueError) as got:
        ServeSpec(**kw)
    assert str(got.value) == str(want.value)


def test_spec_json_and_defaults_equal_the_jax_spec():
    for s in (dict(kind="stale", max_staleness=3, max_batch=16,
                   batch_window_ms=2.5),
              dict(kind="snapshot", max_batch=4), dict(kind="stale")):
        ours, theirs = ServeSpec(**s), JServeSpec(**s)
        assert ours.to_json() == theirs.to_json()
        assert ServeSpec.from_json(json.dumps(ours.to_json())) == ours
    for kind in ("stale", "snapshot"):
        assert ServeSpec.default_for(kind).to_json() == \
            JServeSpec.default_for(kind).to_json()
    assert ServeSpec.default_for("stale", max_staleness=7).to_json() == \
        JServeSpec.default_for("stale", max_staleness=7).to_json()
    for bad in ({"kind": "stale", "staleness": 2}, "[1]"):
        with pytest.raises((ValueError, TypeError)) as want:
            JServeSpec.from_json(bad)
        with pytest.raises(type(want.value)) as got:
            ServeSpec.from_json(bad)
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="serve kind"):
        ServeSpec.default_for("fresh")


def test_serve_spec_is_not_a_plan_field():
    with pytest.raises(ValueError, match="unknown"):
        ExecutionPlan.from_json({"executor": "ssp", "rounds": 6,
                                 "staleness": 1, "serve": {"kind": "stale"}})


# ---------------------------------------------------------------------------
# The query primitives
# ---------------------------------------------------------------------------

def test_lasso_query_predict_equals_the_jax_query(lasso_problem):
    X, y = lasso_problem
    eng, data, init = _lasso(X, y)
    st = eng.execute(init(), data, None, ExecutionPlan(executor="scan",
                                                       rounds=8)).state
    out = eng.app.query(st, {"x": torch.as_tensor(X[:5])})
    jout = jlasso.StradsLasso(jlasso.LassoConfig(**LASSO)).query(
        {"beta": jnp.asarray(st["beta"].numpy())}, {"x": jnp.asarray(X[:5])})
    np.testing.assert_allclose(out["y_hat"].numpy(),
                               np.asarray(jout["y_hat"]), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(out["y_hat"].numpy(),
                               X[:5] @ st["beta"].numpy(), rtol=RTOL,
                               atol=ATOL)
    assert bool((st["beta"] != 0).any())


def test_mf_query_recommend_equals_the_numpy_oracle():
    eng, data, init = _mf()
    st = eng.execute(init(), data, None, ExecutionPlan(executor="scan",
                                                       rounds=4)).state
    users = [0, 5, 23]
    out = eng.app.query(st, {"user": torch.tensor(users, dtype=torch.int32)})
    assert out["items"].shape == (3, 4)
    scores = (eng.unshard(st)["W"].double() @ st["H"].double()).numpy()
    for b, u in enumerate(users):
        want = np.argsort(-scores[u])[:4]
        np.testing.assert_array_equal(out["items"][b].numpy(), want)
        np.testing.assert_allclose(out["scores"][b].numpy(),
                                   scores[u][want], rtol=RTOL)


def _fold_in(B, s, words, cfg, iters):
    """θ of a batch of documents by the fixed-iteration mean-field fold-in
    against fixed topics, in float64 numpy."""
    B, s = np.asarray(B, np.float64), np.asarray(s, np.float64)
    vg = cfg.padded_vocab * cfg.gamma
    out = []
    for doc in words:
        toks = [v for v in doc if v >= 0]
        phi = np.stack([(cfg.gamma + B[v]) / (vg + s) for v in toks])
        theta = np.full(cfg.num_topics, 1.0 / cfg.num_topics)
        for _ in range(iters):
            q = phi * theta
            q /= q.sum(1, keepdims=True)
            theta = cfg.alpha + q.sum(0)
            theta /= theta.sum()
        out.append(theta)
    return np.stack(out)


def test_lda_query_infer_topics_equals_a_numpy_fold_in():
    eng, data, init = _lda()
    st = eng.execute(init(), data, None, ExecutionPlan(executor="scan",
                                                       rounds=4)).state
    cfg = eng.app.cfg
    docs = np.array([[1, 2, 3, 4, -1, -1], [7, 7, 50, 9, 11, 3]], np.int32)
    out = eng.app.query(st, {"words": torch.as_tensor(docs)})
    want = _fold_in(st["B"].reshape(-1, cfg.num_topics).numpy(),
                    st["s"].numpy(), docs, cfg, eng.app.query_iters)
    np.testing.assert_allclose(out["theta"].numpy(), want, rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_array_equal(out["top_topic"].numpy(),
                                  want.argmax(-1))
    # −1 padding is inert
    short = eng.app.query(st, {"words": torch.as_tensor(docs[:1, :4])})
    np.testing.assert_allclose(short["theta"].numpy(),
                               out["theta"][:1].numpy(), rtol=RTOL)


def test_queries_keep_tensor_batches_off_the_host(lasso_problem,
                                                  monkeypatch):
    """A batch already on the engine's device is read as a tensor, never
    through numpy (LDA's query once went through ``np.asarray``, which
    raises for a batch on the card): here any tensor → numpy conversion
    during the queries fails the test."""
    X, y = lasso_problem
    apps = {"lasso": (_lasso(X, y), {"x": torch.as_tensor(X[:3])}),
            "mf": (_mf(), {"user": torch.tensor([1, 2], dtype=torch.int32)}),
            "lda": (_lda(), {"words": torch.tensor([[1, 2, -1], [4, 5, 6]],
                                                   dtype=torch.int32)})}
    states = {k: init() for k, ((_, _, init), _) in apps.items()}

    def no_host_copy(self, *a, **kw):
        raise AssertionError("a query copied a tensor batch to the host")

    monkeypatch.setattr(torch.Tensor, "__array__", no_host_copy)
    monkeypatch.setattr(torch.Tensor, "numpy", no_host_copy)
    for name, ((eng, _, _), batch) in apps.items():
        out = eng.app.query(states[name], batch)
        assert all(torch.is_tensor(v) for v in out.values()), name


def test_query_default_raises():
    class NoQuery(StradsAppBase):
        pass
    with pytest.raises(NotImplementedError, match="query"):
        NoQuery().query({}, {})


# ---------------------------------------------------------------------------
# ModelView: the lazy gate, pins, the mixed view, StaleReadError
# ---------------------------------------------------------------------------

def test_view_read_before_publish_raises(lasso_problem):
    eng, _, _ = _lasso(*lasso_problem)
    for kind in ("stale", "snapshot"):
        with pytest.raises(StaleReadError, match="publish"):
            ModelView(eng, ServeSpec.default_for(kind)).read()
    with pytest.raises(TypeError, match="ServeSpec"):
        ModelView(eng, {"kind": "stale"})


def test_view_stale_gate_refreshes_lazily_as_the_jax_view(lasso_problem):
    X, y = lasso_problem
    eng, _, init = _lasso(X, y)
    jeng = jlasso.make_engine(jlasso.LassoConfig(**LASSO),
                              single_device_mesh())
    spec = dict(kind="stale", max_staleness=2, max_batch=1)
    view, jview = ModelView(eng, ServeSpec(**spec)), JModelView(
        jeng, JServeSpec(**spec))
    state = init()
    jstate = jeng.init_state(jax.random.key(0), y=y)
    for t in (0, 2, 3, 4, 7, 8, 9, 12):
        view.publish(state, t)
        jview.publish(jstate, t)
        assert view.read()[1] == jview.read()[1]
    assert view.reads == [{k: int(v) for k, v in r.items()}
                          for r in jview.reads]
    assert [r["staleness"] for r in view.reads] == [0, 2, 0, 1, 0, 1, 2, 0]
    assert view.staleness_hist() == {0: 4, 1: 2, 2: 2}
    assert view.max_staleness_read() == 2


def test_view_stale_serves_the_mixed_ssp_view(lasso_problem):
    eng, _, init = _lasso(*lasso_problem)
    state = init()
    view = ModelView(eng, ServeSpec(kind="stale", max_staleness=4,
                                    max_batch=1))
    view.publish(state, 0)
    newer = dict(state, beta=state["beta"] + 1.0, r=state["r"] * 2.0)
    view.publish(newer, 3)
    v, s = view.read()
    assert s == 3
    assert torch.equal(v["beta"], state["beta"])          # stale, a copy
    assert v["beta"] is not state["beta"]
    assert v["r"] is newer["r"]                           # live
    # the cache is a copy: writing the published β in place changes nothing
    state["beta"].add_(5.0)
    assert torch.equal(view.read()[0]["beta"], newer["beta"] - 1.0)


def test_view_release_ends_the_boundary_scope(lasso_problem):
    eng, _, init = _lasso(*lasso_problem)
    state = init()
    stale = ModelView(eng, ServeSpec(kind="stale", max_staleness=2))
    pin = ModelView(eng, ServeSpec(kind="snapshot"))
    for view in (stale, pin):
        view.publish(state, 0)
        view.release()
    with pytest.raises(StaleReadError, match="released"):
        stale.read()
    assert torch.equal(pin.read()[0]["r"], state["r"])   # pins stay
    stale.publish(state, 1)
    assert stale.read()[1] == 1


def test_view_snapshot_pins_a_copy(lasso_problem):
    eng, _, init = _lasso(*lasso_problem)
    state = init()
    view = ModelView(eng, ServeSpec.default_for("snapshot"))
    view.publish(state, 4)
    pinned, s = view.read()
    assert s == 0
    _equal(pinned, state)
    assert pinned["beta"] is not state["beta"]
    view.publish(state, 4)
    assert view.read()[1] == 0


def test_lda_pins_survive_a_chunk_of_in_place_writes():
    """LDA's push writes z, B and D in place: a pin taken before a chunk
    keeps its values after the chunk ran on the same tensors; the stale
    kind's boundary references are released before it."""
    eng, data, init = _lda()
    state = init()
    before = {k: v.clone() for k, v in state.items()}
    pin = ModelView(eng, ServeSpec(kind="snapshot"))
    stale = ModelView(eng, ServeSpec(kind="stale", max_staleness=8))
    pin.publish(state, 0)
    stale.publish(state, 0)
    pin.release()
    stale.release()
    B_live = state["B"]
    rep = eng.execute(state, data, None, ExecutionPlan(executor="scan",
                                                       rounds=4))
    assert rep.state["B"] is B_live                 # written in place
    assert not torch.equal(B_live, before["B"])
    pinned, _ = pin.read()
    _equal(pinned, before)
    with pytest.raises(StaleReadError):
        stale.read()
    # the query on the pin answers for the pinned topics
    docs = torch.tensor([[1, 2, 3, 4, 5, 6]], dtype=torch.int32)
    np.testing.assert_array_equal(
        eng.app.query(pinned, {"words": docs})["theta"].numpy(),
        eng.app.query(before, {"words": docs})["theta"].numpy())


# ---------------------------------------------------------------------------
# The frontend: the same batches as the JAX frontend under a fake clock
# ---------------------------------------------------------------------------

def _fake_clock():
    t = [0.0]

    def clock():
        return t[0]
    clock.advance = lambda dt: t.__setitem__(0, t[0] + dt)
    return clock


def test_frontend_forms_the_jax_frontends_batches(lasso_problem):
    X, y = lasso_problem
    eng, data, init = _lasso(X, y)
    state = eng.execute(init(), data, None,
                        ExecutionPlan(executor="scan", rounds=6)).state
    jeng = jlasso.make_engine(jlasso.LassoConfig(**LASSO),
                              single_device_mesh())
    jstate = {"beta": jnp.asarray(state["beta"].numpy()),
              "r": jnp.asarray(state["r"].reshape(-1).numpy())}
    logs = []
    for make in ("port", "jax"):
        spec_kw = dict(kind="stale", max_staleness=0, max_batch=3,
                       batch_window_ms=10.0)
        clock = _fake_clock()
        if make == "port":
            spec = ServeSpec(**spec_kw)
            view = ModelView(eng, spec)
            fe = ServeFrontend(eng, view, spec, clock=clock)
            view.publish(state, 0)
            x = lambda i: {"x": X[i]}                       # noqa: E731
        else:
            spec = JServeSpec(**spec_kw)
            view = JModelView(jeng, spec)
            fe = JServeFrontend(jeng, view, spec, clock=clock)
            view.publish(jstate, 0)
            x = lambda i: {"x": jnp.asarray(X[i])}          # noqa: E731
        served = []
        for i in range(7):
            fe.submit(x(i))
        served.append(fe.flush())          # two full batches; 1 waits
        fe.submit(x(7))
        served.append(fe.flush())          # 2 queued, window open
        clock.advance(0.011)
        served.append(fe.flush())          # window expired: served
        fe.submit(x(8))
        served.append(fe.flush(force=True))
        logs.append((served, len(view.reads), fe.pending(),
                     [r.latency_ms for r in fe.responses],
                     [float(r.result["y_hat"]) for r in fe.responses]))
    (s, n, p, lat, yh), (js, jn, jp, jlat, jyh) = logs
    assert (s, n, p, lat) == (js, jn, jp, jlat)
    assert s == [6, 0, 2, 1] and n == 4
    np.testing.assert_allclose(yh, jyh, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(yh, X[:9] @ state["beta"].numpy(),
                               rtol=RTOL, atol=ATOL)
    assert ServeFrontend(eng, ModelView(eng, ServeSpec(kind="stale")),
                         ServeSpec(kind="stale")).latency_percentiles()[
        "p50_ms"] != 0.0     # NaN with nothing served


def test_frontend_requires_matching_spec(lasso_problem):
    eng, _, _ = _lasso(*lasso_problem)
    view = ModelView(eng, ServeSpec.default_for("stale"))
    with pytest.raises(ValueError, match="share one ServeSpec"):
        ServeFrontend(eng, view, ServeSpec.default_for("snapshot"))


# ---------------------------------------------------------------------------
# serve_while_training: training equals the unserved execute, to the bit
# ---------------------------------------------------------------------------

def _requests(app, n, R, X=None):
    if app == "lasso":
        pay = [{"x": X[i % len(X)]} for i in range(n)]
    elif app == "mf":
        pay = [{"user": np.int32(i % 24)} for i in range(n)]
    else:
        pay = [{"words": np.arange(i, i + 6, dtype=np.int32) % 53}
               for i in range(n)]
    return [((i * R) // n, p) for i, p in enumerate(pay)]


@pytest.mark.parametrize("app,executor,staleness,kind", [
    ("lasso", "ssp", 2, "stale"), ("lasso", "scan", 0, "snapshot"),
    ("mf", "ssp", 1, "stale"), ("mf", "pipelined", 0, "snapshot"),
    ("lda", "ssp", 1, "stale"), ("lda", "scan", 0, "snapshot")])
def test_serve_while_training_equals_execute(app, executor, staleness, kind,
                                             lasso_problem):
    X, y = lasso_problem
    eng, data, init = {"lasso": lambda: _lasso(X, y), "mf": _mf,
                       "lda": _lda}[app]()
    R = 12 if app != "lda" else 8
    plan = ExecutionPlan(executor=executor, rounds=R, staleness=staleness)
    spec = (ServeSpec(kind="stale", max_staleness=staleness + 1)
            if kind == "stale" else ServeSpec.default_for("snapshot"))
    reqs = _requests(app, 9, R, X)
    collect = eng.app.objective_collect() if app != "lda" else None
    gen = (lambda: torch.Generator().manual_seed(5)) if app == "lasso" \
        else (lambda: None)
    srep = serve_while_training(eng, init(), data, gen(), plan, spec=spec,
                                requests=reqs, collect=collect)
    ref = eng.execute(init(), data, gen(), plan, collect=collect)
    _equal(srep.report.state, ref.state)
    if collect is not None:
        assert torch.equal(srep.report.trace, ref.trace)
    assert srep.report.carry.t == R and len(srep.responses) == len(reqs)
    assert srep.max_staleness_read() <= spec.max_staleness
    assert sum(srep.staleness_hist().values()) == len(srep.reads)


def test_serve_while_training_follows_the_jax_trajectory(lasso_problem):
    """Fed the JAX draws, Lasso's served run reads at the JAX run's
    staleness and answers within 1e-5 of the JAX responses."""
    X, y = lasso_problem
    R = 12
    plan_kw = dict(executor="ssp", rounds=R, staleness=2)
    spec_kw = dict(kind="stale", max_staleness=4, max_batch=2)
    reqs = [(t, i) for i, t in enumerate((0, 0, 3, 5, 6, 9, 11, 12, 12))]
    jeng = jlasso.make_engine(jlasso.LassoConfig(**LASSO),
                              single_device_mesh())
    jdata = jeng.shard_data({"X": jnp.asarray(X), "y": jnp.asarray(y)})
    jrep = jserve_while_training(
        jeng, jeng.init_state(jax.random.key(0), y=y), jdata,
        jax.random.key(0), JPlan(**plan_kw), spec=JServeSpec(**spec_kw),
        requests=[(t, {"x": jnp.asarray(X[i])}) for t, i in reqs])
    draws = jax_draws(R, J)
    eng, data, init = _lasso(X, y, workers=4)
    srep = serve_while_training(
        eng, init(), data, None, ExecutionPlan(**plan_kw),
        spec=ServeSpec(**spec_kw), noise=lambda t: draws[t],
        requests=[(t, {"x": X[i]}) for t, i in reqs])
    assert srep.reads == [{k: int(v) for k, v in r.items()}
                          for r in jrep.reads]
    assert srep.staleness_hist() == {0: 4, 3: 2} == jrep.staleness_hist()
    np.testing.assert_allclose(
        [float(r.result["y_hat"]) for r in srep.responses],
        [float(r.result["y_hat"]) for r in jrep.responses],
        rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(srep.report.state["beta"].numpy(),
                               np.asarray(jrep.report.state["beta"]),
                               atol=ATOL * 10)


def test_serve_while_training_records_spans_and_rejects_bad_input(
        lasso_problem):
    X, y = lasso_problem
    eng, data, init = _lasso(X, y)
    plan = ExecutionPlan(executor="ssp", rounds=6, staleness=2)
    rec = Recorder()
    serve_while_training(eng, init(), data, None, plan, recorder=rec,
                         requests=[(3, {"x": X[0]})])
    names = [e["name"] for e in rec.to_json_events()]
    assert {"train_chunk", "serve_batch", "serve_read",
            "serve_refresh"} <= set(names)
    assert names.count("train_chunk") == 2
    with pytest.raises(TypeError, match="t_due"):
        serve_while_training(eng, init(), data, None, plan,
                             requests=[{"x": X[0]}])
    with pytest.raises(ValueError, match="due round"):
        serve_while_training(eng, init(), data, None, plan,
                             requests=[(99, {"x": X[0]})])
    with pytest.raises(ValueError, match="multiple"):
        serve_while_training(eng, init(), data, None,
                             ExecutionPlan(executor="ssp", rounds=12,
                                           staleness=2), chunk_rounds=4)
    with pytest.raises(TypeError, match="stream= wants a StreamSpec"):
        serve_while_training(eng, init(), data, None, plan,
                             stream=object(), source=object())


def test_serve_only(lasso_problem):
    X, y = lasso_problem
    eng, data, init = _lasso(X, y)
    trained = eng.execute(init(), data, None,
                          ExecutionPlan(executor="scan", rounds=8)).state
    srep = serve_only(eng, trained, requests=[{"x": X[i]} for i in range(5)],
                      t=8)
    assert srep.report is None and len(srep.responses) == 5
    assert srep.max_staleness_read() == 0
    np.testing.assert_allclose(
        [float(r.result["y_hat"]) for r in srep.responses],
        X[:5] @ trained["beta"].numpy(), rtol=RTOL, atol=ATOL)
    pct = srep.latency_percentiles()
    assert 0 <= pct["p50_ms"] <= pct["p99_ms"]


# ---------------------------------------------------------------------------
# The serving layer on a Recorder: waits, request ids, one timeline
# ---------------------------------------------------------------------------

def test_batch_spans_carry_each_requests_wait(lasso_problem):
    """Under a fake clock each ``waits_us`` of a ``serve_batch`` span is
    the batch's start less that request's submit, and the span names its
    requests' ids."""
    X, y = lasso_problem
    eng, data, init = _lasso(X, y)
    rec, clock = Recorder(), _fake_clock()
    spec = ServeSpec(kind="stale", max_staleness=0, max_batch=3,
                     batch_window_ms=1e4)
    view = ModelView(eng, spec)
    fe = ServeFrontend(eng, view, spec, recorder=rec, clock=clock)
    view.publish(init(), 0)
    submits = []
    for i in range(5):
        submits.append(clock())
        assert fe.submit({"x": X[i]}) == i
        clock.advance(0.25 * (i + 1))
    starts = [clock()]
    assert fe.flush() == 3                 # a full batch; 2 wait
    clock.advance(0.5)
    starts.append(clock())
    assert fe.flush(force=True) == 2
    batches = [e for e in rec.to_json_events() if e["name"] == "serve_batch"]
    assert [b["requests"] for b in batches] == [[0, 1, 2], [3, 4]]
    for b, start in zip(batches, starts):
        want = [(start - submits[i]) * 1e6 for i in b["requests"]]
        assert b["waits_us"] == pytest.approx(want, rel=1e-12)
        assert set(b["args"]) == {"size", "staleness"}
    assert rec.timers()["serve_query"]["count"] == 2
    publish = [e for e in rec.to_json_events()
               if e["name"] == "serve_publish"]
    assert len(publish) == 1 and publish[0]["device_dur"] is None


def test_request_ids_cover_every_served_request_once(lasso_problem):
    X, y = lasso_problem
    eng, data, init = _lasso(X, y)
    rec = Recorder()
    reqs = _requests("lasso", 11, 6, X)
    srep = serve_while_training(eng, init(), data, None,
                                ExecutionPlan(executor="ssp", rounds=6,
                                              staleness=1),
                                recorder=rec, requests=reqs)
    ids = [i for e in rec.to_json_events() if e["name"] == "serve_batch"
           for i in e["requests"]]
    assert sorted(ids) == list(range(len(reqs))) == list(range(
        len(srep.responses)))
    waits = [w for e in rec.to_json_events() if e["name"] == "serve_batch"
             for w in e["waits_us"]]
    assert len(waits) == len(ids) and min(waits) >= 0.0


def test_frontends_share_the_engines_recorder(lasso_problem):
    """A frontend or view given a Recorder attaches it to an engine that
    has none; one given none uses the engine's, looked up when it
    publishes or serves."""
    X, y = lasso_problem
    eng, data, init = _lasso(X, y)
    spec = ServeSpec(kind="stale", max_staleness=0)
    view = ModelView(eng, spec)
    plain = ServeFrontend(eng, view, spec)
    assert eng.recorder is None and plain.recorder is None
    rec = Recorder()
    fe = ServeFrontend(eng, view, spec, recorder=rec)
    assert eng.recorder is rec and plain.recorder is rec \
        and view.recorder is rec
    other = Recorder()
    assert ServeFrontend(eng, view, spec, recorder=other).recorder is other
    assert eng.recorder is rec                 # the engine keeps its own
    view.publish(init(), 0)
    plain.submit({"x": X[0]})
    plain.flush(force=True)
    fe.submit({"x": X[1]})
    fe.flush(force=True)
    names = [e["name"] for e in rec.to_json_events()]
    assert names.count("serve_batch") == 2 and "serve_publish" in names
    eng2, _, init2 = _lasso(X, y)
    ModelView(eng2, spec, recorder=rec)
    assert eng2.recorder is rec


def test_a_traced_served_run_is_one_timeline(lasso_problem):
    """Under ``kind="trace"``, ``serve_while_training`` leaves one event
    list: every ``execute`` nests inside its ``train_chunk``, and the
    whole list is strictly nested."""
    X, y = lasso_problem
    eng, data, init = _lasso(X, y)
    rec = Recorder()
    plan = ExecutionPlan(executor="ssp", rounds=6, staleness=2,
                         telemetry=TelemetrySpec(kind="trace"))
    srep = serve_while_training(eng, init(), data, None, plan, recorder=rec,
                                requests=_requests("lasso", 5, 6, X))
    events = rec.to_json_events()
    assert validate_spans(events) is None
    chunks = {e["id"]: e for e in events if e["name"] == "train_chunk"}
    execs = [e for e in events if e["name"] == "execute"]
    assert len(chunks) == len(execs) == 2
    assert all(e["parent"] in chunks for e in execs)
    assert rec.timers()["round"]["count"] == 6
    # the last chunk's report carries its own execute's events
    assert [e["name"] for e in srep.report.telemetry.events][:2] == [
        "execute", "ssp"]


@settings(max_examples=6, deadline=None)
@given(st.integers(min_value=0, max_value=2),
       st.integers(min_value=0, max_value=5),
       st.integers(min_value=1, max_value=3))
def test_read_staleness_never_exceeds_bound(train_s, bound, spread):
    """Every read under kind="stale" observes state at most max_staleness
    rounds old, over random (training staleness, serving bound, request
    interleaving) configurations, on the staleness the view logged."""
    X, y, _ = jlasso.synthetic_correlated(
        np.random.default_rng(train_s * 11 + bound), n=N, J=J, k_true=4)
    eng, data, init = _lasso(X, y)
    R = 6 * (train_s + 1)
    plan = ExecutionPlan(executor="ssp", rounds=R, staleness=train_s)
    spec = ServeSpec(kind="stale", max_staleness=bound, max_batch=2)
    reqs = [((i * spread) % (R + 1), {"x": X[i % len(X)]})
            for i in range(10)]
    srep = serve_while_training(eng, init(), data, None, plan, spec=spec,
                                requests=reqs)
    assert len(srep.responses) == len(reqs) and srep.reads
    for r in srep.reads:
        assert r["staleness"] <= bound, r
    assert sum(srep.staleness_hist().values()) == len(srep.reads)


# ---------------------------------------------------------------------------
# The CLI, on the CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("engine", ["lasso", "lda", "mf"])
def test_serve_cli_on_the_cpu(engine, tmp_path, capsys):
    out, trace = str(tmp_path / "a.json"), str(tmp_path / "t.json")
    srep = tserve.main(["--engine", engine, "--requests", "12",
                        "--device", "cpu", "--workers", "2", "--out", out,
                        "--trace", trace])
    assert len(srep.responses) == 12
    art = json.load(open(out))
    assert art["requests"] == 12 and art["device"] == "cpu"
    assert art["max_staleness_read"] <= art["serve_spec"]["max_staleness"]
    names = {e["name"] for e in json.load(open(trace))["traceEvents"]}
    assert {"train_chunk", "serve_batch", "serve_read"} <= names
    assert "latency p50=" in capsys.readouterr().out


def test_serve_cli_options_and_refusals(tmp_path):
    plan = str(tmp_path / "p.json")
    with open(plan, "w") as f:
        json.dump(ExecutionPlan(executor="ssp", rounds=6, staleness=2,
                                workers=2).to_json(), f)
    srep = tserve.main(["--engine", "lasso", "--plan", plan, "--requests",
                        "8", "--device", "cpu", "--serve-kind", "snapshot"])
    assert srep.spec.kind == "snapshot" and len(srep.responses) == 8
    srep = tserve.main(["--engine", "lasso", "--requests", "4", "--device",
                        "cpu", "--serve-only", "--staleness", "0"])
    assert srep.report is None and srep.reads[0]["t"] == 12
    for argv in (["--stream-kind", "extend"], ["--ingest-every", "4"]):
        with pytest.raises(SystemExit, match="needs --stream"):
            tserve.main(["--engine", "lasso", "--device", "cpu"] + argv)
    with pytest.raises(SystemExit, match="conflicts"):
        tserve.main(["--engine", "lasso", "--device", "cpu", "--plan", plan,
                     "--rounds", "4"])
    with pytest.raises(SystemExit, match="stale only"):
        tserve.main(["--engine", "lasso", "--device", "cpu", "--serve-kind",
                     "snapshot", "--max-staleness", "1"])
