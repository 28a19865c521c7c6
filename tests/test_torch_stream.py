"""The port's streaming ingest (``repro_torch.stream``) against the JAX
package's ``repro.stream``.

What runs of the JAX package here: its spec, its sources (numpy), its
``Ingestor`` cursor arithmetic (``_slots``, numpy), a streamed run with
an ``EmptySource`` and its engine resumed span by span with ``carry=``.
Its ``ingest`` calls scatter into sharded operands and raise under this
jax, so the port's streamed trajectories are held against the JAX engine
run from boundary to boundary with a numpy oracle of the ingest between
the spans: the row writes, then the derived state recomputed in numpy
(r = y − Xβ on the rows, R = (A − WH)·mask on the rows, LDA's counts
recounted from (words, docs, z)).

Tolerances: Lasso's β and r within 1e-5 every round (f32 sums in another
order), MF's W, H and R within 1e-5 of their largest value, LDA's z and
counts to the bit (the port is fed the JAX sampler's draws).  Port
against port — empty source against unstreamed, loop against scan,
resumed against uninterrupted, served against unserved — is to the bit.
A delta split in two at a boundary is held within 1e-5 (the derived
state of the rows is two smaller products, as in the JAX package's own
test).  SyntheticLMSource is held to the bit against the port's
``make_batch`` (the port's draws differ from JAX's PRNG) and to the JAX
source's keys and shapes.
"""
import json

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
from repro.data.pipeline import SyntheticLMConfig as JLMConfig
from repro import stream as jstream
from repro_torch import convert
from repro_torch import stream as tstream
from repro_torch.apps import lasso, lda, mf
from repro_torch.checkpoint import load_flat, restore_checkpoint
from repro_torch.core import ExecutionPlan, StradsAppBase
from repro_torch.data import SyntheticLMConfig, make_batch, synthetic_batches
from repro_torch.kernels import KernelSpec
from repro_torch.launch import serve as tserve
from repro_torch.obs import TelemetrySpec
from repro_torch.serve import serve_while_training
from repro_torch.stream import (EmptySource, Ingestor, LassoDriftSource,
                                LDADriftSource, MFDriftSource,
                                ScheduledSource, StreamSpec,
                                SyntheticLMSource, replay_data)
from test_torch_lasso import jax_draws
from test_torch_lda import CFG1, _corpus, jax_noise

ATOL = 1e-5          # Lasso β, r
RTOL = 1e-5          # MF: of the largest value
EXECUTORS = ("loop", "scan", "pipelined", "ssp")
N, J = 48, 24
LASSO = dict(num_features=J, lam=0.05, block_size=4, num_candidates=8,
             rho=0.5)
MF_SIZE = dict(num_rows=24, num_cols=10, rank=3, lam=0.05)
R, EVERY = 8, 2


@pytest.fixture(scope="module")
def lasso_problem():
    X, y, _ = jlasso.synthetic_correlated(np.random.default_rng(0), n=N,
                                          J=J, k_true=4)
    return X, y


@pytest.fixture(scope="module")
def mf_problem():
    return jmf.synthetic_ratings(np.random.default_rng(0), 24, 10,
                                 true_rank=2, density=0.5)


def _equal(a: dict, b: dict):
    assert set(a) == set(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


def _plan(executor, rounds, **kw):
    if executor == "ssp":
        kw.setdefault("staleness", 1)
    return ExecutionPlan(executor=executor, rounds=rounds, **kw)


def _jplan(executor, rounds):
    return JPlan(executor=executor, rounds=rounds, donate=False,
                 **({"staleness": 1} if executor == "ssp" else {}))


# --- the port's three apps on the CPU (data always a copy: the port's
# --- streamed runs write into the tensors they are handed)

def _lasso(X, y, workers=1):
    eng = lasso.make_engine(lasso.LassoConfig(**LASSO), workers=workers,
                            device="cpu")
    data = eng.shard_data({"X": X.copy(), "y": y.copy()})
    return eng, data, eng.init_state(y=y)


def _mf(A, mask, workers=2):
    eng = mf.make_engine(mf.MFConfig(**MF_SIZE), workers=workers,
                         device="cpu")
    data = eng.shard_data({"A": A.copy(), "mask": mask.copy()})
    state = eng.init_state(A=A, mask=mask,
                           generator=torch.Generator().manual_seed(2))
    return eng, data, state


def _lda(cfg_kw=CFG1, noise=None):
    words, docs, z0 = _corpus(cfg_kw)
    eng = lda.make_engine(lda.LDAConfig(**cfg_kw), device="cpu",
                          noise=noise)
    data = eng.shard_data({"words": words.copy(), "docs": docs.copy()})
    return eng, data, eng.init_state(words=words, docs=docs, z0=z0)


def _lasso_src(seed=3, rows=8, cls=LassoDriftSource):
    return cls(num_rows=N, num_features=J, rows_per_ingest=rows, seed=seed)


def _mf_src(kind="extend", seed=5, rows=4, cls=MFDriftSource):
    return cls(num_rows=24, num_cols=10, rows_per_ingest=rows, true_rank=2,
               kind=kind, seed=seed)


def _lda_src(kind="extend", seed=7, tokens=40, cfg_kw=CFG1,
             cls=LDADriftSource):
    return cls(num_tokens=cfg_kw["num_workers"] * cfg_kw[
        "tokens_per_worker"], vocab=cfg_kw["vocab"],
        num_topics=cfg_kw["num_topics"],
        docs_per_worker=cfg_kw["docs_per_worker"],
        tokens_per_ingest=tokens, kind=kind, seed=seed)


# ---------------------------------------------------------------------------
# StreamSpec: the JAX spec's rules and JSON
# ---------------------------------------------------------------------------

BAD_SPECS = [dict(kind="append"), dict(kind="replace", capacity=16),
             dict(kind="replace", ingest_every=0),
             dict(kind="replace", ingest_every=True),
             dict(kind="extend", capacity=-1),
             dict(kind="extend", capacity=True),
             dict(kind="extend", ingest_every=2.0)]


@pytest.mark.parametrize("kw", BAD_SPECS)
def test_spec_rejects_what_the_jax_spec_rejects(kw):
    with pytest.raises(Exception) as want:
        jstream.StreamSpec(**kw)
    with pytest.raises(type(want.value)) as got:
        StreamSpec(**kw)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("obj", [{"kind": "extend", "ring": 8}, ["extend"],
                                 "[1]"])
def test_spec_from_json_rejects_what_the_jax_spec_rejects(obj):
    with pytest.raises(Exception) as want:
        jstream.StreamSpec.from_json(obj)
    with pytest.raises(type(want.value)) as got:
        StreamSpec.from_json(obj)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("kw", [dict(kind="replace", ingest_every=4),
                                dict(kind="extend", ingest_every=2,
                                     capacity=64),
                                dict(kind="extend")])
def test_spec_json_and_defaults_equal_the_jax_spec(kw):
    s, js = StreamSpec(**kw), jstream.StreamSpec(**kw)
    assert s.to_json() == js.to_json()
    assert StreamSpec.from_json(json.dumps(js.to_json())) == s
    assert jstream.StreamSpec.from_json(json.dumps(s.to_json())) == js
    assert StreamSpec.from_json(s.to_json()) == s
    for kind in ("replace", "extend"):
        assert StreamSpec.default_for(kind).to_json() == \
            jstream.StreamSpec.default_for(kind).to_json()
    assert StreamSpec.default_for("extend", capacity=32).to_json() == \
        jstream.StreamSpec.default_for("extend", capacity=32).to_json()
    with pytest.raises(ValueError, match="stream kind"):
        StreamSpec.default_for("append")
    with pytest.raises(ValueError, match="unknown"):
        ExecutionPlan.from_json({"executor": "ssp", "rounds": 6,
                                 "staleness": 1,
                                 "stream": {"kind": "extend"}})


# ---------------------------------------------------------------------------
# Sources: the JAX sources' arrays to the bit
# ---------------------------------------------------------------------------

SOURCES = {
    "lasso": lambda cls: _lasso_src(cls=cls),
    "mf_extend": lambda cls: _mf_src("extend", cls=cls),
    "mf_replace": lambda cls: _mf_src("replace", cls=cls),
    "lda_extend": lambda cls: _lda_src("extend", cls=cls),
    "lda_replace": lambda cls: _lda_src("replace", cls=cls),
}
CLASSES = {"lasso": "LassoDriftSource", "mf": "MFDriftSource",
           "lda": "LDADriftSource"}


def _same_delta(a, b):
    assert set(a) == set(b)
    for k in a:
        if isinstance(a[k], dict):
            _same_delta(a[k], b[k])
        else:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("name", sorted(SOURCES))
@pytest.mark.parametrize("t", range(9))
def test_drift_sources_take_the_jax_arrays_to_the_bit(name, t):
    cls = CLASSES[name.split("_")[0]]
    port = SOURCES[name](getattr(tstream, cls))
    ref = SOURCES[name](getattr(jstream, cls))
    assert port.peek(t) == ref.peek(t)
    got, want = port.take(t), ref.take(t)
    if want is None:
        assert got is None
        return
    assert len(got) == len(want)
    for a, b in zip(got, want):
        _same_delta(a, b)


def test_scheduled_and_empty_sources_match_the_jax_ones():
    d = {"rows": np.arange(3), "data": {"X": np.zeros((3, 2))}}
    for mod in (tstream, jstream):
        src = mod.ScheduledSource({2: d, 4: [d, d]})
        assert [src.peek(t) for t in range(6)] == [0, 0, 3, 0, 6, 0]
        assert src.take(2) == [d] and len(src.take(4)) == 2
        assert src.take(3) is None
        assert mod.EmptySource().peek(1) == 0
        assert mod.EmptySource().take(1) is None
    assert isinstance(EmptySource(), tstream.DataSource)


def test_synthetic_lm_source_walks_the_ports_make_batch():
    cfg = SyntheticLMConfig(vocab_size=50, seq_len=8, batch_size=2, seed=3)
    src = SyntheticLMSource(cfg)
    jsrc = jstream.SyntheticLMSource(JLMConfig(vocab_size=50, seq_len=8,
                                               batch_size=2, seed=3))
    it = synthetic_batches(cfg)
    for t in range(9):
        assert src.peek(t) == jsrc.peek(t) == 2
        got, jgot = src.take(t), jsrc.take(t)
        assert len(got) == len(jgot) == 1
        want = make_batch(cfg, t)
        assert set(got[0]["data"]) == set(jgot[0]["data"]) == set(want)
        nxt = next(it)
        for k in want:
            assert tuple(got[0]["data"][k].shape) == \
                tuple(jgot[0]["data"][k].shape)
            assert torch.equal(got[0]["data"][k], want[k])
            assert torch.equal(nxt[k], want[k])


# ---------------------------------------------------------------------------
# The Ingestor: the JAX Ingestor's cursor step by step
# ---------------------------------------------------------------------------

def _row_delta(vals, M):
    """An MF delta whose A rows are the constants ``vals``."""
    k = len(vals)
    return {"data": {
        "A": np.tile(np.asarray(vals, np.float32)[:, None], (1, M)),
        "mask": np.ones((k, M), np.float32)}}


@pytest.mark.parametrize("capacity", [0, 6])
def test_ring_cursor_equals_the_jax_ingestors_step_by_step(capacity):
    """The ring schedule of tests/test_stream.py:211-256 (padding first,
    then the wrap, then a delta larger than the ring): the port's rows,
    cursor, rows_in and rows_dropped equal the JAX Ingestor's ``_slots``
    (bound to a JAX MF engine) at every step, and the written rows hold
    the delta's values."""
    N_, M_, FILL = 8, 6, 5
    r = np.random.default_rng(0)
    A = np.concatenate([r.normal(size=(FILL, M_)).astype(np.float32),
                        np.zeros((N_ - FILL, M_), np.float32)])
    mask = np.concatenate([np.ones((FILL, M_), np.float32),
                           np.zeros((N_ - FILL, M_), np.float32)])
    sched = {0: _row_delta([100, 101], M_),
             1: _row_delta([102, 103, 104], M_),
             2: _row_delta(list(range(200, 210)), M_),
             3: [_row_delta([300], M_), _row_delta([301, 302], M_)]}
    spec_kw = dict(kind="extend", ingest_every=1, capacity=capacity)
    jeng = jmf.make_engine(jmf.MFConfig(num_rows=N_, num_cols=M_, rank=2),
                           single_device_mesh())
    jing = jstream.Ingestor(jstream.StreamSpec(**spec_kw),
                            jstream.ScheduledSource(sched)).bind(
        jeng, jeng.shard_data({"A": jnp.asarray(A),
                               "mask": jnp.asarray(mask)}))
    eng = mf.make_engine(mf.MFConfig(num_rows=N_, num_cols=M_, rank=2),
                         workers=2, device="cpu")
    data = eng.shard_data({"A": A.copy(), "mask": mask.copy()})
    ing = Ingestor(StreamSpec(**spec_kw),
                   ScheduledSource(sched)).bind(eng, data)
    assert (ing.capacity, ing.fill0) == (jing.capacity, jing.fill0)
    assert ing.fill0 == FILL
    want_A = A.copy()
    for t in range(4):
        for d in jstream.ScheduledSource(sched).take(t):
            rows, sliced = jing._slots(d)
            want_A[rows] = sliced["data"]["A"]
        _, data = ing.step(eng, None, data, t)
        assert {k: int(v) for k, v in ing.payload().items()} == \
            {k: int(v) for k, v in jing.payload().items()}
        np.testing.assert_array_equal(data["A"].reshape(N_, M_).numpy(),
                                      want_A)
    payload = ing.payload()
    assert sorted(payload) == ["cursor", "fill0", "rows_dropped",
                               "rows_in"]
    assert all(isinstance(v, np.int64) for v in payload.values())
    ing2 = Ingestor(StreamSpec(**spec_kw), EmptySource()).restore(
        payload).bind(eng, data)
    assert (ing2.cursor, ing2.fill0) == (ing.cursor, FILL)


# ---------------------------------------------------------------------------
# The apps' ingest against the numpy oracles, deltas numpy and tensors
# ---------------------------------------------------------------------------

def _as(delta, tensors: bool):
    if not tensors:
        return delta
    return {k: ({n: torch.as_tensor(v) for n, v in d.items()}
                if isinstance(d, dict) else torch.as_tensor(d))
            for k, d in delta.items()}


@pytest.mark.parametrize("tensors", [False, True])
@pytest.mark.parametrize("workers", [1, 4])
def test_lasso_ingest_keeps_r_equal_to_y_minus_x_beta(lasso_problem,
                                                      workers, tensors):
    X, y = lasso_problem
    eng, data, state = _lasso(X, y, workers)
    state = eng.run(state, data, None, 3)
    beta = state["beta"].numpy().copy()
    r_before = state["r"].reshape(-1).numpy().copy()
    rows = np.array([1, 13, 30, 47])
    g = np.random.default_rng(4)
    Xn = g.normal(size=(4, J)).astype(np.float32)
    yn = g.normal(size=4).astype(np.float32)
    delta = _as({"rows": rows, "data": {"X": Xn, "y": yn}}, tensors)
    r_rows = torch.as_tensor(rows) if tensors else rows
    new_data, new_state = eng.app.ingest(data, state, r_rows, delta)
    assert new_state["r"] is state["r"] and new_data["X"] is data["X"]
    X2, y2 = X.copy(), y.copy()
    X2[rows], y2[rows] = Xn, yn
    np.testing.assert_array_equal(data["X"].reshape(N, J).numpy(), X2)
    np.testing.assert_array_equal(data["y"].reshape(-1).numpy(), y2)
    r = new_state["r"].reshape(-1).numpy()
    np.testing.assert_allclose(r[rows], yn - Xn @ beta, atol=ATOL)
    keep = np.setdiff1d(np.arange(N), rows)
    np.testing.assert_array_equal(r[keep], r_before[keep])
    assert eng.app.ingest(data, None, rows, delta)[1] is None


@pytest.mark.parametrize("tensors", [False, True])
def test_mf_ingest_keeps_r_on_the_rows(mf_problem, tensors):
    A, mask = mf_problem
    eng, data, state = _mf(A, mask, workers=2)
    state = eng.run(state, data, None, 4)
    before = {k: v.clone() for k, v in eng.unshard(state).items()}
    rows = np.array([0, 11, 12, 23])
    d = _mf_src("replace").take(3)[0]
    d["rows"] = rows
    new_data, new_state = eng.app.ingest(data, state,
                                         torch.as_tensor(rows)
                                         if tensors else rows,
                                         _as(d, tensors))
    flat = eng.unshard(new_state)
    W, H = before["W"].numpy(), before["H"].numpy()
    want = (d["data"]["A"] - W[rows] @ H) * d["data"]["mask"]
    np.testing.assert_allclose(flat["R"].numpy()[rows], want, rtol=0,
                               atol=RTOL * max(1.0, np.abs(want).max()))
    keep = np.setdiff1d(np.arange(24), rows)
    np.testing.assert_array_equal(flat["R"].numpy()[keep],
                                  before["R"].numpy()[keep])
    np.testing.assert_array_equal(
        new_data["A"].reshape(24, 10).numpy()[rows], d["data"]["A"])
    np.testing.assert_array_equal(
        new_data["mask"].reshape(24, 10).numpy()[rows], d["data"]["mask"])


def _lda_recount(cfg_kw, words, docs, z):
    """tests/test_stream.py:335-340's recount, over U workers."""
    cfg = jlda.LDAConfig(**cfg_kw)
    U, T, dpw, K = (cfg.num_workers, cfg.tokens_per_worker,
                    cfg.docs_per_worker, cfg.num_topics)
    B = np.zeros((cfg.padded_vocab, K), np.float32)
    D = np.zeros((U * dpw, K), np.float32)
    s = np.zeros((K,), np.float32)
    act = words >= 0
    u = np.arange(U * T) // T
    np.add.at(B, (words[act], z[act]), 1)
    np.add.at(D, (u[act] * dpw + docs[act], z[act]), 1)
    np.add.at(s, z[act], 1)
    return {"B": B, "D": D, "s": s}


@pytest.mark.parametrize("tensors", [False, True])
@pytest.mark.parametrize("kind", ["extend", "replace"])
def test_lda_ingest_keeps_the_counts_equal_to_a_recount(kind, tensors):
    from test_torch_lda import CFG4
    eng, data, state = _lda(CFG4)
    state = eng.run(state, data, None, 4)
    d = _lda_src(kind, tokens=50, cfg_kw=CFG4).take(2)[0]
    rows = (d["rows"] if kind == "replace"
            else (np.arange(50) * 17 + 3) % (4 * 240))
    d["data"]["words"][:3] = -1                 # deletions
    version = data["words"]._version
    eng.app.ingest(data, state, rows, _as(d, tensors))
    assert data["words"]._version > version
    flat = eng.unshard(state)
    words = data["words"].reshape(-1).numpy()
    docs = data["docs"].reshape(-1).numpy()
    np.testing.assert_array_equal(words[rows], d["data"]["words"])
    np.testing.assert_array_equal(flat["z"].numpy()[rows], d["z"])
    want = _lda_recount(CFG4, words, docs, flat["z"].numpy())
    for k in ("B", "D", "s"):
        np.testing.assert_array_equal(flat[k].numpy(), want[k])


@pytest.mark.parametrize("app", ["mf", "lda"])
def test_mf_and_lda_ingest_take_tensor_deltas(app, mf_problem):
    """The slice-11 fault: ``np.asarray`` of the deltas raised on card
    tensors.  Tensor deltas (here on the CPU, rows as a tensor too) give
    the very numbers numpy deltas give."""
    outs = []
    for tensors in (False, True):
        if app == "mf":
            eng, data, state = _mf(*mf_problem)
            d = _mf_src("replace").take(1)[0]
        else:
            eng, data, state = _lda()
            d = _lda_src("replace").take(1)[0]
        rows = torch.as_tensor(d["rows"]) if tensors else d["rows"]
        eng.app.ingest(data, state, rows, _as(d, tensors))
        outs.append((data, state))
    _equal(outs[0][0], outs[1][0])
    _equal(outs[0][1], outs[1][1])


def test_lda_ingest_range_errors_write_nothing():
    eng, data, state = _lda()
    before = {k: v.clone() for k, v in {**data, **state}.items()}
    cfg = eng.app.cfg
    for bad, match in ((dict(words=[cfg.vocab]), "ingested words"),
                       (dict(words=[-2]), "ingested words"),
                       (dict(docs=[cfg.docs_per_worker]), "ingested docs"),
                       (dict(z=[cfg.num_topics]), "ingested z")):
        delta = {"data": {"words": np.array(bad.get("words", [0])),
                          "docs": np.array(bad.get("docs", [0]))},
                 "z": np.array(bad.get("z", [0]))}
        for tensors in (False, True):
            with pytest.raises(ValueError, match=match):
                eng.app.ingest(data, state, np.array([3]), _as(delta,
                                                               tensors))
    _equal({**data, **state}, before)


# ---------------------------------------------------------------------------
# Streamed trajectories against the JAX engine run boundary to boundary
# ---------------------------------------------------------------------------

def _jax_streamed(jeng, st, dt, executor, spec_kw, jsrc, oracle, key=0):
    """The JAX engine from boundary to boundary (``carry=``), the numpy
    ``oracle(st, dt, rows, delta)`` of the ingest between the spans; the
    rows (and the tail of an oversize extend delta) from the JAX
    Ingestor's ``_slots``.  Returns (per-round states, final numpy state,
    final data, the JAX Ingestor)."""
    st = {k: np.array(v) for k, v in st.items()}
    dt = {k: np.array(v) for k, v in dt.items()}
    spec = jstream.StreamSpec(**spec_kw)
    jing = jstream.Ingestor(spec, jsrc).bind(jeng, dt)
    carry, traces = None, []
    for t in range(0, R, EVERY):
        for d in (jsrc.take(t) or []) if t % spec.ingest_every == 0 else []:
            rows, d = jing._slots(d)
            oracle(st, dt, rows, d)
        rep = jeng.execute(jeng.place_state(st), jeng.shard_data(dt),
                           jax.random.key(key), _jplan(executor, t + EVERY),
                           carry=carry, collect=lambda s: s)
        carry = rep.carry
        st = {k: np.array(v) for k, v in rep.state.items()}
        traces.append({k: np.asarray(v) for k, v in rep.trace.items()})
    trace = {k: np.concatenate([tr[k] for tr in traces]) for k in traces[0]}
    return trace, st, dt, jing


def _lasso_oracle(st, dt, rows, d):
    Xn, yn = d["data"]["X"], d["data"]["y"]
    dt["X"][rows], dt["y"][rows] = Xn, yn
    st["r"][rows] = yn - Xn @ st["beta"]


_JAX_RUNS: dict = {}


def _jax_lasso_stream(X, y, executor):
    if executor not in _JAX_RUNS:
        jeng = jlasso.make_engine(jlasso.LassoConfig(**LASSO),
                                  single_device_mesh())
        jst = jeng.init_state(jax.random.key(0), y=y)
        _JAX_RUNS[executor] = _jax_streamed(
            jeng, jst, {"X": X, "y": y}, executor,
            dict(kind="replace", ingest_every=EVERY),
            _lasso_src(cls=jstream.LassoDriftSource), _lasso_oracle)
    return _JAX_RUNS[executor]


@pytest.mark.parametrize("executor", EXECUTORS)
@pytest.mark.parametrize("workers", [1, 4])
def test_streamed_lasso_matches_jax_every_round(lasso_problem, executor,
                                                workers):
    X, y = lasso_problem
    jtrace, jst, jdt, _ = _jax_lasso_stream(X, y, executor)
    draws = jax_draws(R + 1, J)
    eng, data, state = _lasso(X, y, workers)
    rep = eng.execute(state, data, None,
                      _plan(executor, R,
                            kernels=KernelSpec.default_for("pallas")),
                      collect=lambda s: s, noise=lambda t: draws[t],
                      stream=StreamSpec(kind="replace", ingest_every=EVERY),
                      source=_lasso_src())
    np.testing.assert_allclose(rep.trace["beta"].numpy(), jtrace["beta"],
                               atol=ATOL)
    np.testing.assert_allclose(rep.trace["r"].reshape(R, -1).numpy(),
                               jtrace["r"], atol=ATOL)
    np.testing.assert_array_equal(data["X"].reshape(N, J).numpy(), jdt["X"])
    np.testing.assert_array_equal(data["y"].reshape(-1).numpy(), jdt["y"])
    assert {k: int(v) for k, v in rep.stream.items()} == dict(
        cursor=0, rows_in=8 * 3, rows_dropped=0, fill0=0)   # t = 2, 4, 6
    # the deltas moved the trajectory
    eng2, data2, state2 = _lasso(X, y, workers)
    plain = eng2.execute(state2, data2, None, _plan(executor, R),
                         noise=lambda t: draws[t])
    assert not torch.equal(plain.state["beta"], rep.state["beta"])


def _mf_oracle(st, dt, rows, d):
    An, mn = d["data"]["A"], d["data"]["mask"]
    dt["A"][rows], dt["mask"][rows] = An, mn
    st["R"][rows] = (An - st["W"][rows] @ st["H"]) * mn


@pytest.mark.parametrize("executor", EXECUTORS)
@pytest.mark.parametrize("kind", ["extend", "replace"])
def test_streamed_mf_matches_jax(mf_problem, executor, kind):
    A, mask = mf_problem
    jeng = jmf.make_engine(jmf.MFConfig(**MF_SIZE), single_device_mesh())
    jst = {k: np.asarray(v) for k, v in jeng.init_state(
        jax.random.key(0), A=jnp.asarray(A), mask=jnp.asarray(mask)).items()}
    spec_kw = dict(kind=kind, ingest_every=EVERY,
                   **({"capacity": 20} if kind == "extend" else {}))
    jtrace, jfin, jdt, jing = _jax_streamed(
        jeng, jst, {"A": A, "mask": mask}, executor, spec_kw,
        _mf_src(kind, rows=6, cls=jstream.MFDriftSource), _mf_oracle)
    eng = mf.make_engine(mf.MFConfig(**MF_SIZE), workers=2, device="cpu")
    state, data, _ = convert.mf_from_jax(jst, A, mask, device="cpu")
    rep = eng.execute(state, data, None, _plan(executor, R),
                      collect=lambda s: s, stream=StreamSpec(**spec_kw),
                      source=_mf_src(kind, rows=6))
    for k in ("W", "H", "R"):
        want = jtrace[k]
        got = rep.trace[k].reshape(want.shape).numpy()
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=RTOL * max(1.0, np.abs(want).max()))
    np.testing.assert_array_equal(data["A"].reshape(24, 10).numpy(),
                                  jdt["A"])
    assert {k: int(v) for k, v in rep.stream.items()} == \
        {k: int(v) for k, v in jing.payload().items()}


def _lda_oracle(cfg_kw):
    def oracle(st, dt, rows, d):
        dt["words"][rows] = d["data"]["words"]
        dt["docs"][rows] = d["data"]["docs"]
        st["z"][rows] = d["z"]
        st.update(_lda_recount(cfg_kw, dt["words"], dt["docs"], st["z"]))
    return oracle


@pytest.mark.parametrize("executor", EXECUTORS)
@pytest.mark.parametrize("kind", ["extend", "replace"])
def test_streamed_lda_counts_match_jax_to_the_bit(executor, kind):
    words, docs, z0 = _corpus(CFG1)
    words[-100:] = -1                         # padding for the ring
    jeng = jlda.make_engine(jlda.LDAConfig(**CFG1), single_device_mesh())
    jst = jeng.init_state(jax.random.key(0), words=words, docs=docs, z0=z0)
    spec_kw = dict(kind=kind, ingest_every=EVERY)
    # the rotation is LDA's whole schedule and reads no state, so the
    # pipelined run is held against the JAX scan: a JAX pipelined LDA
    # carry holds no in-flight schedule and cannot resume span by span
    _, jfin, jdt, jing = _jax_streamed(
        jeng, jst, {"words": words, "docs": docs},
        "scan" if executor == "pipelined" else executor, spec_kw,
        _lda_src(kind, cls=jstream.LDADriftSource), _lda_oracle(CFG1))
    eng = lda.make_engine(lda.LDAConfig(**CFG1), device="cpu",
                          noise=jax_noise(CFG1))
    data = eng.shard_data({"words": words.copy(), "docs": docs.copy()})
    state = eng.init_state(words=words, docs=docs, z0=z0)
    rep = eng.execute(state, data, None, _plan(executor, R),
                      stream=StreamSpec(**spec_kw), source=_lda_src(kind))
    flat = eng.unshard(rep.state)
    for k in ("z", "D", "B", "s"):
        np.testing.assert_array_equal(flat[k].numpy(), jfin[k], err_msg=k)
    np.testing.assert_array_equal(data["words"].reshape(-1).numpy(),
                                  jdt["words"])
    assert {k: int(v) for k, v in rep.stream.items()} == \
        {k: int(v) for k, v in jing.payload().items()}
    # and the counts are the recount of what the engine holds
    want = _lda_recount(CFG1, data["words"].reshape(-1).numpy(),
                        data["docs"].reshape(-1).numpy(), flat["z"].numpy())
    for k in ("B", "D", "s"):
        np.testing.assert_array_equal(flat[k].numpy(), want[k])


# ---------------------------------------------------------------------------
# Port against port: empty source, loop ≡ scan, batching, resume, serving
# ---------------------------------------------------------------------------

def _app_run(app, executor, problem, spec, source, **kw):
    if app == "lasso":
        eng, data, state = _lasso(*problem[0], workers=2)
    elif app == "mf":
        eng, data, state = _mf(*problem[1])
    else:
        eng, data, state = _lda()
    rep = eng.execute(state, data, torch.Generator().manual_seed(1),
                      _plan(executor, R), stream=spec, source=source, **kw)
    return eng, data, rep


@pytest.mark.parametrize("executor", EXECUTORS)
@pytest.mark.parametrize("app", ["lasso", "mf", "lda"])
def test_empty_source_equals_unstreamed_to_the_bit(app, executor,
                                                   lasso_problem,
                                                   mf_problem):
    problems = (lasso_problem, mf_problem)
    kind = "replace" if app == "lasso" else "extend"
    _, _, ref = _app_run(app, executor, problems, None, None)
    _, _, rep = _app_run(app, executor, problems,
                         StreamSpec(kind=kind, ingest_every=4),
                         EmptySource())
    _equal(ref.state, rep.state)
    assert ref.stream is None
    assert int(rep.stream["rows_in"]) == 0


def test_empty_and_off_cadence_boundaries_return_the_same_objects(
        lasso_problem):
    eng, data, state = _lasso(*lasso_problem)
    ing = Ingestor(StreamSpec(kind="replace", ingest_every=2),
                   _lasso_src()).bind(eng, data)
    for t in (0, 1):                    # nothing due at 0; 1 off cadence
        s, d = ing.step(eng, state, data, t)
        assert s is state and d is data
    s, d = ing.step(eng, state, data, 2)
    assert all(s[k] is state[k] for k in state)                # in place
    assert all(d[k] is data[k] for k in data)


@pytest.mark.parametrize("app", ["lasso", "mf", "lda"])
def test_streamed_loop_equals_streamed_scan_to_the_bit(app, lasso_problem,
                                                       mf_problem):
    problems = (lasso_problem, mf_problem)
    if app == "lasso":
        spec, src = StreamSpec(kind="replace", ingest_every=2), _lasso_src
    elif app == "mf":
        spec, src = StreamSpec(kind="extend", ingest_every=2), _mf_src
    else:
        spec, src = StreamSpec(kind="extend", ingest_every=2), _lda_src
    runs = [_app_run(app, ex, problems, spec, src())
            for ex in ("loop", "scan")]
    _equal(runs[0][2].state, runs[1][2].state)
    _equal(runs[0][1], runs[1][1])
    assert runs[0][2].stream == runs[1][2].stream


@pytest.mark.parametrize("split", [1, 3, 5])
def test_splitting_a_replace_delta_changes_nothing(lasso_problem, split):
    X, y = lasso_problem
    g = np.random.default_rng(split)
    rows = np.sort(g.choice(N, size=6, replace=False))
    Xd = g.normal(size=(6, J)).astype(np.float32)
    yd = g.normal(size=6).astype(np.float32)
    whole = {"rows": rows, "data": {"X": Xd, "y": yd}}
    parts = [{"rows": rows[:split], "data": {"X": Xd[:split],
                                             "y": yd[:split]}},
             {"rows": rows[split:], "data": {"X": Xd[split:],
                                             "y": yd[split:]}}]
    spec = StreamSpec(kind="replace", ingest_every=2)
    out = []
    for src in (ScheduledSource({2: whole}), ScheduledSource({2: parts})):
        eng, data, state = _lasso(X, y)
        out.append(eng.execute(state, data, torch.Generator().manual_seed(1),
                               _plan("scan", 4), stream=spec, source=src))
    for k in ("beta", "r"):
        np.testing.assert_allclose(out[0].state[k].numpy(),
                                   out[1].state[k].numpy(), rtol=1e-5,
                                   atol=1e-5)
    assert out[0].stream == out[1].stream


def test_splitting_an_extend_delta_lands_on_the_same_slots(mf_problem):
    d = _row_delta([300, 301, 302, 303], 10)
    halves = [{"data": {k: v[:2] for k, v in d["data"].items()}},
              {"data": {k: v[2:] for k, v in d["data"].items()}}]
    spec = StreamSpec(kind="extend", ingest_every=2)
    out = []
    for src in (ScheduledSource({2: d}), ScheduledSource({2: halves})):
        eng, data, state = _mf(*mf_problem)
        out.append((data, eng.execute(state, data, None, _plan("scan", 4),
                                      stream=spec, source=src)))
    _equal(out[0][0], out[1][0])
    for k in ("W", "H", "R"):
        np.testing.assert_allclose(out[0][1].state[k].numpy(),
                                   out[1][1].state[k].numpy(), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("executor", ["scan", "pipelined", "ssp"])
def test_chunked_streamed_run_resumes_to_the_bit(lasso_problem, tmp_path,
                                                 executor):
    """Checkpoints every 4 rounds, ingests every 2 (spans of 2): a fresh
    engine resumed from step 4 with ``stream_state`` and the data rebuilt
    by ``replay_data`` from the original data equals the uninterrupted
    run to the bit."""
    X, y = lasso_problem
    spec = StreamSpec(kind="replace", ingest_every=2)
    plan = _plan(executor, R, checkpoint_every=4)
    gen = torch.Generator().manual_seed(1)
    eng, data, state = _lasso(X, y, workers=2)
    full = eng.execute(state, data, gen, plan, ckpt_dir=str(tmp_path),
                       source=_lasso_src(), stream=spec)
    flat = load_flat(str(tmp_path), 4)
    assert {k for k in flat if k.startswith("stream/")} == {
        "stream/cursor", "stream/rows_in", "stream/rows_dropped",
        "stream/fill0"}
    assert int(flat["stream/rows_in"]) == 8          # t = 2 (0 has none)
    eng2, data2, state2 = _lasso(X, y, workers=2)
    tmpl = {"state": state2, "carry": full.carry, "stream": full.stream}
    ck = restore_checkpoint(str(tmp_path), 4, tmpl)
    data2, ing = replay_data(eng2, data2, spec, _lasso_src(), 4,
                             stream_state=ck["stream"])
    rest = eng2.execute(ck["state"], data2, torch.Generator(), plan,
                        carry=ck["carry"], ckpt_dir=str(tmp_path / "b"),
                        stream=spec, source=_lasso_src(),
                        stream_state=ck["stream"])
    _equal(full.state, rest.state)
    _equal(data, data2)
    assert rest.stream == full.stream
    with pytest.raises(ValueError, match="rows_in"):
        replay_data(eng2, _lasso(X, y, 2)[1], spec, _lasso_src(), 4,
                    stream_state=dict(ck["stream"], rows_in=np.int64(99)))


def test_jax_empty_source_checkpoint_resumes_in_the_port(lasso_problem,
                                                         tmp_path):
    X, y = lasso_problem
    jeng = jlasso.make_engine(jlasso.LassoConfig(**LASSO),
                              single_device_mesh())
    jdata = jeng.shard_data({"X": jnp.asarray(X), "y": jnp.asarray(y)})
    jspec = jstream.StreamSpec(kind="replace", ingest_every=2)
    jrep = jeng.execute(jeng.init_state(jax.random.key(0), y=y), jdata,
                        jax.random.key(0),
                        JPlan(executor="scan", rounds=R, donate=False,
                              checkpoint_every=4),
                        ckpt_dir=str(tmp_path), stream=jspec,
                        source=jstream.EmptySource())
    flat = jload_flat(str(tmp_path), 4)
    sstate = convert.stream_state_from_jax(flat)
    assert {k: int(v) for k, v in sstate.items()} == {
        k: int(v) for k, v in jrep.stream.items()}
    assert convert.stream_state_from_jax({"state/beta": 0}) is None
    draws = jax_draws(R, J)
    eng = lasso.make_engine(lasso.LassoConfig(**LASSO), device="cpu")
    state, carry, part = convert.checkpoint_from_jax(flat, eng)
    rep = eng.execute(state, eng.shard_data({"X": X.copy(),
                                             "y": y.copy()}), None,
                      ExecutionPlan(executor="scan", rounds=R,
                                    checkpoint_every=4),
                      carry=carry, partition=part,
                      ckpt_dir=str(tmp_path / "port"),
                      noise=lambda t: draws[t],
                      stream=StreamSpec(kind="replace", ingest_every=2),
                      source=EmptySource(), stream_state=sstate)
    np.testing.assert_allclose(rep.state["beta"].numpy(),
                               np.asarray(jrep.state["beta"]), atol=ATOL)
    np.testing.assert_allclose(rep.state["r"].reshape(-1).numpy(),
                               np.asarray(jrep.state["r"]), atol=ATOL)
    back = load_flat(str(tmp_path / "port"), R)
    for k in ("cursor", "rows_in", "rows_dropped", "fill0"):
        assert int(back[f"stream/{k}"]) == int(flat[f"stream/{k}"])


@pytest.mark.parametrize("executor", ["ssp", "scan"])
def test_served_streamed_run_equals_streamed_execute(lasso_problem,
                                                     executor):
    X, y = lasso_problem
    spec = StreamSpec(kind="replace", ingest_every=2)
    eng, data, state = _lasso(X, y, workers=2)
    ref = eng.execute(state, data, torch.Generator().manual_seed(1),
                      _plan(executor, R), stream=spec, source=_lasso_src())
    eng2, data2, state2 = _lasso(X, y, workers=2)
    srep = serve_while_training(
        eng2, state2, data2, torch.Generator().manual_seed(1),
        _plan(executor, R), stream=spec, source=_lasso_src(),
        requests=[(t, {"x": X[t]}) for t in (0, 2, 4, 8)])
    _equal(srep.report.state, ref.state)
    _equal(data2, data)
    assert srep.ingest == ref.stream == srep.report.stream
    assert len(srep.responses) == 4


def test_served_streamed_lda_and_mf_equal_streamed_execute(mf_problem):
    for app in ("mf", "lda"):
        runs = []
        for served in (False, True):
            if app == "mf":
                eng, data, state = _mf(*mf_problem)
                src = _mf_src()
                reqs = [(t, {"user": np.int32(t)}) for t in (0, 4)]
            else:
                eng, data, state = _lda()
                src = _lda_src()
                reqs = [(t, {"words": np.arange(8, dtype=np.int32)})
                        for t in (0, 4)]
            spec = StreamSpec(kind="extend", ingest_every=2)
            plan = _plan("ssp", R)
            if served:
                out = serve_while_training(eng, state, data, None, plan,
                                           stream=spec, source=src,
                                           requests=reqs).report
            else:
                out = eng.execute(state, data, None, plan, stream=spec,
                                  source=src)
            runs.append(out)
        _equal(runs[0].state, runs[1].state)
        assert runs[0].stream == runs[1].stream


# ---------------------------------------------------------------------------
# Errors: the pair rule, the alignment rules, binding, delta rows
# ---------------------------------------------------------------------------

def _jax_error(fn):
    with pytest.raises(Exception) as e:
        fn()
    return str(e.value)


def test_pair_and_stream_state_rules_match_the_jax_engine(lasso_problem):
    X, y = lasso_problem
    eng, data, state = _lasso(X, y)
    jeng = jlasso.make_engine(jlasso.LassoConfig(**LASSO),
                              single_device_mesh())
    jdata = jeng.shard_data({"X": jnp.asarray(X), "y": jnp.asarray(y)})
    jst = jeng.init_state(jax.random.key(0), y=y)
    plan = _plan("scan", 4)
    for kw, jkw in (({"stream": StreamSpec(kind="replace")},
                     {"stream": jstream.StreamSpec(kind="replace")}),
                    ({"source": EmptySource()},
                     {"source": jstream.EmptySource()}),
                    ({"stream_state": {"cursor": 0}},
                     {"stream_state": {"cursor": 0}})):
        want = _jax_error(lambda: jeng.execute(
            jst, jdata, jax.random.key(1), _jplan("scan", 4), **jkw))
        with pytest.raises(ValueError) as got:
            eng.execute(state, data, None, plan, **kw)
        assert str(got.value) == want
    with pytest.raises(ValueError, match="missing"):
        eng.execute(state, data, None, plan,
                    stream=StreamSpec(kind="replace"), source=EmptySource(),
                    stream_state={"cursor": 0})


@pytest.mark.parametrize("app", ["lasso", "mf"])
def test_misaligned_ingest_cadence_is_refused_as_jax_refuses_it(
        app, lasso_problem, mf_problem):
    # ssp at s = 1: Lasso's step is 2 rounds; MF's scan step is its H/W
    # period, 2 rounds
    if app == "lasso":
        X, y = lasso_problem
        eng, data, state = _lasso(X, y)
        jeng = jlasso.make_engine(jlasso.LassoConfig(**LASSO),
                                  single_device_mesh())
        jdata = jeng.shard_data({"X": jnp.asarray(X), "y": jnp.asarray(y)})
        jst = jeng.init_state(jax.random.key(0), y=y)
        ex, kind = "ssp", "replace"
    else:
        A, mask = mf_problem
        eng, data, state = _mf(A, mask)
        jeng = jmf.make_engine(jmf.MFConfig(**MF_SIZE), single_device_mesh())
        jdata = jeng.shard_data({"A": jnp.asarray(A),
                                 "mask": jnp.asarray(mask)})
        jst = jeng.init_state(jax.random.key(0), A=jnp.asarray(A),
                              mask=jnp.asarray(mask))
        ex, kind = "scan", "extend"
    want = _jax_error(lambda: jeng.execute(
        jst, jdata, jax.random.key(1), _jplan(ex, 8),
        stream=jstream.StreamSpec(kind=kind, ingest_every=3),
        source=jstream.EmptySource()))
    with pytest.raises(ValueError) as got:
        eng.execute(state, data, None, _plan(ex, 8),
                    stream=StreamSpec(kind=kind, ingest_every=3),
                    source=EmptySource())
    assert str(got.value) == want
    assert "ingest_every=3 must be a multiple" in want


def test_serve_loop_refuses_what_the_jax_loop_refuses(lasso_problem):
    X, y = lasso_problem
    eng, data, state = _lasso(X, y)
    plan = _plan("ssp", 8)                          # chunk = window = 2
    with pytest.raises(ValueError, match="multiple of the serve chunk"):
        serve_while_training(eng, state, data, None, plan,
                             stream=StreamSpec(kind="replace",
                                               ingest_every=3),
                             source=EmptySource())
    with pytest.raises(ValueError, match="come as a pair"):
        serve_while_training(eng, state, data, None, plan,
                             source=EmptySource())
    with pytest.raises(ValueError, match="stream_state"):
        serve_while_training(eng, state, data, None, plan,
                             stream_state={"cursor": 0})


def test_ingestor_type_bind_and_row_errors(lasso_problem, mf_problem):
    with pytest.raises(TypeError, match="StreamSpec"):
        Ingestor({"kind": "replace"}, EmptySource())
    with pytest.raises(TypeError, match="DataSource"):
        Ingestor(StreamSpec(kind="replace"), object())
    ing = Ingestor(StreamSpec(kind="replace"), EmptySource())
    with pytest.raises(RuntimeError, match="bind"):
        ing.step(None, None, {}, 0)
    with pytest.raises(ValueError, match="missing"):
        ing.restore({"cursor": 0})

    class NoIngest(StradsAppBase):
        pass

    class FakeEngine:
        app = NoIngest()
    with pytest.raises(NotImplementedError, match="ingest"):
        Ingestor(StreamSpec(kind="replace"),
                 EmptySource()).bind(FakeEngine(), {})
    eng, data, state = _lasso(*lasso_problem)
    with pytest.raises(ValueError, match="supports stream kinds"):
        Ingestor(StreamSpec(kind="extend"), EmptySource()).bind(eng, data)
    meng, mdata, _ = _mf(*mf_problem)
    with pytest.raises(ValueError, match="exceeds"):
        Ingestor(StreamSpec(kind="extend", capacity=999),
                 EmptySource()).bind(meng, mdata)
    spec = StreamSpec(kind="replace", ingest_every=1)
    for rows, match in (([3, 3], "unique"), ([N], "out of range"),
                        ([-1], "out of range")):
        k = len(rows)
        d = {"rows": np.asarray(rows),
             "data": {"X": np.zeros((k, J), np.float32),
                      "y": np.zeros(k, np.float32)}}
        for r_ in (d["rows"], torch.as_tensor(d["rows"])):
            ing = Ingestor(spec, ScheduledSource({0: dict(d, rows=r_)}))
            with pytest.raises(ValueError, match=match):
                ing.bind(eng, data).step(eng, None, data, 0)


# ---------------------------------------------------------------------------
# Observability: the ingest span and instants with the JAX names
# ---------------------------------------------------------------------------

def test_ingest_events_ride_the_recorder(lasso_problem):
    eng, data, state = _lasso(*lasso_problem)
    plan = ExecutionPlan(executor="scan", rounds=4,
                         telemetry=TelemetrySpec(kind="trace"))
    rep = eng.execute(state, data, None, plan,
                      stream=StreamSpec(kind="replace", ingest_every=2),
                      source=ScheduledSource({
                          2: [_lasso_src().take(2)[0],
                              _lasso_src(seed=4, rows=3).take(2)[0]]}))
    ev = rep.telemetry.events
    spans = [e for e in ev if e["name"] == "ingest"]
    rows = [e for e in ev if e["name"] == "ingest_rows"]
    assert len(spans) == 1 and spans[0]["args"] == {"t": 2, "deltas": 2}
    assert [e["args"] for e in rows] == [
        {"t": 2, "rows_in": 8, "rows_dropped": 0},
        {"t": 2, "rows_in": 3, "rows_dropped": 0}]
    # the uninstrumented run is the same run
    eng2, data2, state2 = _lasso(*lasso_problem)
    ref = eng2.execute(state2, data2, None, _plan("scan", 4),
                       stream=StreamSpec(kind="replace", ingest_every=2),
                       source=ScheduledSource({
                           2: [_lasso_src().take(2)[0],
                               _lasso_src(seed=4, rows=3).take(2)[0]]}))
    _equal(ref.state, rep.state)


# ---------------------------------------------------------------------------
# The CLI
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("engine", ["lasso", "mf", "lda"])
def test_serve_cli_streams_on_the_cpu(engine, tmp_path, capsys):
    out = str(tmp_path / "s.json")
    srep = tserve.main(["--engine", engine, "--stream", "--requests", "8",
                        "--device", "cpu", "--ingest-every", "3",
                        "--out", out])
    text = capsys.readouterr().out
    assert "[align] ingest-every 3 -> 4" in text
    assert int(srep.ingest["rows_in"]) > 0
    assert f"rows ingested={int(srep.ingest['rows_in'])}" in text
    with open(out) as f:
        art = json.load(f)
    assert art["stream_spec"]["ingest_every"] == 4
    assert art["stream_spec"]["kind"] == ("replace" if engine == "lasso"
                                          else "extend")
    assert art["ingest"]["rows_in"] == int(srep.ingest["rows_in"])
    srep = tserve.main(["--engine", engine, "--stream", "--requests", "4",
                        "--device", "cpu", "--serve-only"])
    assert srep.report is None and int(srep.ingest["rows_in"]) > 0


@pytest.mark.parametrize("executor", EXECUTORS)
def test_a_streamed_run_holds_no_more_state_than_an_unstreamed_one(
        mf_problem, executor):
    """Each pull finds as many earlier R tensors alive with the stream as
    without: a span does not keep its start state alive past its first
    round (MF's R is 9.3 GB at the chip shape)."""
    import weakref
    counts = []
    for stream in (False, True):
        eng, data, state = _mf(*mf_problem)
        refs, alive = [weakref.ref(state["R"])], []
        pull = eng.app.pull

        def counted(st, *a, **kw):
            alive.append(sum(r() is not None for r in refs))
            out = pull(st, *a, **kw)
            refs.append(weakref.ref(out["R"]))
            return out
        eng.app.pull = counted
        kw = (dict(stream=StreamSpec(kind="replace", ingest_every=4),
                   source=_mf_src("replace")) if stream else {})
        eng.execute(state, data, None, _plan(executor, R), **kw)
        counts.append(alive)
    assert counts[0] == counts[1]


def test_a_served_run_holds_no_more_state_than_an_unserved_one(mf_problem):
    """The serve loop hands each chunk its start state: each pull finds
    as many earlier R tensors alive as in an unserved ssp run (plus the
    caller's start state, which the loop cannot drop)."""
    import weakref
    counts = []
    for served in (False, True):
        eng, data, state = _mf(*mf_problem)
        refs, alive = [], []
        pull = eng.app.pull

        def counted(st, *a, **kw):
            alive.append(sum(r() is not None for r in refs))
            out = pull(st, *a, **kw)
            refs.append(weakref.ref(out["R"]))
            return out
        eng.app.pull = counted
        plan = _plan("ssp", R)
        if served:
            serve_while_training(eng, state, data, None, plan,
                                 stream=StreamSpec(kind="replace",
                                                   ingest_every=4),
                                 source=_mf_src("replace"),
                                 requests=[(4, {"user": np.int32(3)})])
        else:
            eng.execute(state, data, None, plan,
                        stream=StreamSpec(kind="replace", ingest_every=4),
                        source=_mf_src("replace"))
        counts.append(alive)
    assert counts[0] == counts[1]
