"""The port's partitioning subsystem and model store against the JAX
package's (``tests/test_part.py``, ``tests/test_kvstore.py``).

Partitioners are host numpy in both packages, so the same numpy inputs
must give the same Assignments, stats and decisions exactly (tolerance
0).  Byte accounting is integer and must be equal.  Engine wiring runs
on the CPU at the sizes of ``tests/test_torch_lasso.py``; error texts
are compared with the JAX package's own where both packages have the
rule.
"""
import dataclasses
import re
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro import part as jpart
from repro.apps import lasso as jlasso
from repro.apps import mf as jmf
from repro.core import ExecutionPlan as JPlan
from repro.core import single_device_mesh
from repro.core.kvstore import VarSpec as JVarSpec
from repro_torch.apps import lasso, lda, mf
from repro_torch.core import ExecutionPlan, StradsAppBase, StradsEngine
from repro_torch.core.kvstore import (DATA_AXIS, VarSpec, is_replicated,
                                      specs_from_tree, store_from_tree)
from repro_torch.part import (Assignment, PartitionerSpec,
                              build_partitioner, contiguous_assignment,
                              greedy_balance)

J = 20


def _weights(seed: int, n: int) -> np.ndarray:
    """Activity-like weights with ties: a few values repeated."""
    r = np.random.default_rng(seed)
    return np.round(r.exponential(size=n), 1)


# ---------------------------------------------------------------------------
# The same Assignments as the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("workers", [1, 2, 3, 4])
@pytest.mark.parametrize("seed", [0, 1])
def test_greedy_balance_equals_jax(workers, seed):
    w = _weights(seed, 37)
    got = greedy_balance(w, workers, version=2)
    want = jpart.greedy_balance(w, workers, version=2)
    assert got.to_json() == want.to_json()
    assert got.counts().max() - got.counts().min() <= 1


@pytest.mark.parametrize("J_, U", [(10, 4), (16, 4), (7, 3), (5, 8),
                                   (50000, 4), (102784, 128), (1000003, 7)])
def test_contiguous_assignment_is_the_rotation_bounds(J_, U):
    """The static assignment and the port's rotation scheduler share one
    variable→worker map, at vocabulary scale too.  The JAX package's
    map equals it except at (1,000,003, 7): there its ``jnp.linspace``
    runs through XLA's compiled f32 division, which is not correctly
    rounded on the CPU, and one edge lands one variable over
    (ROADMAP.md queue 3)."""
    got = contiguous_assignment(J_, U)
    from repro_torch.sched import RotationScheduler
    bounds = RotationScheduler(J_, U).bounds.numpy()
    expect = np.searchsorted(bounds[1:], np.arange(J_), side="right")
    assert got.owner == tuple(int(o) for o in expect)
    if J_ != 1000003:
        assert got.owner == jpart.contiguous_assignment(J_, U).owner


def test_load_balanced_trajectory_equals_jax():
    """measure / should_rebalance / propose_assignment over a sequence of
    activity vectors: the same EMA bits, decisions and proposals."""
    kw = dict(kind="load_balanced", rebalance_every=4, ema=0.5,
              imbalance_threshold=0.1)
    ours = build_partitioner(PartitionerSpec(**kw), num_vars=J,
                             num_workers=4)
    theirs = jpart.build_partitioner(jpart.PartitionerSpec(**kw),
                                     num_vars=J, num_workers=4)
    a, ja = ours.init_assignment(), theirs.init_assignment()
    s, js = ours.init_stats(), theirs.init_stats()
    assert a.to_json() == ja.to_json()
    r = np.random.default_rng(3)
    moved = 0
    for t in range(4, 44, 4):
        act = np.abs(r.normal(size=J)) * np.linspace(4.0, 0.1, J)
        s, js = ours.measure(s, a, act), theirs.measure(js, ja, act)
        np.testing.assert_array_equal(s["ema"], js["ema"])
        go = ours.should_rebalance(s, a, t)
        assert go == theirs.should_rebalance(js, ja, t)
        assert ours.should_rebalance(s, a, t + 2) is False
        if go:
            a, ja = (ours.propose_assignment(s, a),
                     theirs.propose_assignment(js, ja))
            assert a.to_json() == ja.to_json()
            moved += 1
    assert moved and a.version == moved
    assert ours.measure(s, a, None) is s


def test_size_balanced_and_static_equal_jax():
    sizes = [100.0, 1.0, 1.0, 98.0, 3.0, 3.0, 50.0]
    for kind, kw in (("size_balanced", dict(sizes=sizes)),
                     ("size_balanced", {}), ("static", {})):
        ours = build_partitioner(PartitionerSpec(kind=kind), num_vars=7,
                                 num_workers=3, **kw)
        theirs = jpart.build_partitioner(jpart.PartitionerSpec(kind=kind),
                                         num_vars=7, num_workers=3, **kw)
        a = ours.init_assignment()
        assert a.to_json() == theirs.init_assignment().to_json()
        assert ours.init_stats() is None
        assert not ours.should_rebalance(None, a, 0)
        assert ours.propose_assignment(None, a) is a


def test_assignment_accounting_and_round_trips_equal_jax():
    a = Assignment(owner=(1, 0, 2, 1), num_workers=3, version=5)
    ja = jpart.Assignment(owner=(1, 0, 2, 1), num_workers=3, version=5)
    w = [1.0, 2.0, 3.0, 4.5]
    np.testing.assert_array_equal(a.counts(), ja.counts())
    np.testing.assert_array_equal(a.loads(w), ja.loads(w))
    assert a.spread(w) == ja.spread(w)
    assert a.spread([0.0] * 4) == 0.0
    assert a.to_json() == ja.to_json()
    assert Assignment.from_json(a.to_json()) == a
    assert Assignment.from_json(ja.to_json()) == a
    # payload: the JAX package's keys and dtypes, read both ways
    p, jp = a.payload(), ja.payload()
    assert set(p) == set(jp)
    for k in p:
        assert np.asarray(p[k]).dtype == np.asarray(jp[k]).dtype
        np.testing.assert_array_equal(p[k], jp[k])
    assert Assignment.from_payload(jp) == a
    assert jpart.Assignment.from_payload(p) == ja
    assert Assignment.from_payload(None) is None
    assert hash(a) == hash(Assignment(owner=[1, 0, 2, 1], num_workers=3,
                                      version=5))
    assert a != dataclasses.replace(a, version=0)


def test_assignment_and_builder_reject_what_jax_rejects():
    cases = [
        (lambda m: m.Assignment(owner=(0, 2), num_workers=2), ValueError),
        (lambda m: m.Assignment(owner=(0,), num_workers=0), ValueError),
        (lambda m: m.Assignment(owner=(0,), num_workers=1, version=-1),
         ValueError),
        (lambda m: m.Assignment(owner=(0, 0), num_workers=1).loads([1.0]),
         ValueError),
        (lambda m: m.Assignment.from_json({"owner": [0], "num_workers": 1,
                                           "x": 1}), ValueError),
        (lambda m: m.build_partitioner({"kind": "static"}, num_vars=4,
                                       num_workers=2), TypeError),
        (lambda m: m.build_partitioner(m.PartitionerSpec(kind="static"),
                                       num_vars=0, num_workers=2),
         ValueError),
        (lambda m: m.build_partitioner(
            m.PartitionerSpec(kind="size_balanced"), num_vars=3,
            num_workers=2, sizes=[1.0]).init_assignment(), ValueError),
        (lambda m: m.build_partitioner(
            m.PartitionerSpec(kind="load_balanced", ema=0.5), num_vars=3,
            num_workers=2).measure({"ema": np.zeros(3)}, None,
                                   np.zeros(2)), ValueError),
        (lambda m: m.greedy_balance(np.ones(3), 0), ValueError),
    ]
    import repro_torch.part as tpart
    for make, exc in cases:
        with pytest.raises(exc) as want:
            make(jpart)
        with pytest.raises(exc, match=re.escape(str(want.value))):
            make(tpart)


# ---------------------------------------------------------------------------
# KVStore byte accounting
# ---------------------------------------------------------------------------

def _lasso_state(n=48, J_=12):
    X, y, _ = jlasso.synthetic_correlated(np.random.default_rng(0), n=n,
                                          J=J_, k_true=3)
    return X, y, lasso.LassoConfig(num_features=J_, lam=0.02, block_size=4,
                                   num_candidates=8, rho=0.3)


def _mf_problem():
    A, mask = jmf.synthetic_ratings(np.random.default_rng(0), 24, 10,
                                    true_rank=3, density=0.5)
    return A, mask, mf.MFConfig(num_rows=24, num_cols=10, rank=4)


@pytest.mark.parametrize("workers", [1, 2, 4])
@pytest.mark.parametrize("app", ["lasso", "mf"])
def test_kvstore_bytes_per_worker_equal_jax(app, workers):
    """Per-worker bytes (the Fig-3 quantity) equal the JAX VarSpec's
    per-device bytes on a W-wide ``data`` mesh."""
    if app == "lasso":
        X, y, cfg = _lasso_state()
        eng = lasso.make_engine(cfg, workers=workers, device="cpu")
        state = eng.init_state(y=y)
        jspecs = {"beta": P(), "r": P("data")}
    else:
        A, mask, cfg = _mf_problem()
        eng = mf.make_engine(cfg, workers=workers, device="cpu")
        state = eng.init_state(A=A, mask=mask)
        jspecs = {"W": P("data"), "H": P(), "R": P("data")}
    kv = eng.kvstore
    mesh = SimpleNamespace(shape={"data": workers})
    flat = eng.unshard(state)
    want = 0
    for k, v in flat.items():
        js = JVarSpec(tuple(v.shape), np.float32, jspecs[k])
        assert kv.specs[k].shape == js.shape
        assert kv.specs[k].nbytes() == js.nbytes()
        assert kv.specs[k].nbytes_per_device(workers) == \
            js.nbytes_per_device(mesh)
        assert is_replicated(kv.specs[k].spec) == (jspecs[k] == P())
        want += js.nbytes_per_device(mesh)
    assert kv.bytes_per_device() == want
    assert kv.total_bytes() == sum(v.numel() * 4 for v in flat.values())


def test_kvstore_specs_repartition_and_placement():
    state = {"a": torch.zeros((8, 4)), "b": torch.arange(8.0)}
    store = store_from_tree(2, state, {"a": None, "b": DATA_AXIS})
    placed = store.place_tree(state, "cpu")
    assert placed["b"].shape == (2, 4) and placed["a"].shape == (8, 4)
    before = store.bytes_per_device()
    assert before == 8 * 4 * 4 + 8 * 4 // 2
    asgn = contiguous_assignment(8, 2)
    out = store.repartition(asgn, placed, leaf_specs={"b": None})
    assert out is placed                          # bookkeeping only
    assert store.specs["b"].spec is None and store.assignment is asgn
    assert store.bytes_per_device() == 8 * 4 * 4 + 8 * 4
    assert store.repartition(asgn, leaf_specs={"b": DATA_AXIS}) is None
    assert store.partition_specs() == {"a": None, "b": DATA_AXIS}
    assert store.bytes_per_device() == before
    with pytest.raises(ValueError, match="unknown variable"):
        store.repartition(asgn, placed, leaf_specs={"nope": None})
    with pytest.raises(KeyError):
        store.place_tree({"c": torch.ones(2)}, "cpu")
    with pytest.raises(ValueError, match="role"):
        VarSpec((4,), torch.float32, None, role="prio")
    with pytest.raises(ValueError, match="leaves"):
        specs_from_tree(state, {"a": None})
    with pytest.raises(ValueError, match="unknown state leaves"):
        specs_from_tree(state, {"a": None, "b": None}, roles={"x": "model"})
    assert specs_from_tree(state, {"a": None, "b": None},
                           roles={"b": "priority"})["b"].role == "priority"


# ---------------------------------------------------------------------------
# Engine wiring
# ---------------------------------------------------------------------------

def _engine(workers=1):
    X, y, cfg = _lasso_state()
    eng = lasso.make_engine(cfg, workers=workers, device="cpu")
    return eng, eng.shard_data({"X": X, "y": y}), y


def test_engine_resolves_the_app_default_partitioner():
    eng, _, y = _engine(workers=2)
    eng.init_state(y=y)
    assert eng.partitioner_spec == PartitionerSpec(kind="static")
    asgn = eng.partition_assignment
    assert asgn == contiguous_assignment(12, 2) and asgn.version == 0
    assert eng.app.assignment is asgn
    assert eng.partition_stats is None


@pytest.mark.parametrize("executor", ["loop", "scan", "pipelined"])
def test_static_partitioner_bit_identical_every_executor(executor):
    eng, data, y = _engine(workers=2)
    base = ExecutionPlan(executor=executor, rounds=6)
    explicit = dataclasses.replace(
        base, partitioner=PartitionerSpec(kind="static"))
    a = eng.execute(eng.init_state(y=y), data,
                    torch.Generator().manual_seed(1), base).state
    b = eng.execute(eng.init_state(y=y), data,
                    torch.Generator().manual_seed(1), explicit).state
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_app_kind_compatibility_matches_jax_text():
    spec = dict(kind="load_balanced", ema=0.5)
    cfg = dict(vocab=8, num_topics=2, num_workers=1, tokens_per_worker=8,
               docs_per_worker=2)
    from repro.apps import lda as jlda
    jeng = jlda.make_engine(jlda.LDAConfig(**cfg), single_device_mesh())
    with pytest.raises(ValueError, match="cannot host") as want:
        jeng.set_partitioner(jpart.PartitionerSpec(**spec))
    eng = lda.make_engine(lda.LDAConfig(**cfg), device="cpu")
    with pytest.raises(ValueError, match=re.escape(str(want.value))):
        eng.set_partitioner(PartitionerSpec(**spec))
    meng = mf.make_engine(mf.MFConfig(num_rows=8, num_cols=6, rank=4),
                          device="cpu")
    meng.set_partitioner(PartitionerSpec(**spec))
    assert meng.partition_assignment.num_vars == 4
    meng.set_partitioner(PartitionerSpec(kind="size_balanced"))
    assert meng.partitioner.sizes == tuple(
        float(s) for s in jmf.StradsMF(jmf.MFConfig(
            num_rows=8, num_cols=6, rank=4)).partition_sizes())


def test_load_balanced_requires_partition_signal():
    class NoSignal(StradsAppBase):
        def num_schedulable(self):
            return 4

    eng = StradsEngine(NoSignal(), data_specs={}, device="cpu")
    with pytest.raises(ValueError, match="partition_signal"):
        eng.set_partitioner(PartitionerSpec(kind="load_balanced", ema=0.5))


def test_unchunked_load_balanced_plan_warns():
    eng, data, y = _engine()
    plan = ExecutionPlan(executor="scan", rounds=2,
                         partitioner=PartitionerSpec(kind="load_balanced",
                                                     ema=0.5))
    with pytest.warns(UserWarning, match="chunk boundaries"):
        eng.execute(eng.init_state(y=y), data, None, plan)


def test_restore_partition_rejects_mismatches():
    eng, _, y = _engine()
    eng.init_state(y=y)
    payload = {"owner": np.zeros((12,), np.int32),
               "num_workers": np.int32(1), "version": np.int32(1),
               "stats_ema": np.zeros((12,), np.float64)}
    with pytest.raises(ValueError, match="PartitionerSpec must match"):
        eng.restore_partition(payload)
    eng.set_partitioner(PartitionerSpec(kind="load_balanced", ema=0.5))
    with pytest.raises(ValueError, match="workers"):
        eng.restore_partition(dict(payload, num_workers=np.int32(4)))
    with pytest.raises(ValueError, match="different model size"):
        eng.restore_partition(dict(payload, owner=np.zeros((5,), np.int32),
                                   stats_ema=np.zeros((5,))))
    base = lda.make_engine(lda.LDAConfig(
        vocab=8, num_topics=2, num_workers=1, tokens_per_worker=8,
        docs_per_worker=2), device="cpu", baseline=True)
    assert base.partitioner is None       # the baseline owns no variables
    with pytest.raises(ValueError, match="active partitioner"):
        base.restore_partition(payload)


def test_partition_signals_equal_jax():
    X, y, cfg = _lasso_state()
    japp = jlasso.StradsLasso(jlasso.LassoConfig(**dataclasses.asdict(cfg)))
    beta = np.linspace(-1, 1, 12).astype(np.float32)
    np.testing.assert_array_equal(
        lasso.StradsLasso(cfg).partition_signal(
            {"beta": torch.from_numpy(beta)}).numpy(),
        np.asarray(japp.partition_signal({"beta": jnp.asarray(beta)})))
    A, mask, mcfg = _mf_problem()
    H = np.random.default_rng(1).normal(size=(4, 10)).astype(np.float32)
    jm = jmf.StradsMF(jmf.MFConfig(**dataclasses.asdict(mcfg)))
    np.testing.assert_allclose(
        mf.StradsMF(mcfg).partition_signal({"H": torch.from_numpy(H)}),
        np.asarray(jm.partition_signal({"H": jnp.asarray(H)})), rtol=1e-6)
    assert mf.StradsMF(mcfg).partition_sizes() == jm.partition_sizes()


def test_plan_files_parse_the_same_partitioner():
    import json
    with open("examples/plans/lasso_loadbal.json") as f:
        obj = json.load(f)
    assert ExecutionPlan.from_json(obj).partitioner.to_json() == \
        JPlan.from_json(obj).partitioner.to_json()
