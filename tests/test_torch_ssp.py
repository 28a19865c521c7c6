"""The port's SSP executor (``repro_torch.ps``) against the JAX package's
(``tests/test_ssp.py``, ``tests/test_kvstore.py``,
``tests/test_ckpt_resume.py``).

The JAX SSP splits its key once a round in scan's order, so
``test_torch_lasso.jax_draws`` gives its schedules' draws, and the LDA
tests feed the JAX sampler's Gibbs draws.  Tolerances: Lasso's β and r
within 1e-5 every round (f32 sums in another order), MF within 1e-5 of
the largest value and its objective within 1e-5 relative, LDA's integer
counts to the bit.  Port against port — s = 0 against scan, MF's s = 1
against scan, chunked and resumed against uninterrupted — to the bit.
Error texts are the JAX package's.
"""
import re

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
from repro_torch import convert
from repro_torch.apps import lasso, lda, mf
from repro_torch.checkpoint import load_flat, restore_checkpoint
from repro_torch.core import ExecutionPlan, StradsAppBase, StradsEngine
from repro_torch.core.kvstore import (VarTable, specs_from_tree,
                                      store_from_tree)
from repro_torch.kernels import KernelSpec
from repro_torch.ps import (ParameterServer, SSPCarry, StaleCache,
                            init_clocks, merge_summaries, min_clock,
                            rounds_per_step, tick)
from repro_torch.sched import SchedulerSpec, build_scheduler
from test_torch_lasso import jax_draws
from test_torch_lda import CFG1, CFG4, _corpus, jax_driver, jax_noise

ATOL = 1e-5          # Lasso β, r: f32 sums in another order
RTOL = 1e-5          # MF: of the largest value; objectives relative
N, J = 64, 40
LASSO = dict(num_features=J, lam=0.02, block_size=4, num_candidates=12,
             rho=0.3)
MF_SIZE = dict(num_rows=24, num_cols=10, rank=4, lam=0.05)


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


def _plan(executor, rounds, staleness=0, **kw):
    return ExecutionPlan(executor=executor, rounds=rounds,
                         staleness=staleness, **kw)


def _lasso_run(X, y, plan, workers=1, noise=None, seed=3, **kw):
    eng = lasso.make_engine(lasso.LassoConfig(**LASSO), workers=workers,
                            device="cpu")
    data = eng.shard_data({"X": X, "y": y})
    rep = eng.execute(eng.init_state(y=y), data,
                      torch.Generator().manual_seed(seed), plan,
                      collect=eng.app.objective_collect(), noise=noise, **kw)
    return eng, data, rep


def _mf_run(A, mask, plan, workers=2, **kw):
    eng = mf.make_engine(mf.MFConfig(**MF_SIZE), workers=workers,
                         device="cpu")
    data = eng.shard_data({"A": A, "mask": mask})
    state = eng.init_state(A=A, mask=mask,
                           generator=torch.Generator().manual_seed(2))
    rep = eng.execute(state, data, None, plan,
                      collect=eng.app.objective_collect(), **kw)
    return eng, data, rep


def _lda_run(plan, cfg_kw=CFG4, baseline=False, noise=None, **kw):
    words, docs, z0 = _corpus(cfg_kw)
    eng = lda.make_engine(lda.LDAConfig(**cfg_kw), device="cpu",
                          baseline=baseline, noise=noise)
    data = eng.shard_data({"words": words, "docs": docs})
    state = eng.init_state(words=words, docs=docs, z0=z0)
    rep = eng.execute(state, data, None, plan,
                      collect=eng.app.loglik_collect(), **kw)
    return eng, data, rep


# ---------------------------------------------------------------------------
# s = 0 (and MF's s = 1) equal the port's scan to the bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("app", ["lasso", "mf", "lda", "lda_baseline"])
def test_staleness_zero_equals_scan_to_the_bit(app, lasso_problem,
                                               mf_problem):
    runs = {}
    for ex in ("scan", "ssp"):
        if app == "lasso":
            runs[ex] = _lasso_run(*lasso_problem, _plan(ex, 8), workers=4)[2]
        elif app == "mf":
            runs[ex] = _mf_run(*mf_problem, _plan(ex, 8))[2]
        else:
            runs[ex] = _lda_run(_plan(ex, 8),
                                baseline=app == "lda_baseline")[2]
    _equal(runs["scan"].state, runs["ssp"].state)
    if isinstance(runs["scan"].trace, dict):
        _equal(runs["scan"].trace, runs["ssp"].trace)
    else:
        assert torch.equal(runs["scan"].trace, runs["ssp"].trace)
    assert isinstance(runs["ssp"].carry, SSPCarry)
    assert runs["ssp"].carry.t == 8
    assert runs["ssp"].carry.clocks.dtype == torch.int32
    assert runs["ssp"].carry.clocks.tolist() == [8] * runs[
        "ssp"].carry.clocks.numel()


@pytest.mark.parametrize("workers", [1, 2])
def test_mf_staleness_one_equals_scan_to_the_bit(mf_problem, workers):
    """At s = 1 MF's window is one H/W cycle: the H push reads a fresh
    snapshot and the W commit recomputes from flush-time state, so SSP
    adds no staleness error (``tests/test_ssp.py:94-106``)."""
    scan = _mf_run(*mf_problem, _plan("scan", 12), workers=workers)[2]
    ssp = _mf_run(*mf_problem, _plan("ssp", 12, 1), workers=workers)[2]
    _equal(scan.state, ssp.state)
    assert torch.equal(scan.trace, ssp.trace)


# ---------------------------------------------------------------------------
# s in {1, 2}: the port against the JAX package's SSP, fed its draws
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("workers", [1, 4])
@pytest.mark.parametrize("staleness,R", [(1, 8), (2, 9)])
def test_lasso_matches_jax_ssp_every_round(lasso_problem, workers,
                                           staleness, R):
    X, y = lasso_problem
    jeng = jlasso.make_engine(jlasso.LassoConfig(**LASSO),
                              single_device_mesh())
    jdata = jeng.shard_data({"X": jnp.asarray(X), "y": jnp.asarray(y)})
    jrep = jeng.execute(jeng.init_state(jax.random.key(0), y=y), jdata,
                        jax.random.key(0),
                        JPlan(executor="ssp", rounds=R, staleness=staleness,
                              donate=False),
                        collect=lambda s: s)
    draws = jax_draws(R, J)
    eng = lasso.make_engine(lasso.LassoConfig(**LASSO), workers=workers,
                            device="cpu")
    rep = eng.execute(eng.init_state(y=y), eng.shard_data({"X": X, "y": y}),
                      None, _plan("ssp", R, staleness,
                                  kernels=KernelSpec.default_for("pallas")),
                      collect=lambda s: s, noise=lambda t: draws[t])
    np.testing.assert_allclose(rep.trace["beta"].numpy(),
                               np.asarray(jrep.trace["beta"]), atol=ATOL)
    np.testing.assert_allclose(rep.trace["r"].reshape(R, -1).numpy(),
                               np.asarray(jrep.trace["r"]), atol=ATOL)
    np.testing.assert_allclose(rep.carry.sched_carry.numpy(),
                               np.asarray(jrep.carry.sched_carry), atol=ATOL)
    assert rep.carry.t == int(jrep.carry.t) == R
    assert rep.carry.rng_state is None
    # staleness shows: scan on the same draws ends elsewhere
    scan = eng.execute(eng.init_state(y=y), eng.shard_data({"X": X, "y": y}),
                       None, _plan("scan", R), noise=lambda t: draws[t])
    assert not torch.equal(scan.state["beta"], rep.state["beta"])


@pytest.mark.parametrize("staleness,R", [(1, 12), (2, 12)])
def test_mf_matches_jax_ssp(mf_problem, staleness, R):
    A, mask = mf_problem
    cfg_kw = dict(MF_SIZE)
    jeng = jmf.make_engine(jmf.MFConfig(**cfg_kw), single_device_mesh())
    jstate = jeng.init_state(jax.random.key(0), A=jnp.asarray(A),
                             mask=jnp.asarray(mask))
    jst = {k: np.asarray(v) for k, v in jstate.items()}
    jdata = jeng.shard_data({"A": jnp.asarray(A), "mask": jnp.asarray(mask)})
    jrep = jeng.execute(jstate, jdata, jax.random.key(0),
                        JPlan(executor="ssp", rounds=R, staleness=staleness,
                              donate=False),
                        collect=jeng.app.objective_collect())
    eng = mf.make_engine(mf.MFConfig(**cfg_kw), device="cpu")
    state, data, _ = convert.mf_from_jax(jst, A, mask, device="cpu")
    rep = eng.execute(state, data, None, _plan("ssp", R, staleness),
                      collect=eng.app.objective_collect())
    got = eng.unshard(rep.state)
    for k in ("W", "H", "R"):
        want = np.asarray(jrep.state[k])
        np.testing.assert_allclose(got[k].numpy(), want, rtol=0,
                                   atol=RTOL * max(1.0, np.abs(want).max()))
    np.testing.assert_allclose(rep.trace.numpy(), np.asarray(jrep.trace),
                               rtol=RTOL)


@pytest.mark.parametrize("baseline", [False, True])
@pytest.mark.parametrize("staleness,R", [(1, 6), (2, 6)])
def test_lda_one_worker_matches_jax_ssp_to_the_bit(baseline, staleness, R):
    words, docs, z0 = _corpus(CFG1)
    plan_kw = dict(executor="ssp", rounds=R, staleness=staleness,
                   collect_every=1)
    jst, jtrace, jerrs = jlda.fit(jlda.LDAConfig(**CFG1), words, docs, z0,
                                  single_device_mesh(), baseline=baseline,
                                  plan=JPlan(**plan_kw))
    noise = (jax_noise(CFG1, base=23, phased=False) if baseline
             else jax_noise(CFG1))
    st, trace, errs = lda.fit(lda.LDAConfig(**CFG1), words, docs, z0,
                              baseline=baseline, plan=ExecutionPlan(
                                  **plan_kw), device="cpu", noise=noise)
    for k in ("z", "D", "B", "s"):
        np.testing.assert_array_equal(st[k].numpy(), np.asarray(jst[k]))
    np.testing.assert_allclose([v for _, v in trace],
                               [v for _, v in jtrace], rtol=RTOL)
    # the s-error is an integer sum over U·M: XLA's jit divides by that
    # constant as a product with its f32 reciprocal, one ulp off at times
    assert [t for t, _ in errs] == [t for t, _ in jerrs]
    np.testing.assert_allclose([v for _, v in errs], [v for _, v in jerrs],
                               rtol=2.0 ** -23, atol=0)


@pytest.mark.parametrize("staleness", [1, 2])
def test_lda_four_workers_match_the_jax_sweeps_under_staleness(staleness):
    """W = 4: every sweep of a window reads the window-start s, z, D and B
    commit through, s is the column sums after each round; held against
    ``_gibbs_scan`` driven so, to the bit."""
    words, docs, z0 = _corpus(CFG4)
    eng = lda.make_engine(lda.LDAConfig(**CFG4), device="cpu")
    R = rounds_per_step(eng, staleness)
    want, werrs = jax_driver(CFG4, words, docs, z0, R, staleness=staleness)
    st, _, errs = lda.fit(lda.LDAConfig(**CFG4), words, docs, z0,
                          plan=ExecutionPlan(executor="ssp", rounds=R,
                                             staleness=staleness,
                                             collect_every=1),
                          device="cpu", noise=jax_noise(CFG4))
    for k in ("z", "D", "B", "s"):
        np.testing.assert_array_equal(st[k].numpy(), want[k])
    assert [v for _, v in errs] == [float(e) for e in werrs]
    # the stale reads show: jax_driver with a fresh s decides otherwise
    fresh, _ = jax_driver(CFG4, words, docs, z0, R)
    assert not np.array_equal(fresh["z"], want["z"])
    n_tok = int((words >= 0).sum())
    assert float(st["B"].sum()) == float(st["D"].sum()) == n_tok
    assert torch.equal(st["s"], st["B"].sum(0))


# ---------------------------------------------------------------------------
# The staleness invariant, over what the executor served
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scheduler", ["strads", "rr", "cyclic"])
@pytest.mark.parametrize("steps", [1, 2, 3])
@pytest.mark.parametrize("staleness", [0, 1, 2, 3, 4])
def test_read_staleness_never_exceeds_bound(staleness, steps, scheduler):
    """``tests/test_ssp.py::test_read_staleness_never_exceeds_bound`` over
    every case of its strategy: no read more than s clocks stale, each
    window serves one read at every staleness 0..s, one flush a window,
    the clocks at R."""
    r = np.random.default_rng(staleness * 7 + steps)
    X, y, _ = jlasso.synthetic_correlated(r, n=24, J=12, k_true=3)
    cfg = lasso.LassoConfig(num_features=12, lam=0.02, block_size=3,
                            num_candidates=6, rho=0.5, scheduler=scheduler)
    eng = lasso.make_engine(cfg, device="cpu")
    data = eng.shard_data({"X": X, "y": y})
    R = (staleness + 1) * steps
    state, telem, carry = eng.run_ssp(
        eng.init_state(y=y), data, torch.Generator().manual_seed(1), R,
        staleness=staleness, with_telemetry=True, return_carry=True)
    assert telem.max_staleness <= staleness
    assert telem.hist.sum() == R == telem.rounds
    assert (telem.hist == steps).all()
    assert telem.flushes == steps
    assert (telem.clocks == R).all() and carry.clocks.tolist() == [R]
    assert telem.bytes_pushed == R * cfg.block_size * 4
    assert telem.bytes_pulled == steps * 12 * 4          # β a flush
    assert telem.bytes_deferred_peak == (staleness + 1) * cfg.block_size * 4
    assert bool(torch.isfinite(state["beta"]).all())


# ---------------------------------------------------------------------------
# The window: in-flight exclusion, pristine stats and decisions
# ---------------------------------------------------------------------------

def test_window_proposals_avoid_candidates_in_flight(lasso_problem):
    """In a window the second and third proposals see the earlier ones'
    candidates at the η floor and so avoid them; the Gram blocks and
    the ρ-filter read the unmarked view and carry; the carry folds per
    replayed commit."""
    X, y = lasso_problem
    eng = lasso.make_engine(lasso.LassoConfig(**LASSO), device="cpu")
    app = eng.app
    seen = {"propose": [], "stats": [], "schedule": [], "update": []}
    propose, stats, schedule, update = (app.propose, app.schedule_stats,
                                        app.schedule, app.sched_update)

    def rec_propose(state, carry, noise, t, phase):
        c = propose(state, carry, noise, t, phase)
        seen["propose"].append((carry.clone(), c))
        return c

    def rec_stats(data, state, cand, phase):
        seen["stats"].append(state["beta"].clone())
        return stats(data, state, cand, phase)

    def rec_schedule(state, carry, cand, st, t, phase):
        seen["schedule"].append(carry.clone())
        return schedule(state, carry, cand, st, t, phase)

    def rec_update(carry, before, after, sched, phase):
        seen["update"].append(carry.clone())
        return update(carry, before, after, sched, phase)

    app.propose, app.schedule_stats = rec_propose, rec_stats
    app.schedule, app.sched_update = rec_schedule, rec_update
    draws = jax_draws(6, J)
    eng.execute(eng.init_state(y=y), eng.shard_data({"X": X, "y": y}), None,
                _plan("ssp", 6, 2), noise=lambda t: draws[t])
    ones = torch.ones(J)
    # window 0 starts from the fresh carry: each proposal sees the earlier
    # candidates zeroed, and the three candidate sets are disjoint
    (c0, k0), (c1, k1), (c2, k2) = seen["propose"][:3]
    assert torch.equal(c0, ones)
    assert (c1[k0] == 0).all() and (c1.sum() == J - len(k0))
    assert (c2[torch.cat([k0, k1])] == 0).all()
    assert len(set(torch.cat([k0, k1, k2]).tolist())) == 3 * len(k0)
    # the decisions read the window-start carry, the stats its β
    assert all(torch.equal(c, ones) for c in seen["schedule"][:3])
    assert all(torch.equal(b, torch.zeros(J)) for b in seen["stats"][:3])
    # the carry folds per replayed commit: window 1's proposals start from
    # the carry after three updates, not from a marked one
    assert torch.equal(seen["update"][0], ones)
    assert not torch.equal(seen["update"][1], ones)
    assert torch.equal(seen["propose"][3][0], seen["schedule"][3])
    assert (seen["propose"][3][0] > 0).any()
    # s = 0 marks nothing: one proposal a window
    sc = eng.init_sched_carry()
    assert eng.mark_sched_carry(sc, k0) is not sc and torch.equal(sc, ones)


class _TopPriority(StradsAppBase):
    """A toy app whose priority table lives in its state (``var_roles``):
    each round proposes the ``k`` variables of highest priority and adds
    1 to x at them (a pull of the summed pushes)."""

    def __init__(self, J: int, k: int):
        self.J, self.k = J, k

    def var_roles(self):
        return {"prio": "priority"}

    def init_state(self):
        return {"x": torch.zeros(self.J), "prio": torch.arange(
            1.0, self.J + 1).flip(0)}

    def propose(self, state, carry, noise, t, phase):
        return torch.topk(state["prio"], self.k).indices

    def push(self, data, state, sched, phase):
        return torch.ones((2, self.k)) * 0.5, None

    def pull(self, state, sched, z, local, data, phase):
        x = state["x"].clone()
        x[sched] += z
        return {"x": x, "prio": state["prio"]}


def test_state_priority_leaves_are_masked_in_the_window():
    app = _TopPriority(J=10, k=2)
    eng = StradsEngine(app, {}, {"x": None, "prio": None}, workers=2,
                       device="cpu")
    assert eng.app_roles() == {"prio": "priority"}
    state = eng.init_state()
    assert eng.kvstore.specs["prio"].role == "priority"
    pushed = []
    push = app.push
    app.push = lambda d, s, sched, ph: (pushed.append(sched.tolist()),
                                        push(d, s, sched, ph))[1]
    rep = eng.execute(state, {}, None, _plan("ssp", 6, 2))
    # each window's three proposals take the next two of highest priority
    assert pushed == [[0, 1], [2, 3], [4, 5]] * 2
    assert rep.state["x"].tolist() == [2.0] * 6 + [0.0] * 4
    assert torch.equal(rep.state["prio"], state["prio"])  # not marked
    scan = eng.execute(state, {}, None, _plan("scan", 6))
    assert scan.state["x"].tolist() == [6.0] * 2 + [0.0] * 8


# ---------------------------------------------------------------------------
# The cache holds the server-resident leaves as they were at the window
# start: no push or commit writes them in place
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("app", ["lasso", "mf", "lda", "lda_baseline"])
def test_server_resident_leaves_hold_through_a_window(app, lasso_problem,
                                                      mf_problem):
    s, R = 2, {"lasso": 6, "mf": 6, "lda": 12, "lda_baseline": 6}[app]
    if app == "lasso":
        eng = lasso.make_engine(lasso.LassoConfig(**LASSO), workers=2,
                                device="cpu")
        data = eng.shard_data({"X": lasso_problem[0], "y": lasso_problem[1]})
        state = eng.init_state(y=lasso_problem[1])
    elif app == "mf":
        eng = mf.make_engine(mf.MFConfig(**MF_SIZE), workers=2,
                             device="cpu")
        data = eng.shard_data({"A": mf_problem[0], "mask": mf_problem[1]})
        state = eng.init_state(A=mf_problem[0], mask=mf_problem[1])
    else:
        words, docs, z0 = _corpus(CFG4)
        eng = lda.make_engine(lda.LDAConfig(**CFG4), device="cpu",
                              baseline=app == "lda_baseline")
        data = eng.shard_data({"words": words, "docs": docs})
        state = eng.init_state(words=words, docs=docs, z0=z0)
    shared = ParameterServer(eng.kvstore).shared_names
    assert shared == {"lasso": {"beta"}, "mf": {"H"}, "lda": {"s", "s_err"},
                      "lda_baseline": {"B", "s"}}[app]
    start = {k: state[k].clone() for k in shared}
    reads = []
    push = eng.app.push

    def rec(d, st, sched, ph):
        reads.append({k: (st[k], st[k].clone()) for k in shared})
        return push(d, st, sched, ph)

    eng.app.push = rec
    rep = eng.execute(state, data, None, _plan("ssp", R, s),
                      collect=lambda st: {k: st[k].clone() for k in shared})
    assert len(reads) == R
    for t, read in enumerate(reads):
        w0 = t - t % (s + 1)
        want = start if w0 == 0 else {k: rep.trace[k][w0 - 1]
                                      for k in shared}
        for k, (ref, copy) in read.items():
            assert torch.equal(copy, want[k]), (t, k)
            assert torch.equal(ref, copy), (t, k)   # never written after


# ---------------------------------------------------------------------------
# VarTable (tests/test_kvstore.py:117-156), the server, the cache, clocks
# ---------------------------------------------------------------------------

def _nested_state():
    return {"model": {"w": torch.zeros((4, 2)), "p": torch.zeros((4,))},
            "r": torch.zeros((6,))}


def _nested_specs():
    return {"model": {"w": None, "p": None}, "r": "data"}


def test_vartable_derives_nested_commit_and_priority_sets():
    state = _nested_state()
    store = store_from_tree(2, state, _nested_specs(),
                            roles={"model/p": "priority"})
    table = VarTable(store)
    assert table.worker_resident == {"r"}
    assert table.priority_names == {"model/p"}
    local = {"r": torch.full((6,), 7.0), "z": torch.ones((3,))}
    committed = table.commit_local(state, local, phase=0)
    assert (committed["r"] == 7.0).all()
    assert (committed["model"]["w"] == 0.0).all()
    assert (state["r"] == 0.0).all()                    # a new dict
    deferred = table.defer_local(local, phase=0)
    assert set(deferred) == {"z"}
    rebuilt = table.rebuild_local(committed, deferred, phase=0)
    assert set(rebuilt) == {"r", "z"}
    assert (rebuilt["r"] == 7.0).all() and (rebuilt["z"] == 1.0).all()
    view = {"model": {"w": torch.ones((4, 2)), "p": torch.ones((4,))},
            "r": torch.ones((6,))}
    marked = table.mark_scheduled(view, torch.tensor([1, 3]))
    assert marked["model"]["p"].tolist() == [1.0, 0.0, 1.0, 0.0]
    assert (marked["model"]["w"] == 1.0).all()
    assert (view["model"]["p"] == 1.0).all()            # a new tensor
    with pytest.raises(TypeError, match="integer"):
        table.mark_scheduled(view, torch.tensor([0.5, 1.5]))
    assert table.mark_scheduled(view, None) is view
    # a nested local, and a push with no local
    nested = {"a": {"r": torch.full((6,), 2.0), "q": torch.ones(2)}}
    assert table.commit_local(state, nested, phase=1) is state
    assert table.rebuild_local(state, table.defer_local(nested, 1),
                               1)["a"]["q"].tolist() == [1.0, 1.0]
    assert table.commit_local(state, None, phase=2) is state
    assert table.defer_local(None, 2) == {}
    assert table.rebuild_local(state, {}, 2) is None


def test_vartable_rejects_structure_drift():
    state = _nested_state()
    table = VarTable(store_from_tree(2, state, _nested_specs()))
    assert table.priority_names == frozenset()
    table.commit_local(state, {"r": torch.zeros((6,))}, phase=0)
    with pytest.raises(ValueError, match="different"):
        table.commit_local(state, {"z": torch.zeros((3,))}, phase=0)
    with pytest.raises(ValueError, match="defer_local"):
        table.rebuild_local(state, {}, phase=5)
    with pytest.raises(ValueError, match="unknown state leaves"):
        specs_from_tree(state, _nested_specs(), roles={"nope": "priority"})


def test_server_split_cache_gate_and_clocks(lasso_problem):
    X, y = lasso_problem
    eng = lasso.make_engine(lasso.LassoConfig(**LASSO), workers=4,
                            device="cpu")
    state = eng.init_state(y=y)
    srv = ParameterServer(eng.kvstore)
    assert srv.shared_names == {"beta"}
    assert srv.shared_nbytes() == J * 4 and srv.local_nbytes() == N * 4
    snap = srv.snapshot(state)
    assert set(snap) == {"beta"} and snap["beta"] is state["beta"]
    merged = srv.merge(state, {"beta": torch.ones(J)})
    assert (merged["beta"] == 1).all() and merged["r"] is state["r"]
    again = ParameterServer.from_state(4, state, {"beta": None,
                                                  "r": "data"})
    assert again.shared_names == srv.shared_names
    c = StaleCache(values={"x": torch.zeros(3)}, clock=4)
    assert c.staleness(6) == 2
    assert c.fresh_enough(6, 2) and not c.fresh_enough(7, 2)
    assert c.refresh({"x": torch.ones(3)}, 7).staleness(7) == 0
    clocks = init_clocks(4)
    assert clocks.dtype == torch.int32 and clocks.tolist() == [0] * 4
    assert tick(tick(clocks)).tolist() == [2] * 4 and clocks.sum() == 0
    assert int(min_clock(tick(clocks))) == 1


def test_mark_scheduled_on_the_schedulers():
    dp = build_scheduler(SchedulerSpec(kind="dynamic_priority", block_size=2,
                                       num_candidates=3, rho=0.3),
                         num_vars=6, num_workers=1)
    carry = dp.init_carry("cpu")
    out = dp.mark_scheduled(carry, torch.tensor([1, 4]))
    assert out.tolist() == [1, 0, 1, 1, 0, 1] and (carry == 1).all()
    assert dp.mark_scheduled(carry, None) is carry
    for kind in ("round_robin", "random"):
        s = build_scheduler(SchedulerSpec(kind=kind, block_size=2),
                            num_vars=6, num_workers=1)
        assert s.mark_scheduled(None, torch.tensor([1])) is None


def test_merge_summaries_adds_counts():
    X, y, _ = jlasso.synthetic_correlated(np.random.default_rng(1), n=24,
                                          J=12, k_true=3)
    eng = lasso.make_engine(lasso.LassoConfig(num_features=12, lam=0.02,
                                              block_size=3,
                                              num_candidates=6),
                            device="cpu")
    data = eng.shard_data({"X": X, "y": y})
    st, a, carry = eng.run_ssp(eng.init_state(y=y), data, None, 4,
                               staleness=1, with_telemetry=True,
                               return_carry=True)
    _, b = eng.run_ssp(st, data, None, 4, staleness=1, t0=4,
                       clocks=carry.clocks, sched_carry0=carry.sched_carry,
                       with_telemetry=True)
    m = merge_summaries([a, b])
    assert m.rounds == 8 and m.flushes == 4 and m.hist.tolist() == [4, 4]
    assert m.clocks.tolist() == [8]
    assert m.to_json()["hist"] == [4, 4]
    with pytest.raises(ValueError, match="staleness bounds"):
        merge_summaries([a, eng.run_ssp(st, data, None, 1,
                                        with_telemetry=True)[1]])
    with pytest.raises(ValueError, match="at least one"):
        merge_summaries([])


# ---------------------------------------------------------------------------
# Chunked and resumed runs; a JAX SSP checkpoint continued in the port
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("app,staleness,R,every", [
    ("lasso", 1, 8, 4), ("mf", 2, 12, 6), ("lda", 1, 8, 4)])
def test_chunked_and_resumed_ssp_equal_uninterrupted(app, staleness, R,
                                                     every, lasso_problem,
                                                     mf_problem, tmp_path):
    plan = _plan("ssp", R, staleness)
    chunked = _plan("ssp", R, staleness, checkpoint_every=every)
    if app == "lasso":
        def run(p, **kw):
            return _lasso_run(*lasso_problem, p, workers=2, **kw)
    elif app == "mf":
        def run(p, **kw):
            return _mf_run(*mf_problem, p, **kw)
    else:
        def run(p, **kw):
            return _lda_run(p, **kw)
    eng, data, whole = run(plan)
    _, _, rep = run(chunked, ckpt_dir=str(tmp_path))
    _equal(whole.state, rep.state)
    trace = whole.trace
    if isinstance(trace, dict):
        _equal(trace, rep.trace)
    else:
        assert torch.equal(trace, rep.trace)
    assert isinstance(rep.carry, SSPCarry) and rep.carry.t == R
    assert torch.equal(rep.carry.clocks, whole.carry.clocks)
    flat = load_flat(str(tmp_path), every)
    assert flat["carry/.clocks"].tolist() == [every] * eng.workers
    assert int(flat["carry/.t"]) == every
    # a fresh engine resumed from the middle file
    eng2, data2, _ = run(_plan("ssp", rounds_per_step(eng, staleness),
                               staleness))
    back = restore_checkpoint(str(tmp_path), every,
                              {"state": whole.state, "carry": whole.carry})
    assert isinstance(back["carry"], SSPCarry)
    res = eng2.execute(back["state"], data2, None, plan,
                       carry=back["carry"])
    _equal(whole.state, res.state)
    assert torch.equal(res.carry.clocks, whole.carry.clocks)


def test_checkpoint_from_jax_continues_an_ssp_run(lasso_problem, tmp_path):
    """A JAX SSP run (s = 1) saved at t = 4 continues in the port, fed the
    JAX draws, to the JAX run's β and r at t = 8 within ATOL."""
    X, y = lasso_problem
    R = 8
    jeng = jlasso.make_engine(jlasso.LassoConfig(**LASSO),
                              single_device_mesh())
    jdata = jeng.shard_data({"X": jnp.asarray(X), "y": jnp.asarray(y)})
    jrep = jeng.execute(jeng.init_state(jax.random.key(0), y=y), jdata,
                        jax.random.key(0),
                        JPlan(executor="ssp", rounds=R, staleness=1,
                              checkpoint_every=4),
                        ckpt_dir=str(tmp_path))
    flat = jload_flat(str(tmp_path), 4)
    assert "carry/.clocks" in flat
    eng = lasso.make_engine(lasso.LassoConfig(**LASSO), workers=2,
                            device="cpu")
    state, carry, _ = convert.checkpoint_from_jax(flat, eng)
    assert isinstance(carry, SSPCarry)
    assert carry.t == 4 and carry.rng_state is None
    assert carry.clocks.tolist() == [4, 4]
    draws = jax_draws(R, J)
    rep = eng.execute(state, eng.shard_data({"X": X, "y": y}), None,
                      _plan("ssp", R, 1), carry=carry,
                      noise=lambda t: draws[t])
    np.testing.assert_allclose(rep.state["beta"].numpy(),
                               np.asarray(jrep.state["beta"]), atol=ATOL)
    np.testing.assert_allclose(rep.state["r"].reshape(-1).numpy(),
                               np.asarray(jrep.state["r"]), atol=ATOL)
    np.testing.assert_allclose(rep.carry.sched_carry.numpy(),
                               np.asarray(jrep.carry.sched_carry), atol=ATOL)
    assert rep.carry.clocks.tolist() == [R, R]


# ---------------------------------------------------------------------------
# Error paths, with the JAX package's texts
# ---------------------------------------------------------------------------

def _jax_error(fn):
    with pytest.raises(ValueError) as err:
        fn()
    return str(err.value)


def test_rejects_non_multiple_rounds_and_foreign_carries(lasso_problem,
                                                         tmp_path):
    X, y = lasso_problem
    jeng = jlasso.make_engine(jlasso.LassoConfig(**LASSO),
                              single_device_mesh())
    jdata = jeng.shard_data({"X": jnp.asarray(X), "y": jnp.asarray(y)})
    jstate = jeng.init_state(jax.random.key(0), y=y)
    eng = lasso.make_engine(lasso.LassoConfig(**LASSO), device="cpu")
    data = eng.shard_data({"X": X, "y": y})
    state = eng.init_state(y=y)

    def both(jfn, fn, match):
        want = _jax_error(jfn)
        with pytest.raises(ValueError, match=match) as err:
            fn()
        assert str(err.value) == want

    # rounds that do not tile lcm(s + 1, phase_period)
    both(lambda: jeng.execute(jstate, jdata, jax.random.key(1),
                              JPlan(executor="ssp", rounds=5, staleness=1,
                                    donate=False)),
         lambda: eng.execute(state, data, None, _plan("ssp", 5, 1)),
         "multiple")
    # t0 off the step
    both(lambda: jeng.run_ssp(jstate, jdata, jax.random.key(1), 4,
                              staleness=1, t0=3, donate=False),
         lambda: eng.run_ssp(state, data, None, 4, staleness=1, t0=3),
         "t0")
    # a checkpoint cadence off the step, and an unrunnable final chunk
    both(lambda: jeng.execute(jstate, jdata, jax.random.key(1),
                              JPlan(executor="ssp", rounds=8, staleness=1,
                                    checkpoint_every=3),
                              ckpt_dir=str(tmp_path / "j")),
         lambda: eng.execute(state, data, None,
                             _plan("ssp", 8, 1, checkpoint_every=3),
                             ckpt_dir=str(tmp_path / "t")),
         "checkpoint_every")
    both(lambda: jeng.execute(jstate, jdata, jax.random.key(1),
                              JPlan(executor="ssp", rounds=7, staleness=1,
                                    checkpoint_every=2),
                              ckpt_dir=str(tmp_path / "j")),
         lambda: eng.execute(state, data, None,
                             _plan("ssp", 7, 1, checkpoint_every=2),
                             ckpt_dir=str(tmp_path / "t")),
         "plan.rounds")
    assert not (tmp_path / "t").exists()
    # foreign carries
    jssp = jeng.execute(jstate, jdata, jax.random.key(1),
                        JPlan(executor="ssp", rounds=4, staleness=1,
                              donate=False))
    jscan = jeng.execute(jstate, jdata, jax.random.key(1),
                         JPlan(executor="scan", rounds=4, donate=False))
    ssp = eng.execute(state, data, None, _plan("ssp", 4, 1))
    scan = eng.execute(state, data, None, _plan("scan", 4))
    both(lambda: jeng.execute(jstate, jdata, None,
                              JPlan(executor="pipelined", rounds=8),
                              carry=jssp.carry),
         lambda: eng.execute(state, data, None, _plan("pipelined", 8),
                             carry=ssp.carry),
         "EngineCarry")
    both(lambda: jeng.execute(jstate, jdata, None,
                              JPlan(executor="ssp", rounds=8, staleness=1),
                              carry=jscan.carry),
         lambda: eng.execute(state, data, None, _plan("ssp", 8, 1),
                             carry=scan.carry),
         "SSPCarry")
    # the loop executor continues an SSP run's carry, as in the JAX package
    rest = eng.execute(ssp.state, data, None, _plan("loop", 6),
                       carry=ssp.carry)
    assert rest.carry.t == 6
    with pytest.raises(ValueError, match=re.escape(
            "carry must be the EngineCarry or SSPCarry")):
        eng.execute(state, data, None, _plan("loop", 4), carry=object())
    with pytest.warns(UserWarning, match="sched_carry0"):
        eng.run_ssp(state, data, None, 2, staleness=1, t0=2)
