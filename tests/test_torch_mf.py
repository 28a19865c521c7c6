"""The port's STRADS MF against the JAX package's.

States carried over with ``convert.mf_from_jax`` go through the same
rounds in both packages.  Tolerance: 1e-5 of the largest value (f32 sums
in a different order, and the port reads R where the JAX package reads
R · mask); objectives within 1e-5 relative.  Schedules are equal.  The
properties of ``tests/test_mf.py`` are held by the port on its own.
"""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.apps import mf as jmf
from repro.core import ExecutionPlan as JPlan
from repro.core import single_device_mesh
from repro.sched import SchedulerSpec as JSpec
from repro_torch import convert
from repro_torch.apps import mf
from repro_torch.core import ExecutionPlan, tree_psum
from repro_torch.sched import SchedulerSpec

RTOL = 1e-5   # of the largest value / of the objective
N, M, K = 60, 40, 6


def close(got, want, rtol=RTOL):
    got = got.detach().cpu().numpy() if torch.is_tensor(got) else got
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rtol * max(1.0, np.abs(want).max()))


@pytest.fixture(scope="module")
def problem():
    A, mask = jmf.synthetic_ratings(np.random.default_rng(0), N, M,
                                    true_rank=6, density=0.5)
    return A, mask


@pytest.fixture(scope="module")
def mesh():
    return single_device_mesh()


def _jax_state(cfg, A, mask, seed=0):
    eng = jmf.make_engine(cfg, single_device_mesh())
    st = eng.init_state(jax.random.key(seed), A=jnp.asarray(A),
                        mask=jnp.asarray(mask))
    return {k: np.asarray(v) for k, v in st.items()}


def test_synthetic_ratings_are_the_same_data(problem):
    A, mask = problem
    A2, m2 = mf.synthetic_ratings(np.random.default_rng(0), N, M,
                                  true_rank=6, density=0.5)
    np.testing.assert_array_equal(A2, A)
    np.testing.assert_array_equal(m2, mask)


@pytest.mark.parametrize("workers", [1, 2])
@pytest.mark.parametrize("ranks", [[3], [1, 4]])
def test_one_h_round_and_one_w_round_match_push_and_pull(problem, workers,
                                                         ranks):
    A, mask = problem
    cfg_kw = dict(num_rows=N, num_cols=M, rank=K,
                  ranks_per_round=len(ranks))
    jst = _jax_state(jmf.MFConfig(**cfg_kw), A, mask, seed=1)
    japp = jmf.StradsMF(jmf.MFConfig(**cfg_kw))
    jdata = {"A": jnp.asarray(A), "mask": jnp.asarray(mask)}
    jsched = {"ranks": jnp.asarray(ranks, jnp.int32)}
    eng = mf.make_engine(mf.MFConfig(**cfg_kw), workers=workers,
                         device="cpu")
    state, data, _ = convert.mf_from_jax(jst, A, mask, workers=workers,
                                         device="cpu")
    sched = {"ranks": torch.tensor(ranks)}
    js = {k: jnp.asarray(v) for k, v in jst.items()}
    for phase in (0, 1):
        jz, _ = japp.push(jdata, js, jsched, phase)
        js = japp.pull(js, jsched, jz, None, jdata, phase)
        z, local = eng.app.push(data, state, sched, phase)
        if phase == 0:
            assert z["a"].shape == (workers, len(ranks), M)
            close(z["a"].sum(0), jz["a"])
            close(z["b"].sum(0), jz["b"])
        else:
            assert z is None                 # the W-phase sums nothing
        state = eng.app.pull(state, sched, tree_psum(z), local, data,
                             phase)
        flat = eng.unshard(state)
        for k in ("W", "H", "R"):
            close(flat[k], js[k])
    close(eng.app.partition_signal(state), japp.partition_signal(js))
    assert eng.app.partition_sizes() == japp.partition_sizes()


def _port_run(cfg, A, mask, jst, plan, workers=1, noise=None, carry=None,
              log=None):
    eng = mf.make_engine(cfg, workers=workers, device="cpu")
    state, data, c = convert.mf_from_jax(jst, A, mask, workers=workers,
                                         device="cpu",
                                         t=0 if carry is None else carry)
    cb = None
    if log is not None:
        def cb(t, s, out):
            log.append((t, out.sched["ranks"].tolist()))
            return False
    rep = eng.execute(state, data, None, plan,
                      collect=eng.app.objective_collect(), noise=noise,
                      carry=None if carry is None else c, callback=cb)
    return eng, rep


@pytest.mark.parametrize("workers", [1, 3])
def test_round_robin_trajectory_matches_jax_fit(problem, mesh, workers):
    A, mask = problem
    R = 2 * K
    cfg_kw = dict(num_rows=N, num_cols=M, rank=K, lam=0.05)
    jstate, jtrace = jmf.fit(jmf.MFConfig(**cfg_kw), A, mask, mesh,
                             num_rounds=R, trace_every=1)
    jst = _jax_state(jmf.MFConfig(**cfg_kw), A, mask)   # fit's key(0)
    eng, rep = _port_run(mf.MFConfig(**cfg_kw), A, mask, jst,
                         ExecutionPlan(executor="loop", rounds=R),
                         workers=workers)
    np.testing.assert_allclose(rep.trace.numpy(), [v for _, v in jtrace],
                               rtol=RTOL)
    flat = eng.unshard(rep.state)
    for k in ("W", "H", "R"):
        close(flat[k], jstate[k])


def _cycle_draws(cycles: int, block: int) -> np.ndarray:
    """Per cycle c, noise whose top-U set, in order, is the JAX random
    scheduler's ``choice`` under ``fold_in(key(29), c)`` (mf.py:132-134)."""
    out = np.full((cycles, K), -10.0, np.float32)
    for c in range(cycles):
        key = jax.random.fold_in(jax.random.key(29), c)
        pick = np.asarray(jax.random.choice(key, K, shape=(block,),
                                            replace=False))
        out[c, pick] = block - np.arange(block)
    return out


def test_random_schedules_the_jax_blocks_when_fed_its_cycle_draws(
        problem, mesh):
    A, mask = problem
    R, U = 4 * K, 2
    cfg_kw = dict(num_rows=N, num_cols=M, rank=K, ranks_per_round=U)
    jspec = JSpec(kind="random", block_size=U)
    jeng = jmf.make_engine(jmf.MFConfig(**cfg_kw), mesh)
    jdata = jeng.shard_data({"A": jnp.asarray(A), "mask": jnp.asarray(mask)})
    jinit = jeng.init_state(jax.random.key(0), A=jnp.asarray(A),
                            mask=jnp.asarray(mask))
    jst = {k: np.asarray(v) for k, v in jinit.items()}
    jlog = []
    jrep = jeng.execute(jinit, jdata, jax.random.key(0),
                        JPlan(executor="loop", rounds=R, scheduler=jspec),
                        callback=lambda t, s, out: jlog.append(
                            (t, np.asarray(out.sched["ranks"]).tolist())))
    draws = _cycle_draws(R // 2, U)
    log = []
    eng, rep = _port_run(
        mf.MFConfig(**cfg_kw), A, mask, jst,
        ExecutionPlan(executor="loop", rounds=R,
                      scheduler=SchedulerSpec(kind="random", block_size=U)),
        noise=lambda t: draws[t // 2], log=log)
    assert log == jlog
    for k in ("W", "H", "R"):
        close(eng.unshard(rep.state)[k], jrep.state[k])


def test_random_draws_once_per_cycle_and_not_from_the_fit_seed(problem):
    A, mask = problem
    cfg = mf.MFConfig(num_rows=N, num_cols=M, rank=K, ranks_per_round=2)
    plan = ExecutionPlan(executor="loop", rounds=12, scheduler=SchedulerSpec(
        kind="random", block_size=2))
    logs = []
    for seed in (0, 5):
        log = []
        gen = torch.Generator().manual_seed(seed)
        eng = mf.make_engine(cfg, device="cpu")
        eng.execute(eng.init_state(A=A, mask=mask, generator=gen),
                    eng.shard_data({"A": A, "mask": mask}), gen, plan,
                    callback=lambda t, s, out: log.append(
                        sorted(out.sched["ranks"].tolist())))
        logs.append(log)
    for log in logs:
        assert all(log[2 * c] == log[2 * c + 1] for c in range(6))
        assert len({tuple(x) for x in log}) > 1
    assert logs[0] == logs[1]
    want = mf.cycle_gumbel(3, K, "cpu")
    assert torch.equal(want, mf.cycle_gumbel(3, K, "cpu"))
    assert not torch.equal(want, mf.cycle_gumbel(4, K, "cpu"))


@pytest.mark.parametrize("kind", ["round_robin", "random"])
@pytest.mark.parametrize("workers", [1, 3])
def test_port_loop_equals_port_scan_bit_exactly(problem, kind, workers):
    A, mask = problem
    cfg = mf.MFConfig(num_rows=N, num_cols=M, rank=K, ranks_per_round=2)
    spec = SchedulerSpec(kind=kind, block_size=2)
    out = {}
    for ex in ("loop", "scan"):
        out[ex] = mf.fit(cfg, A, mask, plan=ExecutionPlan(
            executor=ex, rounds=10, workers=workers, scheduler=spec,
            collect_every=1), generator=torch.Generator().manual_seed(2),
            device="cpu")
    for k in ("W", "H", "R"):
        assert torch.equal(out["loop"][0][k], out["scan"][0][k])
    assert out["loop"][1] == out["scan"][1]


def test_one_and_four_workers_agree(problem):
    A, mask = problem
    cfg = mf.MFConfig(num_rows=N, num_cols=M, rank=K)
    runs = [mf.fit(cfg, A, mask, num_rounds=2 * K, workers=W,
                   generator=torch.Generator().manual_seed(1),
                   device="cpu")[0] for W in (1, 4)]
    for k in ("W", "H", "R"):
        close(runs[1][k], runs[0][k].numpy())


def test_jax_run_converted_mid_way_continues_identically(problem, mesh):
    A, mask = problem
    R1, R = 4, 10
    cfg_kw = dict(num_rows=N, num_cols=M, rank=K)
    jeng = jmf.make_engine(jmf.MFConfig(**cfg_kw), mesh)
    jdata = jeng.shard_data({"A": jnp.asarray(A), "mask": jnp.asarray(mask)})
    jinit = jeng.init_state(jax.random.key(0), A=jnp.asarray(A),
                            mask=jnp.asarray(mask))
    whole = jeng.execute(jinit, jdata, jax.random.key(0),
                         JPlan(executor="loop", rounds=R))
    half = jeng.execute(jinit, jdata, jax.random.key(0),
                        JPlan(executor="loop", rounds=R1))
    jst = {k: np.asarray(v) for k, v in half.state.items()}
    eng, rep = _port_run(mf.MFConfig(**cfg_kw), A, mask, jst,
                         ExecutionPlan(executor="scan", rounds=R),
                         workers=2, carry=int(half.carry.t))
    assert rep.trace.shape == (R - R1,) and rep.carry.t == R
    for k in ("W", "H", "R"):
        close(eng.unshard(rep.state)[k], whole.state[k])


def test_scan_keeps_the_jax_phase_rule(problem):
    """A scan run must start on an H/W cycle boundary, with the JAX
    package's error; the loop may start anywhere."""
    A, mask = problem
    cfg_kw = dict(num_rows=N, num_cols=M, rank=K)
    jeng = jmf.make_engine(jmf.MFConfig(**cfg_kw), single_device_mesh())
    jdata = jeng.shard_data({"A": jnp.asarray(A), "mask": jnp.asarray(mask)})
    jinit = jeng.init_state(jax.random.key(0), A=jnp.asarray(A),
                            mask=jnp.asarray(mask))
    with pytest.raises(ValueError) as jerr:
        jeng.run_scanned(jinit, jdata, jax.random.key(0), 2, t0=1,
                         donate=False)
    assert jeng.phase_period == 2
    jst = _jax_state(jmf.MFConfig(**cfg_kw), A, mask)
    with pytest.raises(ValueError, match=re.escape(str(jerr.value))):
        _port_run(mf.MFConfig(**cfg_kw), A, mask, jst,
                  ExecutionPlan(executor="scan", rounds=4), carry=1)
    eng, rep = _port_run(mf.MFConfig(**cfg_kw), A, mask, jst,
                         ExecutionPlan(executor="loop", rounds=4), carry=1)
    assert eng.phase_period == 2 and rep.carry.t == 4


# -- the properties of tests/test_mf.py, on the port -------------------------

def test_h_update_matches_closed_form(problem):
    A, mask = problem
    cfg = mf.MFConfig(num_rows=N, num_cols=M, rank=K, lam=0.05)
    eng = mf.make_engine(cfg, workers=2, device="cpu")
    data = eng.shard_data({"A": A, "mask": mask})
    st = eng.init_state(A=A, mask=mask,
                        generator=torch.Generator().manual_seed(1))
    out = eng.run_round(st, data, t=0)
    W, H, R = (eng.unshard(st)[k].numpy() for k in ("W", "H", "R"))
    num = np.einsum("i,ij->j", W[:, 0], R * mask) \
        + np.einsum("ij,i->j", mask, W[:, 0] ** 2) * H[0]
    den = 0.05 + np.einsum("ij,i->j", mask, W[:, 0] ** 2)
    np.testing.assert_allclose(out.state["H"][0].numpy(), num / den,
                               rtol=2e-5, atol=2e-5)


def test_residual_consistency(problem):
    A, mask = problem
    cfg = mf.MFConfig(num_rows=N, num_cols=M, rank=K, lam=0.05)
    state, _ = mf.fit(cfg, A, mask, num_rounds=20, workers=2, device="cpu")
    W, H, R = (state[k].numpy() for k in ("W", "H", "R"))
    np.testing.assert_allclose(R, (A - W @ H) * mask, atol=1e-3)


def test_objective_decreases(problem):
    A, mask = problem
    cfg = mf.MFConfig(num_rows=N, num_cols=M, rank=K, lam=0.05)
    _, trace = mf.fit(cfg, A, mask, num_rounds=60, trace_every=10,
                      device="cpu")
    vals = [v for _, v in trace]
    assert vals[-1] < vals[0] * 0.2           # big drop
    for a, b in zip(vals, vals[1:]):
        assert b <= a + 1e-3                  # monotone (exact CD)


def test_recovers_low_rank_signal():
    A, mask = mf.synthetic_ratings(np.random.default_rng(3), 80, 50,
                                   true_rank=4, density=0.6, noise=0.01)
    cfg = mf.MFConfig(num_rows=80, num_cols=50, rank=8, lam=0.01)
    state, _ = mf.fit(cfg, A, mask, num_rounds=200, device="cpu")
    R = state["R"].numpy()
    assert np.sqrt((R ** 2).sum() / mask.sum()) < 0.1


def test_als_baseline_converges(problem):
    A, mask = problem
    (_, _), trace = mf.als_fit(A, mask, K, 0.05, 8, device="cpu")
    vals = [v for _, v in trace]
    assert vals[-1] < vals[0] * 0.2
    for a, b in zip(vals, vals[1:]):
        assert b <= a + 1e-3


def test_als_step_matches_jax(problem):
    A, mask = problem
    r = np.random.default_rng(5)
    W = (r.standard_normal((N, K)) / np.sqrt(K)).astype(np.float32)
    H = (r.standard_normal((K, M)) / np.sqrt(K)).astype(np.float32)
    jW, jH = jmf.als_step(jnp.asarray(A), jnp.asarray(mask), jnp.asarray(W),
                          jnp.asarray(H), 0.05)
    tW, tH = mf.als_step(torch.from_numpy(A), torch.from_numpy(mask),
                         torch.from_numpy(W), torch.from_numpy(H), 0.05,
                         chunk=16)
    close(tW, jW, rtol=1e-4)                  # K×K solves in f32
    close(tH, jH, rtol=1e-4)


def test_strads_handles_larger_rank_than_als_budget():
    A, mask = mf.synthetic_ratings(np.random.default_rng(4), 60, 40,
                                   true_rank=6, density=0.5)
    cfg = mf.MFConfig(num_rows=60, num_cols=40, rank=64, lam=0.1)
    _, trace = mf.fit(cfg, A, mask, num_rounds=128, trace_every=127,
                      device="cpu")
    assert trace[-1][1] < trace[0][1]


def test_query_recommends_the_numpy_top_k():
    """The oracle of tests/test_serve.py:134-139."""
    A, mask = mf.synthetic_ratings(np.random.default_rng(3), 12, 10,
                                   true_rank=2)
    cfg = mf.MFConfig(num_rows=12, num_cols=10, rank=3, top_k=4)
    eng = mf.make_engine(cfg, workers=2, device="cpu")
    state = eng.init_state(A=A, mask=mask)
    out = eng.app.query(state, {"user": np.asarray([0, 5, 11], np.int32)})
    assert out["items"].shape == (3, 4)
    flat = eng.unshard(state)
    scores = flat["W"].numpy() @ flat["H"].numpy()
    for b, u in enumerate((0, 5, 11)):
        want = np.argsort(-scores[u])[:4]
        np.testing.assert_array_equal(out["items"][b].numpy(), want)
        np.testing.assert_allclose(out["scores"][b].numpy(),
                                   scores[u][want], rtol=1e-5)


def test_ingest_keeps_the_residual_on_touched_rows(problem):
    A, mask = problem
    cfg = mf.MFConfig(num_rows=N, num_cols=M, rank=K)
    eng = mf.make_engine(cfg, workers=3, device="cpu")
    data = eng.shard_data({"A": A, "mask": mask})
    state = eng.run(eng.init_state(A=A, mask=mask), data, None, 6)
    rows = np.array([2, 33, 59])
    r = np.random.default_rng(9)
    m_new = (r.uniform(size=(3, M)) < 0.5).astype(np.float32)
    A_new = (r.standard_normal((3, M)) * m_new).astype(np.float32)
    before = {k: v.clone() for k, v in state.items()}
    A2, m2 = A.copy(), mask.copy()      # the data shares A's memory here
    A2[rows] = A_new
    m2[rows] = m_new
    new_data, new_state = eng.app.ingest(
        data, state, rows, {"data": {"A": A_new, "mask": m_new}})
    # written in place, only on the rows: the same tensors back
    for k in state:
        assert new_state[k] is state[k]
    for k in data:
        assert new_data[k] is data[k]
    assert torch.equal(new_state["W"], before["W"])
    assert torch.equal(new_state["H"], before["H"])
    fd = {k: v.reshape(N, M) for k, v in new_data.items()}
    fs = eng.unshard(new_state)
    np.testing.assert_array_equal(fd["A"].numpy(), A2)
    np.testing.assert_array_equal(fd["mask"].numpy(), m2)
    W, H = fs["W"].numpy(), fs["H"].numpy()
    np.testing.assert_allclose(fs["R"].numpy()[rows],
                               (A_new - W[rows] @ H) * m_new, atol=1e-5)
    keep = np.setdiff1d(np.arange(N), rows)
    np.testing.assert_array_equal(fs["R"].numpy()[keep],
                                  eng.unshard(before)["R"].numpy()[keep])
    valid = eng.app.ingest_specs()["valid"](new_data)
    np.testing.assert_array_equal(valid.numpy(), m2.any(axis=1))
    assert eng.app.ingest(data, None, rows, {"data": {
        "A": A_new, "mask": m_new}})[1] is None


def test_entry_points_default_to_the_card(problem):
    A, mask = problem
    cfg = mf.MFConfig(num_rows=N, num_cols=M, rank=K)
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mf.make_engine(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mf.fit(cfg, A, mask, num_rounds=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mf.als_fit(A, mask, K, 0.05, 1)
