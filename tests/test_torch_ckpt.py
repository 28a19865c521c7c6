"""The port's pipelined executor, checkpoint-chunked runs and resumes
against the JAX package's (``tests/test_ckpt_resume.py``,
``tests/test_part.py``, ``tests/test_engine_scan.py``).

Pipelined parity feeds the port the JAX engine's own scheduler draws
(``test_torch_lasso.jax_draws``; at depth 1 round t takes the t-th draw,
as at depth 0, and the last prefetch takes one more) and LDA the JAX
sampler's Gibbs draws.  Tolerances: Lasso's β and r within 1e-5 (f32
sums in another order), MF's objective within 1e-5 relative, LDA's
integer counts to the bit.  Port against port — chunked against
uninterrupted, resumed from the files against uninterrupted, pipelined
against scan where the schedule reads no state — is to the bit.  Error
texts are compared with the JAX package's own where both packages have
the rule.
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
from repro.part import PartitionerSpec as JPartSpec
from repro_torch import convert
from repro_torch.apps import lasso, lda, mf
from repro_torch.checkpoint import (latest_step, load_flat,
                                    restore_checkpoint)
from repro_torch.core import EngineCarry, ExecutionPlan
from repro_torch.kernels import KernelSpec
from repro_torch.kernels import lasso_cd as tlc
from repro_torch.part import (Assignment, PartitionerSpec,
                              contiguous_assignment)
from test_torch_lasso import jax_draws
from test_torch_lda import CFG1, CFG4, _corpus, jax_noise

ATOL = 1e-5          # Lasso β, r: f32 sums in another order
RTOL = 1e-5          # MF objective, relative
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
    for k in a:
        assert torch.equal(a[k], b[k]), k


# ---------------------------------------------------------------------------
# Pipelined parity with the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("workers", [1, 4])
def test_pipelined_lasso_matches_jax_every_round(lasso_problem, workers,
                                                 monkeypatch):
    """β and r every round within ATOL of the JAX depth-1 scan, the same
    schedules, the same prefetched schedule in the carry; round 0 runs
    depth 0's schedule; a fresh run makes R + 1 Gram blocks for R
    pushes."""
    X, y = lasso_problem
    R = 8
    jeng = jlasso.make_engine(jlasso.LassoConfig(**LASSO),
                              single_device_mesh())
    jdata = jeng.shard_data({"X": jnp.asarray(X), "y": jnp.asarray(y)})
    jrep = jeng.execute(jeng.init_state(jax.random.key(0), y=y), jdata,
                        jax.random.key(0),
                        JPlan(executor="pipelined", rounds=R, donate=False),
                        collect=lambda s: s)
    calls = {"lasso_partial": [], "gram_block": []}
    for name in calls:
        def wrapped(*a, _fn=getattr(tlc, name), _name=name, **kw):
            calls[_name].append(a[0].shape)
            return _fn(*a, **kw)
        monkeypatch.setattr(tlc, name, wrapped)
    draws = jax_draws(R + 1, J)
    eng = lasso.make_engine(lasso.LassoConfig(**LASSO), workers=workers,
                            device="cpu")
    ran = []
    push = eng.app.push
    eng.app.push = lambda d, s, sched, ph: (ran.append(sched), push(
        d, s, sched, ph))[1]
    rep = eng.execute(eng.init_state(y=y), eng.shard_data({"X": X, "y": y}),
                      None, ExecutionPlan(
                          executor="pipelined", rounds=R,
                          kernels=KernelSpec.default_for("pallas")),
                      collect=lambda s: s, noise=lambda t: draws[t])
    np.testing.assert_allclose(rep.trace["beta"].numpy(),
                               np.asarray(jrep.trace["beta"]), atol=ATOL)
    np.testing.assert_allclose(rep.trace["r"].reshape(R, -1).numpy(),
                               np.asarray(jrep.trace["r"]), atol=ATOL)
    np.testing.assert_allclose(rep.carry.sched_carry.numpy(),
                               np.asarray(jrep.carry.sched_carry), atol=ATOL)
    for k in ("idx", "mask"):
        np.testing.assert_array_equal(rep.carry.sched[k].numpy(),
                                      np.asarray(jrep.carry.sched[k]))
    assert rep.carry.t == R and rep.carry.depth == 1
    assert len(calls["gram_block"]) == R + 1
    assert len(calls["lasso_partial"]) == R
    # round 0's schedule is depth 0's (the first draw, the fresh carry)
    sc = eng.init_sched_carry()
    first = eng.run_round(eng.init_state(y=y),
                          eng.shard_data({"X": X, "y": y}), None, 0,
                          sched_carry=sc, noise=lambda t: draws[t]).sched
    for k in ("idx", "mask"):
        assert torch.equal(ran[0][k], first[k])
    # staleness shows: scan on the same draws pushes another schedule in
    # some round, so an executor that scheduled after the update fails
    ran_scan = []
    eng.app.push = lambda d, s, sched, ph: (ran_scan.append(sched), push(
        d, s, sched, ph))[1]
    eng.execute(eng.init_state(y=y), eng.shard_data({"X": X, "y": y}),
                None, ExecutionPlan(executor="scan", rounds=R,
                                    kernels=KernelSpec.default_for("pallas")),
                noise=lambda t: draws[t])
    assert len(ran_scan) == R
    differs = [t for t in range(R)
               if not all(torch.equal(ran[t][k], ran_scan[t][k])
                          for k in ("idx", "mask"))]
    assert differs and differs[0] > 0, differs


def test_pipelined_mf_matches_jax_and_equals_scan(mf_problem):
    """MF's round-robin schedule reads no state: pipelined equals the
    port's scan to the bit, and its objective trace is the JAX
    pipelined run's within RTOL."""
    A, mask = mf_problem
    R = 8
    jcfg = jmf.MFConfig(**MF_SIZE)
    jeng = jmf.make_engine(jcfg, single_device_mesh())
    jst = jeng.init_state(jax.random.key(0), A=jnp.asarray(A),
                          mask=jnp.asarray(mask))
    jstate = {k: np.asarray(v) for k, v in jst.items()}
    jrep = jeng.execute(jst, jeng.shard_data({"A": jnp.asarray(A),
                                              "mask": jnp.asarray(mask)}),
                        jax.random.key(0),
                        JPlan(executor="pipelined", rounds=R),
                        collect=jeng.app.objective_collect())
    out = {}
    for ex in ("pipelined", "scan"):
        eng = mf.make_engine(mf.MFConfig(**MF_SIZE), workers=2,
                             device="cpu")
        state, data, _ = convert.mf_from_jax(jstate, A, mask, workers=2,
                                             device="cpu")
        out[ex] = eng.execute(state, data, None,
                              ExecutionPlan(executor=ex, rounds=R),
                              collect=eng.app.objective_collect())
    _equal(out["pipelined"].state, out["scan"].state)
    assert torch.equal(out["pipelined"].trace, out["scan"].trace)
    np.testing.assert_allclose(out["pipelined"].trace.numpy(),
                               np.asarray(jrep.trace), rtol=RTOL)
    np.testing.assert_allclose(out["pipelined"].state["H"].numpy(),
                               np.asarray(jrep.state["H"]), rtol=0,
                               atol=RTOL * np.abs(jrep.state["H"]).max())


def test_pipelined_lda_matches_jax_to_the_bit():
    """One worker against the JAX pipelined executor, fed its draws: z,
    D, B, s equal to the bit.  Four workers: the rotation reads no
    state, so pipelined equals scan to the bit."""
    words, docs, z0 = _corpus(CFG1)
    R = 3
    cfg = jlda.LDAConfig(**CFG1)
    jeng = jlda.make_engine(cfg, single_device_mesh())
    jdata = jeng.shard_data({"words": jnp.asarray(words),
                             "docs": jnp.asarray(docs)})
    jrep = jeng.execute(jeng.init_state(jax.random.key(0), words=words,
                                        docs=docs, z0=z0),
                        jdata, jax.random.key(0),
                        JPlan(executor="pipelined", rounds=R))
    eng = lda.make_engine(lda.LDAConfig(**CFG1), device="cpu",
                          noise=jax_noise(CFG1))
    rep = eng.execute(eng.init_state(words=words, docs=docs, z0=z0),
                      eng.shard_data({"words": words, "docs": docs}), None,
                      ExecutionPlan(executor="pipelined", rounds=R))
    got = eng.unshard(rep.state)
    for k in ("z", "D", "B", "s", "s_err"):
        np.testing.assert_array_equal(got[k].numpy(),
                                      np.asarray(jrep.state[k]))
    assert rep.carry.depth == 1 and rep.carry.sched is None

    words, docs, z0 = _corpus(CFG4)
    out = {ex: lda.fit(lda.LDAConfig(**CFG4), words, docs, z0,
                       plan=ExecutionPlan(executor=ex, rounds=4,
                                          collect_every=1), device="cpu")
           for ex in ("pipelined", "scan")}
    _equal(out["pipelined"][0], out["scan"][0])
    assert out["pipelined"][1:] == out["scan"][1:]


# ---------------------------------------------------------------------------
# Chunked and resumed runs equal uninterrupted ones
# ---------------------------------------------------------------------------

def _app(name, lasso_problem, mf_problem):
    """(engine factory, data, fresh-state factory, generator factory)."""
    if name == "lasso":
        X, y = lasso_problem

        def make():
            return lasso.make_engine(lasso.LassoConfig(**LASSO), workers=2,
                                     device="cpu")
        return (make, lambda e: e.shard_data({"X": X, "y": y}),
                lambda e: e.init_state(y=y),
                lambda: torch.Generator().manual_seed(7))
    if name == "mf":
        A, mask = mf_problem

        def make():
            return mf.make_engine(mf.MFConfig(**MF_SIZE), workers=2,
                                  device="cpu")
        return (make, lambda e: e.shard_data({"A": A, "mask": mask}),
                lambda e: e.init_state(A=A, mask=mask), lambda: None)
    words, docs, z0 = _corpus(CFG4)

    def make():
        return lda.make_engine(lda.LDAConfig(**CFG4), device="cpu")
    return (make, lambda e: e.shard_data({"words": words, "docs": docs}),
            lambda e: e.init_state(words=words, docs=docs, z0=z0),
            lambda: None)


@pytest.mark.parametrize("executor", ["loop", "scan", "pipelined"])
@pytest.mark.parametrize("app", ["lasso", "mf", "lda"])
def test_chunked_and_resumed_runs_equal_the_uninterrupted_one(
        app, executor, lasso_problem, mf_problem, tmp_path):
    make, shard, fresh, gen = _app(app, lasso_problem, mf_problem)
    R, C = 8, 4
    eng = make()
    data = shard(eng)
    whole = eng.execute(fresh(eng), data, gen(),
                        ExecutionPlan(executor=executor, rounds=R))
    plan = ExecutionPlan(executor=executor, rounds=R, checkpoint_every=C)
    chunked = eng.execute(fresh(eng), data, gen(), plan,
                          ckpt_dir=str(tmp_path))
    _equal(whole.state, chunked.state)
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "step_00000004.npz", "step_00000008.npz"]
    assert chunked.carry.t == R and whole.carry.t == R
    assert chunked.carry.depth == whole.carry.depth == (
        executor == "pipelined")
    # a fresh engine resumed from the middle file
    eng2 = make()
    template = {"state": fresh(eng2), "carry": chunked.carry,
                "assignment": eng.partition_payload()}
    back = restore_checkpoint(str(tmp_path), C, template)
    assert back["carry"].t == C
    resumed = eng2.execute(back["state"], shard(eng2), torch.Generator(),
                           plan, carry=back["carry"],
                           partition=back["assignment"],
                           ckpt_dir=str(tmp_path / "resumed"))
    _equal(whole.state, resumed.state)
    if whole.carry.sched_carry is not None:
        assert torch.equal(whole.carry.sched_carry,
                           resumed.carry.sched_carry)
    if whole.carry.rng_state is not None:
        assert torch.equal(whole.carry.rng_state, resumed.carry.rng_state)


def _skewed_lasso(workers: int):
    """Column activity concentrated on a contiguous hot block, as
    ``tests/test_part.py::_skewed_lasso``."""
    rng = np.random.default_rng(0)
    n, J_ = 80, 32
    X = rng.normal(size=(n, J_)).astype(np.float32)
    X -= X.mean(axis=0)
    X /= np.maximum(np.linalg.norm(X, axis=0), 1e-12)
    bstar = np.zeros((J_,), np.float32)
    bstar[:8] = 5.0 * np.arange(1, 9, dtype=np.float32) ** -1.2
    y = (X @ bstar).astype(np.float32)
    y -= y.mean()
    cfg = lasso.LassoConfig(num_features=J_, lam=0.01, block_size=4,
                            num_candidates=8)
    eng = lasso.make_engine(cfg, workers=workers, device="cpu")
    return eng, eng.shard_data({"X": X, "y": y}), y


def test_rebalance_fires_and_replays_on_resume(tmp_path):
    """A mid-run load_balanced rebalance on four workers, resumed from
    the ``{"state", "carry", "assignment"}`` checkpoint: the final state,
    assignment and EMA equal the uninterrupted run's."""
    spec = PartitionerSpec(kind="load_balanced", ema=0.5,
                           imbalance_threshold=0.1)
    plan = ExecutionPlan(executor="scan", rounds=8, checkpoint_every=2,
                         partitioner=spec)
    eng, data, y = _skewed_lasso(4)
    rep = eng.execute(eng.init_state(y=y), data,
                      torch.Generator().manual_seed(1), plan,
                      ckpt_dir=str(tmp_path))
    final, ema = eng.partition_assignment, eng.partition_stats["ema"]
    payload = eng.partition_payload()
    assert final.version > 0
    # each move lowers the load spread on the EMA it was proposed from
    prev = contiguous_assignment(32, 4)
    for t in (2, 4, 6):
        flat = load_flat(str(tmp_path), t)
        own = Assignment.from_payload(
            {k: flat[f"assignment/{k}"]
             for k in ("owner", "num_workers", "version")})
        if own.owner != prev.owner:
            w = flat["assignment/stats_ema"]
            assert own.version == prev.version + 1
            assert own.spread(w) < prev.spread(w)
        prev = own
    assert prev == final
    assert {"assignment/owner", "assignment/num_workers",
            "assignment/version", "assignment/stats_ema", "carry/.t",
            "carry/.rng_state", "carry/.sched_carry"} <= set(
                load_flat(str(tmp_path), 8))
    # the static run is the same math: ownership is bookkeeping
    static = eng.execute(eng.init_state(y=y), data,
                         torch.Generator().manual_seed(1),
                         ExecutionPlan(executor="scan", rounds=8))
    _equal(rep.state, static.state)
    eng2, data2, _ = _skewed_lasso(4)
    eng2.set_partitioner(spec)
    back = restore_checkpoint(str(tmp_path), 4, {
        "state": eng2.init_state(y=y), "carry": rep.carry,
        "assignment": payload})
    resumed = eng2.execute(back["state"], data2, None, plan,
                           carry=back["carry"],
                           partition=back["assignment"],
                           ckpt_dir=str(tmp_path / "resumed"))
    _equal(rep.state, resumed.state)
    assert eng2.partition_assignment == final
    np.testing.assert_array_equal(eng2.partition_stats["ema"], ema)
    # a fresh execute starts the partition trajectory over
    again = eng.execute(eng.init_state(y=y), data,
                        torch.Generator().manual_seed(1), plan,
                        ckpt_dir=str(tmp_path / "again"))
    assert eng.partition_assignment == final
    _equal(rep.state, again.state)


def test_checkpoint_from_jax_continues_a_pipelined_run(lasso_problem,
                                                       tmp_path):
    """A JAX pipelined run saved at t = 8 continues in the port (fed the
    JAX draws) to the JAX run's β and r at t = 16 within ATOL."""
    X, y = lasso_problem
    R = 16
    jeng = jlasso.make_engine(jlasso.LassoConfig(**LASSO),
                              single_device_mesh())
    jdata = jeng.shard_data({"X": jnp.asarray(X), "y": jnp.asarray(y)})
    jrep = jeng.execute(jeng.init_state(jax.random.key(0), y=y), jdata,
                        jax.random.key(0),
                        JPlan(executor="pipelined", rounds=R,
                              checkpoint_every=8),
                        ckpt_dir=str(tmp_path))
    flat = jload_flat(str(tmp_path), 8)
    eng = lasso.make_engine(lasso.LassoConfig(**LASSO), workers=2,
                            device="cpu")
    state, carry, partition = convert.checkpoint_from_jax(flat, eng)
    assert isinstance(carry, EngineCarry)
    assert carry.t == 8 and carry.depth == 1 and carry.rng_state is None
    assert carry.sched["idx"].dtype == torch.int64
    assert state["r"].shape == (2, N // 2)
    assert set(partition) == {"owner", "num_workers", "version"}
    # the JAX run's assignment spans its one worker: it resumes a
    # one-worker engine, and the two-worker run starts its own
    with pytest.raises(ValueError, match="spans 1 workers"):
        eng.restore_partition(partition)
    one = lasso.make_engine(lasso.LassoConfig(**LASSO), device="cpu")
    one.restore_partition(partition)
    assert one.partition_assignment == contiguous_assignment(J, 1)
    draws = jax_draws(R + 1, J)
    rep = eng.execute(state, eng.shard_data({"X": X, "y": y}), None,
                      ExecutionPlan(executor="pipelined", rounds=R),
                      carry=carry, noise=lambda t: draws[t])
    np.testing.assert_allclose(rep.state["beta"].numpy(),
                               np.asarray(jrep.state["beta"]), atol=ATOL)
    np.testing.assert_allclose(rep.state["r"].reshape(-1).numpy(),
                               np.asarray(jrep.state["r"]), atol=ATOL)
    assert load_flat(str(tmp_path), 8).keys() == flat.keys()


# ---------------------------------------------------------------------------
# Error paths, with the JAX package's texts
# ---------------------------------------------------------------------------

def _both(lasso_problem):
    X, y = lasso_problem
    jeng = jlasso.make_engine(jlasso.LassoConfig(**LASSO),
                              single_device_mesh())
    jdata = jeng.shard_data({"X": jnp.asarray(X), "y": jnp.asarray(y)})
    eng = lasso.make_engine(lasso.LassoConfig(**LASSO), device="cpu")
    return ((jeng, jdata, jeng.init_state(jax.random.key(0), y=y)),
            (eng, eng.shard_data({"X": X, "y": y}), eng.init_state(y=y)))


@pytest.mark.parametrize("plan_kw,ckpt", [
    (dict(executor="scan", rounds=4), True),              # no cadence
    (dict(executor="scan", rounds=4, checkpoint_every=2), False),
    (dict(executor="scan", rounds=8, phase_unroll=2,
          checkpoint_every=3), True),                     # misaligned
    (dict(executor="pipelined", rounds=7, phase_unroll=2,
          checkpoint_every=2), True),                     # final chunk
    (dict(executor="scan", rounds=8, checkpoint_every=4,
          partitioner="rebalance_every=6"), True),
])
def test_rejections_carry_the_jax_texts(lasso_problem, tmp_path, plan_kw,
                                        ckpt):
    (jeng, jdata, jst), (eng, data, st) = _both(lasso_problem)
    kw = dict(plan_kw)
    if kw.get("partitioner"):
        part = dict(kind="load_balanced", ema=0.5, rebalance_every=6)
        jkw = dict(kw, partitioner=JPartSpec(**part))
        kw["partitioner"] = PartitionerSpec(**part)
    else:
        jkw = kw
    with pytest.raises(ValueError) as want:
        jeng.execute(jst, jdata, jax.random.key(1), JPlan(**jkw),
                     ckpt_dir=str(tmp_path / "jax") if ckpt else None)
    with pytest.raises(ValueError, match=re.escape(str(want.value))):
        eng.execute(st, data, None, ExecutionPlan(**kw),
                    ckpt_dir=str(tmp_path / "port") if ckpt else None)
    assert latest_step(str(tmp_path / "port")) is None


def test_pipelined_rounds_rule_and_foreign_carries(lasso_problem,
                                                   mf_problem):
    A, mask = mf_problem
    jeng = jmf.make_engine(jmf.MFConfig(**MF_SIZE), single_device_mesh())
    jst = jeng.init_state(jax.random.key(0), A=jnp.asarray(A),
                          mask=jnp.asarray(mask))
    jdata = jeng.shard_data({"A": jnp.asarray(A), "mask": jnp.asarray(mask)})
    with pytest.raises(ValueError) as want:
        jeng.execute(jst, jdata, jax.random.key(0),
                     JPlan(executor="pipelined", rounds=3))
    meng = mf.make_engine(mf.MFConfig(**MF_SIZE), device="cpu")
    with pytest.raises(ValueError, match=re.escape(str(want.value))):
        meng.execute(meng.init_state(A=A, mask=mask),
                     meng.shard_data({"A": A, "mask": mask}), None,
                     ExecutionPlan(executor="pipelined", rounds=3))
    _, (eng, data, st) = _both(lasso_problem)
    scan = eng.execute(st, data, None, ExecutionPlan(executor="scan",
                                                     rounds=2))
    pipe = eng.execute(st, data, None, ExecutionPlan(executor="pipelined",
                                                     rounds=2))
    with pytest.raises(ValueError, match="in-flight schedule"):
        eng.execute(st, data, None, ExecutionPlan(executor="pipelined",
                                                  rounds=4),
                    carry=scan.carry)
    for ex in ("scan", "loop"):
        with pytest.raises(ValueError, match="pipelined executor"):
            eng.execute(st, data, None, ExecutionPlan(executor=ex,
                                                      rounds=4),
                        carry=pipe.carry)


def test_chunked_loop_honors_callback_early_stop(lasso_problem, tmp_path):
    _, (eng, data, st) = _both(lasso_problem)
    plan = ExecutionPlan(executor="loop", rounds=6, checkpoint_every=2)
    for stop_at, d in ((2, tmp_path / "mid"), (1, tmp_path / "boundary")):
        seen = []
        rep = eng.execute(st, data, None, plan, ckpt_dir=str(d),
                          callback=lambda t, s, o: (seen.append(t),
                                                    t == stop_at)[1])
        assert seen == list(range(stop_at + 1))
        assert rep.carry.t == stop_at + 1
        assert latest_step(str(d)) == stop_at + 1
