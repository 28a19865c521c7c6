"""The port's STRADS Lasso round against the JAX package's.

JAX's PRNG streams cannot be drawn in torch, so the port takes the
scheduler's Gumbel noise as an input and these tests feed it the JAX
engine's own per-round draws.  States are compared with atol 1e-5
(f32 sums taken in a different order); schedules must be equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.apps import lasso as jlasso
from repro.core import ExecutionPlan as JPlan
from repro.core import single_device_mesh
from repro_torch import convert
from repro_torch.apps import lasso
from repro_torch.core import EngineCarry, ExecutionPlan
from repro_torch.kernels import KernelSpec
from repro_torch.kernels import lasso_cd as tlc

ATOL = 1e-5   # f32 sums in a different order
N, J, U, UP, RHO, LAM = 64, 40, 4, 12, 0.3, 0.02


@pytest.fixture(scope="module")
def problem():
    X, y, _ = jlasso.synthetic_correlated(np.random.default_rng(0), n=N,
                                          J=J, k_true=4)
    cfg = dict(num_features=J, lam=LAM, block_size=U, num_candidates=UP,
               rho=RHO)
    return X, y, cfg


def jax_draws(rounds: int, J: int, seed: int = 0) -> np.ndarray:
    """The (J,) Gumbel draw of every round of a JAX engine run started
    from ``jax.random.key(seed)``: per round ``rng, sub = split(rng)``
    (engine.py:1230), ``r1, r2 = split(sub)`` (engine.py:603), then
    ``gumbel(r1, (J,))`` (schedulers.py:145)."""
    rng, out = jax.random.key(seed), []
    for _ in range(rounds):
        rng, sub = jax.random.split(rng)
        r1, _ = jax.random.split(sub)
        out.append(np.asarray(jax.random.gumbel(r1, (J,), jnp.float32)))
    return np.stack(out)


def _jax_loop(X, y, cfg, rounds, carry=None, state=None):
    """JAX loop run: per-round (idx, mask, beta, r), the final report."""
    eng = jlasso.make_engine(jlasso.LassoConfig(**cfg), single_device_mesh())
    data = eng.shard_data({"X": jnp.asarray(X), "y": jnp.asarray(y)})
    if state is None:
        state = eng.init_state(jax.random.key(0), y=y)
    log = []

    def cb(t, s, out):
        log.append((np.asarray(out.sched["idx"]),
                    np.asarray(out.sched["mask"]),
                    np.asarray(s["beta"]), np.asarray(s["r"])))
        return False

    rep = eng.execute(state, data, jax.random.key(0),
                      JPlan(executor="loop", rounds=rounds), callback=cb,
                      carry=carry)
    return log, rep


def _port_loop(X, y, cfg, rounds, workers=1, kernels=None):
    eng = lasso.make_engine(lasso.LassoConfig(**cfg), workers=workers,
                            device="cpu")
    data = eng.shard_data({"X": X, "y": y})
    state = eng.init_state(y=y)
    draws = jax_draws(rounds, J)
    log = []

    def cb(t, s, out):
        log.append((out.sched["idx"].numpy(), out.sched["mask"].numpy(),
                    s["beta"].numpy(), s["r"].reshape(-1).numpy()))
        return False

    rep = eng.execute(state, data, None,
                      ExecutionPlan(executor="loop", rounds=rounds,
                                    kernels=kernels),
                      callback=cb, noise=lambda t: draws[t])
    return log, rep


def test_soft_threshold():
    out = lasso.soft_threshold(torch.tensor([-2.0, -0.5, 0.0, 0.5, 2.0]),
                               1.0)
    np.testing.assert_array_equal(
        out.numpy(), np.asarray(jlasso.soft_threshold(
            jnp.asarray([-2.0, -0.5, 0.0, 0.5, 2.0]), 1.0)))


def test_synthetic_correlated_is_the_same_design(problem):
    X, y, _ = problem
    X2, y2, _ = lasso.synthetic_correlated(np.random.default_rng(0), n=N,
                                           J=J, k_true=4)
    np.testing.assert_array_equal(X2, X)
    np.testing.assert_array_equal(y2, y)


@pytest.mark.parametrize("workers", [1, 4])
def test_one_round_with_a_fixed_schedule_matches_push_and_pull(problem,
                                                               workers):
    X, y, cfg = problem
    r = np.random.default_rng(1)
    beta = (r.standard_normal(J) * 0.1).astype(np.float32)
    res = (y - X @ beta).astype(np.float32)
    idx = np.array([3, 17, 5, 30], np.int64)
    mask = np.array([True, True, False, True])

    japp = jlasso.StradsLasso(jlasso.LassoConfig(**cfg))
    jstate = {"beta": jnp.asarray(beta), "r": jnp.asarray(res)}
    jdata = {"X": jnp.asarray(X), "y": jnp.asarray(y)}
    jsched = {"idx": jnp.asarray(idx, jnp.int32), "mask": jnp.asarray(mask)}
    jz, _ = japp.push(jdata, jstate, jsched, 0)
    jout = japp.pull(jstate, jsched, jz, None, jdata, 0)

    eng = lasso.make_engine(lasso.LassoConfig(**cfg), workers=workers,
                            device="cpu")
    data = eng.shard_data({"X": X, "y": y})
    state = {"beta": torch.from_numpy(beta),
             "r": torch.from_numpy(res).reshape(workers, -1)}
    sched = {"idx": torch.from_numpy(idx), "mask": torch.from_numpy(mask)}
    z, _ = eng.app.push(data, state, sched, 0)
    assert z.shape == (workers, U)
    z = z.sum(0)
    out = eng.app.pull(state, sched, z, None, data, 0)
    np.testing.assert_allclose(z.numpy(), np.asarray(jz), atol=ATOL)
    np.testing.assert_allclose(out["beta"].numpy(), np.asarray(jout["beta"]),
                               atol=ATOL)
    np.testing.assert_allclose(out["r"].reshape(-1).numpy(),
                               np.asarray(jout["r"]), atol=ATOL)


@pytest.mark.parametrize("workers", [1, 4])
@pytest.mark.parametrize("kind", ["reference", "pallas"])
def test_dynamic_priority_trajectory_matches_on_loop(problem, workers, kind):
    X, y, cfg = problem
    R = 8
    jlog, _ = _jax_loop(X, y, cfg, R)
    spec = (KernelSpec(kind="reference") if kind == "reference"
            else KernelSpec.default_for("pallas"))
    tlog, rep = _port_loop(X, y, cfg, R, workers=workers, kernels=spec)
    assert len(tlog) == len(jlog) == R and rep.carry.t == R
    for t, (jr, tr) in enumerate(zip(jlog, tlog)):
        np.testing.assert_array_equal(tr[0], jr[0], err_msg=f"idx, round {t}")
        np.testing.assert_array_equal(tr[1], jr[1], err_msg=f"mask, round {t}")
        np.testing.assert_allclose(tr[2], jr[2], atol=ATOL)
        np.testing.assert_allclose(tr[3], jr[3], atol=ATOL)


def test_dynamic_priority_trajectory_matches_on_scan(problem):
    X, y, cfg = problem
    R = 8
    jeng = jlasso.make_engine(jlasso.LassoConfig(**cfg),
                              single_device_mesh())
    jdata = jeng.shard_data({"X": jnp.asarray(X), "y": jnp.asarray(y)})
    jstate = jeng.init_state(jax.random.key(0), y=y)
    jrep = jeng.execute(jstate, jdata, jax.random.key(0),
                        JPlan(executor="scan", rounds=R, donate=False),
                        collect=lambda s: s)
    draws = jax_draws(R, J)
    eng = lasso.make_engine(lasso.LassoConfig(**cfg), device="cpu")
    rep = eng.execute(eng.init_state(y=y), eng.shard_data({"X": X, "y": y}),
                      None, ExecutionPlan(executor="scan", rounds=R),
                      collect=lambda s: s, noise=lambda t: draws[t])
    assert rep.trace["beta"].shape == (R, J)
    np.testing.assert_allclose(rep.trace["beta"].numpy(),
                               np.asarray(jrep.trace["beta"]), atol=ATOL)
    np.testing.assert_allclose(rep.trace["r"].reshape(R, -1).numpy(),
                               np.asarray(jrep.trace["r"]), atol=ATOL)
    np.testing.assert_allclose(rep.carry.sched_carry.numpy(),
                               np.asarray(jrep.carry.sched_carry), atol=ATOL)


@pytest.mark.parametrize("scheduler", ["strads", "rr", "cyclic"])
def test_port_loop_equals_port_scan_bit_exactly(problem, scheduler):
    X, y, cfg = problem
    cfg = dict(cfg, scheduler=scheduler)
    out = {}
    for ex in ("loop", "scan"):
        gen = torch.Generator().manual_seed(5)
        plan = ExecutionPlan(executor=ex, rounds=7, workers=4,
                             kernels=KernelSpec.default_for("pallas"))
        out[ex] = lasso.fit(lasso.LassoConfig(**cfg), X, y, generator=gen,
                            plan=plan, device="cpu")[0]
    for k in ("beta", "r"):
        assert torch.equal(out["loop"][k], out["scan"][k])


def test_converges_near_reference_cd():
    r = np.random.default_rng(0)
    X, y, _ = lasso.synthetic_correlated(r, n=150, J=60, k_true=5)
    cfg = lasso.LassoConfig(num_features=60, lam=LAM, block_size=8,
                            num_candidates=32, rho=0.3, eta=1e-2)
    state, trace = lasso.fit(cfg, X, y, num_rounds=400, trace_every=399,
                             device="cpu")
    ref = lasso.reference_cd(X, y, LAM, 100)

    def obj(b):
        return 0.5 * np.sum((y - X @ b) ** 2) + LAM * np.sum(np.abs(b))

    got = obj(state["beta"].numpy())
    assert got <= obj(ref) * 1.05 + 1e-6     # within 5% of the CD optimum
    assert np.isclose(trace[-1][1], got, rtol=1e-4)


def test_jax_run_converted_mid_way_continues_identically(problem):
    X, y, cfg = problem
    R1, R = 4, 8
    jlog, _ = _jax_loop(X, y, cfg, R)
    _, jrep = _jax_loop(X, y, cfg, R1)
    state, data, carry = convert.lasso_from_jax(
        {k: np.asarray(v) for k, v in jrep.state.items()}, X, y,
        sched_carry=np.asarray(jrep.carry.sched_carry),
        t=int(jrep.carry.t), workers=2, device="cpu")
    assert isinstance(carry, EngineCarry) and carry.t == R1
    draws = jax_draws(R, J)
    eng = lasso.make_engine(lasso.LassoConfig(**cfg), workers=2,
                            device="cpu")
    tlog = []
    rep = eng.execute(state, data, None,
                      ExecutionPlan(executor="loop", rounds=R), carry=carry,
                      noise=lambda t: draws[t],
                      callback=lambda t, s, out: tlog.append(
                          (t, out.sched["idx"].numpy(), s["beta"].numpy())))
    assert [t for t, *_ in tlog] == list(range(R1, R))
    for t, idx, beta in tlog:
        np.testing.assert_array_equal(idx, jlog[t][0])
        np.testing.assert_allclose(beta, jlog[t][2], atol=ATOL)
    np.testing.assert_allclose(rep.state["r"].reshape(-1).numpy(),
                               jlog[-1][3], atol=ATOL)


def test_four_workers_give_the_same_z_and_gram_as_one(problem, monkeypatch):
    X, y, cfg = problem
    seen = {}

    def recording(name, fn):
        def wrapped(*a, **kw):
            out = fn(*a, **kw)
            seen.setdefault(a[0].shape[0], {}).setdefault(name, []).append(
                out.sum(0))
            return out
        return wrapped

    for name in ("lasso_partial", "gram_block"):
        monkeypatch.setattr(tlc, name, recording(name, getattr(tlc, name)))
    logs = {W: _port_loop(X, y, cfg, 6, workers=W,
                          kernels=KernelSpec.default_for("pallas"))[0]
            for W in (1, 4)}
    for a, b in zip(logs[1], logs[4]):
        np.testing.assert_array_equal(a[0], b[0])
    for name in ("lasso_partial", "gram_block"):
        assert len(seen[1][name]) == len(seen[4][name]) == 6
        for a, b in zip(seen[1][name], seen[4][name]):
            torch.testing.assert_close(b, a, rtol=0, atol=ATOL)


def test_execute_rejects_what_is_not_ported(problem):
    X, y, cfg = problem
    eng = lasso.make_engine(lasso.LassoConfig(**cfg), workers=2,
                            device="cpu")
    data = eng.shard_data({"X": X, "y": y})
    state = eng.init_state(y=y)
    from repro_torch.part import PartitionerSpec
    with pytest.raises(TypeError, match="stream= wants a StreamSpec"):
        eng.execute(state, data, None, ExecutionPlan(rounds=2),
                    stream=object(), source=object())
    with pytest.raises(ValueError, match="plan.workers=4"):
        eng.execute(state, data, None, ExecutionPlan(rounds=2, workers=4))
    with pytest.raises(ValueError, match="split evenly"):
        lasso.make_engine(lasso.LassoConfig(**cfg), workers=3,
                          device="cpu").shard_data({"X": X})
    with pytest.raises(ValueError, match="callback"):
        eng.execute(state, data, None, ExecutionPlan(rounds=2),
                    callback=lambda *a: False)
    rep = eng.execute(state, data, None,
                      ExecutionPlan(rounds=2, partitioner=PartitionerSpec(
                          kind="static")))
    assert rep.carry.t == 2


def test_generator_state_rides_the_carry(problem):
    X, y, cfg = problem
    eng = lasso.make_engine(lasso.LassoConfig(**cfg), device="cpu")
    data = eng.shard_data({"X": X, "y": y})
    whole = eng.execute(eng.init_state(y=y), data,
                        torch.Generator().manual_seed(3),
                        ExecutionPlan(executor="scan", rounds=6))
    half = eng.execute(eng.init_state(y=y), data,
                       torch.Generator().manual_seed(3),
                       ExecutionPlan(executor="scan", rounds=3))
    rest = eng.execute(half.state, data, torch.Generator(),
                       ExecutionPlan(executor="scan", rounds=6),
                       carry=half.carry)
    ran = eng.run(eng.init_state(y=y), data,
                  torch.Generator().manual_seed(3), 6)
    for k in ("beta", "r"):
        assert torch.equal(rest.state[k], whole.state[k])
        assert torch.equal(ran[k], whole.state[k])


def test_entry_points_default_to_the_card(problem):
    X, y, cfg = problem
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lasso.make_engine(lasso.LassoConfig(**cfg))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lasso.fit(lasso.LassoConfig(**cfg), X, y, num_rounds=1)
