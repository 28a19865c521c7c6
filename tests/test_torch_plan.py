"""Plans and specs mean the same in both packages: every checked-in plan
parses to the same dict, the defaults tables agree, and invalid
combinations raise in both."""
import glob
import json
import os

import pytest

import repro.core as jcore
import repro.kernels as jkern
import repro.obs as jobs
import repro.part as jpart
import repro.sched as jsched
import repro_torch.core as tcore
import repro_torch.kernels as tkern
import repro_torch.obs as tobs
import repro_torch.part as tpart
import repro_torch.sched as tsched

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PLANS = sorted(glob.glob(os.path.join(ROOT, "examples", "plans", "*.json")))


def test_every_example_plan_is_found():
    assert len(PLANS) >= 8


@pytest.mark.parametrize("path", PLANS, ids=os.path.basename)
def test_example_plan_parses_to_the_same_dict(path):
    with open(path) as f:
        raw = json.load(f)
    want = jcore.ExecutionPlan.from_json(raw).to_json()
    plan = tcore.ExecutionPlan.from_json(raw)
    assert plan.to_json() == want == raw
    assert tcore.ExecutionPlan.from_json(json.dumps(want)) == plan


# tests/test_plan.py's invalid combinations
@pytest.mark.parametrize("kw", [
    dict(executor="scan", staleness=1),
    dict(executor="scan", pipeline_depth=1),
    dict(executor="pipelined", pipeline_depth=0),
    dict(executor="scan", rounds=0),
    dict(executor="scan", rounds=1, staleness=-1),
    dict(executor="loop", rounds=4, phase_unroll=2),
    dict(executor="ssp", rounds=4, phase_unroll=2),
    dict(executor="scan", rounds=4, telemetry="counters"),
    dict(executor="scan", rounds=4, workers=0),
    dict(executor="scan", rounds=4, collect_every=-1),
    dict(executor="warp", rounds=4),
])
def test_invalid_plans_raise_in_both(kw):
    with pytest.raises(ValueError) as jerr:
        jcore.ExecutionPlan(**kw)
    with pytest.raises(ValueError) as terr:
        tcore.ExecutionPlan(**kw)
    assert str(terr.value).replace("repro_torch.", "repro.") \
        == str(jerr.value)


SPECS = [(jsched.SchedulerSpec, tsched.SchedulerSpec, k)
         for k in jsched.SCHEDULER_KINDS] + \
        [(jpart.PartitionerSpec, tpart.PartitionerSpec, k)
         for k in jpart.PARTITIONER_KINDS] + \
        [(jkern.KernelSpec, tkern.KernelSpec, k) for k in jkern.KERNEL_KINDS] + \
        [(jobs.TelemetrySpec, tobs.TelemetrySpec, k)
         for k in jobs.TELEMETRY_KINDS]


@pytest.mark.parametrize("jcls,tcls,kind", SPECS,
                         ids=[f"{j.__name__}-{k}" for j, _, k in SPECS])
def test_spec_defaults_and_json_agree(jcls, tcls, kind):
    want = jcls.default_for(kind).to_json()
    spec = tcls.default_for(kind)
    assert spec.to_json() == want
    assert tcls.from_json(json.dumps(want)) == spec


@pytest.mark.parametrize("jcls,tcls,kw", [
    (jsched.SchedulerSpec, tsched.SchedulerSpec,
     dict(kind="dynamic_priority", block_size=8, num_candidates=4, rho=0.3)),
    (jsched.SchedulerSpec, tsched.SchedulerSpec,
     dict(kind="random", block_size=8, rho=0.3)),
    (jsched.SchedulerSpec, tsched.SchedulerSpec, dict(kind="greedy")),
    (jpart.PartitionerSpec, tpart.PartitionerSpec,
     dict(kind="static", ema=0.5)),
    (jkern.KernelSpec, tkern.KernelSpec, dict(kind="pallas")),
    (jkern.KernelSpec, tkern.KernelSpec, dict(kind="reference", block_n=8)),
    (jobs.TelemetrySpec, tobs.TelemetrySpec,
     dict(kind="counters", profiler=True)),
])
def test_invalid_specs_raise_in_both(jcls, tcls, kw):
    with pytest.raises(ValueError):
        jcls(**kw)
    with pytest.raises(ValueError):
        tcls(**kw)


@pytest.fixture(scope="module")
def lasso_problem():
    """The correlated design at a small size that every checked-in plan
    can schedule (``lasso_dyn_rho03.json`` proposes U′ = 128)."""
    import numpy as np
    from repro_torch.apps import lasso
    X, y, _ = lasso.synthetic_correlated(np.random.default_rng(0), n=64,
                                         J=160, k_true=6)
    return X, y


@pytest.mark.parametrize("path", PLANS, ids=os.path.basename)
def test_example_plan_runs_through_the_port(path, lasso_problem, tmp_path):
    """Every checked-in plan runs unchanged through the port's Lasso
    ``execute`` on the CPU: all its rounds, to a finite objective below
    the start, with the carry its executor resumes from."""
    import torch
    from repro_torch.apps import lasso
    from repro_torch.ps import SSPCarry
    with open(path) as f:
        plan = tcore.ExecutionPlan.from_json(json.load(f))
    X, y = lasso_problem
    cfg = lasso.LassoConfig(num_features=X.shape[1], lam=0.02,
                            block_size=8, num_candidates=32, rho=0.3)
    eng = lasso.make_engine(cfg, workers=plan.workers or 1, device="cpu")
    data = eng.shard_data({"X": X, "y": y})
    ckpt = str(tmp_path) if plan.checkpoint_every else None
    rep = eng.execute(eng.init_state(y=y), data,
                      torch.Generator().manual_seed(0), plan,
                      collect=eng.app.objective_collect(), ckpt_dir=ckpt)
    assert rep.carry.t == plan.rounds and rep.trace.shape == (plan.rounds,)
    obj0 = 0.5 * float((y.astype("float64") ** 2).sum())
    assert bool(torch.isfinite(rep.trace).all())
    assert float(rep.trace[-1]) < obj0
    if plan.executor == "ssp":
        assert isinstance(rep.carry, SSPCarry)
        assert rep.carry.clocks.tolist() == [plan.rounds] * eng.workers
    if ckpt:
        assert sorted(os.listdir(ckpt)) == [
            f"step_{t:08d}.npz" for t in range(
                plan.checkpoint_every, plan.rounds + 1,
                plan.checkpoint_every)]
