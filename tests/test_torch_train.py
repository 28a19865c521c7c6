"""The port's training slice (``repro_torch.optim``, ``train/losses.py``,
``train/step.py``, ``sched/block.py``, the ``block_structural``
scheduler, ``launch/train.py``, ``convert.train_state_from_jax`` and the
flash-attention backward's plain version) against the JAX package's, on
the CPU at ``.reduced()`` sizes in float32, JAX weights carried in with
``convert``.  Tolerances and their reasons:

  * schedules: WSD equal to the bit; cosine within 2e-7 of the peak
    rate (XLA's float32 ``cos`` differs from torch's by one ulp at some
    points, times the cosine term's amplitude of at most half the peak,
    plus the last rounding);
  * losses and AdamW on the same numpy inputs: 1e-6 of the largest value
    (float32 sums in another order);
  * loss and gradients: at the reference's init every stacked weight has
    std L^-0.5 (fan-in read from the layer axis), which makes the
    gradients ill-conditioned: the JAX package's own float32 gradients
    are ~2e-3 of their largest value away from its float64 ones.  So the
    stated tolerances (loss 1e-5 relative, each gradient leaf 1e-4 of its
    largest magnitude) are held with the layer weights scaled by 0.1, and
    at the reference's init the port is held within twice the JAX
    package's own float32-vs-float64 distance;
  * composed steps, each from equal states: 1e-6 of the leaf's largest
    value plus lr·min(4, 4·δ/|g|), what a gradient off by δ (the gradient
    tolerance) moves an AdamW update (``_held`` says why); AdamW's first
    step moves an element by ±lr whatever its gradient's size, so
    elements whose gradient is too small for its sign to be decided are
    counted (a gradient of exactly 0, the vocabulary padding's rows, is
    not), and must stay under 1 % of the parameters;
  * STRADS masks, layer blocks and scheduler decisions on the JAX Gumbel
    draws: equal; priorities from the same updates within 1e-6, and after
    composed steps within 1e-4 relative: a priority is the norm of a
    block's first AdamW update, g/(|g| + ε) per element, and the
    elements whose gradient is near ε = 1e-8 follow its float32 noise
    (measured 2.2e-5);
  * the attention backward's plain version: 1e-5 of each gradient's
    largest value against torch autograd and ``jax.vjp`` of the f32
    references (on the rows that see a key: the JAX oracle averages the
    others).
"""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import save_checkpoint as j_save
from repro.configs import get_config as jget
from repro.kernels import ref as JREF
from repro.launch import train as JLT
from repro.models import model as JM
from repro.optim import adamw as JA
from repro.optim import schedules as JSCH
from repro.sched import SchedulerSpec as JSpec
from repro.sched import block as JB
from repro.sched import schedulers as JSS
from repro.train import losses as JLOSS
from repro.train import step as JSTEP

from repro_torch import convert
from repro_torch.checkpoint import (latest_step, load_flat,
                                    restore_checkpoint, save_checkpoint)
from repro_torch.configs import get_config
from repro_torch.kernels import ref as TREF
from repro_torch.launch import train as TLT
from repro_torch.models import model as TM
from repro_torch.optim import adamw as TA
from repro_torch.optim import schedules as TSCH
from repro_torch.optim import tree_flatten
from repro_torch.sched import SchedulerSpec
from repro_torch.sched import block as TB
from repro_torch.sched import schedulers as TSS
from repro_torch.train import losses as TLOSS
from repro_torch.train import step as TSTEP

LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4
VALUE_TOL = 1e-6
PRIORITY_RTOL = 1e-4
ARCHS = ["minicpm-2b", "granite-3-2b"]


def _cfgs(arch, **kw):
    """(JAX config, port config) at reduced size; granite with 2 kv
    heads (``reduced()`` makes it 4/4, losing GQA)."""
    if arch == "granite-3-2b":
        kw.setdefault("num_kv_heads", 2)
    return (dataclasses.replace(jget(arch).reduced(), **kw),
            dataclasses.replace(get_config(arch).reduced(), **kw))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _flat_np(tree):
    """A JAX tree (or the port's) as {path: float64/32 numpy}."""
    out = {}
    for name, x in tree_flatten(tree):
        if torch.is_tensor(x):
            x = x.detach().float().numpy() if x.is_floating_point() \
                else x.numpy()
        else:
            x = np.asarray(x)
            if x.dtype.name == "bfloat16":
                x = x.astype(np.float32)
        out[name] = x
    return out


def _scaled(jp, scale):
    """Every layer weight but the norms scaled by ``scale``."""
    def f(path, x):
        name = "/".join(str(getattr(p, "key", p)) for p in path)
        return x * scale if (name.startswith("layers/")
                             and "norm" not in name) else x
    return jax.tree_util.tree_map_with_path(f, jp)


def _batch(cfg, B=2, S=16, seed=0):
    r = np.random.default_rng(seed)
    toks = r.integers(0, cfg.vocab_size, (B, S + 1))
    return ({"tokens": jnp.asarray(toks[:, :-1], jnp.int32),
             "labels": jnp.asarray(toks[:, 1:], jnp.int32)},
            {"tokens": torch.tensor(toks[:, :-1]),
             "labels": torch.tensor(toks[:, 1:])})


@pytest.fixture(scope="module")
def models():
    """Per arch: JAX configs, params at the reference's init and scaled by
    0.1, and the JAX value_and_grad (jitted once)."""
    out = {}
    for arch in ARCHS:
        jc, tc = _cfgs(arch)
        jp = JM.init_params(jc, jax.random.PRNGKey(0))
        vg = jax.jit(jax.value_and_grad(
            lambda p, b, jc=jc: JSTEP.loss_fn(jc, p, b), has_aux=True))
        out[arch] = dict(jc=jc, tc=tc, jp=jp, jp_s=_scaled(jp, 0.1), vg=vg)
    return out


def _max_rel(a, b):
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


# ---------------------------------------------------------------------------
# Schedules, losses, AdamW
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("args", [(1e-3, 10, 70, 20), (1e-3, 0, 5, 3),
                                  (7e-4, 3, 11, 9), (3e-4, 20, 60, 40)])
def test_wsd_schedule_equals_jax(args):
    fj, ft = JSCH.wsd_schedule(*args), TSCH.wsd_schedule(*args)
    for s in range(sum(args[1:]) + 10):
        a = np.asarray(fj(jnp.int32(s)))
        b = ft(torch.tensor(s, dtype=torch.int32))
        assert b.dtype == torch.float32 and a == b.numpy() == ft(s).numpy()


@pytest.mark.parametrize("args", [(1e-3, 10, 100), (3e-4, 0, 37),
                                  (1e-3, 2, 8, 0.3)])
def test_cosine_schedule_equals_jax(args):
    fj, ft = JSCH.cosine_schedule(*args), TSCH.cosine_schedule(*args)
    steps = range(args[2] + 10)
    a = np.array([np.asarray(fj(jnp.int32(s))) for s in steps])
    b = np.array([ft(s).numpy() for s in steps])
    np.testing.assert_allclose(b, a, rtol=0, atol=2e-7 * args[0])


@pytest.mark.parametrize("padded", [True, False])
@pytest.mark.parametrize("masked", [True, False])
def test_losses_equal_jax(padded, masked):
    r = np.random.default_rng(1)
    V, Vp = (300, 512) if padded else (512, 512)
    logits = (r.standard_normal((3, 7, Vp)) * 4).astype(np.float32)
    labels = r.integers(0, V, (3, 7))
    lmask = (r.random((3, 7)) < 0.6).astype(np.float32) if masked else None
    cj, dj = JLOSS.cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                                 V, None if lmask is None
                                 else jnp.asarray(lmask))
    ct, dt = TLOSS.cross_entropy(torch.from_numpy(logits),
                                 torch.from_numpy(labels), V,
                                 None if lmask is None
                                 else torch.from_numpy(lmask))
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), rtol=VALUE_TOL)
    assert float(dt) == float(dj)
    # accuracy: plant some correct argmaxes
    logits[0, :4, labels[0, :4]] = 50.0
    aj = JLOSS.token_accuracy(jnp.asarray(logits), jnp.asarray(labels), V)
    at = TLOSS.token_accuracy(torch.from_numpy(logits),
                              torch.from_numpy(labels), V)
    assert float(at) == float(aj) and float(at) > 0


def _adamw_inputs(seed=0):
    r = np.random.default_rng(seed)
    shapes = {"b": {"w": (5, 7), "z": (3,)}, "a": (4, 2, 3), "c": (6,)}

    def tree(f):
        return jax.tree.map(f, shapes, is_leaf=lambda x: isinstance(x, tuple))
    params = tree(lambda s: r.standard_normal(s).astype(np.float32))
    grads = tree(lambda s: (r.standard_normal(s) * 0.3).astype(np.float32))
    m = tree(lambda s: (r.standard_normal(s) * 0.1).astype(np.float32))
    v = tree(lambda s: (r.random(s) * 0.05).astype(np.float32))
    return params, grads, m, v


def _to_t(tree, dtype=None):
    return jax.tree.map(lambda x: torch.tensor(np.asarray(x, np.float32),
                                               dtype=dtype), tree)


@pytest.mark.parametrize("clip", [1.0, None, 100.0])
@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("masked", [False, True])
def test_adamw_update_equals_jax(clip, moment_dtype, masked):
    params, grads, m, v = _adamw_inputs()
    cfgj = JA.AdamWConfig(clip_norm=clip, moment_dtype=moment_dtype)
    cfgt = TA.AdamWConfig(clip_norm=clip, moment_dtype=moment_dtype)
    mdt_j = jnp.dtype(moment_dtype)
    optj = {"m": jax.tree.map(lambda x: jnp.asarray(x, mdt_j), m),
            "v": jax.tree.map(lambda x: jnp.asarray(x, mdt_j), v),
            "count": jnp.int32(3)}
    mdt_t = getattr(torch, moment_dtype)
    optt = {"m": _to_t(optj["m"], mdt_t), "v": _to_t(optj["v"], mdt_t),
            "count": torch.tensor(3, dtype=torch.int32)}
    # the mask hook: zero leaf "c", halve leaf "b/w"
    jmask = (lambda u: dict(u, c=u["c"] * 0.0,
                            b=dict(u["b"], w=u["b"]["w"] * 0.5))) \
        if masked else None

    def tmask(u):
        u["c"].mul_(0.0)
        u["b"]["w"].mul_(0.5)
        return u
    lr = JSCH.wsd_schedule(1e-2, 2, 5, 3)(jnp.int32(4))
    pj, oj, gj = JA.adamw_update(
        jax.tree.map(jnp.asarray, grads), optj,
        jax.tree.map(jnp.asarray, params), lr, cfgj, update_mask=jmask)
    pt, ot, gt = TA.adamw_update(
        _to_t(grads), optt, _to_t(params),
        TSCH.wsd_schedule(1e-2, 2, 5, 3)(4), cfgt,
        update_mask=tmask if masked else None)
    np.testing.assert_allclose(float(gt), float(gj), rtol=VALUE_TOL)
    assert int(ot["count"]) == int(oj["count"]) == 4
    for want, got in ((pj, pt), (oj["m"], ot["m"]), (oj["v"], ot["v"])):
        w, g = _flat_np(want), _flat_np(got)
        for n in w:
            assert _max_rel(g[n], w[n]) <= VALUE_TOL, n
    if moment_dtype == "bfloat16":
        assert ot["m"]["a"].dtype == torch.bfloat16


def test_adamw_inplace_equals_functional():
    params, grads, m, v = _adamw_inputs(seed=3)
    cfg = TA.AdamWConfig(moment_dtype="bfloat16")
    lr = torch.tensor(1e-2)

    def opt():
        return {"m": _to_t(m, torch.bfloat16), "v": _to_t(v, torch.bfloat16),
                "count": torch.tensor(1, dtype=torch.int32)}
    p1, o1, g1 = TA.adamw_update(_to_t(grads), opt(), _to_t(params), lr, cfg)
    p_in, o_in = _to_t(params), opt()
    p2, o2, g2 = TA.adamw_update(_to_t(grads), o_in, p_in, lr, cfg,
                                 inplace=True)
    assert p2["a"] is p_in["a"] and o2["m"]["c"] is o_in["m"]["c"]
    for a, b in zip(tree_flatten({"p": p1, "o": o1}),
                    tree_flatten({"p": p2, "o": o2})):
        assert torch.equal(a[1], b[1]), a[0]


# ---------------------------------------------------------------------------
# Loss and gradients, train=True, composed steps
# ---------------------------------------------------------------------------

def _grads(models, arch, scaled, B=2, S=16):
    mm = models[arch]
    jp = mm["jp_s"] if scaled else mm["jp"]
    bj, bt = _batch(mm["tc"], B, S)
    (lj, _), gj = mm["vg"](jp, bj)
    tp = convert.model_params_from_jax(_np(jp), mm["tc"], "cpu")
    (lt, mt), gt = TSTEP.value_and_grad(mm["tc"], tp, bt)
    return float(lj), float(lt), _flat_np(gj), _flat_np(gt)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_equal_jax(models, arch):
    lj, lt, gj, gt = _grads(models, arch, scaled=True)
    assert abs(lt - lj) <= LOSS_RTOL * abs(lj)
    assert set(gj) == set(gt)
    for n in gj:
        assert gt[n].shape == gj[n].shape
        assert _max_rel(gt[n], gj[n]) <= GRAD_TOL, n


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_at_the_reference_init(models, arch):
    """At the reference's init the port stays within twice the JAX
    package's own float32-vs-float64 distance."""
    mm = models[arch]
    lj, lt, gj, gt = _grads(models, arch, scaled=False)
    assert abs(lt - lj) <= LOSS_RTOL * abs(lj)
    jc64 = dataclasses.replace(mm["jc"], dtype="float64")
    bj, _ = _batch(mm["tc"])
    with jax.enable_x64(True):
        jp64 = jax.tree.map(lambda x: jnp.asarray(x, jnp.float64),
                            _np(mm["jp"]))
        (_, _), g64 = jax.jit(jax.value_and_grad(
            lambda p: JSTEP.loss_fn(jc64, p, bj), has_aux=True))(jp64)
        g64 = _flat_np(g64)
    band = max(_max_rel(gj[n], g64[n]) for n in gj)
    port = max(_max_rel(gt[n], gj[n]) for n in gj)
    assert port <= 2 * band, (port, band)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_true_equals_train_false_to_the_bit(models, arch):
    mm = models[arch]
    tp = convert.model_params_from_jax(_np(mm["jp_s"]), mm["tc"], "cpu")
    _, bt = _batch(mm["tc"])
    l1, _ = TM.forward(mm["tc"], tp, bt, train=True)
    l0, _ = TM.forward(mm["tc"], tp, bt, train=False)
    assert torch.equal(l0, l1)
    (_, _), g1 = TSTEP.value_and_grad(mm["tc"], tp, bt)
    plain = TSTEP.loss_fn

    def loss_untrained(cfg, params, batch):
        logits, aux = TM.forward(cfg, params, batch, train=False)
        ce, _ = TLOSS.cross_entropy(logits, batch["labels"], cfg.vocab_size)
        return ce + cfg.router_aux_weight * aux, {"ce": ce.detach()}
    TSTEP.loss_fn = loss_untrained
    try:
        (_, _), g0 = TSTEP.value_and_grad(mm["tc"], tp, bt)
    finally:
        TSTEP.loss_fn = plain
    for (n, a), (_, b) in zip(tree_flatten(g1), tree_flatten(g0)):
        assert torch.equal(a, b), n


def _held(got, want, grads, lr, tag, g_rel=0.0):
    """One composed step from equal states: each parameter within
    VALUE_TOL of its leaf's largest value plus what the gradient
    tolerance lets AdamW move it.  A gradient off by δ moves the update
    m̂/(√v̂ + ε) by at most ~δ/|g| in the first steps (the bias-corrected
    moments of one gradient), and by at most ±2 whatever δ (AdamW's
    first step moves an element by ±lr whichever the sign), so with
    δ ≤ GRAD_TOL·max|g| (+ ``g_rel``·|g| where the gradients were rounded
    to bfloat16 on each side) the bound is lr·min(4, 4·δ/|g|).  Returns
    how many elements sit at the ±lr cap: those whose gradient is too
    small for its sign to be decided."""
    capped = 0
    for n in want:
        g = np.abs(grads[n]).astype(np.float64)
        with np.errstate(divide="ignore"):
            move = 4 * (GRAD_TOL * g.max() / g + g_rel)
        capped += int(((move >= 4) & (g > 0)).sum())
        tol = VALUE_TOL * np.abs(want[n]).max() + lr * np.minimum(4, move)
        err = np.abs(got[n].astype(np.float64) - want[n])
        assert (err <= tol).all(), (tag, n, float((err - tol).max()))
    return capped


@pytest.mark.parametrize("arch", ARCHS)
def test_adamw_on_the_jax_gradients_equals_jax(models, arch):
    """Stage 2: the port's adamw_update fed the JAX gradients."""
    mm = models[arch]
    bj, _ = _batch(mm["tc"])
    (_, _), gj = mm["vg"](mm["jp_s"], bj)
    cfg = JA.AdamWConfig()
    optj = JA.adamw_init(mm["jp_s"], cfg)
    pj, _, nj = jax.jit(JA.adamw_update, static_argnums=4)(
        gj, optj, mm["jp_s"], jnp.float32(1e-3), cfg)
    tp = convert.model_params_from_jax(_np(mm["jp_s"]), mm["tc"], "cpu")
    gt = convert.model_params_from_jax(_np(gj), mm["tc"], "cpu")
    pt, _, nt = TA.adamw_update(gt, TA.adamw_init(tp, TA.AdamWConfig()), tp,
                                torch.tensor(1e-3), TA.AdamWConfig())
    np.testing.assert_allclose(float(nt), float(nj), rtol=VALUE_TOL)
    w, g = _flat_np(pj), _flat_np(pt)
    for n in w:
        assert _max_rel(g[n], w[n]) <= VALUE_TOL, n


@pytest.mark.parametrize("arch,micro,accum", [
    ("minicpm-2b", 1, "bfloat16"), ("granite-3-2b", 1, "bfloat16"),
    ("minicpm-2b", 2, "float32"), ("granite-3-2b", 2, "bfloat16")])
def test_train_steps_equal_jax(models, arch, micro, accum):
    """Stage 3: three composed steps of the plain train step (WSD), with
    microbatches = 2 in float32 and bfloat16 accumulators."""
    mm = models[arch]
    jc, tcfg = mm["jc"], mm["tc"]
    sched = (JSCH.wsd_schedule(1e-3, 1, 1, 1), TSCH.wsd_schedule(1e-3, 1, 1, 1))
    tcj = JSTEP.TrainConfig(schedule=sched[0], microbatches=micro,
                            accum_dtype=accum)
    tct = TSTEP.TrainConfig(schedule=sched[1], microbatches=micro,
                            accum_dtype=accum)
    sj = {"params": mm["jp_s"], "opt": JA.adamw_init(mm["jp_s"], tcj.adamw),
          "step": jnp.int32(0)}
    st = convert.train_state_from_jax(_np(sj), tcfg, "cpu")
    stepj = jax.jit(JSTEP.make_train_step(jc, tcj))
    stept = TSTEP.make_train_step(tcfg, tct)
    capped = 0
    for i in range(3):
        bj, bt = _batch(tcfg, B=4, seed=10 + i)
        (_, _), gj = mm["vg"](sj["params"], bj)
        sj, mj = stepj(sj, bj)
        st, mt = stept(st, bt)
        assert abs(float(mt["loss"]) - float(mj["loss"])) <= \
            LOSS_RTOL * abs(float(mj["loss"]))
        assert float(mt["lr"]) == float(mj["lr"])
        capped += _held(_flat_np(st["params"]), _flat_np(sj["params"]),
                        _flat_np(gj), float(mj["lr"]), f"step {i}",
                        g_rel=2 ** -8 if accum == "bfloat16" and micro > 1
                        else 0.0)
        # the next step from the same state on both sides
        st = convert.train_state_from_jax(_np(sj), tcfg, "cpu")
    assert int(st["step"]) == int(sj["step"]) == 3
    total = sum(x.size for x in _flat_np(sj["params"]).values())
    assert capped < 0.01 * 3 * total, capped


# ---------------------------------------------------------------------------
# STRADS
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_layer_blocks_equal_jax(models, arch):
    mm = models[arch]
    tp = convert.model_params_from_jax(_np(mm["jp"]), mm["tc"], "cpu")
    assert TSTEP.layer_blocks(mm["tc"], tp) == \
        JSTEP.layer_blocks(mm["jc"], mm["jp"])


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("nb,U,UP,md", [(41, 20, 40, 1), (9, 3, 6, 2),
                                        (3, 1, 2, 1)])
def test_select_blocks_on_jax_draws_equals_jax(seed, nb, U, UP, md):
    kw = dict(num_blocks=nb, blocks_per_step=U, candidates_per_step=UP,
              min_distance=md)
    cj, ct = JB.BlockScheduleConfig(**kw), TB.BlockScheduleConfig(**kw)
    r = np.random.default_rng(seed)
    prio = (r.random(nb) * 2).astype(np.float32)
    key = jax.random.PRNGKey(seed)
    mj = JB.select_blocks(cj, jnp.asarray(prio), key)
    g = np.array(jax.random.gumbel(key, (nb,), jnp.float32))
    mt = TB.select_blocks(ct, torch.from_numpy(prio), torch.from_numpy(g))
    np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))
    assert mt.sum() <= U
    assert ct.to_spec().to_json() == cj.to_spec().to_json()
    spec = SchedulerSpec.from_json(cj.to_spec().to_json())
    assert TB.config_from_spec(spec, nb) == ct


def test_block_helpers_equal_jax():
    r = np.random.default_rng(5)
    upd = {"a": r.standard_normal((3, 4)).astype(np.float32),
           "b": {"c": r.standard_normal((5,)).astype(np.float32)}}
    mapping = {"a": 1, "b/c": 2}
    mask = np.array([1.0, 0.0, 1.0], np.float32)
    nj = JB.block_norms(jax.tree.map(jnp.asarray, upd), mapping, 3)
    nt = TB.block_norms(_to_t(upd), mapping, 3)
    np.testing.assert_allclose(nt.numpy(), np.asarray(nj), rtol=VALUE_TOL)
    mj = JB.mask_updates_by_block(jax.tree.map(jnp.asarray, upd), mapping,
                                  jnp.asarray(mask))
    mt = TB.mask_updates_by_block(_to_t(upd), mapping, torch.from_numpy(mask))
    for n, x in _flat_np(mj).items():
        np.testing.assert_array_equal(_flat_np(mt)[n], x)
    cj = JB.BlockScheduleConfig(3, 1, 2)
    ct = TB.BlockScheduleConfig(3, 1, 2)
    pj = JB.update_priority(cj, JB.init_priority(cj), nj, jnp.asarray(mask))
    pt = TB.update_priority(ct, TB.init_priority(ct), nt,
                            torch.from_numpy(mask))
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=VALUE_TOL)


def _strads_pair(models, arch, staleness=0, wd=0.1):
    mm = models[arch]
    jc, tcfg = mm["jc"], mm["tc"]
    nb = JSTEP.layer_blocks(jc, mm["jp"])[1]
    kw = dict(num_blocks=nb, blocks_per_step=1, candidates_per_step=2,
              min_distance=1)
    adj = JA.AdamWConfig(weight_decay=wd)
    tcj = JSTEP.TrainConfig(adamw=adj, peak_lr=1e-3)
    tct = TSTEP.TrainConfig(adamw=TA.AdamWConfig(weight_decay=wd),
                            peak_lr=1e-3)
    sj = JSTEP.init_strads_state(jc, tcj, JB.BlockScheduleConfig(**kw),
                                 jax.random.PRNGKey(1), staleness=staleness)
    sj["params"] = mm["jp_s"]
    st = convert.train_state_from_jax(
        _np(sj), tcfg, "cpu", generator=torch.Generator().manual_seed(0))
    stepj = jax.jit(JSTEP.make_strads_train_step(
        jc, tcj, JB.BlockScheduleConfig(**kw), staleness=staleness))
    stept = TSTEP.make_strads_train_step(
        tcfg, tct, TB.BlockScheduleConfig(**kw), staleness=staleness)
    return sj, st, stepj, stept, nb


@pytest.mark.parametrize("arch", ARCHS)
def test_strads_steps_equal_jax(models, arch):
    """Two STRADS steps fed the JAX Gumbel draws: the same masks, the
    priorities within PRIORITY_RTOL, the parameters held as the plain
    steps."""
    sj, st, stepj, stept, nb = _strads_pair(models, arch)
    tcfg = models[arch]["tc"]
    for i in range(2):
        bj, bt = _batch(tcfg, B=2, seed=20 + i)
        _, sub = jax.random.split(sj["rng"])
        g = torch.from_numpy(np.array(jax.random.gumbel(sub, (nb,),
                                                          jnp.float32)))
        (_, _), gj = models[arch]["vg"](sj["params"], bj)
        sj, mj = stepj(sj, bj)
        st, mt = stept(st, bt, gumbel=g)
        assert float(mt["blocks_active"]) == float(mj["blocks_active"]) <= 1
        np.testing.assert_allclose(st["priority"].numpy(),
                                   np.asarray(sj["priority"]),
                                   rtol=PRIORITY_RTOL)
        _held(_flat_np(st["params"]), _flat_np(sj["params"]), _flat_np(gj),
              float(mj["lr"]), f"strads step {i}")
        st = convert.train_state_from_jax(_np(sj), tcfg, "cpu",
                                          generator=torch.Generator())


@pytest.mark.parametrize("arch", ARCHS)
def test_strads_unscheduled_blocks_do_not_move(models, arch):
    """The port's twin of tests/test_invariants.py: with no weight decay
    the layers whose mask was 0 keep their bits."""
    _, st, _, stept, nb = _strads_pair(models, arch, wd=0.0)
    before = {n: x.clone() for n, x in tree_flatten(st["params"])}
    _, bt = _batch(models[arch]["tc"], B=2, seed=3)
    st, mt = stept(st, bt)
    mask = mt["mask"]
    assert float(mask.sum()) == float(mt["blocks_active"]) <= 1
    for n, x in tree_flatten(st["params"]):
        if n.startswith("layers/"):
            for layer in range(x.shape[0]):
                same = torch.equal(x[layer], before[n][layer])
                assert same == (mask[layer] == 0), (n, layer)
        else:
            assert torch.equal(x, before[n]) == (mask[-1] == 0), n


def test_strads_staleness_serves_the_cached_mask(models):
    arch = "granite-3-2b"
    sj, st, stepj, stept, nb = _strads_pair(models, arch, staleness=1)
    tcfg = models[arch]["tc"]
    masks = []
    for i in range(3):
        bj, bt = _batch(tcfg, B=2, seed=30 + i)
        _, sub = jax.random.split(sj["rng"])
        g = torch.from_numpy(np.array(jax.random.gumbel(sub, (nb,),
                                                          jnp.float32)))
        sj, mj = stepj(sj, bj)
        st, mt = stept(st, bt, gumbel=g)
        np.testing.assert_array_equal(st["mask"].numpy(),
                                      np.asarray(sj["mask"]))
        masks.append(mt["mask"].clone())
    assert torch.equal(masks[0], masks[1])      # step 1 reads step 0's


@pytest.mark.parametrize("seed", range(4))
def test_block_structural_scheduler_equals_jax(seed):
    spec = dict(kind="block_structural", block_size=3, num_candidates=6,
                min_distance=2, rho=0.5)
    sj = JSS.build_scheduler(JSpec(**spec), num_vars=11, num_workers=1)
    stt = TSS.build_scheduler(SchedulerSpec(**spec), num_vars=11,
                              num_workers=1)
    r = np.random.default_rng(seed)
    cj = sj.init_carry()
    ct = stt.init_carry("cpu")
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
    carry = (r.random(11) * 3).astype(np.float32)
    key = jax.random.PRNGKey(seed)
    candj = sj.propose(jnp.asarray(carry), key)
    g = np.array(jax.random.gumbel(key, (11,), jnp.float32))
    candt = stt.propose(torch.from_numpy(carry), torch.from_numpy(g))
    np.testing.assert_array_equal(candt.numpy(), np.asarray(candj))
    np.testing.assert_array_equal(stt.keep_mask(candt).numpy(),
                                  np.asarray(sj.keep_mask(candj)))
    (ij, mj), (it, mt) = sj.finalize(candj), stt.finalize(candt)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))
    dx = r.standard_normal(3).astype(np.float32)
    np.testing.assert_allclose(
        stt.update_carry(torch.from_numpy(carry), it, mt,
                         torch.from_numpy(dx)).numpy(),
        np.asarray(sj.update_carry(jnp.asarray(carry), ij, mj,
                                   jnp.asarray(dx))), rtol=1e-6)
    np.testing.assert_array_equal(
        stt.mark_scheduled(torch.from_numpy(carry), candt).numpy(),
        np.asarray(sj.mark_scheduled(jnp.asarray(carry), candj)))


# ---------------------------------------------------------------------------
# Checkpoints
# ---------------------------------------------------------------------------

def test_bf16_train_state_roundtrips_to_the_bit(tmp_path):
    cfg = dataclasses.replace(get_config("minicpm-2b").reduced(),
                              dtype="bfloat16")
    tc = TSTEP.TrainConfig(adamw=TA.AdamWConfig(moment_dtype="bfloat16"))
    sched = TB.BlockScheduleConfig(3, 1, 2, min_distance=1)
    st = TSTEP.init_strads_state(cfg, tc, sched,
                                 torch.Generator().manual_seed(0),
                                 staleness=1)
    st, _ = TSTEP.make_strads_train_step(cfg, tc, sched, staleness=1)(
        st, _batch(cfg)[1])
    save_checkpoint(str(tmp_path), 1, st)
    flat = load_flat(str(tmp_path), 1)
    assert flat["params/tok_embed"].dtype == np.dtype("V2")
    assert "rng" in flat and "opt/m/tok_embed" in flat
    template = TSTEP.init_strads_state(cfg, tc, sched,
                                       torch.Generator().manual_seed(9),
                                       staleness=1)
    back = restore_checkpoint(str(tmp_path), 1, template)
    for (n, a), (m, b) in zip(tree_flatten(st), tree_flatten(back)):
        assert n == m and a.dtype == b.dtype and torch.equal(a, b), n


def test_jax_train_state_checkpoint_continues_in_the_port(models, tmp_path):
    """A JAX train state after one step, written by the JAX package's
    checkpoint, read with the port's load_flat, continues for a step in
    the port as in JAX (loss within 1e-5; parameters held as above)."""
    arch = "minicpm-2b"
    mm = models[arch]
    jc, tcfg = mm["jc"], mm["tc"]
    tcj = JSTEP.TrainConfig(adamw=JA.AdamWConfig(moment_dtype="bfloat16"))
    tct = TSTEP.TrainConfig(adamw=TA.AdamWConfig(moment_dtype="bfloat16"))
    sj = {"params": mm["jp_s"], "opt": JA.adamw_init(mm["jp_s"], tcj.adamw),
          "step": jnp.int32(0)}
    stepj = jax.jit(JSTEP.make_train_step(jc, tcj))
    sj, _ = stepj(sj, _batch(tcfg, seed=40)[0])
    j_save(str(tmp_path), 1, sj)
    flat = load_flat(str(tmp_path), 1)
    st = convert.train_state_from_jax(flat, tcfg, "cpu")
    assert st["opt"]["m"]["tok_embed"].dtype == torch.bfloat16
    for n, x in _flat_np(sj["opt"]).items():
        np.testing.assert_array_equal(_flat_np(st["opt"])[n], x)
    bj, bt = _batch(tcfg, seed=41)
    (_, _), gj = mm["vg"](sj["params"], bj)
    sj, mj = stepj(sj, bj)
    st, mt = TSTEP.make_train_step(tcfg, tct)(st, bt)
    assert abs(float(mt["loss"]) - float(mj["loss"])) <= \
        LOSS_RTOL * abs(float(mj["loss"]))
    _held(_flat_np(st["params"]), _flat_np(sj["params"]), _flat_np(gj),
          float(mj["lr"]), "continued step")


# ---------------------------------------------------------------------------
# The CLI
# ---------------------------------------------------------------------------

COMMON = ["--preset", "reduced", "--steps", "4", "--batch", "2", "--seq",
          "16", "--log-every", "1", "--seed", "7"]


def _plan_file(tmp_path, **kw):
    from repro.core import ExecutionPlan
    path = str(tmp_path / f"plan{len(os.listdir(tmp_path))}.json")
    with open(path, "w") as f:
        json.dump(ExecutionPlan(**kw).to_json(), f)
    return path


@pytest.mark.parametrize("bad", ["scheduler_and_plan", "rho_and_plan",
                                 "plan_fields", "kind", "plan_kind"])
def test_cli_errors_equal_jax(tmp_path, capsys, bad):
    from repro.sched import SchedulerSpec as JS_
    argv = {
        "scheduler_and_plan": ["--plan", _plan_file(tmp_path),
                               "--scheduler", "block_structural"],
        "rho_and_plan": ["--plan", _plan_file(tmp_path), "--rho", "0.5"],
        "plan_fields": ["--plan", _plan_file(tmp_path, collect_every=2)],
        "kind": ["--scheduler", "dynamic_priority"],
        "plan_kind": ["--plan", _plan_file(tmp_path, scheduler=JS_(
            kind="random", block_size=2))],
    }[bad]
    msgs = []
    for main in (JLT.main, TLT.main):
        with pytest.raises(SystemExit) as e:
            main(["--arch", "granite-3-2b"] + COMMON + argv
                 + (["--device", "cpu"] if main is TLT.main else []))
        assert e.value.code == 2
        msgs.append(capsys.readouterr().err.strip().splitlines()[-1])
    assert msgs[0] == msgs[1]


def _final(argv):
    box = {}

    def on_step(i, state, metrics):
        box["state"] = {n: x.clone() for n, x in tree_flatten(state)}
    hist = TLT.main(argv, on_step=on_step)
    return hist, box["state"]


def test_cli_scan_steps_equal_one_step_to_the_bit():
    argv = ["--arch", "minicpm-2b", "--device", "cpu", "--strads"] + COMMON
    h1, s1 = _final(argv)
    h2, s2 = _final(argv + ["--scan-steps", "2"])
    assert [h["step"] for h in h2] == [1, 3]
    assert h2[-1]["loss"] == h1[-1]["loss"]
    for n in s1:
        assert torch.equal(s1[n], s2[n]), n


def test_cli_plan_resume_equals_uninterrupted(tmp_path):
    """The shape of tests/test_ckpt_resume.py's train resume test, on
    granite-3-2b reduced (xLSTM is not ported): a plan with
    checkpoint_every 2, the final file removed, --resume from step 2."""
    common = ["--arch", "granite-3-2b", "--device", "cpu"] + COMMON
    full, s_full = _final(common)
    plan = _plan_file(tmp_path, executor="loop", rounds=4,
                      checkpoint_every=2)
    d = str(tmp_path / "ck")
    TLT.main(common + ["--plan", plan, "--ckpt-dir", d])
    assert latest_step(d) == 4
    os.remove(os.path.join(d, "step_00000004.npz"))
    resumed, s_res = _final(common + ["--plan", plan, "--ckpt-dir", d,
                                      "--resume"])
    assert resumed[-1]["step"] == full[-1]["step"] == 3
    assert resumed[-1]["loss"] == full[-1]["loss"]
    for n in s_full:
        assert torch.equal(s_full[n], s_res[n]), n


# ---------------------------------------------------------------------------
# The flash-attention backward's plain version
# ---------------------------------------------------------------------------

BWD_CASES = [  # B, Sq, Skv, Hq, Hkv, D, causal, window
    (2, 24, 24, 4, 4, 8, True, None),
    (1, 20, 20, 4, 1, 16, True, 6),
    (2, 12, 30, 6, 2, 8, True, None),
    (1, 30, 12, 2, 1, 8, True, None),
    (2, 17, 17, 4, 2, 8, False, 5),
]


@pytest.mark.parametrize("case", BWD_CASES)
def test_attention_bwd_ref_equals_autograd_and_jax_vjp(case):
    B, Sq, Skv, Hq, Hkv, D, causal, window = case
    r = np.random.default_rng(sum(case[:6]))
    q, k, v = (r.standard_normal(s).astype(np.float32) for s in
               ((B, Sq, Hq, D), (B, Skv, Hkv, D), (B, Skv, Hkv, D)))
    do = r.standard_normal((B, Sq, Hq, D)).astype(np.float32)
    kw = dict(causal=causal, window=window)
    qt, kt, vt = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    o = TREF.attention_ref(qt, kt, vt, **kw)
    auto = torch.autograd.grad(o, (qt, kt, vt), torch.from_numpy(do))
    lse = TREF.attention_lse_ref(qt.detach(), kt.detach(), **kw)
    got = TREF.attention_bwd_ref(qt.detach(), kt.detach(), vt.detach(),
                                 o.detach(), torch.from_numpy(do), lse, **kw)
    seen = TREF.attention_mask(Sq, Skv, Skv - Sq, causal, window).any(-1)
    assert torch.equal(torch.isfinite(lse[0, 0]), seen)
    for a, b in zip(got, auto):
        assert _max_rel(a.numpy(), b.numpy()) <= 1e-5
    # jax.vjp of the JAX oracle, with the cotangent zero on the rows that
    # see no key (the oracle averages those rows' values)
    do_seen = do * seen.numpy()[None, :, None, None]
    _, vjp = jax.vjp(jax.jit(lambda a, b, c: JREF.attention_ref(a, b, c,
                                                                 **kw)),
                     q, k, v)
    jg = vjp(jnp.asarray(do_seen))
    mine = TREF.attention_bwd_ref(qt.detach(), kt.detach(), vt.detach(),
                                  o.detach(), torch.from_numpy(do_seen),
                                  lse, **kw)
    for a, b in zip(mine, jg):
        assert _max_rel(a.numpy(), np.asarray(b)) <= 1e-5
