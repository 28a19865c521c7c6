"""Training the moe and hybrid families in the port: the plain backwards
of the gating and scan kernels (``kernels/ref.py``), and loss, gradients,
STRADS blocks and the training CLI of Phi-3.5-MoE, Llama-4 and Zamba2
against the JAX package's, on the CPU at ``.reduced()`` sizes.

The CUDA backward kernels (``csrc/moe_gating.cu``, ``csrc/ssm_scan.cu``)
compute the formulas of ``topk_gating_bwd_ref`` and ``ssm_scan_bwd_ref``;
``tests/test_torch_kernels.py`` holds them against these on the card.
Inputs come from numpy seeds.  Tolerances and their reasons:

  * gating: dlogits within 1e-6 absolute of torch autograd through
    ``topk_gating_ref`` and of ``jax.vjp`` of the JAX package's
    ``ref.topk_gating_ref`` (f32 sums over at most 128 experts in
    another order; every value is below 1);
  * scan: each gradient within 1e-4 of its largest magnitude (f32 sums
    over the steps and channels in another order); for bf16 inputs, whose
    gradients come back in bf16, within that plus one bf16 rounding of
    the element (2⁻⁸ of it), since the two sides round f32 values that
    may straddle a bf16 step;
  * loss and gradients of ``loss_fn``, STRADS masks and parameters:
    ``tests/test_torch_train.py``'s (loss 1e-5 relative, each gradient
    leaf 1e-4 of its largest magnitude, with the layer weights scaled by
    0.1; masks equal; an unscheduled block keeps its bits).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.kernels import ref as JREF
from repro.models import model as JM
from repro.sched import block as JB
from repro.train import step as JSTEP

from repro_torch.convert import model_params_from_jax
from repro_torch.kernels import ref as TREF
from repro_torch.launch import train as TLT
from repro_torch.optim import AdamWConfig, tree_flatten
from repro_torch.sched import block as TB
from repro_torch.train import step as TSTEP

from test_torch_models import _np, _port_cfg
from test_torch_train import GRAD_TOL, LOSS_RTOL, _flat_np, _max_rel, _scaled

GATE_TOL = 1e-6
SCAN_TOL = 1e-4
PHI, LLAMA4, ZAMBA = ("phi3.5-moe-42b-a6.6b", "llama4-maverick-400b-a17b",
                      "zamba2-2.7b")
GRANITE, STABLELM, CHATGLM = "granite-3-2b", "stablelm-3b", "chatglm3-6b"


def _t(a):
    return torch.from_numpy(np.asarray(a))


# ---------------------------------------------------------------------------
# The gating backward's plain version
# ---------------------------------------------------------------------------

def _gating_inputs(T, E, k, ties, seed):
    r = np.random.default_rng(seed)
    logits = r.standard_normal((T, E)).astype(np.float32)
    if ties:
        # equal logits, so equal probabilities, across and inside the picks
        logits[:, 1] = logits[:, 0]
        logits[::2, 2:5] = logits[::2, 5:8]
        logits[1::3] = 0.25
    dprobs = r.standard_normal((T, k)).astype(np.float32)
    return logits, dprobs


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("E", [16, 128])
def test_topk_gating_bwd_ref_equals_autograd_and_jax_vjp(E, k, ties):
    logits, dprobs = _gating_inputs(40, E, k, ties, seed=E + k)
    lt = _t(logits).requires_grad_()
    probs, idx = TREF.topk_gating_ref(lt, k)
    auto, = torch.autograd.grad(probs, lt, _t(dprobs))
    got = TREF.topk_gating_bwd_ref(lt.detach(), idx, probs.detach(),
                                   _t(dprobs))
    assert got.dtype == torch.float32 and got.shape == (40, E)
    (_, ij), vjp = jax.vjp(lambda x: JREF.topk_gating_ref(x, k),
                            jnp.asarray(logits))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ij))
    want, = vjp((jnp.asarray(dprobs), np.zeros(ij.shape, jax.dtypes.float0)))
    np.testing.assert_allclose(got.numpy(), auto.numpy(), rtol=0,
                               atol=GATE_TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=GATE_TOL)


# ---------------------------------------------------------------------------
# The scan backward's plain version
# ---------------------------------------------------------------------------

SCAN_CASES = [  # B, S, heads, head dim, N, h0, dh_final, dtype
    (2, 19, 2, 4, 8, True, True, "float32"),
    (2, 19, 2, 4, 8, False, False, "float32"),
    (1, 33, 3, 2, 5, True, False, "float32"),
    (2, 17, 2, 4, 16, False, True, "float32"),
    (2, 21, 2, 4, 8, True, True, "bfloat16"),
    (1, 16, 1, 8, 4, False, False, "bfloat16"),
]


def _scan_inputs(B, S, H, P, N, with_h0, seed):
    """dt and A per channel from per-head values, as the Mamba2 block
    gives them (``_expand_heads``)."""
    r = np.random.default_rng(seed)
    C = H * P
    x = r.standard_normal((B, S, C)).astype(np.float32)
    dt_h = np.log1p(np.exp(r.standard_normal((B, S, H)) - 1.0))
    dt = np.repeat(dt_h, P, axis=-1).astype(np.float32)
    A = -np.repeat(np.exp(r.uniform(-1.0, 1.0, H)), P).astype(np.float32)
    Bm = r.standard_normal((B, S, N)).astype(np.float32)
    Cm = r.standard_normal((B, S, N)).astype(np.float32)
    h0 = (r.standard_normal((B, C, N)).astype(np.float32) if with_h0
          else None)
    dy = r.standard_normal((B, S, C)).astype(np.float32)
    dh = r.standard_normal((B, C, N)).astype(np.float32)
    return x, dt, A, Bm, Cm, h0, dy, dh


def _scan_close(got, want, dtype, what):
    got, want = got.float().numpy(), np.asarray(want, np.float32)
    lim = SCAN_TOL * np.abs(want).max()
    if dtype == "bfloat16":
        lim = lim + 2.0 ** -8 * np.abs(want)
    err = np.abs(got - want)
    assert (err <= lim).all(), (what, float(err.max()))


@pytest.mark.parametrize("case", SCAN_CASES)
def test_ssm_scan_bwd_ref_equals_autograd_and_jax_vjp(case):
    B, S, H, P, N, with_h0, with_dh, dtype = case
    x, dt, A, Bm, Cm, h0, dy, dh = _scan_inputs(B, S, H, P, N, with_h0,
                                                 seed=S + N)
    td = getattr(torch, dtype)
    seq = [_t(a).to(td) for a in (x, dt)] + [_t(A)] + \
        [_t(a).to(td) for a in (Bm, Cm)]
    h0t = None if h0 is None else _t(h0)
    dyt = _t(dy).to(td)
    dht = _t(dh) if with_dh else None
    got = TREF.ssm_scan_bwd_ref(*seq, h0t, dyt, dht)
    assert [g.dtype for g in got[:5]] == [td, td, torch.float32, td, td]
    assert (got[5] is None) == (h0 is None)

    leaves = [a.clone().requires_grad_() for a in seq]
    h0l = None if h0t is None else h0t.clone().requires_grad_()
    y, hT = TREF.ssm_scan_ref(*leaves, h0l)
    outs, cots = [y], [dyt]
    if dht is not None:
        outs, cots = [y, hT], [dyt, dht]
    auto = torch.autograd.grad(outs, leaves + ([h0l] if h0l is not None
                                               else []), cots)

    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    jin = [jnp.asarray(a, jd) for a in (x, dt)] + [jnp.asarray(A)] + \
        [jnp.asarray(a, jd) for a in (Bm, Cm)]
    if h0 is None:
        _, vjp = jax.vjp(lambda *a: JREF.ssm_scan_ref(*a), *jin)
    else:
        _, vjp = jax.vjp(lambda *a: JREF.ssm_scan_ref(*a), *jin,
                         jnp.asarray(h0))
    jdh = jnp.asarray(dh) if with_dh else jnp.zeros((B, H * P, N))
    want = vjp((jnp.asarray(dy, jd), jdh))

    names = ["dx", "ddt", "dA", "dB", "dC", "dh0"]
    for i, name in enumerate(names[:len(auto)]):
        _scan_close(got[i], auto[i].float().numpy(), dtype, f"{name} vs "
                    f"autograd")
        _scan_close(got[i], np.asarray(want[i], np.float32), dtype,
                    f"{name} vs jax.vjp")


def test_ssm_scan_bwd_ref_at_zero_steps():
    x, dt, A, Bm, Cm, h0, dy, dh = _scan_inputs(2, 0, 2, 4, 8, True, 3)
    got = TREF.ssm_scan_bwd_ref(*(_t(a) for a in (x, dt, A, Bm, Cm, h0, dy)),
                                _t(dh))
    assert got[0].shape == (2, 0, 8) and float(got[2].abs().max()) == 0.0
    assert torch.equal(got[5], _t(dh))


# ---------------------------------------------------------------------------
# loss and gradients, STRADS, the CLI
# ---------------------------------------------------------------------------

TRAIN_CASES = [  # arch, config overrides, sequence length
    (PHI, {}, 24),
    (PHI, {"moe_impl": "sort"}, 24),
    (LLAMA4, {}, 24),
    (ZAMBA, {}, 24),
    (ZAMBA, {}, 136),   # over 128 and ragged: the SSD form's scan fallback
    (CHATGLM, {}, 24),  # rope over half the head
    # ChatGLM3's group of 16 query heads a kv head (32/2; reduced has 8)
    (CHATGLM, {"num_heads": 32, "head_dim": 8}, 24),
    (STABLELM, {}, 24),  # LayerNorm, rope over a quarter of the head
]


@pytest.mark.parametrize("arch,over,S", TRAIN_CASES)
def test_train_step_loss_and_grads_equal_jax(arch, over, S):
    """Loss and every gradient leaf of ``loss_fn`` (the router's aux loss
    included) at the reference's init with the layer weights scaled by
    0.1."""
    j = dataclasses.replace(jget(arch).reduced(), **over)
    c = _port_cfg(j)
    jp = _scaled(JM.init_params(j, jax.random.PRNGKey(0)), 0.1)
    tp = model_params_from_jax(_np(jp), c, "cpu")
    r = np.random.default_rng(S)
    toks = r.integers(0, j.vocab_size, (2, S + 1))
    jb = {"tokens": jnp.asarray(toks[:, :-1], jnp.int32),
          "labels": jnp.asarray(toks[:, 1:], jnp.int32)}
    tb = {"tokens": _t(toks[:, :-1]), "labels": _t(toks[:, 1:])}
    (lj, mj), gj = jax.jit(jax.value_and_grad(
        lambda p: JSTEP.loss_fn(j, p, jb), has_aux=True))(jp)
    (lt, mt), gt = TSTEP.value_and_grad(c, tp, tb)
    assert abs(float(lt) - float(lj)) <= LOSS_RTOL * abs(float(lj))
    if j.family == "moe":
        assert j.router_aux_weight > 0
        assert float(mt["aux"]) == pytest.approx(float(mj["aux"]), rel=1e-5)
    gj, gt = _flat_np(gj), _flat_np(gt)
    assert set(gj) == set(gt)
    for n in gj:
        assert _max_rel(gt[n], gj[n]) <= GRAD_TOL, n


@pytest.mark.parametrize("arch", [PHI, ZAMBA])
def test_strads_layer_blocks_and_step_masks_equal_jax(arch):
    """The layer groups map to blocks as in the JAX package (the hybrid
    family's shared block with the unstacked leaves); a STRADS step on the
    JAX Gumbel draw applies the mask JAX selects, and with no weight decay
    the blocks it left out keep their bits."""
    j = jget(arch).reduced()
    c = _port_cfg(j)
    jp = JM.init_params(j, jax.random.PRNGKey(0))
    tp = model_params_from_jax(_np(jp), c, "cpu")
    mj, nj = JSTEP.layer_blocks(j, jp)
    mt, nt = TSTEP.layer_blocks(c, tp)
    assert (mt, nt) == (mj, nj)
    kw = dict(num_blocks=nt, blocks_per_step=1, candidates_per_step=2,
              min_distance=1)
    tc = TSTEP.TrainConfig(adamw=AdamWConfig(weight_decay=0.0),
                           peak_lr=1e-3)
    st = TSTEP.init_strads_state(c, tc, TB.BlockScheduleConfig(**kw),
                                 torch.Generator().manual_seed(0))
    st["params"] = tp
    step = TSTEP.make_strads_train_step(c, tc, TB.BlockScheduleConfig(**kw))
    toks = np.random.default_rng(1).integers(0, j.vocab_size, (2, 13))
    bt = {"tokens": _t(toks[:, :-1]), "labels": _t(toks[:, 1:])}
    key = jax.random.PRNGKey(3)
    want = JB.select_blocks(JB.BlockScheduleConfig(**kw),
                            jnp.asarray(st["priority"].numpy()), key)
    g = np.array(jax.random.gumbel(key, (nt,), jnp.float32))
    before = {n: x.clone() for n, x in tree_flatten(tp)}
    st, m = step(st, bt, gumbel=_t(g))
    mask = m["mask"]
    np.testing.assert_array_equal(mask.numpy(), np.asarray(want))
    assert float(mask.sum()) == 1.0
    for n, x in tree_flatten(st["params"]):
        if n.startswith("layers/"):
            for layer in range(x.shape[0]):
                assert torch.equal(x[layer], before[n][layer]) == \
                    (mask[layer] == 0), (n, layer)
        else:
            assert torch.equal(x, before[n]) == (mask[mt[n]] == 0), n


@pytest.mark.parametrize("arch", [PHI, ZAMBA])
def test_train_state_from_jax_carries_every_leaf(arch):
    """A JAX STRADS train state of each family (its router, expert and
    Mamba2 leaves, the moments, the priorities) converts leaf for leaf."""
    from repro.optim import adamw as JA
    from repro_torch import convert
    j = jget(arch).reduced()
    c = _port_cfg(j)
    nb = JSTEP.layer_blocks(j, JM.init_params(j, jax.random.PRNGKey(0)))[1]
    kw = dict(num_blocks=nb, blocks_per_step=1, candidates_per_step=2,
              min_distance=1)
    sj = JSTEP.init_strads_state(
        j, JSTEP.TrainConfig(adamw=JA.AdamWConfig()),
        JB.BlockScheduleConfig(**kw), jax.random.PRNGKey(1))
    st = convert.train_state_from_jax(
        _np(sj), c, "cpu", generator=torch.Generator().manual_seed(0))
    want = _flat_np({k: v for k, v in sj.items() if k != "rng"})
    got = _flat_np({k: v for k, v in st.items() if k != "rng"})
    assert set(got) == set(want)
    for n in want:
        np.testing.assert_array_equal(got[n], want[n], err_msg=n)
    family_leaf = "router" if arch == PHI else "mamba0/A_log"
    assert any(family_leaf in n and n.startswith("opt/") for n in got)


@pytest.mark.parametrize("arch,seq,strads", [
    (PHI, 32, False), (PHI, 32, True), (ZAMBA, 136, False),
    (ZAMBA, 136, True), (LLAMA4, 32, False), (GRANITE, 32, False),
    (STABLELM, 32, False), (CHATGLM, 32, False)])
def test_cli_trains_and_the_loss_falls(arch, seq, strads):
    """``launch/train.py --preset reduced --device cpu`` for both
    families (Zamba2 at 136 tokens: the scan's plain version), plain and
    STRADS; plain for Llama-4 and the three dense archs (their STRADS CLI
    runs are in ``tests/test_torch_zoo.py``: over 4 STRADS steps of half
    the blocks the reference's init lets StableLM's loss rise, the JAX
    package's own run too)."""
    argv = ["--arch", arch, "--preset", "reduced", "--steps", "4",
            "--batch", "2", "--seq", str(seq), "--device", "cpu",
            "--log-every", "1"] + (["--strads"] if strads else [])
    hist = TLT.main(argv)
    losses = [h["loss"] for h in hist]
    assert len(losses) == 4 and all(np.isfinite(losses))
    assert losses[-1] < losses[0], losses
