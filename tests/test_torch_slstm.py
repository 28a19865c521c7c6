"""xLSTM's sLSTM recurrence in the port (``kernels/slstm_scan.py``, its
plain versions in ``kernels/ref.py`` and the route in ``models/xlstm.py``)
against the JAX package's ``models/xlstm.py``.

On the CPU: ``slstm_scan_ref`` against the JAX cell under ``lax.scan``
(from no state and from a state), ``slstm_scan_bwd_ref`` against torch
autograd through the plain loop and against ``jax.vjp`` (of the scan, and
of the whole ``slstm_apply`` block with the port's block sent through
``ops.slstm_scan``, whose backward on the CPU is ``slstm_scan_bwd_ref``),
with cases that meet the ties of ``max(n, 1)`` (every first step from no
state) and of ``max(logσ(f) + m, i)``.  Inputs are made with numpy from
a seed.  Tolerances are ``tests/test_torch_zoo.py``'s ``assert_step``
(rtol 1e-4, atol 1e-5 of the largest value compared; f32 on both sides,
sums in another order).

The tests marked ``gpu`` hold the CUDA kernels against the plain versions
on the card (``PYTHONPATH=src pytest -m gpu tests/test_torch_slstm.py``):
forward within 1e-4 and backward within 1e-3 of each output's largest
magnitude (f32 on both sides; the kernel sums h·W_r over d, and dg·W_rᵀ
over 4d, in another order, and 2,048 steps carry the difference), and
two runs equal to the bit.  The machine with the card has no JAX, so JAX
is imported inside the CPU tests only.
"""
import dataclasses
import importlib

import numpy as np
import pytest
import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import slstm_scan as tsl
from repro_torch.models import xlstm as TX


def assert_step(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-4,
                               atol=1e-5 * max(1.0, np.abs(want).max()))


def _inputs(B, S, d, seed, state=True, wr_scale=0.5):
    """gx (B, S, 4d), wr (d, 4d), bias (4d,) and a state (c, n ≥ 1, m,
    h) or None, numpy f32."""
    r = np.random.default_rng(seed)
    f = lambda *s: r.standard_normal(s).astype(np.float32)
    gx, wr, bias = f(B, S, 4 * d), f(d, 4 * d) * (wr_scale / d ** 0.5), \
        f(4 * d) * 0.5
    st = ((f(B, d), np.abs(f(B, d)) + 1, f(B, d), f(B, d)) if state
          else None)
    return gx, wr, bias, st


def _tie_inputs(B=2, S=6, d=8):
    """A state and inputs whose first step ties both maxima: W_r = 0 and
    bias = 0, f = 100 (logσ(f) = −3.7e-44, lost against m = 0.5) and
    i = m tie max(logσ(f) + m, i), so fa = ia = 1, and n = 0 makes
    n_0 = 1, a tie of max(n, 1); from step 1 the inputs are random.  The
    initial state's dn and dm follow each tie's split."""
    gx, wr, bias, st = _inputs(B, S, d, seed=5)
    wr[:] = 0.0
    bias[:] = 0.0
    m = np.full((B, d), 0.5, np.float32)
    gx[:, 0, d:2 * d] = m
    gx[:, 0, 2 * d:3 * d] = 100.0
    return gx, wr, bias, (st[0], np.zeros_like(m), m, st[3])


def _case_inputs(case, S=40, seed=7, B=2, d=8):
    """``no_state`` (every first step ties max(n, 1), n = 1 exactly),
    ``state`` (n ≥ 1), ``zero_state`` (a state of zeros: m = 0,
    n = 0, so n < 1 and max(n, 1) clamps: h is not invariant to the
    stabiliser, and dm is real), ``m_tie`` (:func:`_tie_inputs`),
    ``one_step``."""
    if case == "m_tie":
        return _tie_inputs(B, 6 if (B, d) == (2, 8) else S, d)
    gx, wr, bias, st = _inputs(B, 1 if case == "one_step" else S, d,
                               seed=seed, state=case != "no_state")
    if case == "zero_state":
        st = tuple(np.zeros_like(a) for a in st)
        gx[:, :, d:2 * d] -= 3.0           # i below logσ(f): n_t < 1
    return gx, wr, bias, st


def _t(a, grad=False):
    t = torch.from_numpy(np.array(a))
    return t.requires_grad_() if grad else t


@pytest.fixture
def jx():
    """The JAX package's xLSTM module and jax itself (CPU tests only)."""
    jax = pytest.importorskip("jax")
    from repro.models import xlstm
    return jax, xlstm


def _jax_scan(jax, JX, gx, wr, bias, state):
    """The JAX package's recurrence: its ``_slstm_cell`` under
    ``lax.scan``, the loop of ``slstm_apply``; state None as
    ``slstm_apply`` makes it (m = −inf)."""
    jnp = jax.numpy
    B, S, d4 = gx.shape
    d = d4 // 4
    if state is None:
        z = jnp.zeros((B, d), jnp.float32)
        state = (z, z, jnp.full((B, d), -jnp.inf, jnp.float32), z)

    def step(carry, g):
        h, carry = JX._slstm_cell(g, wr, bias, carry, d)
        return carry, h
    final, hs = jax.lax.scan(step, tuple(state), jnp.moveaxis(gx, 1, 0))
    return jnp.moveaxis(hs, 0, 1), final


# ---------------------------------------------------------------------------
# CPU: the plain versions against the JAX package and autograd
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,S,d,state", [(2, 40, 8, False), (2, 40, 8, True),
                                         (1, 1, 16, True), (3, 17, 64, False)])
def test_slstm_scan_ref_equals_jax(jx, B, S, d, state):
    jax, JX = jx
    gx, wr, bias, st = _inputs(B, S, d, seed=S + d, state=state)
    hj, fj = _jax_scan(jax, JX, gx, wr, bias, st)
    ht, ft = tref.slstm_scan_ref(_t(gx), _t(wr), _t(bias),
                                 None if st is None else tuple(map(_t, st)))
    assert_step(ht.numpy(), hj)
    for a, b in zip(ft, fj):
        assert_step(a.numpy(), b)
    # what save=True adds does not change hs or the state, and its last
    # step is the final state
    hs2, ft2, (G, C, N, M) = tref.slstm_scan_ref(
        _t(gx), _t(wr), _t(bias), None if st is None
        else tuple(map(_t, st)), save=True)
    assert torch.equal(hs2, ht)
    assert G.shape == (B, S, 4 * d) and C.shape == N.shape == M.shape \
        == (B, S, d)
    for a, b in zip((C, N, M, hs2), ft2):
        assert torch.equal(a[:, -1], b)


def _autograd_grads(gx, wr, bias, st, dhs, dfinal):
    """Torch autograd through the plain loop: the gradients of
    Σ hs·dhs + Σ final·dfinal at (gx, wr, bias, the state)."""
    ins = [_t(gx, True), _t(wr, True), _t(bias, True)]
    state = None if st is None else tuple(_t(a, True) for a in st)
    hs, final = tref.slstm_scan_ref(*ins, state)
    loss = (hs * _t(dhs)).sum() + sum((a * _t(b)).sum()
                                      for a, b in zip(final, dfinal))
    return torch.autograd.grad(loss, ins + ([] if state is None
                                            else list(state)))


def _sweep_grads(gx, wr, bias, st, dhs, dfinal):
    """The same gradients from ``slstm_scan_bwd_ref`` and
    ``slstm_param_grads``."""
    state = None if st is None else tuple(map(_t, st))
    hs, _, saved = tref.slstm_scan_ref(_t(gx), _t(wr), _t(bias), state,
                                       save=True)
    dG, dstate = tref.slstm_scan_bwd_ref(_t(wr), state, saved, _t(dhs),
                                         tuple(map(_t, dfinal)))
    dwr, dbias = tref.slstm_param_grads(dG, hs,
                                        None if st is None else state[3])
    return (dG, dwr, dbias) + (() if st is None else dstate)


CASES = ["no_state", "state", "zero_state", "m_tie", "one_step"]


@pytest.mark.parametrize("case", CASES)
def test_slstm_scan_bwd_ref_equals_autograd(case):
    """The cases of :func:`_case_inputs`."""
    gx, wr, bias, st = _case_inputs(case)
    B, S, d = gx.shape[0], gx.shape[1], gx.shape[2] // 4
    r = np.random.default_rng(11)
    dhs = r.standard_normal((B, S, d)).astype(np.float32)
    dfinal = tuple(r.standard_normal((B, d)).astype(np.float32)
                   for _ in range(4))
    want = _autograd_grads(gx, wr, bias, st, dhs, dfinal)
    got = _sweep_grads(gx, wr, bias, st, dhs, dfinal)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert_step(g.numpy(), w.numpy())


def test_tie_inputs_tie():
    """``_tie_inputs`` meets the ties it is for: logσ(f) + m == i and
    n_0 == 1."""
    gx, wr, bias, st = _tie_inputs()
    d = gx.shape[2] // 4
    a = torch.nn.functional.logsigmoid(_t(gx[:, 0, 2 * d:3 * d])) \
        + _t(st[2])
    assert torch.equal(a, _t(gx[:, 0, d:2 * d]))
    _, _, (_, _, N, _) = tref.slstm_scan_ref(
        _t(gx), _t(wr), _t(bias), tuple(map(_t, st)), save=True)
    assert bool((N[:, 0] == 1).all())


@pytest.mark.parametrize("case", CASES)
def test_slstm_scan_bwd_ref_equals_jax_vjp(jx, case):
    jax, JX = jx
    jnp = jax.numpy
    gx, wr, bias, st = _case_inputs(case, seed=13)
    B, S, d = gx.shape[0], gx.shape[1], gx.shape[2] // 4
    r = np.random.default_rng(17)
    dhs = r.standard_normal((B, S, d)).astype(np.float32)
    dfinal = tuple(r.standard_normal((B, d)).astype(np.float32)
                   for _ in range(4))
    args = (gx, wr, bias) + (() if st is None else (tuple(st),))
    f = (lambda g, w, b: _jax_scan(jax, JX, g, w, b, None)) \
        if st is None else (lambda g, w, b, s: _jax_scan(jax, JX, g, w, b, s))
    _, vjp = jax.vjp(f, *(jax.tree.map(jnp.asarray, a) for a in args))
    want = vjp((jnp.asarray(dhs), tuple(map(jnp.asarray, dfinal))))
    want = list(want[:3]) + ([] if st is None else list(want[3]))
    got = _sweep_grads(gx, wr, bias, st, dhs, dfinal)
    for g, w in zip(got, want):
        assert_step(g.numpy(), w)


@pytest.mark.parametrize("S,state", [(40, False), (40, True), (1, True)])
def test_slstm_block_through_the_scan_op_equals_jax_vjp(jx, monkeypatch,
                                                        S, state):
    """The whole ``slstm_apply`` block (norm, W_x, the recurrence, W_down,
    the residual) with the port's recurrence sent through
    ``ops.slstm_scan`` (the kernel's route, here its plain forward and
    ``slstm_scan_bwd_ref``) against ``jax.vjp`` of the JAX package's
    block: dx, every weight's gradient and the initial state's."""
    jax, JX = jx
    jnp = jax.numpy
    from repro.configs import get_config as jget
    from repro_torch.configs.base import ModelConfig
    d = 32
    j = dataclasses.replace(jget("xlstm-125m").reduced(), d_model=d)
    cfg = ModelConfig(**dataclasses.asdict(j))
    r = np.random.default_rng(S + 3)
    f = lambda *s: r.standard_normal(s).astype(np.float32)
    p = {"norm": {"scale": 1 + 0.1 * f(d)}, "wx": f(d, 4 * d) * d ** -0.5,
         "wr": f(d, 4 * d) * 0.5 * d ** -0.5, "bias": f(4 * d) * 0.5,
         "wdown": f(d, d) * d ** -0.5}
    x, dy = f(2, S, d), f(2, S, d)
    st = (f(2, d), np.abs(f(2, d)) + 1, f(2, d), f(2, d)) if state else None
    dst = tuple(f(2, d) for _ in range(4))

    jp = jax.tree.map(jnp.asarray, p)
    if st is None:
        fj = lambda p_, x_: JX.slstm_apply(p_, x_, j, return_state=True)
        (yj, sj), vjp = jax.vjp(fj, jp, jnp.asarray(x))
    else:
        fj = lambda p_, x_, s_: JX.slstm_apply(p_, x_, j, state=s_,
                                               return_state=True)
        (yj, sj), vjp = jax.vjp(fj, jp, jnp.asarray(x),
                                tuple(map(jnp.asarray, st)))
    gj = vjp((jnp.asarray(dy), tuple(map(jnp.asarray, dst))))

    monkeypatch.setattr(TX, "slstm_route", lambda device_type: "kernel")
    calls = {"n": 0}
    real = tops.slstm_scan

    def counted(*a, **k):
        calls["n"] += 1
        return real(*a, **k)
    monkeypatch.setattr(tops, "slstm_scan", counted)
    tp = {"norm": {"scale": _t(p["norm"]["scale"], True)},
          **{k: _t(v, True) for k, v in p.items() if k != "norm"}}
    xt = _t(x, True)
    stt = None if st is None else tuple(_t(a, True) for a in st)
    before = dict(tops.LAUNCHES)
    yt, sto = TX.slstm_apply(tp, xt, cfg, state=stt)
    assert calls["n"] == 1 and tops.LAUNCHES == before   # plain on the CPU
    assert_step(yt.detach().numpy(), yj)
    for a, b in zip(sto, sj):
        assert_step(a.detach().numpy(), b)
    loss = (yt * _t(dy)).sum() + sum((a * _t(b)).sum()
                                     for a, b in zip(sto, dst))
    leaves = [xt, tp["norm"]["scale"], tp["wx"], tp["wr"], tp["bias"],
              tp["wdown"]] + ([] if stt is None else list(stt))
    got = torch.autograd.grad(loss, leaves)
    want = [gj[1], gj[0]["norm"]["scale"], gj[0]["wx"], gj[0]["wr"],
            gj[0]["bias"], gj[0]["wdown"]] + ([] if st is None
                                              else list(gj[2]))
    for g, w in zip(got, want):
        assert_step(g.numpy(), w)


def test_slstm_route():
    assert TX.slstm_route("cpu") == "plain"
    assert TX.slstm_route("cuda") == "kernel"


def test_slstm_block_on_the_cpu_keeps_the_cell_loop(monkeypatch):
    """On the CPU ``slstm_apply`` runs the cell in its loop and never
    reaches ``ops.slstm_scan``."""
    def refuse(*a, **k):
        raise AssertionError("ops.slstm_scan called on the CPU route")
    monkeypatch.setattr(tops, "slstm_scan", refuse)
    d = 16
    from repro_torch.configs import get_config
    cfg = dataclasses.replace(get_config("xlstm-125m").reduced(), d_model=d)
    r = np.random.default_rng(1)
    f = lambda *s: _t(r.standard_normal(s).astype(np.float32))
    p = {"norm": {"scale": f(d)}, "wx": f(d, 4 * d), "wr": f(d, 4 * d) * 0.1,
         "bias": f(4 * d), "wdown": f(d, d)}
    y, st = TX.slstm_apply(p, f(2, 5, d), cfg)
    assert y.shape == (2, 5, d) and len(st) == 4


def test_ops_slstm_scan_on_the_cpu_is_the_plain_version():
    gx, wr, bias, st = _inputs(2, 9, 8, seed=2)
    args = (_t(gx), _t(wr), _t(bias), tuple(map(_t, st)))
    before = dict(tops.LAUNCHES)
    hs, final = tops.slstm_scan(*args)
    hr, fr = tref.slstm_scan_ref(*args)
    assert tops.LAUNCHES == before
    assert torch.equal(hs, hr)
    assert all(torch.equal(a, b) for a, b in zip(final, fr))


def test_slstm_kernel_wrapper_refuses_cpu_tensors():
    gx, wr, bias, _ = _inputs(1, 3, 8, seed=0, state=False)
    with pytest.raises(ValueError, match="one card"):
        tsl.slstm_scan(_t(gx), _t(wr), _t(bias))
    with pytest.raises(ValueError, match=r"\(B, S, 4d\)"):
        tsl.slstm_scan(_t(gx[:, :, :5]), _t(wr), _t(bias))


def test_importing_the_slstm_wrapper_builds_nothing(monkeypatch):
    def refuse(names):
        raise AssertionError(f"built {names} at import")
    monkeypatch.setattr(_build, "build", refuse)
    importlib.reload(tsl)
    assert "slstm_scan" not in _build._libs


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU "
                    "mode (their plain versions are tested above)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _close(got, want, tol):
    scale = max(1.0, want.abs().max().item())
    err = (got - want).abs().max().item()
    assert err <= tol * scale, (err, scale)


def _on_card_matches_plain(cuda, gx, wr, bias, st, seed):
    """The kernels' forward (hs, the final state, what the backward
    reads) and backward (dG, and the initial state's dc, dn, dm, dh when
    a state is given) against the plain versions, each backward twice to
    the bit; numpy inputs."""
    B, S, d4 = gx.shape
    d = d4 // 4
    gx, wr, bias = (torch.from_numpy(a).to(cuda) for a in (gx, wr, bias))
    st = None if st is None else tuple(torch.from_numpy(a).to(cuda)
                                       for a in st)
    hs, final, saved = tsl.slstm_scan(gx, wr, bias, st, save=True)
    hs2, final2 = tsl.slstm_scan(gx, wr, bias, st)
    torch.cuda.synchronize()
    assert torch.equal(hs, hs2)                 # saving changes nothing
    assert all(torch.equal(a, b) for a, b in zip(final, final2))
    hr, fr, sr = tref.slstm_scan_ref(gx, wr, bias, st, save=True)
    _close(hs, hr, 1e-4)
    for a, b in zip(final + saved, fr + sr):
        _close(a, b, 1e-4)
    r = torch.Generator(device=cuda).manual_seed(seed)
    dhs = torch.randn(hs.shape, generator=r, device=cuda)
    dfinal = tuple(torch.randn(st[0].shape if st else (B, d), generator=r,
                               device=cuda) for _ in range(4))
    dG, dstate = tsl.slstm_scan_bwd(wr, st, saved, dhs, dfinal)
    dG2, dstate2 = tsl.slstm_scan_bwd(wr, st, saved, dhs, dfinal)
    torch.cuda.synchronize()
    assert torch.equal(dG, dG2)                 # no atomics: same bits
    assert all(torch.equal(a, b) for a, b in zip(dstate, dstate2))
    dGr, dsr = tref.slstm_scan_bwd_ref(wr, st, sr, dhs, dfinal)
    _close(dG, dGr, 1e-3)
    if st is not None:
        for a, b in zip(dstate, dsr):
            _close(a, b, 1e-3)


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,d,state", [
    (4, 1, 768, True), (4, 37, 768, False), (1, 2048, 768, False),
    (4, 2048, 768, True), (4, 300, 770, True), (1, 5, 40, False),
    (13, 50, 768, True), (16, 300, 768, True), (32, 64, 768, False),
    (48, 40, 768, True), (128, 1, 768, True), (128, 30, 768, False),
    (133, 20, 768, True)])
def test_slstm_kernels_match_plain_on_card(cuda, B, S, d, state):
    """Forward and backward against the plain versions at S = 1 (decode),
    a ragged S and 2,048; B 1 and 4; d = 768 (6 units a block, W_r's
    slice in registers), 770 (the last block holds 2; the slice in shared
    memory) and 40 (one a block); and B from 13 to 133, of which 128 and
    133 run as several chunks of batch rows in one launch, forward and
    backward (at d = 768 a chunk holds at most 67 rows forward and 60
    backward on an H100), the last chunk shorter at B = 133."""
    gx, wr, bias, st = _inputs(B, S, d, seed=S + d, state=state)
    _on_card_matches_plain(cuda, gx, wr, bias, st, seed=S)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["no_state", "zero_state", "m_tie"])
def test_slstm_kernels_match_plain_on_card_at_the_ties(cuda, case):
    """The CPU cases at d = 768 on the card, where the gradient's path
    through the stabiliser shows: a state of zeros (m = 0, n = 0) with i
    lowered (n_t < 1, so max(n, 1) clamps and dm is real), both maxima
    tied on the first step, and the tie of max(n, 1) from no state."""
    gx, wr, bias, st = _case_inputs(case, S=64, seed=11, B=4, d=768)
    _on_card_matches_plain(cuda, gx, wr, bias, st, seed=11)


@pytest.mark.gpu
def test_slstm_ops_under_grad_on_card(cuda):
    """``ops.slstm_scan`` on the card under grad: one forward and one
    backward launch, the gradients of every input those of the plain
    version's autograd Function."""
    B, S, d = 4, 64, 768
    gx, wr, bias, st = _inputs(B, S, d, seed=3)
    mk = lambda a: torch.from_numpy(a).to(cuda).requires_grad_()
    ins = [mk(gx), mk(wr), mk(bias)]
    state = tuple(mk(a) for a in st)
    grads = []
    for fn in (tops.slstm_scan, tops.slstm_scan_plain):
        before = dict(tops.LAUNCHES)
        hs, final = fn(*ins, state)
        loss = hs.square().sum() + sum(t.sum() for t in final)
        grads.append(torch.autograd.grad(loss, ins + list(state)))
        n = int(fn is tops.slstm_scan)
        assert tops.LAUNCHES["slstm_scan"] == before["slstm_scan"] + n
        assert tops.LAUNCHES["slstm_scan_bwd"] == before["slstm_scan_bwd"] + n
    for a, b in zip(*grads):
        _close(a, b, 1e-3)


@pytest.mark.gpu
def test_slstm_plan_and_barriers_on_card(cuda):
    p = tsl.plan(4, 768)
    assert p["u"] * p["blocks"] >= 768 and p["blocks"] <= p["sms"]
    assert p["smem_fwd"] <= p["smem_optin"]
    assert p["smem_bwd"] <= p["smem_optin"]
    assert p["chunks_fwd"] == p["chunks_bwd"] == 1
    for B in (13, 16, 32, 128, 512):
        p = tsl.plan(B, 768, backward=True)
        for k in ("fwd", "bwd"):
            rows, chunks = p[f"rows_{k}"], p[f"chunks_{k}"]
            assert p[f"smem_{k}"] <= p["smem_optin"]
            assert (chunks - 1) * rows < B <= chunks * rows
            assert rows >= -(-B // chunks)
    assert tsl.plan(16, 768)["chunks_bwd"] == 1
    p = tsl.plan(128, 768)
    assert p["chunks_fwd"] >= 2 and p["chunks_bwd"] >= 2
    assert p["w_in_registers"] and not tsl.plan(4, 770)["w_in_registers"]
    tsl.barriers(4, 2048, 768, cuda)
    torch.cuda.synchronize()
    with pytest.raises(ValueError, match="d=8192"):
        tsl.plan(4, 8192)


@pytest.mark.gpu
def test_slstm_ring_never_takes_a_stale_tag(cuda, monkeypatch):
    """The exchange ring's tags from an earlier launch never match.  Every
    call here gets the same memory for its ring (a prefix of one buffer),
    so it finds the last call's tags there: two calls back to back, a
    call after one at another B (other chunk counts, so other tags), and
    a CUDA graph of the forward and the backward replayed 3 times all
    give the bits of the first call."""
    B, S, d = 4, 64, 768
    gx, wr, bias, st = _inputs(B, S, d, seed=23)
    gx, wr, bias = (torch.from_numpy(a).to(cuda) for a in (gx, wr, bias))
    st = tuple(torch.from_numpy(a).to(cuda) for a in st)
    dhs = torch.randn((B, S, d), generator=torch.Generator(
        device=cuda).manual_seed(23), device=cuda)
    dfinal = tuple(torch.randn((B, d), generator=torch.Generator(
        device=cuda).manual_seed(24 + i), device=cuda) for i in range(4))
    big_plan = tsl.plan(128, d)
    assert big_plan["chunks_fwd"] >= 2 and big_plan["chunks_bwd"] >= 2
    pool = tsl._ring(max(tsl.plan(n, d)[k] for n in (B, 128)
                         for k in ("ring_fwd", "ring_bwd")), cuda)
    monkeypatch.setattr(tsl, "_ring", lambda nbytes, device:
                        pool[:nbytes // 8])

    def both():
        hs, final, saved = tsl.slstm_scan(gx, wr, bias, st, save=True)
        dG, dstate = tsl.slstm_scan_bwd(wr, st, saved, dhs, dfinal)
        return (hs,) + final + saved + (dG,) + dstate

    def same(a, b):
        return all(torch.equal(x, y) for x, y in zip(a, b))
    want = both()
    torch.cuda.synchronize()
    assert pool.any()                          # the ring holds tags now
    assert same(both(), want)
    big = _inputs(128, 30, d, seed=25)
    big = [torch.from_numpy(a).to(cuda) for a in big[:3]] + [tuple(
        torch.from_numpy(a).to(cuda) for a in big[3])]
    hs, _, saved = tsl.slstm_scan(*big, save=True)
    tsl.slstm_scan_bwd(big[1], big[3], saved, torch.ones_like(hs))
    del hs, saved
    assert same(both(), want)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        both()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g, stream=side):
        out = both()
    for _ in range(3):
        for t in out:
            t.zero_()
        g.replay()
        torch.cuda.synchronize()
        assert same(out, want)
