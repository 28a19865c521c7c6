"""The port's Mamba2 block (``repro_torch.models.ssm``) against the JAX
package's ``models/ssm.py``, on the CPU.

Inputs are made with numpy from a seed and fed to both; the layer's
weights are the JAX init of Zamba2-2.7B ``.reduced()`` carried over with
``model_params_from_jax``.  Tolerances, all in f32:
  * the scan and everything around it: rtol = 1e-4 and atol = 1e-5 of the
    largest value compared (f32 sums in another order; the reference's
    stacked fan-in init makes the layer's values reach ~10⁴);
  * the SSD (chunked matmul) form at that init: dt·A reaches −300 a
    step, so a chunk's cumulative log decay runs to −4·10⁴, and the JAX
    package's exp(L_t − L_r), a difference of two such f32 values, loses
    digits: its SSD and scan forms of the same layer differ by e.  The
    port sums each segment directly, so its SSD is held to the
    reference's *scan* form at the tight tolerance, and to the
    reference's SSD form within e plus that tolerance (the triangle
    inequality).  On well-conditioned inputs both SSD forms agree at the
    tight tolerance.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.models import model as JM
from repro.models import ssm as JSSM

from repro_torch.configs.base import ModelConfig
from repro_torch.convert import model_params_from_jax
from repro_torch.models import params as TP
from repro_torch.models import ssm as TSSM


def assert_step(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-4,
                               atol=1e-5 * max(1.0, np.abs(want).max()))


def _layer(seed=0, **over):
    """Layer 0's mamba0 parameters of Zamba2 reduced, in both packages."""
    j = dataclasses.replace(jget("zamba2-2.7b").reduced(), **over)
    c = ModelConfig(**dataclasses.asdict(j))
    jp = JM.init_params(j, jax.random.PRNGKey(seed))
    pj = jax.tree.map(lambda t: t[0], jp["layers"]["mamba0"])
    pt = TP.tree_map(lambda _, t: t[0], model_params_from_jax(
        jax.tree.map(np.asarray, jp), c, "cpu")["layers"]["mamba0"])
    return j, c, pj, pt


def _scan_inputs(B, S, C, N, seed=0, per_head=None):
    """Well-conditioned scan inputs: dt = softplus(N(0,1) − 1), A =
    −exp(U(−1, 1)); dt and A per head (``per_head`` heads of 64
    channels) or per channel."""
    r = np.random.default_rng(seed)
    H = per_head or C
    x = r.standard_normal((B, S, C)).astype(np.float32)
    dt = np.log1p(np.exp(r.standard_normal((B, S, H)) - 1)).astype(
        np.float32)
    A = -np.exp(r.uniform(-1, 1, H)).astype(np.float32)
    Bm = r.standard_normal((B, S, N)).astype(np.float32)
    Cm = r.standard_normal((B, S, N)).astype(np.float32)
    h0 = r.standard_normal((B, C, N)).astype(np.float32)
    return x, dt, A, Bm, Cm, h0


def _both(fn_j, fn_t, arrays):
    """Call the JAX and the port function on the same numpy arrays (None
    stays None)."""
    out_j = fn_j(*(None if a is None else jnp.asarray(a) for a in arrays))
    out_t = fn_t(*(None if a is None else torch.from_numpy(a)
                   for a in arrays))
    return out_j, out_t


# ---------------------------------------------------------------------------
# the scan over the whole sequence, and the SSD form
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("with_h0", [True, False])
def test_single_call_scan_matches_jax_chunked_scan(with_h0):
    # S = 200: the JAX package splits it into default_chunk(200) = 10-step
    # pieces, 20 kernel calls under jax.checkpoint; the port makes one
    x, dt, A, Bm, Cm, h0 = _scan_inputs(2, 200, 128, 16, seed=1)
    from repro.models.scan_utils import default_chunk
    assert default_chunk(200) == 10
    arrays = (x, dt, A, Bm, Cm, h0 if with_h0 else None)
    (yj, hj), (yt, ht) = _both(JSSM._chunked_ssm_scan,
                               TSSM._chunked_ssm_scan, arrays)
    assert yt.shape == (2, 200, 128) and ht.dtype == torch.float32
    assert_step(yt.numpy(), yj)
    assert_step(ht.numpy(), hj)


@pytest.mark.parametrize("S,per_head,with_h0", [
    (256, True, True),          # two chunks of 128, dt/A per head
    (256, False, False),        # per channel (broadcast), h0 None
    (128, True, False),         # one chunk
    (96, True, True),           # one chunk of 96 (Lc = S)
    (200, True, True),          # ragged: falls back to the scan
])
def test_ssd_chunked_matches_jax(S, per_head, with_h0):
    C, N = 256, 16
    x, dt, A, Bm, Cm, h0 = _scan_inputs(2, S, C, N, seed=S,
                                        per_head=C // 64)
    if not per_head:
        dt, A = np.repeat(dt, 64, -1), np.repeat(A, 64)
    arrays = (x, dt, A, Bm, Cm, h0 if with_h0 else None)
    (yj, hj), (yt, ht) = _both(JSSM.ssd_chunked, TSSM.ssd_chunked, arrays)
    assert yt.shape == (2, S, C) and ht.shape == (2, C, N)
    assert_step(yt.numpy(), yj)
    assert_step(ht.numpy(), hj)


def test_causal_conv_and_gnorm_match_jax():
    r = np.random.default_rng(3)
    xc = r.standard_normal((2, 9, 40)).astype(np.float32)
    w = r.standard_normal((4, 40)).astype(np.float32)
    b = r.standard_normal(40).astype(np.float32)
    st = r.standard_normal((2, 3, 40)).astype(np.float32)
    for state in (None, st):
        (oj, sj), (ot, s_t) = _both(JSSM._causal_conv, TSSM._causal_conv,
                                    (xc, w, b, state))
        assert_step(ot.numpy(), oj)
        assert_step(s_t.numpy(), sj)
    g = r.standard_normal(40).astype(np.float32)
    assert_step(TSSM.rms_gnorm(torch.from_numpy(xc), torch.from_numpy(g),
                               1e-5).numpy(),
                JSSM.rms_gnorm(jnp.asarray(xc), jnp.asarray(g), 1e-5))


# ---------------------------------------------------------------------------
# the block: prefill on the scan path and the SSD path, and a decode step
# ---------------------------------------------------------------------------

def _apply_both(j, c, pj, pt, x, state=None):
    sj = None if state is None else jax.tree.map(jnp.asarray, state)
    st = None if state is None else {k: torch.from_numpy(np.array(v))
                                     for k, v in state.items()}
    yj, nj = JSSM.ssm_apply(pj, jnp.asarray(x), j, state=sj)
    yt, nt = TSSM.ssm_apply(pt, torch.from_numpy(x), c, state=st)
    return (yj, nj), (yt, nt)


def test_ssm_apply_prefill_on_the_scan_path_matches_jax():
    # S = 200 > 128 and not a multiple of it: ssd_chunked falls back to
    # the scan kernel (its plain version on the CPU)
    j, c, pj, pt = _layer()
    x = np.random.default_rng(4).standard_normal(
        (2, 200, c.d_model)).astype(np.float32)
    (yj, nj), (yt, nt) = _apply_both(j, c, pj, pt, x)
    assert_step(yt.numpy(), yj)
    assert nt["h"].dtype == torch.float32
    for k in ("h", "conv"):
        assert_step(nt[k].numpy(), nj[k])
    # the zero state the model passes in a prefill is the same as none
    zero = {"h": np.zeros((2, 512, 16), np.float32),
            "conv": np.zeros((2, 3, 512 + 32), np.float32)}
    _, (yz, nz) = _apply_both(j, c, pj, pt, x, zero)
    assert torch.equal(yz, yt) and torch.equal(nz["h"], nt["h"])


def test_ssm_apply_prefill_on_the_ssd_path_matches_jax():
    j, c, pj, pt = _layer()
    x = np.random.default_rng(5).standard_normal(
        (2, 256, c.d_model)).astype(np.float32)
    (yj, nj), (yt, nt) = _apply_both(j, c, pj, pt, x)
    js = dataclasses.replace(j, ssm_impl="scan")
    ys, ns = JSSM.ssm_apply(pj, jnp.asarray(x), js)
    for got, ssd, scan in ((yt, yj, ys), (nt["h"], nj["h"], ns["h"])):
        got, ssd, scan = got.numpy(), np.asarray(ssd), np.asarray(scan)
        assert_step(got, scan)
        e = np.abs(ssd - scan).max()             # the reference's own
        assert np.abs(got - ssd).max() <= \
            e + 1e-5 * np.abs(scan).max() + 1e-4 * np.abs(ssd).max()
    assert_step(nt["conv"].numpy(), nj["conv"])
    # and the port's scan form against the reference's
    _, (yts, nts) = _apply_both(js, dataclasses.replace(c, ssm_impl="scan"),
                                pj, pt, x)
    assert_step(yts.numpy(), ys)
    assert_step(nts["h"].numpy(), ns["h"])


@pytest.mark.parametrize("impl", ["ssd", "scan"])
def test_ssm_apply_decode_step_matches_jax(impl):
    j, c, pj, pt = _layer(seed=1, ssm_impl=impl)
    r = np.random.default_rng(6)
    x = r.standard_normal((2, 12, c.d_model)).astype(np.float32)
    _, nj = JSSM.ssm_apply(pj, jnp.asarray(x), j)         # seed a state
    state = jax.tree.map(np.asarray, nj)
    xd = r.standard_normal((2, 1, c.d_model)).astype(np.float32)
    (yj, nj), (yt, nt) = _apply_both(j, c, pj, pt, xd, state)
    assert_step(yt.numpy(), yj)
    for k in ("h", "conv"):
        assert nt[k].shape == state[k].shape
        assert_step(nt[k].numpy(), nj[k])


def test_ssm_state_template_matches_jax():
    j = jget("zamba2-2.7b")
    c = ModelConfig(**dataclasses.asdict(j))
    tt = TSSM.ssm_state_template(c, 4)
    jt = JSSM.ssm_state_template(j, 4, jnp.bfloat16)
    assert {k: (m.shape, m.axes, m.init) for k, m in tt.items()} == \
        {k: (m.shape, m.axes, m.init) for k, m in jt.items()}
    assert tt["h"].shape == (4, 5120, 64)
    assert TSSM._dims(c) == JSSM._dims(j) == (5120, 80, 5248)
