"""The rest of the port's model zoo against the JAX package's, on the CPU:
``models/scan_utils.py``, ``models/xlstm.py`` and the xLSTM stack, the
vision and audio frontends (InternVL2, HuBERT), the sort MoE dispatch,
the attention route above 2,048 queries, the frontend batches, and their
serving and training entry points.

Inputs are made with numpy from a seed and fed to both packages; JAX
weights are carried over with ``convert.model_params_from_jax``.
Tolerances (float32 throughout, ``tests/test_torch_models.py``'s):
  * pieces (cells, chunks, layers): rtol 1e-4 and atol 1e-5 of the
    largest value compared (``assert_step``), or ``STEP``;
  * logits of a whole forward / prefill / decode / encode: ``LOGITS``
    (atol 2e-4, rtol 1e-4); greedy tokens equal;
  * loss and gradients of a train step: ``tests/test_torch_train.py``'s
    (loss 1e-5 relative, each gradient leaf 1e-4 of its largest
    magnitude) with the layer weights scaled by 0.1, as that file holds
    them.  No case here needed a float64 control: the xLSTM's weights
    are not stacked, and the frontend archs at ``.reduced()`` meet these
    tolerances at the reference's init.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.data import pipeline as JDATA
from repro.models import layers as JL
from repro.models import model as JM
from repro.models import moe as JMOE
from repro.models import scan_utils as JSU
from repro.models import xlstm as JX
from repro.stream import source as JSRC
from repro.train import serve as JS
from repro.train import step as JSTEP

from repro_torch.convert import model_params_from_jax
from repro_torch.configs import ARCHS, get_config
from repro_torch.data import (SyntheticLMConfig, frontend_batch_kwargs,
                              make_batch)
from repro_torch.launch import serve_lm
from repro_torch.launch import train as TLT
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.models import moe as TMOE
from repro_torch.models import params as TP
from repro_torch.models import scan_utils as TSU
from repro_torch.models import xlstm as TX
from repro_torch.optim import AdamWConfig, tree_flatten
from repro_torch.stream import source as TSRC
from repro_torch.train import serve as TS
from repro_torch.train import step as TSTEP

from test_torch_models import LOGITS, STEP, _np, _port_cfg, assert_step
from test_torch_train import GRAD_TOL, LOSS_RTOL, _flat_np, _max_rel, _scaled

XLSTM = "xlstm-125m"
VISION = "internvl2-1b"
AUDIO = "hubert-xlarge"


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _xlstm_cfg():
    """xLSTM-125M reduced with an sLSTM layer: ``.reduced()`` keeps only
    the sLSTM indices below 2, and the config's are 3 and 9."""
    return dataclasses.replace(jget(XLSTM).reduced(), slstm_layers=(1,))


def _cfg(arch):
    return _xlstm_cfg() if arch == XLSTM else jget(arch).reduced()


def _carry(j, seed=0):
    jp = JM.init_params(j, jax.random.PRNGKey(seed))
    return jp, model_params_from_jax(_np(jp), _port_cfg(j), "cpu")


def _batch(j, B, S, seed=0):
    """The same batch for both packages: tokens, and the arch's frontend
    arrays (``frames`` for audio, ``frontend`` for vision)."""
    r = np.random.default_rng(seed)
    b = {}
    if j.frontend == "audio":
        b["frames"] = (r.standard_normal((B, S, j.d_model)) * 0.02
                       ).astype(np.float32)
    else:
        b["tokens"] = r.integers(0, j.vocab_size, (B, S))
    if j.frontend == "vision":
        b["frontend"] = (r.standard_normal(
            (B, j.frontend_tokens, j.d_model)) * 0.02).astype(np.float32)
    jb = {k: jnp.asarray(v, jnp.int32 if k == "tokens" else jnp.float32)
          for k, v in b.items()}
    return jb, {k: _t(v) for k, v in b.items()}


# ---------------------------------------------------------------------------
# scan_utils
# ---------------------------------------------------------------------------

def test_default_chunk_equals_jax():
    for S in (1, 7, 16, 64, 100, 256, 1000, 2048, 4096, 32768):
        assert TSU.default_chunk(S) == JSU.default_chunk(S)


@pytest.mark.parametrize("S,chunk", [(64, 0), (60, 8), (37, 0), (12, 5)])
def test_chunked_scan_outputs_and_grads_equal_an_unchunked_loop(S, chunk):
    """Chunks of 8 (60 does not split: one checkpointed chunk), of
    default_chunk(64) = 16, and the fallbacks at 37 and 12."""
    r = np.random.default_rng(S)
    xs = torch.from_numpy(r.standard_normal((S, 3, 4)).astype(np.float32))
    W = torch.from_numpy(r.standard_normal((4, 4)).astype(np.float32) * 0.5)

    def step(c, x):
        h, s = c
        h = torch.tanh(h @ W + x[0])
        return (h, s + h.sum()), h * 2.0

    def run(fn):
        x = xs.clone().requires_grad_()
        c0 = (torch.zeros((3, 4)), torch.zeros(()))
        (h, s), ys = fn(step, c0, (x,))
        loss = ys.square().sum() + s
        return h, s, ys, torch.autograd.grad(loss, x)[0]

    want = run(TSU._steps)
    got = run(lambda f, c, x: TSU.chunked_scan(f, c, x, chunk))
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)
    with torch.no_grad():                    # no grad: the loop itself
        (h, _), ys = TSU.chunked_scan(step, (torch.zeros((3, 4)),
                                             torch.zeros(())), (xs,))
    assert torch.equal(ys, want[2].detach())


# ---------------------------------------------------------------------------
# xLSTM pieces
# ---------------------------------------------------------------------------

def _mlstm_inputs(B, S, H, hd, seed, state=True):
    r = np.random.default_rng(seed)
    f = lambda *s: r.standard_normal(s).astype(np.float32)
    q, k, v = f(B, S, H, hd), f(B, S, H, hd) * hd ** -0.5, f(B, S, H, hd)
    ig, fg = f(B, S, H), f(B, S, H) + 2.0
    st = ((f(B, H, hd, hd) * 0.1, np.abs(f(B, H, hd)) * 0.1, f(B, H))
          if state else
          (np.zeros((B, H, hd, hd), np.float32),
           np.zeros((B, H, hd), np.float32),
           np.full((B, H), -np.inf, np.float32)))
    return (q, k, v, ig, fg), st


def test_mlstm_cell_equals_jax():
    (q, k, v, ig, fg), st = _mlstm_inputs(2, 1, 3, 8, 0)
    args = (q[:, 0], k[:, 0], v[:, 0], ig[:, 0], fg[:, 0])
    hj, sj = JX._mlstm_cell(*map(jnp.asarray, args),
                            tuple(map(jnp.asarray, st)))
    ht, stt = TX._mlstm_cell(*map(_t, args), tuple(map(_t, st)))
    assert_step(ht.numpy(), hj)
    for a, b in zip(stt, sj):
        assert_step(a.numpy(), b)


@pytest.mark.parametrize("S,chunk,state", [(256, 64, False),
                                           (256, 64, True),
                                           (128, 128, True)])
def test_mlstm_chunkwise_equals_jax(S, chunk, state):
    xs, st = _mlstm_inputs(2, S, 2, 8, S + chunk, state)
    hj, sj = JX.mlstm_chunkwise(*map(jnp.asarray, xs),
                                tuple(map(jnp.asarray, st)), chunk=chunk)
    ht, stt = TX.mlstm_chunkwise(*map(_t, xs), tuple(map(_t, st)),
                                 chunk=chunk)
    assert_step(ht.numpy(), hj)
    for a, b in zip(stt, sj):
        assert_step(a.numpy(), b)
    assert TX.mlstm_chunkwise(*map(_t, xs), tuple(map(_t, st)),
                              chunk=S // 2 + 1) is None   # ragged


def _layer(j, seed=0):
    jp, tp = _carry(j, seed)
    return jp["layers"], tp["layers"]


@pytest.mark.parametrize("kind,S", [("mlstm", 1), ("mlstm", 64),
                                    ("mlstm", 300), ("slstm", 1),
                                    ("slstm", 40)])
def test_xlstm_layers_equal_jax(kind, S):
    """mLSTM at one token (the cell), 64 (the chunkwise form) and 300
    (not a multiple of 256: ``chunked_scan`` over the cell); sLSTM at one
    token and over ``chunked_scan``; from no state and from a state."""
    j = _xlstm_cfg()
    c = _port_cfg(j)
    jl, tl = _layer(j)
    name = "layer_01" if kind == "slstm" else "layer_00"
    japply_ = JX.slstm_apply if kind == "slstm" else JX.mlstm_apply
    tapply = TX.slstm_apply if kind == "slstm" else TX.mlstm_apply
    x = (np.random.default_rng(S).standard_normal((2, S, c.d_model))
         ).astype(np.float32)
    japply = jax.jit(lambda p, x, state: japply_(p, x, j, state=state,
                                                 return_state=True))
    yj, sj = japply(jl[name], jnp.asarray(x), None)
    yt, st = tapply(tl[name], _t(x), c)
    assert_step(yt.numpy(), yj)
    for a, b in zip(st, sj):
        assert_step(a.numpy(), b)
    # one more step from that state
    x1 = x[:, :1] * 0.5
    yj, sj = japply(jl[name], jnp.asarray(x1), sj)
    yt, st = tapply(tl[name], _t(x1), c, state=st)
    assert_step(yt.numpy(), yj)
    for a, b in zip(st, sj):
        assert_step(a.numpy(), b)


def test_slstm_cell_equals_jax():
    r = np.random.default_rng(3)
    B, d = 3, 8
    f = lambda *s: r.standard_normal(s).astype(np.float32)
    gx, wr, bias = f(B, 4 * d), f(d, 4 * d) * 0.1, f(4 * d)
    st = (f(B, d), np.abs(f(B, d)) + 1, f(B, d), f(B, d))
    hj, sj = JX._slstm_cell(jnp.asarray(gx), jnp.asarray(wr),
                            jnp.asarray(bias), tuple(map(jnp.asarray, st)), d)
    ht, stt = TX._slstm_cell(_t(gx), _t(wr), _t(bias), tuple(map(_t, st)), d)
    assert_step(ht.numpy(), hj)
    for a, b in zip(stt, sj):
        assert_step(a.numpy(), b)


# ---------------------------------------------------------------------------
# end to end: xLSTM and InternVL2 (decoders), HuBERT (encoder)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", [XLSTM, VISION])
def test_forward_prefill_decode_equal_jax(arch):
    j = _cfg(arch)
    c = _port_cfg(j)
    jp, tp = _carry(j)
    B, S, T = 2, 20, 3
    jb, tb = _batch(j, B, S + T)
    lj, _ = jax.jit(lambda p, b: JM.forward(j, p, b))(jp, jb)
    lt, _ = TM.forward(c, tp, tb)
    assert lt.shape == (B, S + T, lt.shape[-1])          # no frontend rows
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **LOGITS)
    n_front = TM.num_frontend_tokens(c)
    cut = lambda b: {k: (v[:, :S] if k == "tokens" else v)
                     for k, v in b.items()}
    cache_len = n_front + S + T
    lj, cj = jax.jit(lambda p, b: JM.prefill(j, p, b, cache_len=cache_len)
                     )(jp, cut(jb))
    decode = jax.jit(lambda p, c, t, pos: JM.decode_step(j, p, c, t, pos))
    lt, ct = TM.prefill(c, tp, cut(tb), cache_len=cache_len)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **LOGITS)
    assert ("kpos" in ct) == ("kpos" in cj) == (arch != XLSTM)
    toks = tb["tokens"].numpy()
    for t in range(T):
        pos = n_front + S + t
        lj, cj = decode(jp, cj, jnp.asarray(toks[:, S + t], jnp.int32),
                        jnp.int32(pos))
        lt, ct = TM.decode_step(c, tp, ct, _t(toks[:, S + t]), pos)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **LOGITS)
    for path, x in jax.tree_util.tree_leaves_with_path(cj):
        keys = [str(getattr(p, "key", p)) for p in path]
        got = ct
        for k in keys:
            got = got[k]
        assert got.shape == x.shape
        if keys[-1] == "kpos":
            np.testing.assert_array_equal(got.numpy(), np.asarray(x))
        else:
            assert_step(got.float().numpy(), x)


@pytest.mark.parametrize("arch", [XLSTM, VISION])
def test_greedy_generate_equals_jax(arch):
    j = _cfg(arch)
    jp, tp = _carry(j, seed=1)
    jb, tb = _batch(j, 2, 16, seed=1)
    n_front = TM.num_frontend_tokens(j)
    want = JS.greedy_generate(j, jp, jb, steps=8, cache_len=n_front + 24)
    got = TS.greedy_generate(_port_cfg(j), tp, tb, steps=8,
                             cache_len=n_front + 24)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_hubert_encode_step_equals_jax():
    j = jget(AUDIO).reduced()
    c = _port_cfg(j)
    assert not j.causal and j.encoder_only and j.norm == "ln"
    jp, tp = _carry(j)
    assert "tok_embed" not in tp
    jb, tb = _batch(j, 2, 40)
    lj, aj = JM.encode_step(j, jp, jb)
    lt, at = TM.encode_step(c, tp, tb)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **LOGITS)
    assert float(at) == float(aj) == 0.0
    with pytest.raises(ValueError, match="encoder-only"):
        TM.prefill(c, tp, tb, cache_len=48)
    with pytest.raises(ValueError, match="encoder-only"):
        TM.decode_step(c, tp, {}, torch.zeros(2, dtype=torch.long), 0)


@pytest.mark.parametrize("arch", [XLSTM, VISION, AUDIO])
def test_train_step_loss_and_grads_equal_jax(arch):
    """Loss and every gradient leaf of ``loss_fn`` at the reference's init
    with the layer weights scaled by 0.1 (``tests/test_torch_train.py``
    says why)."""
    j = _cfg(arch)
    c = _port_cfg(j)
    jp = _scaled(JM.init_params(j, jax.random.PRNGKey(0)), 0.1)
    tp = model_params_from_jax(_np(jp), c, "cpu")
    S = 24
    jb, tb = _batch(j, 2, S, seed=4)
    labels = np.random.default_rng(5).integers(0, j.vocab_size, (2, S))
    jb["labels"], tb["labels"] = jnp.asarray(labels, jnp.int32), _t(labels)
    (lj, _), gj = jax.jit(jax.value_and_grad(
        lambda p: JSTEP.loss_fn(j, p, jb), has_aux=True))(jp)
    (lt, _), gt = TSTEP.value_and_grad(c, tp, tb)
    assert abs(float(lt) - float(lj)) <= LOSS_RTOL * abs(float(lj))
    gj, gt = _flat_np(gj), _flat_np(gt)
    assert set(gj) == set(gt)
    for n in gj:
        assert _max_rel(gt[n], gj[n]) <= GRAD_TOL, n


def test_strads_layer_blocks_and_step_masks_equal_jax():
    """The unrolled xLSTM layers map to blocks 0..L−1 as in the JAX
    package; a STRADS step on the JAX Gumbel draw applies the same mask,
    and with no weight decay the layers it left out keep their bits."""
    from repro.sched import block as JB
    from repro_torch.sched import block as TB
    j = _xlstm_cfg()
    c = _port_cfg(j)
    jp, tp = _carry(j)
    mj, nj = JSTEP.layer_blocks(j, jp)
    mt, nt = TSTEP.layer_blocks(c, tp)
    assert (mt, nt) == (mj, nj) and nt == j.num_layers + 1
    assert sorted(set(mt.values())) == list(range(j.num_layers + 1))
    kw = dict(num_blocks=nt, blocks_per_step=1, candidates_per_step=2,
              min_distance=1)
    tc = TSTEP.TrainConfig(adamw=AdamWConfig(weight_decay=0.0),
                           peak_lr=1e-3)
    st = TSTEP.init_strads_state(c, tc, TB.BlockScheduleConfig(**kw),
                                 torch.Generator().manual_seed(0))
    st["params"] = tp
    step = TSTEP.make_strads_train_step(c, tc, TB.BlockScheduleConfig(**kw))
    _, bt = _batch(j, 2, 12)
    bt["labels"] = bt["tokens"]
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
        assert torch.equal(x, before[n]) == (mask[mt[n]] == 0), n


# ---------------------------------------------------------------------------
# the sort MoE dispatch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,capacity_factor", [
    ("phi3.5-moe-42b-a6.6b", 8.0), ("phi3.5-moe-42b-a6.6b", 1.25),
    ("llama4-maverick-400b-a17b", 8.0), ("llama4-maverick-400b-a17b", 1.0)])
def test_sort_dispatch_equals_einsum_and_jax(arch, capacity_factor):
    """With T ≤ 4,096 both dispatches have the same capacity and drop
    order, so the sort path equals the port's einsum path and the JAX
    package's sort path, with and without drops."""
    j = dataclasses.replace(jget(arch).reduced(), moe_impl="sort",
                            capacity_factor=capacity_factor)
    c = _port_cfg(j)
    jp, tp = _carry(j, seed=7)
    sub = f"ffn{j.moe_every - 1}"
    pj = jax.tree.map(lambda t: t[0], jp["layers"][sub])
    pt = TP.tree_map(lambda _, t: t[0], tp["layers"][sub])
    x = np.random.default_rng(8).standard_normal(
        (2, 24, c.d_model)).astype(np.float32)
    yj, aj = jax.jit(lambda p, x: JMOE.moe_apply(p, x, j))(pj,
                                                            jnp.asarray(x))
    ys, as_ = TMOE.moe_apply(pt, _t(x), c)
    ye, ae = TMOE.moe_apply(pt, _t(x), dataclasses.replace(
        c, moe_impl="einsum"))
    assert_step(ys.numpy(), yj)
    assert_step(ys.numpy(), ye.numpy())
    assert float(as_) == float(ae) == pytest.approx(float(aj), rel=1e-5)
    jb, tb = _batch(j, 2, 12)
    lj, _ = jax.jit(lambda p, b: JM.forward(j, p, b))(jp, jb)
    lt, _ = TM.forward(c, tp, tb)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **LOGITS)


def test_sort_dispatch_drops_past_capacity():
    """The port's twin of ``tests/test_models.py``'s capacity case: at
    capacity factor 0.25 entries overflow into the dropped row; the
    output stays finite, the dropped tokens' rows get only what they
    kept, and the JAX package's sort path agrees."""
    j = dataclasses.replace(jget("phi3.5-moe-42b-a6.6b").reduced(),
                            capacity_factor=0.25, moe_impl="sort")
    c = _port_cfg(j)
    jp, tp = _carry(j)
    pj = jax.tree.map(lambda t: t[0], jp["layers"]["ffn0"])
    pt = TP.tree_map(lambda _, t: t[0], tp["layers"]["ffn0"])
    T = 64
    h = np.random.default_rng(9).standard_normal(
        (T, c.d_model)).astype(np.float32)
    probs, idx, _ = TMOE._router(pt, _t(h), c)
    C = TMOE._capacity(T, c.experts_per_token, c.num_experts,
                       c.capacity_factor)
    assert C < T * c.experts_per_token // c.num_experts     # overflow
    y = TMOE._dispatch_sort(pt, _t(h), c, probs, idx)
    yj = jax.jit(lambda p, h, pr, ix: JMOE._dispatch_sort(p, h, j, pr, ix))(
        pj, jnp.asarray(h), jnp.asarray(probs.numpy()),
        jnp.asarray(idx.numpy(), jnp.int32))
    assert bool(torch.isfinite(y).all())
    assert_step(y.numpy(), yj)
    # kept entries: within each expert, the first C in (token, slot) order
    flat = idx.reshape(-1).numpy()
    kept = np.zeros(flat.shape, bool)
    for e in range(c.num_experts):
        kept[np.flatnonzero(flat == e)[:C]] = True
    dropped_all = ~kept.reshape(T, -1).any(1)
    assert dropped_all.any()
    assert bool((y[torch.from_numpy(dropped_all)] == 0).all())
    jb, tb = _batch(j, 2, 32)
    lt, _ = TM.forward(c, tp, tb)
    assert not bool(torch.isnan(lt).any())


# ---------------------------------------------------------------------------
# the attention route
# ---------------------------------------------------------------------------

def test_attention_route_takes_the_kernel_on_the_card_at_every_length():
    for n in (1, 2048, 2049, 2304, 4096, 32768):
        assert TL.attention_route("cuda", n) == "flash"
    assert TL.attention_route("cpu", 2048) == "plain"
    for n in (2049, 2304, 4096):
        assert TL.attention_route("cpu", n) == "chunked"


@pytest.mark.parametrize("causal,window", [(True, None), (False, None),
                                           (True, 300)])
def test_cpu_attention_above_the_threshold_equals_jax(causal, window):
    """2,304 queries (InternVL2's training length) over 2,400 keys: the
    CPU takes the chunked path, as the JAX package's ``attend`` does."""
    r = np.random.default_rng(6)
    q = r.standard_normal((1, 2304, 2, 8)).astype(np.float32)
    k = r.standard_normal((1, 2400, 1, 8)).astype(np.float32)
    v = r.standard_normal((1, 2400, 1, 8)).astype(np.float32)
    want = JL.attend(*map(jnp.asarray, (q, k, v)), causal=causal,
                     window=window)
    got = TL.attend(*map(_t, (q, k, v)), causal=causal, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **STEP)


# ---------------------------------------------------------------------------
# frontend batches and the entry points
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [dict(frames=True, d_model=24),
                                dict(frontend_tokens=5, d_model=24)])
def test_make_batch_frontend_arrays_match_jax_layout(kw):
    cfg = SyntheticLMConfig(vocab_size=97, seq_len=12, batch_size=3, seed=2)
    jcfg = JDATA.SyntheticLMConfig(vocab_size=97, seq_len=12, batch_size=3,
                                   seed=2)
    got, want = make_batch(cfg, 4, **kw), JDATA.make_batch(jcfg, 4, **kw)
    assert set(got) == set(want)
    for k in want:
        assert tuple(got[k].shape) == tuple(want[k].shape), k
        assert got[k].is_floating_point() == jnp.issubdtype(
            want[k].dtype, jnp.floating), k
    plain = make_batch(cfg, 4)
    assert torch.equal(got["labels"], plain["labels"])
    if "tokens" in got:
        assert torch.equal(got["tokens"], plain["tokens"])
    for k in ("frames", "frontend"):
        if k in got:
            assert got[k].dtype == torch.float32
            assert 0.015 < got[k].std().item() < 0.025
            assert torch.equal(got[k], make_batch(cfg, 4, **kw)[k])
    src = TSRC.SyntheticLMSource(cfg, kwargs=kw)
    jsrc = JSRC.SyntheticLMSource(jcfg, kwargs=kw)
    d, dj = src.take(4)[0]["data"], jsrc.take(4)[0]["data"]
    assert {k: tuple(v.shape) for k, v in d.items()} == \
        {k: tuple(v.shape) for k, v in dj.items()}
    assert all(torch.equal(d[k], got[k]) for k in got)
    with pytest.raises(ValueError, match="d_model"):
        make_batch(cfg, 4, frames=True)


@pytest.mark.parametrize("arch", ARCHS)
def test_frontend_helpers_give_each_arch_its_inputs(arch):
    """``frontend_batch_kwargs`` makes the batch ``forward`` takes (frames
    for audio, patch embeddings beside the tokens for vision, tokens
    alone else), and ``num_frontend_tokens`` counts the positions ahead
    of the text, as the JAX package's serving loop counts them."""
    c, j = get_config(arch).reduced(), jget(arch).reduced()
    b = make_batch(SyntheticLMConfig(vocab_size=c.vocab_size, seq_len=6,
                                     batch_size=1, seed=0), 0,
                   **frontend_batch_kwargs(c))
    b.pop("labels")
    want = {"audio": {"frames"}, "vision": {"tokens", "frontend"}}
    assert set(b) == want.get(c.frontend, {"tokens"})
    n_front = TM.num_frontend_tokens(c)
    assert n_front == (j.frontend_tokens if j.frontend == "vision" else 0)
    assert n_front == (b["frontend"].shape[1] if "frontend" in b else 0)
    logits, _ = TM.forward(c, TM.init_params(
        c, torch.Generator().manual_seed(0)), b)
    assert logits.shape[:2] == (1, 6) and bool(torch.isfinite(logits).all())


@pytest.mark.parametrize("arch,extra", [(AUDIO, ()), (VISION, ()),
                                        (XLSTM, ("--strads",)),
                                        ("granite-3-2b", ("--strads",)),
                                        ("stablelm-3b", ("--strads",)),
                                        ("chatglm3-6b", ("--strads",))])
def test_train_cli_runs_the_new_archs_on_the_cpu(arch, extra, capsys):
    hist = TLT.main(["--arch", arch, "--preset", "reduced", "--steps", "3",
                     "--batch", "2", "--seq", "16", "--log-every", "1",
                     "--device", "cpu", *extra])
    out = capsys.readouterr().out
    assert len(hist) == 3 and all(np.isfinite(h["loss"]) for h in hist)
    assert f"arch={arch}" in out
    if extra:
        cfg = _cfg(arch)
        assert f"/{cfg.num_layers + 1} blocks" in out


@pytest.mark.parametrize("arch", [XLSTM, VISION, "granite-3-2b",
                                  "stablelm-3b", "chatglm3-6b",
                                  "llama4-maverick-400b-a17b"])
def test_serve_lm_serves_the_new_decoders_and_refuses_hubert(arch, capsys):
    toks = serve_lm.main(["--arch", arch, "--batch", "2", "--prompt-len",
                          "10", "--gen", "3", "--device", "cpu"])
    out = capsys.readouterr().out
    assert f"arch={arch}" in out and toks.shape == (2, 3)
    n_front = jget(arch).reduced().frontend_tokens \
        if arch == VISION else 0
    assert f"cache={10 + 3 + n_front} " in out
    with pytest.raises(SystemExit):
        serve_lm.main(["--arch", AUDIO, "--device", "cpu"])
