"""The port's model zoo (``repro_torch.models`` and the serving path)
against the JAX package's, on the CPU at reduced size.

The JAX model's parameters are carried into the port with
``model_params_from_jax`` and both are fed the same tokens, made with
numpy.  Tolerances, all in f32 (``reduced()`` configs are float32):
  * layers and single steps: rtol = 1e-4 and atol = 1e-5 of the largest
    value compared (f32 sums in another order; the reference's init makes
    layer outputs of order 10³, so a fixed atol would mean nothing);
  * logits of a whole prefill / decode / generate: atol = 2e-4,
    rtol = 1e-4 (two layers of such sums, logits up to ~5);
  * greedy tokens are equal.
ChatGLM3, MiniCPM, StableLM and Llama-4 (``CONTROL_ARCHS``) exceed that
logits atol at the reference's init through f32 noise alone (up to
~4.7e-4 from the JAX package's; the JAX package's own f32 logits sit up
to ~2.5e-4 from a float64 run, and which of the two packages lands
nearer changes with the seed).  For them each step's float64 control
of the port (the same weights, every upcast kept at float64) is held to
the JAX package's logits at ``LOGITS``, so a fault of the port's shows
there; and the port's f32 logits are held to the control within
``LOGITS`` plus twice the JAX package's largest distance from it over
the test's forward, prefill and decode steps (a distance that first
check bounds).
Zamba2 at a prompt that is a multiple of 128 runs the SSD (chunked
matmul) form, which at the reference's init loses digits in the JAX
package (``tests/test_torch_ssm.py`` says why); there the port is held
to the JAX model's scan form at the logits tolerance, and to its default
SSD form within that form's own distance from the scan form plus it.
"""
import dataclasses
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as J_ARCHS
from repro.configs import INPUT_SHAPES as J_SHAPES
from repro.configs import get_config as jget
from repro.models import layers as JL
from repro.models import model as JM
from repro.models import moe as JMOE
from repro.models import params as JP
from repro.models import transformer as JT
from repro.sharding import rules as JR
from repro.train import serve as JS

from repro_torch.configs import ARCHS, INPUT_SHAPES, get_config
from repro_torch.convert import model_params_from_jax
from repro_torch.data import SyntheticLMConfig, make_batch
from repro_torch.kernels import ops
from repro_torch.launch import serve_lm
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.models import moe as TMOE
from repro_torch.models import params as TP
from repro_torch.models import transformer as TT
from repro_torch.sharding import rules as TR
from repro_torch.train import serve as TS

STEP = dict(rtol=1e-4, atol=1e-4)        # values of order 1
LOGITS = dict(rtol=1e-4, atol=2e-4)
SLICE_ARCHS = ["phi3.5-moe-42b-a6.6b", "granite-3-2b"]
CONTROL_ARCHS = ["chatglm3-6b", "minicpm-2b", "stablelm-3b",
                 "llama4-maverick-400b-a17b"]
PORTED = list(ARCHS)
#: the archs whose family or frontend the port refused until it had them
ONCE_REFUSED = ["xlstm-125m", "internvl2-1b", "hubert-xlarge"]


def assert_step(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-4,
                               atol=1e-5 * max(1.0, np.abs(want).max()))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _carry(cfg, seed=0):
    """JAX params from ``seed`` and the same weights in the port."""
    jp = JM.init_params(cfg, jax.random.PRNGKey(seed))
    return jp, model_params_from_jax(_np(jp), _port_cfg(cfg), "cpu")


def _port_cfg(jcfg):
    """The port's config with the JAX one's field values."""
    from repro_torch.configs.base import ModelConfig
    return ModelConfig(**dataclasses.asdict(jcfg))


def _tokens(cfg, B, S, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S))


_to_f32 = torch.Tensor.float


def _f64_run(fn, cfg, params, *args, **kw):
    """``fn(cfg, params, *args)`` as the float64 control: the config and
    weights in float64, and the port's upcasts (``.float()`` before its
    norms, softmax and attention) keeping float64 tensors float64."""
    keep = lambda t, *a, **k: t if t.dtype == torch.float64 \
        else _to_f32(t, *a, **k)
    with mock.patch.object(torch.Tensor, "float", keep):
        return fn(dataclasses.replace(cfg, dtype="float64"),
                  TP.tree_map(lambda _, t: t.double(), params), *args,
                  **kw)


def _assert_logits(arch, steps):
    """``steps``: (port, JAX, control) logits of each step of a test.
    ``LOGITS`` of the JAX package's, or for CONTROL_ARCHS the control at
    ``LOGITS`` of the JAX package's and the port within ``LOGITS`` plus
    twice the JAX package's largest distance from the control (see the
    module's docstring)."""
    steps = [tuple(None if a is None else np.asarray(a, np.float64)
                   for a in s) for s in steps]
    if arch not in CONTROL_ARCHS:
        for got, want, _ in steps:
            np.testing.assert_allclose(got, want, **LOGITS)
        return
    for i, (_, want, control) in enumerate(steps):
        np.testing.assert_allclose(control, want, **LOGITS,
                                   err_msg=f"step {i}: control vs JAX")
    band = max(np.abs(want - control).max() for _, want, control in steps)
    for i, (got, _, control) in enumerate(steps):
        np.testing.assert_allclose(got, control, rtol=LOGITS["rtol"],
                                   atol=LOGITS["atol"] + 2 * band,
                                   err_msg=f"step {i}, band {band}")


# ---------------------------------------------------------------------------
# configs, padding rules, templates, init
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", J_ARCHS)
def test_configs_match_the_jax_package(arch):
    assert ARCHS == J_ARCHS
    assert dataclasses.asdict(get_config(arch)) == \
        dataclasses.asdict(jget(arch))
    assert dataclasses.asdict(get_config(arch).reduced()) == \
        dataclasses.asdict(jget(arch).reduced())
    c, j = get_config(arch), jget(arch)
    assert (c.head_dim_, c.param_count(), c.active_param_count()) == \
        (j.head_dim_, j.param_count(), j.active_param_count())
    assert {k: dataclasses.asdict(v) for k, v in INPUT_SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in J_SHAPES.items()}


def test_padding_rules_match_the_jax_package():
    assert TR.MODEL_AXIS_SIZE == JR.MODEL_AXIS_SIZE
    for v in (1, 504, 32064, 49155, 151655, 202048):
        assert TR.padded_vocab(v) == JR.padded_vocab(v)
    for h, kv in ((32, 8), (40, 8), (36, 36), (14, 2), (4, 4), (32, 2),
                  (16, 16), (4, 1)):
        assert TR.padded_heads(h, kv) == JR.padded_heads(h, kv)
    assert TR.pad_to_multiple(33, 16) == JR.pad_to_multiple(33, 16) == 48


@pytest.mark.parametrize("arch", PORTED)
@pytest.mark.parametrize("preset", ["full", "reduced"])
def test_templates_match_the_jax_package(arch, preset):
    c, j = get_config(arch), jget(arch)
    if preset == "reduced":
        c, j = c.reduced(), j.reduced()
    tt, jt = TT.stack_template(c), JT.stack_template(j)
    shapes = lambda t, is_leaf: jax.tree.map(
        lambda m: (m.shape, m.axes, m.init, m.scale), t, is_leaf=is_leaf)
    assert shapes(tt, TP.is_meta) == shapes(jt, JP.is_meta)
    assert TM.num_params(c) == JM.num_params(j)
    assert shapes(TT.cache_template(c, 2, 16), TP.is_meta) == \
        shapes(JT.cache_template(j, 2, 16, jnp.float32), JP.is_meta)


@pytest.mark.parametrize("arch", ONCE_REFUSED)
def test_once_refused_archs_build_and_run(arch):
    """The xLSTM family and the vision and audio frontends raised
    NotImplementedError until the port had them.  Now nothing of the
    JAX package's zoo raises it: these build and run a forward, and only
    a family the JAX package lacks raises (ValueError, as there)."""
    cfg = get_config(arch).reduced()
    prm = TM.init_params(cfg, torch.Generator().manual_seed(0))
    batch = ({"frames": torch.zeros((1, 4, cfg.d_model))}
             if cfg.frontend == "audio"
             else {"tokens": torch.zeros((1, 4), dtype=int)})
    if cfg.frontend == "vision":
        batch["frontend"] = torch.zeros((1, cfg.frontend_tokens,
                                         cfg.d_model))
    logits, _ = TM.forward(cfg, prm, batch)
    assert logits.shape[:2] == (1, 4)
    assert bool(torch.isfinite(logits).all())
    with pytest.raises(ValueError):
        TT.stack_template(dataclasses.replace(cfg, family="rnn"))


def test_init_keeps_the_jax_std_rule_and_dtype():
    cfg = dataclasses.replace(get_config("phi3.5-moe-42b-a6.6b").reduced(),
                              num_layers=6, dtype="bfloat16")
    prm = TM.init_params(cfg, torch.Generator().manual_seed(0))
    tmpl = TT.stack_template(cfg)
    seen = 0
    for path, meta in _flat(tmpl):
        t = _get(prm, path)
        assert t.shape == meta.shape and t.dtype == torch.bfloat16
        if meta.init == "ones":
            assert bool((t == 1).all())
        elif meta.init == "normal":
            # a stacked leaf's fan-in is shape[0], the layer count (6),
            # as in the JAX package; the router and embedding keep their
            # explicit scale
            want = meta.scale if meta.scale is not None else \
                meta.shape[0] ** -0.5
            assert TP.leaf_std(meta) == pytest.approx(want)
            if t.numel() > 10_000:
                assert t.float().std().item() == pytest.approx(want,
                                                               rel=0.05)
                seen += 1
    assert seen >= 5
    assert TP.leaf_std(tmpl["layers"]["ffn0"]["wg"]) == 6 ** -0.5
    again = TM.init_params(cfg, torch.Generator().manual_seed(0))
    assert all(torch.equal(_get(prm, p), _get(again, p))
               for p, _ in _flat(tmpl))


def _flat(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, path + (k,))
    else:
        yield path, tree


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def test_convert_checks_keys_and_shapes_and_keeps_bf16_bits():
    j = jget("granite-3-2b").reduced()
    jp = _np(JM.init_params(j, jax.random.PRNGKey(3)))
    cfg = _port_cfg(j)
    bad = dict(jp, extra=np.zeros(3))
    with pytest.raises(ValueError, match="keys"):
        model_params_from_jax(bad, cfg, "cpu")
    bad = dict(jp, final_norm={"scale": np.ones(7, np.float32)})
    with pytest.raises(ValueError, match="shape"):
        model_params_from_jax(bad, cfg, "cpu")
    jb = dataclasses.replace(j, dtype="bfloat16")
    jpb = _np(JM.init_params(jb, jax.random.PRNGKey(3)))
    tpb = model_params_from_jax(jpb, _port_cfg(jb), "cpu")
    wq = tpb["layers"]["attn0"]["wq"]
    assert wq.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        wq.float().numpy(), np.asarray(jpb["layers"]["attn0"]["wq"],
                                       np.float32))


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fraction", [1.0, 0.5, 0.25])
def test_rope_and_norms_match_jax(fraction):
    r = np.random.default_rng(1)
    x = r.standard_normal((2, 7, 3, 16)).astype(np.float32)
    pos = np.arange(5, 12)
    got = TL.rope(torch.from_numpy(x), torch.from_numpy(pos), 1e4, fraction)
    want = JL.rope(jnp.asarray(x), jnp.asarray(pos, jnp.int32), 1e4,
                   fraction)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **STEP)
    s = r.standard_normal(16).astype(np.float32)
    b = r.standard_normal(16).astype(np.float32)
    np.testing.assert_allclose(
        TL.rms_norm(torch.from_numpy(x), torch.from_numpy(s), 1e-5).numpy(),
        np.asarray(JL.rms_norm(jnp.asarray(x), jnp.asarray(s), 1e-5)),
        **STEP)
    np.testing.assert_allclose(
        TL.layer_norm(torch.from_numpy(x), torch.from_numpy(s),
                      torch.from_numpy(b), 1e-5).numpy(),
        np.asarray(JL.layer_norm(jnp.asarray(x), jnp.asarray(s),
                                 jnp.asarray(b), 1e-5)), **STEP)


def _attn_layer(arch="granite-3-2b", seed=0, **over):
    j = dataclasses.replace(jget(arch).reduced(), **over)
    jp = JM.init_params(j, jax.random.PRNGKey(seed))
    p_j = jax.tree.map(lambda t: t[0], jp["layers"]["attn0"])
    p_t = TP.tree_map(lambda _, t: t[0], model_params_from_jax(
        _np(jp), _port_cfg(j), "cpu")["layers"]["attn0"])
    return j, _port_cfg(j), p_j, p_t


def test_attention_apply_prefill_and_decode_match_jax():
    j, c, pj, pt = _attn_layer()
    B, S, Sc = 2, 12, 16
    x = np.random.default_rng(2).standard_normal(
        (B, S, c.d_model)).astype(np.float32)
    pos = np.arange(S)
    yj, _ = JL.attention_apply(pj, jnp.asarray(x), j,
                               positions=jnp.asarray(pos, jnp.int32))
    yt, _ = TL.attention_apply(pt, torch.from_numpy(x), c,
                               positions=torch.from_numpy(pos))
    assert_step(yt.numpy(), yj)
    # prefill into a cache, then one decode step at position S
    cj = JM.init_cache(j, B, Sc)["layers"]["attn0"]
    cj = jax.tree.map(lambda t: t[0], cj)
    ct = TP.tree_map(lambda _, t: t[0],
                     TM.init_cache(c, B, Sc, "cpu")["layers"]["attn0"])
    yj, cj = JL.attention_apply(pj, jnp.asarray(x), j,
                                positions=jnp.asarray(pos, jnp.int32),
                                cache=cj)
    yt, ct = TL.attention_apply(pt, torch.from_numpy(x), c,
                                positions=torch.from_numpy(pos), cache=ct)
    assert_step(yt.numpy(), yj)
    assert_step(ct["k"].numpy(), cj["k"])
    kpos = np.where(np.arange(Sc) <= S, np.arange(Sc), -1)
    xd = np.random.default_rng(3).standard_normal(
        (B, 1, c.d_model)).astype(np.float32)
    yj, cj = JL.attention_apply(
        pj, jnp.asarray(xd), j, positions=jnp.full((1,), S, jnp.int32),
        cache=cj, kpos=jnp.asarray(kpos, jnp.int32), slot=jnp.int32(S))
    yt, ct = TL.attention_apply(
        pt, torch.from_numpy(xd), c, positions=torch.full((1,), S),
        cache=ct, kpos=torch.from_numpy(kpos), slot=S)
    assert_step(yt.numpy(), yj)
    assert_step(ct["v"].numpy(), cj["v"])


def test_attention_apply_ring_buffer_prefill_matches_jax():
    j, c, pj, pt = _attn_layer(seed=1, window=8)
    B, S, Sc = 2, 13, 8
    x = np.random.default_rng(4).standard_normal(
        (B, S, c.d_model)).astype(np.float32)
    pos = np.arange(S)
    cj = jax.tree.map(lambda t: t[0], JM.init_cache(j, B, Sc)["layers"]
                      ["attn0"])
    ct = TP.tree_map(lambda _, t: t[0],
                     TM.init_cache(c, B, Sc, "cpu")["layers"]["attn0"])
    yj, cj = JL.attention_apply(pj, jnp.asarray(x), j,
                                positions=jnp.asarray(pos, jnp.int32),
                                cache=cj, window=8)
    yt, ct = TL.attention_apply(pt, torch.from_numpy(x), c,
                                positions=torch.from_numpy(pos), cache=ct,
                                window=8)
    assert_step(yt.numpy(), yj)
    for key in ("k", "v"):
        assert_step(ct[key].numpy(), cj[key])


@pytest.mark.parametrize("causal,window", [(True, None), (True, 20),
                                           (False, None)])
def test_attention_paths_match_jax(causal, window):
    r = np.random.default_rng(5)
    q = r.standard_normal((2, 45, 4, 8)).astype(np.float32)
    k = r.standard_normal((2, 60, 2, 8)).astype(np.float32)
    v = r.standard_normal((2, 60, 2, 8)).astype(np.float32)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    got = TL._chunked_attention(tq, tk, tv, causal=causal, window=window,
                                chunk=16)
    want = JL._chunked_attention(jq, jk, jv, causal=causal, window=window,
                                 chunk=16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **STEP)
    got = TL.attend(tq, tk, tv, causal=causal, window=window)
    want = JL._sdpa_grouped(jq, jk, jv, causal=causal, window=window,
                            q_offset=15)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **STEP)
    # the kernel's plain version agrees where every row sees a key
    np.testing.assert_allclose(
        ops.attention(tq, tk, tv, causal=causal, window=window).numpy(),
        np.asarray(want), **STEP)


@pytest.mark.parametrize("capacity_factor,tokens", [(1.25, 24), (8.0, 24),
                                                    (0.5, 40), (1.25, 1)])
def test_moe_apply_matches_jax(capacity_factor, tokens):
    j = dataclasses.replace(jget("phi3.5-moe-42b-a6.6b").reduced(),
                            capacity_factor=capacity_factor)
    jp = JM.init_params(j, jax.random.PRNGKey(7))
    c = _port_cfg(j)
    pj = jax.tree.map(lambda t: t[0], jp["layers"]["ffn0"])
    pt = TP.tree_map(lambda _, t: t[0], model_params_from_jax(
        _np(jp), c, "cpu")["layers"]["ffn0"])
    x = np.random.default_rng(8).standard_normal(
        (2, tokens // 2 or 1, c.d_model)).astype(np.float32)
    if tokens == 1:
        x = x[:1]
    yj, aj = JMOE.moe_apply(pj, jnp.asarray(x), j)
    yt, at = TMOE.moe_apply(pt, torch.from_numpy(x), c)
    assert_step(yt.numpy(), yj)
    assert float(at) == pytest.approx(float(aj), rel=1e-5)
    assert TMOE._capacity(4096, 2, 16, 1.25) == \
        JMOE._capacity(4096, 2, 16, 1.25) == 640
    # the sort dispatch (no longer refused) gives the einsum path's values
    ys, as_ = TMOE.moe_apply(pt, torch.from_numpy(x),
                             dataclasses.replace(c, moe_impl="sort"))
    assert_step(ys.numpy(), yt.numpy())
    assert float(as_) == float(at)


# ---------------------------------------------------------------------------
# the whole slice: forward, prefill, decode, greedy generation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", SLICE_ARCHS + CONTROL_ARCHS)
def test_forward_prefill_decode_match_jax(arch):
    j = jget(arch).reduced()
    jp, tp = _carry(j)
    c = _port_cfg(j)
    control = arch in CONTROL_ARCHS
    run64 = lambda fn, *a, **kw: (_f64_run(fn, c, tp, *a, **kw)
                                  if control else (None, None))
    B, S, T = 2, 20, 3
    toks = _tokens(c, B, S + T)
    lj, aj = JM.forward(j, jp, {"tokens": jnp.asarray(toks, jnp.int32)})
    lt, at = TM.forward(c, tp, {"tokens": torch.from_numpy(toks)})
    l64, _ = run64(TM.forward, {"tokens": torch.from_numpy(toks)})
    steps = [(lt, lj, l64)]
    assert float(at) == pytest.approx(float(aj), rel=1e-4, abs=1e-7)
    lj, cj = JM.prefill(j, jp, {"tokens": jnp.asarray(toks[:, :S],
                                                      jnp.int32)},
                        cache_len=S + T)
    lt, ct = TM.prefill(c, tp, {"tokens": torch.from_numpy(toks[:, :S])},
                        cache_len=S + T)
    l64, c64 = run64(TM.prefill, {"tokens": torch.from_numpy(toks[:, :S])},
                     cache_len=S + T)
    steps.append((lt, lj, l64))
    np.testing.assert_array_equal(ct["kpos"].numpy(), np.asarray(cj["kpos"]))
    for t in range(T):
        lj, cj = JM.decode_step(j, jp, cj, jnp.asarray(toks[:, S + t],
                                                       jnp.int32),
                                jnp.int32(S + t))
        lt, ct = TM.decode_step(c, tp, ct, torch.from_numpy(toks[:, S + t]),
                                S + t)
        l64, c64 = run64(lambda cfg, p: TM.decode_step(
            cfg, p, c64, torch.from_numpy(toks[:, S + t]), S + t))
        steps.append((lt, lj, l64))
    _assert_logits(arch, steps)
    np.testing.assert_array_equal(ct["kpos"].numpy(), np.asarray(cj["kpos"]))


@pytest.mark.parametrize("arch", SLICE_ARCHS + CONTROL_ARCHS)
def test_greedy_generate_matches_jax(arch):
    j = jget(arch).reduced()
    jp, tp = _carry(j, seed=1)
    c = _port_cfg(j)
    toks = _tokens(c, 3, 16, seed=1)
    want = JS.greedy_generate(j, jp, {"tokens": jnp.asarray(toks,
                                                            jnp.int32)},
                              steps=8, cache_len=24)
    got = TS.greedy_generate(c, tp, {"tokens": torch.from_numpy(toks)},
                             steps=8, cache_len=24)
    assert got.dtype == torch.int32 and got.shape == (3, 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_ring_buffer_window_decode_matches_jax():
    j = dataclasses.replace(jget("granite-3-2b").reduced(), window=8)
    jp, tp = _carry(j, seed=2)
    c = _port_cfg(j)
    toks = _tokens(c, 2, 12, seed=2)
    want = JS.greedy_generate(j, jp, {"tokens": jnp.asarray(toks,
                                                            jnp.int32)},
                              steps=6, cache_len=8, window=8)
    got = TS.greedy_generate(c, tp, {"tokens": torch.from_numpy(toks)},
                             steps=6, cache_len=8, window=8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_step_factories_and_sampling():
    c = get_config("granite-3-2b").reduced()
    prm = TM.init_params(c, torch.Generator().manual_seed(0))
    toks = torch.from_numpy(_tokens(c, 2, 6))
    lg, cache = TS.make_prefill_step(c, 10)(prm, {"tokens": toks})
    lg2, _ = TS.make_decode_step(c)(prm, cache, lg.argmax(-1), 6)
    assert lg.shape == lg2.shape == (2, TR.padded_vocab(c.vocab_size))
    draw = lambda: TS.greedy_generate(
        c, prm, {"tokens": toks}, steps=5, cache_len=12, temperature=1.0,
        generator=torch.Generator().manual_seed(4))
    a, b = draw(), draw()
    assert torch.equal(a, b) and ((0 <= a) & (a < c.vocab_size)).all()


# ---------------------------------------------------------------------------
# data and the entry point
# ---------------------------------------------------------------------------

def test_make_batch_is_the_zipf_bigram_recipe():
    cfg = SyntheticLMConfig(vocab_size=97, seq_len=400, batch_size=8,
                            seed=3)
    b = make_batch(cfg, 5)
    toks, labels = b["tokens"], b["labels"]
    assert toks.shape == labels.shape == (8, 400)
    assert torch.equal(toks[:, 1:], labels[:, :-1])
    assert ((0 <= toks) & (toks < 97)).all()
    assert torch.equal(make_batch(cfg, 5)["tokens"], toks)
    assert not torch.equal(make_batch(cfg, 6)["tokens"], toks)
    seq = torch.cat([toks, labels[:, -1:]], dim=1)
    bigram = ((seq[:, 1:] - seq[:, :-1]) % 97 == 1).float().mean().item()
    assert 0.72 < bigram < 0.82          # structure 0.75 plus chance
    fresh = seq[:, 1:][(seq[:, 1:] - seq[:, :-1]) % 97 != 1]
    assert (fresh < 10).float().mean().item() > 0.5      # Zipf head


def test_serve_lm_runs_on_the_cpu_and_refuses_a_missing_card(capsys):
    toks = serve_lm.main(["--arch", "phi3.5-moe-42b-a6.6b", "--batch", "2",
                          "--prompt-len", "8", "--gen", "4", "--layers", "1",
                          "--device", "cpu"])
    out = capsys.readouterr().out
    assert "tok/s" in out and "sample tokens" in out and "layers=1" in out
    assert toks.shape == (2, 4) and (toks < 32064).all()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            serve_lm.main(["--device", "cuda"])
    with pytest.raises(SystemExit):
        serve_lm.main(["--arch", "hubert-xlarge", "--device", "cpu"])


# ---------------------------------------------------------------------------
# the hybrid family: Zamba2-2.7B reduced (4 mamba layers, attn_every 2)
# ---------------------------------------------------------------------------

def _prefill_both(j, jp, c, tp, toks, cache_len):
    lj, cj = JM.prefill(j, jp, {"tokens": jnp.asarray(toks, jnp.int32)},
                        cache_len=cache_len)
    lt, ct = TM.prefill(c, tp, {"tokens": torch.from_numpy(toks)},
                        cache_len=cache_len)
    return lj, cj, lt, ct


@pytest.mark.parametrize("prompt", [200, 256])
def test_zamba2_prefill_decode_match_jax(prompt):
    # 200: longer than 128 and not a multiple of it, so every mamba layer
    # of the prefill runs the scan kernel (its plain version here); 256:
    # the SSD form
    j = jget("zamba2-2.7b").reduced()
    assert (j.num_layers, j.attn_every) == (4, 2)
    jp, tp = _carry(j)
    c = _port_cfg(j)
    B, T = 2, 3
    toks = _tokens(c, B, prompt + T)
    jref = j if prompt % 128 else dataclasses.replace(j, ssm_impl="scan")
    lj, cj, lt, ct = _prefill_both(j, jp, c, tp, toks[:, :prompt],
                                   prompt + T)
    lr, cr = (lj, cj) if jref is j else JM.prefill(
        jref, jp, {"tokens": jnp.asarray(toks[:, :prompt], jnp.int32)},
        cache_len=prompt + T)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lr), **LOGITS)
    e = np.abs(np.asarray(lj) - np.asarray(lr)).max()    # 0 on the scan path
    assert np.abs(lt.numpy() - np.asarray(lj)).max() <= \
        e + 2e-4 + 1e-4 * np.abs(np.asarray(lj)).max()
    np.testing.assert_array_equal(lt.argmax(-1).numpy(),
                                  np.asarray(lj).argmax(-1))
    np.testing.assert_array_equal(ct["kpos"].numpy(), np.asarray(cj["kpos"]))
    for k in ("h", "conv"):
        assert_step(ct["layers"]["mamba1"][k].numpy(),
                    cr["layers"]["mamba1"][k])
    assert_step(ct["shared_attn"]["k"].numpy(), cr["shared_attn"]["k"])
    for t in range(T):
        lr, cr = JM.decode_step(jref, jp, cr, jnp.asarray(toks[:, prompt + t],
                                                          jnp.int32),
                                jnp.int32(prompt + t))
        lt, ct = TM.decode_step(c, tp, ct,
                                torch.from_numpy(toks[:, prompt + t]),
                                prompt + t)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lr), **LOGITS)
    assert_step(ct["layers"]["mamba0"]["h"].numpy(),
                cr["layers"]["mamba0"]["h"])
    assert_step(ct["shared_attn"]["v"].numpy(), cr["shared_attn"]["v"])


@pytest.mark.parametrize("prompt", [200, 256])
def test_zamba2_greedy_generate_matches_jax(prompt):
    j = jget("zamba2-2.7b").reduced()
    jp, tp = _carry(j, seed=1)
    c = _port_cfg(j)
    toks = _tokens(c, 2, prompt, seed=1)
    want = JS.greedy_generate(j, jp, {"tokens": jnp.asarray(toks,
                                                            jnp.int32)},
                              steps=6, cache_len=prompt + 6)
    got = TS.greedy_generate(c, tp, {"tokens": torch.from_numpy(toks)},
                             steps=6, cache_len=prompt + 6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_zamba2_forward_matches_jax():
    j = jget("zamba2-2.7b").reduced()
    jp, tp = _carry(j, seed=2)
    c = _port_cfg(j)
    toks = _tokens(c, 2, 150, seed=2)
    lj, _ = JM.forward(j, jp, {"tokens": jnp.asarray(toks, jnp.int32)})
    lt, _ = TM.forward(c, tp, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **LOGITS)


def test_ssm_inits_are_f32_uniform_draws():
    cfg = dataclasses.replace(get_config("zamba2-2.7b").reduced(),
                              dtype="bfloat16")
    prm = TM.init_params(cfg, torch.Generator().manual_seed(0))
    again = TM.init_params(cfg, torch.Generator().manual_seed(0))
    m = prm["layers"]["mamba0"]
    assert m["wx"].dtype == torch.bfloat16
    assert m["A_log"].dtype == m["dt_bias"].dtype == torch.float32
    assert torch.equal(m["A_log"], again["layers"]["mamba0"]["A_log"])
    a = torch.exp(m["A_log"])                           # U[1, 16]
    assert a.shape == (2, 8) and bool(((a >= 1) & (a <= 16)).all())
    dt = torch.nn.functional.softplus(m["dt_bias"])     # U[1e-3, 0.1]
    assert bool(((dt >= 1e-3 - 1e-7) & (dt <= 0.1 + 1e-7)).all())
    big = TP._leaf_init(TP.ParamMeta((20000,), (None,), "ssm_a"),
                        torch.Generator().manual_seed(1), torch.bfloat16,
                        "cpu")
    assert big.dtype == torch.float32
    assert torch.exp(big).mean().item() == pytest.approx(8.5, rel=0.02)


def test_convert_keeps_the_ssm_leaves_f32_in_a_bf16_model():
    jb = dataclasses.replace(jget("zamba2-2.7b").reduced(), dtype="bfloat16")
    jpb = _np(JM.init_params(jb, jax.random.PRNGKey(3)))
    tpb = model_params_from_jax(jpb, _port_cfg(jb), "cpu")
    m, jm = tpb["layers"]["mamba1"], jpb["layers"]["mamba1"]
    assert str(jm["A_log"].dtype) == "float32"
    for k in ("A_log", "dt_bias"):
        assert m[k].dtype == torch.float32
        np.testing.assert_array_equal(m[k].numpy(), jm[k])
    assert m["wz"].dtype == tpb["shared_attn"]["wq"].dtype == torch.bfloat16


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_init_cache_gives_each_leaf_the_jax_type(dtype):
    j = dataclasses.replace(jget("zamba2-2.7b").reduced(), dtype=dtype)
    ct = TM.init_cache(_port_cfg(j), 2, 12, "cpu")
    cj = JM.init_cache(j, 2, 12)
    got = {p: (tuple(t.shape), str(t.dtype)[6:]) for p, t in _flat(ct)}
    want = {p: (tuple(t.shape), str(t.dtype)) for p, t in _flat(cj)}
    assert got == want
    assert got[("layers", "mamba0", "h")][1] == "float32"
    assert got[("shared_attn", "k")] == ((2, 2, 12, 16, 64), dtype)  # padded
    assert bool((ct["kpos"] == -1).all())
    assert not any(t.any() for p, t in _flat(ct) if p[-1] != "kpos")


def test_serve_lm_serves_zamba2_and_checks_its_depth(capsys):
    toks = serve_lm.main(["--arch", "zamba2-2.7b", "--batch", "2",
                          "--prompt-len", "140", "--gen", "3", "--device",
                          "cpu"])
    out = capsys.readouterr().out
    assert "arch=zamba2-2.7b layers=4" in out and toks.shape == (2, 3)
    with pytest.raises(ValueError, match="multiple of attn_every"):
        serve_lm.main(["--arch", "zamba2-2.7b", "--layers", "3",
                       "--device", "cpu"])
