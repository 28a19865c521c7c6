"""The port's kernels against the JAX package's.

On the CPU the wrappers of ``repro_torch.kernels.lasso_cd`` and
``repro_torch.kernels.ops`` take their plain versions; those are held
against the Pallas kernels run in interpret mode and against the jnp
oracles.  Tolerances: rtol = atol = 1e-5 for the Lasso sums and the
gating probabilities, 2e-5 for f32 attention (f32 sums in a different
order), 2e-2 for bf16 attention (one bf16 rounding of the output);
gating indices are equal.

The tests marked ``gpu`` hold the CUDA kernels against the plain versions
on the card; they skip where no card is present.  Run them there with
``PYTHONPATH=src pytest -m gpu tests/test_torch_kernels.py``: the machine
with the card has no JAX, so the JAX package is imported inside the CPU
tests only.
"""
import types

import numpy as np
import pytest
import torch

from repro_torch.kernels import KernelSpec, build_kernels
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import lasso_cd as tlc
from repro_torch.kernels import moe_gating as tmg
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

TOL = dict(rtol=1e-5, atol=1e-5)   # f32 sums in a different order

# (rows per worker, columns, block_n): rows not a multiple of block_n,
# columns not a multiple of 128, and the main path's U = 32 / U′ = 128
SHAPES = [(300, 32, 256), (257, 128, 256), (190, 37, 64), (64, 130, 256),
          (5, 3, 256)]


def _inputs(W, n, U, seed=0):
    r = np.random.default_rng(seed)
    X = r.standard_normal((W, n, U)).astype(np.float32)
    res = r.standard_normal((W, n)).astype(np.float32)
    return X, res


@pytest.fixture(scope="module")
def jx():
    """The JAX package's kernels (imported here, not at module level)."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels import lasso_cd, ref
    from repro.kernels.flash_attention import flash_attention
    from repro.kernels.moe_gating import topk_gating
    return types.SimpleNamespace(jnp=jnp, lc=lasso_cd, ref=ref,
                                 flash=flash_attention, gating=topk_gating)


def _jax_per_worker(jx, fn, *arrays):
    return np.stack([np.asarray(fn(*(jx.jnp.asarray(a[w]) for a in arrays)))
                     for w in range(arrays[0].shape[0])])


@pytest.mark.parametrize("W", [1, 4])
@pytest.mark.parametrize("n,U,block_n", SHAPES)
def test_lasso_partial_plain_matches_jax(jx, W, n, U, block_n):
    X, res = _inputs(W, n, U)
    got = tlc.lasso_partial(torch.from_numpy(X), torch.from_numpy(res),
                            block_n=block_n).numpy()
    pallas = _jax_per_worker(
        jx, lambda x, r: jx.lc.lasso_partial(x, r, block_n=block_n,
                                             interpret=True), X, res)
    oracle = _jax_per_worker(jx, jx.ref.lasso_partial_ref, X, res)
    assert got.shape == (W, U) and got.dtype == np.float32
    np.testing.assert_allclose(got, pallas, **TOL)
    np.testing.assert_allclose(got, oracle, **TOL)


@pytest.mark.parametrize("W", [1, 4])
@pytest.mark.parametrize("n,U,block_n", SHAPES)
def test_gram_block_plain_matches_jax(jx, W, n, U, block_n):
    X, _ = _inputs(W, n, U, seed=1)
    got = tlc.gram_block(torch.from_numpy(X), block_n=block_n).numpy()
    pallas = _jax_per_worker(
        jx, lambda x: jx.lc.gram_block(x, block_n=block_n, interpret=True),
        X)
    oracle = _jax_per_worker(jx, jx.ref.gram_ref, X)
    assert got.shape == (W, U, U) and got.dtype == np.float32
    np.testing.assert_allclose(got, pallas, **TOL)
    np.testing.assert_allclose(got, oracle, **TOL)


def test_cpu_wrappers_take_the_plain_version_and_launch_nothing():
    X, res = _inputs(2, 40, 6)
    Xt, rt = torch.from_numpy(X), torch.from_numpy(res)
    before = dict(tlc.LAUNCHES)
    assert torch.equal(tlc.lasso_partial(Xt, rt), tref.lasso_partial_ref(Xt, rt))
    assert torch.equal(tlc.gram_block(Xt), tref.gram_ref(Xt))
    assert tlc.LAUNCHES == before


def test_backends_agree_and_reject_bad_shapes(jx):
    X, res = _inputs(4, 50, 9, seed=3)
    Xt, rt = torch.from_numpy(X), torch.from_numpy(res)
    refk = build_kernels(KernelSpec(kind="reference"))
    hop = build_kernels(KernelSpec.default_for("pallas"))
    assert hop.spec.block_n == jx.lc.DEFAULT_BLOCK_N == tlc.DEFAULT_BLOCK_N
    torch.testing.assert_close(hop.lasso_partial(Xt, rt),
                               refk.lasso_partial(Xt, rt), **TOL)
    torch.testing.assert_close(hop.gram_block(Xt), refk.gram_block(Xt),
                               **TOL)
    with pytest.raises(ValueError, match="W, n, U"):
        tlc.lasso_partial(Xt[0], rt[0])
    with pytest.raises(ValueError, match="W, n, U"):
        tlc.lasso_partial(Xt, rt[:, 1:])
    with pytest.raises(ValueError, match="W, n, U′"):
        tlc.gram_block(Xt[0])
    with pytest.raises(TypeError, match="KernelSpec"):
        build_kernels("pallas")


# ---------------------------------------------------------------------------
# Attention and gating (the model zoo's kernels), plain versions on the CPU
# ---------------------------------------------------------------------------

# B, Sq, Skv, Hq, Hkv, D, causal, window: causal, window, GQA, decode,
# Sq < Skv, ragged lengths, full attention, and Sq > Skv (the first rows
# of a causal call see no key)
ATTN_CASES = [
    (2, 32, 32, 4, 2, 8, True, None),
    (1, 64, 64, 2, 2, 16, True, 8),
    (1, 1, 40, 4, 1, 8, True, None),
    (2, 17, 33, 2, 1, 8, False, None),
    (1, 1, 64, 8, 2, 16, True, 16),
    (1, 16, 128, 4, 4, 8, True, 32),
    (2, 70, 70, 8, 2, 16, True, None),
    (1, 37, 101, 4, 1, 24, True, 9),
    (1, 20, 12, 2, 1, 8, True, None),
    (1, 20, 12, 2, 2, 8, True, 3),
]


def _attn_inputs(B, Sq, Skv, Hq, Hkv, D, seed=0):
    r = np.random.default_rng(seed)
    return (r.standard_normal((B, Sq, Hq, D)).astype(np.float32),
            r.standard_normal((B, Skv, Hkv, D)).astype(np.float32),
            r.standard_normal((B, Skv, Hkv, D)).astype(np.float32))


def _jax_flash(jx, q, k, v, **kw):
    tr = lambda x: jx.jnp.asarray(x).transpose(0, 2, 1, 3)
    out = jx.flash(tr(q), tr(k), tr(v), block_q=8, block_k=8,
                   interpret=True, **kw)
    return np.asarray(out.transpose(0, 2, 1, 3).astype(jx.jnp.float32))


@pytest.mark.parametrize("case", ATTN_CASES)
def test_attention_plain_matches_jax(jx, case):
    B, Sq, Skv, Hq, Hkv, D, causal, window = case
    q, k, v = _attn_inputs(B, Sq, Skv, Hq, Hkv, D)
    got = tops.attention(torch.from_numpy(q), torch.from_numpy(k),
                         torch.from_numpy(v), causal=causal,
                         window=window).numpy()
    assert got.shape == q.shape and got.dtype == np.float32
    pallas = _jax_flash(jx, q, k, v, causal=causal, window=window)
    np.testing.assert_allclose(got, pallas, rtol=2e-5, atol=2e-5)
    # the jnp oracle averages the values of a row that sees no key, where
    # the kernels write 0: compare the rows that see a key
    oracle = np.asarray(jx.ref.attention_ref(q, k, v, causal=causal,
                                             window=window))
    seen = tref.attention_mask(Sq, Skv, Skv - Sq, causal, window).any(-1)
    np.testing.assert_allclose(got[:, seen.numpy()],
                               oracle[:, seen.numpy()], rtol=2e-5,
                               atol=2e-5)
    assert not got[:, ~seen.numpy()].any()


def test_attention_plain_bf16_matches_jax(jx):
    q, k, v = _attn_inputs(2, 40, 40, 4, 1, 16, seed=1)
    bf = lambda a: torch.from_numpy(a).bfloat16()
    got = tops.attention(bf(q), bf(k), bf(v), causal=True, window=16)
    assert got.dtype == torch.bfloat16
    jb = lambda a: np.asarray(bf(a).float())
    pallas = _jax_flash(jx, *(jx.jnp.asarray(jb(a), jx.jnp.bfloat16)
                              for a in (q, k, v)), causal=True, window=16)
    np.testing.assert_allclose(got.float().numpy(), pallas, rtol=2e-2,
                               atol=2e-2)


def test_attention_scale_and_layout(jx):
    q, k, v = _attn_inputs(1, 9, 9, 2, 1, 8, seed=2)
    got = tops.attention(torch.from_numpy(q), torch.from_numpy(k),
                         torch.from_numpy(v), causal=True, scale=0.3)
    tr = lambda x: jx.jnp.asarray(x).transpose(0, 2, 1, 3)
    want = np.asarray(jx.flash(tr(q), tr(k), tr(v), causal=True, scale=0.3,
                               interpret=True).transpose(0, 2, 1, 3))
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)
    with pytest.raises(ValueError, match="group"):
        tref.attention_ref(torch.zeros(1, 2, 3, 4), torch.zeros(1, 2, 2, 4),
                           torch.zeros(1, 2, 2, 4))


# T, E, k: the main path's E = 16, k = 2; llama4's E = 128, k = 1; more
GATING_CASES = [(16, 8, 2), (100, 16, 2), (4, 16, 2), (7, 128, 1),
                (33, 128, 2), (64, 16, 4), (5, 3, 3), (1, 1, 1)]


@pytest.mark.parametrize("T,E,k", GATING_CASES)
def test_topk_gating_plain_matches_jax(jx, T, E, k):
    logits = np.random.default_rng(T * E + k).standard_normal(
        (T, E)).astype(np.float32)
    p, i = tops.topk_gating(torch.from_numpy(logits), k)
    assert p.dtype == torch.float32 and i.dtype == torch.int32
    pk, ik = jx.gating(jx.jnp.asarray(logits), k, block_t=8, interpret=True)
    pr, ir = jx.ref.topk_gating_ref(jx.jnp.asarray(logits), k)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ik))
    np.testing.assert_array_equal(i.numpy(), np.asarray(ir))
    np.testing.assert_allclose(p.numpy(), np.asarray(pk), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(p.numpy(), np.asarray(pr), rtol=1e-5,
                               atol=1e-5)


def test_topk_gating_ties_go_to_the_lower_index(jx):
    # bf16-valued logits, as the router makes them: exact ties are common
    r = np.random.default_rng(7)
    logits = np.round(r.standard_normal((64, 16)) * 2) / 2
    logits[:, 5] = logits[:, 9] = logits.max(-1) + 1      # a tie on top
    logits = logits.astype(np.float32)
    p, i = tops.topk_gating(torch.from_numpy(logits), 2)
    _, ik = jx.gating(jx.jnp.asarray(logits), 2, block_t=8, interpret=True)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ik))
    assert (i[:, 0] == 5).all() and (i[:, 1] == 9).all()
    torch.testing.assert_close(p, torch.full((64, 2), 0.5))


def test_cpu_ops_take_the_plain_version_and_launch_nothing():
    q, k, v = (torch.from_numpy(a) for a in _attn_inputs(1, 8, 8, 2, 1, 8))
    logits = torch.randn(10, 16, generator=torch.Generator().manual_seed(0))
    before = dict(tops.LAUNCHES)
    assert torch.equal(tops.attention(q, k, v, causal=True),
                       tref.attention_ref(q, k, v, causal=True))
    for a, b in zip(tops.topk_gating(logits, 2),
                    tref.topk_gating_ref(logits, 2)):
        assert torch.equal(a, b)
    assert tops.LAUNCHES == before
    with pytest.raises(ValueError, match="k=5"):
        tref.topk_gating_ref(logits[:, :4], 5)


def test_kernel_bindings_refuse_cpu_tensors():
    """The raw launchers take CUDA tensors only; nothing falls back."""
    q = torch.zeros(1, 2, 4, 8)
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_attention(q, q[:, :1], q[:, :1])
    with pytest.raises(ValueError, match="CUDA"):
        tmg.topk_gating(torch.zeros(4, 16), 2)


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


@pytest.mark.gpu
@pytest.mark.parametrize("W,n,U", [(4, 12500, 32), (1, 50000, 32),
                                   (4, 1001, 37), (3, 77, 5)])
def test_lasso_partial_kernel_matches_plain_on_card(cuda, W, n, U):
    X, res = _inputs(W, n, U, seed=4)
    Xt, rt = torch.from_numpy(X).to(cuda), torch.from_numpy(res).to(cuda)
    before = tlc.LAUNCHES["lasso_partial"]
    got = tlc.lasso_partial(Xt, rt)
    again = tlc.lasso_partial(Xt, rt)
    torch.cuda.synchronize()
    assert tlc.LAUNCHES["lasso_partial"] == before + 2
    assert torch.equal(got, again)          # no atomics: same bits
    want = tref.lasso_partial_ref(Xt, rt)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-3)


@pytest.mark.gpu
@pytest.mark.parametrize("W,n,U", [(4, 12500, 128), (1, 50000, 128),
                                   (4, 1001, 37), (2, 300, 130)])
def test_gram_block_kernel_matches_plain_on_card(cuda, W, n, U):
    X, _ = _inputs(W, n, U, seed=5)
    Xt = torch.from_numpy(X).to(cuda)
    before = tlc.LAUNCHES["gram_block"]
    got = tlc.gram_block(Xt)
    again = tlc.gram_block(Xt)
    torch.cuda.synchronize()
    assert tlc.LAUNCHES["gram_block"] == before + 2
    assert torch.equal(got, again)
    assert torch.equal(got, got.mT)         # upper triangle, mirrored
    want = tref.gram_ref(Xt)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("block_n", [1, 7, 256, 4096, 10 ** 6])
def test_kernels_agree_for_every_block_n_on_card(cuda, block_n):
    X, res = _inputs(2, 1000, 37, seed=6)
    Xt, rt = torch.from_numpy(X).to(cuda), torch.from_numpy(res).to(cuda)
    torch.testing.assert_close(tlc.lasso_partial(Xt, rt, block_n=block_n),
                               tref.lasso_partial_ref(Xt, rt),
                               rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(tlc.gram_block(Xt, block_n=block_n),
                               tref.gram_ref(Xt), rtol=1e-4, atol=1e-3)


@pytest.mark.gpu
def test_cuda_wrappers_reject_what_the_kernel_does_not_take(cuda):
    X = torch.zeros((2, 10, 4), dtype=torch.float64, device=cuda)
    with pytest.raises(TypeError, match="float32"):
        tlc.gram_block(X)
    Xt = torch.zeros((2, 4, 10), device=cuda).mT
    with pytest.raises(ValueError, match="contiguous"):
        tlc.gram_block(Xt)


def _cuda_attn(cuda, case, dtype, seed=8):
    B, Sq, Skv, Hq, Hkv, D, causal, window = case
    q, k, v = (torch.from_numpy(a).to(cuda, dtype)
               for a in _attn_inputs(B, Sq, Skv, Hq, Hkv, D, seed=seed))
    return q, k, v, dict(causal=causal, window=window)


# the main path's prefill (4, 1024, 1024, 32, 8, 128, causal) at batch 1,
# then ragged lengths, windows, GQA 4, Sq < Skv, Sq > Skv and head dims
# 64, 80, 128, 256
GPU_ATTN_CASES = ATTN_CASES + [
    (1, 1024, 1024, 32, 8, 128, True, None),
    (2, 200, 333, 8, 2, 64, True, 50),
    (1, 129, 129, 4, 4, 80, True, None),
    (1, 65, 300, 2, 1, 256, False, None),
    (3, 63, 63, 12, 3, 128, True, 7),
]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", GPU_ATTN_CASES)
def test_flash_attention_kernel_matches_plain_on_card(cuda, case, dtype):
    q, k, v, kw = _cuda_attn(cuda, case, dtype)
    before = tops.LAUNCHES["flash_attention"]
    got = tops.attention(q, k, v, **kw)
    again = tops.attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert tops.LAUNCHES["flash_attention"] == before + 2
    assert torch.equal(got, again)          # no atomics: same bits
    want = tref.attention_ref(q, k, v, **kw)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("T,E,k", GATING_CASES + [(4096, 16, 2),
                                                  (4096, 128, 1),
                                                  (1000, 64, 8),
                                                  (3, 128, 32)])
def test_topk_gating_kernel_matches_plain_on_card(cuda, T, E, k):
    gen = torch.Generator().manual_seed(T + E + k)
    logits = torch.randn((T, E), generator=gen).to(cuda)
    logits[: T // 2] = logits[: T // 2].bfloat16().float()   # with ties
    before = tops.LAUNCHES["topk_gating"]
    p, i = tops.topk_gating(logits, k)
    torch.cuda.synchronize()
    assert tops.LAUNCHES["topk_gating"] == before + 1
    pr, ir = tref.topk_gating_ref(logits, k)
    assert torch.equal(i, ir)
    torch.testing.assert_close(p, pr, rtol=1e-5, atol=1e-6)


@pytest.mark.gpu
def test_model_kernels_reject_what_they_do_not_take(cuda):
    q = torch.zeros((1, 4, 2, 8), device=cuda)
    with pytest.raises(TypeError, match="one dtype"):
        tops.attention(q, q.bfloat16(), q)
    with pytest.raises(ValueError, match="head_dim"):
        tops.attention(torch.zeros((1, 4, 2, 300), device=cuda),
                       torch.zeros((1, 4, 2, 300), device=cuda),
                       torch.zeros((1, 4, 2, 300), device=cuda))
    with pytest.raises(TypeError, match="float32"):
        tops.topk_gating(torch.zeros((4, 16), device=cuda,
                                     dtype=torch.bfloat16), 2)
    with pytest.raises(ValueError, match="experts"):
        tops.topk_gating(torch.zeros((4, 200), device=cuda), 2)
