"""The port's Lasso kernels against the JAX package's.

On the CPU the wrappers of ``repro_torch.kernels.lasso_cd`` take their
plain versions; those are held against the Pallas kernels run in
interpret mode and against the jnp oracles.  Tolerance: rtol = atol =
1e-5, because the f32 sums are taken in a different order.

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
from repro_torch.kernels import lasso_cd as tlc
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
    return types.SimpleNamespace(jnp=jnp, lc=lasso_cd, ref=ref)


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
