"""The port's kernels against the JAX package's.

On the CPU the wrappers of ``repro_torch.kernels.lasso_cd`` and
``repro_torch.kernels.ops`` take their plain versions; those are held
against the Pallas kernels run in interpret mode and against the jnp
oracles.  Tolerances: rtol = atol = 1e-5 for the Lasso sums and the
gating probabilities, 2e-5 for f32 attention (f32 sums in a different
order), 2e-2 for bf16 attention (one bf16 rounding of the output);
gating indices are equal.  The selective scan: rtol = 1e-5 and atol =
1e-5 of the largest value for f32 y and every h (f32 sums in a different
order over up to 64 steps), 1e-2 for bf16 y (one bf16 rounding).

LDA's Gibbs sweep (``lda_gibbs``, no Pallas counterpart) is held against
the JAX ``_gibbs_scan`` in ``tests/test_torch_lda.py``; here its kernel
equals its plain version to the bit on the same noise (both use the
card's ``logf``).

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
from repro_torch.kernels import lda_gibbs as tlg
from repro_torch.kernels import moe_gating as tmg
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import ssm_scan as tss

TOL = dict(rtol=1e-5, atol=1e-5)   # f32 sums in a different order

# (rows per worker, columns, block_n): rows not a multiple of block_n,
# columns not a multiple of 128, the main path's U = 32 / U′ = 128, and
# U = 1 and 33 (the CUDA lasso_partial's edges: one column a lane, and one
# past a whole warp of 4-column loads)
SHAPES = [(300, 32, 256), (257, 128, 256), (190, 37, 64), (64, 130, 256),
          (5, 3, 256), (100, 1, 64), (150, 33, 64)]


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
    from repro.kernels.ssm_scan import ssm_scan
    return types.SimpleNamespace(jnp=jnp, lc=lasso_cd, ref=ref,
                                 flash=flash_attention, gating=topk_gating,
                                 scan=ssm_scan)


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


def _gram_footprint(W, n, U, C, S):
    """What ``gram_fused`` touches, from csrc/lasso_cd.cu's indexing: the
    rows of each slice, the highest workspace float written + 1 (a
    cluster's partial takes a slot of 8704 floats, of which block ``rank``
    writes piece ``rank``), and the highest counter + 1."""
    panels = -(-U // 128)
    jobs, groups = panels * panels, S // C
    rps = -(-n // S)
    rows = [min(n, min(n, s * rps) + rps) - min(n, s * rps)
            for s in range(S)]
    top = 0
    for w in range(W):
        for job in range(jobs):
            piece = 64 * (136 if job < panels else 128) // C
            for q in range(groups):
                for rank in range(C):
                    top = max(top, ((w * jobs + job) * groups + q) * 8704
                              + rank * piece + piece)
    return rows, top, W * jobs * C


@pytest.mark.parametrize("W,n,U,slots", [
    (4, 12500, 128, 120), (1, 50000, 128, 120), (4, 12500, 128, 132),
    (1, 50000, 128, 132), (4, 1001, 37, 120), (2, 300, 130, 120),
    (3, 77, 5, 132), (1, 5, 256, 112), (64, 4000, 128, 120),
    (2, 1000, 1, 16)])
def test_gram_plan_fills_the_card_within_its_workspace(W, n, U, slots):
    """The launch plan for a card that runs ``slots`` blocks at once: a
    cluster of 4 or 8 and S a multiple of it; the slices cover every row
    once; the workspace and the counters it promises are what the
    kernel's indexing reaches (to within the last slot of 8704 floats,
    which an off-diagonal job fills to 8192); and the main path's shapes
    fill the card in one wave."""
    C, S, floats, counters = tlc._gram_plan(W, n, U, slots)
    assert C in (4, 8) and S >= C and S % C == 0
    rows, top, need = _gram_footprint(W, n, U, C, S)
    assert sum(rows) == n and min(rows) >= 0
    assert floats - 8704 < top <= floats and counters == need
    blocks = S * (-(-U // 128)) ** 2 * W
    assert blocks <= max(slots, C * (-(-U // 128)) ** 2 * W)
    if (n, U) in ((12500, 128), (50000, 128)):
        assert blocks >= 0.9 * slots
        assert max(rows) <= 450             # ≤ 15 stages of 32 rows a block


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
    (1, 33, 70, 4, 2, 80, True, 20),
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


# ---------------------------------------------------------------------------
# The flash-attention backward's host side: which kernels a call takes, the
# workspaces, and the wgmma kernels' tile walk (mirrored from
# csrc/flash_attention.cu)
# ---------------------------------------------------------------------------

def _bwd_view(B, S, H, D, dtype=torch.bfloat16, offset=0, pad=0):
    """A (B, H, S, D) view of a (B, S, H, D + pad) buffer that starts
    ``offset`` elements into its storage, as ``ops`` hands it over."""
    buf = torch.empty(B * S * H * (D + pad) + offset, dtype=dtype)
    x = buf[offset:].view(B, S, H, D + pad)[..., :D]
    return x.transpose(1, 2)


# dtype, head dim, (tensor, change) → route: what decides it is the dtype,
# the head dim (64, 80 or 128; 96, 32 and D % 8 != 0 are not), and every
# one of q, k, v, out, dout having a 16-byte aligned base and strides of
# whole 16 bytes (one element in, or rows of D + 4, are not; 8 elements
# in, or rows of D + 8, are)
ROUTE_CASES = [
    ("bfloat16", 64, None, "wgmma"),
    ("bfloat16", 128, None, "wgmma"),
    ("float32", 64, None, "f32"),
    ("float32", 128, ("q", "offset", 1), "f32"),
    ("bfloat16", 80, None, "wgmma"),
    ("bfloat16", 80, ("q", "offset", 1), "mma_sync"),
    ("bfloat16", 80, ("v", "pad", 4), "mma_sync"),
    ("bfloat16", 80, ("dout", "pad", 8), "wgmma"),
    ("bfloat16", 96, None, "mma_sync"),
    ("bfloat16", 32, None, "mma_sync"),
    ("bfloat16", 62, None, "mma_sync"),
    ("bfloat16", 64, ("q", "offset", 1), "mma_sync"),
    ("bfloat16", 64, ("k", "offset", 1), "mma_sync"),
    ("bfloat16", 128, ("dout", "offset", 1), "mma_sync"),
    ("bfloat16", 64, ("out", "offset", 1), "mma_sync"),
    ("bfloat16", 64, ("v", "pad", 4), "mma_sync"),
    ("bfloat16", 128, ("q", "pad", 2), "mma_sync"),
    ("bfloat16", 64, ("q", "offset", 8), "wgmma"),
    ("bfloat16", 128, ("k", "pad", 8), "wgmma"),
]


@pytest.mark.parametrize("dt,D,change,route", ROUTE_CASES)
def test_bwd_route_follows_dtype_head_dim_and_alignment(dt, D, change,
                                                        route):
    dtype = getattr(torch, dt)
    shapes = {"q": (2, 70, 4), "k": (2, 90, 2), "v": (2, 90, 2),
              "out": (2, 70, 4), "dout": (2, 70, 4)}
    views = {}
    for name, (B, S, H) in shapes.items():
        kw = {}
        if change is not None and change[0] == name:
            kw[change[1]] = change[2]
        views[name] = _bwd_view(B, S, H, D, dtype, **kw)
    assert tfa.bwd_route(views["q"], views["k"], views["v"], views["out"],
                         views["dout"]) == route


def test_bwd_route_ignores_the_stride_of_an_extent_one_dim():
    """A dim of extent 1 is never stepped, so its stride does not decide
    the route (its tensor map is given a stride of 16 bytes)."""
    buf = torch.zeros(3 + 40 * 64, dtype=torch.bfloat16)
    q = buf.as_strided((1, 1, 40, 64), (3, 5, 64, 1), storage_offset=0)
    assert tfa.bwd_route(q, q, q, q, q) == "wgmma"
    q = buf.as_strided((1, 2, 20, 64), (3, 5, 64, 1), storage_offset=0)
    assert tfa.bwd_route(q, q, q, q, q) == "mma_sync"


def test_training_shape_takes_the_wgmma_route():
    """MiniCPM-2B's training call: q, k, v, out and dout (4, 2048, 48, 64)
    bf16, contiguous in (B, S, H, D) (the attention block's rope output,
    the forward's output and the gradient of the block's einsum), seen
    (B, H, S, D) by the backward."""
    q, k, v, out, dout = (_bwd_view(4, 2048, 48, 64) for _ in range(5))
    assert tfa.bwd_route(q, k, v, out, dout) == "wgmma"
    assert tfa.bwd_rows(2048, "wgmma") == 2304


@pytest.mark.parametrize("B,S,H,D", [(4, 1500, 16, 80), (4, 2000, 32, 80)])
def test_head_dim_80_training_shapes_take_the_wgmma_route(B, S, H, D):
    """HuBERT-XLarge's (4, 1500, 16, 80) and Zamba2-2.7B's (4, 2000, 32,
    80) training calls, contiguous in (B, S, H, D) as the attention block
    hands them over (160-byte rows: whole 16 bytes), take the wgmma route;
    one element into their buffer they take the mma.sync route."""
    views = [_bwd_view(B, S, H, D) for _ in range(5)]
    assert tfa.bwd_route(*views) == "wgmma"
    assert tfa.bwd_rows(S, "wgmma") == -(-S // 384) * 384
    views[0] = _bwd_view(B, S, H, D, offset=1)
    assert tfa.bwd_route(*views) == "mma_sync"


# the last four configurations the card serves and trains, at full width:
# (padded query heads, kv heads, head dim) of their attention
NEW_ATTN_ARCHS = [("granite-3-2b", (32, 8, 64)), ("stablelm-3b", (32, 32, 80)),
                  ("chatglm3-6b", (32, 2, 128)),
                  ("llama4-maverick-400b-a17b", (48, 8, 128))]


@pytest.mark.parametrize("arch,heads", NEW_ATTN_ARCHS)
def test_attention_block_hands_the_backward_wgmma_views(arch, heads,
                                                        monkeypatch):
    """One attention block of ``arch`` at full width in bf16 (StableLM's
    rope over 20 of 80 dims, ChatGLM3's over 64 of 128, each joined by a
    ``torch.cat``): the q, k and v it hands the kernel, the kernel's
    (B, S, H, D) output and the gradient the block's output projection
    sends back to it are TMA views, so the backward takes the wgmma
    route."""
    from repro_torch.configs import get_config
    from repro_torch.models import layers as TL
    from repro_torch.models import params as TP
    cfg = get_config(arch)
    p = TP.init(TL.attention_template(cfg), torch.Generator().manual_seed(0),
                torch.bfloat16, "cpu")
    seen = {}

    def attend(q, k, v, *, causal, window):
        seen["out"] = torch.zeros(q.shape, dtype=q.dtype, requires_grad=True)
        seen["qkv"] = (q, k, v)
        return seen["out"]
    monkeypatch.setattr(TL, "attend", attend)
    x = torch.randn((1, 130, cfg.d_model),
                    generator=torch.Generator().manual_seed(1)).bfloat16()
    y, _ = TL.attention_apply(p, x, cfg, positions=torch.arange(130))
    y.float().sum().backward()
    q, k, v = seen["qkv"]
    assert (q.shape[2], k.shape[2], q.shape[3]) == heads
    dout = seen["out"].grad
    if dout.stride(-1) != 1:                 # as ops._FlashAttention does
        dout = dout.contiguous()
    views = [t.transpose(1, 2) for t in (q, k, v, seen["out"], dout)]
    assert tfa.bwd_route(*views) == "wgmma"


@pytest.mark.parametrize("Sq", [1, 63, 64, 127, 128, 129, 333, 2048])
def test_bwd_workspace_rows(Sq):
    """The wgmma route's lse/delta workspaces hold Sq rounded up to a
    multiple of the dQ kernel's q tile at both head dims (every tile of
    either kernel reads inside its own (batch, head) row, and its 256-byte
    copies start 16-byte aligned); the other routes hold Sq."""
    r = tfa.bwd_rows(Sq, "wgmma")
    assert r % tfa.BWD_PAD == 0 and Sq <= r < Sq + tfa.BWD_PAD
    assert all(r % _q_tile(D) == 0 for D in tfa.WGMMA_HEAD_DIMS)
    assert (r * 4) % 16 == 0
    assert tfa.bwd_rows(Sq, "mma_sync") == tfa.bwd_rows(Sq, "f32") == Sq


# the wgmma kernels' tiles: a 64-row slab (a TMA box, a warpgroup's m64,
# a streamed step), dK/dV blocks of 128 keys, dQ blocks of a slab a
# consumer warpgroup: 3 at head dims 64 and 80, 2 at 128 (dq_consumers)
_SLAB, _KV_TILE = 64, 128


def _q_tile(D):
    return _SLAB * (3 if D in (64, 80) else 2)


def _slab_cover(k0, k1, r0, r1, offs, causal, window, whole):
    """slab_cover: whether some / every pair of keys [k0, k1] and rows
    [r0, r1] is visible."""
    p0, p1 = r0 + offs, r1 + offs
    some = (k0 <= k1 and r0 <= r1 and (not causal or k0 <= p1)
            and (not window or p0 - k1 < window))
    every = (whole and (not causal or k1 <= p0)
             and (not window or p1 - k0 < window))
    return some, every


def _seeing_slabs(k0, k1, Sq, Skv, causal, window):
    """seeing_slabs: the 64-row q tiles whose rows see a key of [k0, k1]."""
    offs = Skv - Sq
    lo = k0 - offs if causal else 0
    hi = k1 + window - 1 - offs if window else Sq - 1
    lo, hi = max(lo, 0), min(hi, Sq - 1)
    begin = lo // _SLAB
    return begin, begin if hi < lo else hi // _SLAB + 1


def _visible_tiles(q_lo, q_hi, Skv, causal, window):
    """visible_tiles: the 64-key tiles the rows at positions q_lo..q_hi
    see."""
    nkt = -(-Skv // _SLAB)
    end = (0 if q_hi < 0 else min(nkt, q_hi // _SLAB + 1)) if causal else nkt
    lo = q_lo - window + 1 if window else 0
    return (lo // _SLAB if lo > 0 else 0), end


def _bwd_walks(Sq, Skv, causal, window, D):
    """The tiles each wgmma kernel loads and the slabs each of its
    warpgroups computes: dK/dV blocks (128 keys) walk q tiles of 64 rows,
    a warpgroup 64 keys of each; dQ blocks (``_q_tile(D)`` q rows) walk kv
    tiles of 64 keys, a warpgroup 64 rows of each.  Returns {kernel:
    [(loaded (rows, keys), [slab (rows, keys, any, full), ...]), ...]}
    with inclusive ranges, in the kernels' order."""
    offs = Skv - Sq
    step = _SLAB
    block = _q_tile(D)
    last = lambda a, n, lim: min(a + n, lim) - 1
    walks = {"dkdv": [], "dq": []}
    for k0 in range(0, Skv, _KV_TILE):
        b, e = _seeing_slabs(k0, last(k0, _KV_TILE, Skv), Sq, Skv, causal,
                             window)
        for q0 in range(b * step, e * step, step):
            r1 = last(q0, step, Sq)
            slabs = []
            for kw0 in (k0, k0 + _SLAB):
                kw1 = last(kw0, _SLAB, Skv)
                some, every = _slab_cover(
                    kw0, kw1, q0, r1, offs, causal, window,
                    kw0 + _SLAB <= Skv and q0 + step <= Sq)
                slabs.append(((q0, r1), (kw0, kw1), some, every))
            walks["dkdv"].append((((q0, r1), (k0, last(k0, _KV_TILE, Skv))),
                                  slabs))
    for q0 in range(0, Sq, block):
        b, e = _visible_tiles(q0 + offs, last(q0, block, Sq) + offs, Skv,
                              causal, window)
        for k0 in range(b * step, e * step, step):
            k1 = last(k0, step, Skv)
            slabs = []
            for r0 in range(q0, q0 + block, _SLAB):
                r1 = last(r0, _SLAB, Sq)
                some, every = _slab_cover(
                    k0, k1, r0, r1, offs, causal, window,
                    k0 + step <= Skv and r0 + _SLAB <= Sq)
                slabs.append(((r0, r1), (k0, k1), some, every))
            walks["dq"].append((((q0, last(q0, block, Sq)), (k0, k1)),
                                slabs))
    return walks


# Sq, Skv, causal, window: the training shape; ragged tails; Sq < Skv;
# Sq > Skv (rows that see no key); windows narrower and wider than a tile;
# full attention; decode; a window of 1
WALK_CASES = [
    (2048, 2048, True, None), (1000, 1000, True, None),
    (333, 1001, True, None), (1001, 333, True, None),
    (700, 333, True, 100), (300, 300, True, 50), (100, 333, True, 70),
    (129, 257, False, None), (65, 300, False, 40), (200, 130, True, None),
    (1, 40, True, None), (64, 64, True, 1), (150, 200, True, 40),
    (1500, 1500, False, None), (2000, 2000, True, None),
]


@pytest.mark.parametrize("D", [64, 80, 128])
@pytest.mark.parametrize("Sq,Skv,causal,window", WALK_CASES)
def test_bwd_tile_walk_covers_every_visible_pair_once(Sq, Skv, causal,
                                                      window, D):
    """Each kernel computes every visible (query, key) pair in exactly one
    slab and no invisible one: a slab it computes (``any``) holds a
    visible pair, a slab it skips none, a slab it takes unmasked
    (``full``) only visible pairs; every tile it loads holds a visible
    pair; a dQ block walks its kv tiles in one fixed, rising order."""
    mask = tref.attention_mask(Sq, Skv, Skv - Sq, causal, window).numpy()
    for kernel, walk in _bwd_walks(Sq, Skv, causal, window, D).items():
        count = np.zeros(mask.shape, dtype=np.int64)
        for ((a, b), (c, d)), slabs in walk:
            assert mask[a:b + 1, c:d + 1].any(), (kernel, a, c)
            for (r0, r1), (k0, k1), some, every in slabs:
                m = mask[r0:r1 + 1, k0:k1 + 1]
                assert some == bool(m.any()), (kernel, r0, k0)
                assert not every or m.all(), (kernel, r0, k0)
                if some:
                    count[r0:r1 + 1, k0:k1 + 1] += m
        assert np.array_equal(count, mask.astype(np.int64)), kernel
    per_block = {}
    for ((a, _), (c, _)), _ in _bwd_walks(Sq, Skv, causal, window,
                                          D)["dq"]:
        per_block.setdefault(a, []).append(c)
    for keys in per_block.values():
        assert keys == sorted(set(keys))


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


# rows whose p tie by rounding, with the row's sum the same in every
# order of adding: the max 0.75 (e = 1) and logits d ulps below it (e =
# 1 - d 2^-24) on the experts named, the rest 30-35 below it (e < 1e-13,
# lost in any sum); name -> ({expert: d}, the picks of k argmaxes of p)
GATING_TIES = {
    # p3 = p4 = p5: the lower two go first, though e5 is the largest
    "two below a higher max": ({5: 0, 3: 1, 4: 1, 7: 64}, (3, 4)),
    "one below a higher max": ({5: 0, 3: 1, 9: 6}, (3, 5)),
    # p0 = p4 = p9: the one below the max goes second
    "one below between two maxes": ({0: 0, 9: 0, 4: 1, 12: 64}, (0, 4)),
    # no tie within reach of the picks: a near pair 0.25 below the max
    "a near pair below the picks": ({5: 0, 11: 2 ** 21, 8: 2 ** 22,
                                     2: 2 ** 22 + 1}, (5, 11)),
}


def _tie_rows(T: int, E: int, pattern: dict, seed: int) -> torch.Tensor:
    x = 0.75 - 30 - 5 * torch.rand((T, E),
                                   generator=torch.Generator().manual_seed(
                                       seed))
    for e, d in pattern.items():
        x[:, e] = 0.75 - d * 2.0 ** -24
    return x


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("E", [16, 128])
@pytest.mark.parametrize("name", list(GATING_TIES))
def test_topk_gating_rounding_ties_pick_as_jax(jx, name, E, k):
    """The tie rows of the GPU tests pick in the plain version as in the
    JAX kernel: by p, the lower index first among equal p."""
    pattern, picks = GATING_TIES[name]
    x = _tie_rows(16, E, pattern, E + k)
    p, i = tops.topk_gating(x, k)
    _, ik = jx.gating(jx.jnp.asarray(x.numpy()), k, block_t=8,
                      interpret=True)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ik))
    assert (i == torch.tensor(picks[:k], dtype=torch.int32)).all()


def test_cpu_ops_take_the_plain_version_and_launch_nothing():
    q, k, v = (torch.from_numpy(a) for a in _attn_inputs(1, 8, 8, 2, 1, 8))
    logits = torch.randn(10, 16, generator=torch.Generator().manual_seed(0))
    before = dict(tops.LAUNCHES)
    assert torch.equal(tops.attention(q, k, v, causal=True),
                       tref.attention_ref(q, k, v, causal=True))
    for a, b in zip(tops.topk_gating(logits, 2),
                    tref.topk_gating_ref(logits, 2)):
        assert torch.equal(a, b)
    x, dt, A, Bm, Cm, _ = (None if a is None else torch.from_numpy(a)
                           for a in _ssm_inputs(1, 6, 8, 16, False))
    for a, b in zip(tops.ssm_scan(x, dt, A, Bm, Cm),
                    tref.ssm_scan_ref(x, dt, A, Bm, Cm)):
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
    x, bm = torch.zeros(1, 3, 8), torch.zeros(1, 3, 4)
    with pytest.raises(ValueError, match="CUDA"):
        tss.ssm_scan(x, x, torch.zeros(8), bm, bm)


# the gating kernels' route: 16-byte loads where E % 4 == 0 on a 16-byte
# base (and, at k = 2, the backward's picks 8-byte aligned), checked
# 4-byte loads otherwise; (E, logits offset, picks offset, k, route)
GATING_ROUTES = [(16, 0, 0, 2, "vector"), (128, 0, 0, 1, "vector"),
                 (128, 4, 0, 2, "vector"), (64, 0, 0, 8, "vector"),
                 (33, 0, 0, 2, "scalar"), (3, 0, 0, 2, "scalar"),
                 (16, 1, 0, 2, "scalar"), (128, 2, 0, 1, "scalar"),
                 (16, 0, 1, 2, "scalar"), (16, 0, 1, 3, "vector")]


@pytest.mark.parametrize("E,offset,pick_offset,k,want", GATING_ROUTES)
def test_gating_route_follows_width_and_alignment(E, offset, pick_offset,
                                                  k, want):
    logits = _offset_view(torch.randn(6, E), offset)
    picks = [_offset_view(torch.zeros(6, k, dtype=dt), pick_offset)
             for dt in (torch.int32, torch.float32, torch.float32)]
    assert tmg.route(logits, *picks) == want
    if not pick_offset:
        assert tmg.route(logits) == want
    assert tmg.route(logits.double()) == "scalar"


@pytest.mark.parametrize("E,k", [(16, 2), (128, 1)])
def test_router_logits_take_the_vector_route(E, k):
    """The model's router hands the kernel logits the vector route takes
    (a fresh ``(h @ router).float()``), at Phi's and Llama-4's widths."""
    from repro_torch.models import moe
    seen = []
    real = tops.topk_gating

    def spy(logits, kk):
        seen.append(tmg.route(logits))
        return real(logits, kk)
    cfg = types.SimpleNamespace(experts_per_token=k, num_experts=E)
    g = torch.Generator().manual_seed(E)
    h = torch.randn(10, 64, generator=g).bfloat16()
    tops.topk_gating = spy
    try:
        moe._router({"router": torch.randn(64, E, generator=g)}, h, cfg)
    finally:
        tops.topk_gating = real
    assert seen == ["vector"]


# ---------------------------------------------------------------------------
# The selective scan, plain version on the CPU
# ---------------------------------------------------------------------------

# B, S, C, N, h0 given, dtype, the Pallas kernel's chunk: S ragged against
# the chunk, S below it, h0 given and None, N = 16 (reduced) and 64
# (Zamba2-2.7B), C not a multiple of the CUDA kernel's 32-channel block;
# N = 1, 17 and 63, the edges of the CUDA kernel's split of a channel's
# states over lanes (one live state, one past a bucket, one short of it)
SSM_CASES = [
    (2, 37, 24, 16, True, "float32", 16),
    (1, 64, 40, 64, False, "float32", 64),
    (2, 5, 8, 16, False, "float32", 64),
    (3, 50, 33, 64, True, "float32", 16),
    (1, 1, 16, 16, True, "float32", 64),
    (2, 40, 16, 16, True, "bfloat16", 16),
    (1, 64, 24, 64, False, "bfloat16", 32),
    (2, 21, 70, 1, True, "float32", 16),
    (1, 30, 40, 17, False, "bfloat16", 16),
    (2, 19, 72, 63, True, "float32", 8),
]


def _ssm_inputs(B, S, C, N, with_h0, seed=0):
    """x, Bm, Cm, h0 standard normal; dt = softplus(N(0,1) − 1) > 0;
    A = −exp(U(−1, 1)) < 0, as the model makes them."""
    r = np.random.default_rng(seed)
    x = r.standard_normal((B, S, C)).astype(np.float32)
    dt = np.log1p(np.exp(r.standard_normal((B, S, C)) - 1)).astype(
        np.float32)
    A = -np.exp(r.uniform(-1, 1, C)).astype(np.float32)
    Bm = r.standard_normal((B, S, N)).astype(np.float32)
    Cm = r.standard_normal((B, S, N)).astype(np.float32)
    h0 = r.standard_normal((B, C, N)).astype(np.float32) if with_h0 \
        else None
    return x, dt, A, Bm, Cm, h0


def _close(got, want, rtol, atol_frac):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=rtol,
                               atol=atol_frac * max(1.0, np.abs(want).max()))


@pytest.mark.parametrize("case", SSM_CASES)
def test_ssm_scan_plain_matches_jax(jx, case):
    B, S, C, N, with_h0, dtype, chunk = case
    x, dt, A, Bm, Cm, h0 = _ssm_inputs(B, S, C, N, with_h0)
    tdt = getattr(torch, dtype)
    seq = [torch.from_numpy(a).to(tdt) for a in (x, dt, Bm, Cm)]
    th0 = None if h0 is None else torch.from_numpy(h0)
    y, h = tops.ssm_scan(seq[0], seq[1], torch.from_numpy(A), seq[2],
                         seq[3], th0)
    assert y.shape == (B, S, C) and y.dtype == tdt
    assert h.shape == (B, C, N) and h.dtype == torch.float32
    # the JAX package gets the same values in the same type
    jseq = [jx.jnp.asarray(t.float().numpy(), getattr(jx.jnp, dtype))
            for t in seq]
    jh0 = None if h0 is None else jx.jnp.asarray(h0)
    yp, hp = jx.scan(jseq[0], jseq[1], jx.jnp.asarray(A), jseq[2], jseq[3],
                     jh0, chunk=chunk, interpret=True)
    yo, ho = jx.ref.ssm_scan_ref(jseq[0], jseq[1], jx.jnp.asarray(A),
                                 jseq[2], jseq[3], jh0)
    ytol = 1e-5 if dtype == "float32" else 1e-2
    for want_y, want_h in ((yp, hp), (yo, ho)):
        _close(y.float().numpy(), np.asarray(want_y, np.float32), ytol,
               ytol)
        _close(h.numpy(), want_h, 1e-5, 1e-5)


# ssm_scan_bwd's walk (mirrored from csrc/ssm_scan.cu): the forward saves
# the state before each tile of 16 steps but the first; the backward walks
# the tiles from the last, each as two halves of 8 steps, the later first
# (when the tile has a step there), a half's states taken again from the
# tile's boundary (the later half's through the earlier half's steps);
# steps past S decay 1 with input 0
_SSM_T, _SSM_TB = 16, 8


def _ssm_forward_states(a, u, h0):
    """The state before each step, and the saved boundary states."""
    before, saved, h = [], [], h0
    tiles = -(-len(a) // _SSM_T)
    for k in range(tiles):
        if k > 0:
            saved.append(h)
        for t in range(k * _SSM_T, (k + 1) * _SSM_T):
            if t < len(a):
                before.append(h)
            at, ut = (a[t], u[t]) if t < len(a) else (np.float32(1), 0)
            h = np.float32(np.float32(at * h) + ut)
    return before, saved


def _ssm_bwd_walk(a, u, h0, saved):
    """(step, the state before it, the boundary it was taken from) in the
    order the backward takes them."""
    S, out = len(a), []
    for k in range(-(-S // _SSM_T) - 1, -1, -1):
        steps = min(_SSM_T, S - k * _SSM_T)
        bound = saved[k - 1] if k else h0

        def run(h, lo, hi):
            states = []
            for tt in range(lo, hi):
                states.append(h)
                t = k * _SSM_T + tt
                at, ut = (a[t], u[t]) if tt < steps else (np.float32(1), 0)
                h = np.float32(np.float32(at * h) + ut)
            return states, h
        if steps > _SSM_TB:
            _, h8 = run(bound, 0, _SSM_TB)
            later, _ = run(h8, _SSM_TB, _SSM_T)
            out += [(k * _SSM_T + tt, later[tt - _SSM_TB], k)
                    for tt in range(min(steps, _SSM_T) - 1, _SSM_TB - 1, -1)]
        earlier, _ = run(bound, 0, _SSM_TB)
        out += [(k * _SSM_T + tt, earlier[tt], k)
                for tt in range(min(steps, _SSM_TB) - 1, -1, -1)]
    return out


@pytest.mark.parametrize("S", [1, 7, 8, 9, 15, 16, 17, 33, 2000])
def test_ssm_scan_bwd_walk_takes_every_state_once_in_reverse(S):
    """Every step's state exactly once, in reverse, equal to the bit to
    the forward's, and taken from the boundary of the step's own tile."""
    r = np.random.default_rng(S)
    a = np.exp(-r.uniform(0, 2, S)).astype(np.float32)
    u = r.standard_normal(S).astype(np.float32)
    h0 = np.float32(r.standard_normal())
    before, saved = _ssm_forward_states(a, u, h0)
    assert len(saved) == max(0, -(-S // _SSM_T) - 1)
    walk = _ssm_bwd_walk(a, u, h0, saved)
    assert [t for t, _, _ in walk] == list(range(S - 1, -1, -1))
    assert all(h == before[t] for t, h, _ in walk)
    assert all(k == t // _SSM_T for t, _, k in walk)


def _ssm_bwd_smem(NB, itemsize):
    """bwd_smem_bytes: 8 states a thread (32 channels x NB), (a, u, dy,
    dt) and (dx, ddt) of 16 steps, B and C of 8 in f32, dB and dC of 8 by
    warp, and a ring of two 16-step tiles of x, dt, dy, B, C."""
    C, T, TB, W = 32, 16, 8, 4
    return (TB * C * NB * 4 + T * C * 16 + T * C * 8 + 2 * TB * NB * 4
            + 2 * W * TB * NB * 4 + 2 * (3 * T * C + 2 * T * NB) * itemsize)


@pytest.mark.parametrize("NB,blocks", [(64, 2), (32, 3)])
def test_ssm_scan_bwd_shared_memory_fits_blocks_a_sm(NB, blocks):
    """In bf16, two blocks fit an H100 SM's 228 KB at N = 64 (Zamba2's),
    three at N <= 32, with the 1 KB each block reserves.  This reads a
    Python mirror of bwd_smem_bytes (ssm_scan.cu), not the source's own
    value: test_ssm_scan_bwd_runs_two_blocks_a_sm_on_card reads that
    through the occupancy API and holds the mirror to it."""
    smem = _ssm_bwd_smem(NB, 2)
    assert smem <= 113 * 1024
    assert blocks * (smem + 1024) <= 228 * 1024 < \
        (blocks + 1) * (smem + 1024)


def test_ssm_scan_plain_keeps_h0_and_takes_zeros_for_none():
    x, dt, A, Bm, Cm, h0 = (None if a is None else torch.from_numpy(a)
                            for a in _ssm_inputs(2, 9, 12, 16, True, seed=1))
    y0, h_none = tops.ssm_scan(x, dt, A, Bm, Cm)
    y1, h_zero = tops.ssm_scan(x, dt, A, Bm, Cm, torch.zeros_like(h0))
    assert torch.equal(y0, y1) and torch.equal(h_none, h_zero)
    h0_before = h0.clone()
    # two halves carried through h equal one call over the whole sequence
    ya, ha = tops.ssm_scan(x[:, :4], dt[:, :4], A, Bm[:, :4], Cm[:, :4], h0)
    yb, hb = tops.ssm_scan(x[:, 4:], dt[:, 4:], A, Bm[:, 4:], Cm[:, 4:], ha)
    y, h = tops.ssm_scan(x, dt, A, Bm, Cm, h0)
    torch.testing.assert_close(torch.cat([ya, yb], 1), y, rtol=1e-6,
                               atol=1e-6)
    torch.testing.assert_close(hb, h, rtol=1e-6, atol=1e-6)
    assert torch.equal(h0, h0_before)                  # not written
    ye, he = tops.ssm_scan(x[:, :0], dt[:, :0], A, Bm[:, :0], Cm[:, :0], h0)
    assert ye.shape == (2, 0, 12) and torch.equal(he, h0)


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


def _offset_view(t: torch.Tensor, offset: int = 1) -> torch.Tensor:
    """``t``'s values in a contiguous view that starts ``offset`` elements
    into a larger buffer (a base that is not 16-byte aligned)."""
    buf = torch.zeros(t.numel() + offset, dtype=t.dtype, device=t.device)
    buf[offset:] = t.reshape(-1)
    return buf[offset:].view(t.shape)


@pytest.mark.gpu
@pytest.mark.parametrize("U", [32, 37, 1, 33])
def test_lasso_partial_kernel_takes_unaligned_views_on_card(cuda, U):
    """A base one element past 16-byte alignment (and U = 37, 1, 33 on any
    base) takes the kernel's scalar loads; U = 32 aligned takes float4."""
    X, res = _inputs(4, 12500, U, seed=11)
    Xt = _offset_view(torch.from_numpy(X).to(cuda))
    rt = _offset_view(torch.from_numpy(res).to(cuda))
    assert Xt.data_ptr() % 16 != 0 and Xt.is_contiguous()
    want = tref.lasso_partial_ref(Xt, rt)
    for Xa, ra in ((Xt, rt), (Xt.contiguous(), rt.contiguous())):
        got = tlc.lasso_partial(Xa, ra)
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-3)


def _graph_kernel_nodes(fn) -> list:
    """The node types of a CUDA graph that captures one call of ``fn``
    (the driver's cuGraphGetNodes / cuGraphNodeGetType; 0 is a kernel)."""
    import ctypes
    cu = ctypes.CDLL("libcuda.so.1")
    g = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(g):
        fn()
    graph = ctypes.c_void_p(g.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    assert cu.cuGraphGetNodes(graph, None, ctypes.byref(n)) == 0
    nodes = (ctypes.c_void_p * n.value)()
    assert cu.cuGraphGetNodes(graph, nodes, ctypes.byref(n)) == 0
    kinds = []
    for node in nodes:
        kind = ctypes.c_int(-1)
        assert cu.cuGraphNodeGetType(ctypes.c_void_p(node),
                                     ctypes.byref(kind)) == 0
        kinds.append(kind.value)
    return kinds


@pytest.mark.gpu
def test_lasso_partial_is_one_launch_and_replays_the_same_bits_on_card(
        cuda):
    """One kernel a call (the nodes of a captured call's CUDA graph), and
    a captured CUDA graph replayed 3 times gives the eager call's bits
    each time: the per-worker counters are back at 0 after every call."""
    X, res = _inputs(4, 12500, 32, seed=12)
    Xt, rt = torch.from_numpy(X).to(cuda), torch.from_numpy(res).to(cuda)
    want = tlc.lasso_partial(Xt, rt)
    torch.cuda.synchronize()
    assert _graph_kernel_nodes(lambda: tlc.lasso_partial(Xt, rt)) == [0]
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        out = tlc.lasso_partial(Xt, rt)
    for _ in range(3):
        out.zero_()
        g.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, want)


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
def test_gram_block_is_one_launch_and_replays_the_same_bits_on_card(cuda):
    """One kernel a call, G symmetric to the bit, and a captured call
    replayed 3 times gives the eager call's bits each time: the counters
    are back at 0 after every call."""
    X, _ = _inputs(4, 12500, 128, seed=13)
    Xt = torch.from_numpy(X).to(cuda)
    want = tlc.gram_block(Xt)
    torch.cuda.synchronize()
    assert torch.equal(want, want.mT)
    assert _graph_kernel_nodes(lambda: tlc.gram_block(Xt)) == [0]
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        out = tlc.gram_block(Xt)
    for _ in range(3):
        out.zero_()
        g.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, want)


@pytest.mark.gpu
@pytest.mark.parametrize("U", [128, 37])
def test_gram_block_kernel_takes_unaligned_views_on_card(cuda, U):
    """A base one element past 16-byte alignment (and U′ = 37 on any base)
    takes the kernel's 4-byte copies; U′ = 128 aligned takes 16-byte
    ones."""
    X, _ = _inputs(4, 12500, U, seed=14)
    Xt = _offset_view(torch.from_numpy(X).to(cuda))
    assert Xt.data_ptr() % 16 != 0 and Xt.is_contiguous()
    want = tref.gram_ref(Xt)
    for Xa in (Xt, Xt.contiguous()):
        got = tlc.gram_block(Xa)
        assert torch.equal(got, got.mT)
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("U", [1, 8, 127, 129, 256])
def test_gram_block_kernel_matches_plain_at_every_width_on_card(cuda, U):
    """One column, a single 8-column tile, a panel less one column, and
    two panels (ragged and whole: diagonal and off-diagonal jobs)."""
    X, _ = _inputs(2, 3000, U, seed=15)
    Xt = torch.from_numpy(X).to(cuda)
    got = tlc.gram_block(Xt)
    torch.cuda.synchronize()
    assert torch.equal(got, tlc.gram_block(Xt))
    assert torch.equal(got, got.mT)
    torch.testing.assert_close(got, tref.gram_ref(Xt), rtol=1e-4, atol=1e-2)


@pytest.mark.gpu
def test_gram_block_shares_its_workspace_soundly_on_card(cuda):
    """Calls at two shapes, interleaved with lasso_partial (which shares
    the workspace and counters), give the first call's bits again."""
    X4, res = _inputs(4, 12500, 128, seed=16)
    X1, _ = _inputs(1, 50000, 128, seed=17)
    X4t, X1t = torch.from_numpy(X4).to(cuda), torch.from_numpy(X1).to(cuda)
    Xb, rt = X4t[..., :32].contiguous(), torch.from_numpy(res).to(cuda)
    first4, first1 = tlc.gram_block(X4t), tlc.gram_block(X1t)
    z = tlc.lasso_partial(Xb, rt)
    for _ in range(2):
        assert torch.equal(tlc.gram_block(X4t), first4)
        assert torch.equal(tlc.lasso_partial(Xb, rt), z)
        assert torch.equal(tlc.gram_block(X1t), first1)
    torch.testing.assert_close(first1, tref.gram_ref(X1t), rtol=1e-4,
                               atol=1e-2)


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
    """A case's q, k, v on the card; a ninth entry, when present, places
    each at that many elements into a larger buffer (a view whose base is
    not 16-byte aligned)."""
    B, Sq, Skv, Hq, Hkv, D, causal, window, *offset = case

    def put(a):
        x = torch.from_numpy(a).to(cuda, dtype)
        if not offset:
            return x
        buf = torch.zeros(x.numel() + offset[0], dtype=dtype, device=cuda)
        buf[offset[0]:] = x.reshape(-1)
        return buf[offset[0]:].view(x.shape)
    q, k, v = (put(a) for a in _attn_inputs(B, Sq, Skv, Hq, Hkv, D,
                                            seed=seed))
    return q, k, v, dict(causal=causal, window=window)


# the main path's prefill (4, 1024, 1024, 32, 8, 128, causal) at batch 1,
# then ragged lengths, windows, GQA 4, Sq < Skv, Sq > Skv and head dims
# 64, 80, 128, 256; Zamba2's prefill (4, 1000, 1000, 32, 32, 80, causal)
# at batch 1; D = 256 at S = 1024; a window smaller than a tile with
# Sq > Skv (rows that see no key of a tile their block loads); views offset
# by one element into a larger buffer (the kernel's unaligned load path)
GPU_ATTN_CASES = ATTN_CASES + [
    (1, 1024, 1024, 32, 8, 128, True, None),
    (2, 200, 333, 8, 2, 64, True, 50),
    (1, 129, 129, 4, 4, 80, True, None),
    (1, 65, 300, 2, 1, 256, False, None),
    (3, 63, 63, 12, 3, 128, True, 7),
    (1, 1000, 1000, 32, 32, 80, True, None),
    (1, 1024, 1024, 8, 2, 256, True, None),
    (2, 300, 170, 4, 2, 64, True, 5),
    (2, 150, 200, 8, 2, 128, True, 40, 1),
] + [  # ChatGLM3's group of 16 and Llama-4's of 6 at head dim 128, and
    # StableLM's causal MHA at 80, each also at a ragged Skv of 1,001
    (1, 1024, 1024, 32, 2, 128, True, None),
    (2, 333, 1001, 32, 2, 128, True, None),
    (1, 1024, 1024, 48, 8, 128, True, None),
    (2, 333, 1001, 48, 8, 128, True, None),
    (2, 333, 1001, 32, 32, 80, True, None),
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


def _cuda_ssm(cuda, B, S, C, N, with_h0, dtype, seed=9, strided=False):
    """The scan's inputs on the card; ``strided`` cuts x, Bm, Cm out of one
    wider (B, S, C + 2N) tensor, as the model's conv output gives them."""
    x, dt, A, Bm, Cm, h0 = _ssm_inputs(B, S, C, N, with_h0, seed=seed)
    if strided:
        xc = torch.from_numpy(np.concatenate([x, Bm, Cm], -1)).to(cuda,
                                                                  dtype)
        x_, Bm_, Cm_ = xc[..., :C], xc[..., C:C + N], xc[..., C + N:]
    else:
        x_, Bm_, Cm_ = (torch.from_numpy(a).to(cuda, dtype)
                        for a in (x, Bm, Cm))
    return (x_, torch.from_numpy(dt).to(cuda, dtype),
            torch.from_numpy(A).to(cuda), Bm_, Cm_,
            None if h0 is None else torch.from_numpy(h0).to(cuda))


# the main path's prefill (4, 1000, 5120, 64, bf16, h0 zeros) at batch 1,
# then S = 1, 25, 200 and 1,000; N = 16 and 64 (and 20 and 33, between the
# kernel's register buckets); C not a multiple of the 32-channel block;
# h0 given and None; strided views
GPU_SSM_CASES = SSM_CASES + [
    (1, 1000, 5120, 64, True, "bfloat16", 0),
    (2, 1, 100, 64, True, "float32", 0),
    (2, 25, 130, 16, False, "bfloat16", 0),
    (3, 200, 257, 64, True, "float32", 0),
    (1, 1000, 96, 16, False, "float32", 0),
    (2, 77, 70, 20, True, "bfloat16", 0),
    (1, 33, 64, 33, False, "float32", 0),
]


@pytest.mark.gpu
@pytest.mark.parametrize("strided", [False, True])
@pytest.mark.parametrize("case", GPU_SSM_CASES)
def test_ssm_scan_kernel_matches_plain_on_card(cuda, case, strided):
    B, S, C, N, with_h0, dtype, _ = case
    args = _cuda_ssm(cuda, B, S, C, N, with_h0, getattr(torch, dtype),
                     strided=strided)
    before = tops.LAUNCHES["ssm_scan"]
    y, h = tops.ssm_scan(*args)
    y2, h2 = tops.ssm_scan(*args)
    torch.cuda.synchronize()
    assert tops.LAUNCHES["ssm_scan"] == before + 2
    assert torch.equal(y, y2) and torch.equal(h, h2)   # same bits
    yr, hr = tref.ssm_scan_ref(*args)
    assert y.dtype == yr.dtype and h.dtype == torch.float32
    tol = 1e-4 if dtype == "float32" else 1e-2
    for got, want, t in ((y, yr, tol), (h, hr, 1e-4)):
        err = (got.float() - want.float()).abs().max().item()
        assert err <= t * max(1.0, want.float().abs().max().item()), err


@pytest.mark.gpu
@pytest.mark.parametrize("case", [(1, 1000, 5120, 64, True, "bfloat16"),
                                  (2, 77, 70, 17, False, "bfloat16"),
                                  (2, 40, 96, 63, True, "float32")])
def test_ssm_scan_kernel_takes_unaligned_views_on_card(cuda, case):
    """x, dt, Bm, Cm each one element into a larger buffer: the kernel's
    element loads in place of its 16-byte copies."""
    B, S, C, N, with_h0, dtype = case
    args = list(_cuda_ssm(cuda, B, S, C, N, with_h0, getattr(torch, dtype)))
    for i in (0, 1, 3, 4):
        args[i] = _offset_view(args[i])
        assert args[i].data_ptr() % 16 != 0
    y, h = tops.ssm_scan(*args)
    yr, hr = tref.ssm_scan_ref(*args)
    tol = 1e-4 if dtype == "float32" else 1e-2
    for got, want, t in ((y, yr, tol), (h, hr, 1e-4)):
        err = (got.float() - want.float()).abs().max().item()
        assert err <= t * max(1.0, want.float().abs().max().item()), err


@pytest.mark.gpu
def test_ssm_scan_kernel_rejects_what_it_does_not_take(cuda):
    x, dt, A, Bm, Cm, h0 = _cuda_ssm(cuda, 1, 8, 16, 16, True,
                                     torch.float32)
    with pytest.raises(TypeError, match="one dtype"):
        tops.ssm_scan(x, dt.bfloat16(), A, Bm, Cm, h0)
    with pytest.raises(TypeError, match="float32"):
        tops.ssm_scan(x, dt, A.bfloat16(), Bm, Cm, h0)
    with pytest.raises(ValueError, match="at most 64"):
        big = torch.zeros((1, 8, 65), device=cuda)
        tops.ssm_scan(x, dt, A, big, big)
    with pytest.raises(ValueError, match="stride"):
        tops.ssm_scan(x.mT.contiguous().mT, dt, A, Bm, Cm, h0)
    with pytest.raises(ValueError, match="one card"):
        tops.ssm_scan(x, dt, A.cpu(), Bm, Cm, h0)


# ---------------------------------------------------------------------------
# The flash-attention backward (the port's own kernel) on the card
# ---------------------------------------------------------------------------

# MiniCPM-2B's training shape (4, 2048, 2048, 48, 48, 64, causal) at batch
# 1; Granite's GQA 32/8 at head dim 64 and Phi's 32/8 at 128, also at 1,000
# rows (a tail of 104 keys, not a multiple of 128); Zamba2's head dim 80
# with a window; Sq < Skv, Sq > Skv (rows that see no key), ragged lengths,
# full attention, a window of three keys; views one element into a larger
# buffer (the mma.sync route for bf16 at head dims 64 and 128 too); head
# dim 80 on the wgmma route: HuBERT-XLarge's (1500, 16, 80) non-causal at
# batch 1, a causal 1,000-row tail, GQA 32/8, Sq != Skv with a window, and
# one element into its buffer (the mma.sync route)
GPU_ATTN_BWD_CASES = [
    (1, 2048, 2048, 48, 48, 64, True, None),
    (1, 512, 512, 32, 8, 64, True, None),
    (1, 512, 512, 32, 8, 128, True, None),
    (1, 1000, 1000, 32, 8, 64, True, None),
    (1, 1000, 1000, 32, 8, 128, True, None),
    (2, 300, 300, 8, 8, 80, True, 50),
    (2, 100, 333, 8, 2, 64, True, 70),
    (1, 200, 130, 4, 2, 128, True, None),
    (2, 333, 1001, 8, 2, 128, True, None),
    (1, 700, 333, 8, 2, 64, True, 100),
    (2, 97, 97, 4, 1, 80, False, None),
    (1, 65, 300, 2, 1, 64, False, 40),
    (2, 129, 257, 4, 1, 128, False, None),
    (1, 64, 64, 2, 1, 64, True, 3),
    (2, 150, 200, 8, 2, 128, True, 40, 1),
    (1, 300, 300, 4, 2, 64, True, None, 1),
    (1, 1500, 1500, 16, 16, 80, False, None),
    (1, 1000, 1000, 32, 32, 80, True, None),
    (1, 512, 512, 32, 8, 80, True, None),
    (2, 333, 1001, 8, 2, 80, True, 100),
    (1, 700, 333, 8, 2, 80, True, 100),
    (2, 150, 200, 8, 2, 80, True, 40, 1),
    # ChatGLM3's group of 16 (32/2) and Llama-4's of 6 (48/8) at head dim
    # 128, StableLM's causal MHA (32/32) at 80: at 1,000 rows and at a
    # ragged Skv of 1,001 under 333 queries, all on the wgmma route
    (1, 1000, 1000, 32, 2, 128, True, None),
    (2, 333, 1001, 32, 2, 128, True, None),
    (1, 1000, 1000, 48, 8, 128, True, None),
    (2, 333, 1001, 48, 8, 128, True, None),
    (2, 333, 1001, 32, 32, 80, True, None),
]


def _want_route(case, dtype):
    """The route a GPU_ATTN_BWD_CASES case must take: bf16 at head dim
    64, 80 or 128 in aligned views is the wgmma route's."""
    D, offset = case[5], case[8:]
    if dtype == torch.float32:
        return "f32"
    return ("wgmma" if D in tfa.WGMMA_HEAD_DIMS and not offset
            else "mma_sync")


def _bwd_on_card(q, k, v, kw, seed=3):
    """Forward and backward through ``ops.attention`` under autograd, with
    the launch counts; returns (out, dq, dk, dv, dout)."""
    q, k, v = (x.detach().requires_grad_() for x in (q, k, v))
    before = dict(tops.LAUNCHES)
    out = tops.attention(q, k, v, **kw)
    assert out.grad_fn is not None
    gen = torch.Generator(device=q.device).manual_seed(seed)
    dout = torch.randn(out.shape, generator=gen, device=q.device).to(
        out.dtype)
    dq, dk, dv = torch.autograd.grad(out, (q, k, v), dout)
    torch.cuda.synchronize()
    assert tops.LAUNCHES["flash_attention"] == \
        before["flash_attention"] + 1
    assert tops.LAUNCHES["flash_attention_bwd"] == \
        before["flash_attention_bwd"] + 1
    return out.detach(), dq, dk, dv, dout


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", GPU_ATTN_BWD_CASES)
def test_flash_attention_bwd_kernel_matches_plain_on_card(cuda, case, dtype):
    """dq, dk, dv against ``attention_bwd_ref`` on the same inputs (f32
    math for bf16, within 2e-2 of each gradient's largest magnitude; f64
    math for f32, within 1e-4), and the forward's lse against
    ``attention_lse_ref`` (−inf on the rows that see no key); the call on
    the route ``_want_route`` names."""
    q, k, v, kw = _cuda_attn(cuda, case, dtype)
    route = _want_route(case, dtype)
    calls = tfa.BWD_ROUTE_CALLS[route]
    out, dq, dk, dv, dout = _bwd_on_card(q, k, v, kw)
    assert tfa.BWD_ROUTE_CALLS[route] == calls + 1
    assert (dq.shape, dk.shape, dv.shape) == (q.shape, k.shape, v.shape)
    assert dq.dtype == dk.dtype == dv.dtype == dtype
    rdt, tol = ((torch.float64, 1e-4) if dtype == torch.float32
                else (torch.float32, 2e-2))
    lse_ref = tref.attention_lse_ref(q, k, **kw, dtype=rdt)
    _, lse = tfa.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                                 v.transpose(1, 2), return_lse=True, **kw)
    seen = torch.isfinite(lse_ref)
    assert torch.equal(seen, torch.isfinite(lse))
    assert (lse[~seen] == float("-inf")).all()
    assert (lse[seen].double() - lse_ref[seen].double()).abs().max() <= \
        1e-4 * max(1.0, lse_ref[seen].abs().max().item())
    want = tref.attention_bwd_ref(q, k, v, out, dout, lse_ref, **kw,
                                  dtype=rdt)
    for name, got, ref_ in zip("qkv", (dq, dk, dv), want):
        err = (got.to(rdt) - ref_).abs().max().item()
        assert err <= tol * ref_.abs().max().item(), (name, err)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_bwd_two_runs_equal_to_the_bit_on_card(cuda, dtype):
    """No atomics: the backward gives the same bits every run."""
    q, k, v, kw = _cuda_attn(cuda, (2, 700, 700, 16, 4, 64, True, None),
                             dtype)
    a = _bwd_on_card(q, k, v, kw)
    b = _bwd_on_card(q, k, v, kw)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(4, 2048, 48, 64), (4, 2000, 32, 80)])
def test_flash_attention_bwd_training_shape_equal_to_the_bit_on_card(
        cuda, shape):
    """MiniCPM-2B's training call (4, 2048, 48, 64) and Zamba2-2.7B's (4,
    2000, 32, 80), bf16 causal, on the wgmma route: two runs of the
    backward give the same bits (no floating-point atomics; dQ summed in
    one block, in a fixed order)."""
    g = torch.Generator(device=cuda).manual_seed(11)
    q, k, v, dout = (torch.randn(shape, generator=g,
                                 device=cuda).bfloat16().transpose(1, 2)
                     for _ in range(4))
    o, lse = tfa.flash_attention(q, k, v, return_lse=True)
    assert tfa.bwd_route(q, k, v, o, dout) == "wgmma"
    calls = tfa.BWD_ROUTE_CALLS["wgmma"]
    a = tfa.flash_attention_bwd(q, k, v, o, lse, dout)
    b = tfa.flash_attention_bwd(q, k, v, o, lse, dout)
    torch.cuda.synchronize()
    assert tfa.BWD_ROUTE_CALLS["wgmma"] == calls + 2
    for x, y in zip(a, b):
        assert torch.equal(x, y)


# the backward kernels of topk_gating and ssm_scan: against their plain
# versions (``ref.topk_gating_bwd_ref``, ``ref.ssm_scan_bwd_ref``), two
# calls to the bit.  Gating: 1e-6 absolute (f32 sums over ≤ 128 experts
# in another order).  Scan: against the plain version in f32, 1e-4 (f32)
# or 1e-3 (bf16) of each gradient's largest value, plus for bf16 outputs
# their own rounding (2⁻⁸ of the element); the sums run over up to 1,000
# steps and 5,120 channels in another order.
GPU_GATING_BWD_CASES = [(8192, 16, 2), (4096, 16, 2), (1000, 128, 1),
                        (77, 128, 2), (33, 40, 3), (5, 8, 8), (3, 33, 32)]


@pytest.mark.gpu
@pytest.mark.parametrize("T,E,k", GPU_GATING_BWD_CASES)
def test_topk_gating_bwd_kernel_matches_plain_on_card(cuda, T, E, k):
    g = torch.Generator(device=cuda).manual_seed(T + E + k)
    logits = torch.randn((T, E), generator=g, device=cuda)
    logits[::5, 1] = logits[::5, 0]                  # ties
    logits[1::7] = 0.5
    dprobs = torch.randn((T, k), generator=g, device=cuda)
    x = logits.clone().requires_grad_()
    before = dict(tops.LAUNCHES)
    probs, idx = tops.topk_gating(x, k)
    assert probs.requires_grad and not idx.requires_grad
    got, = torch.autograd.grad(probs, x, dprobs)
    torch.cuda.synchronize()
    assert tops.LAUNCHES["topk_gating"] == before["topk_gating"] + 1
    assert tops.LAUNCHES["topk_gating_bwd"] == before["topk_gating_bwd"] + 1
    want = tref.topk_gating_bwd_ref(logits, idx, probs.detach(), dprobs)
    assert (got - want).abs().max().item() <= 1e-6
    again = tmg.topk_gating_bwd(logits, idx, probs.detach(), dprobs)
    assert torch.equal(got, again)


# the redesigned gating kernels on each route: E across the lane-group
# buckets (G = 4 at E <= 16, 8 above), k on the top-2 tree (1, 2) and on
# k passes (8, 32), T not a multiple of a block's rows (32 at E <= 16, 16
# above), a quarter of the rows bf16-rounded (exact ties), every 7th row
# of equal logits, and bases one element into a buffer (the scalar
# route); (T, E, k, offset)
GPU_GATING_ROUTE_CASES = [
    (1000 if off == 0 else 37, E, k, off)
    for E in (3, 16, 33, 128) for k in (1, 2, 8, 32) if k <= E
    for off in (0, 1)]


def _gating_logits(cuda, T, E, seed):
    g = torch.Generator().manual_seed(seed)
    logits = torch.randn((T, E), generator=g)
    logits[: T // 4] = logits[: T // 4].bfloat16().float()
    logits[1::7] = 0.5
    return logits.to(cuda)


@pytest.mark.gpu
@pytest.mark.parametrize("T,E,k,offset", GPU_GATING_ROUTE_CASES)
def test_topk_gating_routes_match_plain_on_card(cuda, T, E, k, offset):
    logits = _gating_logits(cuda, T, E, T + E + k)
    if offset:
        logits = _offset_view(logits, offset)
    way = "vector" if not offset and E % 4 == 0 else "scalar"
    assert tmg.route(logits) == way
    calls = dict(tmg.ROUTE_CALLS["topk_gating"])
    p, i = tmg.topk_gating(logits, k)
    p2, i2 = tmg.topk_gating(logits, k)
    torch.cuda.synchronize()
    assert tmg.ROUTE_CALLS["topk_gating"][way] == calls[way] + 2
    assert torch.equal(p, p2) and torch.equal(i, i2)     # no atomics
    pr, ir = tref.topk_gating_ref(logits, k)
    assert torch.equal(i, ir)
    torch.testing.assert_close(p, pr, rtol=1e-5, atol=1e-6)


@pytest.mark.gpu
@pytest.mark.parametrize("T,E,k,offset", GPU_GATING_ROUTE_CASES)
def test_topk_gating_bwd_routes_match_plain_on_card(cuda, T, E, k, offset):
    logits = _gating_logits(cuda, T, E, 3 * T + E + k)
    pr, ir = tref.topk_gating_ref(logits, k)
    dprobs = torch.randn((T, k), generator=torch.Generator().manual_seed(
        T * k)).to(cuda)
    want = tref.topk_gating_bwd_ref(logits, ir, pr, dprobs)
    if offset:
        logits, ir, pr, dprobs = (_offset_view(t, offset)
                                  for t in (logits, ir, pr, dprobs))
    way = "vector" if not offset and E % 4 == 0 else "scalar"
    assert tmg.route(logits, ir, pr, dprobs) == way
    calls = dict(tmg.ROUTE_CALLS["topk_gating_bwd"])
    got = tmg.topk_gating_bwd(logits, ir, pr, dprobs)
    again = tmg.topk_gating_bwd(logits, ir, pr, dprobs)
    torch.cuda.synchronize()
    assert tmg.ROUTE_CALLS["topk_gating_bwd"][way] == calls[way] + 2
    assert torch.equal(got, again)
    assert (got - want).abs().max().item() <= 1e-6


@pytest.mark.gpu
def test_topk_gating_bwd_takes_the_scalar_route_for_unaligned_picks(cuda):
    """Aligned logits with k = 2 picks one element into their buffers:
    the backward reads the picks as scalars, and agrees."""
    logits = _gating_logits(cuda, 999, 16, 5)
    pr, ir = tref.topk_gating_ref(logits, 2)
    dprobs = torch.randn((999, 2), generator=torch.Generator().manual_seed(
        6)).to(cuda)
    want = tref.topk_gating_bwd_ref(logits, ir, pr, dprobs)
    ir, pr, dprobs = (_offset_view(t) for t in (ir, pr, dprobs))
    assert tmg.route(logits, ir, pr, dprobs) == "scalar"
    got = tmg.topk_gating_bwd(logits, ir, pr, dprobs)
    torch.cuda.synchronize()
    assert (got - want).abs().max().item() <= 1e-6


def _pselect(cuda, tmp_path):
    """The forward built with ``-DMOE_GATING_PSELECT`` (every e divided,
    the picks taken on p) as ``fn(logits, k) -> (probs, idx)``."""
    import ctypes
    import subprocess
    from repro_torch.kernels import _build
    lib = tmp_path / "libmoe_gating_pselect.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS,
                    "-DMOE_GATING_PSELECT", "-o", str(lib),
                    str(_build.CSRC / "moe_gating.cu")], check=True,
                   capture_output=True)
    dll = ctypes.CDLL(str(lib))
    p_, i_ = ctypes.c_void_p, ctypes.c_int
    dll.topk_gating_launch.argtypes = [p_, p_, p_, i_, i_, i_, i_, p_]
    dll.topk_gating_launch.restype = i_

    def fn(x, k):
        T, E = x.shape
        probs = torch.empty((T, k), device=cuda)
        idx = torch.empty((T, k), dtype=torch.int32, device=cuda)
        assert dll.topk_gating_launch(
            x.data_ptr(), probs.data_ptr(), idx.data_ptr(), T, E, k,
            int(tmg.route(x) == "vector"),
            torch.cuda.current_stream().cuda_stream) == 0
        torch.cuda.synchronize()
        return probs, idx
    return fn


@pytest.mark.gpu
def test_topk_gating_picks_by_e_equal_picks_by_p_on_card(cuda, tmp_path):
    """The forward picks on e and divides only the picks, falling back to
    p for a warp with a near tie.  Each tie pattern of ``GATING_TIES``
    fills whole warps of its own (999 rows of it), so a warp that misses
    one takes the shortcut on it; then the patterns and random rows
    interleaved, so one near row sends its warp's other rows to p.  The
    picks equal the plain version's and, with the probabilities, a build
    that always picks on p (``-DMOE_GATING_PSELECT``) bit for bit."""
    pselect = _pselect(cuda, tmp_path)
    T = 999
    for E, k in [(16, 1), (16, 2), (128, 1), (128, 2), (33, 1), (33, 2)]:
        tensors = []
        for name, (pattern, picks) in GATING_TIES.items():
            x = _tie_rows(T, E, pattern, E + k).to(cuda)
            tensors.append((name, x, torch.tensor(
                picks[:k], dtype=torch.int32, device=cuda).expand(T, k)))
        mixed = _gating_logits(cuda, T, E, E + k)
        for j, (_, x, _) in enumerate(tensors):
            mixed[j::len(tensors) + 1] = x[j::len(tensors) + 1]
        tensors.append(("interleaved", mixed, None))
        for name, x, want in tensors:
            got = tmg.topk_gating(x, k)
            pr, ir = tref.topk_gating_ref(x, k)
            if want is not None:
                assert torch.equal(ir, want), (name, E, k)
            assert torch.equal(got[1], ir), (name, E, k)
            assert all(map(torch.equal, got, pselect(x, k))), (name, E, k)
            torch.testing.assert_close(got[0], pr, rtol=1e-5, atol=1e-6)


GPU_SSM_BWD_CASES = [  # B, S, C, N, h0, dh, dtype
    (1, 1000, 5120, 64, False, False, "bfloat16"),
    (2, 77, 70, 20, True, True, "float32"),
    (2, 16, 96, 64, True, False, "float32"),
    (3, 200, 257, 33, False, True, "bfloat16"),
    (1, 1, 32, 16, True, True, "float32"),
    (2, 40, 64, 64, True, True, "float32"),
    (1, 17, 40, 1, False, True, "float32"),
    (1, 7, 64, 64, True, True, "float32"),
    (2, 8, 70, 17, True, True, "bfloat16"),
    (1, 9, 40, 63, False, True, "float32"),
    (2, 15, 96, 1, True, False, "bfloat16"),
    (1, 24, 64, 64, True, True, "bfloat16"),
    (2, 33, 130, 63, True, True, "float32"),
    (1, 2000, 512, 64, False, False, "bfloat16"),
]


def _ssm_bwd_close(got, want, dtype, what):
    want = want.float()
    lim = (1e-4 if dtype == "float32" else 1e-3) * want.abs().max().item()
    if dtype == "bfloat16":
        lim = lim + 2.0 ** -8 * want.abs()
    err = (got.float() - want).abs()
    assert bool((err <= lim).all()), (what, err.max().item())


@pytest.mark.gpu
@pytest.mark.parametrize("strided", [False, True])
@pytest.mark.parametrize("case", GPU_SSM_BWD_CASES)
def test_ssm_scan_bwd_kernel_matches_plain_on_card(cuda, case, strided):
    B, S, C, N, with_h0, with_dh, dtype = case
    args = _cuda_ssm(cuda, B, S, C, N, with_h0, getattr(torch, dtype),
                     strided=strided)
    g = torch.Generator(device=cuda).manual_seed(S + C)
    dy = torch.randn((B, S, C), generator=g, device=cuda).to(args[0].dtype)
    dh = (torch.randn((B, C, N), generator=g, device=cuda) if with_dh
          else None)
    y, h, states = tss.ssm_scan(*args, save_states=True)
    y0, h0_ = tss.ssm_scan(*args)          # saving the states changes no bit
    assert torch.equal(y, y0) and torch.equal(h, h0_)
    got = tss.ssm_scan_bwd(*args, states, dy, dh)
    again = tss.ssm_scan_bwd(*args, states, dy, dh)
    torch.cuda.synchronize()
    for a, b in zip(got, again):
        assert (a is None and b is None) or torch.equal(a, b)
    f32 = [None if a is None else a.float() for a in args]
    want = tref.ssm_scan_bwd_ref(*f32, dy.float(), dh)
    for name, a, b in zip(["dx", "ddt", "dA", "dB", "dC", "dh0"], got, want):
        assert (a is None) == (b is None), name
        if a is not None:
            assert a.shape == b.shape and a.dtype == (
                torch.float32 if name in ("dA", "dh0") else args[0].dtype)
            _ssm_bwd_close(a, b, dtype, name)


@pytest.mark.gpu
def test_ssm_scan_bwd_runs_two_blocks_a_sm_on_card(cuda):
    """At Zamba2's N = 64 in bf16 two blocks of the backward fit an SM
    (shared memory ≤ 113 KB a block), three at N ≤ 32; f32's larger ring
    fits one at N = 64."""
    assert tss.ssm_scan_bwd_occupancy(torch.bfloat16, 64)[0] >= 2
    assert tss.ssm_scan_bwd_occupancy(torch.bfloat16, 64)[1] <= 113 * 1024
    assert tss.ssm_scan_bwd_occupancy(torch.bfloat16, 64)[1] == \
        _ssm_bwd_smem(64, 2)
    assert tss.ssm_scan_bwd_occupancy(torch.bfloat16, 17)[0] >= 3
    assert tss.ssm_scan_bwd_occupancy(torch.float32, 64)[0] >= 1


@pytest.mark.gpu
def test_ssm_scan_under_grad_launches_the_backward_on_card(cuda):
    """Through ``ops.ssm_scan`` under autograd, with dh dropped (None) and
    given: the gradients of every input equal the raw backward's."""
    args = _cuda_ssm(cuda, 2, 100, 128, 64, True, torch.float32)
    leaves = [a.clone().requires_grad_() for a in args]
    dy = torch.randn((2, 100, 128), device=cuda)
    for use_h in (False, True):
        before = dict(tops.LAUNCHES)
        y, h = tops.ssm_scan(*leaves)
        loss = (y * dy).sum() + (h.sum() if use_h else 0.0)
        grads = torch.autograd.grad(loss, leaves)
        torch.cuda.synchronize()
        assert tops.LAUNCHES["ssm_scan"] == before["ssm_scan"] + 1
        assert tops.LAUNCHES["ssm_scan_bwd"] == before["ssm_scan_bwd"] + 1
        _, _, states = tss.ssm_scan(*args, save_states=True)
        raw = tss.ssm_scan_bwd(*args, states, dy,
                               torch.ones_like(h) if use_h else None)
        for a, b in zip(grads, raw):
            assert torch.equal(a, b)


@pytest.mark.gpu
def test_backward_kernels_reject_what_they_do_not_take_on_card(cuda):
    logits = torch.randn((16, 200), device=cuda, requires_grad=True)
    with pytest.raises(ValueError, match="experts"):
        tops.topk_gating(logits, 2)
    idx = torch.zeros((16, 2), dtype=torch.int32, device=cuda)
    p = torch.zeros((16, 2), device=cuda)
    with pytest.raises(ValueError, match="experts"):
        tmg.topk_gating_bwd(logits.detach(), idx, p, p)
    with pytest.raises(ValueError, match="dprobs"):
        tmg.topk_gating_bwd(logits.detach()[:, :16].contiguous(), idx, p,
                            p.double())
    x, dt, A, Bm, Cm, h0 = _cuda_ssm(cuda, 1, 40, 16, 16, True,
                                     torch.float32)
    _, _, states = tss.ssm_scan(x, dt, A, Bm, Cm, h0, save_states=True)
    big = torch.zeros((1, 40, 65), device=cuda)
    with pytest.raises(ValueError, match="at most 64"):
        tss.ssm_scan_bwd(x, dt, A, big, big, None, states, x)
    with pytest.raises(ValueError, match="states"):
        tss.ssm_scan_bwd(x, dt, A, Bm, Cm, h0, states[1:], x)
    with pytest.raises(ValueError, match="dy"):
        tss.ssm_scan_bwd(x, dt, A, Bm, Cm, h0, states, x.bfloat16())
    with pytest.raises(ValueError, match="dh"):
        tss.ssm_scan_bwd(x, dt, A, Bm, Cm, h0, states, x, h0.mT)
    q = torch.zeros((1, 4, 2, 256), device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        tfa.flash_attention_bwd(q.transpose(1, 2), q.transpose(1, 2),
                                q.transpose(1, 2), q.transpose(1, 2),
                                torch.zeros((1, 2, 4), device=cuda),
                                q.transpose(1, 2))


# ---------------------------------------------------------------------------
# LDA's Gibbs sweep
# ---------------------------------------------------------------------------

def _repeat_words(g, P, T, V, dpw):
    """(P, T) words and docs made of runs: a word repeated 1..12 times in
    one document, a word at j and j + 2 with another between, and single
    tokens; every token's rows are the ones its neighbours change."""
    words = torch.empty((P, T), dtype=torch.int32)
    docs = torch.empty((P, T), dtype=torch.int32)
    for p in range(P):
        i = 0
        while i < T:
            v = int(torch.randint(0, V, (), generator=g))
            d = int(torch.randint(0, dpw, (), generator=g))
            kind = int(torch.randint(0, 3, (), generator=g))
            if kind == 0:
                seg = [(v, d)] * int(torch.randint(1, 13, (), generator=g))
            elif kind == 1:
                d2 = int(torch.randint(0, dpw, (), generator=g))
                seg = [(v, d), ((v + 1) % V, d if d2 % 2 else d2), (v, d)]
            else:
                seg = [(v, d)]
            for v_, d_ in seg[:T - i]:
                words[p, i], docs[p, i] = v_, d_
                i += 1
    return words, docs


def _lda_case(device, K, P=4, T=600, nb=4, Vb=12, dpw=6, seed=21,
              rotate=True, repeats=False):
    """Words, docs, z and their counts for P workers over nb vocabulary
    blocks of Vb words: worker 2 has no active token, worker 1 all its
    tokens in document 0, and one slot in nine is padding (word −1).
    ``rotate=False`` gives the data-parallel baseline's layout instead:
    one block spanning all nb·Vb words and a replica of B a worker.
    ``repeats`` draws the words as runs (``_repeat_words``) instead of
    uniformly."""
    g = torch.Generator().manual_seed(seed)
    if repeats:
        words, docs = _repeat_words(g, P, T, nb * Vb, dpw)
    else:
        words = torch.randint(0, nb * Vb, (P, T), generator=g,
                              dtype=torch.int32)
        docs = torch.randint(0, dpw, (P, T), generator=g, dtype=torch.int32)
    words[:, ::9] = -1
    words[2] = -1
    docs[1] = 0
    z = torch.randint(0, K, (P, T), generator=g, dtype=torch.int32)
    on = words >= 0
    w, k = words[on].long(), z[on].long()
    p = torch.arange(P)[:, None].expand(P, T)[on]
    B = torch.zeros((nb, Vb, K))
    B.index_put_((w // Vb, w % Vb, k), torch.ones(k.shape), accumulate=True)
    D = torch.zeros((P, dpw, K))
    D.index_put_((p, docs[on].long(), k), torch.ones(k.shape),
                 accumulate=True)
    V = nb * Vb
    if not rotate:
        B = B.reshape(1, V, K).expand(P, V, K).clone()
        nb, Vb = 1, V
    order, offsets = tlg.gibbs_index(words, Vb, nb)
    kw = dict(rotate=rotate, block_vocab=Vb, vg=V * 0.1, alpha=0.1,
              gamma=0.1, seed=17)
    t = dict(words=words, docs=docs, z=z, order=order, offsets=offsets,
             B=B, D=D, s=D.sum((0, 1)))
    return {k: v.to(device) for k, v in t.items()}, kw


def _lda_run(fn, c, phase, kw, gumbel=None, **over):
    """``fn`` on copies of the case's z, B, D (or the views ``over``
    gives, used as they are): (z, B, D, s̃)."""
    z, B, D = (over[k] if k in over else c[k].clone()
               for k in ("z", "B", "D"))
    st = fn(c["words"], c["docs"], z, c["order"], c["offsets"], B, D,
            c["s"], phase=phase, gumbel=gumbel, **kw)
    return z, B, D, st


def test_lda_gibbs_cpu_wrapper_takes_the_plain_version_and_backends_agree():
    before = dict(tlg.LAUNCHES)
    refk = build_kernels(KernelSpec(kind="reference"))
    hop = build_kernels(KernelSpec.default_for("pallas"))
    for rotate in (True, False):
        c, kw = _lda_case("cpu", 7, rotate=rotate)
        for phase in (0, 1):
            want = _lda_run(tref.lda_gibbs_ref, c, phase, kw)
            for fn in (tlg.lda_gibbs, refk.lda_gibbs, hop.lda_gibbs):
                got = _lda_run(fn, c, phase, kw)
                assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert tlg.LAUNCHES == before
    # the philox draws the plain version makes are its own helper's
    _, slots, _ = tref.gibbs_active(c["order"], c["offsets"], 1)
    g = tref.philox_gumbel(17, 1, slots, 7)
    want = _lda_run(tref.lda_gibbs_ref, c, 1, kw)
    got = _lda_run(tref.lda_gibbs_ref, c, 1, kw, gumbel=g)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def _lda_kernel_equals_plain(cuda, K, noise, repeats, **case):
    for rotate in (True, False):
        c, kw = _lda_case(cuda, K, rotate=rotate, repeats=repeats, **case)
        for phase in (0, 1, 3):
            g = None
            if noise == "explicit":
                L = int(tlg.active_counts(c["offsets"], phase).max())
                g = torch.randn((4, L, K), device=cuda)
            before = tlg.LAUNCHES["lda_gibbs"]
            got = _lda_run(tlg.lda_gibbs, c, phase, kw, g)
            torch.cuda.synchronize()
            assert tlg.LAUNCHES["lda_gibbs"] == before + 1
            want = _lda_run(tref.lda_gibbs_ref, c, phase, kw, g)
            for a, b in zip(got, want):
                assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("K", [1, 7, 33, 1000, 2049, 3000, 4500])
@pytest.mark.parametrize("noise", ["explicit", "philox"])
@pytest.mark.parametrize("repeats", [False, True])
def test_lda_gibbs_kernel_matches_plain_on_card(cuda, K, noise, repeats):
    """Equal to the bit: z, B, D and s̃, with a worker that has no active
    token and one whose tokens share one document; STRADS's rotation and
    the baseline's one block over the whole vocabulary on replicas; words
    drawn uniformly or as runs that share rows token after token.  K
    spans the kernel's ring depths (6 up to K = 2,049, more topics than
    threads; 4 at 3,000; 2 at 4,500)."""
    _lda_kernel_equals_plain(cuda, K, noise, repeats)


@pytest.mark.gpu
@pytest.mark.parametrize("noise", ["explicit", "philox"])
def test_lda_gibbs_kernel_without_a_ring_matches_plain_on_card(cuda, noise):
    """K = 16,384 (``MAX_TOPICS``): no ring slot fits, and the kernel
    reads each row at its turn; equal to the bit on a tiny corpus."""
    assert tlg.ring_depth(tlg.MAX_TOPICS, cuda) == 0
    _lda_kernel_equals_plain(cuda, tlg.MAX_TOPICS, noise, True, T=60)


@pytest.mark.gpu
def test_lda_gibbs_ring_depth_follows_the_topics_on_card(cuda):
    """The depths the tests above cover, on an H100's 227 KB a block."""
    Ks = (1, 1000, 2049, 3000, 4500, 16384)
    assert [tlg.ring_depth(K, cuda) for K in Ks] == [6, 6, 6, 4, 2, 0]
    assert [tlg.block_threads(K, cuda) for K in Ks] == [512] * 4 + [256] * 2


@pytest.mark.gpu
@pytest.mark.parametrize("K", [33, 1000])
def test_lda_gibbs_kernel_takes_unaligned_views_on_card(cuda, K):
    """B, D and the noise one element past 16-byte alignment: the ring
    takes 4-byte copies (at K = 1,000 the rows would be aligned)."""
    c, kw = _lda_case(cuda, K, repeats=K == 1000)
    L = int(tlg.active_counts(c["offsets"], 2).max())
    g = torch.randn((4, L, K), device=cuda)
    want = _lda_run(tref.lda_gibbs_ref, c, 2, kw, g)
    views = {k: _offset_view(c[k]) for k in ("B", "D")}
    assert all(v.data_ptr() % 16 for v in views.values())
    got = _lda_run(tlg.lda_gibbs, c, 2, kw, _offset_view(g), **views)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("K, repeats", [(33, False), (1000, True),
                                        (4500, True), (16384, True)])
def test_lda_gibbs_is_one_launch_and_replays_the_same_bits_on_card(
        cuda, K, repeats):
    """One kernel node a call, and a captured call replayed 3 times from
    the same state gives the eager call's bits each time, at each ring
    depth."""
    c, kw = _lda_case(cuda, K, repeats=repeats,
                      T=60 if K > 4500 else 600)
    want = _lda_run(tlg.lda_gibbs, c, 1, kw)
    z, B, D = (c[k].clone() for k in ("z", "B", "D"))

    def call():
        return tlg.lda_gibbs(c["words"], c["docs"], z, c["order"],
                             c["offsets"], B, D, c["s"], phase=1, **kw)
    call()                                   # warm, outside the capture
    torch.cuda.synchronize()
    assert _graph_kernel_nodes(call) == [0]
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        st = call()
    for _ in range(3):
        for k, t in (("z", z), ("B", B), ("D", D)):
            t.copy_(c[k])
        g.replay()
        torch.cuda.synchronize()
        for a, b in zip((z, B, D, st), want):
            assert torch.equal(a, b)


@pytest.mark.gpu
def test_lda_philox_draws_are_gumbel_on_card(cuda):
    """10⁷ of the sampler's Philox draws, made on the card: mean within
    1e-3 of Euler's γ and variance within 1e-2 of π²/6.  (The kernel's
    draws are these bits: it equals the plain version in Philox mode.)"""
    slots = torch.arange(128 * 100, device=cuda).view(128, 100)
    g = tref.philox_gumbel(17, 5, slots, 1000)
    assert abs(float(g.double().mean()) - 0.5772156649) < 1e-3
    assert abs(float(g.double().var()) - np.pi ** 2 / 6) < 1e-2


@pytest.mark.gpu
def test_lda_gibbs_rejects_what_it_does_not_take_on_card(cuda):
    c, kw = _lda_case(cuda, 7)
    args = [c[k] for k in ("words", "docs", "z", "order", "offsets", "B",
                           "D", "s")]
    with pytest.raises(TypeError, match="int32"):
        tlg.lda_gibbs(args[0].long(), *args[1:], phase=0, **kw)
    with pytest.raises(ValueError, match="contiguous"):
        tlg.lda_gibbs(*args[:6], args[6].mT.contiguous().mT, args[7],
                      phase=0, **kw)
    with pytest.raises(ValueError, match="one card"):
        tlg.lda_gibbs(*args[:7], args[7].cpu(), phase=0, **kw)
    with pytest.raises(ValueError, match="fewer than its active"):
        tlg.lda_gibbs(*args, phase=0, gumbel=torch.zeros((4, 1, 7),
                                                         device=cuda), **kw)
    K = tlg.MAX_TOPICS + 1
    with pytest.raises(ValueError, match="topics"):
        tlg.lda_gibbs(*args[:5], torch.zeros((4, 12, K), device=cuda),
                      torch.zeros((4, 6, K), device=cuda),
                      torch.zeros(K, device=cuda), phase=0, **kw)
