"""The port's STRADS LDA against the JAX package's.

The JAX package draws its Gibbs noise from ``fold_in(fold_in(key(17),
phase), p)`` (the baseline ``fold_in(key(23), p)``), split once per token
slot, and ``jax.random.categorical`` is exactly the argmax of
``gumbel(sub, (K,))`` + logits.  These tests compute those draws with JAX
and feed them to the port, which then takes the same decisions: z and the
counts D, B, s are equal to the bit (integers in f32), the s-error too;
log-likelihoods agree within 1e-5 relative (lgamma and f32 sums in a
different order).  Multi-worker runs are held against ``_gibbs_scan``
driven per (worker, phase) in this process, with the rotation as
indexing, so no forced devices are needed.
"""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.apps import lda as jlda
from repro.core import ExecutionPlan as JPlan
from repro.core import single_device_mesh
from repro_torch import convert
from repro_torch.apps import lda
from repro_torch.core import ExecutionPlan
from repro_torch.kernels import lda_gibbs as lg
from repro_torch.kernels import ref as tref
from repro_torch.sched import SchedulerSpec, build_scheduler

RTOL = 1e-5
CFG1 = dict(vocab=50, num_topics=6, num_workers=1, tokens_per_worker=600,
            docs_per_worker=15)
CFG4 = dict(vocab=53, num_topics=7, num_workers=4, tokens_per_worker=240,
            docs_per_worker=5)
_scan = jax.jit(jlda._gibbs_scan, static_argnums=0)


def _corpus(cfg_kw, seed=0, true_topics=6):
    return jlda.synthetic_corpus(np.random.default_rng(seed),
                                 jlda.LDAConfig(**cfg_kw),
                                 true_topics=true_topics)


def _repeat_corpus(cfg_kw, seed=0):
    """A corpus of runs: a word repeated 1..12 times in one document, a
    word at j and j + 2 with another word between (in the same document
    or another), and single tokens, laid out as ``_corpus``'s shards.
    Consecutive tokens share their word or their document far more often
    than in the planted corpus."""
    rng = np.random.default_rng(seed)
    U, T = cfg_kw["num_workers"], cfg_kw["tokens_per_worker"]
    V, dpw, K = (cfg_kw["vocab"], cfg_kw["docs_per_worker"],
                 cfg_kw["num_topics"])
    words, docs = np.empty(U * T, np.int32), np.empty(U * T, np.int32)
    for u in range(U):
        i = u * T
        while i < (u + 1) * T:
            v, d = int(rng.integers(V)), int(rng.integers(dpw))
            kind = int(rng.integers(3))
            if kind == 0:                       # a run in one document
                seg = [(v, d)] * int(rng.integers(1, 13))
            elif kind == 1:                     # v, other, v
                d2 = d if rng.integers(2) else int(rng.integers(dpw))
                seg = [(v, d), ((v + 1) % V, d2), (v, d)]
            else:
                seg = [(v, d)]
            for v_, d_ in seg[:(u + 1) * T - i]:
                words[i], docs[i] = v_, d_
                i += 1
    return words, docs, rng.integers(0, K, size=U * T).astype(np.int32)


def slot_draws(key, T: int, K: int) -> np.ndarray:
    """The (T, K) Gumbel draws ``_gibbs_scan`` makes from ``key``: one
    split per slot, ``categorical``'s ``gumbel(sub, (K,))``."""
    def body(k, _):
        k, sub = jax.random.split(k)
        return k, jax.random.gumbel(sub, (K,), jnp.float32)
    return np.asarray(jax.lax.scan(body, key, None, length=T)[1])


def jax_noise(cfg_kw, base: int = 17, phased: bool = True):
    """``noise(phase)`` → (U, T_p, K): the JAX sampler's draws."""
    U, T, K = (cfg_kw["num_workers"], cfg_kw["tokens_per_worker"],
               cfg_kw["num_topics"])
    cache = {}

    def noise(phase):
        if phase not in cache:
            root = jax.random.key(base)
            if phased:
                root = jax.random.fold_in(root, phase)
            cache[phase] = np.stack([slot_draws(
                jax.random.fold_in(root, p), T, K) for p in range(U)])
        return cache[phase]
    return noise


def jax_driver(cfg_kw, words, docs, z0, rounds, state=None, t0=0,
               staleness=0):
    """The JAX package's push/pull semantics, ``_gibbs_scan`` driven per
    (worker, phase) in process: worker p samples block (p + t) % U of the
    home-ordered B, s is the sum of the blocks' column sums, and the
    s-error (1/UM) Σ_p ‖s̃_p − s‖₁.  Numpy state in the JAX layout.
    Under ``staleness`` s every sweep of a window of s + 1 rounds (the
    windows start at ``t0``) reads the window-start s, as the JAX SSP's
    pushes read s from their cache; z, D and B commit through."""
    cfg = jlda.LDAConfig(**cfg_kw)
    U, T, dpw, Vb = (cfg.num_workers, cfg.tokens_per_worker,
                     cfg.docs_per_worker, cfg.block_vocab)
    st = state or {k: np.array(v) for k, v in
                   jlda.build_state(cfg, words, docs, z0).items()}
    st = {k: np.array(v) for k, v in st.items()}
    errs = []
    for t in range(t0, t0 + rounds):
        phase = t % U
        if (t - t0) % (staleness + 1) == 0:
            s_read = st["s"].copy()             # the window's snapshot
        tildes = []
        for p in range(U):
            blk = (p + phase) % U
            rows, sl = slice(blk * Vb, (blk + 1) * Vb), slice(p * T,
                                                             (p + 1) * T)
            w = words[sl]
            key = jax.random.fold_in(jax.random.fold_in(jax.random.key(17),
                                                        phase), p)
            B, D, s_t, z = _scan(
                cfg, jnp.asarray(st["B"][rows]),
                jnp.asarray(st["D"][p * dpw:(p + 1) * dpw]),
                jnp.asarray(s_read), jnp.asarray(w), jnp.asarray(docs[sl]),
                jnp.asarray(st["z"][sl]),
                jnp.asarray((w >= 0) & (w // Vb == blk)), blk * Vb, key)
            st["B"][rows], st["z"][sl] = np.asarray(B), np.asarray(z)
            st["D"][p * dpw:(p + 1) * dpw] = np.asarray(D)
            tildes.append(np.asarray(s_t))
        st["s"] = st["B"].sum(0).astype(np.float32)
        err = np.float32(np.abs(np.stack(tildes) - st["s"]).sum())
        st["s_err"] = np.float32(err / np.float32(U * U * T))
        errs.append(st["s_err"])
    return st, errs


def test_synthetic_corpus_is_the_same_corpus():
    want = _corpus(CFG4)
    got = lda.synthetic_corpus(np.random.default_rng(0),
                               lda.LDAConfig(**CFG4), true_topics=6)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("cfg_kw", [CFG1, CFG4])
def test_build_state_and_loglik_match(cfg_kw):
    words, docs, z0 = _corpus(cfg_kw)
    cfg = jlda.LDAConfig(**cfg_kw)
    want = jlda.build_state(cfg, words, docs, z0)
    got = lda.build_state(lda.LDAConfig(**cfg_kw), words, docs, z0,
                          device="cpu")
    for k in ("z", "D", "B", "s", "s_err"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    np.testing.assert_allclose(
        float(lda.log_likelihood(lda.LDAConfig(**cfg_kw), got)),
        float(jlda._global_loglik(cfg, want)), rtol=RTOL)


@pytest.mark.parametrize("K", [1, 6, 33])
@pytest.mark.parametrize("phase", [0, 2])
@pytest.mark.parametrize("corpus", ["planted", "repeats"])
def test_one_worker_sweep_equals_jax_gibbs_scan(K, phase, corpus):
    """Worker p = 1 of U = 3 samples block (1 + phase) % 3 of a corpus
    where the other blocks' tokens are inactive; z, the block of B, D and
    s̃ equal the JAX scan's, fed its own draws.  ``repeats`` is a corpus
    of runs of one word in one document (some longer than 8) and of a
    word at j and j + 2 but not j + 1, where each token changes the rows
    the next ones read."""
    cfg_kw = dict(vocab=50, num_topics=K, num_workers=3,
                  tokens_per_worker=500, docs_per_worker=9)
    cfg = jlda.LDAConfig(**cfg_kw)
    words, docs, z0 = (_corpus(cfg_kw) if corpus == "planted"
                       else _repeat_corpus(cfg_kw))
    st = jlda.build_state(cfg, words, docs, z0)
    U, T, dpw, Vb, p = 3, 500, 9, cfg.block_vocab, 1
    blk = (p + phase) % U
    sl = slice(p * T, (p + 1) * T)
    w = words[sl]
    key = jax.random.fold_in(jax.random.fold_in(jax.random.key(17), phase),
                             p)
    jB, jD, js, jz = _scan(
        cfg, st["B"][blk * Vb:(blk + 1) * Vb], st["D"][p * dpw:(p + 1) * dpw],
        st["s"], jnp.asarray(w), jnp.asarray(docs[sl]),
        jnp.asarray(z0[sl]), jnp.asarray((w >= 0) & (w // Vb == blk)),
        blk * Vb, key)
    # the port's kernel wrapper for the one worker (P = 1, its block as
    # the phase), on the JAX draws of its active slots
    wt, dt = torch.tensor(w[None]), torch.tensor(docs[sl][None])
    zt = torch.tensor(z0[sl][None])
    order, offsets = lg.gibbs_index(wt, Vb, U)
    _, slots, counts = tref.gibbs_active(order, offsets, blk)
    assert 0 < int(counts[0]) < T
    g = torch.tensor(slot_draws(key, T, K))[slots[0]][None]
    B = torch.tensor(np.asarray(st["B"])).view(U, Vb, K)
    D = torch.tensor(np.asarray(st["D"])[p * dpw:(p + 1) * dpw][None])
    before = dict(lg.LAUNCHES)
    s_t = lg.lda_gibbs(wt, dt, zt, order, offsets, B, D,
                       torch.tensor(np.asarray(st["s"])), phase=blk,
                       rotate=True, block_vocab=Vb,
                       vg=cfg.padded_vocab * cfg.gamma, alpha=cfg.alpha,
                       gamma=cfg.gamma, gumbel=g)
    assert lg.LAUNCHES == before            # the CPU takes the plain version
    np.testing.assert_array_equal(zt[0].numpy(), np.asarray(jz))
    np.testing.assert_array_equal(B[blk].numpy(), np.asarray(jB))
    np.testing.assert_array_equal(D[0].numpy(), np.asarray(jD))
    np.testing.assert_array_equal(s_t[0].numpy(), np.asarray(js))


def _every_slot_sweep(cfg, B, D, s, words, docs, z, active, block_start, g):
    """``_gibbs_scan`` transliterated into torch: every slot, with the
    inactive ones as the reference's no-ops (a = 0, znew = zi)."""
    st = s.clone()
    z = z.clone()
    for i in range(words.shape[0]):
        a = float(active[i])
        v = int((words[i] - block_start).clamp(0, cfg.block_vocab - 1))
        d, zi = int(docs[i]), int(z[i])
        B[v, zi] += -a
        D[d, zi] += -a
        st[zi] += -a
        logits = (torch.log(cfg.gamma + B[v])
                  - torch.log(cfg.padded_vocab * cfg.gamma + st)
                  + torch.log(cfg.alpha + D[d]))
        zn = int(torch.argmax(g[i] + logits)) if active[i] else zi
        B[v, zn] += a
        D[d, zn] += a
        st[zn] += a
        z[i] = zn
    return st, z


@pytest.mark.parametrize("seed", [0, 1])
def test_skipping_inactive_slots_changes_no_bit(seed):
    cfg_kw = dict(vocab=40, num_topics=5, num_workers=4,
                  tokens_per_worker=300, docs_per_worker=6)
    cfg = lda.LDAConfig(**cfg_kw)
    words, docs, z0 = _corpus(cfg_kw, seed=seed)
    words[::7] = -1                          # padding slots too
    st = lda.build_state(cfg, words, docs, z0, device="cpu")
    U, T, K, Vb, phase = 4, 300, 5, cfg.block_vocab, 1
    W = torch.tensor(words).view(U, T)
    Dc = torch.tensor(docs).view(U, T)
    g = torch.from_numpy(np.random.default_rng(seed).gumbel(
        size=(U, T, K)).astype(np.float32))
    order, offsets = lg.gibbs_index(W, Vb, U)
    _, slots, _ = tref.gibbs_active(order, offsets, phase)
    B = st["B"].view(U, Vb, K).clone()
    D = st["D"].view(U, -1, K).clone()
    z = st["z"].view(U, T).clone()
    s_t = tref.lda_gibbs_ref(W, Dc, z, order, offsets, B, D, st["s"],
                             phase=phase, rotate=True, block_vocab=Vb,
                             vg=cfg.padded_vocab * cfg.gamma,
                             alpha=cfg.alpha, gamma=cfg.gamma,
                             gumbel=g[torch.arange(U)[:, None], slots])
    for p in range(U):
        blk = (p + phase) % U
        Bw = st["B"].view(U, Vb, K)[blk].clone()
        Dw = st["D"].view(U, -1, K)[p].clone()
        active = (W[p] >= 0) & (W[p] // Vb == blk)
        want_s, want_z = _every_slot_sweep(cfg, Bw, Dw, st["s"], W[p],
                                           Dc[p], st["z"].view(U, T)[p],
                                           active, blk * Vb, g[p])
        assert torch.equal(z[p], want_z)
        assert torch.equal(B[blk], Bw)
        assert torch.equal(D[p], Dw)
        assert torch.equal(s_t[p], want_s)


def test_one_worker_fit_matches_jax_fit():
    words, docs, z0 = _corpus(CFG1)
    R = 5
    jst, jtrace, jerrs = jlda.fit(jlda.LDAConfig(**CFG1), words, docs, z0,
                                  single_device_mesh(), num_rounds=R,
                                  trace_every=1)
    st, trace, errs = lda.fit(lda.LDAConfig(**CFG1), words, docs, z0,
                              num_rounds=R, trace_every=1, device="cpu",
                              noise=jax_noise(CFG1))
    for k in ("z", "D", "B", "s"):
        np.testing.assert_array_equal(st[k].numpy(), np.asarray(jst[k]))
    np.testing.assert_allclose([v for _, v in trace],
                               [v for _, v in jtrace], rtol=RTOL)
    assert errs == jerrs and all(v == 0.0 for _, v in errs)


@pytest.mark.parametrize("executor", ["loop", "scan"])
def test_four_workers_match_the_jax_sweeps_with_the_rotation(executor):
    words, docs, z0 = _corpus(CFG4)
    R = 2 * CFG4["num_workers"]
    want, werrs = jax_driver(CFG4, words, docs, z0, R)
    plan = ExecutionPlan(executor=executor, rounds=R, collect_every=1)
    st, trace, errs = lda.fit(lda.LDAConfig(**CFG4), words, docs, z0,
                              plan=plan, device="cpu",
                              noise=jax_noise(CFG4))
    for k in ("z", "D", "B", "s"):
        np.testing.assert_array_equal(st[k].numpy(), want[k])
    assert [v for _, v in errs] == [float(e) for e in werrs]
    assert max(v for _, v in errs) > 0       # stale s̃ across workers


def test_baseline_matches_jax_at_one_worker():
    words, docs, z0 = _corpus(CFG1)
    R = 3
    jst, jtrace, _ = jlda.fit(jlda.LDAConfig(**CFG1), words, docs, z0,
                              single_device_mesh(), num_rounds=R,
                              baseline=True, trace_every=1)
    st, trace, errs = lda.fit(lda.LDAConfig(**CFG1), words, docs, z0,
                              num_rounds=R, baseline=True, trace_every=1,
                              device="cpu",
                              noise=jax_noise(CFG1, base=23, phased=False))
    for k in ("z", "D", "B", "s"):
        np.testing.assert_array_equal(st[k].numpy(), np.asarray(jst[k]))
    np.testing.assert_allclose([v for _, v in trace],
                               [v for _, v in jtrace], rtol=RTOL)
    assert errs == []


def test_jax_run_converted_mid_way_continues_identically():
    words, docs, z0 = _corpus(CFG1)
    R1, R = 2, 5
    cfg = jlda.LDAConfig(**CFG1)
    jeng = jlda.make_engine(cfg, single_device_mesh())
    jdata = jeng.shard_data({"words": jnp.asarray(words),
                             "docs": jnp.asarray(docs)})
    init = jeng.init_state(jax.random.key(0), words=words, docs=docs, z0=z0)
    whole = jeng.execute(init, jdata, jax.random.key(0),
                         JPlan(executor="loop", rounds=R))
    half = jeng.execute(init, jdata, jax.random.key(0),
                        JPlan(executor="loop", rounds=R1))
    state, data, carry = convert.lda_from_jax(
        {k: np.asarray(v) for k, v in half.state.items()}, words, docs,
        t=int(half.carry.t), device="cpu")
    eng = lda.make_engine(lda.LDAConfig(**CFG1), device="cpu",
                          noise=jax_noise(CFG1))
    rep = eng.execute(state, data, None, ExecutionPlan(executor="loop",
                                                       rounds=R),
                      carry=carry)
    got = eng.unshard(rep.state)
    for k in ("z", "D", "B", "s", "s_err"):
        np.testing.assert_array_equal(got[k].numpy(),
                                      np.asarray(whole.state[k]))


def test_converted_four_worker_run_continues_identically():
    words, docs, z0 = _corpus(CFG4)
    U = CFG4["num_workers"]
    half, _ = jax_driver(CFG4, words, docs, z0, U)
    want, _ = jax_driver(CFG4, words, docs, z0, U, state=half, t0=U)
    state, data, carry = convert.lda_from_jax(half, words, docs, t=U,
                                              workers=U, device="cpu")
    assert state["B"].shape == (U, lda.LDAConfig(**CFG4).block_vocab, 7)
    eng = lda.make_engine(lda.LDAConfig(**CFG4), device="cpu",
                          noise=jax_noise(CFG4))
    rep = eng.execute(state, data, None,
                      ExecutionPlan(executor="scan", rounds=2 * U),
                      carry=carry)
    got = eng.unshard(rep.state)
    for k in ("z", "D", "B", "s", "s_err"):
        np.testing.assert_array_equal(got[k].numpy(), want[k])


def test_port_loop_equals_port_scan_bit_exactly():
    words, docs, z0 = _corpus(CFG4)
    out = {ex: lda.fit(lda.LDAConfig(**CFG4), words, docs, z0,
                       plan=ExecutionPlan(executor=ex, rounds=6,
                                          collect_every=1), device="cpu")
           for ex in ("loop", "scan")}
    for k in ("z", "D", "B", "s", "s_err"):
        assert torch.equal(out["loop"][0][k], out["scan"][0][k])
    assert out["loop"][1:] == out["scan"][1:]


def test_scan_starts_on_a_rotation_boundary():
    words, docs, z0 = _corpus(CFG4)
    eng = lda.make_engine(lda.LDAConfig(**CFG4), device="cpu")
    data = eng.shard_data({"words": words, "docs": docs})
    state = eng.init_state(words=words, docs=docs, z0=z0)
    rep = eng.execute(state, data, None, ExecutionPlan(executor="loop",
                                                       rounds=2))
    msg = ("t0 must be a multiple of the phase period (4) so phases stay "
           "static; got 2")
    with pytest.raises(ValueError, match=re.escape(msg)):
        eng.execute(rep.state, data, None,
                    ExecutionPlan(executor="scan", rounds=8),
                    carry=rep.carry)
    assert eng.phase_period == 4


# -- the properties of tests/test_lda.py, on the port's own draws -------------

@pytest.fixture(scope="module")
def run1():
    cfg_kw = dict(CFG1, tokens_per_worker=1200)
    words, docs, z0 = _corpus(cfg_kw)
    cfg = lda.LDAConfig(**cfg_kw)
    st, trace, errs = lda.fit(cfg, words, docs, z0, num_rounds=8,
                              trace_every=1, device="cpu")
    return cfg, words, st, trace, errs


def test_likelihood_increases(run1):
    _, _, _, trace, _ = run1
    assert trace[-1][1] > trace[0][1] + 100    # clear ascent


def test_count_conservation(run1):
    cfg, words, st, _, _ = run1
    n_tok = int((words >= 0).sum())
    assert float(st["B"].sum()) == n_tok
    assert float(st["D"].sum()) == n_tok
    assert torch.equal(st["s"], st["B"].sum(0))
    assert bool((st["B"] >= 0).all()) and bool((st["D"] >= 0).all())


def test_single_worker_zero_s_error(run1):
    _, _, _, _, errs = run1
    assert len(errs) == 8 and all(v == 0.0 for _, v in errs)


def test_assignments_in_range(run1):
    cfg, _, st, _, _ = run1
    z = st["z"].numpy()
    assert ((0 <= z) & (z < cfg.num_topics)).all()


def test_baseline_runs_and_improves():
    words, docs, z0 = _corpus(CFG4)
    _, trace, _ = lda.fit(lda.LDAConfig(**CFG4), words, docs, z0,
                          num_rounds=4, baseline=True, trace_every=1,
                          device="cpu")
    assert trace[-1][1] > trace[0][1]


def test_block_partition_covers_vocab():
    cfg = lda.LDAConfig(vocab=53, num_topics=4, num_workers=4,
                        tokens_per_worker=10, docs_per_worker=2)
    assert cfg.padded_vocab >= cfg.vocab
    assert cfg.padded_vocab == cfg.block_vocab * cfg.num_workers
    blocks = np.arange(cfg.vocab) // cfg.block_vocab
    assert blocks.max() < cfg.num_workers
    sched = build_scheduler(SchedulerSpec(kind="rotation"),
                            num_vars=cfg.padded_vocab, num_workers=4)
    np.testing.assert_array_equal(
        sched.bounds.numpy(), np.arange(5) * cfg.block_vocab)


def test_gibbs_index_lists_each_block_in_slot_order():
    words = torch.tensor([[5, -1, 0, 9, 3, 5, -1, 8],
                          [-1, -1, -1, -1, 1, 1, 1, 1]], dtype=torch.int32)
    order, offsets = lg.gibbs_index(words, 4, 3)
    assert order.dtype == offsets.dtype == torch.int32
    np.testing.assert_array_equal(offsets.numpy(),
                                  [[0, 2, 4, 6], [0, 4, 4, 4]])
    np.testing.assert_array_equal(order[0, :6].numpy(), [2, 4, 0, 5, 3, 7])
    np.testing.assert_array_equal(order[1, :4].numpy(), [4, 5, 6, 7])
    np.testing.assert_array_equal(lg.active_counts(offsets, 2).numpy(),
                                  [2, 4])
    np.testing.assert_array_equal(lg.active_counts(offsets, 0).numpy(),
                                  [2, 0])


def test_philox_matches_the_random123_answers_and_draws_gumbel():
    zero = torch.zeros(1, dtype=torch.int64)
    full = torch.full((1,), 0xFFFFFFFF, dtype=torch.int64)
    pi = [torch.tensor([x]) for x in (0x243F6A88, 0x85A308D3, 0x13198A2E,
                                      0x03707344)]
    for ctr, key, want in (
            ((zero,) * 4, 0, (0x6627E8D5, 0xE169C58D, 0xBC57AC4C,
                              0x9B00DBD8)),
            ((full,) * 4, 2 ** 64 - 1, (0x408F276D, 0x41C83B0E, 0xA20BC7C6,
                                        0x6D5451FD)),
            (pi, (0x299F31D0 << 32) | 0xA4093822,
             (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1))):
        assert [int(w) for w in tref.philox4x32(ctr, key)] == list(want)
    g = tref.philox_gumbel(17, 3, torch.arange(4000).view(4, 1000), 250)
    assert g.shape == (4, 1000, 250) and bool(torch.isfinite(g).all())
    assert abs(float(g.double().mean()) - 0.5772156649) < 5e-3
    assert abs(float(g.double().var()) - np.pi ** 2 / 6) < 2e-2
    again = tref.philox_gumbel(17, 3, torch.arange(4000).view(4, 1000), 250)
    assert torch.equal(g, again)
    other = tref.philox_gumbel(17, 4, torch.arange(4000).view(4, 1000), 250)
    assert not torch.equal(g, other)


def _mean_field(cfg, B, s, words, iters=8):
    """The fold-in of ``StradsLDA.query`` in float64 numpy."""
    v = np.clip(words, 0, cfg.padded_vocab - 1)
    act = (words >= 0)[..., None]
    phi = (cfg.gamma + B[v]) / (cfg.padded_vocab * cfg.gamma + s)
    phi = np.where(act, phi, 1.0)
    theta = np.full((words.shape[0], cfg.num_topics), 1.0 / cfg.num_topics)
    for _ in range(iters):
        q = phi * theta[:, None, :]
        q = q / np.maximum(q.sum(-1, keepdims=True), 1e-30)
        q = np.where(act, q, 0.0)
        theta = cfg.alpha + q.sum(1)
        theta = theta / theta.sum(-1, keepdims=True)
    return theta


def test_query_matches_a_numpy_mean_field_oracle():
    words, docs, z0 = _corpus(CFG4)
    cfg = lda.LDAConfig(**CFG4)
    eng = lda.make_engine(cfg, device="cpu")
    state = eng.run(eng.init_state(words=words, docs=docs, z0=z0),
                    eng.shard_data({"words": words, "docs": docs}), None, 4)
    batch = np.random.default_rng(2).integers(0, cfg.vocab, size=(5, 9))
    batch[1, 4:] = -1
    batch[3, :] = -1
    out = eng.app.query(state, {"words": batch})
    want = _mean_field(cfg, eng.unshard(state)["B"].double().numpy(),
                       state["s"].double().numpy(), batch)
    np.testing.assert_allclose(out["theta"].numpy(), want, rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_array_equal(out["top_topic"].numpy(),
                                  want.argmax(-1))


def test_ingest_keeps_the_collapsed_counts_exact():
    """The recount of tests/test_stream.py:335-340 after swapping slots
    (new tokens, a deleted one, and one into a padding slot)."""
    words, docs, z0 = _corpus(CFG4)
    words[5] = -1
    cfg = lda.LDAConfig(**CFG4)
    U, T, dpw, K = 4, 240, 5, 7
    eng = lda.make_engine(cfg, device="cpu")
    data = eng.shard_data({"words": words, "docs": docs})
    state = eng.run(eng.init_state(words=words, docs=docs, z0=z0), data,
                    None, 3)
    before = {k: v.clone() for k, v in state.items()}
    rows = np.array([5, 17, 300, 959])
    delta = {"data": {"words": np.array([3, -1, 52, 0], np.int32),
                      "docs": np.array([1, 0, 4, 2], np.int32)},
             "z": np.array([6, 0, 2, 5], np.int32)}
    version = data["words"]._version
    new_data, new_state = eng.app.ingest(data, state, rows, delta)
    # written in place: the same tensors, the words' version bumped (so
    # the sweep's token index is rebuilt), other slots untouched
    for k in state:
        assert new_state[k] is state[k]
    assert new_data["words"] is data["words"]
    assert data["words"]._version > version
    keep = np.setdiff1d(np.arange(U * T), rows)
    assert torch.equal(new_state["z"].reshape(-1)[keep],
                       before["z"].reshape(-1)[keep])
    w = new_data["words"].reshape(-1).numpy()
    d = new_data["docs"].reshape(-1).numpy()
    flat = eng.unshard(new_state)
    z = flat["z"].numpy()
    B = np.zeros((cfg.padded_vocab, K), np.float32)
    D = np.zeros((U * dpw, K), np.float32)
    s = np.zeros((K,), np.float32)
    act = w >= 0
    u = np.arange(U * T) // T
    np.add.at(B, (w[act], z[act]), 1)
    np.add.at(D, (u[act] * dpw + d[act], z[act]), 1)
    np.add.at(s, z[act], 1)
    np.testing.assert_array_equal(flat["B"].numpy(), B)
    np.testing.assert_array_equal(flat["D"].numpy(), D)
    np.testing.assert_array_equal(flat["s"].numpy(), s)
    assert eng.app.ingest_specs()["valid"](new_data).sum() == act.sum()
    with pytest.raises(ValueError, match="ingested words"):
        eng.app.ingest(data, state, rows[:1], {"data": {
            "words": np.array([cfg.vocab]), "docs": np.array([0])},
            "z": np.array([0])})


def test_device_corpus_follows_the_recipe():
    cfg = lda.LDAConfig(vocab=300, num_topics=5, num_workers=3,
                        tokens_per_worker=4000, docs_per_worker=7)
    words, docs, z0 = lda.synthetic_corpus_device(3, cfg, device="cpu",
                                                  chunk=5000)
    n = 3 * 4000
    assert words.shape == docs.shape == z0.shape == (n,)
    assert words.dtype == torch.int32
    assert 0 <= int(words.min()) and int(words.max()) < cfg.vocab
    assert 0 <= int(docs.min()) and int(docs.max()) < cfg.docs_per_worker
    assert 0 <= int(z0.min()) and int(z0.max()) < cfg.num_topics
    # ten sparse planted topics: a few words carry most of the tokens
    counts = torch.bincount(words.long(), minlength=cfg.vocab).sort(
        descending=True).values
    assert int(counts[:60].sum()) > 0.5 * n
    again = lda.synthetic_corpus_device(3, cfg, device="cpu", chunk=5000)
    assert all(torch.equal(a, b) for a, b in zip((words, docs, z0), again))


def test_entry_points_default_to_the_card():
    words, docs, z0 = _corpus(CFG1)
    cfg = lda.LDAConfig(**CFG1)
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lda.build_state(cfg, words, docs, z0)
    for baseline in (False, True):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            lda.make_engine(cfg, baseline=baseline)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            lda.fit(cfg, words, docs, z0, num_rounds=1, baseline=baseline)
