"""The port's schedulers against the JAX package's: with the same Gram
block and the same Gumbel draws they take the same decisions, exactly."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.sched import schedulers as js
from repro.sched import SchedulerSpec as JSpec
from repro_torch.sched import schedulers as ts
from repro_torch.sched import SchedulerSpec


def _gram(u, seed, ties=False):
    r = np.random.default_rng(seed)
    X = r.standard_normal((3 * u, u)).astype(np.float32)
    X /= np.linalg.norm(X, axis=0)
    g = X.T @ X
    if ties:
        # exact ties with ρ and between entries: |g| = ρ is a conflict
        # (the test is < ρ), and equal rows exercise the stable compaction
        g = np.round(g * 4) / 4
    return g.astype(np.float32)


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("rho,max_select", [(0.1, 4), (0.25, 8),
                                            (0.5, 32), (1.5, 5)])
def test_dependency_filter_and_compaction_match(seed, rho, max_select):
    u = 16
    g = _gram(u, seed, ties=seed % 2 == 1)
    want_keep = np.asarray(js.dependency_filter(jnp.asarray(g), rho,
                                                max_select))
    got_keep = ts.dependency_filter(torch.from_numpy(g), rho,
                                    max_select).numpy()
    np.testing.assert_array_equal(got_keep, want_keep)

    cand = np.random.default_rng(seed + 100).permutation(40)[:u]
    want_idx, want_mask = js._compact_schedule(jnp.asarray(cand),
                                               jnp.asarray(want_keep),
                                               max_select)
    got_idx, got_mask = ts._compact_schedule(torch.from_numpy(cand),
                                             torch.from_numpy(got_keep),
                                             max_select)
    np.testing.assert_array_equal(got_idx.numpy(), np.asarray(want_idx))
    np.testing.assert_array_equal(got_mask.numpy(), np.asarray(want_mask))


@pytest.mark.parametrize("seed", range(4))
def test_sample_candidates_match_given_the_same_gumbel_draw(seed):
    J, k = 50, 12
    key = jax.random.key(seed)
    w = np.random.default_rng(seed).uniform(0, 1, J).astype(np.float32)
    w[::7] = 0.0                     # below the 1e-30 floor
    want = np.asarray(js.sample_candidates(key, jnp.asarray(w), k))
    gumbel = np.array(jax.random.gumbel(key, (J,), jnp.float32))
    got = ts.sample_candidates(torch.from_numpy(gumbel),
                               torch.from_numpy(w), k).numpy()
    np.testing.assert_array_equal(got, want)


def test_sample_candidates_ties_go_to_the_lower_index():
    keys = np.array([1.0, 3.0, 3.0, 2.0, 3.0, 2.0], np.float32)
    _, want = jax.lax.top_k(jnp.asarray(keys), 4)
    got = ts.sample_candidates(torch.zeros(6), torch.from_numpy(
        np.exp(keys)).float(), 4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_dynamic_priority_carry_and_finalize_match():
    spec_kw = dict(kind="dynamic_priority", block_size=4, num_candidates=10,
                   rho=0.3, eta=1e-6)
    jsch = js.build_scheduler(JSpec(**spec_kw), num_vars=30, num_workers=1)
    tsch = ts.build_scheduler(SchedulerSpec(**spec_kw), num_vars=30,
                              num_workers=1)
    carry_j = jsch.init_carry()
    carry_t = tsch.init_carry("cpu")
    np.testing.assert_array_equal(carry_t.numpy(), np.asarray(carry_j))
    key = jax.random.key(7)
    for step in range(3):
        key, sub = jax.random.split(key)
        cand_j = jsch.propose(carry_j, sub)
        g = jax.random.gumbel(sub, (30,), jnp.float32)
        cand_t = tsch.propose(carry_t, torch.from_numpy(np.array(g)))
        np.testing.assert_array_equal(cand_t.numpy(), np.asarray(cand_j))
        gram = _gram(10, step)
        idx_j, mask_j = jsch.finalize(cand_j, jnp.asarray(gram))
        idx_t, mask_t = tsch.finalize(cand_t, torch.from_numpy(gram))
        np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))
        np.testing.assert_array_equal(mask_t.numpy(), np.asarray(mask_j))
        dx = np.random.default_rng(step).standard_normal(4).astype(
            np.float32)
        carry_j = jsch.update_carry(carry_j, idx_j, mask_j, jnp.asarray(dx))
        carry_t = tsch.update_carry(carry_t, idx_t, mask_t,
                                    torch.from_numpy(dx))
        np.testing.assert_array_equal(carry_t.numpy(), np.asarray(carry_j))


def test_round_robin_and_random_blocks():
    rr = ts.build_scheduler(SchedulerSpec(kind="round_robin", block_size=4),
                            num_vars=10, num_workers=1)
    jrr = js.build_scheduler(JSpec(kind="round_robin", block_size=4),
                             num_vars=10, num_workers=1)
    for t in range(5):
        np.testing.assert_array_equal(rr.propose(None, None, t, 0).numpy(),
                                      np.asarray(jrr(jnp.int32(t))))
    rnd = ts.build_scheduler(SchedulerSpec(kind="random", block_size=6),
                             num_vars=10, num_workers=1)
    idx = rnd.propose(None, torch.randn(10), 0, 0)
    assert idx.shape == (6,) and len(set(idx.tolist())) == 6
    with pytest.raises(ValueError, match="exceeds"):
        ts.build_scheduler(SchedulerSpec(kind="random", block_size=11),
                           num_vars=10, num_workers=1)
    assert isinstance(ts.build_scheduler(SchedulerSpec(kind="rotation"),
                                         num_vars=10, num_workers=2),
                      ts.RotationScheduler)
    # block_structural is ported with the training slice: the same
    # policy, field for field, as the JAX package builds
    spec = dict(kind="block_structural", block_size=2, min_distance=1)
    bs = ts.build_scheduler(SchedulerSpec.default_for(**spec), num_vars=10,
                            num_workers=2)
    jbs = js.build_scheduler(JSpec.default_for(**spec), num_vars=10,
                             num_workers=2)
    assert isinstance(bs, ts.BlockStructuralScheduler)
    assert dataclasses.asdict(bs) == dataclasses.asdict(jbs)


def _ppermute(x: np.ndarray, pairs: list) -> np.ndarray:
    """What ``lax.ppermute`` does to a leading device axis."""
    out = np.zeros_like(x)
    for src, dst in pairs:
        out[dst] = x[src]
    return out


@pytest.mark.parametrize("U", [1, 3, 4, 7])
@pytest.mark.parametrize("J", [53, 10, 4 * 7 * 3])
def test_rotation_scheduler_matches(U, J):
    """The same bounds, blocks and permutations as the JAX class, for a
    J that U divides and ones it does not (10 over 4 puts edges on
    exact halves: both round them to even)."""
    jsch = js.build_scheduler(JSpec(kind="rotation"), num_vars=J,
                              num_workers=U)
    tsch = ts.build_scheduler(SchedulerSpec(kind="rotation"), num_vars=J,
                              num_workers=U)
    assert tsch.needs_noise is False
    np.testing.assert_array_equal(tsch.bounds.numpy(),
                                  np.asarray(jsch.bounds))
    assert tsch.bounds.dtype == torch.int32
    x = np.arange(U * 5).reshape(U, 5)
    for t in range(2 * U + 1):
        for p in range(U):
            assert tsch.block_for_worker(p, t) == int(
                jsch.block_for_worker(jnp.int32(p), jnp.int32(t)))
            assert torch.equal(tsch.block_for_worker(torch.tensor(p), t),
                               torch.tensor(int(jsch.block_for_worker(p, t))))
        phase = t % U
        np.testing.assert_array_equal(
            x[tsch.forward_perm(phase).numpy()],
            _ppermute(x, jsch.forward_perm(phase)))
        np.testing.assert_array_equal(
            x[tsch.backward_perm(phase).numpy()],
            _ppermute(x, jsch.backward_perm(phase)))
        fwd = x[tsch.forward_perm(phase).numpy()]
        back = tsch.backward_perm(phase).numpy()
        np.testing.assert_array_equal(fwd[back], x)
    for u in range(U):
        np.testing.assert_array_equal(tsch.block_mask(u).numpy(),
                                      np.asarray(jsch.block_mask(u)))
    assert tsch.propose(None, None, 0, 0) is None
