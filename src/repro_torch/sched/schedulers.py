"""Schedulers of the STRADS apps, ported from the JAX package's
``sched/schedulers.py``:

* :class:`RoundRobinScheduler` — fixed cyclic blocks (Lasso-cyclic).
* :class:`RandomScheduler` — uniform random blocks (the Lasso-RR
  baseline): the top U of the round's Gumbel noise, which is a uniform
  draw without replacement.
* :class:`RotationScheduler` — word rotation over U disjoint blocks
  (STRADS LDA): worker p owns block ``(p + t) mod U`` at round t.
* :class:`DynamicPriorityScheduler` — the STRADS Lasso strategy: sample
  U′ candidates with probability ∝ |Δβ| + η by Gumbel top-k, then
  greedily keep at most U whose pairwise |x_jᵀx_k| is below ρ.
* :class:`BlockStructuralScheduler` — the same two steps over the layer
  blocks of a deep net, with the 0/1 :func:`structural_gram` (graph
  distance) in place of the data Gram block.

Shapes are static (U′ candidates, U-wide masked schedules), and nothing
here syncs with the host: the ρ-filter is written with tensor ops only.
"""
from __future__ import annotations

import dataclasses

import torch

from .protocol import SchedulerBase
from .spec import SchedulerSpec


@dataclasses.dataclass(frozen=True)
class RoundRobinScheduler(SchedulerBase):
    """Round t schedules indices ``[t*U, ..., (t+1)*U) mod J``."""
    num_vars: int
    block_size: int

    needs_noise = False

    def propose(self, carry, noise, t, phase, device=None):
        start = (t * self.block_size) % self.num_vars
        return (start + torch.arange(self.block_size, device=device)) \
            % self.num_vars


@dataclasses.dataclass(frozen=True)
class RandomScheduler(SchedulerBase):
    """Uniform random block of U distinct indices."""
    num_vars: int
    block_size: int

    def propose(self, carry, noise, t, phase, device=None):
        return sample_candidates(noise, torch.ones_like(noise),
                                 self.block_size)


@dataclasses.dataclass(frozen=True)
class RotationScheduler(SchedulerBase):
    """Word rotation over U disjoint variable blocks (STRADS LDA).

    Block u is ``[bounds[u], bounds[u+1])``; worker p works on block
    ``block_for_worker(p, t) = (p + t) mod U`` at round t, so every
    worker visits every block once per U rounds and concurrent workers
    never share a block.  The JAX package moves the blocks between
    devices with two static ``ppermute`` calls; here the workers are a
    tensor axis, so the rotation is indexing: :meth:`forward_perm` and
    :meth:`backward_perm` are index maps over that axis, and on one
    device nothing moves (LDA reads block ``block_for_worker(p, t)`` of
    the home-ordered table in place)."""
    num_vars: int
    num_workers: int

    needs_noise = False

    @property
    def bounds(self) -> torch.Tensor:
        """(U+1,) int32 block edges: ``jnp.linspace(0, J, U+1)`` in f32,
        rounded half to even, as in the JAX package."""
        U = self.num_workers
        step = torch.arange(U, dtype=torch.float32) / U
        edges = torch.cat([step * float(self.num_vars),
                           torch.tensor([float(self.num_vars)])])
        return torch.round(edges).to(torch.int32)

    def block_for_worker(self, p, t):
        return (p + t) % self.num_workers

    def block_mask(self, block: int) -> torch.Tensor:
        """(J,) bool: which variables lie in ``block``."""
        b = self.bounds
        j = torch.arange(self.num_vars)
        return (j >= b[block]) & (j < b[block + 1])

    def forward_perm(self, phase: int) -> torch.Tensor:
        """(U,) index map: ``x[forward_perm(t)]`` puts block
        ``block_for_worker(d, t)`` at worker d (the JAX pairs
        ``((d + t) % U, d)``)."""
        return (torch.arange(self.num_workers) + phase) % self.num_workers

    def backward_perm(self, phase: int) -> torch.Tensor:
        """(U,) index map: ``y[backward_perm(t)]`` sends each worker's
        block home (the JAX pairs ``(d, (d + t) % U)``)."""
        return (torch.arange(self.num_workers) - phase) % self.num_workers

    def propose(self, carry, noise, t, phase, device=None):
        # the rotation lives in the app's indexing; nothing to propose
        return None

    def finalize(self, candidates, stats):
        return candidates, None


def priority_weights(delta: torch.Tensor, eta: float) -> torch.Tensor:
    """c_j ∝ |Δx_j| + η  (paper §3.3, f₁)."""
    return delta.abs() + eta


def sample_candidates(gumbel: torch.Tensor, weights: torch.Tensor,
                      num_candidates: int) -> torch.Tensor:
    """Draw U′ distinct candidates ∝ weights via Gumbel top-k, given the
    (J,) Gumbel draw.  A stable descending sort breaks ties towards the
    lower index, as ``lax.top_k`` does."""
    keys = torch.log(torch.clamp_min(weights, 1e-30)) + gumbel
    order = torch.sort(keys, descending=True, stable=True).indices
    return order[:num_candidates]


def dependency_filter(gram: torch.Tensor, rho: float,
                      max_select: int) -> torch.Tensor:
    """Greedy ρ-dependency filter (paper §3.3, f₂): admit candidates in
    order; candidate i joins iff its |correlation| with every admitted
    candidate is < ρ and fewer than ``max_select`` are admitted.  Returns
    the (U′,) keep-mask.  Tensor ops only — no ``.item()``, no Python
    ``bool`` of a device tensor — so it never waits for the device."""
    u = gram.shape[0]
    absg = gram.abs()
    keep = torch.zeros((u,), dtype=torch.bool, device=gram.device)
    count = torch.zeros((), dtype=torch.int32, device=gram.device)
    zero = torch.zeros((), dtype=absg.dtype, device=gram.device)
    for i in range(u):
        # max correlation with already-kept candidates (keep[i] is still
        # False, so the candidate itself is excluded)
        conflict = torch.where(keep, absg[i], zero).max()
        ok = (conflict < rho) & (count < max_select)
        keep[i] = ok
        count = count + ok
    return keep


def structural_gram(candidates: torch.Tensor,
                    min_distance: int) -> torch.Tensor:
    """The graph-distance dependency surrogate: a 0/1 "correlation" block
    where candidates closer than ``min_distance`` (adjacent layers, whose
    gradients flow through each other) count as fully correlated.  It
    feeds :func:`dependency_filter` as the data Gram block does, so any
    ρ ∈ (0, 1] admits exactly the distance-filtered set."""
    d = (candidates[:, None] - candidates[None, :]).abs()
    return (d < min_distance).to(torch.float32)


def _compact_schedule(candidates: torch.Tensor, keep: torch.Tensor,
                      block_size: int):
    """Compact the kept candidates to the front (stable, like
    ``argsort(~keep)``); the tail is masked out downstream."""
    order = torch.sort((~keep).to(torch.uint8), stable=True).indices
    return candidates[order][:block_size], keep[order][:block_size]


@dataclasses.dataclass(frozen=True)
class DynamicPriorityScheduler(SchedulerBase):
    """STRADS Lasso scheduler: priority sampling + Gram dependency filter.
    The carry is the (J,) Δβ history driving the priorities."""
    num_vars: int
    num_candidates: int      # U'
    block_size: int          # U  (≤ num_candidates)
    rho: float = 0.1
    eta: float = 1e-6

    needs_stats = True

    def init_carry(self, device) -> torch.Tensor:
        """Uniform priority at t=0 (every variable equally likely)."""
        return torch.ones((self.num_vars,), dtype=torch.float32,
                          device=device)

    def update_carry(self, carry, idx, mask, dx):
        """Scheduled-and-kept entries take |Δx|; the rest keep their
        previous priority (indices are distinct, so the scatter is
        deterministic)."""
        out = carry.clone()
        out[idx] = torch.where(mask, dx.abs(), carry[idx])
        return out

    def propose(self, carry, noise, t=None, phase: int = 0, device=None):
        c = priority_weights(carry, self.eta)
        return sample_candidates(noise, c, self.num_candidates)

    def finalize(self, candidates, gram):
        keep = dependency_filter(gram, self.rho, self.block_size)
        return _compact_schedule(candidates, keep, self.block_size)

    def mark_scheduled(self, carry, candidates):
        """SSP in-flight exclusion: candidates already proposed in this
        staleness window drop to the η floor, so later stale proposals
        pick fresh coordinates instead of compounding the same deferred
        update (a new tensor; ``carry`` is not changed)."""
        if candidates is None:
            return carry
        out = carry.clone()
        out[candidates] = 0.0
        return out


@dataclasses.dataclass(frozen=True)
class BlockStructuralScheduler(SchedulerBase):
    """Layer-block scheduling: dynamic priorities and the structural ρ
    filter (graph distance instead of the data Gram: the dependency
    between blocks is adjacency, known statically).  The carry is the
    per-block priority table (an EMA of update norms); ``finalize``
    ignores ``stats``."""
    num_blocks: int
    block_size: int          # U  — blocks per step
    num_candidates: int      # U' ≥ U
    min_distance: int = 2
    rho: float = 0.5         # any value in (0,1] is equivalent (0/1 gram)
    eta: float = 1e-3
    ema: float = 0.9

    def init_carry(self, device) -> torch.Tensor:
        return torch.ones((self.num_blocks,), dtype=torch.float32,
                          device=device)

    def propose(self, carry, noise, t=None, phase: int = 0, device=None):
        return sample_candidates(noise, carry + self.eta,
                                 self.num_candidates)

    def keep_mask(self, candidates: torch.Tensor) -> torch.Tensor:
        """The uncompacted (U′,) keep mask — the trainer scatters it onto
        the (num_blocks,) 0/1 schedule mask
        (:func:`repro_torch.sched.block.select_blocks`)."""
        gram = structural_gram(candidates, self.min_distance)
        return dependency_filter(gram, self.rho, self.block_size)

    def finalize(self, candidates, stats=None):
        return _compact_schedule(candidates, self.keep_mask(candidates),
                                 self.block_size)

    def update_carry(self, carry, idx, mask, dx):
        """EMA of per-block update magnitude; only scheduled blocks
        observed an update, the rest keep their stale priority (a new
        tensor; the indices are distinct, so the scatters are
        deterministic)."""
        norms = torch.zeros_like(carry)
        norms[idx] = torch.where(mask, dx.abs(), carry[idx])
        new = self.ema * carry + (1 - self.ema) * norms
        sel = torch.zeros_like(carry, dtype=torch.bool)
        sel[idx] = mask
        return torch.where(sel, new, carry)

    mark_scheduled = DynamicPriorityScheduler.mark_scheduled


def build_scheduler(spec: SchedulerSpec, *, num_vars: int,
                    num_workers: int):
    """Materialize the policy a :class:`SchedulerSpec` declares for a
    concrete app (``num_vars`` schedulable variables, ``num_workers``
    workers)."""
    if not isinstance(spec, SchedulerSpec):
        raise TypeError(f"build_scheduler wants a SchedulerSpec; got "
                        f"{type(spec).__name__}")
    if spec.num_candidates > num_vars:
        raise ValueError(
            f"spec.num_candidates={spec.num_candidates} exceeds the "
            f"app's {num_vars} schedulable variables (top-U′ sampling "
            f"needs U′ <= J)")
    if spec.block_size > num_vars:
        raise ValueError(
            f"spec.block_size={spec.block_size} exceeds the app's "
            f"{num_vars} schedulable variables (a block larger than J "
            f"would schedule duplicates)")
    if spec.kind == "round_robin":
        return RoundRobinScheduler(num_vars, spec.block_size)
    if spec.kind == "random":
        return RandomScheduler(num_vars, spec.block_size)
    if spec.kind == "rotation":
        return RotationScheduler(num_vars, num_workers)
    if spec.kind == "dynamic_priority":
        return DynamicPriorityScheduler(
            num_vars=num_vars, num_candidates=spec.num_candidates,
            block_size=spec.block_size, rho=spec.rho, eta=spec.eta)
    # "block_structural" (spec validation admits nothing else)
    return BlockStructuralScheduler(
        num_blocks=num_vars, block_size=spec.block_size,
        num_candidates=spec.num_candidates,
        min_distance=spec.min_distance, rho=spec.rho, eta=spec.eta,
        ema=spec.ema)
