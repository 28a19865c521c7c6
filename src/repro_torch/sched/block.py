"""STRADS block-coordinate scheduling for deep-net training.

The port of the JAX package's ``sched/block.py``: the paper's
DynamicPriority schedule carried from model variables onto the layer
blocks of a deep net.

* priority  c_b ∝ ‖Δθ_b‖ + η            (the Lasso f₁ rule, per block)
* dependency filter: blocks closer than ``min_distance`` are not
  scheduled together — the greedy ρ filter of the Lasso scheduler
  (:func:`repro_torch.sched.schedulers.dependency_filter`) fed the 0/1
  :func:`~repro_torch.sched.schedulers.structural_gram`;
* push/pull: the optimizer update of unscheduled blocks is masked to
  zero, so only the scheduled blocks move in a step.

:class:`BlockScheduleConfig` is the trainer-facing surface
(``launch/train.py --strads``, ``train/step.py``); it round-trips to the
declarative :class:`~repro_torch.sched.spec.SchedulerSpec` through
:func:`config_from_spec` and :meth:`BlockScheduleConfig.to_spec`.  As
everywhere in the port, randomness is an input: :func:`select_blocks`
takes its (num_blocks,) Gumbel draw.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from ..optim.adamw import tree_flatten, tree_unflatten
from .schedulers import dependency_filter, sample_candidates, structural_gram
from .spec import SchedulerSpec


@dataclasses.dataclass(frozen=True)
class BlockScheduleConfig:
    num_blocks: int
    blocks_per_step: int          # U
    candidates_per_step: int      # U' ≥ U
    min_distance: int = 2         # dependency filter radius (layers)
    eta: float = 1e-3             # exploration floor (paper's η)
    ema: float = 0.9              # priority EMA decay
    rho: float = 0.5              # threshold over the 0/1 structural gram

    def to_spec(self) -> SchedulerSpec:
        """The declarative twin (``kind="block_structural"``)."""
        return SchedulerSpec(kind="block_structural",
                             block_size=self.blocks_per_step,
                             num_candidates=self.candidates_per_step,
                             rho=self.rho, eta=self.eta,
                             min_distance=self.min_distance, ema=self.ema)


def config_from_spec(spec: SchedulerSpec,
                     num_blocks: int) -> BlockScheduleConfig:
    """The trainer config a ``block_structural`` spec declares
    (``num_blocks`` comes from the model layout, never the spec)."""
    if spec.kind != "block_structural":
        raise ValueError(f"the block-coordinate trainer needs a "
                         f"kind='block_structural' spec; got {spec.kind!r}")
    return BlockScheduleConfig(
        num_blocks=num_blocks,
        blocks_per_step=min(spec.block_size, num_blocks),
        candidates_per_step=min(spec.num_candidates, num_blocks),
        min_distance=spec.min_distance, eta=spec.eta, ema=spec.ema,
        rho=spec.rho)


def init_priority(cfg: BlockScheduleConfig, device=None) -> torch.Tensor:
    """Uniform initial priorities (all blocks equally urgent)."""
    return torch.ones((cfg.num_blocks,), dtype=torch.float32, device=device)


def select_blocks(cfg: BlockScheduleConfig, priority: torch.Tensor,
                  gumbel: torch.Tensor) -> torch.Tensor:
    """schedule(): a (num_blocks,) float32 0/1 mask of the blocks to
    update, given the (num_blocks,) Gumbel draw: priority sampling (f₁),
    then the greedy ρ filter (f₂) over the structural gram."""
    cand = sample_candidates(gumbel, priority + cfg.eta,
                             cfg.candidates_per_step)
    keep = dependency_filter(structural_gram(cand, cfg.min_distance),
                             cfg.rho, cfg.blocks_per_step)
    mask = torch.zeros((cfg.num_blocks,), dtype=torch.float32,
                       device=priority.device)
    mask[cand] = keep.to(torch.float32)
    return mask


def update_priority(cfg: BlockScheduleConfig, priority: torch.Tensor,
                    block_update_norms: torch.Tensor,
                    scheduled: torch.Tensor) -> torch.Tensor:
    """Pull-side bookkeeping: an EMA of each block's update magnitude.
    Unscheduled blocks keep their stale priority."""
    new = cfg.ema * priority + (1 - cfg.ema) * block_update_norms
    return torch.where(scheduled > 0, new, priority)


def mask_updates_by_block(updates: Any, block_of_param: Dict[str, int],
                          mask: torch.Tensor) -> Any:
    """Zero the update of every parameter whose block is unscheduled.
    ``block_of_param`` maps a flattened parameter path → block id."""
    out = {}
    for name, leaf in tree_flatten(updates):
        b = block_of_param.get(name)
        out[name] = leaf if b is None else leaf * mask[b]
    return tree_unflatten(updates, out)


def block_norms(updates: Any, block_of_param: Dict[str, int],
                num_blocks: int) -> torch.Tensor:
    """Per-block L2 norm of the (pre-mask) updates — feeds priorities."""
    sq = None
    for name, leaf in tree_flatten(updates):
        b = block_of_param.get(name)
        if b is not None:
            if sq is None:
                sq = torch.zeros((num_blocks,), dtype=torch.float32,
                                 device=leaf.device)
            sq[b] += torch.sum(torch.square(leaf).float())
    if sq is None:
        sq = torch.zeros((num_blocks,), dtype=torch.float32)
    return torch.sqrt(sq)
