"""Training steps.

The port of the JAX package's ``train/step.py``:

* :func:`make_train_step` — the full-parameter AdamW step;
* :func:`make_strads_train_step` — the paper's technique as a trainer
  feature: a DynamicPriority block scheduler (:mod:`repro_torch.sched.block`)
  picks which layer blocks receive optimizer updates each step
  (schedule), per-block update norms are the partial results (push), the
  masked AdamW commit is the aggregation (pull).

Gradients come from ``torch.autograd.grad`` over the parameter leaves
(:func:`value_and_grad`), through the flash-attention backward kernel on
the card.  A state is a dict of tensors: ``params``, ``opt`` and ``step``
(int32), and for STRADS ``priority`` and ``rng`` — the state of the
``torch.Generator`` the step draws its Gumbel noise from, where the JAX
package keeps a PRNG key — and with ``staleness > 0`` the cached
``mask``.  ``donate=True`` writes the new parameters and moments into
the state's tensors (the JAX package's ``donate_argnums``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from ..models import model as M
from ..models.transformer import group_layout
from ..optim.adamw import (AdamWConfig, adamw_init, adamw_update,
                           tree_flatten, tree_unflatten)
from ..sched.block import (BlockScheduleConfig, init_priority,
                           select_blocks, update_priority)
from .losses import cross_entropy, token_accuracy


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    adamw: AdamWConfig = AdamWConfig()
    schedule: Optional[Callable[[torch.Tensor], torch.Tensor]] = None
    peak_lr: float = 3e-4
    microbatches: int = 1            # gradient accumulation
    accum_dtype: str = "bfloat16"    # gradient accumulator dtype


def _lr(tc: TrainConfig, step: torch.Tensor) -> torch.Tensor:
    if tc.schedule is None:
        return torch.tensor(tc.peak_lr, dtype=torch.float32,
                            device=step.device)
    return tc.schedule(step)


def init_train_state(cfg, tc: TrainConfig, gen: torch.Generator,
                     device=None) -> Dict[str, Any]:
    """Random parameters from ``gen`` (see :func:`models.model.
    init_params`), zero moments and step 0."""
    params = M.init_params(cfg, gen, device)
    dev = next(iter(tree_flatten(params)))[1].device
    return {"params": params, "opt": adamw_init(params, tc.adamw),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def loss_fn(cfg, params, batch) -> Tuple[torch.Tensor,
                                          Dict[str, torch.Tensor]]:
    logits, aux = M.forward(cfg, params, batch, train=True)
    ce, _ = cross_entropy(logits, batch["labels"], cfg.vocab_size,
                          batch.get("label_mask"))
    loss = ce + cfg.router_aux_weight * aux
    return loss, {"ce": ce.detach(), "aux": aux.detach(),
                  "acc": token_accuracy(logits, batch["labels"],
                                        cfg.vocab_size)}


def value_and_grad(cfg, params, batch):
    """((loss, metrics), grads) of :func:`loss_fn` at ``params``: the
    gradient of every leaf in the leaf's dtype (zeros where a leaf does
    not reach the loss), as ``jax.value_and_grad`` gives it."""
    flat = tree_flatten(params)
    leaves = [p.detach().requires_grad_() for _, p in flat]
    prm = tree_unflatten(params, {n: x for (n, _), x in zip(flat, leaves)})
    with torch.enable_grad():
        loss, metrics = loss_fn(cfg, prm, batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = {n: torch.zeros_like(x) if g is None else g
             for (n, _), x, g in zip(flat, leaves, grads)}
    return (loss.detach(), metrics), tree_unflatten(params, grads)


def _accumulated_grads(cfg, tc: TrainConfig, params, batch):
    """Gradient accumulation over ``tc.microbatches`` slices of the batch:
    gradients summed in ``accum_dtype``, then divided by their count."""
    mb = tc.microbatches
    adt = getattr(torch, tc.accum_dtype)
    acc = {n: torch.zeros(p.shape, dtype=adt, device=p.device)
           for n, p in tree_flatten(params)}
    losses, metricses = [], []
    for i in range(mb):
        mbatch = {k: v.reshape((mb, v.shape[0] // mb) + v.shape[1:])[i]
                  for k, v in batch.items()}
        (loss, metrics), grads = value_and_grad(cfg, params, mbatch)
        for n, g in tree_flatten(grads):
            acc[n] = acc[n] + g.to(adt)
        del grads
        losses.append(loss)
        metricses.append(metrics)
    grads = tree_unflatten(params, {n: a / mb for n, a in acc.items()})
    loss = torch.stack(losses).mean()
    metrics = {k: torch.stack([m[k] for m in metricses]).mean()
               for k in metricses[0]}
    return loss, metrics, grads


def make_train_step(cfg, tc: TrainConfig, donate: bool = False):
    """``train_step(state, batch) -> (state, metrics)``."""
    def train_step(state, batch):
        if tc.microbatches > 1:
            loss, metrics, grads = _accumulated_grads(
                cfg, tc, state["params"], batch)
        else:
            (loss, metrics), grads = value_and_grad(cfg, state["params"],
                                                    batch)
        lr = _lr(tc, state["step"])
        new_p, new_opt, gnorm = adamw_update(
            grads, state["opt"], state["params"], lr, tc.adamw,
            inplace=donate)
        metrics = dict(metrics, loss=loss, grad_norm=gnorm, lr=lr)
        return ({"params": new_p, "opt": new_opt,
                 "step": state["step"] + 1}, metrics)
    return train_step


# ---------------------------------------------------------------------------
# STRADS block-coordinate training
# ---------------------------------------------------------------------------

def num_layer_blocks(cfg) -> int:
    """One block a layer group, or a layer of the unrolled xLSTM stack."""
    return cfg.num_layers if cfg.family == "ssm" else group_layout(cfg)[0]


def _block_of(name: str, rest: int) -> int:
    """A leaf's block: XX for an unrolled layer's ``layers/layer_XX/…``,
    ``-1`` for a stacked layer leaf (its mask is per layer group, along
    the leading axis), else the block after the layers (embeddings, head
    and shared leaves)."""
    if name.startswith("layers/layer_"):
        return int(name.split("/")[1][len("layer_"):])
    return -1 if name.startswith("layers/") else rest


def layer_blocks(cfg, params) -> Tuple[Dict[str, int], int]:
    """Every parameter's block (:func:`_block_of`).  Returns (mapping,
    number of blocks)."""
    nl = num_layer_blocks(cfg)
    return ({name: _block_of(name, nl) for name, _ in tree_flatten(params)},
            nl + 1)


def _gumbel(rng_state: torch.Tensor, n: int, device):
    """(n,) float32 Gumbel draws −log(−log u), u uniform in [tiny, 1), from
    a generator in ``rng_state``; returns (draws, the generator's next
    state)."""
    gen = torch.Generator(device=device)
    gen.set_state(rng_state)
    u = torch.rand((n,), generator=gen, device=device, dtype=torch.float32)
    u = torch.clamp_min(u, torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u)), gen.get_state()


def make_strads_train_step(cfg, tc: TrainConfig, sched: BlockScheduleConfig,
                           staleness: int = 0, donate: bool = False):
    """The block-coordinate step: ``train_step(state, batch, gumbel=None)
    -> (state, metrics)``.  Stacked layer leaves are masked along their
    leading (layer group) axis, every other leaf by the last block.

    The (num_blocks,) Gumbel draw of the schedule comes from the state's
    generator, or from ``gumbel`` (a parity test passes the JAX draws;
    the generator state is then left as it was).  ``staleness > 0`` adopts
    a fresh schedule only every ``staleness + 1`` steps and serves the
    cached ``mask`` in between.  ``metrics["mask"]`` is the applied
    (num_blocks,) mask; ``blocks_active`` its sum.  The unrolled xLSTM
    stack's layers are blocks of their own (:func:`_block_of`)."""
    refresh = staleness + 1
    nb = sched.num_blocks

    def mask_updates(updates, mask):
        # the updates are adamw_update's own float32 tensors: scaled in
        # place, the same values as u · mask
        for name, u in tree_flatten(updates):
            b = _block_of(name, nb - 1)
            if b < 0:
                u.mul_(mask[:u.shape[0]].reshape(
                    (u.shape[0],) + (1,) * (u.dim() - 1)).to(u.dtype))
            else:
                u.mul_(mask[b])
        return updates

    def norms(updates, device):
        sq = torch.zeros((nb,), dtype=torch.float32, device=device)
        for name, u in tree_flatten(updates):
            uf = torch.square(u.float())
            b = _block_of(name, nb - 1)
            if b < 0:
                sq[:u.shape[0]] += uf.sum(dim=tuple(range(1, u.dim())))
            else:
                sq[b] += uf.sum()
        return torch.sqrt(sq)

    def train_step(state, batch, gumbel=None):
        prio = state["priority"]
        rng = state["rng"]
        if gumbel is None:
            gumbel, rng = _gumbel(rng, nb, prio.device)
        fresh = select_blocks(sched, prio, gumbel.to(prio.device))
        if staleness:
            mask = torch.where(state["step"] % refresh == 0, fresh,
                               state["mask"])
        else:
            mask = fresh
        (loss, metrics), grads = value_and_grad(cfg, state["params"], batch)
        lr = _lr(tc, state["step"])
        captured = {}

        def mask_and_capture(updates):
            captured["norms"] = norms(updates, prio.device)
            return mask_updates(updates, mask)
        new_p, new_opt, gnorm = adamw_update(
            grads, state["opt"], state["params"], lr, tc.adamw,
            update_mask=mask_and_capture, inplace=donate)
        priority = update_priority(sched, prio, captured["norms"], mask)
        metrics = dict(metrics, loss=loss, grad_norm=gnorm, lr=lr,
                       blocks_active=mask.sum(), mask=mask)
        out = {"params": new_p, "opt": new_opt, "step": state["step"] + 1,
               "priority": priority, "rng": rng}
        if staleness:
            out["mask"] = mask
        return out, metrics

    return train_step


def init_strads_state(cfg, tc: TrainConfig, sched: BlockScheduleConfig,
                      gen: torch.Generator, staleness: int = 0,
                      device=None) -> Dict[str, Any]:
    """:func:`init_train_state` plus uniform priorities and ``rng``, the
    state of ``gen`` after the parameters were drawn (the schedule's
    noise continues that stream)."""
    st = init_train_state(cfg, tc, gen, device)
    dev = st["step"].device
    st["priority"] = init_priority(sched, dev)
    st["rng"] = gen.get_state()
    if staleness:
        # step 0 always recomputes (0 % refresh == 0): any init works
        st["mask"] = torch.zeros((sched.num_blocks,), dtype=torch.float32,
                                 device=dev)
    return st
