"""AdamW with a configurable moment dtype and global-norm clipping.

The port of the JAX package's ``optim/adamw.py``, functional on the
parameter tree (nested dicts of tensors): the moment math in float32, the
moments stored in ``moment_dtype``, the bias corrections from ``count``,
and decoupled decay applied as ``p − lr·(u + wd·p)`` in float32, then
cast to p's dtype.  Leaves are walked in the JAX package's flatten order
(sorted keys), so :func:`global_norm` sums in the same order.

``inplace=True`` writes the new moments and parameters into the given
tensors (the JAX package's ``donate_argnums``): the same values, without
a second copy of the moments, which a 3-billion-parameter model on one
card needs.  ``opt_specs`` has no counterpart on one card.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: Optional[float] = 1.0
    moment_dtype: str = "float32"


def tree_flatten(tree: Any, prefix: str = "") -> List[Tuple[str, Any]]:
    """(``/``-joined path, leaf) of a nested dict in the JAX package's
    flatten order: keys sorted at every level."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += tree_flatten(tree[k], f"{prefix}/{k}" if prefix else k)
        return out
    return [(prefix, tree)]


def tree_unflatten(template: Any, values: Dict[str, Any],
                   prefix: str = "") -> Any:
    """A nested dict shaped like ``template`` with the leaf at each path
    taken from ``values``."""
    if isinstance(template, dict):
        return {k: tree_unflatten(v, values, f"{prefix}/{k}" if prefix
                                  else k) for k, v in template.items()}
    return values[prefix]


def adamw_init(params: Any, cfg: AdamWConfig) -> Dict[str, Any]:
    dt = getattr(torch, cfg.moment_dtype)
    zeros = {name: torch.zeros(p.shape, dtype=dt, device=p.device)
             for name, p in tree_flatten(params)}
    device = next(iter(zeros.values())).device if zeros else None
    return {"m": tree_unflatten(params, zeros),
            "v": tree_unflatten(params, {k: v.clone()
                                         for k, v in zeros.items()}),
            "count": torch.zeros((), dtype=torch.int32, device=device)}


def global_norm(tree: Any) -> torch.Tensor:
    """√(Σ x²) over every leaf, in float32, summed leaf after leaf."""
    total = 0
    for _, x in tree_flatten(tree):
        total = total + torch.sum(torch.square(x.float()))
    return torch.sqrt(total)


def adamw_update(grads: Any, opt: Dict[str, Any], params: Any,
                 lr: torch.Tensor, cfg: AdamWConfig,
                 update_mask: Optional[Callable[[Any], Any]] = None,
                 inplace: bool = False,
                 ) -> Tuple[Any, Dict[str, Any], torch.Tensor]:
    """One AdamW step.  Returns (new_params, new_opt, pre-clip grad norm).

    ``update_mask``: optional fn(updates_tree) → masked updates — the hook
    the STRADS block scheduler uses to zero unscheduled blocks.  Without
    it each leaf's float32 update is applied as soon as it is made."""
    count = opt["count"] + 1
    gnorm = global_norm(grads)
    scale = None
    if cfg.clip_norm is not None:
        scale = torch.clamp_max(cfg.clip_norm / (gnorm + 1e-9), 1.0)
    dt = getattr(torch, cfg.moment_dtype)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1 - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                     device=count.device), count.float())
    bc2 = 1 - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                     device=count.device), count.float())
    m_tree, v_tree = dict(tree_flatten(opt["m"])), dict(tree_flatten(opt["v"]))
    p_tree = dict(tree_flatten(params))
    new_m, new_v, new_p, upd = {}, {}, {}, {}

    def apply(name, u):
        p = p_tree[name]
        pf = p.float()
        out = pf - lr * (u + cfg.weight_decay * pf)
        if inplace:
            new_p[name] = p.copy_(out)
        else:
            new_p[name] = out.to(p.dtype)

    for name, g in tree_flatten(grads):
        # a clipped gradient is float32, as jnp promotes bf16 · f32
        gf = g.float() if scale is None else g.float() * scale
        m, v = m_tree[name], v_tree[name]
        mf = b1 * m.float() + (1 - b1) * gf
        vf = b2 * v.float() + (1 - b2) * torch.square(gf)
        del gf
        new_m[name] = m.copy_(mf) if inplace else mf.to(dt)
        new_v[name] = v.copy_(vf) if inplace else vf.to(dt)
        u = (mf / bc1) / (torch.sqrt(vf / bc2) + cfg.eps)
        del mf, vf
        if update_mask is None:
            apply(name, u)
        else:
            upd[name] = u
        del u
    if update_mask is not None:
        masked = dict(tree_flatten(update_mask(tree_unflatten(grads, upd))))
        upd.clear()
        for name in list(masked):
            apply(name, masked.pop(name))
    return (tree_unflatten(params, new_p),
            {"m": tree_unflatten(opt["m"], new_m),
             "v": tree_unflatten(opt["v"], new_v), "count": count},
            gnorm)
