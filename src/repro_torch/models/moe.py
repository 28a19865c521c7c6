"""Mixture-of-Experts layer: top-k router + capacity-based expert FFN.

The port of the JAX package's ``models/moe.py``.  The router goes through
the top-k gating kernel (:func:`repro_torch.kernels.ops.topk_gating`);
two dispatches, as ``cfg.moe_impl`` picks:
  * ``"einsum"``, the GShard one-hot form: tokens are ranked within each
    expert's queue per group of :data:`GROUP` tokens, those past the
    capacity C are dropped, and the expert FFN runs on (E, C)-shaped
    batches.  The one-hot dispatch and combine tensors are built by a
    scatter-add rather than by summing one-hots, which gives the same
    values without the (g, k, E·C) intermediate;
  * ``"sort"``: the (token, slot) pairs stably sorted by expert, ranked
    within each expert's run over all T tokens, gathered into dense
    (E, C, d) batches and added back by ``index_add_``.  No one-hot
    product.  With T ≤ :data:`GROUP` both forms have the same capacity
    and drop order.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from ..kernels import ops
from .layers import (EXPERT, FSDP, apply_norm, mlp_apply, mlp_template,
                     norm_template)
from .params import ParamMeta

# Token-group size for capacity accounting (tokens are dispatched within
# groups so the (g, E, C) one-hots stay small).
GROUP = 4096


def moe_template(cfg) -> Dict[str, Any]:
    d, f, E = cfg.d_model, cfg.d_ff, cfg.num_experts
    t = {
        "norm": norm_template(cfg),
        "router": ParamMeta((d, E), (FSDP, None), scale=d ** -0.5),
        "wg": ParamMeta((E, d, f), (EXPERT, FSDP, None)),
        "wu": ParamMeta((E, d, f), (EXPERT, FSDP, None)),
        "wd": ParamMeta((E, f, d), (EXPERT, None, FSDP)),
    }
    if cfg.moe_shared_expert:
        t["shared"] = mlp_template(cfg)
    return t


def _capacity(g: int, k: int, E: int, factor: float) -> int:
    c = int(g * k / E * factor)
    return max(4, -(-c // 4) * 4)


def _router(p, h, cfg):
    """Common gating: returns (probs (T,k), idx (T,k) int64, aux-loss)."""
    logits = (h @ p["router"].to(h.dtype)).float()
    probs, idx = ops.topk_gating(logits, cfg.experts_per_token)
    idx = idx.long()
    # GShard load-balance loss: E * Σ_e (fraction_e · mean-prob_e)
    full = torch.softmax(logits, dim=-1)
    onehot = F.one_hot(idx[:, 0], cfg.num_experts).float()
    aux = cfg.num_experts * torch.mean(onehot.mean(0) * full.mean(0))
    return probs, idx, aux


def _dispatch_einsum(p, h, cfg, probs, idx):
    """Capacity-based one-hot dispatch (GShard).  h (T, d) → y (T, d)."""
    T, d = h.shape
    E, k = cfg.num_experts, cfg.experts_per_token
    g = min(GROUP, T)
    G = T // g
    C = _capacity(g, k, E, cfg.capacity_factor)
    hg = h.reshape(G, g, d)
    pg = probs.reshape(G, g, k)
    ig = idx.reshape(G, g, k)

    # rank every (token, slot) within its expert queue, in (token, slot)
    # order: a cumsum of the expert one-hot over the group, taken along
    # a contiguous last axis (a scan along a middle axis runs with only E
    # threads)
    sel = F.one_hot(ig, E).to(torch.int32).reshape(G, g * k, E)
    prio = sel.transpose(1, 2).contiguous().cumsum(dim=-1)     # (G,E,g·k)
    prio = prio.transpose(1, 2).reshape(G, g, k, E)
    rank = prio.gather(-1, ig[..., None])[..., 0] - 1          # (G,g,k)
    keep = (rank >= 0) & (rank < C)
    # dispatch[g, s, e·C + c] = 1 and combine[...] = prob where token s's
    # slot went to expert e at rank c.  A token's k slots go to k
    # different experts, and a dropped slot adds 0 (at column 0), so the
    # sums are exact; E·C columns keep the rows aligned for the matmuls.
    col = torch.where(keep, ig * C + rank, 0)
    kept = keep.to(h.dtype)
    dispatch = torch.zeros((G, g, E * C), dtype=h.dtype, device=h.device)
    dispatch.scatter_add_(-1, col, kept)
    combine = torch.zeros_like(dispatch)
    combine.scatter_add_(-1, col, pg.to(h.dtype) * kept)
    dispatch = dispatch.view(G, g, E, C)
    combine = combine.view(G, g, E, C)

    xin = torch.einsum("gsec,gsd->gecd", dispatch, hg)
    gate = torch.einsum("gecd,edf->gecf", xin, p["wg"].to(h.dtype))
    up = torch.einsum("gecd,edf->gecf", xin, p["wu"].to(h.dtype))
    hidden = F.silu(gate) * up
    out = torch.einsum("gecf,efd->gecd", hidden, p["wd"].to(h.dtype))
    y = torch.einsum("gsec,gecd->gsd", combine, out)
    return y.reshape(T, d)


def _dispatch_sort(p, h, cfg, probs, idx):
    """Sort-based dispatch.  h (T, d) → y (T, d).

    Entries past an expert's capacity go to an overflow row E·C that is
    dropped, and add 0 on the way back.  A token's row of ``y`` sums its
    k ≤ 2 kept contributions into a zero row, and a + b = b + a, so the
    atomics of ``index_add_`` on the card cannot change the bits."""
    T, d = h.shape
    E, k = cfg.num_experts, cfg.experts_per_token
    C = _capacity(T, k, E, cfg.capacity_factor)

    flat_e = idx.reshape(-1)                                  # (T·k,)
    flat_t = torch.arange(T, device=h.device).repeat_interleave(k)
    order = torch.argsort(flat_e, stable=True)
    e_sorted, t_sorted = flat_e[order], flat_t[order]
    p_sorted = probs.reshape(-1)[order]
    # rank of each entry within its expert's run: its position less the
    # run's start (a running max of the starts)
    pos = torch.arange(e_sorted.numel(), device=h.device)
    starts = torch.ones_like(e_sorted, dtype=torch.bool)
    starts[1:] = e_sorted[1:] != e_sorted[:-1]
    rank = pos - torch.where(starts, pos, 0).cummax(0).values
    keep = rank < C
    dest = torch.where(keep, e_sorted * C + rank, E * C)      # overflow row

    xin = h.new_zeros((E * C + 1, d))
    xin[dest] = h[t_sorted]
    xin = xin[:-1].view(E, C, d)
    gate = torch.bmm(xin, p["wg"].to(h.dtype))
    up = torch.bmm(xin, p["wu"].to(h.dtype))
    out = torch.bmm(F.silu(gate) * up, p["wd"].to(h.dtype))

    contrib = torch.where(keep, p_sorted, 0.0)[:, None].to(h.dtype)
    picked = out.view(E * C, d)[dest.clamp_max(E * C - 1)]
    return h.new_zeros((T, d)).index_add_(0, t_sorted, picked * contrib)


def moe_apply(p: Dict[str, Any], x: torch.Tensor, cfg,
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pre-norm MoE block (residual included).  Returns (y, aux_loss)."""
    B, S, d = x.shape
    h = apply_norm(p["norm"], x, cfg).reshape(B * S, d)
    probs, idx, aux = _router(p, h, cfg)
    dispatch = _dispatch_sort if cfg.moe_impl == "sort" else _dispatch_einsum
    y = dispatch(p, h, cfg, probs, idx).reshape(B, S, d)
    if cfg.moe_shared_expert:
        # shared expert runs densely on every token (Llama-4 style);
        # mlp_apply adds its own residual, so feed x and take the delta.
        y = y + (mlp_apply(p["shared"], x, cfg) - x)
    return x + y, aux
