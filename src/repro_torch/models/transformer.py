"""The decoder/encoder stack of all six families.

The port of the JAX package's ``models/transformer.py``.  Layers are
organised into groups that repeat down the stack, and each parameter of a
group is stacked over the groups (the JAX package's scan-over-layers
layout, so weights carry across one for one).  Group contents:

  dense / vlm / audio  : [attn, mlp]                       × num_layers
  moe (moe_every=g)    : [attn, mlp] × (g−1) + [attn, moe] × (layers / g)
  hybrid (attn_every=g): [mamba] × g + shared-attn(+mlp)   × (layers / g)
                         — one set of attention and MLP parameters,
                         applied after every group (Zamba2 style), with a
                         KV cache of its own for each application
  ssm (xLSTM)          : unrolled, one ``layers/layer_XX`` entry a layer
                         (sLSTM at ``slstm_layers``, mLSTM elsewhere),
                         with its recurrent state as its cache

Where the JAX package scans over the stacked groups, the port loops in
Python over layer slices of the stacked tensors (``torch.unbind``, once a
leaf).  With ``train=True`` each group runs under
``torch.utils.checkpoint`` (the JAX package's ``jax.checkpoint`` with
``nothing_saveable``): its activations are made again in the backward.
The unrolled xLSTM stack checkpoints each layer the same way.
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from ..sharding import rules
from . import params as P
from .layers import (FSDP, VOCAB, attention_apply, attention_cache_template,
                     attention_template, mlp_apply, mlp_template,
                     norm_template)
from .moe import moe_apply, moe_template
from .ssm import ssm_apply, ssm_state_template, ssm_template
from .xlstm import (mlstm_apply, mlstm_state_template, mlstm_template,
                    slstm_apply, slstm_state_template, slstm_template)

ParamMeta = P.ParamMeta


# ---------------------------------------------------------------------------
# Stack layout
# ---------------------------------------------------------------------------

def group_layout(cfg) -> Tuple[int, List[Tuple[str, str]]]:
    """Returns (number of groups, [(sub_name, kind), ...]) for the
    grouped families; the xLSTM stack is unrolled and has none."""
    if cfg.family in ("dense", "vlm", "audio"):
        return cfg.num_layers, [("attn0", "attn"), ("ffn0", "mlp")]
    if cfg.family == "moe":
        g = max(1, cfg.moe_every)
        subs = []
        for i in range(g):
            subs.append((f"attn{i}", "attn"))
            subs.append((f"ffn{i}", "moe" if i == g - 1 else "mlp"))
        return cfg.num_layers // g, subs
    if cfg.family == "hybrid":
        g = max(1, cfg.attn_every)
        return cfg.num_layers // g, [(f"mamba{i}", "mamba") for i in range(g)]
    raise ValueError(cfg.family)


_SUB_TEMPLATE = {
    "attn": attention_template,
    "mlp": mlp_template,
    "moe": moe_template,
    "mamba": ssm_template,
    "mlstm": mlstm_template,
    "slstm": slstm_template,
}


def _xlstm_kinds(cfg) -> List[str]:
    return ["slstm" if i in cfg.slstm_layers else "mlstm"
            for i in range(cfg.num_layers)]


def stack_template(cfg) -> Dict[str, Any]:
    """Template for the full parameter tree."""
    d = cfg.d_model
    vp = rules.padded_vocab(cfg.vocab_size)
    t: Dict[str, Any] = {}
    if cfg.frontend != "audio":
        t["tok_embed"] = ParamMeta((vp, d), (VOCAB, FSDP), scale=0.02)
    if cfg.family == "ssm":                              # xlstm: unrolled
        t["layers"] = {f"layer_{i:02d}": _SUB_TEMPLATE[kind](cfg)
                       for i, kind in enumerate(_xlstm_kinds(cfg))}
    else:
        steps, subs = group_layout(cfg)
        group = {name: _SUB_TEMPLATE[kind](cfg) for name, kind in subs}
        t["layers"] = P.stack(group, steps)
    if cfg.family == "hybrid":                           # shared block
        t["shared_attn"] = attention_template(cfg)
        t["shared_mlp"] = mlp_template(cfg)
    t["final_norm"] = norm_template(cfg)
    if not cfg.tie_embeddings:
        t["lm_head"] = ParamMeta((d, vp), (FSDP, VOCAB))
    return t


# ---------------------------------------------------------------------------
# Cache template
# ---------------------------------------------------------------------------

def cache_template(cfg, batch: int, cache_len: int) -> Dict[str, Any]:
    """Layout of the decode cache (mirrors the layer groups): keys and
    values of each attention sub-layer, the recurrent state {"h", "conv"}
    of each mamba sub-layer and, for the hybrid family, one KV cache for
    each application of the shared attention block; for the xLSTM stack,
    each layer's recurrent state (mLSTM {"C", "n", "m"}, sLSTM {"c", "n",
    "m", "h"}) and no ``kpos``, since it has no attention."""
    if cfg.family == "ssm":
        return {"layers": {
            f"layer_{i:02d}": (mlstm_state_template(cfg, batch)
                               if kind == "mlstm"
                               else slstm_state_template(cfg, batch))
            for i, kind in enumerate(_xlstm_kinds(cfg))}}
    steps, subs = group_layout(cfg)
    group: Dict[str, Any] = {}
    for name, kind in subs:
        if kind == "attn":
            group[name] = attention_cache_template(cfg, batch, cache_len)
        elif kind == "mamba":
            group[name] = ssm_state_template(cfg, batch)
    t = {"layers": P.stack(group, steps)}
    if cfg.family == "hybrid":
        t["shared_attn"] = P.stack(
            attention_cache_template(cfg, batch, cache_len), steps)
    t["kpos"] = ParamMeta((cache_len,), (None,), "zeros")       # int32 − 1
    return t


# ---------------------------------------------------------------------------
# Sub-layer application
# ---------------------------------------------------------------------------

def _apply_sub(kind: str, p, x, cfg, ctx):
    """Returns (x, aux_loss or None); a cache in ``ctx`` is written in
    place."""
    if kind == "attn":
        x, _ = attention_apply(
            p, x, cfg, positions=ctx["positions"], cache=ctx["cache"],
            kpos=ctx["kpos"], slot=ctx["slot"], causal=cfg.causal,
            window=ctx["window"])
        return x, None
    if kind == "mlp":
        return mlp_apply(p, x, cfg), None
    if kind == "moe":
        return moe_apply(p, x, cfg)
    if kind == "mamba":
        state = ctx["cache"]
        x, new = ssm_apply(p, x, cfg, state=state)
        if state is not None:
            state["h"].copy_(new["h"])
            state["conv"].copy_(new["conv"])
        return x, None
    if kind in ("mlstm", "slstm"):
        state = ctx["cache"]
        keys = "Cnm" if kind == "mlstm" else "cnmh"
        apply = mlstm_apply if kind == "mlstm" else slstm_apply
        x, new = apply(p, x, cfg, state=None if state is None
                       else tuple(state[k] for k in keys))
        if state is not None:
            for k, t in zip(keys, new):
                state[k].copy_(t)
        return x, None
    raise ValueError(kind)


def _layer(tree, i: int):
    return P.tree_map(lambda _, t: t[i], tree)


def _unbind(tree, n: int) -> List[Any]:
    """The n layer slices of a stacked tree, each leaf split once with
    ``torch.unbind``: under autograd its backward stacks the n slices'
    gradients in one pass, where ``t[i]`` would make a gradient of the
    whole stacked leaf for each layer and sum them one by one."""
    parts = P.tree_map(lambda _, t: t.unbind(0), tree)
    return [P.tree_map(lambda _, t: t[i], parts) for i in range(n)]


# ---------------------------------------------------------------------------
# Stack application (shared by forward / prefill / decode)
# ---------------------------------------------------------------------------

def apply_stack(cfg, prm, x, *, positions, cache=None, kpos=None, slot=None,
                window=None, train=False):
    """Runs the layer stack.  Returns (x, cache, aux_loss); a given
    ``cache`` ({"layers": …}, and "shared_attn" for the hybrid family)
    is filled or updated in place.  ``train=True`` checkpoints each group
    (same values; its activations are made again in the backward)."""
    base_ctx = {"positions": positions, "kpos": kpos, "slot": slot,
                "window": window}
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.family == "ssm":                              # unrolled xlstm
        for i, kind in enumerate(_xlstm_kinds(cfg)):
            name = f"layer_{i:02d}"
            ctx = dict(base_ctx, cache=None if cache is None
                       else cache["layers"][name])
            if train:
                x, _ = checkpoint(_apply_sub, kind, prm["layers"][name], x,
                                  cfg, ctx, use_reentrant=False)
            else:
                x, _ = _apply_sub(kind, prm["layers"][name], x, cfg, ctx)
        return x, cache, aux
    steps, subs = group_layout(cfg)

    def group(i, layer_p, x):
        layer_cache = None if cache is None else _layer(cache["layers"], i)
        aux = None
        for name, kind in subs:
            ctx = dict(base_ctx)
            ctx["cache"] = None if layer_cache is None \
                else layer_cache.get(name)
            x, a = _apply_sub(kind, layer_p[name], x, cfg, ctx)
            if a is not None:
                aux = a if aux is None else aux + a
        if cfg.family == "hybrid":           # the shared block, cache i
            ctx = dict(base_ctx)
            ctx["cache"] = None if cache is None \
                else _layer(cache["shared_attn"], i)
            x, _ = _apply_sub("attn", prm["shared_attn"], x, cfg, ctx)
            x = mlp_apply(prm["shared_mlp"], x, cfg)
        return x, aux

    for i, layer_p in enumerate(_unbind(prm["layers"], steps)):
        if train:
            x, a = checkpoint(group, i, layer_p, x, use_reentrant=False)
        else:
            x, a = group(i, layer_p, x)
        if a is not None:
            aux = aux + a
    return x, cache, aux
