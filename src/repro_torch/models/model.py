"""Public model API: ``init_params`` / ``forward`` / ``encode_step`` /
``init_cache`` / ``prefill`` / ``decode_step``.

The port of the JAX package's ``models/model.py``, for every family and
both frontend stubs: an audio arch (HuBERT) takes ``batch["frames"]``
(B, S, d) frame embeddings in place of tokens; a vision arch (InternVL2)
takes ``batch["frontend"]`` (B, P, d) patch embeddings, put ahead of the
token embeddings, and its logits drop those P positions.  Every function
takes the :class:`repro_torch.configs.base.ModelConfig` explicitly;
parameters are nested dicts built from :func:`transformer.stack_template`,
on the device :func:`init_params` put them on.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from . import params as P
from .layers import apply_norm
from .transformer import apply_stack, cache_template, stack_template


def _dtype(cfg) -> torch.dtype:
    return getattr(torch, cfg.dtype)


# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------

def init_params(cfg, gen: torch.Generator, device=None):
    """Random parameters drawn from ``gen`` on ``gen``'s device (or
    ``device``), in the config's dtype, with the JAX package's init rule
    (:func:`params.leaf_std`).  The draws differ from JAX's; carry JAX
    weights over with :func:`repro_torch.convert.model_params_from_jax`."""
    device = gen.device if device is None else torch.device(device)
    return P.init(stack_template(cfg), gen, _dtype(cfg), device)


def num_params(cfg) -> int:
    return P.param_count(stack_template(cfg))


def num_frontend_tokens(cfg) -> int:
    """Positions a vision arch's patch embeddings take ahead of the text
    (0 for every other arch): a prompt's decode positions start after
    them, and a cache holds them."""
    return cfg.frontend_tokens if cfg.frontend == "vision" else 0


# ---------------------------------------------------------------------------
# Embedding / head
# ---------------------------------------------------------------------------

def _embed(cfg, prm, tokens: torch.Tensor) -> torch.Tensor:
    x = prm["tok_embed"][tokens].to(_dtype(cfg))
    return x * cfg.d_model ** 0.5 if cfg.scale_embed else x


def _logits(cfg, prm, x: torch.Tensor) -> torch.Tensor:
    x = apply_norm(prm["final_norm"], x, cfg)
    if cfg.tie_embeddings:
        return x @ prm["tok_embed"].to(x.dtype).T
    return x @ prm["lm_head"].to(x.dtype)


def _inputs(cfg, prm, batch: Dict[str, torch.Tensor]):
    """Token or frontend embeddings: (x (B, S_total, d), n_frontend)."""
    if cfg.frontend == "audio":
        return batch["frames"].to(_dtype(cfg)), 0
    x = _embed(cfg, prm, batch["tokens"])
    if cfg.frontend == "vision":
        fe = batch["frontend"].to(_dtype(cfg))
        return torch.cat([fe, x], dim=1), fe.shape[1]
    return x, 0


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def forward(cfg, prm, batch: Dict[str, torch.Tensor], *, train: bool = False,
            window: Optional[int] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward.  Returns (logits (B, S_text, Vp), aux_loss):
    a vision arch's frontend positions have no logits (the JAX package
    computes and drops them).  ``train=True`` checkpoints each layer
    group (the same values)."""
    x, n_front = _inputs(cfg, prm, batch)
    positions = torch.arange(x.shape[1], device=x.device)
    x, _, aux = apply_stack(cfg, prm, x, positions=positions,
                            window=window if window is not None
                            else cfg.window, train=train)
    return _logits(cfg, prm, x[:, n_front:]), aux


def encode_step(cfg, prm, batch: Dict[str, torch.Tensor]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Encoder-only forward (HuBERT): bidirectional, no cache."""
    return forward(cfg, prm, batch, train=False)


# ---------------------------------------------------------------------------
# Cache
# ---------------------------------------------------------------------------

def init_cache(cfg, batch: int, cache_len: int, device) -> Dict[str, Any]:
    """Each leaf in the JAX package's type: keys and values zeroed in the
    config's dtype; ``kpos`` (int32) −1 for every slot (empty); the
    recurrent states (the SSM's ``h`` and ``conv``, the xLSTM's) in f32,
    zeroed except the xLSTM stabiliser ``m``, −1e30 (the exp-gating
    floor)."""
    t = cache_template(cfg, batch, cache_len)

    def leaf(path, m):
        if path[-1] == "kpos":
            return torch.full(m.shape, -1, dtype=torch.int32, device=device)
        if path[-1] == "m":
            return torch.full(m.shape, -1e30, dtype=torch.float32,
                              device=device)
        dtype = _dtype(cfg) if path[-1] in ("k", "v") else torch.float32
        return torch.zeros(m.shape, dtype=dtype, device=device)
    return P.tree_map(leaf, t)


# ---------------------------------------------------------------------------
# Prefill / decode
# ---------------------------------------------------------------------------

def prefill(cfg, prm, batch: Dict[str, torch.Tensor], *, cache_len: int,
            window: Optional[int] = None) -> Tuple[torch.Tensor, Any]:
    """Process a prompt, build the decode cache.  Returns
    (last-token logits (B, Vp), cache)."""
    if cfg.encoder_only:
        raise ValueError(f"{cfg.name} is encoder-only: no decode path")
    x, _ = _inputs(cfg, prm, batch)
    B, S = x.shape[:2]
    positions = torch.arange(S, device=x.device)
    cache = init_cache(cfg, B, cache_len, x.device)
    x, cache, _ = apply_stack(cfg, prm, x, positions=positions, cache=cache,
                              window=window if window is not None
                              else cfg.window)
    kpos = cache.get("kpos")                 # None: no attention
    sc = cache_len
    if kpos is not None and sc >= S:
        kpos[:S] = torch.arange(S, dtype=torch.int32, device=x.device)
    elif kpos is not None:                   # ring holds the tail, rolled
        kpos[:] = torch.roll(
            torch.arange(S - sc, S, dtype=torch.int32, device=x.device),
            (S - sc) % sc)
    logits = _logits(cfg, prm, x[:, -1:])[:, 0]
    return logits, cache


def decode_step(cfg, prm, cache, token: torch.Tensor, pos: int, *,
                window: Optional[int] = None) -> Tuple[torch.Tensor, Any]:
    """One autoregressive step.  token (B,) int; pos the absolute position
    of this token.  Writes the step into ``cache`` in place and returns
    (logits (B, Vp), cache)."""
    if cfg.encoder_only:
        raise ValueError(f"{cfg.name} is encoder-only: no decode path")
    if cfg.frontend == "audio":
        raise ValueError(f"{cfg.name}: an audio arch is encoder-only")
    x = _embed(cfg, prm, token[:, None])
    pos = int(pos)
    kpos, slot = cache.get("kpos"), None
    if kpos is not None:
        slot = pos % kpos.shape[0]
        kpos[slot] = pos
    positions = torch.full((1,), pos, dtype=torch.int32, device=x.device)
    x, cache, _ = apply_stack(cfg, prm, x, positions=positions, cache=cache,
                              kpos=kpos, slot=slot,
                              window=window if window is not None
                              else cfg.window)
    return _logits(cfg, prm, x)[:, 0], cache
