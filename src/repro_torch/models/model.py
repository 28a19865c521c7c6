"""Public model API: ``init_params`` / ``forward`` / ``init_cache`` /
``prefill`` / ``decode_step``.

The port of the JAX package's ``models/model.py`` for the text path of
the dense, MoE and hybrid families.  Every function takes the
:class:`repro_torch.configs.base.ModelConfig` explicitly; parameters are
nested dicts built from :func:`transformer.stack_template`, on the device
:func:`init_params` put them on.  The vision and audio frontends are not
ported yet.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from . import params as P
from .layers import apply_norm
from .transformer import apply_stack, cache_template, stack_template


def _dtype(cfg) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _check_frontend(cfg) -> None:
    if cfg.frontend is not None:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.frontend} frontend is not ported yet "
            f"(ROADMAP.md queue 1 step 13c)")


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
    """Token embeddings: (x (B, S, d), n_frontend = 0)."""
    _check_frontend(cfg)
    return _embed(cfg, prm, batch["tokens"]), 0


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def forward(cfg, prm, batch: Dict[str, torch.Tensor], *, train: bool = False,
            window: Optional[int] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward.  Returns (logits (B, S, Vp), aux_loss).
    ``train=True`` checkpoints each layer group (the same values)."""
    x, _ = _inputs(cfg, prm, batch)
    positions = torch.arange(x.shape[1], device=x.device)
    x, _, aux = apply_stack(cfg, prm, x, positions=positions,
                            window=window if window is not None
                            else cfg.window, train=train)
    return _logits(cfg, prm, x), aux


# ---------------------------------------------------------------------------
# Cache
# ---------------------------------------------------------------------------

def init_cache(cfg, batch: int, cache_len: int, device) -> Dict[str, Any]:
    """Each leaf in the JAX package's type: keys and values zeroed in the
    config's dtype; ``kpos`` (int32) −1 for every slot (empty); the
    recurrent states (the SSM's ``h`` and ``conv``) zeroed in f32."""
    t = cache_template(cfg, batch, cache_len)

    def leaf(path, m):
        if path[-1] == "kpos":
            return torch.full(m.shape, -1, dtype=torch.int32, device=device)
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
    sc = cache_len
    if sc >= S:
        cache["kpos"][:S] = torch.arange(S, dtype=torch.int32,
                                         device=x.device)
    else:                                    # ring holds the tail, rolled
        cache["kpos"][:] = torch.roll(
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
    _check_frontend(cfg)
    x = _embed(cfg, prm, token[:, None])
    pos = int(pos)
    kpos = cache["kpos"]
    slot = pos % kpos.shape[0]
    kpos[slot] = pos
    positions = torch.full((1,), pos, dtype=torch.int32, device=x.device)
    x, cache, _ = apply_stack(cfg, prm, x, positions=positions, cache=cache,
                              kpos=kpos, slot=slot,
                              window=window if window is not None
                              else cfg.window)
    return _logits(cfg, prm, x)[:, 0], cache
