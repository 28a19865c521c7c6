"""Deterministic synthetic token batches.

The recipe of the JAX package's ``data/pipeline.py``: tokens follow a
Zipf marginal with a bigram structure (``x_{t+1} = (x_t + 1) mod V`` on a
``structure`` share of the steps), so tiny models show a falling loss.
Everything is drawn from a ``torch.Generator`` seeded from
``(seed, step)``, so any batch can be made again anywhere.  The draws
differ from JAX's PRNG; tests that compare the two packages feed both the
same tokens.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class SyntheticLMConfig:
    vocab_size: int
    seq_len: int
    batch_size: int
    seed: int = 0
    zipf_a: float = 1.2          # marginal skew
    structure: float = 0.75      # fraction of deterministic bigram steps


def _zipf_probs(v: int, a: float) -> torch.Tensor:
    ranks = np.arange(1, v + 1, dtype=np.float64)
    p = ranks ** -a
    return torch.from_numpy(p / p.sum())


def make_batch(cfg: SyntheticLMConfig, step: int, device="cpu",
               d_model: Optional[int] = None, frontend_tokens: int = 0,
               frames: bool = False) -> Dict[str, torch.Tensor]:
    """``{"tokens": (B, S), "labels": (B, S)}`` int64 for one step,
    labels the tokens shifted by one.  ``frames=True``: audio-style
    frame embeddings ``"frames"`` (B, S, d_model) in place of the tokens;
    ``frontend_tokens=P``: vision patch embeddings ``"frontend"``
    (B, P, d_model) beside them.  Both are N(0, 0.02²) float32 draws made
    after the tokens', so the tokens and labels of a step do not depend
    on them."""
    gen = torch.Generator().manual_seed(cfg.seed * 1_000_003 + step)
    B, S, V = cfg.batch_size, cfg.seq_len + 1, cfg.vocab_size
    draws = torch.multinomial(_zipf_probs(V, cfg.zipf_a), B * S,
                              replacement=True, generator=gen).view(B, S)
    structured = torch.rand((B, S), generator=gen,
                            dtype=torch.float64) < cfg.structure
    # x_t = x_{t−1} + 1 on structured steps, else the fresh draw; the
    # step before t = 0 carries draws[:, 0].  So x_t is the last fresh
    # draw at or before t plus the steps since it (mod V).
    t = torch.arange(S).expand(B, S)
    last = torch.where(structured, -1, t).cummax(dim=1).values
    base = torch.where(last >= 0, draws.gather(1, last.clamp_min(0)),
                       draws[:, :1])
    seq = (base + torch.where(last >= 0, t - last, t + 1)) % V
    seq = seq.to(device)
    out = {"labels": seq[:, 1:]}
    if (frames or frontend_tokens) and d_model is None:
        raise ValueError("frames and frontend embeddings need d_model")
    if frames:
        out["frames"] = (torch.randn((B, cfg.seq_len, d_model),
                                     generator=gen) * 0.02).to(device)
    else:
        out["tokens"] = seq[:, :-1]
    if frontend_tokens:
        out["frontend"] = (torch.randn((B, frontend_tokens, d_model),
                                       generator=gen) * 0.02).to(device)
    return out


def frontend_batch_kwargs(cfg) -> Dict[str, object]:
    """:func:`make_batch`'s keyword arguments for a model config's
    frontend: frame embeddings for an audio arch, patch embeddings for a
    vision arch, none for a text-only one."""
    if cfg.frontend == "audio":
        return {"frames": True, "d_model": cfg.d_model}
    if cfg.frontend == "vision":
        return {"frontend_tokens": cfg.frontend_tokens,
                "d_model": cfg.d_model}
    return {}


def synthetic_batches(cfg: SyntheticLMConfig, **kw
                      ) -> Iterator[Dict[str, torch.Tensor]]:
    """The trainer-facing batch iterator — a thin walk over
    :class:`repro_torch.stream.source.SyntheticLMSource`, so the streaming
    subsystem's DataSource and this generator share one batch-derivation
    path (same ``(seed, step)`` schedule, same deltas).  ``kw`` goes to
    :func:`make_batch` (``device=``, and the frontend's ``d_model=``,
    ``frontend_tokens=``, ``frames=``)."""
    from ..stream.source import SyntheticLMSource
    src = SyntheticLMSource(cfg, kwargs=kw or None)
    step = 0
    while True:
        for delta in src.take(step):
            yield delta["data"]
        step += 1
