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
from typing import Dict, Iterator

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


def make_batch(cfg: SyntheticLMConfig, step: int,
               device="cpu") -> Dict[str, torch.Tensor]:
    """``{"tokens": (B, S), "labels": (B, S)}`` int64 for one step,
    labels the tokens shifted by one."""
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
    return {"tokens": seq[:, :-1], "labels": seq[:, 1:]}


def synthetic_batches(cfg: SyntheticLMConfig, **kw
                      ) -> Iterator[Dict[str, torch.Tensor]]:
    """The trainer-facing batch iterator — a thin walk over
    :class:`repro_torch.stream.source.SyntheticLMSource`, so the streaming
    subsystem's DataSource and this generator share one batch-derivation
    path (same ``(seed, step)`` schedule, same deltas).  ``kw`` goes to
    :func:`make_batch` (``device=``)."""
    from ..stream.source import SyntheticLMSource
    src = SyntheticLMSource(cfg, kwargs=kw or None)
    step = 0
    while True:
        for delta in src.take(step):
            yield delta["data"]
        step += 1
