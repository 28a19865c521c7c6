"""Serving steps: batched prefill + autoregressive decode.

The port of the JAX package's ``train/serve.py``.  Where the JAX package
scans the decode steps inside one jitted program, the port runs them as
a Python loop of eager steps; the cache is updated in place.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from ..models import model as M


def make_prefill_step(cfg, cache_len: int, window: Optional[int] = None):
    def prefill_step(params, batch):
        return M.prefill(cfg, params, batch, cache_len=cache_len,
                         window=window)
    return prefill_step


def make_decode_step(cfg, window: Optional[int] = None):
    def decode_step(params, cache, token, pos):
        return M.decode_step(cfg, params, cache, token, pos, window=window)
    return decode_step


def greedy_generate(cfg, params, batch: Dict[str, torch.Tensor], *,
                    steps: int, cache_len: int,
                    window: Optional[int] = None,
                    generator: Optional[torch.Generator] = None,
                    temperature: float = 0.0) -> torch.Tensor:
    """Prefill, then ``steps`` decode steps; returns the (B, steps) int32
    tokens: the prefill's pick, then each decode step's but the last (the
    JAX package's schedule, so the last step's pick is dropped).  A vision
    arch's decode positions start after its frontend tokens.

    ``temperature > 0`` samples from ``generator`` (which lives on the
    logits' device); its draws differ from JAX's, so the two packages
    agree only for greedy decoding."""
    logits, cache = M.prefill(cfg, params, batch, cache_len=cache_len,
                              window=window)
    start = batch["tokens"].shape[1] + M.num_frontend_tokens(cfg)

    def pick(lg):
        lg = lg[:, :cfg.vocab_size].float()
        if temperature <= 0.0:
            return lg.argmax(-1).to(torch.int32)
        probs = torch.softmax(lg / temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=generator)[:, 0].to(
            torch.int32)

    tok = pick(logits)
    toks = []
    for i in range(steps):
        toks.append(tok)
        lg, cache = M.decode_step(cfg, params, cache, tok, start + i,
                                  window=window)
        tok = pick(lg)
    return torch.stack(toks, dim=1)
