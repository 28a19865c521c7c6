"""Token-level losses over the padded-vocabulary logits.

The port of the JAX package's ``train/losses.py``: the vocabulary padding
(:func:`repro_torch.sharding.rules.padded_vocab`) is masked to −1e30
before the softmax, so the normaliser runs over the real classes only.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def _mask_pad(logits: torch.Tensor, vocab_size: int) -> torch.Tensor:
    vp = logits.shape[-1]
    if vp == vocab_size:
        return logits
    keep = torch.arange(vp, device=logits.device) < vocab_size
    return torch.where(keep, logits, torch.full((), -1e30,
                                                dtype=logits.dtype,
                                                device=logits.device))


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  vocab_size: int,
                  label_mask: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean cross-entropy over the (B, S) tokens, in float32.  Returns
    (loss, denominator)."""
    lf = _mask_pad(logits.float(), vocab_size)
    logz = torch.logsumexp(lf, dim=-1)
    gold = lf.gather(-1, labels[..., None].long())[..., 0]
    nll = logz - gold
    if label_mask is None:
        label_mask = torch.ones_like(nll)
    denom = torch.clamp_min(torch.sum(label_mask), 1.0)
    return torch.sum(nll * label_mask) / denom, denom


@torch.no_grad()
def token_accuracy(logits: torch.Tensor, labels: torch.Tensor,
                   vocab_size: int) -> torch.Tensor:
    """Share of tokens whose argmax over the real classes is the label.
    The argmax runs on the logits' own dtype over ``[:vocab_size]``: the
    float32 cast is exact and the padding never wins, so it is the
    JAX package's argmax without a float32 copy of the logits."""
    pick = logits[..., :vocab_size].argmax(-1)
    return (pick == labels).float().mean()
