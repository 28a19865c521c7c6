"""The model zoo's kernels behind one call each.

  * :func:`attention`   — GQA attention in the (B, S, H, D) layout,
    through the flash-attention kernel (``csrc/flash_attention.cu``).
  * :func:`topk_gating` — softmax → top-k → renormalise router gating,
    through the gating kernel (``csrc/moe_gating.cu``).

As in :mod:`.lasso_cd`: tensors on the CPU take the plain version
(:mod:`.ref`); CUDA tensors launch the kernel or raise, with no plain
fallback.  Each launch adds one to :data:`LAUNCHES`, so a run can show
that it went through the kernels.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import flash_attention as _fa
from . import moe_gating as _mg
from .ref import attention_ref, topk_gating_ref

#: kernel name → launches since the last :func:`reset_launch_counts`
LAUNCHES = {"flash_attention": 0, "topk_gating": 0}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _on_cpu(*xs: torch.Tensor) -> bool:
    return all(x.device.type == "cpu" for x in xs)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: Optional[int] = None,
              scale: Optional[float] = None) -> torch.Tensor:
    """q (B, Sq, Hq, D); k, v (B, Skv, Hkv, D) → (B, Sq, Hq, D) in
    q.dtype.  See :func:`.ref.attention_ref` for the semantics."""
    if _on_cpu(q, k, v):
        return attention_ref(q, k, v, causal=causal, window=window,
                             scale=scale)
    out = _fa.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                              v.transpose(1, 2), causal=causal,
                              window=window, scale=scale)
    LAUNCHES["flash_attention"] += 1
    return out.transpose(1, 2)


def topk_gating(logits: torch.Tensor, k: int):
    """(T, E) logits → (probs (T, k) f32, idx (T, k) int32).  See
    :func:`.ref.topk_gating_ref`."""
    if _on_cpu(logits):
        return topk_gating_ref(logits, k)
    out = _mg.topk_gating(logits, k)
    LAUNCHES["topk_gating"] += 1
    return out
