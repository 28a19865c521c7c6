"""The model zoo's kernels behind one call each.

  * :func:`attention`   — GQA attention in the (B, S, H, D) layout,
    through the flash-attention kernel (``csrc/flash_attention.cu``).
  * :func:`topk_gating` — softmax → top-k → renormalise router gating,
    through the gating kernel (``csrc/moe_gating.cu``).
  * :func:`ssm_scan`    — the diagonal selective scan of a Mamba2 block,
    through the scan kernel (``csrc/ssm_scan.cu``).

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
from . import ssm_scan as _ss
from .ref import attention_ref, ssm_scan_ref, topk_gating_ref

#: kernel name → launches since the last :func:`reset_launch_counts`
LAUNCHES = {"flash_attention": 0, "topk_gating": 0, "ssm_scan": 0}


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


def ssm_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             Bm: torch.Tensor, Cm: torch.Tensor,
             h0: Optional[torch.Tensor] = None):
    """x, dt (B, S, C); A (C,); Bm, Cm (B, S, N); h0 (B, C, N) or None →
    (y (B, S, C) in x.dtype, h (B, C, N) f32).  See
    :func:`.ref.ssm_scan_ref`."""
    if _on_cpu(x, dt, A, Bm, Cm, *(() if h0 is None else (h0,))):
        return ssm_scan_ref(x, dt, A, Bm, Cm, h0)
    out = _ss.ssm_scan(x, dt, A, Bm, Cm, h0)
    LAUNCHES["ssm_scan"] += 1
    return out
