"""The model zoo's kernels behind one call each.

  * :func:`attention`   — GQA attention in the (B, S, H, D) layout,
    through the flash-attention kernel (``csrc/flash_attention.cu``); when
    a gradient is asked for, through a ``torch.autograd.Function`` whose
    backward launches the backward kernel of the same source.
  * :func:`topk_gating` — softmax → top-k → renormalise router gating,
    through the gating kernel (``csrc/moe_gating.cu``).
  * :func:`ssm_scan`    — the diagonal selective scan of a Mamba2 block,
    through the scan kernel (``csrc/ssm_scan.cu``).

As in :mod:`.lasso_cd`: tensors on the CPU take the plain version
(:mod:`.ref`); CUDA tensors launch the kernel or raise, with no plain
fallback.  Each launch adds one to :data:`LAUNCHES`, so a run can show
that it went through the kernels.  ``topk_gating`` and ``ssm_scan`` have
no backward kernel yet: on CUDA tensors that require a gradient they
raise rather than return outputs that would carry none.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import flash_attention as _fa
from . import moe_gating as _mg
from . import ssm_scan as _ss
from .ref import attention_ref, ssm_scan_ref, topk_gating_ref

#: kernel name → launches since the last :func:`reset_launch_counts`
LAUNCHES = {"flash_attention": 0, "flash_attention_bwd": 0,
            "topk_gating": 0, "ssm_scan": 0}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _on_cpu(*xs: torch.Tensor) -> bool:
    return all(x.device.type == "cpu" for x in xs)


def _needs_grad(*xs: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(x.requires_grad for x in xs)


def _t(x: torch.Tensor) -> torch.Tensor:
    return x.transpose(1, 2)


class _FlashAttention(torch.autograd.Function):
    """The forward kernel with its ``lse`` output, and the backward
    kernel for (dq, dk, dv); inputs and outputs in the (B, S, H, D)
    layout."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale):
        out, lse = _fa.flash_attention(_t(q), _t(k), _t(v), causal=causal,
                                       window=window, scale=scale,
                                       return_lse=True)
        LAUNCHES["flash_attention"] += 1
        out = _t(out)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.kw = {"causal": causal, "window": window, "scale": scale}
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        if dout.stride(-1) != 1:
            dout = dout.contiguous()
        dq, dk, dv = _fa.flash_attention_bwd(_t(q), _t(k), _t(v), _t(out),
                                             lse, _t(dout), **ctx.kw)
        LAUNCHES["flash_attention_bwd"] += 1
        return _t(dq), _t(dk), _t(dv), None, None, None


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: Optional[int] = None,
              scale: Optional[float] = None) -> torch.Tensor:
    """q (B, Sq, Hq, D); k, v (B, Skv, Hkv, D) → (B, Sq, Hq, D) in
    q.dtype.  See :func:`.ref.attention_ref` for the semantics.  On CUDA,
    when grad is enabled and an input requires it, the output carries a
    ``grad_fn`` whose backward is the backward kernel (one count of
    ``flash_attention_bwd`` a call)."""
    if _on_cpu(q, k, v):
        return attention_ref(q, k, v, causal=causal, window=window,
                             scale=scale)
    if _needs_grad(q, k, v):
        return _FlashAttention.apply(q, k, v, causal, window, scale)
    out = _fa.flash_attention(_t(q), _t(k), _t(v), causal=causal,
                              window=window, scale=scale)
    LAUNCHES["flash_attention"] += 1
    return _t(out)


def _refuse_grad(name: str, *xs: torch.Tensor) -> None:
    if _needs_grad(*xs):
        raise NotImplementedError(
            f"{name}: the CUDA kernel has no backward yet, so its output "
            f"would carry no gradient (ROADMAP.md queue 2, the backward "
            f"kernels of {name}); call it under torch.no_grad()")


def topk_gating(logits: torch.Tensor, k: int):
    """(T, E) logits → (probs (T, k) f32, idx (T, k) int32).  See
    :func:`.ref.topk_gating_ref`."""
    if _on_cpu(logits):
        return topk_gating_ref(logits, k)
    _refuse_grad("topk_gating", logits)
    out = _mg.topk_gating(logits, k)
    LAUNCHES["topk_gating"] += 1
    return out


def ssm_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             Bm: torch.Tensor, Cm: torch.Tensor,
             h0: Optional[torch.Tensor] = None):
    """x, dt (B, S, C); A (C,); Bm, Cm (B, S, N); h0 (B, C, N) or None →
    (y (B, S, C) in x.dtype, h (B, C, N) f32).  See
    :func:`.ref.ssm_scan_ref`."""
    xs = (x, dt, A, Bm, Cm) + (() if h0 is None else (h0,))
    if _on_cpu(*xs):
        return ssm_scan_ref(x, dt, A, Bm, Cm, h0)
    _refuse_grad("ssm_scan", *xs)
    out = _ss.ssm_scan(x, dt, A, Bm, Cm, h0)
    LAUNCHES["ssm_scan"] += 1
    return out
