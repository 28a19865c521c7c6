"""The model zoo's kernels behind one call each.

  * :func:`attention`   — GQA attention in the (B, S, H, D) layout,
    through the flash-attention kernel (``csrc/flash_attention.cu``); when
    a gradient is asked for, through a ``torch.autograd.Function`` whose
    backward launches the backward kernel of the same source.
  * :func:`topk_gating` — softmax → top-k → renormalise router gating,
    through the gating kernel (``csrc/moe_gating.cu``); under grad its
    backward launches the gating backward kernel of the same source.
  * :func:`ssm_scan`    — the diagonal selective scan of a Mamba2 block,
    through the scan kernel (``csrc/ssm_scan.cu``); under grad the
    forward also writes the state before every tile of 16 steps, and its
    backward launches the scan's backward kernel of the same source,
    which takes each tile's states again from there.
  * :func:`slstm_scan`  — xLSTM's sLSTM recurrence, through the sLSTM
    kernel (``csrc/slstm_scan.cu``, one persistent grid a call); under
    grad the forward also writes each step's pre-activations and state,
    and its backward launches the reverse sweep of the same source.

As in :mod:`.lasso_cd`: tensors on the CPU take the plain version
(:mod:`.ref`; autograd differentiates it); CUDA tensors launch the
kernel or raise, with no plain fallback.  Each launch adds one to
:data:`LAUNCHES`, so a run can show that it went through the kernels:
a backward counts under its own name (``*_bwd``).
"""
from __future__ import annotations

from typing import Optional

import torch

from . import flash_attention as _fa
from . import moe_gating as _mg
from . import slstm_scan as _sl
from . import ssm_scan as _ss
from .ref import (attention_ref, slstm_param_grads, slstm_scan_bwd_ref,
                  slstm_scan_ref, ssm_scan_ref, topk_gating_ref)

#: kernel name → launches since the last :func:`reset_launch_counts`
LAUNCHES = {"flash_attention": 0, "flash_attention_bwd": 0,
            "topk_gating": 0, "topk_gating_bwd": 0, "ssm_scan": 0,
            "ssm_scan_bwd": 0, "slstm_scan": 0, "slstm_scan_bwd": 0}


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


class _TopkGating(torch.autograd.Function):
    """The gating kernel, and for dlogits the backward kernel; ``idx``
    carries no gradient."""

    @staticmethod
    def forward(ctx, logits, k):
        probs, idx = _mg.topk_gating(logits, k)
        LAUNCHES["topk_gating"] += 1
        ctx.save_for_backward(logits, idx, probs)
        ctx.mark_non_differentiable(idx)
        return probs, idx

    @staticmethod
    def backward(ctx, dprobs, _didx):
        logits, idx, probs = ctx.saved_tensors
        dlogits = _mg.topk_gating_bwd(logits, idx, probs,
                                      dprobs.float().contiguous())
        LAUNCHES["topk_gating_bwd"] += 1
        return dlogits, None


def topk_gating(logits: torch.Tensor, k: int):
    """(T, E) logits → (probs (T, k) f32, idx (T, k) int32).  See
    :func:`.ref.topk_gating_ref`.  On CUDA, when grad is enabled and the
    logits require it, probs carries a ``grad_fn`` whose backward is the
    backward kernel (one count of ``topk_gating_bwd`` a call)."""
    if _on_cpu(logits):
        return topk_gating_ref(logits, k)
    if _needs_grad(logits):
        return _TopkGating.apply(logits, k)
    out = _mg.topk_gating(logits, k)
    LAUNCHES["topk_gating"] += 1
    return out


class _SsmScan(torch.autograd.Function):
    """The scan kernel writing its tile boundaries' states, and the
    backward kernel from them.  ``dh`` is None when the caller drops the
    final state."""

    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm, h0):
        y, h, states = _ss.ssm_scan(x, dt, A, Bm, Cm, h0, save_states=True)
        LAUNCHES["ssm_scan"] += 1
        ctx.save_for_backward(x, dt, A, Bm, Cm, h0, states)
        ctx.set_materialize_grads(False)
        return y, h

    @staticmethod
    def backward(ctx, dy, dh):
        x, dt, A, Bm, Cm, h0, states = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(x)
        elif dy.dtype != x.dtype or dy.stride(-1) != 1:
            dy = dy.to(x.dtype).contiguous()
        if dh is not None:
            dh = dh.float().contiguous()
        grads = _ss.ssm_scan_bwd(x, dt, A, Bm, Cm, h0, states, dy, dh)
        LAUNCHES["ssm_scan_bwd"] += 1
        return grads


def ssm_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             Bm: torch.Tensor, Cm: torch.Tensor,
             h0: Optional[torch.Tensor] = None):
    """x, dt (B, S, C); A (C,); Bm, Cm (B, S, N); h0 (B, C, N) or None →
    (y (B, S, C) in x.dtype, h (B, C, N) f32).  See
    :func:`.ref.ssm_scan_ref`.  On CUDA, when grad is enabled and an input
    requires it, the outputs carry a ``grad_fn`` whose backward is the
    backward kernel (one count of ``ssm_scan_bwd`` a call)."""
    xs = (x, dt, A, Bm, Cm) + (() if h0 is None else (h0,))
    if _on_cpu(*xs):
        return ssm_scan_ref(x, dt, A, Bm, Cm, h0)
    if _needs_grad(*xs):
        return _SsmScan.apply(x, dt, A, Bm, Cm, h0)
    out = _ss.ssm_scan(x, dt, A, Bm, Cm, h0)
    LAUNCHES["ssm_scan"] += 1
    return out


class _SlstmScan(torch.autograd.Function):
    """The sLSTM forward writing what its backward reads, and the
    reverse sweep; dW_r and dbias from the sweep's dG by one product and
    one sum.  ``plain`` runs the plain versions (:mod:`.ref`) in place
    of the kernels.  The state's four tensors are inputs and outputs of
    their own; the initial ones are None together."""

    @staticmethod
    def forward(ctx, plain, gx, wr, bias, c0, n0, m0, h0):
        state = None if c0 is None else (c0, n0, m0, h0)
        if plain:
            hs, final, saved = slstm_scan_ref(gx, wr, bias, state, save=True)
        else:
            hs, final, saved = _sl.slstm_scan(gx, wr, bias, state, save=True)
            LAUNCHES["slstm_scan"] += 1
        ctx.plain = plain
        ctx.save_for_backward(wr, hs, *saved, c0, n0, m0, h0)
        ctx.set_materialize_grads(False)
        return (hs,) + tuple(final)

    @staticmethod
    def backward(ctx, dhs, *dfinal):
        wr, hs, G, C, N, M, c0, n0, m0, h0 = ctx.saved_tensors
        state = None if c0 is None else (c0, n0, m0, h0)
        want = state is not None and any(ctx.needs_input_grad[4:])
        dhs = (torch.zeros_like(hs) if dhs is None
               else dhs.float().contiguous())
        dfinal = tuple(None if t is None else t.float().contiguous()
                       for t in dfinal)
        if ctx.plain:
            dG, dstate = slstm_scan_bwd_ref(wr, state, (G, C, N, M), dhs,
                                            dfinal)
        else:
            dG, dstate = _sl.slstm_scan_bwd(wr, state, (G, C, N, M), dhs,
                                            dfinal, want_dstate=want)
            LAUNCHES["slstm_scan_bwd"] += 1
        dwr, dbias = slstm_param_grads(dG, hs, h0)
        return (None, dG, dwr, dbias) + (tuple(dstate) if want
                                          else (None,) * 4)


def _slstm_args(gx, wr, bias, state):
    state = (None,) * 4 if state is None else tuple(
        t.float().contiguous() for t in state)
    return (gx.float().contiguous(), wr.float().contiguous(),
            bias.float().contiguous()) + state


def slstm_scan_plain(gx: torch.Tensor, wr: torch.Tensor, bias: torch.Tensor,
                     state: Optional[tuple] = None):
    """:func:`slstm_scan`'s plain version on any device: the plain
    forward (:func:`.ref.slstm_scan_ref`), and under grad the plain
    reverse sweep (:func:`.ref.slstm_scan_bwd_ref`) as its backward
    (autograd through the step loop would keep every step's graph)."""
    args = _slstm_args(gx, wr, bias, state)
    if _needs_grad(*(t for t in args if t is not None)):
        hs, *final = _SlstmScan.apply(True, *args)
        return hs, tuple(final)
    return slstm_scan_ref(*args[:3], None if state is None else args[3:])


def slstm_scan(gx: torch.Tensor, wr: torch.Tensor, bias: torch.Tensor,
               state: Optional[tuple] = None):
    """gx (B, S, 4d), wr (d, 4d), bias (4d,), state (c, n, m, h) each
    (B, d) or None (c = n = h = 0, m = −inf) → (hs (B, S, d) f32, the
    state after the last step), in float32.  See
    :func:`.ref.slstm_scan_ref`.  On CUDA, when grad is enabled and an
    input requires it, the outputs carry a ``grad_fn`` whose backward is
    the backward kernel (one count of ``slstm_scan_bwd`` a call)."""
    xs = (gx, wr, bias) + (() if state is None else tuple(state))
    if _on_cpu(*xs):
        return slstm_scan_plain(gx, wr, bias, state)
    args = _slstm_args(gx, wr, bias, state)
    if _needs_grad(*xs):
        hs, *final = _SlstmScan.apply(False, *args)
        return hs, tuple(final)
    out = _sl.slstm_scan(*args[:3], None if state is None else args[3:])
    LAUNCHES["slstm_scan"] += 1
    return out
