"""Mamba2-style selective-state-space block (SSD), built on the selective
scan kernel (:func:`repro_torch.kernels.ops.ssm_scan`).

The port of the JAX package's ``models/ssm.py``.  Block layout
(simplified Mamba2, n_groups = 1):
    in_proj: d → [z (d_inner), x (d_inner), B (N), C (N), dt (n_heads)]
    depthwise causal conv (width ssm_conv) over [x, B, C]
    selective scan: h_t = exp(dt·A)·h_{t−1} + (dt·x_t)⊗B_t ; y_t = ⟨h_t,C_t⟩
    gate: y · silu(z), RMS-normed, out_proj d_inner → d

:func:`ssm_apply` keeps the JAX package's three branches: a one-token
step with a state (decode) updates the state inline; otherwise
``ssm_impl="ssd"`` takes the chunked matmul form :func:`ssd_chunked`,
which falls back to the scan kernel when the sequence does not split
into whole chunks of ``min(128, S)`` (a prompt longer than 128 tokens
and not a multiple of 128); ``ssm_impl="scan"`` always takes the kernel.
Types as in the JAX package: ``dt`` is cast to the activation type
before the kernel, A stays f32, the state ``h`` is f32.  Training
differentiates both forms: the SSD form is plain tensor code under
autograd, and on the card the scan's backward is the scan's backward
kernel (:func:`repro_torch.kernels.ops.ssm_scan`).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..kernels import ops
from .layers import BATCH, FSDP, TENSOR, apply_norm, norm_template
from .params import ParamMeta

SSM_HEAD_DIM = 64


def _dims(cfg):
    d_inner = cfg.ssm_expand * cfg.d_model
    n_heads = d_inner // SSM_HEAD_DIM
    conv_ch = d_inner + 2 * cfg.ssm_state
    return d_inner, n_heads, conv_ch


def ssm_template(cfg) -> Dict[str, Any]:
    d = cfg.d_model
    N = cfg.ssm_state
    d_inner, n_heads, conv_ch = _dims(cfg)
    return {
        "norm": norm_template(cfg),
        "wz": ParamMeta((d, d_inner), (FSDP, TENSOR)),
        "wx": ParamMeta((d, d_inner), (FSDP, TENSOR)),
        "wB": ParamMeta((d, N), (FSDP, None)),
        "wC": ParamMeta((d, N), (FSDP, None)),
        "wdt": ParamMeta((d, n_heads), (FSDP, TENSOR)),
        "dt_bias": ParamMeta((n_heads,), (TENSOR,), "ssm_dt"),
        "A_log": ParamMeta((n_heads,), (TENSOR,), "ssm_a"),
        "conv_w": ParamMeta((cfg.ssm_conv, conv_ch), (None, None),
                            scale=cfg.ssm_conv ** -0.5),
        "conv_b": ParamMeta((conv_ch,), (None,), "zeros"),
        "gnorm": ParamMeta((d_inner,), (TENSOR,), "ones"),
        "wo": ParamMeta((d_inner, d), (TENSOR, FSDP)),
    }


def _proj(p, h, cfg):
    """Shared projections.  h (B,S,d) → z, xc (pre-conv [x,B,C]), dt (f32)."""
    z = h @ p["wz"].to(h.dtype)
    x = h @ p["wx"].to(h.dtype)
    Bm = h @ p["wB"].to(h.dtype)
    Cm = h @ p["wC"].to(h.dtype)
    dt = h @ p["wdt"].to(h.dtype)
    dt = F.softplus(dt.float() + p["dt_bias"].float())
    xc = torch.cat([x, Bm, Cm], dim=-1)
    return z, xc, dt


def _split_conv(xc, cfg, d_inner):
    N = cfg.ssm_state
    return (xc[..., :d_inner], xc[..., d_inner:d_inner + N],
            xc[..., d_inner + N:])


def _causal_conv(xc, w, b, conv_state: Optional[torch.Tensor]):
    """Depthwise causal conv.  xc (B,S,C); w (W,C).  conv_state (B,W−1,C)
    is the trailing window from the previous segment (zeros at start).
    A sum of W shifted products, as the JAX package computes it (not
    ``F.conv1d``, which runs f32 through cuDNN in TF32 on the card)."""
    W = w.shape[0]
    if conv_state is None:
        pad = torch.zeros((xc.shape[0], W - 1, xc.shape[-1]), dtype=xc.dtype,
                          device=xc.device)
    else:
        pad = conv_state.to(xc.dtype)
    full = torch.cat([pad, xc], dim=1)
    S = xc.shape[1]
    out = full[:, 0:S] * w[0].to(xc.dtype)
    for i in range(1, W):
        out = out + full[:, i:i + S] * w[i].to(xc.dtype)
    out = F.silu(out + b.to(xc.dtype))
    new_state = full[:, full.shape[1] - (W - 1):]
    return out, new_state


def _expand_heads(v):
    """(..., n_heads) → (..., d_inner) by per-head broadcast."""
    return torch.repeat_interleave(v, SSM_HEAD_DIM, dim=-1)


def ssm_apply(p: Dict[str, Any], x: torch.Tensor, cfg, *,
              state: Optional[Dict[str, torch.Tensor]] = None,
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Pre-norm Mamba2 block (residual included).

    Prefill / forward: ``state`` None or a zero state → the scan from
    that state (the final state is returned so prefill can seed decode).
    Decode: ``x`` is (B,1,d); pass the carried ``state`` dict
    {"h": (B,C,N) f32, "conv": (B,W−1,Ch)}.  Returns (x, new_state); the
    caller writes the new state where it keeps it.
    """
    d_inner = _dims(cfg)[0]
    h_res = x
    hin = apply_norm(p["norm"], x, cfg)
    z, xc, dt = _proj(p, hin, cfg)
    conv_state = None if state is None else state["conv"]
    xc, new_conv = _causal_conv(xc, p["conv_w"], p["conv_b"], conv_state)
    xs, Bm, Cm = _split_conv(xc, cfg, d_inner)
    A = -torch.exp(p["A_log"].float())                      # (n_heads,) < 0
    step = x.shape[1] == 1 and state is not None
    ssd = cfg.ssm_impl == "ssd" and not step
    if not ssd:
        A_full = _expand_heads(A)
        dt_full = _expand_heads(dt)

    h0 = None if state is None else state["h"]
    if step:                                                # decode: 1 step
        a = torch.exp(dt_full[:, 0] * A_full[None, :])      # (B,C)
        inp = (dt_full[:, 0] * xs[:, 0].float())[:, :, None] \
            * Bm[:, 0].float()[:, None, :]
        h_new = a[:, :, None] * h0 + inp                    # (B,C,N)
        y = torch.einsum("bcn,bn->bc", h_new, Cm[:, 0].float())[:, None]
        y = y.to(x.dtype)
    elif ssd:
        y, h_new = ssd_chunked(xs, dt, A, Bm, Cm, h0)
    else:
        y, h_new = _chunked_ssm_scan(xs, dt_full.to(xs.dtype), A_full,
                                     Bm, Cm, h0)
    y = y * F.silu(z)
    y = rms_gnorm(y, p["gnorm"], cfg.norm_eps)
    out = y @ p["wo"].to(y.dtype)
    return h_res + out, {"h": h_new, "conv": new_conv}


def ssd_chunked(xs, dt, A, Bm, Cm, h0, head_dim: int = SSM_HEAD_DIM,
                chunk: int = 128):
    """Mamba2 SSD: the chunked *matmul* form of the diagonal selective
    scan (arXiv:2405.21060 §6), plain tensor code as in the JAX package.

    Exploits decay being per head (A/dt broadcast across each head's
    channels): per chunk, per head (L the cumulative log decay),
        y_intra = (mask ∘ exp(L_t − L_r) ∘ (C_t·B_r)) @ u
        y_inter = exp(L_t) · (C_t · h_prev)
        h_next  = exp(L_last − L_r) weighted Σ u_r ⊗ B_r + exp(L_last)·h_prev
    When S does not split into chunks of ``min(chunk, S)`` it falls back
    to the scan kernel.  Shapes as in :func:`..kernels.ref.ssm_scan_ref`;
    returns (y (B,S,C), h_final (B,C,N) f32)."""
    B, S, C = xs.shape
    N = Bm.shape[-1]
    H = C // head_dim
    Lc = min(chunk, S)
    f32 = torch.float32
    # dt/A may arrive per channel (broadcast) or per head; take them per
    # head without making the (B,S,d_inner) expansion
    if dt.shape[-1] == C:
        dt_h = dt.float().reshape(B, S, H, head_dim)[..., 0]
    else:
        dt_h = dt.float()                                        # (B,S,H)
    A_h = (A.float().reshape(H, head_dim)[:, 0] if A.shape[-1] == C
           else A.float())                                       # (H,)
    if S % Lc:
        dt_c = torch.repeat_interleave(dt_h, head_dim, dim=-1).to(xs.dtype)
        A_c = torch.repeat_interleave(A_h, head_dim)
        return _chunked_ssm_scan(xs, dt_c, A_c, Bm, Cm, h0)
    nc = S // Lc
    loga = dt_h * A_h                                            # (B,S,H) <0
    u = (dt_h[..., None] * xs.float().reshape(B, S, H, head_dim)
         ).reshape(B, nc, Lc, H, head_dim)
    Bc = Bm.float().reshape(B, nc, Lc, N)
    Cc = Cm.float().reshape(B, nc, Lc, N)
    la = loga.reshape(B, nc, Lc, H)
    Lcum = torch.cumsum(la, dim=2)                               # (B,nc,Lc,H)

    # intra-chunk: M[t,r] = exp(Lcum_t − Lcum_r) · (C_t·B_r) · mask(r ≤ t).
    # The exponent is summed segment by segment, Σ_{k=r+1..t} la_k, and
    # not taken as the difference of two cumulative sums: where dt·A is
    # large (−300 a step at the reference's init) Lcum runs to −4·10⁴
    # within a chunk and the difference of two such f32 values loses the
    # digits that exp needs.  Same function, ~60× closer to the
    # step-by-step scan than the JAX package's difference form there.
    cb = torch.einsum("bgtn,bgrn->bgtr", Cc, Bc)                 # (B,nc,t,r)
    tri = torch.ones((Lc, Lc), dtype=torch.bool, device=xs.device)
    below = torch.tril(tri, -1)[None, None, :, :, None]          # r < t
    ldiff = torch.cumsum(la[:, :, :, None, :].expand(B, nc, Lc, Lc, H)
                         .masked_fill(~below, 0.0), dim=2)       # (B,nc,t,r,H)
    mask = torch.tril(tri)[None, None, :, :, None]               # r ≤ t
    # mask the exponent before exp: the upper triangle is not a segment
    M = torch.exp(ldiff.masked_fill(~mask, -1e30)) * cb[..., None]
    y_intra = torch.einsum("bgtrh,bgrhd->bgthd", M, u)

    # inter-chunk: the sequential (nc steps) state recurrence
    decay_tail = torch.exp(ldiff[:, :, -1])          # exp(L_last − L_r)
    uB = torch.einsum("bgrhd,bgrn,bgrh->bghdn", u, Bc, decay_tail)
    chunk_decay = torch.exp(Lcum[:, :, -1, :])                   # (B,nc,H)

    h = (torch.zeros((B, H, head_dim, N), dtype=f32, device=xs.device)
         if h0 is None else h0.float().reshape(B, H, head_dim, N))
    h_prevs = []
    for g in range(nc):
        h_prevs.append(h)
        h = chunk_decay[:, g, :, None, None] * h + uB[:, g]
    h_prevs = torch.stack(h_prevs, dim=1)                        # (B,nc,...)

    y_inter = torch.einsum("bgtn,bghdn,bgth->bgthd",
                           Cc, h_prevs, torch.exp(Lcum))
    y = (y_intra + y_inter).reshape(B, S, C).to(xs.dtype)
    return y, h.reshape(B, C, N)


def _chunked_ssm_scan(xs, dt, A, Bm, Cm, h0):
    """The selective scan over the whole sequence in one kernel call.

    The JAX package splits S into ``default_chunk(S)`` pieces under
    ``jax.checkpoint`` to bound the memory of *autodiff*: only the state
    at each piece's boundary is kept, and each piece's steps are taken
    again in the backward.  Here the kernel does that job itself: under
    grad its forward writes the state before every tile of 16 steps, and
    its backward kernel takes each tile's states again from there.  The
    recurrence is the same step for step and h is f32 in both, so one
    call gives the same y and h, with one launch instead of one a
    piece."""
    return ops.ssm_scan(xs, dt, A, Bm, Cm, h0)


def rms_gnorm(y: torch.Tensor, scale: torch.Tensor, eps: float
              ) -> torch.Tensor:
    yf = y.float()
    var = yf.square().mean(-1, keepdim=True)
    return (yf * torch.rsqrt(var + eps)).to(y.dtype) * scale


def ssm_state_template(cfg, batch: int) -> Dict[str, ParamMeta]:
    d_inner, _, conv_ch = _dims(cfg)
    return {
        "h": ParamMeta((batch, d_inner, cfg.ssm_state),
                       (BATCH, TENSOR, None), "zeros"),
        "conv": ParamMeta((batch, cfg.ssm_conv - 1, conv_ch),
                          (BATCH, None, None), "zeros"),
    }
