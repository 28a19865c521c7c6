"""xLSTM blocks (sLSTM + mLSTM) per arXiv:2405.04517, with exponential
gating and its stabiliser state.

The port of the JAX package's ``models/xlstm.py``.

* mLSTM — matrix memory C ∈ R^{H×hd×hd} updated with outer products
  k vᵀ, queried with q, parallel over heads; the ``proj_factor``
  up-projection wraps the cell (xLSTM-125M has d_ff = 0 because the FFN
  lives here).  A sequence runs in the chunkwise matmul form
  :func:`mlstm_chunkwise` when it splits into whole chunks, else as a
  scan of the one-step cell :func:`_mlstm_cell`; one token (decode) is
  the cell alone.
* sLSTM — scalar memory per (head, dim) with recurrent input from the
  previous hidden state: a sequential recurrence in float32.  On the card
  every call, one token (decode) or many, is one launch of the port's
  sLSTM kernel (:func:`repro_torch.kernels.ops.slstm_scan`, whose
  backward is a kernel too); elsewhere it is a Python loop of the cell
  over :func:`~.scan_utils.chunked_scan` (:func:`slstm_route`).

Matrix products are ``torch.matmul``; the sLSTM kernel is the only one of
the port's here (the JAX package's xLSTM reaches no Pallas kernel: its
sLSTM is a ``lax.scan``).  States are tuples (C, n, m) and (c, n, m, h)
in float32.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..kernels import ops
from .layers import BATCH, FSDP, TENSOR, apply_norm, norm_template
from .params import ParamMeta
from .scan_utils import chunked_scan
from .ssm import rms_gnorm


def _dims(cfg):
    d_inner = int(cfg.xlstm_proj_factor * cfg.d_model)
    H = cfg.num_heads
    hd = d_inner // H
    return d_inner, H, hd


def _maybe_checkpoint(fn, *args):
    """``fn(*args)``, checkpointed when grad is on (its intermediates made
    again in the backward), as the JAX package's ``jax.checkpoint``."""
    if torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

def mlstm_template(cfg) -> Dict[str, Any]:
    d = cfg.d_model
    d_inner, H, hd = _dims(cfg)
    return {
        "norm": norm_template(cfg),
        "wup": ParamMeta((d, d_inner), (FSDP, TENSOR)),
        "wgate": ParamMeta((d, d_inner), (FSDP, TENSOR)),
        "wq": ParamMeta((d_inner, d_inner), (FSDP, TENSOR)),
        "wk": ParamMeta((d_inner, d_inner), (FSDP, TENSOR)),
        "wv": ParamMeta((d_inner, d_inner), (FSDP, TENSOR)),
        "wif": ParamMeta((d_inner, 2 * H), (FSDP, None), scale=1e-2),
        "if_bias": ParamMeta((2 * H,), (None,), "zeros"),
        "onorm": ParamMeta((d_inner,), (TENSOR,), "ones"),
        "wdown": ParamMeta((d_inner, d), (TENSOR, FSDP)),
    }


def _mlstm_cell(q, k, v, i_gate, f_gate, state):
    """One recurrent step.  q, k, v (B, H, hd); gates (B, H)
    pre-activation; state = (C (B, H, hd, hd), n (B, H, hd), m (B, H))."""
    C, n, m = state
    logf = F.logsigmoid(f_gate)                           # log σ(f)
    m_new = torch.maximum(logf + m, i_gate)
    fa = torch.exp(logf + m - m_new)
    ia = torch.exp(i_gate - m_new)
    C = fa[..., None, None] * C + ia[..., None, None] * (
        k[..., :, None] * v[..., None, :])
    n = fa[..., None] * n + ia[..., None] * k
    num = torch.einsum("bhkv,bhk->bhv", C, q)
    # xLSTM eq. (21): max(|ñᵀq|, e^{−m}) in stabilised units — this is
    # max(|nᵀq|, 1) in actual units
    den = torch.maximum(torch.einsum("bhk,bhk->bh", n, q).abs(),
                        torch.exp(-m_new))
    h = num / den[..., None]
    return h, (C, n, m_new)


def _mlstm_chunk(C, n, m, qg, kg, vg, ic, Fc, gmx, Flast):
    """One chunk of :func:`mlstm_chunkwise`: the chunk's h (B, Lc, H, hd)
    and the state at its end, from the state at its start."""
    Lc = qg.shape[1]
    m_new = torch.maximum(Fc + m[:, None], Fc + gmx)      # (B, Lc, H)
    a = torch.exp(Fc + m[:, None] - m_new)                # inter scale
    Ft, it, mt = (t.transpose(1, 2) for t in (Fc, ic, m_new))  # (B, H, Lc)
    d = Ft[..., :, None] - Ft[..., None, :] + it[..., None, :] \
        - mt[..., :, None]                                # (B, H, t, r)
    mask = torch.ones((Lc, Lc), dtype=torch.bool, device=d.device).tril()
    D = torch.exp(d.masked_fill(~mask, -1e30))
    qh, kh, vh = (t.transpose(1, 2) for t in (qg, kg, vg))    # (B, H, Lc, hd)
    s_qk = qh @ kh.transpose(-1, -2)
    intra_h = (D * s_qk) @ vh
    intra_n = D @ kh
    ah = a.transpose(1, 2)[..., None]                     # (B, H, Lc, 1)
    num = intra_h + ah * (qh @ C)
    ntot = intra_n + ah * n[:, :, None, :]
    den = torch.maximum((ntot * qh).sum(-1).abs(), torch.exp(-mt))
    h = num / den[..., None]                              # (B, H, Lc, hd)
    # the chunk-end state
    m_end = m_new[:, -1]                                  # (B, H)
    a_end = torch.exp(Flast + m - m_end)
    w = torch.exp(Flast[:, None, :] - Fc + ic - m_end[:, None, :])
    wk = w.transpose(1, 2)[..., None] * kh                # (B, H, Lc, hd)
    C_new = a_end[..., None, None] * C + wk.transpose(-1, -2) @ vh
    n_new = a_end[..., None] * n + wk.sum(-2)
    return C_new, n_new, m_end, h.transpose(1, 2)


def mlstm_chunkwise(qf, kf, vf, ig, fg, state, chunk: int = 256):
    """Chunkwise-parallel mLSTM (TFLA-style): the matmul form of the
    matrix-memory recurrence with exp-gating stabilisation, numerically
    the sequential cell's.  qf/kf/vf (B, S, H, hd) f32; ig/fg (B, S, H)
    f32 pre-activations; state = (C, n, m).  Returns (h (B, S, H, hd),
    state), or ``None`` when S does not split into chunks of
    ``min(chunk, S)`` (the caller scans the cell instead).

    Per chunk, in stabilised units (actual = tilde · e^m):
        F_t  = Σ_{r≤t} log σ(f_r)       (cumulative log-forget)
        g_r  = i_r − F_r
        m_t  = max(F_t + m_prev, F_t + cummax_r≤t g_r)
        D_tr = exp(F_t − F_r + i_r − m_t) · [r ≤ t]
        h̃_t = (D ∘ qkᵀ) v + e^{F_t + m_prev − m_t} q C_prev
        ñ_t = D k + e^{F_t + m_prev − m_t} n_prev
        h_t  = h̃_t / max(|ñ_tᵀq_t|, e^{−m_t})
    Each chunk is checkpointed when grad is on (the JAX package's
    ``jax.checkpoint`` of its scan body)."""
    B, S, H, hd = qf.shape
    Lc = min(chunk, S)
    if S % Lc:
        return None
    nc = S // Lc
    resh = lambda a: a.reshape((B, nc, Lc) + a.shape[2:])
    q_c, k_c, v_c, i_c = resh(qf), resh(kf), resh(vf), resh(ig)
    logf = F.logsigmoid(resh(fg))                         # log σ(f)
    Fcum = torch.cumsum(logf, dim=2)                      # (B, nc, Lc, H)
    gmax = torch.cummax(i_c - Fcum, dim=2).values
    C, n, m = state
    hs = []
    for j in range(nc):
        C, n, m, h = _maybe_checkpoint(
            _mlstm_chunk, C, n, m, q_c[:, j], k_c[:, j], v_c[:, j],
            i_c[:, j], Fcum[:, j], gmax[:, j], Fcum[:, j, -1])
        hs.append(h)
    return torch.cat(hs, dim=1), (C, n, m)


def mlstm_apply(p: Dict[str, Any], x: torch.Tensor, cfg, *,
                state: Optional[Tuple] = None
                ) -> Tuple[torch.Tensor, Tuple]:
    """Pre-norm mLSTM block (residual included).  Returns (y, the state
    after the last step)."""
    B, S, d = x.shape
    d_inner, H, hd = _dims(cfg)
    hin = apply_norm(p["norm"], x, cfg)
    up = hin @ p["wup"].to(hin.dtype)
    gate = hin @ p["wgate"].to(hin.dtype)
    q = up @ p["wq"].to(up.dtype)
    k = (up @ p["wk"].to(up.dtype)) * hd ** -0.5
    v = up @ p["wv"].to(up.dtype)
    gf = (up @ p["wif"].to(up.dtype)).float() + p["if_bias"]
    qf, kf, vf = (t.reshape(B, S, H, hd).float() for t in (q, k, v))
    ig, fg = gf[..., :H], gf[..., H:]

    if state is None:
        state = (torch.zeros((B, H, hd, hd), device=x.device),
                 torch.zeros((B, H, hd), device=x.device),
                 torch.full((B, H), -torch.inf, device=x.device))
    if S == 1:
        h, state = _mlstm_cell(qf[:, 0], kf[:, 0], vf[:, 0], ig[:, 0],
                               fg[:, 0], state)
        hs = h[:, None]
    else:
        ck = mlstm_chunkwise(qf, kf, vf, ig, fg, state)
        if ck is not None:                                # matmul form
            hs, state = ck
        else:                                             # tiny/ragged S
            def step(carry, xt):
                h, carry = _mlstm_cell(*xt, carry)
                return carry, h
            state, hs = chunked_scan(step, state, tuple(
                t.transpose(0, 1) for t in (qf, kf, vf, ig, fg)))
            hs = hs.transpose(0, 1)                       # (B, S, H, hd)
    hflat = hs.reshape(B, S, d_inner).to(x.dtype)
    hflat = rms_gnorm(hflat, p["onorm"], cfg.norm_eps)
    out = hflat * F.silu(gate)
    return x + out @ p["wdown"].to(out.dtype), state


def mlstm_state_template(cfg, batch: int) -> Dict[str, ParamMeta]:
    _, H, hd = _dims(cfg)
    return {
        "C": ParamMeta((batch, H, hd, hd), (BATCH, None, None, None),
                       "zeros"),
        "n": ParamMeta((batch, H, hd), (BATCH, None, None), "zeros"),
        "m": ParamMeta((batch, H), (BATCH, None), "zeros"),
    }


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

def slstm_template(cfg) -> Dict[str, Any]:
    d = cfg.d_model
    return {
        "norm": norm_template(cfg),
        "wx": ParamMeta((d, 4 * d), (FSDP, TENSOR)),
        "wr": ParamMeta((d, 4 * d), (FSDP, TENSOR), scale=1e-2),
        "bias": ParamMeta((4 * d,), (None,), "zeros"),
        "wdown": ParamMeta((d, d), (TENSOR, FSDP)),
    }


def _slstm_cell(gx, wr, bias, state, d):
    """gx (B, 4d) input contribution; state = (c, n, m, h) each (B, d)."""
    c, n, m, h = state
    g = gx + h @ wr + bias                                # (B, 4d)
    zi, ii, fi, oi = g.split(d, dim=-1)
    z = torch.tanh(zi)
    o = torch.sigmoid(oi)
    logf = F.logsigmoid(fi)
    m_new = torch.maximum(logf + m, ii)
    fa = torch.exp(logf + m - m_new)
    ia = torch.exp(ii - m_new)
    c = fa * c + ia * z
    n = fa * n + ia
    h_new = o * c / torch.maximum(n, n.new_ones(()))
    return h_new, (c, n, m_new, h_new)


def slstm_route(device_type: str) -> str:
    """The path :func:`slstm_apply` takes: ``"kernel"`` (the sLSTM
    kernel, one launch a call whatever the sequence length) on the card,
    else ``"plain"`` (the cell in a Python loop)."""
    return "kernel" if device_type == "cuda" else "plain"


def slstm_apply(p: Dict[str, Any], x: torch.Tensor, cfg, *,
                state: Optional[Tuple] = None
                ) -> Tuple[torch.Tensor, Tuple]:
    """Pre-norm sLSTM block (residual included).  Returns (y, the state
    after the last step)."""
    B, S, d = x.shape
    hin = apply_norm(p["norm"], x, cfg)
    gx = (hin @ p["wx"].to(hin.dtype)).float()
    wr = p["wr"].float()
    bias = p["bias"].float()
    if slstm_route(x.device.type) == "kernel":
        hs, state = ops.slstm_scan(gx, wr, bias, state)
        y = hs.to(x.dtype) @ p["wdown"].to(x.dtype)
        return x + y, state
    if state is None:
        zeros = lambda: torch.zeros((B, d), device=x.device)
        state = (zeros(), zeros(),
                 torch.full((B, d), -torch.inf, device=x.device), zeros())
    if S == 1:
        h, state = _slstm_cell(gx[:, 0], wr, bias, state, d)
        hs = h[:, None]
    else:
        def step(carry, xt):
            h, carry = _slstm_cell(xt[0], wr, bias, carry, d)
            return carry, h
        state, hs = chunked_scan(step, state, (gx.transpose(0, 1),))
        hs = hs.transpose(0, 1)
    y = hs.to(x.dtype) @ p["wdown"].to(x.dtype)
    return x + y, state


def slstm_state_template(cfg, batch: int) -> Dict[str, ParamMeta]:
    d = cfg.d_model
    return {k: ParamMeta((batch, d), (BATCH, None), "zeros")
            for k in ("c", "n", "m", "h")}
