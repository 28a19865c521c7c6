"""Plain PyTorch versions of the port's kernels.

They are the semantics contract for the CUDA kernels
(:mod:`repro_torch.kernels.lasso_cd`, :mod:`repro_torch.kernels.ops`):
the wrappers take them for tensors that lie on the CPU, the CPU tests
hold them against the JAX package, and ``chip_smoke.py`` holds the CUDA
kernels against them on the card.  The Lasso pair accepts an optional
leading worker axis, so ``(W, n, U)`` inputs give per-worker results.
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True, window: Optional[int] = None,
                  scale: Optional[float] = None) -> torch.Tensor:
    """Masked multi-head attention, GQA-aware, in f32; returns q.dtype.

    q (B, Sq, Hq, D); k, v (B, Skv, Hkv, D) with Hq % Hkv == 0: query
    head h reads kv head h // (Hq / Hkv).  Query i sits at absolute
    position i + (Skv − Sq) (q is the suffix of the kv timeline) and sees
    key j when ``j <= i`` (causal) and ``i − j < window``.

    The JAX package's ``attention_ref`` with one difference: a query row
    that sees no key returns 0, as the TPU kernel
    (``flash_attention.py``, the ``lsum == 0`` guard) and the CUDA kernel
    do, where the jnp oracle averages every value.
    """
    B, Sq, Hq, D = q.shape
    _, Skv, Hkv, _ = k.shape
    if Hq % Hkv:
        raise ValueError(f"{Hq} query heads do not group over {Hkv} kv "
                         f"heads")
    G = Hq // Hkv
    scale = scale if scale is not None else D ** -0.5
    qf = q.float() * scale
    kf = k.float().repeat_interleave(G, dim=2)
    vf = v.float().repeat_interleave(G, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf)
    mask = attention_mask(Sq, Skv, Skv - Sq, causal, window, q.device)
    s = s.masked_fill(~mask, NEG_INF)
    p = torch.softmax(s, dim=-1) * mask.any(-1, keepdim=True)
    return torch.einsum("bhqk,bkhd->bqhd", p, vf).to(q.dtype)


def attention_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      o: torch.Tensor, do: torch.Tensor, lse: torch.Tensor,
                      causal: bool = True, window: Optional[int] = None,
                      scale: Optional[float] = None,
                      dtype: torch.dtype = torch.float32):
    """The gradients (dq, dk, dv) of :func:`attention_ref` at (q, k, v),
    in ``dtype`` (float32, or float64 for checks), from the forward's
    output ``o``, its row log-sum-exp ``lse`` (B, Hq, Sq) and ``do``, the
    gradient of ``o`` — the formulas the CUDA backward computes:

        P = exp(scale·q·kᵀ − lse) on the visible pairs, 0 elsewhere,
        Δ = Σ_d dO·o,  dS = P ∘ (dO·vᵀ − Δ),
        dv = Pᵀ·dO,  dk = scale·dSᵀ·q,  dq = scale·dS·k,

    with dk and dv summed over the G query heads of each kv head.  The
    layouts are :func:`attention_ref`'s: q, o, do (B, Sq, Hq, D); k, v
    (B, Skv, Hkv, D).  A row that sees no key gets zero gradients."""
    B, Sq, Hq, D = q.shape
    _, Skv, Hkv, _ = k.shape
    G = Hq // Hkv
    scale = scale if scale is not None else D ** -0.5
    qf, kf, vf = (x.to(dtype) for x in (q, k, v))
    of, dof = o.to(dtype), do.to(dtype)
    kr = kf.repeat_interleave(G, dim=2)
    vr = vf.repeat_interleave(G, dim=2)
    mask = attention_mask(Sq, Skv, Skv - Sq, causal, window, q.device)
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kr) * scale
    p = torch.where(mask, torch.exp(s - lse.to(dtype)[..., None]),
                    torch.zeros((), dtype=dtype, device=q.device))
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vr)
    delta = torch.einsum("bqhd,bqhd->bhq", dof, of)
    ds = p * (dp - delta[..., None])
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kr) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf) * scale
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dof)
    dk = dk.reshape(B, Skv, Hkv, G, D).sum(3)
    dv = dv.reshape(B, Skv, Hkv, G, D).sum(3)
    return dq, dk, dv


def attention_lse_ref(q: torch.Tensor, k: torch.Tensor, causal: bool = True,
                      window: Optional[int] = None,
                      scale: Optional[float] = None,
                      dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(B, Hq, Sq) natural-log log-sum-exp of each row's visible scaled
    scores in ``dtype``; −inf for a row that sees no key (what the
    forward kernel's ``lse`` output holds)."""
    B, Sq, Hq, D = q.shape
    _, Skv, Hkv, _ = k.shape
    scale = scale if scale is not None else D ** -0.5
    kr = k.to(dtype).repeat_interleave(Hq // Hkv, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.to(dtype), kr) * scale
    mask = attention_mask(Sq, Skv, Skv - Sq, causal, window, q.device)
    return torch.logsumexp(s.masked_fill(~mask, float("-inf")), dim=-1)


def attention_mask(Sq: int, Skv: int, q_offset: int, causal: bool,
                   window: Optional[int], device=None) -> torch.Tensor:
    """(Sq, Skv) bool: query i (absolute i + q_offset) sees key j."""
    q_ids = torch.arange(Sq, device=device)[:, None] + q_offset
    k_ids = torch.arange(Skv, device=device)[None, :]
    m = torch.ones((Sq, Skv), dtype=torch.bool, device=device)
    if causal:
        m &= q_ids >= k_ids
    if window is not None:
        m &= (q_ids - k_ids) < window
    return m


def gating_softmax(logits: torch.Tensor) -> torch.Tensor:
    """p = e / sum e over the last axis, e = exp(x - max), in f32: a
    division, as the Pallas kernel and the CUDA kernel take it
    (``torch.softmax`` on the CPU multiplies by the sum's reciprocal,
    which can round apart two p that the division ties)."""
    x = logits.float()
    e = torch.exp(x - x.amax(dim=-1, keepdim=True).detach())
    return e / e.sum(dim=-1, keepdim=True)


def topk_gating_ref(logits: torch.Tensor, k: int):
    """Softmax over experts, keep the top k, renormalise.

    logits (T, E) → probs (T, k) f32, idx (T, k) int32.  The top k are
    taken by k argmaxes, as the TPU kernel takes them: ties go to the
    lower expert index (``torch.argmax`` returns the first maximum), and
    a taken expert is set to −1.
    """
    if not 1 <= k <= logits.shape[-1]:
        raise ValueError(f"k={k} outside 1..{logits.shape[-1]} experts")
    work = gating_softmax(logits)
    probs, idx = [], []
    for _ in range(k):
        best = work.argmax(dim=-1, keepdim=True)
        probs.append(work.gather(-1, best))
        idx.append(best)
        work = work.scatter(-1, best, -1.0)
    top_p = torch.cat(probs, dim=-1)
    top_p = top_p / top_p.sum(dim=-1, keepdim=True)
    return top_p, torch.cat(idx, dim=-1).to(torch.int32)


def topk_gating_bwd_ref(logits: torch.Tensor, idx: torch.Tensor,
                        probs: torch.Tensor,
                        dprobs: torch.Tensor) -> torch.Tensor:
    """The gradient of :func:`topk_gating_ref` at ``logits`` (T, E) for
    the forward's picks ``idx`` and ``probs`` (T, k) and ``dprobs``, the
    gradient of ``probs``: dlogits (T, E) f32, the formulas the CUDA
    backward computes:

        p = softmax(logits),  s = Σ_sel p  (the picks, in pick order),
        dp_sel = (dprobs − Σ_k probs·dprobs) / s at ``idx``, 0 elsewhere,
        dlogits = p ⊙ (dp − Σ_e p_e·dp_e).

    The picks are the forward's, so ties go as they went there."""
    p = gating_softmax(logits)
    idx = idx.long()
    dq = dprobs.float()
    s = p.gather(-1, idx).sum(dim=-1, keepdim=True)
    coef = (dq - (probs.float() * dq).sum(dim=-1, keepdim=True)) / s
    dp = torch.zeros_like(p).scatter(-1, idx, coef)
    return p * (dp - (p * dp).sum(dim=-1, keepdim=True))


def ssm_scan_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                 Bm: torch.Tensor, Cm: torch.Tensor,
                 h0: Optional[torch.Tensor] = None):
    """Diagonal selective scan (Mamba2-style), one step at a time.

    x, dt (B, S, C); A (C,); Bm, Cm (B, S, N); h0 (B, C, N) or None
    (zeros).  Per step, in f32:

        h_t = exp(dt_t ⊙ A) ⊙ h_{t−1} + (dt_t ⊙ x_t) ⊗ B_t
        y_t = ⟨h_t, C_t⟩_N

    Returns (y (B, S, C) in x.dtype, h_final (B, C, N) f32).
    """
    Bsz, S, C = x.shape
    N = Bm.shape[-1]
    xf, dtf = x.float(), dt.float()
    Bf, Cf, Af = Bm.float(), Cm.float(), A.float()
    h = (torch.zeros((Bsz, C, N), dtype=torch.float32, device=x.device)
         if h0 is None else h0.float())
    ys = []
    for t in range(S):
        a = torch.exp(dtf[:, t] * Af[None, :])                 # (B, C)
        inp = (dtf[:, t] * xf[:, t])[:, :, None] * Bf[:, t][:, None, :]
        h = a[:, :, None] * h + inp                            # (B, C, N)
        ys.append(torch.einsum("bcn,bn->bc", h, Cf[:, t]))
    y = (torch.stack(ys, dim=1) if ys else
         torch.zeros((Bsz, 0, C), dtype=torch.float32, device=x.device))
    return y.to(x.dtype), h


def ssm_scan_bwd_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                     Bm: torch.Tensor, Cm: torch.Tensor,
                     h0: Optional[torch.Tensor], dy: torch.Tensor,
                     dh_final: Optional[torch.Tensor] = None):
    """The gradients of :func:`ssm_scan_ref` at (x, dt, A, Bm, Cm, h0) for
    ``dy`` (B, S, C), the gradient of y, and ``dh_final`` (B, C, N), that
    of the final state (None: zeros) — the formulas the CUDA backward
    computes.  With a_t = exp(dt_t ⊙ A) and u_t = dt_t ⊙ x_t, per step in
    reverse, in f32 (g_t the gradient of h_t, seeded by dh_final):

        g_t   = dy_t ⊗ C_t + a_{t+1} ⊙ g_{t+1}
        dC_t  = Σ_c dy_t[c]·h_t[c, :]         dB_t  = Σ_c g_t[c, :]·u_t[c]
        du_t  = Σ_n g_t·B_t                   da_t  = Σ_n g_t·h_{t−1}
        dx = du·dt,  ddt = du·x + da·a·A,  dA = Σ_{b,t} da·a·dt,
        dh0 = a_0 ⊙ g_0.

    The states h_{t−1} are taken forward once (all S of them: B·S·C·N
    floats).  Returns (dx, ddt, dA, dB, dC, dh0), each in its input's
    type, as autograd gives them; dh0 is None when h0 is."""
    Bsz, S, C = x.shape
    N = Bm.shape[-1]
    xf, dtf = x.float(), dt.float()
    Bf, Cf, Af = Bm.float(), Cm.float(), A.float()
    a = torch.exp(dtf * Af)                                    # (B, S, C)
    u = dtf * xf
    h = (torch.zeros((Bsz, C, N), dtype=torch.float32, device=x.device)
         if h0 is None else h0.float())
    hs = [h]                                                   # h_{t−1}
    for t in range(S):
        h = a[:, t, :, None] * h + u[:, t, :, None] * Bf[:, t][:, None, :]
        hs.append(h)
    dyf = dy.float()
    g_next = (torch.zeros((Bsz, C, N), dtype=torch.float32, device=x.device)
              if dh_final is None else dh_final.float())
    du, da = torch.empty_like(xf), torch.empty_like(xf)
    dB, dC = torch.empty_like(Bf), torch.empty_like(Cf)
    for t in reversed(range(S)):
        g = dyf[:, t, :, None] * Cf[:, t][:, None, :] + g_next
        dC[:, t] = torch.einsum("bc,bcn->bn", dyf[:, t], hs[t + 1])
        dB[:, t] = torch.einsum("bcn,bc->bn", g, u[:, t])
        du[:, t] = torch.einsum("bcn,bn->bc", g, Bf[:, t])
        da[:, t] = (g * hs[t]).sum(-1)
        g_next = a[:, t, :, None] * g
    dx = du * dtf
    ddt = du * xf + da * a * Af
    dA = (da * a * dtf).sum((0, 1))
    dh0 = None if h0 is None else g_next.to(h0.dtype)
    return (dx.to(x.dtype), ddt.to(dt.dtype), dA.to(A.dtype),
            dB.to(Bm.dtype), dC.to(Cm.dtype), dh0)


# ---------------------------------------------------------------------------
# xLSTM's sLSTM recurrence (``kernels/csrc/slstm_scan.cu``)
# ---------------------------------------------------------------------------

def slstm_state0(B: int, d: int, device) -> tuple:
    """The state an sLSTM starts from when it is given none: c = n = h = 0
    and m = −inf (the JAX package's ``slstm_apply``)."""
    zeros = lambda: torch.zeros((B, d), dtype=torch.float32, device=device)
    return (zeros(), zeros(),
            torch.full((B, d), -torch.inf, device=device), zeros())


def slstm_scan_ref(gx: torch.Tensor, wr: torch.Tensor, bias: torch.Tensor,
                   state: Optional[tuple] = None, save: bool = False):
    """The sLSTM recurrence with exponential gating and its stabiliser,
    one step at a time (``models/xlstm.py::_slstm_cell``'s arithmetic in
    its order).

    gx (B, S, 4d) the input's part of the pre-activations, wr (d, 4d),
    bias (4d,), all f32; state = (c, n, m, h), each (B, d) f32, or None
    for :func:`slstm_state0`.  Per step, with g split into the z, i, f,
    o quarters:

        g = gx_t + h_{t−1} W_r + bias
        m_t = max(logσ(f) + m_{t−1}, i)
        c_t = e^{logσ(f) + m_{t−1} − m_t} c_{t−1} + e^{i − m_t} tanh(z)
        n_t = e^{logσ(f) + m_{t−1} − m_t} n_{t−1} + e^{i − m_t}
        h_t = σ(o) c_t / max(n_t, 1)

    Returns (hs (B, S, d), (c, n, m, h) after the last step), and with
    ``save`` a third output, what the backward reads: (G (B, S, 4d) the
    pre-activations g, C, N, M (B, S, d) the states after each step)."""
    B, S, d4 = gx.shape
    d = d4 // 4
    c, n, m, h = slstm_state0(B, d, gx.device) if state is None else state
    hs, saved = [], ([], [], [], [])
    for t in range(S):
        g = gx[:, t] + h @ wr + bias
        zi, ii, fi, oi = g.split(d, dim=-1)
        z = torch.tanh(zi)
        o = torch.sigmoid(oi)
        logf = torch.nn.functional.logsigmoid(fi)
        m_new = torch.maximum(logf + m, ii)
        fa = torch.exp(logf + m - m_new)
        ia = torch.exp(ii - m_new)
        c = fa * c + ia * z
        n = fa * n + ia
        h = o * c / torch.maximum(n, n.new_ones(()))
        m = m_new
        hs.append(h)
        if save:
            for acc, v in zip(saved, (g, c, n, m)):
                acc.append(v)
    stack = lambda xs, w: (torch.stack(xs, dim=1) if xs else torch.zeros(
        (B, 0, w), dtype=torch.float32, device=gx.device))
    out = (stack(hs, d), (c, n, m, h))
    if save:
        return out + (tuple(stack(v, w) for v, w in
                            zip(saved, (4 * d, d, d, d))),)
    return out


def _tie_weight(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The share of ``max(a, b)``'s gradient that goes to ``a``: 1 where
    a > b, ½ where they tie, 0 where a < b (``torch.maximum`` and
    ``jnp.maximum`` both split a tie evenly)."""
    return torch.where(a > b, 1.0, torch.where(a == b, 0.5, 0.0))


def slstm_scan_bwd_ref(wr: torch.Tensor, state: Optional[tuple],
                       saved: tuple, dhs: torch.Tensor,
                       dfinal: Optional[tuple] = None):
    """The reverse sweep of :func:`slstm_scan_ref`, step by step, as the
    CUDA backward computes it: autograd's chain through the cell, the
    stabiliser included.

    ``saved`` = (G, C, N, M) from a ``save=True`` forward; ``state`` the
    forward's initial state (None: :func:`slstm_state0`); ``dhs`` (B, S,
    d) the gradient of hs; ``dfinal`` = (dc, dn, dm, dh) of the final
    state, any of them None for zeros.  At step t, from the gradients
    dc, dn, dm of (c_t, n_t, m_t) and dh = dhs_t + (the recurrent part),
    with D = max(n_t, 1), a = logσ(f) + m_{t−1}, fa = e^{a − m_t},
    ia = e^{i − m_t}:

        do = dh c_t / D,  dc += dh σ(o) / D,  dn += −dh (h_t / D)·[n_t ≥ 1]
        dfa = dc c_{t−1} + dn n_{t−1},  dia = dc tanh(z) + dn
        dm_t' = dm − dfa fa − dia ia            (m_t's total gradient)
        da = dfa fa + dm_t'·[a ≥ i],  di = dia ia + dm_t'·[i ≥ a]
        dg = (dc ia (1 − tanh²z), di, da σ(−f), do σ(o)(1 − σ(o)))
        dc_{t−1} = dc fa,  dn_{t−1} = dn fa,  dm_{t−1} = da,
        dh_{t−1} = dhs_{t−1} + dg W_rᵀ

    where each [x ≥ y] of a max is ½ at a tie (:func:`_tie_weight`).  No
    term forms inf − inf or 0·inf: with m_{t−1} = −inf, fa = 0 and
    a < i.  Returns (dG (B, S, 4d), the gradient of the initial state
    (dc, dn, dm, dh)); dG is also the gradient of gx."""
    G, C, N, M = saved
    B, S, d = C.shape
    c0, n0, m0, _ = (slstm_state0(B, d, C.device) if state is None
                     else state)
    zero = lambda: torch.zeros((B, d), dtype=torch.float32, device=C.device)
    dc, dn, dm, dhr = (zero() if dfinal is None or dfinal[i] is None
                       else dfinal[i].float() for i in range(4))
    dG = torch.empty_like(G)
    for t in reversed(range(S)):
        zi, ii, fi, oi = G[:, t].split(d, dim=-1)
        c_t, n_t, m_t = C[:, t], N[:, t], M[:, t]
        c_p, n_p, m_p = ((C[:, t - 1], N[:, t - 1], M[:, t - 1]) if t
                         else (c0, n0, m0))
        z = torch.tanh(zi)
        o = torch.sigmoid(oi)
        a = torch.nn.functional.logsigmoid(fi) + m_p
        fa = torch.exp(a - m_t)
        ia = torch.exp(ii - m_t)
        D = torch.maximum(n_t, n_t.new_ones(()))
        h_t = o * c_t / D
        dh = dhs[:, t] + dhr
        q = dh / D
        do = q * c_t
        dc = dc + q * o
        dn = dn + (-dh * (h_t / D)) * _tie_weight(n_t, n_t.new_ones(()))
        dfa = dc * c_p + dn * n_p
        dia = dc * z + dn
        ea, ei = dfa * fa, dia * ia
        dmt = dm - ea - ei
        wa = _tie_weight(a, ii)
        da = ea + dmt * wa
        di = ei + dmt * (1.0 - wa)
        dg = torch.cat([dc * ia * (1.0 - z * z), di,
                        da * torch.sigmoid(-fi), do * o * (1.0 - o)], dim=-1)
        dG[:, t] = dg
        dc, dn, dm = dc * fa, dn * fa, da
        dhr = dg @ wr.T
    return dG, (dc, dn, dm, dhr)


def slstm_param_grads(dG: torch.Tensor, hs: torch.Tensor,
                      h0: Optional[torch.Tensor]) -> tuple:
    """(dW_r, dbias) from the reverse sweep's dG: H_prevᵀ dG over every
    (b, t), with H_prev the h each step read (h0, zeros when None, then
    hs without its last step), and Σ dG."""
    B, S, d = hs.shape
    first = (torch.zeros((B, 1, d), dtype=hs.dtype, device=hs.device)
             if h0 is None else h0[:, None])
    hprev = torch.cat([first, hs[:, :-1]], dim=1)
    dwr = hprev.reshape(B * S, d).T @ dG.reshape(B * S, 4 * d)
    return dwr, dG.sum(dim=(0, 1))


def lasso_partial_ref(Xb: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """z_j = x_jᵀ r for the scheduled block: (…, n, U), (…, n) → (…, U)
    f32."""
    return (Xb.float().mT @ r.float().unsqueeze(-1)).squeeze(-1)


def gram_ref(Xc: torch.Tensor) -> torch.Tensor:
    """Candidate Gram block: (…, n, U′) → (…, U′, U′) f32."""
    Xf = Xc.float()
    return Xf.mT @ Xf


# ---------------------------------------------------------------------------
# LDA's collapsed Gibbs sweep (``kernels/csrc/lda_gibbs.cu``)
# ---------------------------------------------------------------------------

_MASK32 = 0xFFFFFFFF
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)


def _mulhilo(a: int, b: torch.Tensor):
    """(hi, lo) 32-bit words of a·b for a constant a < 2³² and int64 b in
    [0, 2³²), in int64 arithmetic that never overflows."""
    p1 = b * (a & 0xFFFF)                       # < 2⁴⁸
    p2 = b * (a >> 16)                          # < 2⁴⁸
    t = ((p2 & 0xFFFF) << 16) + p1              # < 2⁴⁹
    return (p2 >> 16) + (t >> 32), t & _MASK32


def philox4x32(counter, key: int):
    """Philox-4x32-10 (Salmon et al., SC 2011) of four int64 tensors of
    32-bit counter words under the 64-bit ``key``: the four output words
    as int64 tensors.  The CUDA kernel's ``philox4x32_10`` bit for bit."""
    c0, c1, c2, c3 = counter
    k0, k1 = key & _MASK32, (key >> 32) & _MASK32
    for r in range(10):
        if r:
            k0, k1 = (k0 + _PHILOX_W[0]) & _MASK32, \
                (k1 + _PHILOX_W[1]) & _MASK32
        hi0, lo0 = _mulhilo(_PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo(_PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def philox_gumbel(seed: int, phase: int, slots: torch.Tensor,
                  K: int) -> torch.Tensor:
    """The Gibbs kernel's own Gumbel draws: for worker p's token in slot
    ``slots[p, j]``, topic k takes word k % 4 of Philox-4x32-10 at counter
    (k // 4, slot, p, phase) under key ``seed``; a word x becomes
    u = (2·(x >> 9) + 1)·2⁻²⁴ ∈ (0, 1), exact in f32, and
    g = −log(−log u).  ``slots`` (P, L) → (P, L, K) f32."""
    P, L = slots.shape
    dev = slots.device
    chunks = -(-K // 4)
    shape = (P, L, chunks)
    c0 = torch.arange(chunks, device=dev).expand(shape)
    c1 = slots.long()[:, :, None].expand(shape)
    c2 = torch.arange(P, device=dev)[:, None, None].expand(shape)
    c3 = torch.full(shape, int(phase), dtype=torch.int64, device=dev)
    words = torch.stack(philox4x32((c0, c1, c2, c3), int(seed)), dim=-1)
    u = ((words >> 9) * 2 + 1).to(torch.float32) * 2.0 ** -24
    g = -torch.log(-torch.log(u))
    return g.reshape(P, L, chunks * 4)[..., :K].contiguous()


def gibbs_active(order: torch.Tensor, offsets: torch.Tensor, phase: int):
    """Worker p's block this round, ``(p + phase) % n_blocks``, and the
    slots of its active tokens in slot order: ``(blocks (P,), slots
    (P, L) int64 padded with 0, counts (P,))`` for L the largest count."""
    P = order.shape[0]
    n_blocks = offsets.shape[1] - 1
    p = torch.arange(P, device=order.device)
    blocks = (p + phase) % n_blocks
    start = offsets[p, blocks].long()
    counts = offsets[p, blocks + 1].long() - start
    L = int(counts.max()) if P else 0
    j = torch.arange(L, device=order.device)
    pos = (start[:, None] + j).clamp_max_(order.shape[1] - 1)
    slots = torch.where(j < counts[:, None], order.gather(1, pos).long(), 0)
    return blocks, slots, counts


def lda_gibbs_ref(words, docs, z, order, offsets, B, D, s, *, phase: int,
                  rotate: bool, block_vocab: int, vg: float, alpha: float,
                  gamma: float, gumbel: Optional[torch.Tensor] = None,
                  seed: int = 0) -> torch.Tensor:
    """Sequential collapsed Gibbs over every worker's active tokens, the
    workers side by side (the JAX package's ``_gibbs_scan`` and
    ``_full_gibbs_scan``, ``apps/lda.py``, without the inactive slots,
    which are exact no-ops there).

    Worker p samples the tokens of vocabulary block
    ``b = (p + phase) % n_blocks`` (``n_blocks = offsets.shape[1] − 1``),
    in slot order, against ``B[b]`` when ``rotate`` (STRADS: B is
    (n_blocks, V_b, K) by home block) or ``B[p]`` otherwise (the
    baseline's replicas), ``D[p]`` (dpw, K) and its own copy s̃ of s.
    Per token: remove its topic from B, D and s̃; logits
    (log(γ + B[v]) − log(vg + s̃)) + log(α + D[d]); the new topic is the
    first argmax of Gumbel noise + logits; add it back.  The noise is
    ``gumbel`` (P, L, K), row j for the worker's j-th active token, or
    :func:`philox_gumbel` of (``seed``, ``phase``) when None.

    words, docs and z are (P, T) int32; ``order`` and ``offsets`` come
    from :func:`repro_torch.kernels.lda_gibbs.gibbs_index`.  Updates z, B
    and D in place; returns s̃ (P, K)."""
    P = words.shape[0]
    K = B.shape[-1]
    p = torch.arange(P, device=words.device)
    blocks, slots, counts = gibbs_active(order, offsets, phase)
    if gumbel is None:
        gumbel = philox_gumbel(seed, phase, slots, K)
    slabs = blocks if rotate else p
    vbase = blocks * block_vocab
    st = s.float().expand(P, K).clone()
    for j in range(slots.shape[1]):
        act = j < counts
        w, slot = p[act], slots[act, j]
        sl = slabs[act]
        v = words[w, slot].long() - vbase[act]
        d = docs[w, slot].long()
        zi = z[w, slot].long()
        B[sl, v, zi] -= 1.0
        D[w, d, zi] -= 1.0
        st[w, zi] -= 1.0
        logits = ((torch.log(gamma + B[sl, v]) - torch.log(vg + st[w]))
                  + torch.log(alpha + D[w, d]))
        znew = torch.argmax(gumbel[w, j] + logits, dim=-1)
        B[sl, v, znew] += 1.0
        D[w, d, znew] += 1.0
        st[w, znew] += 1.0
        z[w, slot] = znew.to(z.dtype)
    return st
