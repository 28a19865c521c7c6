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


def topk_gating_ref(logits: torch.Tensor, k: int):
    """Softmax over experts, keep the top k, renormalise.

    logits (T, E) → probs (T, k) f32, idx (T, k) int32.  The top k are
    taken by k argmaxes, as the TPU kernel takes them: ties go to the
    lower expert index (``torch.argmax`` returns the first maximum), and
    a taken expert is set to −1.
    """
    if not 1 <= k <= logits.shape[-1]:
        raise ValueError(f"k={k} outside 1..{logits.shape[-1]} experts")
    work = torch.softmax(logits.float(), dim=-1)
    probs, idx = [], []
    for _ in range(k):
        best = work.argmax(dim=-1, keepdim=True)
        probs.append(work.gather(-1, best))
        idx.append(best)
        work = work.scatter(-1, best, -1.0)
    top_p = torch.cat(probs, dim=-1)
    top_p = top_p / top_p.sum(dim=-1, keepdim=True)
    return top_p, torch.cat(idx, dim=-1).to(torch.int32)


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


def lasso_partial_ref(Xb: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """z_j = x_jᵀ r for the scheduled block: (…, n, U), (…, n) → (…, U)
    f32."""
    return (Xb.float().mT @ r.float().unsqueeze(-1)).squeeze(-1)


def gram_ref(Xc: torch.Tensor) -> torch.Tensor:
    """Candidate Gram block: (…, n, U′) → (…, U′, U′) f32."""
    Xf = Xc.float()
    return Xf.mT @ Xf
