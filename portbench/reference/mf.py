"""The plain reference of STRADS matrix factorisation: the residual of a
factorisation, one H/W cycle of rank-wise coordinate descent, and the
``recommend`` scores.

Plain PyTorch in float64; imports nothing of the program.  The task
(paper §3.2) is min_{W,H} Σ_{(i,j)∈Ω} (a_ij − w_i·h_j)² + λ(‖W‖² + ‖H‖²)
with W (N, K) and H (K, M).  A cycle updates rank k twice: the H-phase
sets every h_kj to its exact minimiser with the rest fixed,

    h_kj ← Σ_i m_ij w_ik (r_ij + w_ik h_kj) / (λ + Σ_i m_ij w_ik²),

and the W-phase then sets every w_ik the same way against the new H,

    w_ik ← Σ_j m_ij h_kj (r_ij + w_ik h_kj) / (λ + Σ_j m_ij h_kj²),

where r = (A − W H)·mask is the residual at that point.  Everything is
taken in blocks of ``chunk`` rows, so no (N, M) float64 temporary is
held.

``tf32=True`` is the control: float32, with both operands of every
product rounded to TF32 (10 bits of mantissa), the precision a float32
matrix product takes on the card when TF32 is allowed.
"""
from __future__ import annotations

import torch


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` in float32 rounded to TF32's 10 mantissa bits (to nearest,
    ties to even)."""
    u = x.float().contiguous().view(torch.int32).long() & 0xFFFFFFFF
    u = (u + 0xFFF + ((u >> 13) & 1)) & 0xFFFFE000
    u = torch.where(u >= 1 << 31, u - (1 << 32), u)
    return u.to(torch.int32).view(torch.float32)


class _Arith:
    def __init__(self, tf32: bool):
        self.tf32 = tf32
        self.dtype = torch.float32 if tf32 else torch.float64

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(self.dtype)

    def mm(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        if self.tf32:
            return to_tf32(x) @ to_tf32(y)
        return x.double() @ y.double()


def _residual(f: _Arith, A, mask, W, H, i: int, chunk: int):
    return (f(A[i:i + chunk]) - f.mm(W[i:i + chunk], H)) \
        * f(mask[i:i + chunk])


def residual_gap(A, mask, W, H, R, chunk: int = 8192) -> float:
    """max |R − (A − W H)·mask| over every entry, with the product and the
    difference in float64."""
    f = _Arith(False)
    worst = 0.0
    for i in range(0, A.shape[0], chunk):
        r = _residual(f, A, mask, W, H, i, chunk)
        worst = max(worst, float((R[i:i + chunk].double() - r).abs().max()))
    return worst


def residual(A, mask, W, H, chunk: int = 8192, tf32: bool = True):
    """(A − W H)·mask as a float32 (N, M) tensor (the control's)."""
    f = _Arith(tf32)
    out = torch.empty(A.shape, dtype=torch.float32, device=A.device)
    for i in range(0, A.shape[0], chunk):
        out[i:i + chunk] = _residual(f, A, mask, W, H, i, chunk)
    return out


def cycle(A, mask, W, H, k: int, lam: float, chunk: int = 8192,
          tf32: bool = False):
    """The H-phase then the W-phase of rank ``k`` from the factors W (N, K)
    and H (K, M): returns (h_k (M,), w_k (N,)), the rank's new row of H
    and new column of W, in float64 (float32 with ``tf32``)."""
    f = _Arith(tf32)
    N, M = A.shape
    dev = A.device
    w = f(W[:, k])
    h_old = f(H[k])
    num = torch.zeros((1, M), dtype=f.dtype, device=dev)
    den = torch.zeros((1, M), dtype=f.dtype, device=dev)
    for i in range(0, N, chunk):
        r = _residual(f, A, mask, W, H, i, chunk)
        m = f(mask[i:i + chunk])
        wi = w[i:i + chunk][None, :]
        den_i = f.mm(wi * wi, m)
        num += f.mm(wi, r) + den_i * h_old
        den += den_i
    h_new = (num / (lam + den))[0]
    H1 = f(H).clone()
    H1[k] = h_new
    w_new = torch.empty((N,), dtype=f.dtype, device=dev)
    hh = (h_new * h_new)[:, None]
    for i in range(0, N, chunk):
        r = _residual(f, A, mask, W, H1, i, chunk)
        m = f(mask[i:i + chunk])
        mh = f.mm(m, hh)[:, 0]
        wi = w[i:i + chunk]
        w_new[i:i + chunk] = (f.mm(r, h_new[:, None])[:, 0] + wi * mh) \
            / (lam + mh)
    return h_new, w_new


def scores(w_u: torch.Tensor, H: torch.Tensor,
           tf32: bool = False) -> torch.Tensor:
    """``recommend``'s scores of one user over every item, w_u·h_j: (M,)
    in float64 (float32 with ``tf32``)."""
    f = _Arith(tf32)
    return f.mm(w_u[None, :], H)[0]
