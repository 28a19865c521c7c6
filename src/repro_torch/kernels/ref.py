"""Plain PyTorch versions of the Lasso round's two kernels.

They are the semantics contract for :mod:`repro_torch.kernels.lasso_cd`:
its wrappers take them for tensors that lie on the CPU, the CPU tests
hold them against the JAX package, and ``chip_smoke.py`` holds the CUDA
kernels against them on the card.  Both accept an optional leading
worker axis, so ``(W, n, U)`` inputs give per-worker results.
"""
from __future__ import annotations

import torch


def lasso_partial_ref(Xb: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """z_j = x_jᵀ r for the scheduled block: (…, n, U), (…, n) → (…, U)
    f32."""
    return (Xb.float().mT @ r.float().unsqueeze(-1)).squeeze(-1)


def gram_ref(Xc: torch.Tensor) -> torch.Tensor:
    """Candidate Gram block: (…, n, U′) → (…, U′, U′) f32."""
    Xf = Xc.float()
    return Xf.mT @ Xf
