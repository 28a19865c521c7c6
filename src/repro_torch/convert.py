"""Carry a STRADS Lasso run from the JAX package into the port.

The JAX package keeps β replicated, r and the data row-sharded over a
``data`` mesh axis, and the dynamic-priority scheduler's Δβ history in
its ``EngineCarry.sched_carry``.  :func:`lasso_from_jax` takes those as
numpy arrays (``np.asarray`` of the JAX values) and returns the port's
state, data and :class:`~repro_torch.core.EngineCarry` on ``device``, in
the port's worker layout.  A run that resumes from them with the same
scheduler noise continues on the JAX run's trajectory.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .core import EngineCarry, resolve_device


def _rows(x: np.ndarray, workers: int, device) -> torch.Tensor:
    x = torch.tensor(np.asarray(x, np.float32), device=device)
    if x.shape[0] % workers:
        raise ValueError(f"{x.shape[0]} rows do not split evenly over "
                         f"{workers} workers")
    return x.reshape(workers, x.shape[0] // workers, *x.shape[1:])


def lasso_from_jax(state: dict, X: np.ndarray, y: np.ndarray, *,
                   sched_carry: Optional[np.ndarray] = None, t: int = 0,
                   workers: int = 1, device="cuda"):
    """``state`` is ``{"beta": (J,), "r": (n,)}``, ``sched_carry`` the
    (J,) priority history (``None`` for stateless schedulers) and ``t``
    the next round index.  Returns ``(state, data, carry)`` for
    :meth:`~repro_torch.core.StradsEngine.execute`: β (J,), r (W, n/W),
    X (W, n/W, J), y (W, n/W)."""
    device = resolve_device(device)
    out_state = {
        "beta": torch.tensor(np.asarray(state["beta"], np.float32),
                             device=device),
        "r": _rows(state["r"], workers, device),
    }
    data = {"X": _rows(X, workers, device), "y": _rows(y, workers, device)}
    sc = (None if sched_carry is None else
          torch.tensor(np.asarray(sched_carry, np.float32), device=device))
    return out_state, data, EngineCarry(t=int(t), sched_carry=sc)
