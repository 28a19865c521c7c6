"""Sequence scans with chunked gradient checkpointing.

The port of the JAX package's ``models/scan_utils.py``.  Backprop through
a scan over S timesteps keeps what every step saves; for recurrent blocks
with matrix state (the mLSTM's C) that is O(S·state).  ``chunked_scan``
runs the steps as a Python loop and, when grad is on, checkpoints each
chunk of steps (``torch.utils.checkpoint``), so only the carries at the
chunk boundaries stay saved and a chunk's steps are run again in the
backward: O(S/K + K) states (classic sqrt-remat).
"""
from __future__ import annotations

import math
from typing import Any, Callable, Tuple

import torch
from torch.utils.checkpoint import checkpoint


def default_chunk(S: int) -> int:
    """√S rounded down to a divisor of S (powers of two divide cleanly)."""
    k = max(16, int(math.sqrt(S)))
    while S % k:
        k -= 1
    return max(k, 1)


def _steps(step_fn: Callable, carry: Any, xs: Tuple[torch.Tensor, ...]):
    """``step_fn`` over the leading axis of ``xs``; the outputs stacked."""
    ys = []
    for t in range(xs[0].shape[0]):
        carry, y = step_fn(carry, tuple(x[t] for x in xs))
        ys.append(y)
    return carry, torch.stack(ys)


def chunked_scan(step_fn: Callable, carry: Any, xs: Tuple[torch.Tensor, ...],
                 chunk: int = 0) -> Tuple[Any, torch.Tensor]:
    """``lax.scan(step_fn, carry, xs)`` with chunk-boundary checkpointing.

    ``xs`` is a tuple of tensors with leading dim S; ``step_fn(carry,
    x)`` gets the tuple of their slices at one step and returns (carry,
    y) with y a tensor.  Returns (the last carry, the ys stacked along a
    new leading dim S).  With grad on, each chunk of ``chunk`` steps
    (default :func:`default_chunk`) runs checkpointed; when S does not
    split (tiny sizes) the whole scan is one checkpointed chunk."""
    S = xs[0].shape[0]
    if not torch.is_grad_enabled():
        return _steps(step_fn, carry, xs)
    k = chunk or default_chunk(S)
    if S % k or S <= k:
        k = S
    ys = []
    for lo in range(0, S, k):
        carry, y = checkpoint(_steps, step_fn, carry,
                              tuple(x[lo:lo + k] for x in xs),
                              use_reentrant=False)
        ys.append(y)
    return carry, torch.cat(ys)
