"""The scheduler protocol, as in the JAX package's ``sched/protocol.py``:

    carry  = scheduler.init_carry(device)           # once per run
    cand   = scheduler.propose(carry, noise, t, phase)
    idx, m = scheduler.finalize(cand, stats)        # stats = summed Gram
    carry' = scheduler.update_carry(carry, idx, m, dx)
    carry~ = scheduler.mark_scheduled(carry, cand)  # SSP in-flight exclusion

One difference: randomness is an input.  The engine draws one (J,)
Gumbel vector per round (from a ``torch.Generator``, or from a noise
source the caller passes, as the parity tests do with the JAX package's
own draws) and hands it to ``propose``; policies that need no noise set
``needs_noise = False`` and get ``None``.  Every scheduler is a frozen
dataclass, and every method works on device tensors without a host sync.
"""
from __future__ import annotations

from typing import Any, Optional

import torch


class SchedulerBase:
    """Stateless defaults: no carry, no stats, full-block mask."""

    needs_stats = False
    needs_noise = True

    def init_carry(self, device) -> Optional[Any]:
        return None

    def finalize(self, candidates, stats):
        """Identity filter: keep the whole candidate block."""
        return candidates, torch.ones(candidates.shape, dtype=torch.bool,
                                      device=candidates.device)

    def update_carry(self, carry, idx, mask, dx):
        return carry

    def mark_scheduled(self, carry, candidates):
        """The SSP in-flight exclusion over the carry: identity for
        policies whose proposals read no priorities."""
        return carry
