"""Worker-local stale caches for server-resident variables, from the JAX
package's ``ps/cache.py``.

A worker never reads the parameter server directly: reads go through a
:class:`StaleCache`, a snapshot of the server values stamped with the
clock it was taken at.  The SSP consistency gate (Xing et al. 2016) is

    clock - cache.clock <= s

so a cached read may be served while it is at most ``s`` commits old;
once the bound would be violated the executor flushes its pending
updates and refreshes the cache.  ``repro_torch.ps.ssp`` evaluates the
gate while it lays out a step's rounds, so the gate *is* the window
structure, not a branch each round.  The snapshot holds references to
the server-resident tensors, never copies: the apps' pulls write those
leaves as new tensors, so a cached value stays as it was read.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict


@dataclasses.dataclass(frozen=True)
class StaleCache:
    """A worker's view of the server: values and the clock they were read
    at.  ``values`` is the flat {path: tensor} dict of
    :meth:`~repro_torch.ps.server.ParameterServer.snapshot`; ``clock`` is
    the round counter at snapshot time (a host int)."""
    values: Dict[str, Any]
    clock: int

    def staleness(self, clock: int) -> int:
        """How many commits behind the server this cache is."""
        return int(clock) - self.clock

    def fresh_enough(self, clock: int, bound: int) -> bool:
        """The SSP gate: may a read at ``clock`` still be served?"""
        return self.staleness(clock) <= bound

    def refresh(self, values: Dict[str, Any], clock: int) -> "StaleCache":
        """A fresh snapshot (after a flush made the server current)."""
        return StaleCache(values=values, clock=int(clock))
