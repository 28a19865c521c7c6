"""The parameter server: versioned shared variables and vector clocks,
from the JAX package's ``ps/server.py``.

The model store's *values* are the state's leaves (``core/kvstore.py``);
this module adds what bounded staleness needs on top of it:

* the split of the state into **server-resident** variables (whole on
  every worker, spec ``None``: every worker sees one committed value,
  refreshed at a flush) and **worker-resident** ones (split over the
  workers, spec :data:`~repro_torch.core.kvstore.DATA_AXIS`: a worker
  always reads its own current copy), from the store's VarSpecs;
* ``snapshot``/``merge``: take the server values into a worker cache and
  serve reads through it (the read path of :mod:`repro_torch.ps.cache`);
* per-worker **vector clocks** (Xing et al. 2016): worker p's clock
  counts the rounds it has committed.  The workers of one card advance
  in lockstep, so the vector is one value repeated; it is carried all
  the same, because the SSP invariant is stated over it.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from ..core.kvstore import (KVStore, named_leaves, is_replicated,
                            map_with_path, store_from_tree)


class ParameterServer:
    """Bookkeeping for the server-resident half of an app's state."""

    def __init__(self, store: KVStore):
        self.store = store
        self.shared_names = frozenset(
            n for n, vs in store.specs.items() if is_replicated(vs.spec))

    @classmethod
    def from_state(cls, workers: int, state: Any, spec_tree: Any,
                   roles=None) -> "ParameterServer":
        """A server over a store declared from ``state`` (``roles``: the
        app's ``var_roles()``, for the in-flight exclusion)."""
        return cls(store_from_tree(workers, state, spec_tree, roles=roles))

    # -- read path -----------------------------------------------------------

    def snapshot(self, state: Any) -> Dict[str, torch.Tensor]:
        """The server-resident leaves as a flat {path: tensor} dict (the
        payload of a :class:`~repro_torch.ps.cache.StaleCache`):
        references, not copies."""
        return {n: leaf for n, leaf in named_leaves(state)
                if n in self.shared_names}

    def merge(self, state: Any, cache: Dict[str, torch.Tensor]) -> Any:
        """Serve a read: server-resident leaves from the (possibly stale)
        cache, worker-resident leaves from the live state."""
        return map_with_path(lambda n, x: cache.get(n, x), state)

    # -- accounting ----------------------------------------------------------

    def shared_nbytes(self) -> int:
        """Bytes a cache refresh moves into every worker (the 'pull')."""
        return sum(self.store.specs[n].nbytes() for n in self.shared_names)

    def local_nbytes(self) -> int:
        return self.store.total_bytes() - self.shared_nbytes()


# ---------------------------------------------------------------------------
# Vector clocks
# ---------------------------------------------------------------------------

def init_clocks(num_workers: int, device="cpu") -> torch.Tensor:
    """All workers start at clock 0: an int32 (W,) tensor."""
    return torch.zeros((num_workers,), dtype=torch.int32, device=device)


def tick(clocks: torch.Tensor) -> torch.Tensor:
    """Every worker commits a round (lockstep advance)."""
    return clocks + 1


def min_clock(clocks: torch.Tensor) -> torch.Tensor:
    """The slowest worker's clock — the staleness reference point."""
    return clocks.min()
