"""The :class:`Assignment` value: which worker owns each model variable.

A copy of the JAX package's ``part/assignment.py``: an assignment is the
output of a partitioner, the variable→worker ownership map of the
partitioned model store.  It is a frozen, hashable value; ``version``
counts rebalances.  It round-trips two ways: ``to_json``/``from_json``
for artifacts and ``payload``/``from_payload`` as a flat dict of numpy
arrays for :mod:`repro_torch.checkpoint` (the ``{"state", "carry",
"assignment"}`` checkpoints ``StradsEngine.execute`` writes at chunk
boundaries; the JAX package's files hold the same keys and dtypes).
"""
from __future__ import annotations

import dataclasses
import json
from typing import Dict, Optional

import numpy as np

from ..sched.schedulers import RotationScheduler


@dataclasses.dataclass(frozen=True)
class Assignment:
    """Variable→worker ownership: variable ``j`` lives on worker
    ``owner[j]``.  ``version`` counts rebalances (0 = the initial
    assignment); equality and hashing compare the full owner map and the
    version."""
    owner: tuple
    num_workers: int
    version: int = 0

    def __post_init__(self):
        owner = tuple(int(o) for o in self.owner)
        object.__setattr__(self, "owner", owner)
        if not isinstance(self.num_workers, int) or self.num_workers < 1:
            raise ValueError(f"num_workers must be a positive int; got "
                             f"{self.num_workers!r}")
        bad = [o for o in owner if not 0 <= o < self.num_workers]
        if bad:
            raise ValueError(
                f"owner entries must be worker ids in [0, "
                f"{self.num_workers}); got {sorted(set(bad))}")
        if not isinstance(self.version, int) or self.version < 0:
            raise ValueError(f"version must be an int >= 0; got "
                             f"{self.version!r}")

    @property
    def num_vars(self) -> int:
        return len(self.owner)

    # -- accounting ----------------------------------------------------------

    def counts(self) -> np.ndarray:
        """(U,) variables owned per worker."""
        return np.bincount(np.asarray(self.owner, np.int64),
                           minlength=self.num_workers)

    def loads(self, weights) -> np.ndarray:
        """(U,) per-worker load: the sum of ``weights`` (per-variable
        activity, bytes, …) over each worker's owned variables."""
        w = np.asarray(weights, np.float64)
        if w.shape != (self.num_vars,):
            raise ValueError(f"weights must have shape ({self.num_vars},)"
                             f"; got {w.shape}")
        return np.bincount(np.asarray(self.owner, np.int64), weights=w,
                           minlength=self.num_workers)

    def spread(self, weights) -> float:
        """Relative per-worker load spread ``(max − min) / mean`` — the
        quantity ``PartitionerSpec.imbalance_threshold`` gates on (0 =
        perfectly balanced)."""
        loads = self.loads(weights)
        mean = float(loads.mean())
        if mean == 0.0:
            return 0.0
        return float((loads.max() - loads.min()) / mean)

    # -- serialization (artifacts) -------------------------------------------

    def to_json(self) -> dict:
        return {"owner": list(self.owner),
                "num_workers": self.num_workers,
                "version": self.version}

    @classmethod
    def from_json(cls, obj) -> "Assignment":
        if isinstance(obj, (str, bytes)):
            obj = json.loads(obj)
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(obj) - known
        if unknown:
            raise ValueError(f"unknown Assignment field(s): "
                             f"{sorted(unknown)}")
        return cls(**obj)

    # -- serialization (checkpoint) ------------------------------------------

    def payload(self) -> Dict[str, np.ndarray]:
        """Flat array dict for :mod:`repro_torch.checkpoint` (the
        ``"assignment"`` subtree of a chunked run's checkpoint)."""
        return {"owner": np.asarray(self.owner, np.int32),
                "num_workers": np.int32(self.num_workers),
                "version": np.int32(self.version)}

    @classmethod
    def from_payload(cls, payload: Dict[str, np.ndarray]
                     ) -> Optional["Assignment"]:
        if payload is None:
            return None
        return cls(owner=tuple(int(o) for o in
                               np.asarray(payload["owner"])),
                   num_workers=int(payload["num_workers"]),
                   version=int(payload["version"]))


def contiguous_assignment(num_vars: int, num_workers: int) -> Assignment:
    """The frozen contiguous partition: worker u owns
    ``[bounds[u], bounds[u+1])`` with the rotation scheduler's own
    :attr:`~repro_torch.sched.RotationScheduler.bounds` (a float32
    linspace rounded half to even, as the JAX package's), so the static
    assignment and the rotation's variable→worker map can never
    disagree, at vocabulary scale too."""
    edges = RotationScheduler(num_vars, num_workers).bounds.numpy()
    owner = np.searchsorted(edges[1:].astype(np.int64), np.arange(num_vars),
                            side="right")
    return Assignment(owner=tuple(int(o) for o in owner),
                      num_workers=num_workers)
