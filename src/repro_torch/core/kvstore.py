"""The model store: the paper's partitioned key-value store of the model
variables, from the JAX package's ``core/kvstore.py``.

The JAX package places each variable on a device mesh with a
``PartitionSpec``.  Here the workers are a leading tensor axis on one
device: a variable whose spec is :data:`DATA_AXIS` is split by rows over
the workers and carries shape (W, n/W, …); every other variable is whole
(the synced KV-store values).  This module keeps the bookkeeping of the
store: named variables, their specs and roles, the byte accounting of
the Fig-3 memory claim, and the (re)placement of a state.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

DATA_AXIS = "data"


def path_name(path) -> str:
    """'/'-joined key path (the convention of :mod:`repro_torch.checkpoint`
    too)."""
    return "/".join(str(p) for p in path)


def is_replicated(spec) -> bool:
    """True iff a spec keeps the variable whole on every worker — the
    paper's synced KV-store values (vs worker-local partitions)."""
    return spec != DATA_AXIS


def place(name: str, x, spec, workers: int, device) -> torch.Tensor:
    """``x`` on ``device`` (floats as f32); a :data:`DATA_AXIS` leaf
    takes the (W, n/W, …) worker layout, a view of the rows."""
    x = torch.as_tensor(x, device=device)
    if x.is_floating_point():
        x = x.float()
    if spec != DATA_AXIS:
        return x
    n = x.shape[0]
    if n % workers:
        raise ValueError(f"{name!r}: {n} rows do not split evenly over "
                         f"{workers} workers")
    return x.reshape(workers, n // workers, *x.shape[1:])


@dataclasses.dataclass
class VarSpec:
    """A declared model variable: its whole shape and its dtype, how it
    is split over the workers (``spec``: :data:`DATA_AXIS` or ``None``) and
    its role.

    ``role`` is ``"model"`` (an ordinary variable) or ``"priority"`` (a
    scheduling-priority table indexed by variable id, which the SSP
    window scheduler masks for in-flight exclusion)."""
    shape: tuple
    dtype: Any
    spec: Optional[str] = None     # whole on every worker by default
    role: str = "model"            # "model" | "priority"

    VALID_ROLES = ("model", "priority")

    def __post_init__(self):
        if self.role not in self.VALID_ROLES:
            raise ValueError(
                f"VarSpec.role must be one of {list(self.VALID_ROLES)} "
                f"('model' = ordinary variable, 'priority' = scheduling-"
                f"priority table masked for SSP in-flight exclusion); "
                f"got {self.role!r}")
        if self.spec not in (None, DATA_AXIS):
            raise ValueError(f"VarSpec.spec must be None or "
                             f"{DATA_AXIS!r}; got {self.spec!r}")

    def nbytes(self) -> int:
        itemsize = (torch.empty((), dtype=self.dtype).element_size()
                    if isinstance(self.dtype, torch.dtype)
                    else np.dtype(self.dtype).itemsize)
        return int(np.prod(self.shape)) * itemsize

    def nbytes_per_device(self, workers: int) -> int:
        """Bytes one worker holds — the Fig-3 quantity: a
        :data:`DATA_AXIS` variable's 1/W share, a whole variable in full.
        With W workers on one card this is per worker, not per card
        (the card holds every worker's share)."""
        return self.nbytes() // (workers if self.spec == DATA_AXIS else 1)


class KVStore:
    """A named model-variable store over W workers of one device."""

    def __init__(self, workers: int, specs: Mapping[str, VarSpec]):
        self.workers = workers
        self.specs = dict(specs)
        #: the active variable→worker Assignment (repro_torch.part) —
        #: None until the engine repartitions through this store
        self.assignment = None

    # -- placement ----------------------------------------------------------

    def place_tree(self, tree: dict, device) -> dict:
        """Place a flat state dict: every leaf takes the layout its
        VarSpec declares (:func:`place`)."""
        unknown = set(tree) - set(self.specs)
        if unknown:
            raise KeyError(f"place_tree: leaves {sorted(unknown)} have no "
                           f"VarSpec (store has {sorted(self.specs)})")
        return {k: place(k, v, self.specs[k].spec, self.workers, device)
                for k, v in tree.items()}

    def repartition(self, assignment, state: Optional[dict] = None,
                    leaf_specs: Optional[Mapping[str, Any]] = None
                    ) -> Optional[dict]:
        """Adopt a new variable→worker
        :class:`~repro_torch.part.Assignment` — the paper's dynamic
        partitioning move.  On one card it is bookkeeping: ``leaf_specs``
        (leaf name → new spec) re-derives those VarSpecs, so the byte
        accounting follows a declared move, and ``state`` comes back
        unchanged (the built-in apps keep their leaf placement fixed;
        ownership decides which worker serves a variable, not where its
        bytes lie)."""
        for name, spec in dict(leaf_specs or {}).items():
            if name not in self.specs:
                raise ValueError(f"repartition names unknown variable "
                                 f"{name!r} (store has "
                                 f"{sorted(self.specs)})")
            self.specs[name] = dataclasses.replace(self.specs[name],
                                                   spec=spec)
        self.assignment = assignment
        return state

    # -- accounting (Fig 3) -------------------------------------------------

    def total_bytes(self) -> int:
        return sum(vs.nbytes() for vs in self.specs.values())

    def bytes_per_device(self) -> int:
        """Model-store bytes one worker holds (per worker, not per card:
        see :meth:`VarSpec.nbytes_per_device`).  Split stores shrink as
        W grows; whole (data-parallel) stores do not — the paper's
        central memory claim (Fig 3)."""
        return sum(vs.nbytes_per_device(self.workers)
                   for vs in self.specs.values())

    def partition_specs(self) -> Dict[str, Any]:
        return {name: vs.spec for name, vs in self.specs.items()}


# ---------------------------------------------------------------------------
# Declare a store from a live state
# ---------------------------------------------------------------------------

def _flatten(tree: Any, prefix: tuple = ()) -> list:
    """(path, leaf) pairs of nested dicts; ``None`` counts as a leaf (a
    spec of ``None`` is the whole placement)."""
    if isinstance(tree, dict):
        return [kv for k, v in tree.items()
                for kv in _flatten(v, prefix + (k,))]
    return [(prefix, tree)]


def specs_from_tree(tree: dict, spec_tree: dict,
                    roles: Optional[Mapping[str, str]] = None
                    ) -> Dict[str, VarSpec]:
    """VarSpec per leaf of a state before placement (names are
    '/'-joined paths);
    ``spec_tree`` is the matching tree of :data:`DATA_AXIS` / ``None``
    specs, ``roles`` maps leaf paths to VarSpec roles (unknown paths
    raise)."""
    roles = dict(roles or {})
    flat, sflat = _flatten(tree), _flatten(spec_tree)
    if len(flat) != len(sflat):
        raise ValueError(f"state has {len(flat)} leaves but the spec tree "
                         f"has {len(sflat)}")
    out = {}
    for (path, leaf), (spath, spec) in zip(flat, sflat):
        name = path_name(path)
        if name != path_name(spath):
            raise ValueError(f"state/spec tree mismatch: leaf {name!r} "
                             f"paired with spec {path_name(spath)!r}")
        leaf = torch.as_tensor(leaf)
        # placement keeps floating leaves in f32 (:func:`place`)
        dtype = torch.float32 if leaf.is_floating_point() else leaf.dtype
        out[name] = VarSpec(tuple(leaf.shape), dtype, spec,
                            role=roles.pop(name, "model"))
    if roles:
        raise ValueError(f"var_roles names unknown state leaves: "
                         f"{sorted(roles)}")
    return out


def store_from_tree(workers: int, tree: dict, spec_tree: dict,
                    roles: Optional[Mapping[str, str]] = None) -> KVStore:
    """A KVStore whose variables mirror a state before placement."""
    return KVStore(workers, specs_from_tree(tree, spec_tree, roles=roles))


__all__ = ["DATA_AXIS", "KVStore", "VarSpec", "is_replicated", "path_name",
           "place", "specs_from_tree", "store_from_tree"]
