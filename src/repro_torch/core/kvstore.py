"""The model store: the paper's partitioned key-value store of the model
variables, from the JAX package's ``core/kvstore.py``.

The JAX package places each variable on a device mesh with a
``PartitionSpec``.  Here the workers are a leading tensor axis on one
device: a variable whose spec is :data:`DATA_AXIS` is split by rows over
the workers and carries shape (W, n/W, …); every other variable is whole
(the synced KV-store values).  This module keeps the bookkeeping of the
store: named variables, their specs and roles, the byte accounting of
the Fig-3 memory claim, the (re)placement of a state, and
:class:`VarTable`, the SSP executor's write contract derived from
placement.
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


# ---------------------------------------------------------------------------
# VarTable — the v2 push/pull write contract, derived from placement
# ---------------------------------------------------------------------------

_LEAF = object()                 # a leaf's place in a recorded structure


def named_leaves(tree: Any, prefix: tuple = ()) -> list:
    """(name, leaf) pairs of nested dicts, with ``None`` holding no leaf
    (the JAX package's pytree convention for ``local``)."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [kv for k, v in tree.items()
                for kv in named_leaves(v, prefix + (k,))]
    return [(path_name(prefix), tree)]


def _skeleton(tree: Any) -> Any:
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _skeleton(v) for k, v in tree.items()}
    return _LEAF


def _fill(skel: Any, vals: dict, prefix: tuple = ()) -> Any:
    if skel is None:
        return None
    if isinstance(skel, dict):
        return {k: _fill(v, vals, prefix + (k,)) for k, v in skel.items()}
    return vals[path_name(prefix)]


def map_with_path(fn, tree: Any, prefix: tuple = ()) -> Any:
    """``fn(name, leaf)`` over every leaf of nested dicts, the structure
    kept."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, prefix + (k,))
                for k, v in tree.items()}
    return fn(path_name(prefix), tree)


class VarTable:
    """Placement-aware view of the state for the v2 primitive protocol,
    from the JAX package's ``core/kvstore.py``.

    ``push`` returns ``(z, local)``; any ``local`` leaf whose '/'-joined
    key path names a **worker-resident** state leaf (spec
    :data:`DATA_AXIS`) *is* the committed new value of that leaf — the
    commit-through set.  The SSP executor, which defers the sum over
    workers, commits those leaves every round (the read-my-writes
    guarantee) and buffers only the remaining ``local`` leaves until the
    flush, where the app's own ``pull`` is replayed with ``local``
    rebuilt (commit-through entries read back from the live state,
    deferred entries from the buffer).  A push that writes a
    worker-resident leaf in place (LDA's z, B, D) is committed through
    by that write.  ``role="priority"`` leaves get the in-flight
    exclusion (:meth:`mark_scheduled`)."""

    def __init__(self, store: KVStore):
        self.store = store
        self.worker_resident = frozenset(
            n for n, vs in store.specs.items()
            if not is_replicated(vs.spec))
        self.priority_names = frozenset(
            n for n, vs in store.specs.items() if vs.role == "priority")
        # phase -> (local structure, leaf paths, commit-through name set),
        # recorded at the first call so flush-time rebuilds are structural
        self._local_forms: Dict[int, tuple] = {}

    # -- classification ------------------------------------------------------

    def _local_form(self, local: Any, phase: int):
        names = [n for n, _ in named_leaves(local)]
        commit = frozenset(n for n in names if n in self.worker_resident)
        form = (_skeleton(local), names, commit)
        prev = self._local_forms.setdefault(phase, form)
        if prev[1] != names:
            raise ValueError(
                f"push returned a different `local` structure for phase "
                f"{phase}: {prev[1]} vs {names}")
        return form

    # -- the derived commit/defer/rebuild triple ----------------------------

    def commit_local(self, state: Any, local: Any, phase: int) -> Any:
        """The state with the commit-through leaves of ``local`` written
        in (a new dict; runs every round)."""
        _, _, commit = self._local_form(local, phase)
        if not commit:
            return state
        vals = dict(named_leaves(local))
        return map_with_path(
            lambda n, x: vals[n] if n in commit else x, state)

    def defer_local(self, local: Any, phase: int) -> Dict[str, Any]:
        """The flat ``{path: leaf}`` dict of non-commit-through leaves —
        the only part of ``local`` the flush still needs to buffer."""
        _, _, commit = self._local_form(local, phase)
        return {n: leaf for n, leaf in named_leaves(local)
                if n not in commit}

    def rebuild_local(self, state: Any, deferred: Dict[str, Any],
                      phase: int) -> Any:
        """Reconstruct the round's ``local`` tree at flush time:
        commit-through entries read back from the live state (their
        committed values), deferred entries from the buffer."""
        if phase not in self._local_forms:
            raise ValueError(f"no local structure recorded for phase "
                             f"{phase} (defer_local not called)")
        skel, names, commit = self._local_forms[phase]
        svals = dict(named_leaves(state))
        return _fill(skel, {n: svals[n] if n in commit else deferred[n]
                            for n in names})

    # -- in-flight exclusion (role="priority") -------------------------------

    def mark_scheduled(self, view: Any, candidates: Any) -> Any:
        """Exclude in-flight candidates from later schedule proposals in
        the same SSP window: zero their entries in every
        ``role="priority"`` leaf of the scheduling view (a new tensor;
        pending updates are invisible until the flush, so rescheduling
        them would compound the same stale read).  ``candidates`` must be
        an integer index tensor when any priority leaf is declared."""
        if not self.priority_names or candidates is None:
            return view
        idx = torch.as_tensor(candidates)
        if idx.is_floating_point() or idx.is_complex() \
                or idx.dtype == torch.bool:
            raise TypeError(
                f"role='priority' in-flight exclusion needs integer "
                f"candidate indices; got dtype {idx.dtype}")

        def mark(name, x):
            if name not in self.priority_names:
                return x
            out = x.clone()
            out[idx.to(x.device)] = 0
            return out
        return map_with_path(mark, view)


__all__ = ["DATA_AXIS", "KVStore", "VarSpec", "VarTable", "is_replicated",
           "map_with_path", "named_leaves", "path_name", "place",
           "specs_from_tree", "store_from_tree"]
