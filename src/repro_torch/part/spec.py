"""The declarative partitioning surface: :class:`PartitionerSpec`.

A copy of the JAX package's ``part/spec.py`` with the same fields,
validation, error text and JSON, so that every plan file reads the
same in both packages.  :func:`repro_torch.part.build_partitioner`
resolves it.
"""
from __future__ import annotations

import dataclasses
import json

PARTITIONER_KINDS = ("static", "size_balanced", "load_balanced")

_KIND_MSG = ("partitioner kind must be 'static', 'size_balanced' or "
             "'load_balanced'; got {!r}")

# Which fields each kind consumes; everything else must stay at its zero
# default (a spec never carries silently-ignored knobs — the same rule
# SchedulerSpec enforces).
_FIELDS_BY_KIND = {
    "static": (),
    "size_balanced": (),
    "load_balanced": ("rebalance_every", "ema", "imbalance_threshold"),
}


@dataclasses.dataclass(frozen=True)
class PartitionerSpec:
    """Everything the engine needs to know about *where* model variables
    live (and when they may move).

    Fields
    ------
    kind:           ``"static"`` (the frozen contiguous partition —
                    variable j lives on worker ``j·U//J`` forever; the
                    bit-identical pre-refactor behavior),
                    ``"size_balanced"`` (greedy bin-packing on
                    per-variable *bytes* once at init — 1411.2305-style
                    block ownership; never moves afterwards),
                    ``"load_balanced"`` (tracks per-variable update
                    activity and greedily re-bins variables to equalize
                    per-worker load at chunk boundaries — the
                    1312.5766-style dynamic placement).
    rebalance_every: minimum rounds between rebalances
                    (``load_balanced`` only; the engine only *checks* at
                    ``plan.checkpoint_every`` chunk boundaries, so a
                    nonzero cadence must be a multiple of the chunk
                    length; 0 = every chunk boundary is eligible).
    ema:            activity EMA decay (``load_balanced`` only;
                    0 ≤ ema < 1, 0 = no memory — each chunk's activity
                    replaces the last).
    imbalance_threshold: relative per-worker load spread
                    ``(max − min) / mean`` above which a rebalance fires
                    (``load_balanced`` only; ≥ 0, 0 = rebalance on any
                    imbalance).
    """

    kind: str
    rebalance_every: int = 0
    ema: float = 0.0
    imbalance_threshold: float = 0.0

    def __post_init__(self):
        if self.kind not in PARTITIONER_KINDS:
            raise ValueError(_KIND_MSG.format(self.kind))
        v = self.rebalance_every
        if not isinstance(v, int) or isinstance(v, bool) or v < 0:
            raise ValueError(f"rebalance_every must be an int >= 0; "
                             f"got {v!r}")
        for field in ("ema", "imbalance_threshold"):
            v = getattr(self, field)
            if isinstance(v, bool) or not isinstance(v, (int, float)) \
                    or v < 0:
                raise ValueError(f"{field} must be a number >= 0; "
                                 f"got {v!r}")
        used = _FIELDS_BY_KIND[self.kind]
        for field in ("rebalance_every", "ema", "imbalance_threshold"):
            if field not in used and getattr(self, field):
                raise ValueError(
                    f"{field}={getattr(self, field)!r} does not apply to "
                    f"kind={self.kind!r} (leave it at its default)")
        if self.kind == "load_balanced" and not 0 <= self.ema < 1:
            raise ValueError(f"ema must be in [0, 1); got {self.ema!r}")

    # -- serialization -------------------------------------------------------

    def to_json(self) -> dict:
        """A plain JSON-safe dict (every field, defaults included) —
        ``from_json(to_json(s)) == s`` exactly."""
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, obj) -> "PartitionerSpec":
        """Rebuild from ``to_json`` output, a JSON string, or a partial
        dict (missing fields take their defaults; unknown keys raise)."""
        if isinstance(obj, (str, bytes)):
            obj = json.loads(obj)
        if not isinstance(obj, dict):
            raise TypeError(f"PartitionerSpec.from_json wants a dict or "
                            f"JSON string; got {type(obj).__name__}")
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(obj) - known
        if unknown:
            raise ValueError(f"unknown PartitionerSpec field(s): "
                             f"{sorted(unknown)}")
        return cls(**obj)

    @classmethod
    def default_for(cls, kind: str, **overrides) -> "PartitionerSpec":
        """The conventional spec for a kind — the ONE defaults table the
        CLI surfaces (``dryrun --partitioner``) resolve flag-built specs
        from, so per-site copies cannot drift.  ``overrides`` replace
        individual fields on the conventional base."""
        if kind in ("static", "size_balanced"):
            base = dict(kind=kind)
        elif kind == "load_balanced":
            base = dict(kind=kind, ema=0.5, imbalance_threshold=0.1)
        else:
            raise ValueError(_KIND_MSG.format(kind))
        base.update(overrides)
        return cls(**base)
