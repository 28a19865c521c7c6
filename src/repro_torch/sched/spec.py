"""The declarative scheduling surface: :class:`SchedulerSpec`.

A copy of the JAX package's ``sched/spec.py`` with the same fields,
validation, error text and JSON, so one plan file means the same policy
in both packages.  The spec is policy only; structural dimensions come
from the app at injection time (:func:`repro_torch.sched.build_scheduler`).
"""
from __future__ import annotations

import dataclasses
import json

SCHEDULER_KINDS = ("round_robin", "random", "rotation", "dynamic_priority",
                   "block_structural")

_KIND_MSG = ("scheduler kind must be 'round_robin', 'random', 'rotation', "
             "'dynamic_priority' or 'block_structural'; got {!r}")

# Which fields each kind consumes; everything else must stay at its zero
# default (a spec never carries silently-ignored knobs).
_FIELDS_BY_KIND = {
    "round_robin": ("block_size",),
    "random": ("block_size",),
    "rotation": (),
    "dynamic_priority": ("block_size", "num_candidates", "rho", "eta"),
    "block_structural": ("block_size", "num_candidates", "rho", "eta",
                         "min_distance", "ema"),
}


@dataclasses.dataclass(frozen=True)
class SchedulerSpec:
    """Everything the engine needs to know about *which* variables to
    schedule each round.

    Fields
    ------
    kind:           ``"round_robin"`` (fixed cyclic blocks — STRADS MF),
                    ``"random"`` (uniform blocks, the Shotgun / Lasso-RR
                    baseline), ``"rotation"`` (disjoint block rotation —
                    STRADS LDA), ``"dynamic_priority"`` (priority sampling
                    + Gram ρ-filter — STRADS Lasso, paper §3.3),
                    ``"block_structural"`` (dynamic priorities with the
                    graph-distance ρ-filter — the beyond-paper deep-net
                    block scheduler).
    block_size:     U — concurrent updates per round (0 for ``rotation``,
                    whose blocks are the worker partition).
    num_candidates: U′ — proposal pool for the dynamic kinds (≥ U).
    rho:            ρ — dependency threshold (> 0; values > 1 disable
                    the filter, a legal degenerate sweep point).  For
                    ``dynamic_priority`` the Gram bound |x_jᵀx_k| < ρ;
                    for ``block_structural`` the threshold over the 0/1
                    structural gram (any value in (0, 1] admits exactly
                    the distance-filtered set — ``min_distance`` is the
                    real knob there, 0.5 the conventional value).
    eta:            η — exploration floor added to the priorities
                    (dynamic kinds only; ≥ 0).
    min_distance:   graph-distance radius of the structural filter
                    (``block_structural`` only): blocks closer than this
                    are never co-scheduled.
    ema:            priority EMA decay for ``block_structural`` (the
                    trainer folds per-block update norms into priorities
                    with this decay; 0 ≤ ema < 1).
    """

    kind: str
    block_size: int = 0
    num_candidates: int = 0
    rho: float = 0.0
    eta: float = 0.0
    min_distance: int = 0
    ema: float = 0.0

    def __post_init__(self):
        if self.kind not in SCHEDULER_KINDS:
            raise ValueError(_KIND_MSG.format(self.kind))
        for field in ("block_size", "num_candidates", "min_distance"):
            v = getattr(self, field)
            if not isinstance(v, int) or isinstance(v, bool) or v < 0:
                raise ValueError(f"{field} must be an int >= 0; got {v!r}")
        for field in ("rho", "eta", "ema"):
            v = getattr(self, field)
            if isinstance(v, bool) or not isinstance(v, (int, float)) \
                    or v < 0:
                raise ValueError(f"{field} must be a number >= 0; "
                                 f"got {v!r}")
        used = _FIELDS_BY_KIND[self.kind]
        for field in ("block_size", "num_candidates", "rho", "eta",
                      "min_distance", "ema"):
            if field not in used and getattr(self, field):
                raise ValueError(
                    f"{field}={getattr(self, field)!r} does not apply to "
                    f"kind={self.kind!r} (leave it at its default)")
        if "block_size" in used and self.block_size < 1:
            raise ValueError(f"kind={self.kind!r} needs block_size >= 1; "
                             f"got {self.block_size!r}")
        if "num_candidates" in used:
            if self.num_candidates < self.block_size:
                raise ValueError(
                    f"num_candidates (U') must be >= block_size (U); got "
                    f"U'={self.num_candidates} < U={self.block_size}")
            if self.rho <= 0:
                raise ValueError(
                    f"kind={self.kind!r} needs rho > 0 (rho = 0 admits "
                    f"no candidate at all; rho > 1 is legal and disables "
                    f"the filter); got {self.rho!r}")
        if self.kind == "block_structural":
            if self.min_distance < 1:
                raise ValueError(f"block_structural needs min_distance "
                                 f">= 1; got {self.min_distance!r}")
            if not 0 <= self.ema < 1:
                raise ValueError(f"ema must be in [0, 1); got "
                                 f"{self.ema!r}")

    # -- serialization -------------------------------------------------------

    def to_json(self) -> dict:
        """A plain JSON-safe dict (every field, defaults included) —
        ``from_json(to_json(s)) == s`` exactly."""
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, obj) -> "SchedulerSpec":
        """Rebuild from ``to_json`` output, a JSON string, or a partial
        dict (missing fields take their defaults; unknown keys raise)."""
        if isinstance(obj, (str, bytes)):
            obj = json.loads(obj)
        if not isinstance(obj, dict):
            raise TypeError(f"SchedulerSpec.from_json wants a dict or JSON "
                            f"string; got {type(obj).__name__}")
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(obj) - known
        if unknown:
            raise ValueError(f"unknown SchedulerSpec field(s): "
                             f"{sorted(unknown)}")
        return cls(**obj)

    @classmethod
    def default_for(cls, kind: str, block_size: int = 32,
                    num_candidates: int = 0,
                    **overrides) -> "SchedulerSpec":
        """The conventional spec for a kind — the ONE defaults table the
        CLI surfaces (``dryrun --scheduler``, ``train --scheduler``)
        resolve flag-built specs from, so per-site copies cannot drift.
        ``overrides`` replace individual fields on the conventional
        base."""
        if kind == "rotation":
            base = dict(kind=kind)
        elif kind in ("round_robin", "random"):
            base = dict(kind=kind, block_size=block_size)
        elif kind == "dynamic_priority":
            base = dict(kind=kind, block_size=block_size,
                        num_candidates=num_candidates or 4 * block_size,
                        rho=0.3, eta=1e-6)
        elif kind == "block_structural":
            base = dict(kind=kind, block_size=block_size,
                        num_candidates=num_candidates or 2 * block_size,
                        rho=0.5, eta=1e-3, min_distance=2, ema=0.9)
        else:
            raise ValueError(_KIND_MSG.format(kind))
        base.update(overrides)
        return cls(**base)
