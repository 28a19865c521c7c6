"""The declarative serving surface: :class:`ServeSpec`, from the JAX
package's ``serve/spec.py`` with the same fields, validation, error text,
JSON and ``default_for``.

A cached read may be served while it is at most ``s`` commits old: the
SSP consistency contract of :mod:`repro_torch.ps`.  A ServeSpec makes
the read path declarative, as :class:`~repro_torch.sched.SchedulerSpec`
does scheduling:

* **frozen + hashable** — a spec is a value, usable as a sweep key;
* **validated at construction** — every invalid kind/parameter
  combination raises here, never mid-serve;
* **JSON-round-trippable** — ``to_json``/``from_json`` are exact
  (defaults included), so specs live in records and CLI flags
  (``launch/serve.py --serve-kind``).

The spec is policy only — it never names an app.  What a query computes
comes from the app's ``query()`` primitive; where the served values come
from (the state's server- and worker-resident leaves) comes from the
engine at binding time (:class:`repro_torch.serve.view.ModelView`).
"""
from __future__ import annotations

import dataclasses
import json

SERVE_KINDS = ("stale", "snapshot")

_KIND_MSG = "serve kind must be 'stale' or 'snapshot'; got {!r}"

# Which fields each kind consumes; everything else must stay at its zero
# default (a spec never carries silently-ignored knobs — the same rule
# SchedulerSpec/PartitionerSpec enforce).
_FIELDS_BY_KIND = {
    "stale": ("max_staleness", "max_batch", "batch_window_ms"),
    "snapshot": ("max_batch", "batch_window_ms"),
}


@dataclasses.dataclass(frozen=True)
class ServeSpec:
    """Everything the read path needs to know about *how* model state
    may be served while training continues.

    Fields
    ------
    kind:           ``"stale"`` (serve the SSP-style mixed view:
                    worker-resident leaves read live at the boundary,
                    server-resident leaves through a
                    :class:`~repro_torch.ps.cache.StaleCache` refreshed lazily
                    under the gate ``clock − cache.clock ≤
                    max_staleness`` — cheap, skips snapshot copies while
                    the bound holds), ``"snapshot"`` (pin the *entire*
                    state at each flush/chunk boundary — every leaf from
                    the same clock, a fully consistent view that stays
                    valid across training chunks, even where training
                    writes the state in place, at the price of a full
                    copy per pin).
    max_staleness:  the serving staleness bound in committed rounds
                    (``stale`` only; 0 = refresh the cache at every
                    boundary, the BSP-fresh read).
    max_batch:      most requests one batched query call serves
                    (≥ 1; the micro-batching frontend assembles up to
                    this many queued requests per flush).
    batch_window_ms: how long a partial batch may wait for more
                    requests before it is served anyway (0 = serve
                    partial batches immediately).
    """

    kind: str
    max_staleness: int = 0
    max_batch: int = 1
    batch_window_ms: float = 0.0

    def __post_init__(self):
        if self.kind not in SERVE_KINDS:
            raise ValueError(_KIND_MSG.format(self.kind))
        v = self.max_staleness
        if not isinstance(v, int) or isinstance(v, bool) or v < 0:
            raise ValueError(f"max_staleness must be an int >= 0; "
                             f"got {v!r}")
        v = self.max_batch
        if not isinstance(v, int) or isinstance(v, bool) or v < 1:
            raise ValueError(f"max_batch must be an int >= 1; got {v!r}")
        v = self.batch_window_ms
        if isinstance(v, bool) or not isinstance(v, (int, float)) or v < 0:
            raise ValueError(f"batch_window_ms must be a number >= 0; "
                             f"got {v!r}")
        used = _FIELDS_BY_KIND[self.kind]
        for field in ("max_staleness", "batch_window_ms"):
            if field not in used and getattr(self, field):
                raise ValueError(
                    f"{field}={getattr(self, field)!r} does not apply to "
                    f"kind={self.kind!r} (leave it at its default)")

    # -- serialization -------------------------------------------------------

    def to_json(self) -> dict:
        """A plain JSON-safe dict (every field, defaults included) —
        ``from_json(to_json(s)) == s`` exactly."""
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, obj) -> "ServeSpec":
        """Rebuild from ``to_json`` output, a JSON string, or a partial
        dict (missing fields take their defaults; unknown keys raise)."""
        if isinstance(obj, (str, bytes)):
            obj = json.loads(obj)
        if not isinstance(obj, dict):
            raise TypeError(f"ServeSpec.from_json wants a dict or JSON "
                            f"string; got {type(obj).__name__}")
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(obj) - known
        if unknown:
            raise ValueError(f"unknown ServeSpec field(s): "
                             f"{sorted(unknown)}")
        return cls(**obj)

    @classmethod
    def default_for(cls, kind: str, **overrides) -> "ServeSpec":
        """The conventional spec for a kind — the ONE defaults table the
        CLI surfaces (``launch/serve.py --serve-kind``) resolve
        flag-built specs from, so per-site copies cannot drift.
        ``overrides`` replace individual fields on the conventional
        base."""
        if kind == "stale":
            base = dict(kind=kind, max_staleness=2, max_batch=8)
        elif kind == "snapshot":
            base = dict(kind=kind, max_batch=8)
        else:
            raise ValueError(_KIND_MSG.format(kind))
        base.update(overrides)
        return cls(**base)
