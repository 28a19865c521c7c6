"""The declarative streaming surface: :class:`StreamSpec`, from the JAX
package's ``stream/spec.py`` (the same fields, errors and JSON).

The paper's STRADS workers assume a fixed data shard per worker — the
engine places the data once (``StradsEngine.shard_data``) and every
round reads it.  A :class:`StreamSpec` makes the *write* half of that
story declarative, as :class:`~repro_torch.serve.spec.ServeSpec` made
the read half:

* **frozen + hashable** — a spec is a value, usable as a sweep key;
* **validated at construction** — every invalid kind/parameter
  combination raises here, at spec-build time, never mid-ingest;
* **JSON-round-trippable** — ``to_json``/``from_json`` are exact
  (defaults included), so specs live inside run records and CLI
  flags (``launch/serve.py --stream``).

The spec is policy only — it never names an app.  *What* an ingested
delta means (which leaves, how derived state catches up) comes from the
app's ``ingest()``/``ingest_specs()`` primitives; *where* deltas come
from is a :class:`~repro_torch.stream.source.DataSource` bound beside
the spec at the entry points (``execute(..., stream=, source=)``); *when*
they land is this spec's cadence — always at host-synced chunk
boundaries, the same places the partitioner rebalances and the serve
loop publishes.
"""
from __future__ import annotations

import dataclasses
import json

STREAM_KINDS = ("replace", "extend")

_KIND_MSG = "stream kind must be 'replace' or 'extend'; got {!r}"

# Which fields each kind consumes; everything else must stay at its zero
# default (a spec never carries silently-ignored knobs — the same rule
# SchedulerSpec/PartitionerSpec/ServeSpec enforce).
_FIELDS_BY_KIND = {
    "replace": ("ingest_every",),
    "extend": ("ingest_every", "capacity"),
}


@dataclasses.dataclass(frozen=True)
class StreamSpec:
    """Everything the ingest path needs to know about *how* new data may
    flow into a running job.

    Fields
    ------
    kind:         ``"replace"`` (each delta names the row slots it
                  overwrites — corrected labels, refreshed ratings; the
                  data shapes and the row→worker placement never
                  change), ``"extend"`` (each delta appends rows into a
                  capacity-padded ring buffer with a validity mask —
                  new observations land in padding slots first, then
                  wrap around and overwrite the oldest rows, so data
                  shapes stay static and every tensor the rounds read
                  keeps its storage).
    ingest_every: the ingest cadence in rounds (≥ 1).  Deltas land at
                  host-synced boundaries ``t % ingest_every == 0``; the
                  engine requires it to be a multiple of the executor's
                  step length, the same alignment rule
                  ``checkpoint_every`` obeys.
    capacity:     ring-buffer size in rows (``extend`` only; 0 = the
                  data's whole row axis).  Appends beyond it overwrite
                  the oldest rows; delta rows that can never land
                  (a single delta larger than the ring) are counted as
                  dropped.
    """

    kind: str
    ingest_every: int = 1
    capacity: int = 0

    def __post_init__(self):
        if self.kind not in STREAM_KINDS:
            raise ValueError(_KIND_MSG.format(self.kind))
        v = self.ingest_every
        if not isinstance(v, int) or isinstance(v, bool) or v < 1:
            raise ValueError(f"ingest_every must be an int >= 1; "
                             f"got {v!r}")
        v = self.capacity
        if not isinstance(v, int) or isinstance(v, bool) or v < 0:
            raise ValueError(f"capacity must be an int >= 0; got {v!r}")
        used = _FIELDS_BY_KIND[self.kind]
        for field in ("capacity",):
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
    def from_json(cls, obj) -> "StreamSpec":
        """Rebuild from ``to_json`` output, a JSON string, or a partial
        dict (missing fields take their defaults; unknown keys raise)."""
        if isinstance(obj, (str, bytes)):
            obj = json.loads(obj)
        if not isinstance(obj, dict):
            raise TypeError(f"StreamSpec.from_json wants a dict or JSON "
                            f"string; got {type(obj).__name__}")
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(obj) - known
        if unknown:
            raise ValueError(f"unknown StreamSpec field(s): "
                             f"{sorted(unknown)}")
        return cls(**obj)

    @classmethod
    def default_for(cls, kind: str, **overrides) -> "StreamSpec":
        """The conventional spec for a kind — the ONE defaults table the
        CLI surfaces (``launch/serve.py --stream-kind``) resolve
        flag-built specs from, so per-site copies cannot drift.
        ``overrides`` replace individual fields on the conventional
        base."""
        if kind == "replace":
            base = dict(kind=kind, ingest_every=1)
        elif kind == "extend":
            base = dict(kind=kind, ingest_every=1)
        else:
            raise ValueError(_KIND_MSG.format(kind))
        base.update(overrides)
        return cls(**base)
