"""The declarative observability surface: :class:`TelemetrySpec`.

A copy of the JAX package's ``obs/spec.py`` with the same fields,
validation, error text and JSON, so every plan file reads the same in
both packages.  ``"counters"`` turns on the device counters of
:mod:`repro_torch.obs.counters`; ``"trace"`` adds the host
:class:`~repro_torch.obs.events.Recorder`, and ``profiler=True`` a
``torch.profiler.record_function`` range (``strads.<name>``) around
each of its spans.
"""
from __future__ import annotations

import dataclasses
import json

TELEMETRY_KINDS = ("counters", "trace")

_KIND_MSG = "telemetry kind must be 'counters' or 'trace'; got {!r}"

# Which fields each kind consumes; everything else must stay at its zero
# default (a spec never carries silently-ignored knobs).
_FIELDS_BY_KIND = {
    "counters": (),
    "trace": ("profiler",),
}


@dataclasses.dataclass(frozen=True)
class TelemetrySpec:
    """Everything the engine needs to know about *what* to observe.

    Fields
    ------
    kind:     ``"counters"`` (device-side per-phase/schedule/ρ-filter
              counters in the executor carry — the hot-path-safe floor)
              or ``"trace"`` (counters + the host-side event
              Recorder with phase spans and Chrome-trace export).
    profiler: with ``kind="trace"``: also open a
              ``torch.profiler.record_function`` range around every
              recorded span, so host phases appear inside a
              ``torch.profiler`` trace of the card.
    """

    kind: str
    profiler: bool = False

    def __post_init__(self):
        if self.kind not in TELEMETRY_KINDS:
            raise ValueError(_KIND_MSG.format(self.kind))
        if not isinstance(self.profiler, bool):
            raise ValueError(f"profiler must be a bool; got "
                             f"{self.profiler!r}")
        used = _FIELDS_BY_KIND[self.kind]
        if "profiler" not in used and self.profiler:
            raise ValueError(
                f"profiler={self.profiler!r} does not apply to "
                f"kind={self.kind!r} (leave it at its default)")

    @property
    def events(self) -> bool:
        """True when this spec asks for the host-side event Recorder."""
        return self.kind == "trace"

    # -- serialization -------------------------------------------------------

    def to_json(self) -> dict:
        """A plain JSON-safe dict (every field, defaults included) —
        ``from_json(to_json(s)) == s`` exactly."""
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, obj) -> "TelemetrySpec":
        """Rebuild from ``to_json`` output, a JSON string, or a partial
        dict (missing fields take their defaults; unknown keys raise)."""
        if isinstance(obj, (str, bytes)):
            obj = json.loads(obj)
        if not isinstance(obj, dict):
            raise TypeError(f"TelemetrySpec.from_json wants a dict or "
                            f"JSON string; got {type(obj).__name__}")
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(obj) - known
        if unknown:
            raise ValueError(f"unknown TelemetrySpec field(s): "
                             f"{sorted(unknown)}")
        return cls(**obj)

    @classmethod
    def default_for(cls, kind: str, **overrides) -> "TelemetrySpec":
        """The conventional spec for a kind — the ONE defaults table the
        CLI surfaces (``dryrun --telemetry``) resolve flag-built specs
        from, so per-site copies cannot drift.  ``overrides`` replace
        individual fields on the conventional base."""
        if kind not in TELEMETRY_KINDS:
            raise ValueError(_KIND_MSG.format(kind))
        base = dict(kind=kind)
        base.update(overrides)
        return cls(**base)
