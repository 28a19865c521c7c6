"""The declarative kernel surface: :class:`KernelSpec`.

A copy of the JAX package's ``kernels/spec.py`` with the same fields,
validation, error text and JSON.  ``kind="pallas"`` keeps its name so
that one plan file drives both packages: in the port it selects the
hand-written CUDA kernels of :mod:`repro_torch.kernels.lasso_cd`, with
``block_n`` as their row tile.  Which tensors run where is decided by
the kernels' wrappers from the device of their inputs, never by the spec.
"""
from __future__ import annotations

import dataclasses
import json

KERNEL_KINDS = ("reference", "pallas")

_KIND_MSG = "kernel kind must be 'reference' or 'pallas'; got {!r}"

# Which fields each kind consumes; everything else must stay at its zero
# default (a spec never carries silently-ignored knobs — the same rule
# SchedulerSpec and PartitionerSpec enforce).
_FIELDS_BY_KIND = {
    "reference": (),
    "pallas": ("block_n",),
}


@dataclasses.dataclass(frozen=True)
class KernelSpec:
    """Everything the engine needs to know about *what executes* the
    round body's compute hot-spots.

    Fields
    ------
    kind:     ``"reference"`` (the plain PyTorch versions in
              :mod:`repro_torch.kernels.ref`), ``"pallas"`` (the
              hand-written CUDA kernels of
              :mod:`repro_torch.kernels.lasso_cd`; their wrappers take the
              plain versions for tensors that lie on the CPU).
    block_n:  row tile of the kernels (``pallas`` only; > 0 — 256 is the
              conventional default ``default_for`` fills in; the
              kernels clamp it down to the row count for small shards).
    """

    kind: str
    block_n: int = 0

    def __post_init__(self):
        if self.kind not in KERNEL_KINDS:
            raise ValueError(_KIND_MSG.format(self.kind))
        v = self.block_n
        if not isinstance(v, int) or isinstance(v, bool) or v < 0:
            raise ValueError(f"block_n must be an int >= 0; got {v!r}")
        used = _FIELDS_BY_KIND[self.kind]
        for field in ("block_n",):
            if field not in used and getattr(self, field):
                raise ValueError(
                    f"{field}={getattr(self, field)!r} does not apply to "
                    f"kind={self.kind!r} (leave it at its default)")
        if self.kind == "pallas" and self.block_n < 1:
            raise ValueError(
                f"kind='pallas' needs block_n >= 1 (the row-tile "
                f"size; KernelSpec.default_for('pallas') fills the "
                f"conventional 256); got {self.block_n!r}")

    # -- serialization -------------------------------------------------------

    def to_json(self) -> dict:
        """A plain JSON-safe dict (every field, defaults included) —
        ``from_json(to_json(s)) == s`` exactly."""
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, obj) -> "KernelSpec":
        """Rebuild from ``to_json`` output, a JSON string, or a partial
        dict (missing fields take their defaults; unknown keys raise)."""
        if isinstance(obj, (str, bytes)):
            obj = json.loads(obj)
        if not isinstance(obj, dict):
            raise TypeError(f"KernelSpec.from_json wants a dict or "
                            f"JSON string; got {type(obj).__name__}")
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(obj) - known
        if unknown:
            raise ValueError(f"unknown KernelSpec field(s): "
                             f"{sorted(unknown)}")
        return cls(**obj)

    @classmethod
    def default_for(cls, kind: str, **overrides) -> "KernelSpec":
        """The conventional spec for a kind — the ONE defaults table the
        CLI surfaces (``dryrun --kernels``) resolve flag-built specs
        from, so per-site copies cannot drift.  ``overrides`` replace
        individual fields on the conventional base."""
        if kind == "reference":
            base = dict(kind=kind)
        elif kind == "pallas":
            from .lasso_cd import DEFAULT_BLOCK_N
            base = dict(kind=kind, block_n=DEFAULT_BLOCK_N)
        else:
            raise ValueError(_KIND_MSG.format(kind))
        base.update(overrides)
        return cls(**base)
