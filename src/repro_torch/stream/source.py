"""Where streamed deltas come from: the :class:`DataSource` protocol,
from the JAX package's ``stream/source.py``.

A source is host-side and *deterministic in* ``t`` — everything each
delta contains is derived from ``(seed, t)`` with the same regeneration
idiom as :mod:`repro_torch.data.pipeline` (``seed * 1_000_003 + t``), so
any worker can rebuild any delta and a crashed run can replay the exact
stream it had ingested (see :func:`repro_torch.stream.ingest.replay_data`).
The drift sources make the same numpy calls in the same order as the JAX
package's, so ``take(t)`` gives its arrays to the bit.  A delta's arrays
may also be tensors, on any device: the apps' ``ingest`` takes either.

The delta contract
------------------
``take(t)`` returns ``None`` (nothing due at boundary ``t``) or a
*list* of delta dicts.  Each delta carries per-row arrays with a shared
leading axis ``k``:

* ``"data"`` — ``{leaf_name: (k, ...) array}`` for every streamable
  leaf the app's ``ingest_specs()`` names (all of them, every delta);
* ``"rows"`` — ``(k,)`` int row slots to overwrite (``"replace"``
  kind only; ``"extend"`` computes slots from the ring cursor);
* app extras — additional per-row ``(k,)`` arrays some apps need to
  keep derived state consistent (LDA wants a ``"z"`` topic draw per
  ingested token).

Returning a *list* is deliberate: the
:class:`~repro_torch.stream.ingest.Ingestor`
applies the entries in order, and trajectories must depend only on the
(data, delta-schedule) pair — splitting one delta into several at the
same boundary changes nothing (``tests/test_torch_stream.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Protocol, runtime_checkable

import numpy as np

from ..data.pipeline import SyntheticLMConfig, make_batch


def _delta_rows(delta: dict) -> int:
    """Leading-axis length of a delta's per-row arrays."""
    for leaf in delta.get("data", {}).values():
        return int(np.shape(leaf)[0])
    return 0


@runtime_checkable
class DataSource(Protocol):
    """Host-side feed of data-pytree deltas, polled at chunk
    boundaries."""

    def peek(self, t: int) -> int:
        """Rows due at boundary ``t`` without consuming them."""
        ...

    def take(self, t: int) -> Optional[List[dict]]:
        """The deltas due at boundary ``t`` (see the module docstring
        for the delta contract), or ``None``."""
        ...


class EmptySource:
    """The no-op source: a streamed run with it is bit-identical to an
    unstreamed ``execute()``."""

    def peek(self, t: int) -> int:
        return 0

    def take(self, t: int) -> Optional[List[dict]]:
        return None


class ScheduledSource:
    """A fixed ``{t: delta-or-list}`` table — the test/bench workhorse
    for handing the Ingestor an exact delta schedule."""

    def __init__(self, deltas: Dict[int, object]):
        self._deltas = {
            int(t): list(d) if isinstance(d, (list, tuple)) else [d]
            for t, d in deltas.items()}

    def peek(self, t: int) -> int:
        return sum(_delta_rows(d) for d in self._deltas.get(t, ()))

    def take(self, t: int) -> Optional[List[dict]]:
        return self._deltas.get(t)


def _rng(seed: int, t: int) -> np.random.Generator:
    # the (seed, step) regeneration idiom of data.pipeline
    return np.random.default_rng(seed * 1_000_003 + t)


@dataclasses.dataclass
class LassoDriftSource:
    """Replace-kind drift for the lasso app: every ``t > 0`` boundary
    refreshes ``rows_per_ingest`` observation rows drawn from a slowly
    drifting ground-truth ``beta`` — so the objective genuinely moves
    under ingest."""

    num_rows: int
    num_features: int
    rows_per_ingest: int = 8
    k_true: int = 8
    noise: float = 0.1
    drift: float = 0.05
    seed: int = 0

    def _beta(self, t: int) -> np.ndarray:
        base = np.random.default_rng(self.seed)
        beta = np.zeros(self.num_features)
        idx = base.choice(self.num_features,
                          size=min(self.k_true, self.num_features),
                          replace=False)
        beta[idx] = base.normal(size=idx.size) * (1.0 + self.drift * t)
        return beta

    def peek(self, t: int) -> int:
        return self.rows_per_ingest if t > 0 else 0

    def take(self, t: int) -> Optional[List[dict]]:
        if t <= 0:
            return None
        rng = _rng(self.seed, t)
        k = min(self.rows_per_ingest, self.num_rows)
        rows = np.sort(rng.choice(self.num_rows, size=k, replace=False))
        # the lasso update rule assumes unit-L2 design columns; fresh
        # rows at the original per-entry scale 1/sqrt(n) keep column
        # norms ~1 so coordinate descent stays contractive under drift
        X = (rng.normal(size=(k, self.num_features))
             / np.sqrt(self.num_rows)).astype(np.float32)
        y = (X @ self._beta(t)
             + self.noise * rng.normal(size=k)).astype(np.float32)
        return [{"rows": rows, "data": {"X": X, "y": y}}]


@dataclasses.dataclass
class MFDriftSource:
    """Drift for the MF app: each ``t > 0`` boundary produces
    ``rows_per_ingest`` fresh user rows of low-rank-plus-noise ratings.
    ``kind="replace"`` names the user slots to refresh; ``"extend"``
    leaves slot choice to the ring cursor (new users arriving)."""

    num_rows: int
    num_cols: int
    rows_per_ingest: int = 4
    true_rank: int = 4
    density: float = 0.3
    noise: float = 0.05
    kind: str = "extend"
    seed: int = 0

    def peek(self, t: int) -> int:
        return self.rows_per_ingest if t > 0 else 0

    def take(self, t: int) -> Optional[List[dict]]:
        if t <= 0:
            return None
        base = np.random.default_rng(self.seed)
        V = base.normal(size=(self.true_rank, self.num_cols))
        rng = _rng(self.seed, t)
        k = min(self.rows_per_ingest, self.num_rows)
        U = rng.normal(size=(k, self.true_rank))
        A = (U @ V + self.noise * rng.normal(
            size=(k, self.num_cols))).astype(np.float32)
        mask = (rng.random((k, self.num_cols))
                < self.density).astype(np.float32)
        delta = {"data": {"A": A, "mask": mask}}
        if self.kind == "replace":
            delta["rows"] = np.sort(
                rng.choice(self.num_rows, size=k, replace=False))
        return [delta]


@dataclasses.dataclass
class LDADriftSource:
    """Drift for the LDA app: each ``t > 0`` boundary delivers
    ``tokens_per_ingest`` fresh tokens (word id, local doc id, and the
    initial topic draw ``z`` the collapsed counts need).  ``"extend"``
    slides the token window; ``"replace"`` resamples existing slots."""

    num_tokens: int
    vocab: int
    num_topics: int
    docs_per_worker: int
    tokens_per_ingest: int = 8
    kind: str = "extend"
    seed: int = 0

    def peek(self, t: int) -> int:
        return self.tokens_per_ingest if t > 0 else 0

    def take(self, t: int) -> Optional[List[dict]]:
        if t <= 0:
            return None
        rng = _rng(self.seed, t)
        k = min(self.tokens_per_ingest, self.num_tokens)
        words = rng.integers(0, self.vocab, size=k).astype(np.int32)
        docs = rng.integers(0, self.docs_per_worker,
                            size=k).astype(np.int32)
        z = rng.integers(0, self.num_topics, size=k).astype(np.int32)
        delta = {"data": {"words": words, "docs": docs}, "z": z}
        if self.kind == "replace":
            delta["rows"] = np.sort(
                rng.choice(self.num_tokens, size=k, replace=False))
        return [delta]


@dataclasses.dataclass
class SyntheticLMSource:
    """The :mod:`repro_torch.data.pipeline` token stream as a
    :class:`DataSource`: one :func:`~repro_torch.data.pipeline.make_batch`
    per boundary, derived entirely from ``(cfg.seed, t)`` (the port's
    draws, which differ from the JAX package's PRNG).
    :func:`~repro_torch.data.pipeline.synthetic_batches` iterates this
    source, so the trainer-facing generator and the streaming subsystem
    share one batch-derivation path."""

    cfg: SyntheticLMConfig
    kwargs: Optional[dict] = None

    def peek(self, t: int) -> int:
        return self.cfg.batch_size

    def take(self, t: int) -> Optional[List[dict]]:
        return [{"data": make_batch(self.cfg, t, **(self.kwargs or {}))}]
