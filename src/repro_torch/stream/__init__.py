"""Streaming data ingest: new observations flowing into a *running* job,
from the JAX package's ``stream/`` package.

* :class:`StreamSpec` — frozen, JSON-round-trippable policy
  (``"replace"`` swaps named row slots in place, ``"extend"`` appends
  into a capacity-padded ring buffer behind a validity mask);
* :class:`DataSource` — the host-side delta feed (``peek``/``take(t)``),
  with deterministic ``(seed, t)``-derived synthetic sources so any
  worker can rebuild any delta;
* :class:`Ingestor` — applies deltas at the engine's host-synced chunk
  boundaries (where the partitioner rebalances and the serve loop
  publishes), writing only the rows they name.

Like :class:`~repro_torch.serve.spec.ServeSpec`, the spec rides the entry
points — ``StradsEngine.execute(..., stream=, source=)``,
``serve_while_training(..., stream=, source=)``, ``launch/serve.py
--stream`` — never the ExecutionPlan, so a stream knob can never be
silently ignored.  Apps opt in with the ``ingest()``/``ingest_specs()``
primitives (the ingest-injection contract in
:mod:`repro_torch.core.primitives`).
"""
from .ingest import Ingestor, replay_data
from .source import (DataSource, EmptySource, LassoDriftSource,
                     LDADriftSource, MFDriftSource, ScheduledSource,
                     SyntheticLMSource)
from .spec import STREAM_KINDS, StreamSpec

__all__ = [
    "STREAM_KINDS", "StreamSpec",
    "DataSource", "EmptySource", "ScheduledSource",
    "LassoDriftSource", "LDADriftSource", "MFDriftSource",
    "SyntheticLMSource",
    "Ingestor", "replay_data",
]
