"""The :class:`Ingestor`: applies :class:`~repro_torch.stream.source.DataSource`
deltas to a running job at host-synced chunk boundaries, from the JAX
package's ``stream/ingest.py``.

The engine's chunked execution loop is the only place model state and
data are host-visible between spans — the partitioner already
rebalances there, checkpoints already save there, the serve loop already
publishes there.  The Ingestor rides the same boundaries:

* ``"replace"`` overwrites the row slots each delta names;
* ``"extend"`` appends rows as if one at a time into a capacity-padded
  ring buffer: new rows land in the padding slots first (the app's
  ``ingest_specs()["valid"]`` mask says which slots hold real rows at
  bind time), then wrap around and overwrite the oldest rows.  Data
  shapes never change.

The rows are global rows of the data: the app maps each to its worker
and local row the way ``StradsEngine.shard_data`` placed them.  The
port's ``ingest`` writes those rows, and the derived state of those
rows, **into the tensors the engine runs on** (the JAX package's arrays
are immutable and it makes new ones; at the chip shapes a copy of MF's
A, mask or R is 9.3 GB).  So a streamed run changes the data tensors it
was handed, and the state tensors the boundary holds: a caller who
replays from the original data or keeps a state must copy it first.  A
leaf the app hands back off the engine's device is moved there; every
other leaf comes back as the very same object, and an off-cadence
boundary or an empty source returns the very same dicts.

The cursor (``cursor``/``rows_in``/``rows_dropped``/``fill0``) is plain
numpy int64 and rides the checkpoint payload beside ``"state"`` /
``"carry"`` / ``"assignment"``, so a mid-stream checkpoint resumes
bit-exactly: restore it with ``execute(..., stream_state=...)`` and
rebuild the data a resumed process no longer holds with
:func:`replay_data`.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core.kvstore import DATA_AXIS
from .source import _delta_rows
from .spec import StreamSpec

_CURSOR_KEYS = ("cursor", "rows_in", "rows_dropped", "fill0")


def _on(device: torch.device, x: torch.Tensor) -> bool:
    return x.device.type == device.type and (
        device.index is None or x.device.index == device.index)


def _place_changed(engine, tree: dict) -> dict:
    """``tree`` with every tensor leaf that is not on the engine's device
    moved there; the others are the very same objects."""
    dev = engine.device
    return {k: (v.to(dev) if torch.is_tensor(v) and not _on(dev, v) else v)
            for k, v in tree.items()}


def _host_rows(rows) -> np.ndarray:
    """A delta's ``rows`` as host int64 (one read when they are a tensor
    on the card)."""
    if torch.is_tensor(rows):
        rows = rows.detach().cpu().numpy()
    return np.asarray(rows, np.int64)


def _tail(val, keep: int):
    if torch.is_tensor(val):
        return val[val.shape[0] - keep:]
    val = np.asarray(val)
    return val[val.shape[0] - keep:]


def _slice_delta(delta: dict, keep: int) -> dict:
    """The last ``keep`` rows of every per-row array in a delta."""
    if keep >= _delta_rows(delta):
        return delta
    return {key: ({leaf: _tail(v, keep) for leaf, v in val.items()}
                  if key == "data" else _tail(val, keep))
            for key, val in delta.items()}


def _num_rows(engine, name: str, x) -> int:
    """The global row count of data leaf ``name``: a row-split leaf is
    laid out (W, n/W, …)."""
    if engine.data_specs.get(name) == DATA_AXIS:
        return int(x.shape[0]) * int(x.shape[1])
    return int(x.shape[0])


class Ingestor:
    """Binds a (:class:`StreamSpec`, :class:`DataSource`) pair to one
    engine and data dict and applies deltas at boundaries."""

    def __init__(self, spec: StreamSpec, source):
        if not isinstance(spec, StreamSpec):
            raise TypeError(f"stream= wants a StreamSpec; "
                            f"got {type(spec).__name__}")
        if not callable(getattr(source, "take", None)):
            raise TypeError(f"source= wants a DataSource (peek/take); "
                            f"got {type(source).__name__}")
        self.spec = spec
        self.source = source
        self.cursor = 0        # extend: rows ever offered to the ring
        self.rows_in = 0       # rows actually written into the buffer
        self.rows_dropped = 0  # delta rows that could never land
        self.fill0 = 0         # extend: valid rows at bind time
        self.capacity = 0
        self._leaves: tuple = ()
        self._total_rows = 0
        self._bound = False
        self._restored = False

    # -- lifecycle -----------------------------------------------------------

    def bind(self, engine, data) -> "Ingestor":
        """Resolve the app's ingest primitives against one data dict (row
        count, streamable leaves, initial ring fill: one host read of the
        validity mask's sum for a fresh extend stream)."""
        from ..core.primitives import StradsAppBase
        app = engine.app
        for prim in ("ingest", "ingest_specs"):
            fn = getattr(type(app), prim, None)
            if fn is None or fn is getattr(StradsAppBase, prim):
                raise NotImplementedError(
                    f"{type(app).__name__} declares no {prim}() primitive "
                    f"— streaming (repro_torch.stream) needs ingest() and "
                    f"ingest_specs(); see the ingest-injection contract "
                    f"in repro_torch.core.primitives")
        kinds = getattr(app, "supported_stream_kinds", None)
        if kinds is not None and self.spec.kind not in kinds:
            raise ValueError(
                f"{type(app).__name__} supports stream kinds {kinds}; "
                f"spec wants {self.spec.kind!r}")
        isp = app.ingest_specs()
        self._leaves = tuple(isp["leaves"])
        first = self._leaves[0]
        self._total_rows = _num_rows(engine, first, data[first])
        if self.spec.capacity > self._total_rows:
            raise ValueError(
                f"capacity={self.spec.capacity} exceeds the data's "
                f"{self._total_rows} rows")
        self.capacity = self.spec.capacity or self._total_rows
        if self.spec.kind == "extend" and not self._restored:
            valid = isp.get("valid")
            self.fill0 = (int(valid(data).sum())
                          if valid is not None else 0)
        self._bound = True
        return self

    def payload(self) -> dict:
        """The stream cursor as flat numpy — rides the checkpoint
        payload beside ``"state"``/``"carry"``/``"assignment"``."""
        return {k: np.int64(getattr(self, k)) for k in _CURSOR_KEYS}

    def restore(self, payload: dict) -> "Ingestor":
        """Adopt a checkpointed cursor (call before :meth:`bind`, or
        pass ``stream_state=`` to ``execute`` which does both)."""
        missing = [k for k in _CURSOR_KEYS if k not in payload]
        if missing:
            raise ValueError(f"stream payload missing {missing}")
        for k in _CURSOR_KEYS:
            setattr(self, k, int(np.asarray(payload[k])))
        self._restored = True
        return self

    # -- the boundary step ---------------------------------------------------

    def step(self, engine, state, data, t: int):
        """Apply whatever the source has due at boundary ``t``; returns
        ``(state, data)``.  A no-op — the very same objects back, no
        transfers, no draws — when ``t`` is off cadence or the source
        has nothing, which is what makes an empty-source streamed run
        bit-identical to an unstreamed one.  ``state=None`` applies the
        data-leaf writes only (the :func:`replay_data` path)."""
        if not self._bound:
            raise RuntimeError("Ingestor.step before bind()")
        if t % self.spec.ingest_every != 0:
            return state, data
        deltas = self.source.take(t)
        if not deltas:
            return state, data
        if isinstance(deltas, dict):
            deltas = [deltas]
        if state is not None:
            # a state restored on another device comes to the engine's
            state = _place_changed(engine, state)
        with engine._obs_span("ingest", t=t, deltas=len(deltas)):
            for delta in deltas:
                rows, delta = self._slots(delta)
                if rows.size == 0:
                    continue
                new_data, new_state = engine.app.ingest(
                    data, state, rows, delta)
                data = _place_changed(engine, new_data)
                if state is not None:
                    state = _place_changed(engine, new_state)
                engine._obs_event("ingest_rows", t=t,
                                  rows_in=int(rows.size),
                                  rows_dropped=self.rows_dropped)
        return state, data

    def _slots(self, delta: dict):
        """Row slots for one delta (+ the delta, tail-sliced if the
        ring cannot hold all of it), advancing the cursor."""
        k = _delta_rows(delta)
        if k == 0:
            return np.zeros((0,), np.int64), delta
        if self.spec.kind == "replace":
            rows = _host_rows(delta["rows"])
            if rows.shape != (k,):
                raise ValueError(
                    f"replace delta rows shape {rows.shape} != ({k},)")
            if np.unique(rows).size != k:
                raise ValueError("replace delta rows must be unique")
            if rows.size and (rows.min() < 0
                              or rows.max() >= self._total_rows):
                raise ValueError(
                    f"replace delta rows out of range [0, "
                    f"{self._total_rows})")
            self.rows_in += k
            return rows, delta
        # extend: append as if row-by-row; a delta larger than the ring
        # keeps only its last `capacity` rows (the earlier ones would be
        # overwritten before the next round ever saw them)
        keep = min(k, self.capacity)
        dropped = k - keep
        start = self.fill0 + self.cursor + dropped
        rows = (start + np.arange(keep, dtype=np.int64)) % self.capacity
        self.cursor += k
        self.rows_in += keep
        self.rows_dropped += dropped
        return rows, _slice_delta(delta, keep)


def replay_data(engine, data, spec: StreamSpec, source,
                t_upto: int, stream_state: Optional[dict] = None):
    """Rebuild the data a resumed process no longer holds: re-apply every
    boundary ``t < t_upto`` of a deterministic source to the *original*
    data (data-only — derived state comes from the checkpoint, never
    double-applied).  The writes go into ``data``'s tensors.  Returns
    ``(data, ingestor)``; the ingestor's cursor equals the checkpointed
    ``"stream"`` payload (pass it as ``stream_state=`` to verify)."""
    ing = Ingestor(spec, source).bind(engine, data)
    for t in range(0, t_upto, spec.ingest_every):
        _, data = ing.step(engine, None, data, t)
    if stream_state is not None:
        got, want = ing.payload(), stream_state
        for key in _CURSOR_KEYS:
            if int(np.asarray(want[key])) != int(got[key]):
                raise ValueError(
                    f"replayed stream cursor {key}={int(got[key])} != "
                    f"checkpointed {int(np.asarray(want[key]))} (source "
                    f"or t_upto does not match the original run)")
    return data, ing
