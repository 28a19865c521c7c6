"""The serving read path: :class:`ModelView`, from the JAX package's
``serve/view.py``.

A ModelView is the bridge between the training loop and the request
frontend: training *publishes* committed state at its flush/chunk
boundaries (the points where the host holds the state between rounds,
the same boundaries the partitioner and the checkpoints use), and
serving *reads* a view whose consistency the
:class:`~repro_torch.serve.spec.ServeSpec` declares:

* ``kind="stale"`` reuses the SSP read machinery: the server-resident
  leaves (:meth:`~repro_torch.ps.server.ParameterServer.snapshot`) are
  served through a :class:`~repro_torch.ps.cache.StaleCache`, refreshed
  lazily under the gate ``clock − cache.clock ≤ max_staleness``; the
  worker-resident leaves come from the state at the boundary (the
  read-my-writes half of SSP).
* ``kind="snapshot"`` pins a copy of the *entire* state at each publish,
  so every leaf is from the same clock and the view stays valid across
  training chunks.

The port writes some state in place (LDA's push updates z, B and D),
where the JAX package's arrays are immutable and only donation could
take them away.  So every pin and every cache refresh is a ``clone()``,
and the stale kind's references to the boundary state are
boundary-scoped: :meth:`ModelView.release` drops them before training
takes the state back, and a read after it raises
:class:`StaleReadError` until the next publish.  No view ever serves a
tensor the next chunk overwrote.

Every read is logged as ``{"t", "clock", "staleness"}``: the measured
staleness-at-read is what the bound is checked against.  On a Recorder
(the one the view is given, attached to the engine when the engine has
none; else the engine's, looked up at each publish and read) every
publish is a ``serve_publish`` span with its device time
(``device=True``: the stale cache's refresh copies count), and reads,
refreshes and pins are instants.  Reads never
write: the view touches neither the training noise stream nor the
engine carry, which is what makes ``serve_while_training`` equal to an
unserved ``execute()`` to the bit.
"""
from __future__ import annotations

from typing import Any, List, Optional

import torch

from ..ps.cache import StaleCache
from ..ps.server import ParameterServer
from .spec import ServeSpec


class StaleReadError(RuntimeError):
    """A read the ServeSpec's consistency contract cannot serve: nothing
    published yet, the boundary state was released back to training, or
    the staleness gate failed to hold (a bug, since publish refreshes
    under the gate)."""


def _copy_tree(tree):
    """A copy of a state tree with every tensor cloned: served values must
    survive the next chunk's in-place writes (LDA's z, B and D)."""
    if isinstance(tree, dict):
        return {k: _copy_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_copy_tree(v) for v in tree)
    return tree.clone() if torch.is_tensor(tree) else tree


class ModelView:
    """A bounded-staleness view of an engine's model state.

    ``publish(state, t)`` is called by the training side at every
    flush/chunk boundary with the committed state and the round clock,
    and ``release()`` before the next chunk runs; ``read()`` returns
    ``(state_view, staleness_at_read)`` for the query calls.  The view
    never changes what it is given.
    """

    def __init__(self, engine, spec: ServeSpec,
                 recorder: Optional[Any] = None):
        if not isinstance(spec, ServeSpec):
            raise TypeError(f"ModelView wants a ServeSpec; got "
                            f"{type(spec).__name__}")
        self.engine = engine
        self.spec = spec
        self._recorder = recorder
        if recorder is not None and engine.recorder is None:
            engine.recorder = recorder
        self._server: Optional[ParameterServer] = None
        self._cache: Optional[StaleCache] = None   # stale: server leaves
        self._state = None                         # stale: boundary state
        self._pinned = None                        # snapshot: full copy
        self._pinned_clock = 0
        self._clock = 0          # committed training rounds at last publish
        self.reads: List[dict] = []

    @property
    def recorder(self):
        """The Recorder the view was given, else the engine's."""
        return (self._recorder if self._recorder is not None
                else self.engine.recorder)

    # -- the training side ---------------------------------------------------

    def publish(self, state, t: int) -> None:
        """Make the state committed through round ``t`` servable.  Called
        at a boundary, while training does not run."""
        rec = self.recorder
        if rec is None:
            self._publish(state, t, None)
            return
        with rec.span("serve_publish", device=True, t=int(t)):
            self._publish(state, t, rec)

    def _publish(self, state, t: int, rec) -> None:
        self._clock = int(t)
        if self.spec.kind == "snapshot":
            self._pinned = None          # the old pin goes before the copy
            self._pinned = _copy_tree(state)
            self._pinned_clock = self._clock
            if rec is not None:
                rec.instant("serve_pin", t=self._clock)
            return
        if self._server is None:
            eng = self.engine
            self._server = ParameterServer.from_state(
                eng.workers, state, {k: eng.state_specs.get(k)
                                     for k in state},
                roles=eng.app_roles())
        self._state = state
        if self._cache is None or not self._cache.fresh_enough(
                self._clock, self.spec.max_staleness):
            # the gate would be violated at this clock: refresh the cache
            # from the server-resident leaves (the "pull"), as copies
            self._cache = StaleCache(
                values=_copy_tree(self._server.snapshot(state)),
                clock=self._clock)
            if rec is not None:
                rec.instant("serve_refresh", t=self._clock,
                            nbytes=self._server.shared_nbytes())

    def release(self) -> None:
        """Training takes the boundary state back (its next chunk may
        write worker-resident leaves in place): the stale kind drops its
        references to it, and reads fail until the next publish.  Pins
        and the cache are copies and stay."""
        self._state = None

    # -- the serving side ----------------------------------------------------

    @property
    def clock(self) -> int:
        """Committed training rounds as of the last publish."""
        return self._clock

    def read(self):
        """Serve one read: returns ``(state_view, staleness_at_read)`` and
        logs the measured staleness.  ``stale`` merges the (possibly
        stale) server cache over the boundary state; ``snapshot`` returns
        the pinned copy."""
        if self.spec.kind == "snapshot":
            if self._pinned is None:
                raise StaleReadError("read before the first publish — "
                                     "nothing is pinned yet")
            staleness = self._clock - self._pinned_clock
            view = self._pinned
        else:
            if self._cache is None:
                raise StaleReadError("read before the first publish — "
                                     "the serving cache is empty")
            if self._state is None:
                raise StaleReadError(
                    "the boundary state was released to training (its "
                    "next chunk may write it in place) — publish() again "
                    "before reading")
            staleness = self._cache.staleness(self._clock)
            if staleness > self.spec.max_staleness:
                raise StaleReadError(
                    f"staleness-at-read {staleness} exceeds the spec "
                    f"bound {self.spec.max_staleness} — publish() must "
                    f"run at every boundary")
            view = self._server.merge(self._state, self._cache.values)
        rec = {"t": self._clock, "clock": self._clock - staleness,
               "staleness": staleness}
        self.reads.append(rec)
        recorder = self.recorder
        if recorder is not None:
            recorder.instant("serve_read", **rec)
        return view, staleness

    # -- measured-staleness accounting ---------------------------------------

    def staleness_hist(self) -> dict:
        """``{staleness: read count}`` over every read served so far."""
        hist: dict = {}
        for r in self.reads:
            hist[r["staleness"]] = hist.get(r["staleness"], 0) + 1
        return hist

    def max_staleness_read(self) -> int:
        """The worst staleness any read observed (0 when nothing was
        read)."""
        return max((r["staleness"] for r in self.reads), default=0)


__all__ = ["ModelView", "StaleReadError"]
