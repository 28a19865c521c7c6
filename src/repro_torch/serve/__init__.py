"""Serving of the port: bounded-staleness reads while training, from the
JAX package's ``serve/``.

* :class:`ServeSpec` (:mod:`repro_torch.serve.spec`) — the frozen,
  hashable, JSON-round-trippable serving policy (``kind="stale" |
  "snapshot"``, ``max_staleness``, ``max_batch``, ``batch_window_ms``);
* :class:`ModelView` (:mod:`repro_torch.serve.view`) — the read path
  over the SSP split (:class:`~repro_torch.ps.server.ParameterServer` +
  :class:`~repro_torch.ps.cache.StaleCache`) with a measured
  staleness-at-read; pins and cache refreshes are copies, since the port
  writes some state in place;
* :class:`ServeFrontend` (:mod:`repro_torch.serve.frontend`) — the
  micro-batching request frontend, calling the app's ``query()`` eagerly
  and timing each response after the device has run it;
* :func:`serve_while_training` / :func:`serve_only`
  (:mod:`repro_torch.serve.loop`) — ``execute()`` chunks interleaved
  with serving reads at SSP flush boundaries, equal to an unserved run
  to the bit.

Apps opt in with one primitive, ``query(state, batch)``: Lasso's
``predict``, LDA's ``infer_topics`` fold-in, MF's ``recommend`` top-k.
"""
from .spec import SERVE_KINDS, ServeSpec
from .view import ModelView, StaleReadError
from .frontend import Request, Response, ServeFrontend
from .loop import ServeReport, serve_only, serve_while_training

__all__ = [
    "SERVE_KINDS", "ServeSpec", "ModelView", "StaleReadError",
    "Request", "Response", "ServeFrontend", "ServeReport",
    "serve_only", "serve_while_training",
]
