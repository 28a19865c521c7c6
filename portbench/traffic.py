"""The one traffic generator: reads a mix's parameters
(``traffic/<name>.json``) and draws its open-loop schedule from the seed.

A mix without ``arrivals`` is training alone: rounds back to back.  A
mix with them offers queries in an open loop, due by the wall clock from
the window's start, whatever the system does.  Every seed gets the same
multiset of gaps and sizes in another order (the gaps are the n
quantiles of the arrival process, the sizes the n quantiles of the size
distribution, each permuted by the seed), so seeds change which query
comes when, not how much work a window holds.

Mix keys:

- ``chunk``: ``"sweep"`` (a chunk of the configuration's
  ``sweep_rounds``) or ``"step"`` (the executor's step, the boundary
  cadence of ``serve_while_training``);
- ``arrivals``: ``{"process": "poisson", "rate_per_s": r}``;
- ``query``: what each query asks; ``{"kind": "document", "length":
  {"dist": "lognormal", "mean": m, "sigma": s, "max": L}}`` (the
  document's length in tokens, padded with −1 to ``max``) or
  ``{"kind": "user", "popularity": {"dist": "zipf", "s": s}}`` (the
  popularity rank of the user asking, 0 the most popular);
- ``serve``: the ``ServeSpec`` fields.
"""
from __future__ import annotations

import json
import math
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent


def load(name: str) -> dict:
    """The mix ``traffic/<name>.json``."""
    return json.loads((HERE / "traffic" / f"{name}.json").read_text())


def _quantiles(n: int) -> np.ndarray:
    return (np.arange(n) + 0.5) / n


def _rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) & 0xFFFFFFFFFFFFFFFF, stream])


def arrival_offsets(mix: dict, seed: int, seconds: float) -> np.ndarray:
    """Due times (s from the window's start, increasing) of the queries
    that arrive in ``seconds``; empty for a training-only mix."""
    arr = mix.get("arrivals")
    if not arr:
        return np.zeros((0,))
    if arr["process"] != "poisson":
        raise ValueError(f"unknown arrival process {arr['process']!r}")
    rate = float(arr["rate_per_s"])
    n = max(1, int(math.ceil(rate * seconds)))
    gaps = -np.log1p(-_quantiles(n)) / rate
    return np.cumsum(_rng(seed, 1).permutation(gaps))


def sizes(mix: dict, seed: int, n: int, population: int = 0) -> np.ndarray:
    """Each query's size: a document's length in tokens, or the
    popularity rank (in [0, ``population``)) of the user it asks for."""
    q = mix["query"]
    u = _rng(seed, 2).permutation(_quantiles(n))
    if q["kind"] == "document":
        ln = q["length"]
        if ln["dist"] != "lognormal":
            raise ValueError(f"unknown length distribution {ln['dist']!r}")
        sigma = float(ln["sigma"])
        mu = math.log(float(ln["mean"])) - sigma * sigma / 2
        from statistics import NormalDist
        z = np.array([NormalDist().inv_cdf(x) for x in u])
        return np.clip(np.rint(np.exp(mu + sigma * z)), 1,
                       int(ln["max"])).astype(np.int64)
    if q["kind"] == "user":
        pop = q["popularity"]
        if pop["dist"] != "zipf":
            raise ValueError(f"unknown popularity {pop['dist']!r}")
        w = np.arange(1, population + 1, dtype=np.float64) ** -float(pop["s"])
        cdf = np.cumsum(w) / w.sum()
        return np.minimum(np.searchsorted(cdf, u), population - 1)
    raise ValueError(f"unknown query kind {q['kind']!r}")
