"""Parameter templates: one source of truth for shapes and initialisation.

A model is a nested dict of :class:`ParamMeta` leaves (the JAX package's
``models/params.py`` layout); :func:`init` materialises it as a nested
dict of tensors on an explicit device from an explicit generator.  The
logical sharding axes are kept on each leaf so the templates read as the
JAX package's do, but nothing here shards.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ParamMeta:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]          # logical axis per dim
    init: str = "normal"                     # normal|zeros|ones|ssm_a|ssm_dt
    scale: Optional[float] = None            # stddev; default fan-in

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} and axes {self.axes} "
                             f"differ in rank")


Template = Dict[str, Any]                    # nested dict of ParamMeta

_DRAW_ELEMS = 1 << 26                        # f32 elements drawn at once
#: inits whose leaves stay float32 in a model of any type (the JAX
#: package's ``params.abstract``): the SSM's A_log and dt_bias
SSM_INITS = ("ssm_a", "ssm_dt")


def is_meta(x) -> bool:
    return isinstance(x, ParamMeta)


def tree_map(fn: Callable, tree, *rest, path: Tuple[str, ...] = ()):
    """``fn(path, leaf, *other_leaves)`` over a nested dict, keeping its
    structure; the leaves are whatever is not a dict."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest), path=path + (k,))
                for k, v in tree.items()}
    return fn(path, tree, *rest)


def leaves(tree):
    """The leaves of a nested dict, depth first in key order."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from leaves(v)
    else:
        yield tree


def leaf_std(meta: ParamMeta) -> float:
    """The JAX package's rule: ``scale`` if given, else fan-in ** -0.5 with
    the fan-in read from ``shape[0]`` (for a stacked leaf that is the
    layer count, as in the reference)."""
    fan_in = meta.shape[0] if len(meta.shape) > 1 else meta.shape[-1]
    return meta.scale if meta.scale is not None else fan_in ** -0.5


def _leaf_init(meta: ParamMeta, gen: torch.Generator, dtype,
               device) -> torch.Tensor:
    if meta.init == "zeros":
        return torch.zeros(meta.shape, dtype=dtype, device=device)
    if meta.init == "ones":
        return torch.ones(meta.shape, dtype=dtype, device=device)
    if meta.init in SSM_INITS:               # f32 whatever the model's type
        u = torch.rand(meta.shape, generator=gen, device=device,
                       dtype=torch.float32)
        if meta.init == "ssm_a":             # A_log: log of U[1, 16]
            return torch.log(u * 15.0 + 1.0)
        u = u * (0.1 - 1e-3) + 1e-3          # dt_bias: softplus⁻¹(U[1e-3, .1])
        return torch.log(torch.expm1(u))
    if meta.init != "normal":
        raise ValueError(f"unknown init {meta.init!r}")
    std = leaf_std(meta)
    out = torch.empty(meta.shape, dtype=dtype, device=device)
    # drawn in f32 and cast a few slices of the leading axis at a time,
    # so the f32 temporaries stay at most one layer's worth (a stacked
    # expert leaf of Phi-3.5-MoE is (L, 16, 4096, 6400))
    rows = out.view(meta.shape[0], -1) if len(meta.shape) > 1 else out[None]
    step = max(1, _DRAW_ELEMS // max(1, rows.shape[1]))
    for i in range(0, rows.shape[0], step):
        part = rows[i:i + step]
        part.copy_(torch.randn(part.shape, generator=gen, device=device,
                               dtype=torch.float32).mul_(std))
    return out


def init(template: Template, gen: torch.Generator, dtype,
         device) -> Dict[str, Any]:
    """Materialise a template: every "normal" leaf drawn from ``gen``
    (which must live on ``device``), leaf after leaf in key order, in
    ``dtype``; the SSM inits (:data:`SSM_INITS`) are uniform draws kept in
    float32."""
    return tree_map(lambda _, m: _leaf_init(m, gen, dtype, device), template)


def param_count(template: Template) -> int:
    return sum(math.prod(m.shape) for m in leaves(template))


def stack(template: Template, n: int, axis_name: Optional[str] = None
          ) -> Template:
    """Prepend a length-``n`` layer dim to every leaf."""
    return tree_map(lambda _, m: ParamMeta((n,) + m.shape,
                                           (axis_name,) + m.axes,
                                           m.init, m.scale), template)
