"""Kernel backends: what a resolved :class:`~repro_torch.kernels.spec.
KernelSpec` executes.

A backend is a frozen value exposing the apps' hot spots, each taking a
leading worker axis:

    lasso_partial(Xb, r)  ->  (W, U)     f32   z = X_Bᵀ r     (Lasso push)
    gram_block(Xc)        ->  (W, U′,U′) f32   G = X_CᵀX_C    (ρ-filter)
    lda_gibbs(...)        ->  (W, K)     f32   s̃ after each worker's
                                               Gibbs sweep     (LDA push)

``build_kernels(spec)`` is the registry entry point; the engine calls it
at injection time (``StradsEngine.set_kernels``) and hands the result to
the app via ``use_kernels``.  ``kind="pallas"`` keeps the JAX package's
name so one plan file drives both packages; here it means the
hand-written CUDA kernels, whose wrappers decide CPU or card from the
device of the tensors they are given.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict

import torch

from . import lasso_cd as _lc
from . import lda_gibbs as _lg
from . import ref
from .spec import _KIND_MSG, KernelSpec


@dataclasses.dataclass(frozen=True)
class ReferenceKernels:
    """The plain PyTorch versions (:mod:`repro_torch.kernels.ref`)."""

    spec: KernelSpec

    def lasso_partial(self, Xb: torch.Tensor, r: torch.Tensor):
        return ref.lasso_partial_ref(Xb, r)

    def gram_block(self, Xc: torch.Tensor):
        return ref.gram_ref(Xc)

    def lda_gibbs(self, *args, **kw):
        return ref.lda_gibbs_ref(*args, **kw)


@dataclasses.dataclass(frozen=True)
class PallasKernels:
    """The hand-written CUDA kernels (:mod:`repro_torch.kernels.
    lasso_cd`, row-tiled at ``spec.block_n``, and
    :mod:`repro_torch.kernels.lda_gibbs`)."""

    spec: KernelSpec

    def lasso_partial(self, Xb: torch.Tensor, r: torch.Tensor):
        return _lc.lasso_partial(Xb, r, block_n=self.spec.block_n)

    def gram_block(self, Xc: torch.Tensor):
        return _lc.gram_block(Xc, block_n=self.spec.block_n)

    def lda_gibbs(self, *args, **kw):
        return _lg.lda_gibbs(*args, **kw)


# kind → factory(spec).  A new backend kind registers a factory here (and
# its kind/fields in spec.py) — nothing else changes.
KERNEL_BACKENDS: Dict[str, Callable] = {
    "reference": ReferenceKernels,
    "pallas": PallasKernels,
}


def build_kernels(spec: KernelSpec):
    """Resolve a :class:`KernelSpec` into an executable backend."""
    if not isinstance(spec, KernelSpec):
        raise TypeError(f"build_kernels wants a repro_torch.kernels."
                        f"KernelSpec; got {type(spec).__name__}")
    factory = KERNEL_BACKENDS.get(spec.kind)
    if factory is None:                                 # pragma: no cover
        raise ValueError(_KIND_MSG.format(spec.kind))
    return factory(spec)
