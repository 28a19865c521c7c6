"""Kernels of the port: the plain versions, the hand-written CUDA kernels
and the backend registry a :class:`KernelSpec` resolves through."""
from .backend import (KERNEL_BACKENDS, PallasKernels, ReferenceKernels,
                      build_kernels)
from .lasso_cd import (DEFAULT_BLOCK_N, LAUNCHES, gram_block, lasso_partial,
                       reset_launch_counts)
from .ref import gram_ref, lasso_partial_ref
from .spec import KERNEL_KINDS, KernelSpec

__all__ = ["KERNEL_BACKENDS", "KERNEL_KINDS", "DEFAULT_BLOCK_N", "LAUNCHES",
           "KernelSpec", "PallasKernels", "ReferenceKernels", "build_kernels",
           "gram_block", "gram_ref", "lasso_partial", "lasso_partial_ref",
           "reset_launch_counts"]
