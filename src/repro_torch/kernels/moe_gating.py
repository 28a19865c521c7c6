"""The hand-written Hopper top-k gating kernel, bound with ctypes.

Replaces the Pallas kernel of the JAX package's ``kernels/moe_gating.py``:
softmax over the experts, top-k by k argmaxes (ties to the lower index),
renormalised.  The source is ``csrc/moe_gating.cu``, built by ``nvcc`` at
first use (:mod:`._build`).  :func:`topk_gating` launches on the current
stream and counts nothing: :func:`repro_torch.kernels.ops.topk_gating` is
the wrapper that picks the plain version on the CPU and counts launches.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

MAX_EXPERTS = 128            # 32 lanes × 4 registers a row
MAX_K = 32                   # lane i writes the i-th pick


def _lib() -> ctypes.CDLL:
    lib = _build.load("moe_gating")
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.topk_gating_launch.argtypes = [p, p, p, i, i, i, p]
        lib.topk_gating_launch.restype = i
        lib.moe_gating_error_string.argtypes = [i]
        lib.moe_gating_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def topk_gating(logits: torch.Tensor, k: int):
    """logits (T, E) float32 contiguous on the card → probs (T, k) f32,
    idx (T, k) int32.  Raises on what the kernel does not take."""
    if logits.dim() != 2:
        raise ValueError(f"topk_gating wants logits (T, E); got "
                         f"{tuple(logits.shape)}")
    T, E = logits.shape
    if logits.device.type != "cuda":
        raise ValueError(f"topk_gating: the CUDA kernel takes a CUDA "
                         f"tensor; got {logits.device}")
    if logits.dtype != torch.float32:
        raise TypeError(f"topk_gating: the CUDA kernel takes float32 "
                        f"logits; got {logits.dtype}")
    if not logits.is_contiguous():
        raise ValueError("topk_gating: the CUDA kernel takes contiguous "
                         "logits")
    if not 1 <= E <= MAX_EXPERTS or not 1 <= k <= min(E, MAX_K):
        raise ValueError(f"topk_gating: the CUDA kernel takes 1..."
                         f"{MAX_EXPERTS} experts and 1 <= k <= min(E, "
                         f"{MAX_K}); got E={E}, k={k}")
    probs = torch.empty((T, k), dtype=torch.float32, device=logits.device)
    idx = torch.empty((T, k), dtype=torch.int32, device=logits.device)
    if T == 0:
        return probs, idx
    lib = _lib()
    err = lib.topk_gating_launch(
        logits.data_ptr(), probs.data_ptr(), idx.data_ptr(), T, E, k,
        torch.cuda.current_stream(logits.device).cuda_stream)
    if err:
        msg = lib.moe_gating_error_string(err).decode()
        raise RuntimeError(f"topk_gating: kernel launch failed: CUDA error "
                           f"{err} ({msg})")
    return probs, idx
