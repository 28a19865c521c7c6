"""The hand-written Hopper flash-attention kernel, bound with ctypes.

Replaces the Pallas kernel of the JAX package's
``kernels/flash_attention.py``.  The source is
``csrc/flash_attention.cu`` (the note at its top says what bounds the
kernel and how it is split), built by ``nvcc`` at first use
(:mod:`._build`).  :func:`flash_attention` takes the TPU kernel's
(B, H, S, D) layout, as views with any batch, head and sequence strides
and a head_dim stride of 1, so the model's (B, S, H, D) activations go
in without a copy.  It launches on the current stream and counts
nothing: :func:`repro_torch.kernels.ops.attention` is the wrapper that
picks the plain version on the CPU and counts launches.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build

MAX_HEAD_DIM = 256
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_GRID_LIMIT = 65535          # grid y (query heads) and z (batch)


def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.flash_attention_launch.argtypes = [
            p, p, p, p, i, i, i, i, i, i, i, p, i, i, ctypes.c_float, p]
        lib.flash_attention_launch.restype = i
        lib.flash_attention_error_string.argtypes = [i]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    scale: Optional[float] = None) -> torch.Tensor:
    """q (B, Hq, Sq, D); k, v (B, Hkv, Skv, D) CUDA tensors of one dtype
    (float32 or bfloat16) → (B, Hq, Sq, D) in q.dtype, a view of a
    (B, Sq, Hq, D) contiguous tensor.  Raises on what the kernel does not
    take; never falls back."""
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"flash_attention wants q (B, Hq, Sq, D) and k, v "
                         f"(B, Hkv, Skv, D); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, Hq, Sq, D = q.shape
    _, Hkv, Skv, _ = k.shape
    if k.shape[0] != B or k.shape[3] != D or Hkv < 1 or Hq % Hkv:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} does not "
                         f"match k {tuple(k.shape)} (GQA needs Hq % Hkv "
                         f"== 0)")
    for x in (q, k, v):
        if x.device.type != "cuda" or x.device != q.device:
            raise ValueError(f"flash_attention: the CUDA kernel takes "
                             f"tensors on one card; got {x.device}")
        if x.dtype != q.dtype or x.dtype not in _DTYPES:
            raise TypeError(f"flash_attention: the CUDA kernel takes "
                            f"float32 or bfloat16 q, k, v of one dtype; "
                            f"got {q.dtype}, {k.dtype}, {v.dtype}")
        if x.stride(3) != 1:
            raise ValueError("flash_attention: the head_dim stride must "
                             "be 1")
    if not 1 <= D <= MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: head_dim {D} outside 1.."
                         f"{MAX_HEAD_DIM}")
    if Hq > _GRID_LIMIT or B > _GRID_LIMIT:
        raise ValueError(f"flash_attention: at most {_GRID_LIMIT} heads "
                         f"and batch rows")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1 or None; got {window}")
    scale = D ** -0.5 if scale is None else float(scale)
    out = torch.empty((B, Sq, Hq, D), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    if Sq == 0:
        return out
    strides = (ctypes.c_longlong * 12)(*(
        s for x in (q, k, v, out) for s in x.stride()[:3]))
    lib = _lib()
    err = lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        _DTYPES[q.dtype], B, Hq, Hkv, Sq, Skv, D, strides, int(causal),
        window or 0, scale, torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        msg = lib.flash_attention_error_string(err).decode()
        raise RuntimeError(f"flash_attention: kernel launch failed: CUDA "
                           f"error {err} ({msg})")
    return out
