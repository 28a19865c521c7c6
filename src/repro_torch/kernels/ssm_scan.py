"""The hand-written Hopper selective-scan kernel, bound with ctypes.

Replaces the Pallas kernel of the JAX package's ``kernels/ssm_scan.py``:
the diagonal selective scan of a Mamba2 block.  The source is
``csrc/ssm_scan.cu`` (the note at its top says what bounds the kernel and
how it is laid out: a channel's states split over lanes, x, dt, B and C
through a ring of ``cp.async`` tiles), built by ``nvcc`` at first use
(:mod:`._build`).
:func:`ssm_scan` takes x, dt (B, S, C) and B, C (B, S, N) as views with
any batch and sequence strides and a last-axis stride of 1, so the
model's slices of its conv output go in without a copy.  It launches on
the current stream and counts nothing:
:func:`repro_torch.kernels.ops.ssm_scan` is the wrapper that picks the
plain version on the CPU and counts launches.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build

MAX_STATE = 64               # N state values a channel keeps in registers
                             # (split over 8 lanes)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_GRID_LIMIT = 65535          # grid y (batch rows)


def _lib() -> ctypes.CDLL:
    lib = _build.load("ssm_scan")
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.ssm_scan_launch.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i,
                                        i, p, p]
        lib.ssm_scan_launch.restype = i
        lib.ssm_scan_error_string.argtypes = [i]
        lib.ssm_scan_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def ssm_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             Bm: torch.Tensor, Cm: torch.Tensor,
             h0: Optional[torch.Tensor] = None):
    """x, dt (B, S, C) and Bm, Cm (B, S, N), CUDA tensors of one dtype
    (float32 or bfloat16); A (C,) float32; h0 (B, C, N) float32
    contiguous, or None for zeros → (y (B, S, C) in x.dtype, h (B, C, N)
    float32).  Raises on what the kernel does not take; never falls
    back."""
    if x.dim() != 3 or dt.shape != x.shape or Bm.dim() != 3 \
            or Cm.shape != Bm.shape or Bm.shape[:2] != x.shape[:2]:
        raise ValueError(f"ssm_scan wants x, dt (B, S, C) and Bm, Cm "
                         f"(B, S, N); got {tuple(x.shape)}, "
                         f"{tuple(dt.shape)}, {tuple(Bm.shape)}, "
                         f"{tuple(Cm.shape)}")
    Bsz, S, C = x.shape
    N = Bm.shape[-1]
    if A.shape != (C,):
        raise ValueError(f"ssm_scan: A must be ({C},); got {tuple(A.shape)}")
    if h0 is not None and h0.shape != (Bsz, C, N):
        raise ValueError(f"ssm_scan: h0 must be {(Bsz, C, N)}; got "
                         f"{tuple(h0.shape)}")
    seq = (x, dt, Bm, Cm)
    for t in seq + (A,) + (() if h0 is None else (h0,)):
        if t.device.type != "cuda" or t.device != x.device:
            raise ValueError(f"ssm_scan: the CUDA kernel takes tensors on "
                             f"one card; got {t.device}")
    if any(t.dtype != x.dtype for t in seq) or x.dtype not in _DTYPES:
        raise TypeError(f"ssm_scan: the CUDA kernel takes x, dt, Bm, Cm of "
                        f"one dtype, float32 or bfloat16; got "
                        f"{[str(t.dtype) for t in seq]}")
    if A.dtype != torch.float32 or (h0 is not None
                                    and h0.dtype != torch.float32):
        raise TypeError("ssm_scan: the CUDA kernel takes A and h0 in "
                        "float32")
    if any(t.stride(-1) != 1 and t.shape[-1] > 1 for t in seq) \
            or not A.is_contiguous() \
            or (h0 is not None and not h0.is_contiguous()):
        raise ValueError("ssm_scan: x, dt, Bm, Cm need a last-axis stride "
                         "of 1, and A and h0 must be contiguous")
    if not 1 <= N <= MAX_STATE:
        raise ValueError(f"ssm_scan: the CUDA kernel keeps at most "
                         f"{MAX_STATE} state values a channel; got N={N}")
    if not 1 <= Bsz <= _GRID_LIMIT or C < 1:
        raise ValueError(f"ssm_scan: 1..{_GRID_LIMIT} batch rows and at "
                         f"least one channel; got B={Bsz}, C={C}")
    y = torch.empty((Bsz, S, C), dtype=x.dtype, device=x.device)
    h = torch.empty((Bsz, C, N), dtype=torch.float32, device=x.device)
    strides = (ctypes.c_longlong * 10)(*(
        s for t in (x, dt, Bm, Cm, y) for s in t.stride()[:2]))
    lib = _lib()
    err = lib.ssm_scan_launch(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
        Cm.data_ptr(), None if h0 is None else h0.data_ptr(),
        y.data_ptr(), h.data_ptr(), _DTYPES[x.dtype], Bsz, S, C, N, strides,
        torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        msg = lib.ssm_scan_error_string(err).decode()
        raise RuntimeError(f"ssm_scan: kernel launch failed: CUDA error "
                           f"{err} ({msg})")
    return y, h
