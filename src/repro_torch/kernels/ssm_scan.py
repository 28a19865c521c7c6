"""The hand-written Hopper selective-scan kernel, bound with ctypes.

Replaces the Pallas kernel of the JAX package's ``kernels/ssm_scan.py``:
the diagonal selective scan of a Mamba2 block.  The source is
``csrc/ssm_scan.cu`` (the note at its top says what bounds the kernel and
how it is laid out: a channel's states split over lanes, x, dt, B and C
through a ring of ``cp.async`` tiles), built by ``nvcc`` at first use
(:mod:`._build`).
:func:`ssm_scan` takes x, dt (B, S, C) and B, C (B, S, N) as views with
any batch and sequence strides and a last-axis stride of 1, so the
model's slices of its conv output go in without a copy.  Asked to
(``save_states=True``), the forward also writes the state before every
tile of 16 steps, and :func:`ssm_scan_bwd`, the backward kernel of the
same source, takes each tile's states again from there (the note at the
source's backward says how, and what the states cost).  Both launch on
the current stream and count nothing:
:func:`repro_torch.kernels.ops.ssm_scan` is the wrapper that picks the
plain version on the CPU, puts the backward under autograd and counts
launches.
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
        ll = ctypes.c_longlong
        lib.ssm_scan_launch.argtypes = [p, p, p, p, p, p, p, p, p, i, i, i,
                                        i, i, p, p]
        lib.ssm_scan_launch.restype = i
        lib.ssm_scan_bwd_launch.argtypes = [p] * 16 + [i] * 5 + [p, p]
        lib.ssm_scan_bwd_launch.restype = i
        lib.ssm_scan_bwd_occupancy.argtypes = [
            i, i, ctypes.POINTER(i), ctypes.POINTER(ll)]
        lib.ssm_scan_bwd_occupancy.restype = i
        for fn in (lib.ssm_scan_state_floats, lib.ssm_scan_bwd_work_floats):
            fn.argtypes = [i, i, i, i]
            fn.restype = ll
        lib.ssm_scan_error_string.argtypes = [i]
        lib.ssm_scan_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def _check(x, dt, A, Bm, Cm, h0, name="ssm_scan"):
    """The forward's checks (the backward takes the same inputs)."""
    if x.dim() != 3 or dt.shape != x.shape or Bm.dim() != 3 \
            or Cm.shape != Bm.shape or Bm.shape[:2] != x.shape[:2]:
        raise ValueError(f"{name} wants x, dt (B, S, C) and Bm, Cm "
                         f"(B, S, N); got {tuple(x.shape)}, "
                         f"{tuple(dt.shape)}, {tuple(Bm.shape)}, "
                         f"{tuple(Cm.shape)}")
    Bsz, S, C = x.shape
    N = Bm.shape[-1]
    if A.shape != (C,):
        raise ValueError(f"{name}: A must be ({C},); got {tuple(A.shape)}")
    if h0 is not None and h0.shape != (Bsz, C, N):
        raise ValueError(f"{name}: h0 must be {(Bsz, C, N)}; got "
                         f"{tuple(h0.shape)}")
    seq = (x, dt, Bm, Cm)
    for t in seq + (A,) + (() if h0 is None else (h0,)):
        if t.device.type != "cuda" or t.device != x.device:
            raise ValueError(f"{name}: the CUDA kernel takes tensors on "
                             f"one card; got {t.device}")
    if any(t.dtype != x.dtype for t in seq) or x.dtype not in _DTYPES:
        raise TypeError(f"{name}: the CUDA kernel takes x, dt, Bm, Cm of "
                        f"one dtype, float32 or bfloat16; got "
                        f"{[str(t.dtype) for t in seq]}")
    if A.dtype != torch.float32 or (h0 is not None
                                    and h0.dtype != torch.float32):
        raise TypeError(f"{name}: the CUDA kernel takes A and h0 in "
                        "float32")
    if any(t.stride(-1) != 1 and t.shape[-1] > 1 for t in seq) \
            or not A.is_contiguous() \
            or (h0 is not None and not h0.is_contiguous()):
        raise ValueError(f"{name}: x, dt, Bm, Cm need a last-axis stride "
                         "of 1, and A and h0 must be contiguous")
    if not 1 <= N <= MAX_STATE:
        raise ValueError(f"{name}: the CUDA kernel keeps at most "
                         f"{MAX_STATE} state values a channel; got N={N}")
    if not 1 <= Bsz <= _GRID_LIMIT or C < 1:
        raise ValueError(f"{name}: 1..{_GRID_LIMIT} batch rows and at "
                         f"least one channel; got B={Bsz}, C={C}")


def _raise_on(lib, err: int, name: str) -> None:
    if err:
        msg = lib.ssm_scan_error_string(err).decode()
        raise RuntimeError(f"{name}: kernel launch failed: CUDA error "
                           f"{err} ({msg})")


def _strides(*ts) -> ctypes.Array:
    return (ctypes.c_longlong * (2 * len(ts)))(*(
        s for t in ts for s in t.stride()[:2]))


def ssm_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             Bm: torch.Tensor, Cm: torch.Tensor,
             h0: Optional[torch.Tensor] = None, save_states: bool = False):
    """x, dt (B, S, C) and Bm, Cm (B, S, N), CUDA tensors of one dtype
    (float32 or bfloat16); A (C,) float32; h0 (B, C, N) float32
    contiguous, or None for zeros → (y (B, S, C) in x.dtype, h (B, C, N)
    float32), and with ``save_states`` a third output: the states the
    backward starts its tiles from (a flat float32 tensor in the kernel's
    own order, for :func:`ssm_scan_bwd`).  Raises on what the kernel does
    not take; never falls back."""
    _check(x, dt, A, Bm, Cm, h0)
    Bsz, S, C = x.shape
    N = Bm.shape[-1]
    lib = _lib()
    states = (torch.empty(lib.ssm_scan_state_floats(Bsz, S, C, N),
                          dtype=torch.float32, device=x.device)
              if save_states else None)
    y = torch.empty((Bsz, S, C), dtype=x.dtype, device=x.device)
    h = torch.empty((Bsz, C, N), dtype=torch.float32, device=x.device)
    err = lib.ssm_scan_launch(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
        Cm.data_ptr(), None if h0 is None else h0.data_ptr(),
        y.data_ptr(), h.data_ptr(),
        None if states is None or not states.numel() else states.data_ptr(),
        _DTYPES[x.dtype], Bsz, S, C, N, _strides(x, dt, Bm, Cm, y),
        torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on(lib, err, "ssm_scan")
    return (y, h) if states is None else (y, h, states)


def ssm_scan_bwd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                 Bm: torch.Tensor, Cm: torch.Tensor,
                 h0: Optional[torch.Tensor], states: torch.Tensor,
                 dy: torch.Tensor, dh: Optional[torch.Tensor] = None):
    """The gradients of :func:`ssm_scan` at its inputs, from the states
    its ``save_states`` call returned, ``dy`` (B, S, C) in x.dtype with a
    last-axis stride of 1, and ``dh`` (B, C, N) float32 contiguous, the
    final state's gradient (None: zeros) → (dx, ddt, dA, dB, dC, dh0):
    dx, ddt (B, S, C) and dB, dC (B, S, N) in x.dtype, dA (C,) and dh0
    (B, C, N) float32, dh0 None when h0 is.  See
    :func:`.ref.ssm_scan_bwd_ref`.  Raises on what the kernel does not
    take; never falls back."""
    _check(x, dt, A, Bm, Cm, h0, "ssm_scan_bwd")
    Bsz, S, C = x.shape
    N = Bm.shape[-1]
    lib = _lib()
    want = lib.ssm_scan_state_floats(Bsz, S, C, N)
    if states.shape != (want,) or states.dtype != torch.float32 \
            or states.device != x.device:
        raise ValueError(f"ssm_scan_bwd: states must be the forward's "
                         f"({want},) float32 on {x.device}; got "
                         f"{tuple(states.shape)} {states.dtype}")
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device \
            or (dy.stride(-1) != 1 and C > 1):
        raise ValueError(f"ssm_scan_bwd: dy must be {tuple(x.shape)} "
                         f"{x.dtype} on {x.device} with a last-axis stride "
                         f"of 1; got {tuple(dy.shape)} {dy.dtype}")
    if dh is not None and (dh.shape != (Bsz, C, N)
                           or dh.dtype != torch.float32
                           or not dh.is_contiguous()
                           or dh.device != x.device):
        raise ValueError(f"ssm_scan_bwd: dh must be a contiguous "
                         f"{(Bsz, C, N)} float32 tensor on {x.device}")
    dx = torch.empty((Bsz, S, C), dtype=x.dtype, device=x.device)
    ddt = torch.empty_like(dx)
    dB = torch.empty((Bsz, S, N), dtype=x.dtype, device=x.device)
    dC = torch.empty_like(dB)
    dA = torch.empty((C,), dtype=torch.float32, device=x.device)
    dh0 = None if h0 is None else torch.empty_like(h0)
    work = torch.empty(lib.ssm_scan_bwd_work_floats(Bsz, S, C, N),
                       dtype=torch.float32, device=x.device)
    ptr = lambda t: None if t is None or not t.numel() else t.data_ptr()
    err = lib.ssm_scan_bwd_launch(
        ptr(x), ptr(dt), ptr(A), ptr(Bm), ptr(Cm), ptr(h0), ptr(states),
        ptr(dy), ptr(dh), ptr(dx), ptr(ddt), ptr(dA), ptr(dB), ptr(dC),
        ptr(dh0), ptr(work), _DTYPES[x.dtype], Bsz, S, C, N,
        _strides(x, dt, Bm, Cm, dy, dx),
        torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on(lib, err, "ssm_scan_bwd")
    return dx, ddt, dA, dB, dC, dh0


def ssm_scan_bwd_occupancy(dtype: torch.dtype, N: int) -> tuple:
    """(resident blocks an SM, shared memory bytes a block) of the
    backward kernel :func:`ssm_scan_bwd` launches for x of ``dtype`` and
    N state values, from the CUDA occupancy API on the current card."""
    if dtype not in _DTYPES or not 1 <= N <= MAX_STATE:
        raise ValueError(f"ssm_scan_bwd_occupancy: {dtype}, N={N}")
    lib = _lib()
    blocks, smem = ctypes.c_int(0), ctypes.c_longlong(0)
    _raise_on(lib, lib.ssm_scan_bwd_occupancy(
        _DTYPES[dtype], N, ctypes.byref(blocks), ctypes.byref(smem)),
        "ssm_scan_bwd_occupancy")
    return blocks.value, smem.value
