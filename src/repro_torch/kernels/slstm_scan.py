"""The hand-written Hopper sLSTM recurrence, forward and backward, bound
with ctypes.

Replaces no Pallas kernel: the JAX package runs xLSTM's sLSTM as the
``lax.scan`` of its ``models/xlstm.py:261-265``, which XLA compiles into
one device loop.  The source is ``csrc/slstm_scan.cu`` (the note at its
top says what bounds it and how it is laid out: one persistent grid of
co-resident blocks, each keeping its units' slice of W_r in registers
or shared memory, h (in the backward, the blocks' partials of dh)
exchanged through L2 as tagged 64-bit words in a two-slot ring, one
round trip a step; batch rows beyond what a block's shared memory holds
run as chunks, one after another, in the same launch), built by
``nvcc`` at first use (:mod:`._build`).  :func:`plan` reads the grid,
the chunks and the ring the card gives a shape; :func:`slstm_scan` runs
the forward (asked to, ``save=True``, it also writes what the backward
reads) and :func:`slstm_scan_bwd` the reverse sweep; :func:`barriers`
runs the forward's grid through its exchanges alone.  All launch on the
current stream and count nothing: :func:`repro_torch.kernels.ops.slstm_scan`
picks the plain version on the CPU, puts the backward under autograd
and counts launches.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build


def _lib() -> ctypes.CDLL:
    return typed(_build.load("slstm_scan"))


def typed(lib: ctypes.CDLL) -> ctypes.CDLL:
    """``lib`` (a build of ``csrc/slstm_scan.cu``) with its functions'
    argument types set."""
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        ip, llp = ctypes.POINTER(i), ctypes.POINTER(ctypes.c_longlong)
        lib.slstm_scan_plan.argtypes = [i, i, ip, ip, ip, ip, llp, llp, llp,
                                        llp, ip, ip, ip]
        lib.slstm_scan_plan.restype = i
        lib.slstm_scan_fwd_launch.argtypes = [p] * 17 + [i, i, i, p]
        lib.slstm_scan_fwd_launch.restype = i
        lib.slstm_scan_bwd_launch.argtypes = [p] * 19 + [i, i, i, p]
        lib.slstm_scan_bwd_launch.restype = i
        lib.slstm_barriers_launch.argtypes = [p, i, i, i, p]
        lib.slstm_barriers_launch.restype = i
        if hasattr(lib, "slstm_stamps"):
            lib.slstm_stamps.argtypes = [p, ctypes.c_longlong]
        lib.slstm_scan_error_string.argtypes = [i]
        lib.slstm_scan_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def _raise_on(lib, err: int, name: str) -> None:
    if err:
        msg = lib.slstm_scan_error_string(err).decode()
        raise RuntimeError(f"{name}: kernel launch failed: CUDA error "
                           f"{err} ({msg})")


def plan(B: int, d: int, backward: bool = False) -> dict:
    """The grid of a call with B batch rows and d hidden units on the
    current card: ``u`` units a block, ``blocks`` blocks (one an SM),
    the rows of a chunk (``rows_fwd``, ``rows_bwd``: the most a block's
    shared memory holds beside its slice of W_r, evened out over the
    fewest chunks) and the chunks (``chunks_fwd``, ``chunks_bwd``), the
    forward's and the backward's shared memory a block in bytes at those
    rows, the bytes of each one's exchange ring (``ring_fwd``,
    ``ring_bwd``: two slots of tagged 64-bit words), whether the
    blocks' slices of W_r stay in registers (``w_in_registers``; else in
    shared memory), the card's SMs and the shared memory a block may opt
    in to.  Raises when the forward (with ``backward``, the backward)
    cannot take even one row of d."""
    lib = _lib()
    L, I = ctypes.c_longlong, ctypes.c_int
    vals = [I(0) for _ in range(4)] + [L(0) for _ in range(4)] + [
        I(0) for _ in range(3)]
    _raise_on(lib, lib.slstm_scan_plan(B, d, *map(ctypes.byref, vals)),
              "slstm_scan plan")
    (u, blocks, rf, rb, fwd, bwd, ring_f, ring_b, regs, sms,
     optin) = (v.value for v in vals)
    out = {"u": u, "blocks": blocks, "rows_fwd": rf, "rows_bwd": rb,
           "chunks_fwd": -(-B // rf) if rf else 0,
           "chunks_bwd": -(-B // rb) if rb else 0,
           "smem_fwd": fwd, "smem_bwd": bwd, "ring_fwd": ring_f,
           "ring_bwd": ring_b, "w_in_registers": bool(regs), "sms": sms,
           "smem_optin": optin}
    name, rows, smem = (("slstm_scan_bwd", rb, bwd) if backward
                        else ("slstm_scan", rf, fwd))
    if rows < 1:
        raise ValueError(
            f"{name}: d={d} needs {u} units a block on {sms} SMs, whose "
            f"slice of W_r with one batch row's buffers takes {smem} bytes "
            f"of shared memory; a block may have {optin}")
    return out


def _check_state(state, B: int, d: int, device, name: str) -> None:
    if state is None:
        return
    if len(state) != 4:
        raise ValueError(f"{name}: the state is (c, n, m, h)")
    for t in state:
        if t is None or t.shape != (B, d) or t.dtype != torch.float32 \
                or t.device != device or not t.is_contiguous():
            raise ValueError(
                f"{name}: each state tensor must be a contiguous ({B}, {d}) "
                f"float32 tensor on {device}; got "
                f"{None if t is None else (tuple(t.shape), t.dtype)}")


def _check(gx, wr, bias, state, name="slstm_scan"):
    if gx.dim() != 3 or gx.shape[-1] % 4 or gx.shape[1] < 1:
        raise ValueError(f"{name} wants gx (B, S, 4d) with S >= 1; got "
                         f"{tuple(gx.shape)}")
    B, S, d4 = gx.shape
    d = d4 // 4
    if wr.shape != (d, d4) or bias.shape != (d4,):
        raise ValueError(f"{name}: wr must be {(d, d4)} and bias ({d4},); "
                         f"got {tuple(wr.shape)}, {tuple(bias.shape)}")
    for t in (gx, wr, bias):
        if t.device.type != "cuda" or t.device != gx.device:
            raise ValueError(f"{name}: the CUDA kernel takes tensors on one "
                             f"card; got {t.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: the CUDA kernel takes float32; got "
                            f"{t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: gx, wr and bias must be contiguous")
    _check_state(state, B, d, gx.device, name)
    return B, S, d


def _ring(nbytes: int, device) -> torch.Tensor:
    """Scratch for an exchange ring (the kernel zeroes it)."""
    return torch.empty(nbytes // 8, dtype=torch.int64, device=device)


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def slstm_scan(gx: torch.Tensor, wr: torch.Tensor, bias: torch.Tensor,
               state: Optional[tuple] = None, save: bool = False):
    """gx (B, S, 4d), wr (d, 4d), bias (4d,), contiguous float32 CUDA
    tensors; state = (c, n, m, h), each a contiguous (B, d) float32
    tensor, or None for c = n = h = 0, m = −inf → (hs (B, S, d), (c, n,
    m, h) after the last step), and with ``save`` a third output for
    :func:`slstm_scan_bwd`: (G (B, S, 4d), C, N, M (B, S, d)).  See
    :func:`.ref.slstm_scan_ref`.  Raises on what the kernel does not
    take; never falls back."""
    B, S, d = _check(gx, wr, bias, state)
    ring = _ring(plan(B, d)["ring_fwd"], gx.device)
    lib = _lib()
    dev = gx.device
    f32 = lambda *shape: torch.empty(shape, dtype=torch.float32, device=dev)
    hs = f32(B, S, d)
    final = tuple(f32(B, d) for _ in range(4))
    saved = ((f32(B, S, 4 * d), f32(B, S, d), f32(B, S, d), f32(B, S, d))
             if save else (None,) * 4)
    init = (None,) * 4 if state is None else state
    err = lib.slstm_scan_fwd_launch(
        gx.data_ptr(), wr.data_ptr(), bias.data_ptr(), *map(_ptr, init),
        hs.data_ptr(), *map(_ptr, final), *map(_ptr, saved),
        ring.data_ptr(), B, S, d, torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(lib, err, "slstm_scan")
    return (hs, final, saved) if save else (hs, final)


def slstm_scan_bwd(wr: torch.Tensor, state: Optional[tuple], saved: tuple,
                   dhs: torch.Tensor, dfinal: Optional[tuple] = None,
                   want_dstate: bool = True):
    """The reverse sweep of :func:`slstm_scan` from its ``save=True``
    outputs ``saved`` = (G, C, N, M), its wr and initial state (None:
    the default), ``dhs`` (B, S, d) the gradient of hs and ``dfinal`` =
    (dc, dn, dm, dh) of the final state (any None: zeros) → (dG (B, S,
    4d), the gradient of gx, and (dc, dn, dm, dh) of the initial state,
    or None when not ``want_dstate``).  dW_r and dbias follow from dG by
    :func:`.ref.slstm_param_grads`.  See :func:`.ref.slstm_scan_bwd_ref`.
    Raises on what the kernel does not take; never falls back."""
    G, C, N, M = saved
    if G is None:
        raise ValueError("slstm_scan_bwd: saved must be the forward's "
                         "(G, C, N, M) from save=True")
    B, S, d = _check(G, wr, wr[0], state, "slstm_scan_bwd")
    for t in (C, N, M, dhs):
        if t.shape != (B, S, d) or t.dtype != torch.float32 \
                or t.device != G.device or not t.is_contiguous():
            raise ValueError(f"slstm_scan_bwd: C, N, M and dhs must be "
                             f"contiguous ({B}, {S}, {d}) float32 tensors "
                             f"on {G.device}")
    dfinal = (None,) * 4 if dfinal is None else dfinal
    for t in dfinal:
        if t is not None:
            _check_state((t,) * 4, B, d, G.device, "slstm_scan_bwd dfinal")
    ring = _ring(plan(B, d, backward=True)["ring_bwd"], G.device)
    lib = _lib()
    dev = G.device
    dG = torch.empty_like(G)
    dstate = (tuple(torch.empty((B, d), dtype=torch.float32, device=dev)
                    for _ in range(4)) if want_dstate else (None,) * 4)
    init = (None,) * 3 if state is None else state[:3]
    err = lib.slstm_scan_bwd_launch(
        wr.data_ptr(), *map(_ptr, init), *map(_ptr, saved), dhs.data_ptr(),
        *map(_ptr, dfinal), dG.data_ptr(), *map(_ptr, dstate),
        ring.data_ptr(), B, S, d, torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(lib, err, "slstm_scan_bwd")
    return dG, (dstate if want_dstate else None)


def barriers(B: int, S: int, d: int, device) -> None:
    """The forward's grid for (B, d) through one chunk's S − 1 exchanges
    of tagged words and nothing else: the floor of a chunk's chain of
    steps."""
    ring = _ring(plan(B, d)["ring_fwd"], device)
    lib = _lib()
    _raise_on(lib, lib.slstm_barriers_launch(
        ring.data_ptr(), B, S, d,
        torch.cuda.current_stream(device).cuda_stream), "slstm_barriers")
