"""The hand-written Hopper flash-attention kernels, bound with ctypes.

The forward replaces the Pallas kernel of the JAX package's
``kernels/flash_attention.py``; the backward (:func:`flash_attention_bwd`)
is the port's own, for the gradients the JAX package takes by autodiff.  The source is
``csrc/flash_attention.cu`` (the notes at the top of its forward and
backward sections say what bounds each kernel and how it is split), built
by ``nvcc`` at first use (:mod:`._build`).  The backward takes one of
three routes (:func:`bwd_route`): bf16 at head dim 64, 80 or 128 in
aligned views runs the TMA/``wgmma`` kernels, other bf16 calls the
``mma.sync`` ones, float32 the FP32-core ones; :data:`BWD_ROUTE_CALLS` counts them.
:func:`flash_attention` takes the TPU kernel's (B, H, S, D) layout, as
views with any batch, head and sequence strides and a head_dim stride of
1, so the model's (B, S, H, D) activations go in without a copy.  It
launches on the current stream and counts nothing:
:func:`repro_torch.kernels.ops.attention` is the wrapper that picks the
plain version on the CPU, counts launches and binds the two into
autograd.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build

MAX_HEAD_DIM = 256
MAX_HEAD_DIM_BWD = 128
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_GRID_LIMIT = 65535          # grid y (query heads) and z (batch)
#: the backward's routes, by their code in ``csrc/flash_attention.cu``
BWD_ROUTES = ("f32", "mma_sync", "wgmma")
BWD_PAD = 384                # the wgmma route's lse/delta rows round up to
                             # it: a multiple of a dQ block's 192 rows (head
                             # dim 64, 80) or 128 (128)
WGMMA_HEAD_DIMS = (64, 80, 128)
#: route → backward calls that took it (a plain count, as ``ops.LAUNCHES``)
BWD_ROUTE_CALLS = {r: 0 for r in BWD_ROUTES}


def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.flash_attention_launch.argtypes = [
            p, p, p, p, p, i, i, i, i, i, i, i, p, i, i, ctypes.c_float, p]
        lib.flash_attention_launch.restype = i
        lib.flash_attention_bwd_launch.argtypes = [p] * 11 + [i] * 9 + [
            p, i, i, ctypes.c_float, p]
        lib.flash_attention_bwd_launch.restype = i
        lib.flash_attention_error_string.argtypes = [i]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def _check(name: str, q, k, v, window) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"{name} wants q (B, Hq, Sq, D) and k, v "
                         f"(B, Hkv, Skv, D); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, Hq, Sq, D = q.shape
    _, Hkv, Skv, _ = k.shape
    if k.shape[0] != B or k.shape[3] != D or Hkv < 1 or Hq % Hkv:
        raise ValueError(f"{name}: q {tuple(q.shape)} does not match k "
                         f"{tuple(k.shape)} (GQA needs Hq % Hkv == 0)")
    for x in (q, k, v):
        if x.device.type != "cuda" or x.device != q.device:
            raise ValueError(f"{name}: the CUDA kernel takes tensors on "
                             f"one card; got {x.device}")
        if x.dtype != q.dtype or x.dtype not in _DTYPES:
            raise TypeError(f"{name}: the CUDA kernel takes float32 or "
                            f"bfloat16 q, k, v of one dtype; got {q.dtype}, "
                            f"{k.dtype}, {v.dtype}")
        if x.stride(3) != 1:
            raise ValueError(f"{name}: the head_dim stride must be 1")
    if Hq > _GRID_LIMIT or B > _GRID_LIMIT:
        raise ValueError(f"{name}: at most {_GRID_LIMIT} heads and batch "
                         f"rows")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1 or None; got {window}")


def _raise_on(lib, err: int, name: str) -> None:
    if err:
        msg = lib.flash_attention_error_string(err).decode()
        raise RuntimeError(f"{name}: kernel launch failed: CUDA error {err} "
                           f"({msg})")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    scale: Optional[float] = None, return_lse: bool = False):
    """q (B, Hq, Sq, D); k, v (B, Hkv, Skv, D) CUDA tensors of one dtype
    (float32 or bfloat16) → (B, Hq, Sq, D) in q.dtype, a view of a
    (B, Sq, Hq, D) contiguous tensor; with ``return_lse`` also each row's
    log-sum-exp of the scaled scores, (B, Hq, Sq) float32 (−inf for a row
    that sees no key), which the backward reads.  Raises on what the
    kernel does not take; never falls back."""
    _check("flash_attention", q, k, v, window)
    B, Hq, Sq, D = q.shape
    _, Hkv, Skv, _ = k.shape
    if not 1 <= D <= MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: head_dim {D} outside 1.."
                         f"{MAX_HEAD_DIM}")
    scale = D ** -0.5 if scale is None else float(scale)
    out = torch.empty((B, Sq, Hq, D), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    lse = (torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    if Sq > 0:
        strides = (ctypes.c_longlong * 12)(*(
            s for x in (q, k, v, out) for s in x.stride()[:3]))
        lib = _lib()
        _raise_on(lib, lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(), _DTYPES[q.dtype], B, Hq,
            Hkv, Sq, Skv, D, strides, int(causal), window or 0, scale,
            torch.cuda.current_stream(q.device).cuda_stream),
            "flash_attention")
    return (out, lse) if return_lse else out


def _tma_view(x: torch.Tensor) -> bool:
    """A 16-byte aligned base and (batch, head, seq) strides of whole 16
    bytes (the stride of an extent-1 dim is never stepped)."""
    return x.data_ptr() % 16 == 0 and all(
        n == 1 or s % 8 == 0 for n, s in zip(x.shape[:3], x.stride()[:3]))


def bwd_route(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              out: torch.Tensor, dout: torch.Tensor) -> str:
    """The kernels :func:`flash_attention_bwd` takes for these (B, H, S, D)
    views; the CUDA source picks the same (``bwd_route`` there) and refuses
    a call where the two differ.  ``"f32"``: float32 inputs, the FP32-core
    kernels.  ``"wgmma"``: bfloat16 at head dim 64, 80 or 128 with q, k, v,
    out and dout all TMA sources (:func:`_tma_view`).  ``"mma_sync"``: any
    other bfloat16 call (another head dim, an unaligned view)."""
    if q.dtype != torch.bfloat16:
        return "f32"
    if q.shape[-1] in WGMMA_HEAD_DIMS and all(map(_tma_view,
                                                  (q, k, v, out, dout))):
        return "wgmma"
    return "mma_sync"


def bwd_rows(Sq: int, route: str) -> int:
    """Rows a (batch, head) of the backward's lse/delta workspaces: Sq,
    or on the wgmma route Sq rounded up to BWD_PAD (a multiple of the dQ
    kernel's q tile at each of its head dims), so that every tile's rows lie
    inside its own (batch, head)."""
    return -(-Sq // BWD_PAD) * BWD_PAD if route == "wgmma" else Sq


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, lse: torch.Tensor,
                        dout: torch.Tensor, *, causal: bool = True,
                        window: Optional[int] = None,
                        scale: Optional[float] = None):
    """The gradients of :func:`flash_attention` at (q, k, v), given its
    output ``out`` and ``lse`` and dout, the gradient of ``out`` (all in
    the (B, H, S, D) layout, any batch, head and sequence strides, a
    head_dim stride of 1).  Returns (dq, dk, dv) in q's dtype, views of
    (B, S, H, D) contiguous tensors.  Head dims up to 128 (even); others
    raise.  :func:`bwd_route` names the kernels the call takes;
    BWD_ROUTE_CALLS counts the calls of each route."""
    _check("flash_attention_bwd", q, k, v, window)
    B, Hq, Sq, D = q.shape
    _, Hkv, Skv, _ = k.shape
    if not 1 <= D <= MAX_HEAD_DIM_BWD or D % 2:
        raise ValueError(f"flash_attention_bwd: head_dim {D} is not an even "
                         f"number in 2..{MAX_HEAD_DIM_BWD}")
    for name, x in (("out", out), ("dout", dout)):
        if (x.shape != q.shape or x.dtype != q.dtype or x.device != q.device
                or x.stride(3) != 1):
            raise ValueError(f"flash_attention_bwd: {name} must match q in "
                             f"shape, dtype and device with a head_dim "
                             f"stride of 1")
    if (lse.shape != (B, Hq, Sq) or lse.dtype != torch.float32
            or not lse.is_contiguous()):
        raise ValueError("flash_attention_bwd: lse must be (B, Hq, Sq) "
                         "contiguous float32, as the forward returns it")
    scale = D ** -0.5 if scale is None else float(scale)

    def empty(S, H):
        return torch.empty((B, S, H, D), dtype=q.dtype,
                           device=q.device).transpose(1, 2)
    dq, dk, dv = empty(Sq, Hq), empty(Skv, Hkv), empty(Skv, Hkv)
    if Sq == 0 or Skv == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    route = bwd_route(q, k, v, out, dout)
    rows = bwd_rows(Sq, route)
    delta = torch.empty((B, Hq, rows), dtype=torch.float32, device=q.device)
    lse2 = torch.empty_like(delta) if route == "wgmma" else None
    strides = (ctypes.c_longlong * 24)(*(
        s for x in (q, k, v, out, dout, dq, dk, dv) for s in x.stride()[:3]))
    lib = _lib()
    _raise_on(lib, lib.flash_attention_bwd_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
        None if lse2 is None else lse2.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), _DTYPES[q.dtype],
        BWD_ROUTES.index(route), B, Hq, Hkv, Sq, Skv, D, rows, strides,
        int(causal), window or 0, scale,
        torch.cuda.current_stream(q.device).cuda_stream),
        "flash_attention_bwd")
    BWD_ROUTE_CALLS[route] += 1
    return dq, dk, dv
