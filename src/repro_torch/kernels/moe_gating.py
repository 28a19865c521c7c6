"""The hand-written Hopper top-k gating kernel, bound with ctypes.

Replaces the Pallas kernel of the JAX package's ``kernels/moe_gating.py``:
softmax over the experts, top-k by k argmaxes (ties to the lower index),
renormalised; and its backward, :func:`topk_gating_bwd` (dlogits for the
forward's picks, ``ref.topk_gating_bwd_ref``).  The source is
``csrc/moe_gating.cu``, built by ``nvcc`` at first use (:mod:`._build`).
A row takes a group of lanes sized to E; each call takes one of two
routes (:func:`route`): 16-byte loads and stores, or checked 4-byte ones
in the same kernel template; :data:`ROUTE_CALLS` counts them.  Both
launch on the current stream and count nothing else:
:func:`repro_torch.kernels.ops.topk_gating` is the wrapper that picks the
plain version on the CPU, puts the backward under autograd and counts
launches.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

MAX_EXPERTS = 128            # 8 lanes × 16 experts a row
MAX_K = 32                   # the backward holds the k picks in registers
ROUTES = ("vector", "scalar")
#: kernel → route → launches that took it (a plain count, as ``ops.LAUNCHES``)
ROUTE_CALLS = {name: dict.fromkeys(ROUTES, 0)
               for name in ("topk_gating", "topk_gating_bwd")}


def _lib() -> ctypes.CDLL:
    lib = _build.load("moe_gating")
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.topk_gating_launch.argtypes = [p, p, p, i, i, i, i, p]
        lib.topk_gating_launch.restype = i
        lib.topk_gating_bwd_launch.argtypes = [p, p, p, p, p, i, i, i, i, p]
        lib.topk_gating_bwd_launch.restype = i
        lib.moe_gating_error_string.argtypes = [i]
        lib.moe_gating_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def _check_logits(name: str, logits: torch.Tensor, k: int) -> None:
    if logits.dim() != 2:
        raise ValueError(f"{name} wants logits (T, E); got "
                         f"{tuple(logits.shape)}")
    E = logits.shape[1]
    if logits.device.type != "cuda":
        raise ValueError(f"{name}: the CUDA kernel takes a CUDA "
                         f"tensor; got {logits.device}")
    if logits.dtype != torch.float32:
        raise TypeError(f"{name}: the CUDA kernel takes float32 "
                        f"logits; got {logits.dtype}")
    if not logits.is_contiguous():
        raise ValueError(f"{name}: the CUDA kernel takes contiguous "
                         "logits")
    if not 1 <= E <= MAX_EXPERTS or not 1 <= k <= min(E, MAX_K):
        raise ValueError(f"{name}: the CUDA kernel takes 1..."
                         f"{MAX_EXPERTS} experts and 1 <= k <= min(E, "
                         f"{MAX_K}); got E={E}, k={k}")


def _vector(E: int, base: int, picks=(), k: int = 0) -> bool:
    """The vector route's condition on E and the data pointers."""
    return (E % 4 == 0 and base % 16 == 0
            and (k != 2 or all(p % 8 == 0 for p in picks)))


def route(logits: torch.Tensor, *picks: torch.Tensor) -> str:
    """The loads the kernels take for these (T, E) logits and, for the
    backward, the (T, k) ``picks`` (idx, probs, dprobs); the CUDA source
    refuses a ``"vector"`` call where they do not hold.  ``"vector"``:
    float32 logits with E % 4 == 0 on a 16-byte-aligned base, and at
    k = 2 the picks 8-byte aligned (one float4 a lane's chunk, one
    float2 / int2 a row's picks).  ``"scalar"``: anything else the
    kernels take (4-byte loads, checked against E).  Callable on any
    device; the model's logits (a fresh ``(h @ router).float()``) take
    ``"vector"``."""
    vec = logits.dtype == torch.float32 and _vector(
        logits.shape[-1], logits.data_ptr(), [t.data_ptr() for t in picks],
        picks[0].shape[-1] if picks else 0)
    return "vector" if vec else "scalar"


def _raise_on(lib, err: int, name: str) -> None:
    if err:
        msg = lib.moe_gating_error_string(err).decode()
        raise RuntimeError(f"{name}: kernel launch failed: CUDA error "
                           f"{err} ({msg})")


def topk_gating(logits: torch.Tensor, k: int):
    """logits (T, E) float32 contiguous on the card → probs (T, k) f32,
    idx (T, k) int32, on the :func:`route` the logits allow.  Raises on
    what the kernel does not take."""
    _check_logits("topk_gating", logits, k)
    T, E = logits.shape
    probs = torch.empty((T, k), dtype=torch.float32, device=logits.device)
    idx = torch.empty((T, k), dtype=torch.int32, device=logits.device)
    if T == 0:
        return probs, idx
    lib = _lib()
    x = logits.data_ptr()
    vec = _vector(E, x)
    err = lib.topk_gating_launch(
        x, probs.data_ptr(), idx.data_ptr(), T, E, k, vec,
        torch.cuda.current_stream(logits.device).cuda_stream)
    _raise_on(lib, err, "topk_gating")
    ROUTE_CALLS["topk_gating"]["vector" if vec else "scalar"] += 1
    return probs, idx


def topk_gating_bwd(logits: torch.Tensor, idx: torch.Tensor,
                    probs: torch.Tensor, dprobs: torch.Tensor
                    ) -> torch.Tensor:
    """The forward's logits (T, E), its picks idx (T, k) int32 and probs
    (T, k) f32, and dprobs (T, k) f32, all contiguous on one card →
    dlogits (T, E) f32.  Raises on what the kernel does not take."""
    k = idx.shape[-1] if idx.dim() == 2 else 0
    _check_logits("topk_gating_bwd", logits, k)
    T = logits.shape[0]
    for name, t, dtype in (("idx", idx, torch.int32),
                           ("probs", probs, torch.float32),
                           ("dprobs", dprobs, torch.float32)):
        if t.shape != (T, k) or t.dtype != dtype or not t.is_contiguous() \
                or t.device != logits.device:
            raise ValueError(f"topk_gating_bwd: {name} must be a contiguous "
                             f"({T}, {k}) {dtype} tensor on "
                             f"{logits.device}; got {tuple(t.shape)} "
                             f"{t.dtype} on {t.device}")
    dlogits = torch.empty_like(logits)
    if T == 0:
        return dlogits
    lib = _lib()
    x, p, i, d = (t.data_ptr() for t in (logits, probs, idx, dprobs))
    vec = _vector(logits.shape[1], x, (p, i, d), k)
    err = lib.topk_gating_bwd_launch(
        x, p, i, d, dlogits.data_ptr(), T, logits.shape[1], k, vec,
        torch.cuda.current_stream(logits.device).cuda_stream)
    _raise_on(lib, err, "topk_gating_bwd")
    ROUTE_CALLS["topk_gating_bwd"]["vector" if vec else "scalar"] += 1
    return dlogits
