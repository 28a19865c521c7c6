"""Hand-written Hopper kernels for the STRADS Lasso round's hot spots.

  * ``lasso_partial`` — the push partials z = X_Bᵀr per worker:
    (W, n, U), (W, n) → (W, U) f32, in one launch that sums its row
    tiles in the block that finishes last (a workspace and per-worker
    counters kept per card, see :func:`_workspace`).
  * ``gram_block``    — the ρ-filter Gram block G = X_CᵀX_C per worker:
    (W, n, U′) → (W, U′, U′) f32.

They replace the Pallas kernels of the JAX package's
``kernels/lasso_cd.py``.  The sources are in ``csrc/lasso_cd.cu`` (the
note at its top says what bounds each kernel and how it is split), built
by ``nvcc`` at first use (:mod:`._build`).  One launch serves all W
workers; the caller's ``.sum(0)`` is the psum.

A wrapper given tensors on the CPU returns the plain version
(:mod:`.ref`); given CUDA tensors it launches the kernel or raises.  It
adds one to :data:`LAUNCHES` each time it launches, so a run can show
that it went through the kernels.  ``block_n`` is the row tile, as on the
TPU: every value gives the same result up to f32 summation order.
Neither kernel uses float atomics, so each result is the same bits on
every run, and on every replay of a captured CUDA graph.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .ref import gram_ref, lasso_partial_ref

DEFAULT_BLOCK_N = 256

#: kernel name → launches since the last :func:`reset_launch_counts`
LAUNCHES = {"lasso_partial": 0, "gram_block": 0}

_GRID_LIMIT = 65535          # grid y and z
#: device → ``lasso_partial``'s (partials, tickets); see :func:`_workspace`
_WORKSPACE: dict = {}
_RETIRED: list = []
_TILE = 64                   # gram_block's output tile edge (csrc); the
                             # grid holds tiles·(tiles+1)/2 ≤ 65535 of them


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _lib() -> ctypes.CDLL:
    lib = _build.load("lasso_cd")
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.lasso_partial_launch.argtypes = [p, p, p, p, p, i, i, i, i, p]
        lib.lasso_partial_launch.restype = i
        lib.gram_block_launch.argtypes = [p, p, p, i, i, i, i, p]
        lib.gram_block_launch.restype = i
        lib.lasso_cd_error_string.argtypes = [i]
        lib.lasso_cd_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def _check_cuda(name: str, *tensors: torch.Tensor) -> None:
    dev = tensors[0].device
    for x in tensors:
        if x.device != dev:
            raise ValueError(f"{name}: inputs lie on {dev} and {x.device}")
        if x.dtype != torch.float32:
            raise TypeError(f"{name}: the CUDA kernel takes float32; got "
                            f"{x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{name}: the CUDA kernel takes contiguous "
                             f"inputs")


def _raise_on(lib, name: str, err: int) -> None:
    if err:
        msg = lib.lasso_cd_error_string(err).decode()
        raise RuntimeError(f"{name}: kernel launch failed: CUDA error "
                           f"{err} ({msg})")


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _row_tiles(n: int, block_n: int) -> tuple[int, int]:
    if not isinstance(block_n, int) or block_n < 1:
        raise ValueError(f"block_n must be an int >= 1; got {block_n!r}")
    block_n = min(block_n, n)
    return block_n, -(-n // block_n)


def _workspace(device: torch.device, floats: int, workers: int):
    """``lasso_partial``'s scratch on ``device``: (partials, tickets), at
    least ``floats`` floats and ``workers`` counters.  Kept from call to
    call and grown only when too small; a replaced pair stays allocated,
    so a captured CUDA graph that holds its pointers stays valid."""
    work = _WORKSPACE.get(device)
    if work is None or work[0].numel() < floats \
            or work[1].numel() < workers:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("lasso_partial: call it once at these shapes "
                               "before capturing a CUDA graph (its "
                               "workspace is allocated outside capture)")
        if work is not None:
            _RETIRED.append(work)
            floats = max(floats, 2 * work[0].numel())
            workers = max(workers, work[1].numel())
        work = (torch.empty(floats, dtype=torch.float32, device=device),
                torch.zeros(workers, dtype=torch.int32, device=device))
        _WORKSPACE[device] = work
    return work


def lasso_partial(Xb: torch.Tensor, r: torch.Tensor,
                  block_n: int = DEFAULT_BLOCK_N) -> torch.Tensor:
    """z = Xbᵀ r per worker: (W, n, U), (W, n) → (W, U) f32.  One launch
    on the current stream; calls on one card share a workspace, so they
    run in order (one stream)."""
    if Xb.dim() != 3 or r.shape != Xb.shape[:2]:
        raise ValueError(f"lasso_partial wants Xb (W, n, U) and r (W, n); "
                         f"got {tuple(Xb.shape)} and {tuple(r.shape)}")
    if Xb.device.type == "cpu" and r.device.type == "cpu":
        return lasso_partial_ref(Xb, r)
    if Xb.device.type != "cuda":
        raise ValueError(f"lasso_partial runs on CPU or CUDA tensors; got "
                         f"{Xb.device}")
    _check_cuda("lasso_partial", Xb, r)
    W, n, U = Xb.shape
    if W > _GRID_LIMIT:
        raise ValueError(f"lasso_partial: at most {_GRID_LIMIT} workers")
    z = torch.empty((W, U), dtype=torch.float32, device=Xb.device)
    if n == 0 or U == 0 or W == 0:
        return z.zero_()
    block_n, T = _row_tiles(n, block_n)
    work, tickets = _workspace(Xb.device, W * T * U, W)
    lib = _lib()
    err = lib.lasso_partial_launch(Xb.data_ptr(), r.data_ptr(),
                                   work.data_ptr(), tickets.data_ptr(),
                                   z.data_ptr(), W, n, U, block_n,
                                   _stream(Xb.device))
    _raise_on(lib, "lasso_partial", err)
    LAUNCHES["lasso_partial"] += 1
    return z


def gram_block(Xc: torch.Tensor,
               block_n: int = DEFAULT_BLOCK_N) -> torch.Tensor:
    """G = Xcᵀ Xc per worker: (W, n, U′) → (W, U′, U′) f32."""
    if Xc.dim() != 3:
        raise ValueError(f"gram_block wants Xc (W, n, U′); got "
                         f"{tuple(Xc.shape)}")
    if Xc.device.type == "cpu":
        return gram_ref(Xc)
    if Xc.device.type != "cuda":
        raise ValueError(f"gram_block runs on CPU or CUDA tensors; got "
                         f"{Xc.device}")
    _check_cuda("gram_block", Xc)
    W, n, U = Xc.shape
    tiles = -(-U // _TILE)
    if W > _GRID_LIMIT or tiles * (tiles + 1) // 2 > _GRID_LIMIT:
        raise ValueError(f"gram_block: at most {_GRID_LIMIT} workers and "
                         f"{_TILE * 361} candidates; got W={W}, U′={U}")
    G = torch.empty((W, U, U), dtype=torch.float32, device=Xc.device)
    if n == 0 or U == 0 or W == 0:
        return G.zero_()
    block_n, T = _row_tiles(n, block_n)
    partials = torch.empty((W, T, U, U), dtype=torch.float32,
                           device=Xc.device)
    lib = _lib()
    err = lib.gram_block_launch(Xc.data_ptr(), partials.data_ptr(),
                                G.data_ptr(), W, n, U, block_n,
                                _stream(Xc.device))
    _raise_on(lib, "gram_block", err)
    LAUNCHES["gram_block"] += 1
    return G
