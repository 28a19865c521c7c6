"""Hand-written Hopper kernels for the STRADS Lasso round's hot spots.

  * ``lasso_partial`` — the push partials z = X_Bᵀr per worker:
    (W, n, U), (W, n) → (W, U) f32, in one launch that sums its row
    tiles in the block that finishes last (a workspace and per-worker
    counters kept per card, see :func:`_workspace`).
  * ``gram_block``    — the ρ-filter Gram block G = X_CᵀX_C per worker:
    (W, n, U′) → (W, U′, U′) f32, in one launch that splits the rows into
    slices by what the card runs at once (:func:`_gram_plan`), sums each
    thread-block cluster of slices through distributed shared memory and
    the clusters in the block that finishes last (the same workspace and
    counters).

They replace the Pallas kernels of the JAX package's
``kernels/lasso_cd.py``.  The sources are in ``csrc/lasso_cd.cu`` (the
note at its top says what bounds each kernel and how it is split), built
by ``nvcc`` at first use (:mod:`._build`).  One launch serves all W
workers; the caller's ``.sum(0)`` is the psum.

A wrapper given tensors on the CPU returns the plain version
(:mod:`.ref`); given CUDA tensors it launches the kernel or raises.  It
adds one to :data:`LAUNCHES` each time it launches, so a run can show
that it went through the kernels.  ``block_n`` is the row tile, as on the
TPU: every value gives the same result up to f32 summation order
(``gram_block`` only checks it: its rows are split by the card).
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
#: device → the kernels' (partials, tickets); see :func:`_workspace`
_WORKSPACE: dict = {}
_RETIRED: list = []
#: device → the blocks of ``gram_block`` it runs at once, read once
_SLOTS: dict = {}
# gram_block's constants in csrc/lasso_cd.cu
_PANEL = 128                 # columns of a panel (kPanel)
_PART = 136 * 64             # floats of a cluster's partial (kPart)
_ROWS = 32                   # rows of a stage (kRows)


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _lib() -> ctypes.CDLL:
    lib = _build.load("lasso_cd")
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.lasso_partial_launch.argtypes = [p, p, p, p, p, i, i, i, i, p]
        lib.lasso_partial_launch.restype = i
        lib.gram_block_launch.argtypes = [p, p, p, p, i, i, i, i, i, p]
        lib.gram_block_launch.restype = i
        lib.gram_block_slots.argtypes = [p]
        lib.gram_block_slots.restype = i
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


def _workspace(name: str, device: torch.device, floats: int,
               counters: int):
    """The kernels' scratch on ``device``: (partials, tickets), at least
    ``floats`` floats and ``counters`` counters, shared by both kernels
    (each leaves its counters at 0, and calls on one card run in order).
    Kept from call to call and grown only when too small; a replaced pair
    stays allocated, so a captured CUDA graph that holds its pointers
    stays valid."""
    work = _WORKSPACE.get(device)
    if work is None or work[0].numel() < floats \
            or work[1].numel() < counters:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(f"{name}: call it once at these shapes "
                               f"before capturing a CUDA graph (its "
                               f"workspace is allocated outside capture)")
        if work is not None:
            _RETIRED.append(work)
            floats = max(floats, 2 * work[0].numel())
            counters = max(counters, work[1].numel())
        work = (torch.empty(floats, dtype=torch.float32, device=device),
                torch.zeros(counters, dtype=torch.int32, device=device))
        _WORKSPACE[device] = work
    return work


def _slots(device: torch.device) -> int:
    slots = _SLOTS.get(device)
    if slots is None:
        lib, out = _lib(), ctypes.c_int(0)
        with torch.cuda.device(device):
            _raise_on(lib, "gram_block", lib.gram_block_slots(ctypes.byref(
                out)))
        slots = _SLOTS[device] = out.value
    return slots


def _gram_plan(W: int, n: int, U: int,
               slots: int) -> tuple[int, int, int, int]:
    """``gram_block``'s launch on a card that runs ``slots`` of its blocks
    at once (in clusters; 120 on an H100 SXM, whose 132 SMs do not all
    take a cluster): (C, S, floats, counters).  S slices a worker in
    clusters of C = 8 or 4 slices, so that the grid (S, P², W) of P =
    ⌈U′/128⌉ panels holds as many blocks as fit in one wave (at least one
    cluster a job, and no more than 32-row stages allow); of two sizes
    that fill the card alike, 8 (fewer partials to sum).  The workspace
    holds each cluster's summed partial, ``floats`` = W·P²·(S/C)·8704,
    and one counter a (worker, job, block of the cluster)."""
    jobs = (-(-U // _PANEL)) ** 2
    best = None
    for C in (8, 4):
        per = max(1, min(slots // (C * W * jobs), -(-n // (C * _ROWS))))
        key = (min(C * per * W * jobs, slots), C)
        if best is None or key > best[0]:
            best = (key, C, per)
    _, C, per = best
    return C, C * per, W * jobs * per * _PART, W * jobs * C


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
    work, tickets = _workspace("lasso_partial", Xb.device, W * T * U,
                               W)
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
    """G = Xcᵀ Xc per worker: (W, n, U′) → (W, U′, U′) f32, symmetric to
    the bit.  One launch on the current stream; calls on one card share a
    workspace, so they run in order (one stream)."""
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
    panels = -(-U // _PANEL)
    if W > _GRID_LIMIT or panels * panels > _GRID_LIMIT:
        raise ValueError(f"gram_block: at most {_GRID_LIMIT} workers and "
                         f"{_PANEL * 255} candidates; got W={W}, U′={U}")
    G = torch.empty((W, U, U), dtype=torch.float32, device=Xc.device)
    if n == 0 or U == 0 or W == 0:
        return G.zero_()
    _row_tiles(n, block_n)
    C, S, floats, counters = _gram_plan(W, n, U, _slots(Xc.device))
    work, tickets = _workspace("gram_block", Xc.device, floats, counters)
    lib = _lib()
    err = lib.gram_block_launch(Xc.data_ptr(), work.data_ptr(),
                                tickets.data_ptr(), G.data_ptr(), W, n, U,
                                S, C, _stream(Xc.device))
    _raise_on(lib, "gram_block", err)
    LAUNCHES["gram_block"] += 1
    return G
