"""The hand-written Hopper kernel for LDA's collapsed Gibbs sweep, bound
with ctypes.

It has no Pallas counterpart: it replaces the ``lax.scan`` of
``_gibbs_scan`` and ``_full_gibbs_scan`` in the JAX package's
``apps/lda.py``.  The source is ``csrc/lda_gibbs.cu`` (the note at its
top says what bounds it: the logf of each topic, and the chain of a
worker's tokens on one SM), built by ``nvcc`` at first use
(:mod:`._build`).  One launch samples every worker's active tokens of
one round, one thread block a worker, software-pipelined: a ring of
:func:`ring_depth` tokens' rows arrives by cp.async while the block
samples, and the next token's logits are computed before the current
token's argmax.

:func:`gibbs_index` sorts each worker's token slots by vocabulary block
once; :func:`lda_gibbs` then walks only the block a worker owns this
round.  Given tensors on the CPU it returns the plain version
(:func:`.ref.lda_gibbs_ref`); given CUDA tensors it launches the kernel
or raises, and adds one to :data:`LAUNCHES`.  With the same explicit
Gumbel noise the kernel and the plain version on the card take the same
decisions (both use the card's full-precision ``logf``).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build
from .ref import lda_gibbs_ref

#: kernel name → launches since the last :func:`reset_launch_counts`
LAUNCHES = {"lda_gibbs": 0}

MAX_TOPICS = 16384           # s̃ and log(vg + s̃) in shared memory: 128 KB

_depths: dict = {}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _lib() -> ctypes.CDLL:
    lib = _build.load("lda_gibbs")
    if not getattr(lib, "_typed", False):
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        ll, ull = ctypes.c_longlong, ctypes.c_ulonglong
        lib.lda_gibbs_launch.argtypes = [p, p, p, p, p, p, p, p, p, p, i, i,
                                         i, i, i, i, ll, i, i, i, f, f, f,
                                         ull, i, i, p]
        lib.lda_gibbs_launch.restype = i
        lib.lda_gibbs_depth.argtypes = [i]
        lib.lda_gibbs_depth.restype = i
        lib.lda_gibbs_error_string.argtypes = [i]
        lib.lda_gibbs_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def _raise_on(lib, err: int) -> None:
    if err:
        msg = lib.lda_gibbs_error_string(err).decode()
        raise RuntimeError(f"lda_gibbs: kernel launch failed: CUDA error "
                           f"{err} ({msg})")


def ring_depth(K: int, device=None) -> int:
    """Tokens in the kernel's cp.async ring at K topics on ``device``'s
    card: the deepest of 6, 4 and 2 whose block fits the card's shared
    memory (a slot holds a token's B, D and noise rows), else 0, the
    variant that reads each row from device memory at its turn."""
    dev = torch.device("cuda" if device is None else device)
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    key = (idx, int(K))
    if key not in _depths:
        with torch.cuda.device(idx):
            _depths[key] = _lib().lda_gibbs_depth(int(K))
    return _depths[key]


def block_threads(K: int, device=None) -> int:
    """Threads of the kernel's block (one worker) at K topics: 256 that
    own the topics, and with a ring of 4 or more slots 256 more that copy
    the rows and draw the Philox noise ahead."""
    return 512 if ring_depth(K, device) >= 4 else 256


def gibbs_index(words: torch.Tensor, block_vocab: int, n_blocks: int):
    """Index each worker's token slots by vocabulary block, once: ``order``
    (P, T) int32 lists the slots sorted by block ``word // block_vocab``
    (stable, so slot order within a block; inactive slots, word −1, go
    last) and ``offsets`` (P, n_blocks + 1) int32 says where each block
    starts."""
    P = words.shape[0]
    blk = torch.where(words >= 0, words.long() // block_vocab, n_blocks)
    order = torch.sort(blk, dim=-1, stable=True).indices.to(torch.int32)
    counts = torch.zeros((P, n_blocks + 1), dtype=torch.int64,
                         device=words.device)
    counts.scatter_add_(1, blk, torch.ones_like(blk))
    offsets = torch.zeros_like(counts)
    offsets[:, 1:] = counts[:, :n_blocks].cumsum(1)
    return order.contiguous(), offsets.to(torch.int32)


def active_counts(offsets: torch.Tensor, phase: int) -> torch.Tensor:
    """(P,) active tokens of each worker in the round of ``phase``."""
    P = offsets.shape[0]
    n_blocks = offsets.shape[1] - 1
    p = torch.arange(P, device=offsets.device)
    b = (p + phase) % n_blocks
    return offsets[p, b + 1] - offsets[p, b]


def lda_gibbs(words: torch.Tensor, docs: torch.Tensor, z: torch.Tensor,
              order: torch.Tensor, offsets: torch.Tensor, B: torch.Tensor,
              D: torch.Tensor, s: torch.Tensor, *, phase: int, rotate: bool,
              block_vocab: int, vg: float, alpha: float, gamma: float,
              gumbel: Optional[torch.Tensor] = None,
              seed: int = 0) -> torch.Tensor:
    """One round of every worker's Gibbs sweep; see
    :func:`.ref.lda_gibbs_ref` for the semantics.  words, docs, z,
    order (P, T) int32; offsets (P, n_blocks + 1) int32; B (n_blocks or
    P, rows, K) and D (P, dpw, K) f32, updated in place with z; s (K,)
    f32; ``gumbel`` (P, L, K) f32 or None for the kernel's Philox draws
    keyed on (``seed``, ``phase``, worker, slot).  Returns s̃ (P, K)."""
    args = (words, docs, z, order, offsets, B, D, s)
    if all(t.device.type == "cpu" for t in args + (() if gumbel is None
                                                   else (gumbel,))):
        return lda_gibbs_ref(*args, phase=phase, rotate=rotate,
                             block_vocab=block_vocab, vg=vg, alpha=alpha,
                             gamma=gamma, gumbel=gumbel, seed=seed)
    dev = words.device
    for t in args + (() if gumbel is None else (gumbel,)):
        if t.device != dev or dev.type != "cuda":
            raise ValueError(f"lda_gibbs: the CUDA kernel takes tensors on "
                             f"one card; got {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError("lda_gibbs: the CUDA kernel takes contiguous "
                             "tensors")
    if any(t.dtype != torch.int32 for t in args[:5]) or any(
            t.dtype != torch.float32 for t in args[5:]
            + (() if gumbel is None else (gumbel,))):
        raise TypeError("lda_gibbs: the CUDA kernel takes words, docs, z, "
                        "order and offsets in int32 and B, D, s and the "
                        "noise in float32")
    P, T = words.shape
    K = B.shape[-1]
    n_blocks = offsets.shape[1] - 1
    if docs.shape != (P, T) or z.shape != (P, T) or order.shape != (P, T) \
            or offsets.dim() != 2 or offsets.shape[0] != P or n_blocks < 1:
        raise ValueError(f"lda_gibbs: words, docs, z and order must be "
                         f"(P, T) and offsets (P, n_blocks + 1); got "
                         f"{[tuple(t.shape) for t in args[:5]]}")
    slabs = n_blocks if rotate else P
    if B.dim() != 3 or B.shape[0] != slabs or D.dim() != 3 \
            or D.shape[0] != P or D.shape[2] != K or s.shape != (K,):
        raise ValueError(f"lda_gibbs: B must be ({slabs}, rows, K), D "
                         f"({P}, dpw, K) and s (K,); got {tuple(B.shape)}, "
                         f"{tuple(D.shape)}, {tuple(s.shape)}")
    if not 1 <= K <= MAX_TOPICS:
        raise ValueError(f"lda_gibbs: the CUDA kernel takes 1..{MAX_TOPICS} "
                         f"topics; got K={K}")
    if B.shape[1] < block_vocab:
        raise ValueError(f"lda_gibbs: B has {B.shape[1]} rows a slab, fewer "
                         f"than block_vocab={block_vocab}")
    L = 0
    if gumbel is not None:
        if gumbel.dim() != 3 or gumbel.shape[0] != P \
                or gumbel.shape[2] != K:
            raise ValueError(f"lda_gibbs: gumbel must be ({P}, L, {K}); got "
                             f"{tuple(gumbel.shape)}")
        L = gumbel.shape[1]
        if not torch.cuda.is_current_stream_capturing() and \
                int(active_counts(offsets, phase).max()) > L:
            raise ValueError(f"lda_gibbs: gumbel has L={L} rows a worker, "
                             f"fewer than its active tokens this round")
    s_tilde = torch.empty((P, K), dtype=torch.float32, device=dev)
    lib = _lib()
    err = lib.lda_gibbs_launch(
        words.data_ptr(), docs.data_ptr(), z.data_ptr(), order.data_ptr(),
        offsets.data_ptr(), B.data_ptr(), D.data_ptr(), s.data_ptr(),
        s_tilde.data_ptr(), None if gumbel is None else gumbel.data_ptr(),
        P, T, K, n_blocks, int(bool(rotate)), block_vocab,
        B.shape[1] * K, D.shape[1], int(phase), L, vg, alpha, gamma,
        int(seed), block_threads(K, dev), ring_depth(K, dev),
        torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(lib, err)
    LAUNCHES["lda_gibbs"] += 1
    return s_tilde

