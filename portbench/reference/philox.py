"""The Gumbel draws of LDA's Gibbs sweep, Philox-4x32-10 keyed on
(seed, phase, worker, slot).

Frozen copy of ``philox4x32``, ``_mulhilo`` and ``philox_gumbel`` from
``src/repro_torch/kernels/ref.py`` at commit 8dacd7b, so that the plain
reference imports nothing of the program.  It is the formula the CUDA
kernel ``csrc/lda_gibbs.cu`` documents (``philox4x32_10``,
``philox_gumbel4``): topic k of worker p's token in slot ``slot`` takes
word k % 4 of Philox-4x32-10 at counter (k // 4, slot, p, phase) under
the 64-bit key ``seed``; a word x becomes u = (2·(x >> 9) + 1)·2⁻²⁴,
exact in f32, and g = −log(−log u).
"""
from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF
PHILOX_M = (0xD2511F53, 0xCD9E8D57)
PHILOX_W = (0x9E3779B9, 0xBB67AE85)


def _mulhilo(a: int, b: torch.Tensor):
    """(hi, lo) 32-bit words of a·b for a constant a < 2³² and int64 b in
    [0, 2³²), in int64 arithmetic that never overflows."""
    p1 = b * (a & 0xFFFF)
    p2 = b * (a >> 16)
    t = ((p2 & 0xFFFF) << 16) + p1
    return (p2 >> 16) + (t >> 32), t & MASK32


def philox4x32(counter, key: int):
    """Philox-4x32-10 (Salmon et al., SC 2011) of four int64 tensors of
    32-bit counter words under the 64-bit ``key``."""
    c0, c1, c2, c3 = counter
    k0, k1 = key & MASK32, (key >> 32) & MASK32
    for r in range(10):
        if r:
            k0, k1 = (k0 + PHILOX_W[0]) & MASK32, (k1 + PHILOX_W[1]) & MASK32
        hi0, lo0 = _mulhilo(PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo(PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def gumbel(seed: int, phase: int, workers: torch.Tensor, slots: torch.Tensor,
           K: int, dtype=torch.float32) -> torch.Tensor:
    """(P, L, K) Gumbel draws for the tokens in ``slots`` (P, L) of the
    workers ``workers`` (P,) in the round of ``phase``: u is exact in
    f32, its two logs taken in ``dtype``."""
    P, L = slots.shape
    dev = slots.device
    chunks = -(-K // 4)
    shape = (P, L, chunks)
    c0 = torch.arange(chunks, device=dev).expand(shape)
    c1 = slots.long()[:, :, None].expand(shape)
    c2 = workers.long()[:, None, None].expand(shape)
    c3 = torch.full(shape, int(phase), dtype=torch.int64, device=dev)
    words = torch.stack(philox4x32((c0, c1, c2, c3), int(seed)), dim=-1)
    u = ((words >> 9) * 2 + 1).to(torch.float32) * 2.0 ** -24
    g = -torch.log(-torch.log(u.to(dtype)))
    return g.reshape(P, L, chunks * 4)[..., :K].contiguous()
