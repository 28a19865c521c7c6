"""The padding rules of the JAX package's ``sharding/rules.py``.

The port runs on one card and shards nothing, but it keeps the JAX
package's physical layout (vocabulary and query heads padded for a
16-way model axis), so parameters carry across one for one.  The
logical-axis names and ``constrain`` are not ported: on one device
``constrain`` is the identity.
"""
from __future__ import annotations

from typing import Tuple

MODEL_AXIS_SIZE = 16


def pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def padded_vocab(vocab_size: int) -> int:
    """Vocabulary padded so each of the 16 model shards is a multiple of
    128 wide; the pad rows are never sampled (``logits[:, :vocab]``)."""
    return pad_to_multiple(vocab_size, 128 * MODEL_AXIS_SIZE)


def padded_heads(num_heads: int, num_kv_heads: int) -> Tuple[int, int]:
    """Physical (q, kv) head counts for the 16-way model axis.

    * q heads are padded up to a multiple of 16 that keeps the GQA group
      count integral (llama4: 40→48 with kv=8 → G=6).
    * kv heads keep their count, except MHA-style counts (kv == q), which
      pad together (minicpm: 36/36 → 48/48).
    """
    hq = pad_to_multiple(num_heads, MODEL_AXIS_SIZE)
    if num_kv_heads == num_heads:
        return hq, hq
    kv = num_kv_heads
    while hq % kv:
        hq += MODEL_AXIS_SIZE                 # keep G = hq / kv integral
    return hq, kv
