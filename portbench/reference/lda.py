"""The plain reference of STRADS LDA: the collapsed counts of an
assignment, one round of word-rotation Gibbs sampling, and the
``infer_topics`` fold-in.

Plain PyTorch; imports nothing of the program.  The round follows the
semantics the paper (§3.1) and the program's documentation state: the
vocabulary is split into U contiguous blocks of V_b words, and in the
round of ``phase`` worker p samples, in slot order, its tokens whose word
lies in block b = (p + phase) mod U, against the word-topic counts B, its
own documents' counts D and its own copy s̃ of the topic totals s.  Per
token: remove its topic z from B, D and s̃; logits
(log(γ + B[v]) − log(Vγ + s̃)) + log(α + D[d]); the new topic is the
first argmax of Gumbel noise + logits; add it back.  The noise is
:func:`.philox.gumbel` of (``seed``, ``phase``, worker, slot).  The pull
makes s the column sums of B again.

:func:`forced_gap` replays a round teacher-forced: in the same order,
with the program's chosen topics moving the counts, it measures for
each token how far its chosen topic's score (noise + logits, in float64)
lies below the best one.  A sampler that takes the Gumbel-max draw at
any sound float32 rounding reads near 0; one that picks other topics
than the draw's best reads the gap of the worst pick.

``low=True`` computes the logits in bfloat16 (each log's argument, each
log and each sum rounded to bfloat16): the control that a comparison at
the configuration's precision, float32, has to catch.
"""
from __future__ import annotations

import torch

from . import philox


def counts(words: torch.Tensor, docs: torch.Tensor, z: torch.Tensor, *,
           padded_vocab: int, docs_per_worker: int, num_topics: int):
    """The collapsed counts of an assignment: B (V_p, K), D (U·dpw, K)
    f32 and s (K,) f32, from words, docs, z (U, T_p) (word −1 marks an
    empty slot).  Counts are integers, exact in f32 below 2²⁴."""
    U, Tp = words.shape
    K, dev = num_topics, words.device
    w = words.reshape(-1).long()
    on = w >= 0
    k = z.reshape(-1).long()[on]
    u = torch.arange(U * Tp, device=dev) // Tp
    drow = (u * docs_per_worker + docs.reshape(-1).long())[on]
    one = torch.ones(k.shape, device=dev)
    B = torch.zeros((padded_vocab, K), device=dev)
    B.index_put_((w[on], k), one, accumulate=True)
    D = torch.zeros((U * docs_per_worker, K), device=dev)
    D.index_put_((drow, k), one, accumulate=True)
    s = torch.bincount(k, minlength=K).to(torch.float32)
    return B, D, s


def active_slots(words: torch.Tensor, phase: int, block_vocab: int):
    """Worker p's block ``(p + phase) mod U`` and the slots of its tokens
    there in slot order: ``(slots (U, L) int64, counts (U,))``; a row's
    entries past its count are slots of other tokens, never read."""
    U = words.shape[0]
    p = torch.arange(U, device=words.device)
    blk = (p + phase) % U
    act = (words >= 0) & (words.long() // block_vocab == blk[:, None])
    cnt = act.sum(1)
    order = torch.sort((~act).to(torch.int8), dim=1, stable=True).indices
    L = int(cnt.max())
    return order[:, :L], cnt


def gibbs_round(words, docs, z, B, D, s, *, phase: int, block_vocab: int,
                docs_per_worker: int, alpha: float, gamma: float,
                vg: float, seed: int, low: bool = False,
                block: int = 256):
    """One round of every worker's sweep, from an assignment ``z`` and its
    counts (:func:`counts`).  Writes z, B, D in place; returns the pulled
    s (K,) f32, the column sums of the new B.  ``vg`` is V_p·γ as a
    Python float, ``block`` the token steps whose noise is drawn at
    once."""
    U, _ = words.shape
    K = B.shape[1]
    dev = words.device
    p = torch.arange(U, device=dev)
    slots, cnt = active_slots(words, phase, block_vocab)
    st = s.float().expand(U, K).clone()
    dt = torch.bfloat16 if low else torch.float32
    for j0 in range(0, slots.shape[1], block):
        sl = slots[:, j0:j0 + block]
        g = philox.gumbel(seed, phase, p, sl, K)
        for jj in range(sl.shape[1]):
            act = (j0 + jj) < cnt
            w, slot = p[act], sl[act, jj]
            v = words[w, slot].long()
            d = w * docs_per_worker + docs[w, slot].long()
            zi = z[w, slot].long()
            B[v, zi] -= 1.0
            D[d, zi] -= 1.0
            st[w, zi] -= 1.0
            logits = ((torch.log((gamma + B[v]).to(dt))
                       - torch.log((vg + st[w]).to(dt)))
                      + torch.log((alpha + D[d]).to(dt)))
            znew = torch.argmax(g[w, jj].to(dt) + logits, dim=-1)
            B[v, znew] += 1.0
            D[d, znew] += 1.0
            st[w, znew] += 1.0
            z[w, slot] = znew.to(z.dtype)
    return B.sum(0)


def forced_gap(words, docs, z, z_new, B, D, s, *, phase: int,
               block_vocab: int, docs_per_worker: int, alpha: float,
               gamma: float, vg: float, seed: int,
               block: int = 256) -> float:
    """The widest gap of a sampled round, teacher-forced: from the
    assignment ``z`` before the round and its counts (:func:`counts`),
    walk the round of ``phase`` in slot order, and per token take its
    score over the K topics, Philox noise plus logits in float64, and
    the gap by which the score of its topic in ``z_new`` lies below the
    best, over the largest |score|; then move the counts by that topic.
    Returns the largest such gap (inf where ``z_new`` holds no topic)."""
    U, _ = words.shape
    K = B.shape[1]
    if bool(((z_new < 0) | (z_new >= K)).any()):
        return float("inf")
    dev = words.device
    f64 = torch.float64
    p = torch.arange(U, device=dev)
    slots, cnt = active_slots(words, phase, block_vocab)
    B, D = B.to(f64), D.to(f64)
    st = s.to(f64).expand(U, K).clone()
    gap = torch.zeros((), dtype=f64, device=dev)
    for j0 in range(0, slots.shape[1], block):
        sl = slots[:, j0:j0 + block]
        g = philox.gumbel(seed, phase, p, sl, K, dtype=f64)
        for jj in range(sl.shape[1]):
            act = (j0 + jj) < cnt
            w, slot = p[act], sl[act, jj]
            v = words[w, slot].long()
            d = w * docs_per_worker + docs[w, slot].long()
            zi = z[w, slot].long()
            zn = z_new[w, slot].long()
            B[v, zi] -= 1.0
            D[d, zi] -= 1.0
            st[w, zi] -= 1.0
            score = g[w, jj] + ((torch.log(gamma + B[v])
                                 - torch.log(vg + st[w]))
                                + torch.log(alpha + D[d]))
            got = score.gather(1, zn[:, None])[:, 0]
            rel = (score.max(1).values - got) / score.abs().max(1).values
            gap = torch.maximum(gap, rel.max())
            B[v, zn] += 1.0
            D[d, zn] += 1.0
            st[w, zn] += 1.0
    return float(gap)


def fold_in(words: torch.Tensor, rows: torch.Tensor, s: torch.Tensor, *,
            padded_vocab: int, alpha: float, gamma: float, iters: int,
            dtype=torch.float64) -> torch.Tensor:
    """``infer_topics`` of one document in float64: ``rows`` (n, K) are
    the word-topic counts of its n words (−1 padding left out), ``s`` the
    topic totals of the view it was served from.  Mean-field fold-in with
    the topics held fixed: φ_lk ∝ (γ + B[v_l, k]) / (V_p·γ + s_k), θ from
    1/K re-estimated ``iters`` times as α + Σ_l q_l, normalised.  Returns
    θ (K,) in ``dtype`` (bfloat16 for the control)."""
    K = rows.shape[1]
    phi = (gamma + rows.to(dtype)) / (padded_vocab * gamma + s.to(dtype))
    theta = torch.full((K,), 1.0 / K, dtype=dtype, device=rows.device)
    for _ in range(iters):
        q = phi * theta
        q = q / q.sum(-1, keepdim=True).clamp_min(1e-30)
        theta = alpha + q.sum(0)
        theta = theta / theta.sum()
    return theta
