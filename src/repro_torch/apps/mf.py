"""STRADS Matrix Factorization (paper §3.2) and an ALS baseline on the
port, from the JAX package's ``apps/mf.py``.

Task:  min_{W,H}  Σ_{(i,j)∈Ω} (a_ij − wᵢhⱼ)² + λ(‖W‖_F² + ‖H‖_F²),
W ∈ R^{N×K}, H ∈ R^{K×M}, by rank-wise parallel coordinate descent.
Rounds alternate an H-phase (phase 0) and a W-phase (phase 1) over the
same rank block, so ``phase_period`` is 2:

  push (H-phase):  a_j^p = Σ_{i∈(Ω_j)_p} (r_ij + w_ik h_kj) w_ik,
                   b_j^p = Σ_{i∈(Ω_j)_p} w_ik²
  pull:            h_kj ← Σ_p a_j^p / (λ + Σ_p b_j^p);
                   R ← R − w_k (h_k_new − h_k_old) · mask
  W-phase:         rows live whole on one worker, so each worker solves
                   its rows' w_ik in closed form in ``pull``; ``push``
                   returns no partials and the sum over workers is
                   skipped (the JAX package sums zero-shaped partials).

Layout: A, the observation mask, W and the residual R are split by rows
over the workers, (W, n/W, …); H is replicated.  The residual is zero off
the mask (``init_state``, ``pull`` and ``ingest`` keep it so), so the
round reads R where the JAX package reads R · mask: the same numbers
without an N × M temporary.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import numpy as np
import torch

from ..core import StradsAppBase, StradsEngine, resolve_device
from ..kernels import KernelSpec
from ..part import PartitionerSpec
from ..sched import SchedulerSpec
from . import _exec

_TINY = float(np.finfo(np.float32).tiny)
#: the base of MF's per-cycle schedule draws (the JAX package's key(29))
CYCLE_KEY = 29


@dataclasses.dataclass(frozen=True)
class MFConfig:
    num_rows: int                # N (users)
    num_cols: int                # M (items)
    rank: int                    # K
    lam: float = 0.05
    ranks_per_round: int = 1     # how many rank indices per BSP round
    top_k: int = 8               # recommendations per query() request


def cycle_gumbel(cycle: int, num_vars: int, device) -> torch.Tensor:
    """The (num_vars,) Gumbel draw of an H/W cycle, from a generator
    seeded with (:data:`CYCLE_KEY`, cycle) alone: the same in both halves
    of the cycle and independent of the fit's seed, as the JAX package's
    ``fold_in(key(29), cycle)``."""
    gen = torch.Generator(device=device)
    gen.manual_seed((CYCLE_KEY << 32) + int(cycle))
    u = torch.rand((num_vars,), generator=gen, device=device)
    return -torch.log(-torch.log(u.clamp_min_(_TINY)))


def sum_squares(x: torch.Tensor) -> torch.Tensor:
    """Σ x² as a float64 scalar: f32 norms of the last axis, squared and
    summed in float64 (one pass over x, no temporary of its size)."""
    if x.dim() < 2:
        return torch.linalg.vector_norm(x).double().square()
    return torch.linalg.vector_norm(x, dim=-1).double().square().sum()


class StradsMF(StradsAppBase):
    """Round-robin rank-wise CD on STRADS primitives."""

    phase_period = 2                     # H-phase / W-phase alternation
    # rank blocks are mutually independent given the other factor, so no
    # dependency filter applies: only the stateless dispatch kinds
    supported_scheduler_kinds = ("round_robin", "random")
    # rank-1 updates are GEMVs and elementwise passes: plain torch ops
    supported_kernel_kinds = ("reference",)
    # a random block is drawn once per H/W cycle (see propose)
    own_noise = True

    def __init__(self, cfg: MFConfig):
        self.cfg = cfg

    # -- state: W, R row-sharded; H replicated ------------------------------

    def init_state(self, A=None, mask=None,
                   generator: Optional[torch.Generator] = None):
        """W, H ~ N(0, 1)/√K from ``generator`` (a fresh one seeded 0 if
        None), R = (A − WH) · mask."""
        if A is None:
            raise ValueError("StradsMF.init_state needs A (for the residual)")
        cfg, dev = self.cfg, self.device
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        W = torch.randn((cfg.num_rows, cfg.rank), generator=generator,
                        device=dev) / math.sqrt(cfg.rank)
        H = torch.randn((cfg.rank, cfg.num_cols), generator=generator,
                        device=dev) / math.sqrt(cfg.rank)
        A = torch.as_tensor(A, dtype=torch.float32, device=dev)
        mask = torch.as_tensor(mask, dtype=torch.float32, device=dev)
        R = torch.addmm(A, W, H, alpha=-1).mul_(mask)
        return {"W": W, "H": H, "R": R}

    def state_specs(self):
        return {"W": "data", "H": None, "R": "data"}

    def data_specs(self):
        return {"A": "data", "mask": "data"}

    # -- schedule: round-robin (phase, rank) ---------------------------------

    def default_scheduler_spec(self) -> SchedulerSpec:
        # the paper's round-robin dispatch over the q_p / r_p index sets
        return SchedulerSpec(kind="round_robin",
                             block_size=self.cfg.ranks_per_round)

    def num_schedulable(self) -> int:
        return self.cfg.rank

    # -- partition injection -------------------------------------------------
    # Rank blocks are interchangeable, so ownership may move freely; the
    # activity signal is the per-rank L1 mass of H.

    supported_partitioner_kinds = ("static", "size_balanced",
                                   "load_balanced")

    def default_partitioner_spec(self) -> PartitionerSpec:
        return PartitionerSpec(kind="static")

    def partition_signal(self, state):
        return state["H"].abs().sum(1)

    def partition_sizes(self):
        # bytes per rank: a row of H (M floats) + a column of W (N)
        cfg = self.cfg
        return [4 * (cfg.num_cols + cfg.num_rows)] * cfg.rank

    def static_phase(self, t: int) -> int:
        # Alternate H-phase (0) and W-phase (1) every round.
        return t % 2

    def propose(self, state, carry, noise, t, phase):
        # The rank block advances once per H/W cycle, so both halves of a
        # cycle must schedule the same block: a stochastic policy draws
        # from a source keyed on the cycle (cycle_gumbel), or from the
        # caller's noise(t), which must then agree within a cycle.
        cyc = t // 2
        if noise is None and self.scheduler.needs_noise:
            noise = cycle_gumbel(cyc, self.cfg.rank, self.device)
        ks = self.scheduler.propose(carry, noise, cyc, phase,
                                    device=self.device)
        return {"ranks": ks}

    # -- push / pull ----------------------------------------------------------

    def push(self, data, state, sched, phase):
        if phase != 0:
            # W-phase: rows are whole on their worker; nothing to sum
            return None, None
        W, H, R, mask = state["W"], state["H"], state["R"], data["mask"]
        ks = sched["ranks"]
        Wk = W.index_select(-1, ks)                       # (P, n_p, Kr)
        Hk = H.index_select(0, ks)                        # (Kr, M)
        # b_j = Σ_i m_ij w_ik² ; a_j = Σ_i w_ik r_ij + b_j h_kj
        wk2 = (Wk * Wk).mT @ mask                         # (P, Kr, M)
        a = Wk.mT @ R + wk2 * Hk
        return {"a": a, "b": wk2}, None

    def pull(self, state, sched, z, local, data, phase):
        cfg = self.cfg
        W, H, R, mask = state["W"], state["H"], state["R"], data["mask"]
        ks = sched["ranks"]
        if phase == 0:
            Hk_old = H.index_select(0, ks)                # (Kr, M)
            Hk_new = z["a"] / (cfg.lam + z["b"])          # g₃
            H = H.clone()
            H[ks] = Hk_new
            Wk = W.index_select(-1, ks)                   # (P, n_p, Kr)
            R = _sync(R, Wk, Hk_new - Hk_old, mask)
            return {"W": W, "H": H, "R": R}
        # W-phase: local closed-form CD for rank block ks on local rows
        Hk = H.index_select(0, ks)                        # (Kr, M)
        Wk_old = W.index_select(-1, ks)                   # (P, n_p, Kr)
        mh = mask @ (Hk * Hk).mT                          # (P, n_p, Kr)
        Wk_new = (R @ Hk.mT + Wk_old * mh) / (cfg.lam + mh)
        W = W.clone()
        W[..., ks] = Wk_new
        R = _sync(R, Wk_new - Wk_old, Hk, mask)
        return {"W": W, "H": H, "R": R}

    # -- serving (query primitive) -------------------------------------------

    def query(self, state, batch):
        """``recommend``: top-k item scores for each requested user row
        (``{"user": (B,)}`` → ``{"items": (B, k), "scores": (B, k)}``),
        scores w_uᵀh_j over all items, ties to the lower item index as
        ``lax.top_k`` takes them."""
        k = min(self.cfg.top_k, self.cfg.num_cols)
        users = torch.as_tensor(batch["user"], device=self.device).long()
        Wu = state["W"].reshape(-1, self.cfg.rank)[users]     # (B, K)
        scores = Wu @ state["H"]                               # (B, M)
        top, items = torch.sort(scores, dim=-1, descending=True,
                                stable=True)
        return {"items": items[:, :k], "scores": top[:, :k]}

    # -- streaming (ingest primitives) ---------------------------------------

    #: the ratings mask doubles as the validity channel (padding user rows
    #: have an all-zero mask and stay inert until a delta lands)
    supported_stream_kinds = ("replace", "extend")

    def ingest_specs(self):
        return {"leaves": ("A", "mask"),
                "valid": lambda data: data["mask"].reshape(
                    -1, self.cfg.num_cols).any(dim=1)}

    def ingest(self, data, state, rows, delta):
        """Overwrite user rows (refreshed ratings, or new users landing in
        ring slots) and keep ``R = (A − WH) · mask`` true on exactly those
        rows; the W rows stay as warm starts.  Global row g is worker
        g // (N/W)'s local row, as ``shard_data`` lays the rows out, so
        the flat view of each leaf takes the rows as they are.  Writes A,
        the mask and R in place, only on those rows (a copy of any of
        them is N × M floats).  ``rows`` and the delta's arrays may be
        numpy or tensors on any device."""
        M, dev = self.cfg.num_cols, self.device
        rows = torch.as_tensor(rows, device=dev).long()
        A_new = torch.as_tensor(delta["data"]["A"], dtype=torch.float32,
                                device=dev)
        m_new = torch.as_tensor(delta["data"]["mask"], dtype=torch.float32,
                                device=dev)
        data["A"].view(-1, M)[rows] = A_new
        data["mask"].view(-1, M)[rows] = m_new
        if state is None:
            return data, None
        W_rows = state["W"].view(-1, self.cfg.rank)[rows]
        state["R"].view(-1, M)[rows] = (A_new - W_rows @ state["H"]) * m_new
        return data, state

    def objective_collect(self) -> Callable:
        """Σ R² + λ(‖W‖² + ‖H‖²), a float64 device scalar (a ``collect``
        fn).  R is zero off the mask, so Σ R² is the masked error."""
        lam = self.cfg.lam
        return lambda s: (sum_squares(s["R"]) + lam * sum_squares(s["W"])
                          + lam * sum_squares(s["H"]))


def _sync(R: torch.Tensor, Wk: torch.Tensor, dHk: torch.Tensor,
          mask: torch.Tensor) -> torch.Tensor:
    """R − (Wk·dHk) · mask, as the JAX package writes it: the product into
    a new (P, n_p, M) tensor, then one pass that masks it and subtracts
    it from R in place of it."""
    P, n, M = R.shape
    out = Wk.reshape(P * n, -1) @ dHk
    return torch.addcmul(R.reshape(P * n, M), out, mask.reshape(P * n, M),
                         value=-1, out=out).view(P, n, M)


# ---------------------------------------------------------------------------
# ALS baseline (GraphLab-style alternating least squares)
# ---------------------------------------------------------------------------

def _outer_rows(X: torch.Tensor) -> torch.Tensor:
    """(n, K) → (n, K·K): the outer product x xᵀ of every row."""
    return (X[:, :, None] * X[:, None, :]).reshape(X.shape[0], -1)


def als_step(A, mask, W, H, lam: float, chunk: int = 4096):
    """One full ALS alternation (dense masked closed-form solves): every
    row solves (Hᵀ diag(m) H + λI) w = Hᵀ diag(m) a, then every column
    the same against the new W.  The Gram matrices are built in chunks of
    rows as GEMMs against the outer products, never as an (N, K, M)
    product."""
    N, M = A.shape
    K = W.shape[1]
    eye = torch.eye(K, dtype=W.dtype, device=W.device) * lam
    HH = _outer_rows(H.mT).mT                                # (K·K, M)
    W = torch.empty_like(W)
    for i in range(0, N, chunk):
        m, a = mask[i:i + chunk], A[i:i + chunk]
        G = (m @ HH.mT).view(-1, K, K) + eye
        W[i:i + chunk] = torch.linalg.solve(G, (a * m) @ H.mT)
    G = torch.zeros((M, K * K), dtype=W.dtype, device=W.device)
    b = torch.zeros((M, K), dtype=W.dtype, device=W.device)
    for i in range(0, N, chunk):
        m, a, w = mask[i:i + chunk], A[i:i + chunk], W[i:i + chunk]
        G += m.mT @ _outer_rows(w)
        b += (a * m).mT @ w
    H = torch.linalg.solve(G.view(M, K, K) + eye, b).mT.contiguous()
    return W, H


def masked_objective(A, mask, W, H, lam: float,
                     chunk: int = 4096) -> float:
    """Σ ((A − WH)·mask)² + λ(‖W‖² + ‖H‖²), in chunks of rows."""
    sse = sum(float(sum_squares(torch.addmm(A[i:i + chunk], W[i:i + chunk],
                                            H, alpha=-1)
                                .mul_(mask[i:i + chunk])))
              for i in range(0, A.shape[0], chunk))
    return sse + lam * (float(sum_squares(W)) + float(sum_squares(H)))


def als_fit(A, mask, rank: int, lam: float, num_iters: int,
            generator: Optional[torch.Generator] = None, *,
            device="cuda"):
    """ALS from W, H ~ N(0, 1)/√K; returns ((W, H), [(it, objective)])."""
    dev = resolve_device(device)
    A = torch.as_tensor(A, dtype=torch.float32, device=dev)
    mask = torch.as_tensor(mask, dtype=torch.float32, device=dev)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    N, M = A.shape
    W = torch.randn((N, rank), generator=generator, device=dev) \
        / math.sqrt(rank)
    H = torch.randn((rank, M), generator=generator, device=dev) \
        / math.sqrt(rank)
    trace = []
    for it in range(num_iters):
        W, H = als_step(A, mask, W, H, lam)
        trace.append((it, masked_objective(A, mask, W, H, lam)))
    return (W, H), trace


# ---------------------------------------------------------------------------
# Data + driver
# ---------------------------------------------------------------------------

def synthetic_ratings(rng: np.random.Generator, N: int, M: int,
                      true_rank: int, density: float = 0.3,
                      noise: float = 0.05):
    """Low-rank + noise ratings with a sparse observation mask (the JAX
    package's recipe and numpy draws)."""
    Wt = rng.normal(0, 1, size=(N, true_rank)).astype(np.float32)
    Ht = rng.normal(0, 1, size=(true_rank, M)).astype(np.float32)
    A = (Wt @ Ht / np.sqrt(true_rank)).astype(np.float32)
    A += noise * rng.normal(0, 1, size=A.shape).astype(np.float32)
    mask = (rng.uniform(size=A.shape) < density).astype(np.float32)
    return A * mask, mask


def synthetic_ratings_device(seed: int, N: int, M: int, true_rank: int,
                             density: float = 0.3, noise: float = 0.05,
                             device="cuda", chunk: int = 8192):
    """The same recipe built on the device from a ``torch.Generator``
    seeded with ``seed`` (its draws differ from
    :func:`synthetic_ratings`'), for sizes where numpy is too slow.  The
    noise and the mask are drawn in chunks of rows, so nothing but A and
    the mask is held at full size.  Returns device tensors (A·mask,
    mask), each (N, M) f32."""
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    Wt = torch.randn((N, true_rank), generator=gen, device=device)
    Ht = torch.randn((true_rank, M), generator=gen, device=device)
    A = (Wt @ Ht).div_(math.sqrt(true_rank))
    mask = torch.empty_like(A)
    for i in range(0, N, chunk):
        a = A[i:i + chunk]
        a.add_(torch.randn(a.shape, generator=gen, device=device),
               alpha=noise)
        mask[i:i + chunk] = torch.rand(a.shape, generator=gen,
                                       device=device) < density
        a.mul_(mask[i:i + chunk])
    return A, mask


def make_engine(cfg: MFConfig, workers: int = 1, device="cuda",
                scheduler: Optional[SchedulerSpec] = None,
                kernels: Optional[KernelSpec] = None) -> StradsEngine:
    app = StradsMF(cfg)
    return StradsEngine(app, app.data_specs(), app.state_specs(),
                        workers=workers, device=device, scheduler=scheduler,
                        kernels=kernels)


def fit(cfg: MFConfig, A, mask, num_rounds: Optional[int] = None,
        generator: Optional[torch.Generator] = None,
        trace_every: Optional[int] = None, plan=None, *,
        workers: Optional[int] = None, device="cuda",
        noise: Optional[Callable] = None):
    """Run STRADS MF; returns (flat state, trace of (t, objective)).

    As :func:`repro_torch.apps.lasso.fit`: ``plan`` declares the executor,
    rounds, the ``collect_every`` cadence and the scheduler; W comes from
    ``workers``, else ``plan.workers``, else 1.  ``generator`` draws the
    initial W and H (a fresh one seeded 0 if None).  ``noise(t)``
    replaces a ``random`` scheduler's per-cycle draw (it must give the
    same draw for t = 2c and 2c + 1)."""
    plan = _exec.resolve_plan(plan, num_rounds=num_rounds,
                              trace_every=trace_every)
    eng = make_engine(cfg, workers=workers or plan.workers or 1,
                      device=device)
    data = eng.shard_data({"A": A, "mask": mask})
    state = eng.init_state(A=A, mask=mask, generator=generator)
    every = plan.collect_every
    obj = eng.app.objective_collect()

    if plan.executor != "loop":
        rep = eng.execute(state, data, None, plan,
                          collect=obj if every else None, noise=noise)
        if not every:
            return eng.unshard(rep.state), []
        return eng.unshard(rep.state), _exec.decimate(
            rep.trace.cpu().numpy(), plan.rounds, every)

    trace = []

    def cb(t, s, out):
        if every and (t % every == 0 or t == plan.rounds - 1):
            trace.append((t, float(obj(s))))
        return False

    rep = eng.execute(state, data, None, plan, callback=cb, noise=noise)
    return eng.unshard(rep.state), trace
