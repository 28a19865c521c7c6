"""STRADS Lasso (paper §3.3) on the port, from the JAX package's
``apps/lasso.py``.

Problem:   min_β ½‖y − Xβ‖² + λ‖β‖₁        (X standardized, no intercept)
With unit-norm columns and residual r = y − Xβ the CD update is
β_j ← S(x_jᵀ r + β_j, λ).  Per round:

  schedule:  propose U′ candidates ∝ |Δβ| + η; the candidate Gram block
             G = Σ_p (X_C^p)ᵀ X_C^p; greedy ρ-filter to ≤ U of them
  push:      z_{j,p} = (x_j^p)ᵀ r^p                                  (f₃)
  pull:      β_j ← S(Σ_p z_{j,p} + β_j, λ);  r^p ← r^p − X_B^p Δβ_B

X is (W, n/W, J) and r is (W, n/W): the worker axis leads, and the sum
over p is a ``.sum(0)`` in the engine.  The Gram block and the push
partials go through the injected kernel backend (``self.kernels``), so
``plan.kernels`` decides between the plain versions and the CUDA
kernels.  The candidate and block columns are gathered out of X before
each kernel, as the JAX package does.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from ..core import StradsAppBase, StradsEngine
from ..kernels import KernelSpec, build_kernels
from ..part import PartitionerSpec
from ..sched import SchedulerSpec
from . import _exec


def soft_threshold(x: torch.Tensor, lam: float) -> torch.Tensor:
    """S(x, λ) = sign(x)·max(|x| − λ, 0)  (Friedman et al., 2007)."""
    return torch.sign(x) * torch.clamp_min(x.abs() - lam, 0.0)


@dataclasses.dataclass(frozen=True)
class LassoConfig:
    num_features: int            # J
    lam: float = 0.1             # λ
    block_size: int = 8          # U  — concurrent updates per round
    num_candidates: int = 32     # U′ — proposal pool (STRADS only)
    rho: float = 0.3             # ρ  — dependency threshold (STRADS only)
    eta: float = 1e-6            # η  — priority floor
    scheduler: str = "strads"    # "strads" | "rr" (random) | "cyclic"


class StradsLasso(StradsAppBase):
    """The paper's Lasso on STRADS primitives; the Lasso-RR baseline is
    the same app with a ``kind="random"`` scheduler."""

    supported_scheduler_kinds = ("dynamic_priority", "random",
                                 "round_robin")
    supported_kernel_kinds = ("reference", "pallas")

    def __init__(self, cfg: LassoConfig):
        self.cfg = cfg

    # -- injection -----------------------------------------------------------

    def default_scheduler_spec(self) -> SchedulerSpec:
        cfg = self.cfg
        if cfg.scheduler == "strads":
            return SchedulerSpec(kind="dynamic_priority",
                                 block_size=cfg.block_size,
                                 num_candidates=cfg.num_candidates,
                                 rho=cfg.rho, eta=cfg.eta)
        if cfg.scheduler == "rr":
            return SchedulerSpec(kind="random", block_size=cfg.block_size)
        if cfg.scheduler == "cyclic":
            return SchedulerSpec(kind="round_robin",
                                 block_size=cfg.block_size)
        raise ValueError(f"LassoConfig.scheduler must be 'strads', 'rr' "
                         f"or 'cyclic'; got {cfg.scheduler!r}")

    def num_schedulable(self) -> int:
        return self.cfg.num_features

    def default_kernel_spec(self) -> KernelSpec:
        """When neither the plan nor the engine names a backend: the CUDA
        kernels on the card, the plain versions on the CPU."""
        if self.device.type == "cuda":
            return KernelSpec.default_for("pallas")
        return KernelSpec(kind="reference")

    def _kernels(self):
        # engine-less direct calls lazily self-inject the config default
        if self.kernels is None:
            self.kernels = build_kernels(self.default_kernel_spec())
        return self.kernels

    # -- partition injection -------------------------------------------------
    # Coefficients are interchangeable, so every partition kind applies:
    # the ownership map is bookkeeping (which worker serves β_j), and the
    # load balancer's activity signal is |Δβ| — the quantity the dynamic
    # scheduler's priorities track.

    supported_partitioner_kinds = ("static", "size_balanced",
                                   "load_balanced")

    def default_partitioner_spec(self) -> PartitionerSpec:
        return PartitionerSpec(kind="static")

    def partition_signal(self, state):
        return state["beta"]

    @property
    def needs_schedule_stats(self) -> bool:
        # the Gram ρ-filter is the only policy needing the stats sum
        return self.scheduler is not None and self.scheduler.needs_stats

    # -- state: β (replicated), r (row-sharded) ------------------------------

    def init_state(self, y=None):
        if y is None:
            raise ValueError("StradsLasso.init_state needs y (the initial "
                             "residual r = y at β = 0)")
        # r = y − Xβ at β = 0, a copy: the data's y may be the same
        # storage, and a streamed run writes both in place
        return {
            "beta": torch.zeros((self.cfg.num_features,),
                                dtype=torch.float32, device=self.device),
            "r": torch.as_tensor(y, dtype=torch.float32,
                                 device=self.device).clone(),
        }

    def state_specs(self):
        return {"beta": None, "r": "data"}

    def data_specs(self):
        return {"X": "data", "y": "data"}

    # -- schedule ------------------------------------------------------------

    def propose(self, state, carry, noise, t, phase):
        return self.scheduler.propose(carry, noise, t, phase,
                                      device=self.device)

    def schedule_stats(self, data, state, candidates, phase):
        # per-worker candidate Gram blocks (W, U′, U′) — the ρ-filter hot
        # spot, served by the injected gram_block kernel
        Xc = data["X"].index_select(-1, candidates)
        return self._kernels().gram_block(Xc)

    def schedule(self, state, carry, candidates, stats, t, phase):
        idx, mask = self.scheduler.finalize(candidates, stats)
        return {"idx": idx, "mask": mask}

    def sched_update(self, carry, before, after, sched, phase):
        # feed the committed Δβ of the scheduled block back into the
        # policy (f₁'s priority signal); stateless policies ignore it
        if carry is None:
            return carry
        idx, mask = sched["idx"], sched["mask"]
        dx = after["beta"][idx] - before["beta"][idx]
        return self.scheduler.update_carry(carry, idx, mask, dx)

    # -- push / pull ----------------------------------------------------------

    def push(self, data, state, sched, phase):
        # z_{j,p} = (x_j^p)ᵀ r^p per worker (paper f₃) — the push hot spot
        Xb = data["X"].index_select(-1, sched["idx"])      # (W, n_p, U)
        return self._kernels().lasso_partial(Xb, state["r"]), None

    def pull(self, state, sched, z, local, data, phase):
        idx, mask = sched["idx"], sched["mask"]
        beta_old = state["beta"][idx]
        beta_new = soft_threshold(z + beta_old, self.cfg.lam)
        beta_new = torch.where(mask, beta_new, beta_old)
        d = beta_new - beta_old
        # scheduled indices are distinct, so the scatter is deterministic
        beta = state["beta"].clone()
        beta[idx] = torch.where(mask, beta_new, state["beta"][idx])
        # residual maintenance on every worker's rows: r ← r − X_B Δβ
        Xb = data["X"].index_select(-1, idx)
        r = state["r"] - Xb @ (d * mask)
        return {"beta": beta, "r": r}

    # -- serving (query primitive) -------------------------------------------

    def query(self, state, batch):
        """``predict``: ŷ = xᵀβ per request row (``{"x": (B, J)}`` →
        ``{"y_hat": (B,)}``).  Only β is read — the server-resident leaf,
        so under ``ServeSpec(kind="stale")`` a prediction is exactly as
        stale as an SSP worker's own read of β."""
        return {"y_hat": batch["x"] @ state["beta"]}

    # -- streaming (ingest primitives) ---------------------------------------

    #: every observation row is real (no validity channel to derive an
    #: extend-kind ring mask from), so only in-place replacement streams
    supported_stream_kinds = ("replace",)

    def ingest_specs(self):
        return {"leaves": ("X", "y"), "valid": None}

    def ingest(self, data, state, rows, delta):
        """Overwrite observation rows and keep the residual invariant
        ``r = y − Xβ`` true on exactly those rows (β is untouched — the
        next scheduled rounds react to the new data through r).  Global
        row g is worker g // (n/W)'s local row g % (n/W), as
        ``shard_data`` lays X out (W, n/W, J), so the flat view of each
        leaf takes the rows as they are.  Writes X, y and r in place."""
        dev, J = self.device, self.cfg.num_features
        rows = torch.as_tensor(rows, device=dev).long()
        X_new = torch.as_tensor(delta["data"]["X"], dtype=torch.float32,
                                device=dev)
        y_new = torch.as_tensor(delta["data"]["y"], dtype=torch.float32,
                                device=dev)
        data["X"].view(-1, J)[rows] = X_new
        data["y"].view(-1)[rows] = y_new
        if state is None:
            return data, None
        state["r"].view(-1)[rows] = y_new - X_new @ state["beta"]
        return data, state

    # -- objective -----------------------------------------------------------

    def objective_collect(self) -> Callable:
        """½‖r‖² + λ‖β‖₁ as a device scalar (a ``collect`` fn)."""
        lam = self.cfg.lam
        return lambda s: (0.5 * torch.sum(s["r"] * s["r"])
                          + lam * torch.sum(s["beta"].abs()))


# ---------------------------------------------------------------------------
# Data generation (paper §4.1) + driver
# ---------------------------------------------------------------------------

def synthetic_correlated(rng: np.random.Generator, n: int, J: int,
                         corr: float = 0.9, k_true: int = 10,
                         noise: float = 0.1):
    """The paper's correlated synthetic design, dense laptop-scale variant
    (the JAX package's recipe and random stream, in numpy).

    x₁ ~ U(0,1) noise; for j ≥ 2, with prob ``corr`` x_j gets fresh noise,
    otherwise x_j = 0.9·x_{j−1} + 0.1·U(0,1).  Columns are standardized
    (zero mean, unit L2), y from a k_true-sparse β*.
    """
    eps = rng.uniform(0, 1, size=(n, J)).astype(np.float32)
    X = np.empty((n, J), np.float32)
    X[:, 0] = eps[:, 0]
    for j in range(1, J):
        fresh = rng.uniform() < corr
        X[:, j] = eps[:, j] if fresh else 0.9 * X[:, j - 1] + 0.1 * eps[:, j]
    X -= X.mean(axis=0)
    X /= np.maximum(np.linalg.norm(X, axis=0), 1e-12)
    beta_star = np.zeros((J,), np.float32)
    support = rng.choice(J, size=k_true, replace=False)
    beta_star[support] = rng.normal(0, 1, size=k_true).astype(np.float32)
    y = X @ beta_star + noise * rng.normal(0, 1, size=n).astype(np.float32)
    y = (y - y.mean()).astype(np.float32)
    return X, y, beta_star


def synthetic_correlated_device(seed: int, n: int, J: int,
                                corr: float = 0.9, k_true: int = 10,
                                noise: float = 0.1, device="cuda"):
    """The same recipe built on the device, for sizes where numpy is too
    slow (its draws differ from :func:`synthetic_correlated`'s).  The
    large draws come from a ``torch.Generator`` seeded with ``seed``, the
    small ones from ``np.random.default_rng(seed)``.  The column chain
    x_j = 0.9·x_{j−1} + 0.1·ε_j is applied in place, one pass per chain
    depth, so X is never held twice.  Returns device tensors X (n, J),
    y (n,) and β* (J,)."""
    device = torch.device(device)
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    X = torch.rand((n, J), generator=gen, device=device)       # ε
    fresh = rng.uniform(size=J) < corr
    fresh[0] = True
    depth = np.zeros(J, np.int64)
    for j in range(1, J):
        depth[j] = 0 if fresh[j] else depth[j - 1] + 1
    for p in range(1, int(depth.max()) + 1):
        cols = torch.as_tensor(np.nonzero(depth == p)[0], device=device)
        X[:, cols] = 0.9 * X[:, cols - 1] + 0.1 * X[:, cols]
    X -= X.mean(dim=0)
    X /= torch.clamp_min(torch.linalg.vector_norm(X, dim=0), 1e-12)
    beta_star = np.zeros((J,), np.float32)
    support = rng.choice(J, size=k_true, replace=False)
    beta_star[support] = rng.normal(0, 1, size=k_true).astype(np.float32)
    beta_star = torch.as_tensor(beta_star, device=device)
    y = X @ beta_star + noise * torch.randn((n,), generator=gen,
                                            device=device)
    return X, y - y.mean(), beta_star


def make_engine(cfg: LassoConfig, workers: int = 1, device="cuda",
                scheduler: Optional[SchedulerSpec] = None,
                kernels: Optional[KernelSpec] = None) -> StradsEngine:
    app = StradsLasso(cfg)
    return StradsEngine(app, app.data_specs(), app.state_specs(),
                        workers=workers, device=device, scheduler=scheduler,
                        kernels=kernels)


def fit(cfg: LassoConfig, X, y, num_rounds: Optional[int] = None,
        generator: Optional[torch.Generator] = None,
        trace_every: Optional[int] = None, plan=None, *,
        workers: Optional[int] = None, device="cuda",
        noise: Optional[Callable] = None):
    """Run STRADS Lasso; returns (state, trace of (t, objective)).

    ``plan`` (an :class:`~repro_torch.core.ExecutionPlan`) declares the
    executor, rounds, the ``collect_every`` trace cadence, the scheduler
    and the kernel backend, as in the JAX package.  W comes from
    ``workers``, else ``plan.workers``, else 1.  The returned state is
    flat: r is (n,).  ``noise(t)`` replaces the generator's per-round
    Gumbel draw (the parity tests feed the JAX package's draws)."""
    plan = _exec.resolve_plan(plan, num_rounds=num_rounds,
                              trace_every=trace_every)
    eng = make_engine(cfg, workers=workers or plan.workers or 1,
                      device=device)
    data = eng.shard_data({"X": X, "y": y})
    state = eng.init_state(y=y)
    every = plan.collect_every

    if plan.executor != "loop":
        collect = eng.app.objective_collect() if every else None
        rep = eng.execute(state, data, generator, plan, collect=collect,
                          noise=noise)
        if collect is None:
            return eng.unshard(rep.state), []
        return eng.unshard(rep.state), _exec.decimate(
            rep.trace.cpu().numpy(), plan.rounds, every)

    obj = eng.app.objective_collect()
    trace = []

    def cb(t, s, out):
        if every and (t % every == 0 or t == plan.rounds - 1):
            trace.append((t, float(obj(s))))
        return False

    rep = eng.execute(state, data, generator, plan, callback=cb, noise=noise)
    return eng.unshard(rep.state), trace


def reference_cd(X: np.ndarray, y: np.ndarray, lam: float,
                 num_sweeps: int) -> np.ndarray:
    """Single-machine cyclic CD oracle (ground truth for tests)."""
    J = X.shape[1]
    beta = np.zeros((J,), np.float32)
    r = y.copy()
    for _ in range(num_sweeps):
        for j in range(J):
            zj = X[:, j] @ r + beta[j]
            bj = np.sign(zj) * max(abs(zj) - lam, 0.0)
            r -= X[:, j] * (bj - beta[j])
            beta[j] = bj
    return beta
