"""STRADS LDA (paper §3.1) on the port: word-rotation collapsed Gibbs
sampling, from the JAX package's ``apps/lda.py``.

The vocabulary is split into U contiguous blocks of V_b words; at round t
worker p samples the tokens whose word lies in block ``(p + t) mod U``,
so concurrently sampled tokens never share a word or a document (each
document lives on one worker).  The only shared quantity is the topic
totals s, which each worker reads as a stale copy s̃ during its sweep
and which the pull makes consistent again; the Fig-5 s-error
(1/(U·M)) Σ_p ‖s̃_p − s‖₁ is reported every round.

Layout (workers as a leading axis): words, docs and z are (U, T_p); the
doc-topic table D is (U, dpw, K); the word-topic table B is (U, V_b, K)
by home block; s is (K,).  The JAX package rotates B to its processing
worker and home again with two ``ppermute`` calls; here the rotation is
indexing, and worker p samples against ``B[(p + t) mod U]`` in place.

The sweep is the hand-written kernel ``lda_gibbs``
(:mod:`repro_torch.kernels.lda_gibbs`), one thread block a worker, which
walks only each worker's active tokens.  Its noise is Philox keyed on
(seed, phase, worker, slot), as the reference keys its draws on
(phase, worker) and splits per slot, so the draws repeat every U rounds
(every round for the baseline), as they do there; or a caller's
``noise(phase)`` of per-slot Gumbel draws (the parity tests feed the JAX
package's).

The push updates z, B and D in place: workers write disjoint B blocks and
disjoint D rows, so nothing is read after another worker wrote it.  A
caller who keeps the state from before a round must clone it.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from ..core import StradsAppBase, StradsEngine, resolve_device
from ..kernels import KernelSpec, build_kernels
from ..kernels.lda_gibbs import gibbs_index
from ..kernels.ref import gibbs_active
from ..part import PartitionerSpec
from ..sched import SchedulerSpec
from . import _exec

#: the Philox seeds of the two samplers (the JAX package's key(17) and
#: key(23))
STRADS_SEED = 17
BASELINE_SEED = 23


@dataclasses.dataclass(frozen=True)
class LDAConfig:
    vocab: int                   # V (padded up to U * block_vocab)
    num_topics: int              # K
    num_workers: int             # U
    tokens_per_worker: int       # T_p (padded)
    docs_per_worker: int         # local doc count
    alpha: float = 0.1           # doc-topic prior
    gamma: float = 0.1           # word-topic prior

    @property
    def block_vocab(self) -> int:
        return -(-self.vocab // self.num_workers)    # ceil

    @property
    def padded_vocab(self) -> int:
        return self.block_vocab * self.num_workers


class _GibbsApp(StradsAppBase):
    """What both samplers share: the kernel backend, the token index and
    the caller's noise."""

    # the port has a kernel for the sweep: "pallas" names it, as for Lasso
    supported_kernel_kinds = ("reference", "pallas")
    seed = STRADS_SEED

    def __init__(self, cfg: LDAConfig,
                 noise: Optional[Callable[[int], object]] = None):
        self.cfg = cfg
        self.noise = noise
        self._index_of = None           # (words tensor, version, index)

    def default_kernel_spec(self) -> KernelSpec:
        """The CUDA kernel on the card, the plain version on the CPU."""
        if self.device.type == "cuda":
            return KernelSpec.default_for("pallas")
        return KernelSpec(kind="reference")

    def _kernels(self):
        if self.kernels is None:
            self.kernels = build_kernels(self.default_kernel_spec())
        return self.kernels

    def data_specs(self):
        return {"words": "data", "docs": "data"}

    def _index(self, words: torch.Tensor, block_vocab: int, n_blocks: int):
        """``gibbs_index`` of the words, built once and kept while the
        same tensor is unchanged (an in-place write, as ``ingest``'s,
        bumps its version, so the next sweep rebuilds it)."""
        c = self._index_of
        if c is None or c[0] is not words or c[1] != words._version:
            self._index_of = c = (words, words._version,
                                  gibbs_index(words, block_vocab, n_blocks))
        return c[2]

    def _sweep(self, data, z, B, D, s, phase: int, rotate: bool,
               block_vocab: int, n_blocks: int) -> torch.Tensor:
        cfg = self.cfg
        order, offsets = self._index(data["words"], block_vocab, n_blocks)
        gumbel = None
        if self.noise is not None:
            _, slots, _ = gibbs_active(order, offsets, phase)
            g = torch.as_tensor(self.noise(phase), dtype=torch.float32,
                                device=B.device)
            P = slots.shape[0]
            gumbel = g[torch.arange(P, device=B.device)[:, None],
                       slots].contiguous()
        return self._kernels().lda_gibbs(
            data["words"], data["docs"], z, order, offsets, B, D, s,
            phase=phase, rotate=rotate, block_vocab=block_vocab,
            vg=cfg.padded_vocab * cfg.gamma, alpha=cfg.alpha,
            gamma=cfg.gamma, gumbel=gumbel, seed=self.seed)


class StradsLDA(_GibbsApp):
    """Word-rotation model-parallel collapsed Gibbs on STRADS primitives.
    ``noise(phase)`` (optional) gives per-slot Gumbel draws (U, T_p, K)
    in place of the kernel's Philox draws."""

    supported_scheduler_kinds = ("rotation",)
    # the rotation's blocks are a frozen contiguous word → worker map, so
    # ownership cannot move: only the static partitioner applies
    supported_partitioner_kinds = ("static",)

    def __init__(self, cfg: LDAConfig, noise=None):
        super().__init__(cfg, noise)
        # one rotation = U rounds
        self.phase_period = cfg.num_workers

    def default_scheduler_spec(self) -> SchedulerSpec:
        return SchedulerSpec(kind="rotation")

    def num_schedulable(self) -> int:
        return self.cfg.padded_vocab

    def default_partitioner_spec(self) -> PartitionerSpec:
        return PartitionerSpec(kind="static")

    def static_phase(self, t: int) -> int:
        return t % self.cfg.num_workers

    def init_state(self, words=None, docs=None, z0=None):
        if words is None:
            raise ValueError("StradsLDA.init_state needs the corpus "
                             "(words=, docs=, z0=)")
        return build_state(self.cfg, words, docs, z0, device=self.device)

    def state_specs(self):
        return {"z": "data", "D": "data", "B": "data", "s": None,
                "s_err": None}

    # -- push / pull ----------------------------------------------------------

    def push(self, data, state, sched, phase):
        cfg = self.cfg
        z, B, D = state["z"], state["B"], state["D"]
        # worker p samples block scheduler.block_for_worker(p, phase) of B
        # in place: the JAX package's two ppermutes move nothing here
        s_tilde = self._sweep(data, z, B, D, state["s"], phase, True,
                              cfg.block_vocab, cfg.num_workers)
        # each home block's fresh column sums; their sum over blocks is s
        partial = {"s": B.sum(1)}
        local = {"z": z, "D": D, "B": B, "s_tilde": s_tilde}
        return partial, local

    def pull(self, state, sched, z, local, data, phase):
        cfg = self.cfg
        s_new = z["s"]
        # Fig-5 s-error: (1/UM) Σ_p ‖s̃_p − s_new‖₁  (M = total tokens)
        M = cfg.num_workers * cfg.tokens_per_worker
        s_err = (local["s_tilde"] - s_new).abs().sum() \
            / (cfg.num_workers * M)
        return {"z": local["z"], "D": local["D"], "B": local["B"],
                "s": s_new, "s_err": s_err}

    # -- serving (query primitive) -------------------------------------------

    #: fixed fold-in iterations for query()
    query_iters: int = 8

    def query(self, state, batch):
        """``infer_topics``: fold a batch of unseen documents
        (``{"words": (B, L)}``, −1-padded) into the trained topics →
        ``{"theta": (B, K), "top_topic": (B,)}``, by a fixed-iteration
        mean-field fold-in: φ_lk ∝ (γ + B[v_l, k]) / (Vγ + s[k]) with the
        topics held fixed, θ re-estimated ``query_iters`` times."""
        cfg = self.cfg
        words = torch.as_tensor(batch["words"], device=self.device).long()
        Bf = state["B"].reshape(-1, cfg.num_topics)
        v = words.clamp(0, cfg.padded_vocab - 1)
        active = (words >= 0)[..., None]                    # (B, L, 1)
        phi = (cfg.gamma + Bf[v]) / (cfg.padded_vocab * cfg.gamma
                                     + state["s"])          # (B, L, K)
        phi = torch.where(active, phi, 1.0)
        theta = torch.full((words.shape[0], cfg.num_topics),
                           1.0 / cfg.num_topics, device=self.device)
        for _ in range(self.query_iters):
            q = phi * theta[:, None, :]
            q = q / q.sum(-1, keepdim=True).clamp_min(1e-30)
            q = torch.where(active, q, 0.0)
            theta = cfg.alpha + q.sum(1)
            theta = theta / theta.sum(-1, keepdim=True)
        return {"theta": theta, "top_topic": theta.argmax(-1)}

    # -- streaming (ingest primitives) ---------------------------------------

    #: word −1 marks the padding slots the sweep skips; they double as the
    #: extend-kind validity channel
    supported_stream_kinds = ("replace", "extend")

    def ingest_specs(self):
        return {"leaves": ("words", "docs"),
                "valid": lambda data: data["words"].reshape(-1) >= 0}

    def ingest(self, data, state, rows, delta):
        """Swap token slots (flat over U·T_p) and keep the collapsed
        counts exact: each displaced active token is decremented out of
        D, B and s, each incoming one (topic ``delta["z"]``) incremented
        in.  Word −1 in a delta deletes the slot's token.  Writes words,
        docs, z, B, D and s in place, only where the slots reach (the
        in-place write bumps the words tensor's version, so the sweep's
        token index is rebuilt before the next round).  ``rows`` and the
        delta's arrays may be numpy or tensors on any device; their range
        checks read the card at most once a delta."""
        cfg, dev = self.cfg, self.device
        Tp, dpw, K = (cfg.tokens_per_worker, cfg.docs_per_worker,
                      cfg.num_topics)
        raw = [delta["data"]["words"], delta["data"]["docs"]]
        if state is not None:
            raw.append(delta["z"])
        lo_hi = _ranges(raw)
        w_rng, d_rng = lo_hi[0], lo_hi[1]
        if w_rng and (w_rng[1] >= cfg.vocab or w_rng[0] < -1):
            raise ValueError(f"ingested words out of [-1, {cfg.vocab})")
        if d_rng and (d_rng[0] < 0 or d_rng[1] >= dpw):
            raise ValueError(f"ingested docs out of [0, {dpw}) (doc ids "
                             f"are worker-local)")
        if state is not None and lo_hi[2] and (lo_hi[2][0] < 0
                                               or lo_hi[2][1] >= K):
            raise ValueError(f"ingested z out of [0, {K})")
        slots = torch.as_tensor(rows, device=dev).long()
        w_new, d_new = (torch.as_tensor(x, device=dev).long()
                        for x in raw[:2])
        words, docs = data["words"].view(-1), data["docs"].view(-1)
        if state is not None:
            # the displaced tokens, read before the slots are written
            w_old, d_old = words[slots].long(), docs[slots].long()
        words[slots] = w_new.to(words.dtype)
        docs[slots] = d_new.to(docs.dtype)
        if state is None:
            return data, None
        z = state["z"].view(-1)
        z_new = torch.as_tensor(raw[2], device=dev).long()
        z_old = z[slots].long()
        z[slots] = z_new.to(z.dtype)
        B, D, s = state["B"].view(-1, K), state["D"].view(-1, K), state["s"]
        u = slots // Tp                             # owning worker
        for w, d, k, sign in ((w_old, d_old, z_old, -1.0),
                              (w_new, d_new, z_new, 1.0)):
            # inactive slots (word −1) add exactly 0 at a valid index, so
            # no boolean mask (and no host read) is needed
            one = (w >= 0).to(B.dtype) * sign
            B.index_put_((w.clamp_min(0), k), one, accumulate=True)
            D.index_put_((u * dpw + d, k), one, accumulate=True)
            s.index_put_((k,), one, accumulate=True)
        return data, state

    def loglik_collect(self) -> Callable:
        """The collapsed log P(W, Z) (a ``collect`` fn) and the s-error."""
        cfg = self.cfg
        return lambda s: {"ll": log_likelihood(cfg, s), "s_err": s["s_err"]}


# ---------------------------------------------------------------------------
# Data-parallel baseline (YahooLDA-style)
# ---------------------------------------------------------------------------

class DataParallelLDAApp(_GibbsApp):
    """The data-parallel baseline: every worker samples all its tokens
    against its own replica of the full B (one block spanning the padded
    vocabulary) and the stale s, and the pull merges the table deltas."""

    seed = BASELINE_SEED

    def init_state(self, words=None, docs=None, z0=None):
        if words is None:
            raise ValueError("DataParallelLDAApp.init_state needs the "
                             "corpus (words=, docs=, z0=)")
        full = build_state(self.cfg, words, docs, z0, device=self.device)
        return {k: full[k] for k in ("z", "D", "B", "s")}

    def state_specs(self):
        return {"z": "data", "D": "data", "B": None, "s": None}

    def push(self, data, state, sched, phase):
        cfg = self.cfg
        P = data["words"].shape[0]
        z, D, B = state["z"], state["D"], state["B"]
        replica = B.expand(P, *B.shape).clone()         # (P, V_p, K)
        self._sweep(data, z, replica, D, state["s"], 0, False,
                    cfg.padded_vocab, 1)
        return {"dB": replica.sub_(B)}, {"z": z, "D": D}

    def pull(self, state, sched, z, local, data, phase):
        B = state["B"] + z["dB"]                 # merge stale deltas
        return {"z": local["z"], "D": local["D"], "B": B, "s": B.sum(0)}

    def loglik_collect(self) -> Callable:
        cfg = self.cfg
        return lambda s: {"ll": log_likelihood(cfg, s)}


# ---------------------------------------------------------------------------
# Synthetic corpus, state and drivers
# ---------------------------------------------------------------------------

def _ranges(arrays) -> list:
    """(min, max) of each array (``None`` for an empty one): numpy ones
    on the host, tensors with one read for all of them."""
    out = [None] * len(arrays)
    tens = []
    for i, a in enumerate(arrays):
        if torch.is_tensor(a):
            if a.numel():
                tens.append(i)
        else:
            a = np.asarray(a)
            if a.size:
                out[i] = (int(a.min()), int(a.max()))
    if tens:
        dev = arrays[tens[0]].device
        vals = torch.cat([torch.stack([arrays[i].min(), arrays[i].max()])
                          .long().to(dev) for i in tens]).tolist()
        for j, i in enumerate(tens):
            out[i] = (vals[2 * j], vals[2 * j + 1])
    return out


def synthetic_corpus(rng: np.random.Generator, cfg: LDAConfig,
                     true_topics: int = 10, concentration: float = 0.05):
    """Draw a corpus from a planted LDA model (the JAX package's recipe
    and numpy draws).  Returns (words, docs, z_init) flat int32 arrays
    laid out as num_workers contiguous shards."""
    U, Tp, dpw = cfg.num_workers, cfg.tokens_per_worker, cfg.docs_per_worker
    V, K = cfg.vocab, cfg.num_topics
    topics = rng.dirichlet([concentration] * V, size=true_topics)
    words = np.full((U * Tp,), -1, np.int32)
    docs = np.zeros((U * Tp,), np.int32)
    for u in range(U):
        for i in range(Tp):
            d = rng.integers(dpw)
            theta = rng.dirichlet([0.3] * true_topics)
            k = rng.choice(true_topics, p=theta)
            v = rng.choice(V, p=topics[k])
            words[u * Tp + i] = v
            docs[u * Tp + i] = d
    z0 = rng.integers(0, K, size=(U * Tp,)).astype(np.int32)
    return words, docs, z0


def _dirichlet(gen, conc: float, shape, device) -> torch.Tensor:
    """Rows of Dirichlet(conc) in float64: normalised Gamma(conc) draws."""
    g = torch._standard_gamma(torch.full(shape, conc, dtype=torch.float64,
                                         device=device), generator=gen)
    return g / g.sum(-1, keepdim=True)


def synthetic_corpus_device(seed: int, cfg: LDAConfig,
                            true_topics: int = 10,
                            concentration: float = 0.05, device="cuda",
                            chunk: int = 1 << 22):
    """:func:`synthetic_corpus`'s recipe built on the device from a
    ``torch.Generator`` seeded with ``seed`` (its draws differ), for
    corpus sizes where a Python loop is too slow: ``true_topics`` topics
    ~ Dirichlet(concentration) over the vocabulary; per token a document
    uniform over the worker's, θ ~ Dirichlet(0.3), a topic ~ θ and a word
    ~ that topic (by inverse CDF, in float64); z0 uniform.  Tokens are
    drawn in chunks.  Returns flat int32 device tensors (words, docs,
    z0) of U·T_p."""
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    n = cfg.num_workers * cfg.tokens_per_worker
    V, T = cfg.vocab, true_topics
    topics = _dirichlet(gen, concentration, (T, V), device)
    # one increasing table: topic k's CDF shifted by k, so a single
    # searchsorted of k + u finds the word
    cdf = topics.cumsum(-1)
    cdf /= cdf[:, -1:].clone()
    table = (cdf + torch.arange(T, device=device,
                                dtype=torch.float64)[:, None]).reshape(-1)
    words = torch.empty((n,), dtype=torch.int32, device=device)
    for i in range(0, n, chunk):
        m = min(chunk, n - i)
        theta = _dirichlet(gen, 0.3, (m, T), device)
        k = torch.multinomial(theta.float(), 1, generator=gen)[:, 0]
        u = torch.rand((m,), generator=gen, device=device,
                       dtype=torch.float64)
        pos = torch.searchsorted(table, k + u)
        words[i:i + m] = (pos - k * V).clamp_(0, V - 1)
    docs = torch.randint(cfg.docs_per_worker, (n,), generator=gen,
                         device=device, dtype=torch.int32)
    z0 = torch.randint(cfg.num_topics, (n,), generator=gen, device=device,
                       dtype=torch.int32)
    return words, docs, z0


def build_state(cfg: LDAConfig, words, docs, z0, device="cuda") -> dict:
    """Materialise consistent D, B and s from the initial assignments, by
    one accumulating scatter each, on ``device`` (the card unless the
    caller asks for the CPU).  Flat layout: z (U·T_p,) int32 (a copy of
    z0), D (U·dpw, K), B (V_p, K), s (K,), s_err 0."""
    Tp, dpw = cfg.tokens_per_worker, cfg.docs_per_worker
    Vp, K = cfg.padded_vocab, cfg.num_topics
    device = resolve_device(device)
    w = torch.as_tensor(words, device=device).reshape(-1).long()
    d = torch.as_tensor(docs, device=device).reshape(-1).long()
    z = torch.tensor(z0, device=device).reshape(-1) \
        if not torch.is_tensor(z0) else z0.to(device).reshape(-1).clone()
    z = z.to(torch.int32)
    on = w >= 0
    u = torch.arange(w.numel(), device=device) // Tp
    k = z.long()[on]
    one = torch.ones(k.shape, device=device)
    D = torch.zeros((cfg.num_workers * dpw, K), device=device)
    D.index_put_(((u * dpw + d)[on], k), one, accumulate=True)
    B = torch.zeros((Vp, K), device=device)
    B.index_put_((w[on], k), one, accumulate=True)
    return {"z": z, "D": D, "B": B, "s": B.sum(0),
            "s_err": torch.zeros((), device=device)}


def log_likelihood(cfg: LDAConfig, state) -> torch.Tensor:
    """The collapsed log P(W, Z) up to constants, a float64 device scalar
    (each row's lgamma sum in f32, the rows summed in float64)."""
    K = cfg.num_topics
    B = state["B"].reshape(-1, K)
    D = state["D"].reshape(-1, K)

    def total(x):
        return x.sum(-1).double().sum()

    lb = total(torch.lgamma(B + cfg.gamma))
    ld = total(torch.lgamma(D + cfg.alpha)) \
        - torch.lgamma(D.sum(-1) + K * cfg.alpha).double().sum()
    return lb + ld - torch.lgamma(state["s"] + cfg.padded_vocab
                                  * cfg.gamma).double().sum()


def make_engine(cfg: LDAConfig, device="cuda", baseline: bool = False,
                noise: Optional[Callable] = None,
                kernels: Optional[KernelSpec] = None) -> StradsEngine:
    """An engine of ``cfg.num_workers`` workers for the STRADS sampler or
    the data-parallel ``baseline``."""
    app = (DataParallelLDAApp if baseline else StradsLDA)(cfg, noise)
    return StradsEngine(app, app.data_specs(), app.state_specs(),
                        workers=cfg.num_workers, device=device,
                        kernels=kernels)


def fit(cfg: LDAConfig, words, docs, z0, num_rounds: Optional[int] = None,
        baseline: bool = False, trace_every: Optional[int] = None,
        plan=None, *, device="cuda", noise: Optional[Callable] = None):
    """Run STRADS LDA (or the ``baseline``); returns (flat state, trace of
    (t, log-likelihood), trace of (t, s-error)).  ``plan`` as in
    :func:`repro_torch.apps.lasso.fit`; ``noise(phase)`` replaces the
    kernel's Philox draws with per-slot Gumbel draws (U, T_p, K)."""
    plan = _exec.resolve_plan(plan, num_rounds=num_rounds,
                              trace_every=trace_every)
    eng = make_engine(cfg, device=device, baseline=baseline, noise=noise)
    data = eng.shard_data({"words": words, "docs": docs})
    state = eng.init_state(words=words, docs=docs, z0=z0)
    every = plan.collect_every
    collect = eng.app.loglik_collect()

    if plan.executor != "loop":
        rep = eng.execute(state, data, None, plan,
                          collect=collect if every else None)
        if not every:
            return eng.unshard(rep.state), [], []
        ys = {k: v.cpu().numpy() for k, v in rep.trace.items()}
        s_errs = (_exec.decimate(ys["s_err"], plan.rounds, every)
                  if "s_err" in ys else [])
        return (eng.unshard(rep.state),
                _exec.decimate(ys["ll"], plan.rounds, every), s_errs)

    trace, s_errs = [], []

    def cb(t, s, out):
        if every and (t % every == 0 or t == plan.rounds - 1):
            y = collect(s)
            trace.append((t, float(y["ll"])))
            if "s_err" in y:
                s_errs.append((t, float(y["s_err"])))
        return False

    rep = eng.execute(state, data, None, plan, callback=cb)
    return eng.unshard(rep.state), trace, s_errs
