"""LDA cells: ``repro_torch.apps.lda.StradsLDA`` on the ``scan`` executor.

Inputs: a corpus drawn on the device from the seed by
:func:`synthetic_corpus` (a frozen copy of ``synthetic_corpus_device``
in ``src/repro_torch/apps/lda.py`` at commit 8dacd7b, changed to keep
its planted topics for the queries and to draw them from the
configuration's ``topic_seed``), and for a serving cell held-out
documents drawn from the same planted topics.

The check replays the window's closing round, whose phase is drawn
from the seed: the window's chunks end on a step (phase 0), so the
closing chunk first runs that many rounds more.  The window snapshots
the assignment z before the closing round; the plain reference
(:mod:`portbench.reference.lda`) counts B, D and s from the corpus and
that z and walks the round teacher-forced by the program's new z, with
the same Philox draws in float64: the widest gap of a chosen topic's
score below the best.  The program's B, D and s after the round must be
the counts of its own z (they were carried through every round of the
window, so a count lost or doubled on the way shows), tokens outside the
round's blocks must keep their topic, and every (worker, block) cell
with tokens that the window visited must have had some token change.
A served answer is checked against a float64 fold-in from the
word-topic rows and topic totals of the view that served it.
"""
from __future__ import annotations

import dataclasses

import torch

from .. import roofline
from ..loop import lead_rounds
from ..reference import lda as ref

#: the sampler's Philox seed (``StradsLDA.seed``, the JAX package's key 17)
PHILOX_SEED = 17


# -- inputs: frozen copy of apps/lda.py::synthetic_corpus_device ---------------

def _dirichlet(gen, conc: float, shape, device) -> torch.Tensor:
    g = torch._standard_gamma(torch.full(shape, conc, dtype=torch.float64,
                                         device=device), generator=gen)
    return g / g.sum(-1, keepdim=True)


def _topic_table(gen, V: int, T: int, concentration: float, device):
    """T planted topics ~ Dirichlet(concentration) over V words, as one
    increasing table: topic k's CDF shifted by k."""
    topics = _dirichlet(gen, concentration, (T, V), device)
    cdf = topics.cumsum(-1)
    cdf /= cdf[:, -1:].clone()
    return (cdf + torch.arange(T, device=device,
                               dtype=torch.float64)[:, None]).reshape(-1)


def _words(gen, table, k: torch.Tensor, V: int, device) -> torch.Tensor:
    u = torch.rand(k.shape, generator=gen, device=device,
                   dtype=torch.float64)
    pos = torch.searchsorted(table, k + u)
    return (pos - k * V).clamp_(0, V - 1).to(torch.int32)


def synthetic_corpus(seed: int, U: int, Tp: int, dpw: int, V: int, K: int,
                     true_topics: int, concentration: float,
                     theta_concentration: float, device, topic_seed: int,
                     chunk=1 << 22):
    """words, docs, z0 (U·T_p,) int32 on ``device`` and the planted topic
    table: per token a document uniform over its worker's, θ ~
    Dirichlet(0.3), a topic ~ θ, a word ~ that topic; z0 uniform.  The
    planted topics come from ``topic_seed``, the same for every run (the
    copied recipe draws them from the run's seed: the Gibbs sweep's cost
    then moved by ~5 % from seed to seed); the tokens from ``seed``."""
    gen = torch.Generator(device=device).manual_seed(topic_seed)
    n, T = U * Tp, true_topics
    table = _topic_table(gen, V, T, concentration, device)
    gen.manual_seed(seed)
    words = torch.empty((n,), dtype=torch.int32, device=device)
    for i in range(0, n, chunk):
        m = min(chunk, n - i)
        theta = _dirichlet(gen, theta_concentration, (m, T), device)
        k = torch.multinomial(theta.float(), 1, generator=gen)[:, 0]
        words[i:i + m] = _words(gen, table, k, V, device)
    docs = torch.randint(dpw, (n,), generator=gen, device=device,
                         dtype=torch.int32)
    z0 = torch.randint(K, (n,), generator=gen, device=device,
                       dtype=torch.int32)
    return words, docs, z0, table


# -- the cell -------------------------------------------------------------------

@dataclasses.dataclass
class Answer:
    words: torch.Tensor          # the document's words (−1 padding dropped)
    rows: torch.Tensor           # B rows of those words in the view
    s: torch.Tensor              # the view's topic totals
    theta: torch.Tensor          # what the program served
    top: int


class Cell:
    """One LDA configuration on the program: inputs, engine, state."""

    def __init__(self, cfg: dict, seed: int, device):
        from repro_torch.apps import lda
        from repro_torch.core import ExecutionPlan
        self.torch = torch
        self.cfg = cfg
        self.seed = seed
        self.device = torch.device(device)
        self.lcfg = lda.LDAConfig(
            vocab=cfg["vocab"], num_topics=cfg["num_topics"],
            num_workers=cfg["num_workers"],
            tokens_per_worker=cfg["tokens_per_worker"],
            docs_per_worker=cfg["docs_per_worker"], alpha=cfg["alpha"],
            gamma=cfg["gamma"])
        c = self.lcfg
        a = cfg["assumed"]
        words, docs, z0, self.table = synthetic_corpus(
            seed, c.num_workers, c.tokens_per_worker, c.docs_per_worker,
            c.vocab, c.num_topics, a["planted_topics"],
            a["topic_concentration"], a["theta_concentration"], self.device,
            a["topic_seed"])
        self.engine = lda.make_engine(c, device=self.device)
        self.data = self.engine.shard_data({"words": words, "docs": docs})
        self.words = self.data["words"]
        self.docs = self.data["docs"]
        self.state = self.engine.init_state(words=words, docs=docs, z0=z0)
        del z0
        self.plan = ExecutionPlan(executor=cfg["executor"], rounds=1)
        self.carry = None
        self.t = 0
        self.step_rounds = self.engine._step_length(self.plan)
        self.sweep_rounds = c.num_workers
        self.close_rounds = cfg["close_rounds"]
        self.close_lead = lead_rounds(seed, c.num_workers)
        self._stats = self._block_stats()
        self._start = None

    # -- driving ----------------------------------------------------------------

    def run(self, rounds: int, executor: str = None) -> None:
        """``rounds`` rounds through the program's entry, then a sync
        (``executor`` in place of the configuration's: ``"loop"``
        continues from a round that is not on a step)."""
        held, self.state = [self.state], None
        rep = self.engine.execute(
            held.pop(), self.data, None,
            dataclasses.replace(self.plan, rounds=self.t + rounds,
                                executor=executor or self.plan.executor),
            carry=self.carry)
        self.state, self.carry = rep.state, rep.carry
        self.t = int(rep.carry.t)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def warm(self) -> None:
        self.run(self.cfg["warm_rounds"])

    def snapshot(self):
        return {"z": self.state["z"].clone(), "t": self.t}

    def mark_start(self) -> None:
        """Keep z as the window starts, for :meth:`unmoved_share`."""
        self._start = (self.t, self.state["z"].clone())

    # -- work -----------------------------------------------------------------

    def _block_stats(self):
        """Per (worker, vocabulary block): active tokens, distinct words
        and distinct documents, (U, U) int64 on the host."""
        c = self.lcfg
        U, Vb, dpw = c.num_workers, c.block_vocab, c.docs_per_worker
        w = self.words.long()
        p = torch.arange(U, device=w.device)[:, None].expand_as(w)
        on = w >= 0
        w, p, d = w[on], p[on], self.docs.long()[on]
        cell = p * U + w // Vb
        tokens = torch.bincount(cell, minlength=U * U)
        uw = torch.unique(p * c.padded_vocab + w)   # (worker, word) pairs
        words = torch.bincount(uw // c.padded_vocab * U
                               + uw % c.padded_vocab // Vb, minlength=U * U)
        dk = torch.unique(cell * dpw + d) // dpw
        docs = torch.bincount(dk, minlength=U * U)
        # a count's log is a table read: log(γ + n) up to the most
        # frequent word's count, log(α + n) up to the longest document's
        freq = torch.bincount(w, minlength=c.padded_vocab).max()
        dlen = torch.bincount(p * dpw + d, minlength=U * dpw).max()
        self._table_entries = int(freq) + int(dlen) + 2
        return [x.reshape(U, U).cpu() for x in (tokens, words, docs)]

    def round_work(self, t: int) -> roofline.Work:
        """The least work of round ``t``: worker p samples block
        (p + t) mod U."""
        U = self.lcfg.num_workers
        p = torch.arange(U)
        b = (p + t % U) % U
        tok, wr, dr = (int(x[p, b].sum()) for x in self._stats)
        return roofline.lda_round(tok, wr, dr, self.lcfg.num_topics,
                                  self._table_entries)

    # -- serving ----------------------------------------------------------------

    def make_queries(self, query: dict, lengths, seed: int):
        """Held-out documents of the given lengths, each a θ ~ Dirichlet
        over the planted topics and its words drawn from them, padded
        with −1 to ``query["length"]["max"]``: (n, L) int32 rows."""
        a = self.cfg["assumed"]
        L = int(query["length"]["max"])
        n = len(lengths)
        dev = self.device
        gen = torch.Generator(device=dev).manual_seed(
            (int(seed) * 1_000_003 + 7) % (1 << 63))
        lens = torch.as_tensor(lengths, device=dev)
        theta = _dirichlet(gen, a["theta_concentration"],
                           (n, a["planted_topics"]), dev)
        k = torch.multinomial(theta.float(), L, replacement=True,
                              generator=gen)
        pos = torch.arange(L, device=dev)[None, :].expand(n, L)
        mask = pos < lens[:, None]
        words = torch.full((n, L), -1, dtype=torch.int32, device=dev)
        words[mask] = _words(gen, self.table, k[mask], self.lcfg.vocab, dev)
        return [{"words": words[i]} for i in range(n)]

    def record(self, view_state, payload, result) -> Answer:
        """What the check needs of a served answer: the B rows of its
        words and s, as the view that served it held them."""
        c = self.lcfg
        w = payload["words"]
        w = w[w >= 0].long()
        B = view_state["B"].reshape(-1, c.num_topics)
        return Answer(words=w.clone(), rows=B[w].clone(),
                      s=view_state["s"].clone(),
                      theta=result["theta"].clone(),
                      top=int(result["top_topic"]))

    # -- the check ----------------------------------------------------------------

    def _counts(self, z):
        c = self.lcfg
        return ref.counts(self.words, self.docs, z,
                          padded_vocab=c.padded_vocab,
                          docs_per_worker=c.docs_per_worker,
                          num_topics=c.num_topics)

    def _round_args(self, snap) -> dict:
        c = self.lcfg
        return dict(phase=snap["t"] % c.num_workers,
                    block_vocab=c.block_vocab,
                    docs_per_worker=c.docs_per_worker, alpha=c.alpha,
                    gamma=c.gamma, vg=c.padded_vocab * c.gamma,
                    seed=PHILOX_SEED)

    def unmoved_share(self, snap) -> float:
        """Of the (worker, block) cells that hold tokens and that a round
        of the window before the snapshot sampled, the share in which no
        token's topic changed."""
        c = self.lcfg
        U, Vb = c.num_workers, c.block_vocab
        t0, z0 = self._start
        p = torch.arange(U)
        seen = torch.zeros((U, U), dtype=torch.bool)
        for phase in {t % U for t in range(t0, snap["t"])}:
            seen[p, (p + phase) % U] = True
        w = self.words.long()
        moved = (snap["z"].reshape(w.shape) != z0.reshape(w.shape)) \
            & (w >= 0)
        pw = torch.arange(U, device=w.device)[:, None].expand_as(w)
        cell = (pw * U + w // Vb)[moved]
        n = torch.bincount(cell, minlength=U * U).reshape(U, U).cpu()
        due = (self._stats[0] > 0) & seen
        return float((due & (n == 0)).sum()) / max(int(due.sum()), 1)

    def training_numbers(self, snap, outputs=None) -> dict:
        """The closing round's outputs (the program's, or ``outputs``):
        the widest teacher-forced score gap of its picks; count entries
        (B, D, s) that are not the counts of its z; tokens outside the
        round's blocks whose topic changed; and the share of the window's
        cells left unmoved."""
        c = self.lcfg
        if outputs is None:
            st = self.state
            outputs = (st["z"], st["B"], st["D"], st["s"])
        pz, pB, pD, ps = outputs
        U, K = c.num_workers, c.num_topics
        z0 = snap["z"].reshape(U, -1)
        pz = pz.reshape(U, -1)
        args = self._round_args(snap)
        blk = (torch.arange(U, device=z0.device) + args["phase"]) % U
        act = (self.words >= 0) \
            & (self.words.long() // c.block_vocab == blk[:, None])
        off = int(((pz != z0) & ~act).sum())
        B, D, s = self._counts(pz)
        mismatch = int((pB.reshape(-1, K) != B).sum()
                       + (pD.reshape(-1, K) != D).sum() + (ps != s).sum())
        del B, D, s
        B, D, s = self._counts(z0)
        gap = ref.forced_gap(self.words, self.docs, z0, pz, B, D, s, **args)
        return {"score_gap": gap, "count_mismatch": mismatch,
                "off_block_changes": off,
                "unmoved_share": self.unmoved_share(snap)}

    def control_outputs(self, snap):
        """The reference in bfloat16 in the program's place for the
        closing round: its z, B, D and s after it."""
        z = snap["z"].reshape(self.lcfg.num_workers, -1).clone()
        B, D, s = self._counts(z)
        s = ref.gibbs_round(self.words, self.docs, z, B, D, s, low=True,
                            **self._round_args(snap))
        return z, B, D, s

    def control_answers(self, answers):
        """The answers the reference fold-in in bfloat16 gives in the
        program's place."""
        c = self.lcfg
        out = []
        for a in answers:
            th = ref.fold_in(a.words, a.rows, a.s,
                             padded_vocab=c.padded_vocab, alpha=c.alpha,
                             gamma=c.gamma,
                             iters=self.engine.app.query_iters,
                             dtype=torch.bfloat16)
            out.append(dataclasses.replace(a, theta=th,
                                           top=int(th.float().argmax())))
        return out

    def query_numbers(self, answers) -> dict:
        """Over the recorded answers: the widest gap of a served θ from
        the float64 fold-in, and the widest gap by which the served top
        topic's θ lies below the fold-in's best."""
        c = self.lcfg
        theta_gap = top_gap = 0.0
        for a in answers:
            want = ref.fold_in(a.words, a.rows, a.s,
                               padded_vocab=c.padded_vocab, alpha=c.alpha,
                               gamma=c.gamma,
                               iters=self.engine.app.query_iters)
            theta_gap = max(theta_gap,
                            float((a.theta.double() - want).abs().max()))
            top_gap = max(top_gap, float(want.max() - want[a.top]))
        return {"theta_gap": theta_gap, "top_topic_gap": top_gap}

    def free_program(self) -> None:
        """Drop the program's engine caches (the Gibbs index) before the
        reference runs; the state stays for the comparison."""
        self.engine.app._index_of = None
