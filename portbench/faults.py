"""Faults planted under a run's timed path, which the check has to catch.

Each takes an object with ``setattr(owner, name, value)`` (pytest's
``monkeypatch``, or :class:`Patch`) and the configuration's kind, and
breaks the program's path: a round that returns its state unchanged;
half of the workers' batch left out, the mean taken over the rest; the
sum over workers, the one card's stand-in for the exchange between
chips, left out; a token (LDA), an entry (MF) or an answer altered where
it is produced; the rounds off the rotation's first phase (LDA) or rank
(MF) leaving the state unchanged; every round run at that phase or rank.
``portbench/control.py --fault <name>`` reads a fault on the card; the
tests plant each at small shapes.  Not part of a benchmark run.
"""
import torch
from repro_torch.apps import lda as plda
from repro_torch.apps import mf as pmf
from repro_torch.core import engine as peng


class Patch:
    """``setattr`` that :meth:`undo` takes back."""

    def __init__(self):
        self._saved = []

    def setattr(self, owner, name, value):
        self._saved.append((owner, name, getattr(owner, name)))
        setattr(owner, name, value)

    def undo(self):
        while self._saved:
            owner, name, value = self._saved.pop()
            setattr(owner, name, value)


def _unchanged(mp, kind):
    if kind == "lda":
        mp.setattr(plda._GibbsApp, "_sweep",
                   lambda self, data, z, B, D, s, *a, **k:
                   s.expand(z.shape[0], -1).clone())
    else:
        mp.setattr(pmf.StradsMF, "pull",
                   lambda self, state, sched, z, local, data, phase: state)


def _half(mp, kind):
    if kind == "lda":
        real = plda._GibbsApp._sweep

        def sweep(self, data, z, *a, **k):
            keep = z[z.shape[0] // 2:].clone()
            out = real(self, data, z, *a, **k)
            z[z.shape[0] // 2:] = keep       # half the workers' draws lost
            return out
        mp.setattr(plda._GibbsApp, "_sweep", sweep)
    else:
        real = pmf.StradsMF.push

        def push(self, data, state, sched, phase):
            part, local = real(self, data, state, sched, phase)
            if part is not None:
                h = next(iter(part.values())).shape[0] // 2
                part = {k: torch.cat([2 * v[:h], 0 * v[h:]])
                        for k, v in part.items()}
            return part, local
        mp.setattr(pmf.StradsMF, "push", push)


def _no_exchange(mp, kind):
    mp.setattr(peng, "tree_psum",
               lambda tree: None if tree is None else
               {k: v[0] for k, v in tree.items()})


def _altered(mp, kind):
    if kind == "lda":
        real = plda._GibbsApp._sweep

        def sweep(self, data, z, *a, **k):
            out = real(self, data, z, *a, **k)
            z[0, 0] = (z[0, 0] + 1) % self.cfg.num_topics
            return out
        mp.setattr(plda._GibbsApp, "_sweep", sweep)
    else:
        real = pmf.StradsMF.pull

        def pull(self, state, sched, z, local, data, phase):
            out = real(self, state, sched, z, local, data, phase)
            k = int(sched["ranks"][0])
            out["H"] = out["H"].clone()
            out["H"][k, 0] += 1e-3 * out["H"][k].abs().max()
            return out
        mp.setattr(pmf.StradsMF, "pull", pull)


def _altered_answer(mp, kind):
    app = plda.StradsLDA if kind == "lda" else pmf.StradsMF
    real = app.query

    def query(self, state, batch):
        out = dict(real(self, state, batch))
        key = "theta" if kind == "lda" else "scores"
        out[key] = out[key] + 1e-3 * out[key].abs().max()
        return out
    mp.setattr(app, "query", query)


def _skip_phases(mp, kind):
    if kind == "lda":
        real = plda._GibbsApp._sweep

        def sweep(self, data, z, B, D, s, phase, *a, **k):
            if phase:
                return s.expand(z.shape[0], -1).clone()
            return real(self, data, z, B, D, s, phase, *a, **k)
        mp.setattr(plda._GibbsApp, "_sweep", sweep)
    else:
        real = pmf.StradsMF.pull

        def pull(self, state, sched, z, local, data, phase):
            if int(sched["ranks"][0]):
                return state
            return real(self, state, sched, z, local, data, phase)
        mp.setattr(pmf.StradsMF, "pull", pull)


def _phase_fixed(mp, kind):
    if kind == "lda":
        real = plda._GibbsApp._sweep

        def sweep(self, data, z, B, D, s, phase, *a, **k):
            return real(self, data, z, B, D, s, 0, *a, **k)
        mp.setattr(plda._GibbsApp, "_sweep", sweep)
    else:
        real = pmf.StradsMF.propose

        def propose(self, *a, **k):
            out = real(self, *a, **k)
            return {"ranks": torch.zeros_like(out["ranks"])}
        mp.setattr(pmf.StradsMF, "propose", propose)


FAULTS = {"unchanged": _unchanged, "half_batch": _half,
          "no_exchange": _no_exchange, "altered": _altered,
          "altered_answer": _altered_answer, "skip_phases": _skip_phases,
          "phase_fixed": _phase_fixed}
