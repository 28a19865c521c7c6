"""MF cells: ``repro_torch.apps.mf.StradsMF`` on the ``scan`` executor.

Inputs: low-rank ratings plus noise under a random observation mask at
the configuration's density, drawn on the device from the seed by
:func:`synthetic_ratings` (a frozen copy of ``synthetic_ratings_device``
in ``src/repro_torch/apps/mf.py`` at commit 8dacd7b), and the initial
factors from a generator seeded with the seed; for a serving cell, the
users asking, by popularity rank over a seed-drawn order of the users.

The check replays the window's closing cycle (an H-phase and a W-phase
of one rank, the rank drawn from the seed: the closing chunk first runs
that many cycles past the last step).  The window snapshots W and H
before it; the plain
reference (:mod:`portbench.reference.mf`) takes the residual as
(A − W H)·mask from the inputs and that snapshot, in float64, and makes
the cycle's new row of H and column of W.  Compared: the program's
residual after the window against (A − W H)·mask of its own factors (the
state every round carried), the cycle's new row and column, and that
every rank's row of H and column of W that a round of the window updated
moved.  A served
answer is checked against float64 scores from the user's row of W and
the H of the view that served it.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from .. import roofline
from ..loop import lead_rounds
from ..reference import mf as ref


# -- inputs: frozen copy of apps/mf.py::synthetic_ratings_device --------------

def synthetic_ratings(seed: int, N: int, M: int, true_rank: int,
                      density: float, noise: float, device,
                      chunk: int = 8192):
    """(A·mask, mask), each (N, M) f32 on ``device``: A = W_t H_t / √r +
    noise, the mask Bernoulli(density); drawn in chunks of rows."""
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


# -- the cell -------------------------------------------------------------------

@dataclasses.dataclass
class Answer:
    w: torch.Tensor              # the user's row of W in the view
    H: torch.Tensor              # the view's H
    items: torch.Tensor          # what the program served
    scores: torch.Tensor


class Cell:
    """One MF configuration on the program: inputs, engine, state."""

    def __init__(self, cfg: dict, seed: int, device):
        from repro_torch.apps import mf
        from repro_torch.core import ExecutionPlan
        self.torch = torch
        self.cfg = cfg
        self.seed = seed
        self.device = torch.device(device)
        self.mcfg = mf.MFConfig(num_rows=cfg["users"], num_cols=cfg["movies"],
                                rank=cfg["rank"], lam=cfg["lam"],
                                ranks_per_round=cfg["ranks_per_round"],
                                top_k=cfg["top_k"])
        a = cfg["assumed"]
        density = cfg["source_ratings"] / (cfg["source_users"]
                                           * cfg["movies"])
        self.A, self.mask = synthetic_ratings(
            seed, cfg["users"], cfg["movies"], a["planted_rank"], density,
            a["noise"], self.device)
        self.observed = int(torch.count_nonzero(self.mask))
        self.engine = mf.make_engine(self.mcfg, workers=cfg["num_workers"],
                                     device=self.device)
        self.data = self.engine.shard_data({"A": self.A, "mask": self.mask})
        gen = torch.Generator(device=self.device).manual_seed(seed + 1)
        self.state = self.engine.init_state(A=self.A, mask=self.mask,
                                            generator=gen)
        self.plan = ExecutionPlan(executor=cfg["executor"], rounds=1)
        self.carry = None
        self.t = 0
        self.step_rounds = self.engine._step_length(self.plan)
        self.sweep_rounds = 2 * cfg["rank"]
        self.close_rounds = cfg["close_rounds"]
        self.close_lead = 2 * lead_rounds(seed, cfg["rank"])
        self._start = None
        self.users = torch.randperm(
            cfg["users"], device=self.device,
            generator=torch.Generator(device=self.device).manual_seed(
                seed + 2))

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
        K = self.mcfg.rank
        return {"W": self.state["W"].reshape(-1, K).clone(),
                "H": self.state["H"].clone(), "t": self.t}

    def mark_start(self) -> None:
        """Keep W and H as the window starts, for :meth:`unmoved_share`."""
        snap = self.snapshot()
        self._start = (snap["t"], snap["W"], snap["H"])

    # -- work -----------------------------------------------------------------

    def round_work(self, t: int) -> roofline.Work:
        return roofline.mf_round(self.observed, self.mcfg.num_rows,
                                 self.mcfg.num_cols)

    # -- serving ----------------------------------------------------------------

    def make_queries(self, query: dict, ranks, seed: int):
        """One ``recommend`` payload a query: the user at each popularity
        rank (the seed orders the users)."""
        idx = self.users[torch.as_tensor(ranks, device=self.device)]
        return [{"user": idx[i]} for i in range(len(ranks))]

    def record(self, view_state, payload, result) -> Answer:
        K = self.mcfg.rank
        u = int(payload["user"])
        return Answer(w=view_state["W"].reshape(-1, K)[u].clone(),
                      H=view_state["H"].clone(),
                      items=result["items"].clone(),
                      scores=result["scores"].clone())

    # -- the check ----------------------------------------------------------------

    def unmoved_share(self, snap) -> float:
        """Of the (rank, phase) pairs that a round of the window before
        the snapshot updated, the share whose row of H (H-phase) or
        column of W (W-phase) is what it was at the window's start."""
        t0, W0, H0 = self._start
        K = self.mcfg.rank
        W, H = snap["W"], snap["H"]
        due = {((t // 2) % K, t % 2) for t in range(t0, snap["t"])}
        n = sum(torch.equal(H[k], H0[k]) if phase == 0 else
                torch.equal(W[:, k], W0[:, k]) for k, phase in due)
        return n / max(len(due), 1)

    def training_numbers(self, snap, outputs=None) -> dict:
        """The program's residual after the window against (A − W H)·mask
        of its factors (relative to the largest |rating|), its closing
        cycle's new row of H and column of W against the reference's
        (relative to their largest entry), and the share of the window's
        updates that left their rank unmoved."""
        c = self.mcfg
        K, N = c.rank, c.num_rows
        if outputs is None:
            st = self.state
            outputs = (st["W"].reshape(N, K), st["H"],
                       st["R"].reshape(N, -1))
        W, H, R = outputs
        scale = float(self.A.abs().max())
        residual = ref.residual_gap(self.A, self.mask, W, H, R) / scale
        k = (snap["t"] // 2) % K
        h_new, w_new = ref.cycle(self.A, self.mask, snap["W"], snap["H"], k,
                                 c.lam)
        gap_h = float((H[k].double() - h_new).abs().max()
                      / h_new.abs().max())
        gap_w = float((W[:, k].double() - w_new).abs().max()
                      / w_new.abs().max())
        return {"residual_gap": residual, "factor_gap": max(gap_h, gap_w),
                "unmoved_share": self.unmoved_share(snap)}

    def control_outputs(self, snap):
        """The reference in TF32 in the program's place for the closing
        cycle: W, H with the cycle's rank replaced, and their residual."""
        K = self.mcfg.rank
        k = (snap["t"] // 2) % K
        h, w = ref.cycle(self.A, self.mask, snap["W"], snap["H"], k,
                         self.mcfg.lam, tf32=True)
        W, H = snap["W"].clone(), snap["H"].clone()
        W[:, k], H[k] = w, h
        return W, H, ref.residual(self.A, self.mask, W, H, tf32=True)

    def control_answers(self, answers):
        """The answers the reference in TF32 gives in the program's place."""
        out = []
        for a in answers:
            sc = ref.scores(a.w, a.H, tf32=True)
            top, items = torch.sort(sc, descending=True, stable=True)
            k = a.items.numel()
            out.append(dataclasses.replace(a, items=items[:k],
                                           scores=top[:k]))
        return out

    def query_numbers(self, answers) -> dict:
        """Over the recorded answers, relative to each user's largest
        |score|: the widest gap of a served score from the float64 score
        of its item, or by which the r-th served item's float64 score lies
        below the r-th best, whichever is wider."""
        gap = 0.0
        for a in answers:
            want = ref.scores(a.w, a.H)
            got = want[a.items.long()]
            best = torch.topk(want, a.items.numel()).values
            gap = max(gap, max(float((a.scores.double() - got).abs().max()),
                               float((best - got).max()))
                      / float(want.abs().max()))
        return {"answer_gap": gap}

    def free_program(self) -> None:
        """Nothing of the program beyond its state is held."""
