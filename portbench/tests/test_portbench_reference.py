"""The plain reference agrees with the program's CPU path at a small LDA
and MF: the Gibbs round to the bit, the MF cycle and both queries within
float32 rounding."""
import dataclasses

import pytest
import torch

from conftest import small_config
from portbench.apps import lda as lda_cell
from portbench.apps import mf as mf_cell
from portbench.reference import lda as rlda
from portbench.reference import mf as rmf


@pytest.mark.parametrize("seed", [5, 2**31 + 3])
def test_lda_round_equals_the_program_to_the_bit(seed):
    cell = lda_cell.Cell(small_config("lda-nytimes-k1000", num_topics=16,
                                      tokens_per_worker=128), seed, "cpu")
    c = cell.lcfg
    cell.mark_start()
    for _ in range(3):                   # rounds at phases 0, 1, 2
        snap = cell.snapshot()
        cell.run(1, "loop")
        # the reference round in float32 draws the program's topics
        z = snap["z"].reshape(c.num_workers, -1).clone()
        B, D, s = cell._counts(z)
        s = rlda.gibbs_round(cell.words, cell.docs, z, B, D, s,
                             **cell._round_args(snap))
        st = cell.state
        assert torch.equal(z, st["z"].reshape(z.shape))
        assert torch.equal(B, st["B"].reshape(B.shape))
        assert torch.equal(D, st["D"].reshape(D.shape))
        assert torch.equal(s, st["s"])
        # and teacher-forced, every pick is the draw's best
        nums = cell.training_numbers(snap)
        assert nums["score_gap"] == 0.0
        assert nums["count_mismatch"] == nums["off_block_changes"] == 0
    # and the rounds moved tokens: the comparison is not of a still state
    assert int((cell.state["z"].reshape(-1) != snap["z"].reshape(-1)).sum())
    assert nums["unmoved_share"] == 0.0


def test_lda_forced_gap_reads_a_wrong_pick():
    cell = lda_cell.Cell(small_config("lda-nytimes-k1000", num_topics=16,
                                      tokens_per_worker=128), 7, "cpu")
    cell.mark_start()
    snap = cell.snapshot()
    cell.run(1)
    z = cell.state["z"].clone().reshape(cell.lcfg.num_workers, -1)
    B, D, s = (cell.state[k].clone() for k in ("B", "D", "s"))
    assert cell.training_numbers(snap, (z, B, D, s))["score_gap"] == 0.0
    # one sampled token moved to another topic: its gap shows, and the
    # counts no longer count z
    act = z.reshape(-1) != snap["z"].reshape(-1)
    i = int(act.nonzero()[0])
    z.view(-1)[i] = (z.view(-1)[i] + 1) % cell.lcfg.num_topics
    nums = cell.training_numbers(snap, (z, B, D, s))
    assert nums["score_gap"] > 1e-3
    assert nums["count_mismatch"] > 0


def test_lda_fold_in_matches_infer_topics():
    cell = lda_cell.Cell(small_config("lda-nytimes-k1000"), 9, "cpu")
    cell.warm()
    q = cell.make_queries({"length": {"max": 32}}, [5, 17, 32], 9)
    batch = {"words": torch.stack([p["words"] for p in q])}
    out = cell.engine.app.query(cell.state, batch)
    c = cell.lcfg
    B = cell.state["B"].reshape(-1, c.num_topics)
    for i, p in enumerate(q):
        w = p["words"][p["words"] >= 0].long()
        want = rlda.fold_in(w, B[w], cell.state["s"],
                            padded_vocab=c.padded_vocab, alpha=c.alpha,
                            gamma=c.gamma, iters=cell.engine.app.query_iters)
        assert float((out["theta"][i].double() - want).abs().max()) < 1e-6


@pytest.mark.parametrize("seed", [4, 2**32 + 1])
def test_mf_cycle_matches_the_program(seed):
    cell = mf_cell.Cell(small_config("mf-netflix-k40"), seed, "cpu")
    cell.warm()
    cell.mark_start()
    for _ in range(3):
        snap = cell.snapshot()
        cell.run(2)
        nums = cell.training_numbers(snap)
        assert nums["residual_gap"] < 1e-6
        assert nums["factor_gap"] < 1e-5
    assert nums["unmoved_share"] == 0.0


def test_mf_scores_match_recommend():
    cell = mf_cell.Cell(small_config("mf-netflix-k40"), 3, "cpu")
    cell.warm()
    users = torch.tensor([0, 7, 63])
    out = cell.engine.app.query(cell.state, {"user": users})
    W = cell.state["W"].reshape(-1, cell.mcfg.rank)
    for i, u in enumerate(users):
        want = rmf.scores(W[u], cell.state["H"])
        assert torch.equal(torch.topk(want, 8).indices, out["items"][i])


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2**-10, 1.0 + 2**-11, 1.0 + 3 * 2**-11,
                      -3.0 - 2**-12, 0.0])
    assert rmf.to_tf32(x).tolist() == [1.0, 1.0 + 2**-10, 1.0,
                                       1.0 + 2**-9, -3.0, 0.0]


def test_answer_records_copy():
    a = mf_cell.Answer(torch.zeros(2), torch.zeros(2, 3), torch.zeros(8),
                       torch.zeros(8))
    assert dataclasses.replace(a, scores=torch.ones(8)).w is a.w
