"""A run whose timed path is broken underneath comes out not correct.

Each test drives the rest of a run (the look for a card skipped, small
shapes on the CPU) with one fault of :mod:`portbench.faults` planted in
the program's path."""
import pytest

from conftest import small_run
from portbench.faults import FAULTS

# mf-netflix.serve is held out of BENCHMARK.json; its code stays tested
CELLS = ["lda-nytimes.sweep", "mf-netflix.sweep", "lda-nytimes.serve",
         "mf-netflix.serve"]


def _run(workload):
    run = small_run(workload, seconds=0.4)
    run.measure()
    return run.report(0.0)["result"]


@pytest.mark.parametrize("workload", CELLS)
def test_sound_run_is_correct(workload):
    assert _run(workload)["correct"] is True


#: every fault a cell can have (a training cell serves no answer)
CASES = [(w, f) for w in CELLS for f in sorted(FAULTS)
         if f != "altered_answer" or w.endswith(".serve")]


@pytest.mark.parametrize("workload,fault", CASES)
def test_fault_is_caught(workload, fault, monkeypatch):
    # the run's set-up (the corpus, the first rounds) stays sound: the
    # fault is planted under the measured window
    run = small_run(workload, seconds=0.4)
    FAULTS[fault](monkeypatch, workload.split("-")[0])
    run.measure()
    monkeypatch.undo()
    res = run.report(0.0)["result"]
    assert res["correct"] is False, res["check"]
    print(workload, fault, {k: v["value"] for k, v in res["check"].items()
                            if v["value"] != 0})


#: seeds whose closing round falls at the rotation's first phase (LDA)
#: or rank (MF) at the small shapes' period of 4
FIRST_PHASE_SEEDS = [2**33 + 1, 2**31 + 3]


@pytest.mark.parametrize("seed", FIRST_PHASE_SEEDS)
@pytest.mark.parametrize("fault", ["skip_phases", "phase_fixed"])
@pytest.mark.parametrize("workload", ["lda-nytimes.sweep", "mf-netflix.sweep"])
def test_rotation_fault_is_caught_at_the_first_phase(workload, fault, seed,
                                                     monkeypatch):
    # the replayed round is one the fault leaves sound: the window's
    # unmoved share catches it
    run = small_run(workload, seed=seed, seconds=0.4)
    assert run.cell.close_lead == 0
    FAULTS[fault](monkeypatch, workload.split("-")[0])
    run.measure()
    monkeypatch.undo()
    res = run.report(0.0)["result"]
    assert res["correct"] is False, res["check"]
    check = res["check"]["unmoved_share"]
    assert check["value"] > check["limit"], res["check"]


def test_closing_round_phase_follows_the_seed():
    phases = set()
    for seed in range(2**31, 2**31 + 12):
        run = small_run("lda-nytimes.sweep", seed=seed, seconds=0.1)
        run.measure()
        U = run.cell.lcfg.num_workers
        assert run.win.snapshot["t"] % U == run.cell.close_lead
        phases.add(run.cell.close_lead)
    assert phases == set(range(U))
