"""The control comes out not correct: the plain reference put in the
program's place one precision below the configuration's float32
(bfloat16 logits for LDA, TF32 products for MF) fails a compared number
by its limit, at a size the CPU holds.  On the card the same control
runs at the cells' own sizes (``portbench/control.py``)."""
import pytest

from conftest import small_config, small_run
from portbench.control import readings


def _failed(numbers: dict, limits: dict) -> dict:
    return {k: v for k, v in numbers.items() if k in limits and v > limits[k]}


@pytest.mark.parametrize("seed", [11, 2**31 + 7, 2**33 + 1])
@pytest.mark.parametrize("workload", ["lda-nytimes.sweep", "mf-netflix.sweep",
                                      "lda-nytimes.serve",
                                      "mf-netflix.serve"])
def test_control_fails_and_the_program_passes(workload, seed):
    kind = workload.split(".")[0]
    name = "lda-nytimes-k1000" if kind == "lda-nytimes" else "mf-netflix-k40"
    # enough tokens and topics a round that bfloat16 logits reorder some
    over = dict(num_topics=64, tokens_per_worker=8192) \
        if kind == "lda-nytimes" else {}
    cfg = small_config(name, **over)
    run = small_run(workload, seed=seed, seconds=0.4, config=cfg)
    run.measure()
    got = readings(run)
    assert _failed(got["program"], cfg["limits"]) == {}
    bad = _failed(got["control"], cfg["limits"])
    assert bad, got
