"""The open-loop generator is a function of the seed alone, every seed
gets the same work in another order, and a query is timed from when it
was due."""
import time

import numpy as np
import pytest

from conftest import small_mix, small_run
from portbench import traffic


@pytest.mark.parametrize("name", ["infer-topics-open", "recommend-zipf-open"])
def test_schedule_is_a_function_of_the_seed(name):
    mix = traffic.load(name)
    a = traffic.arrival_offsets(mix, 2**33 + 5, 10.0)
    b = traffic.arrival_offsets(mix, 2**33 + 5, 10.0)
    c = traffic.arrival_offsets(mix, 7, 10.0)
    assert np.array_equal(a, b) and not np.array_equal(a, c)
    assert np.all(np.diff(a) > 0)
    # the same gaps in another order: the same total, the same multiset
    assert np.allclose(np.sort(np.diff(a, prepend=0.0)),
                       np.sort(np.diff(c, prepend=0.0)))
    rate = mix["arrivals"]["rate_per_s"]
    assert len(a) == int(np.ceil(rate * 10.0))
    assert a[-1] == pytest.approx(10.0, rel=0.05)
    sa = traffic.sizes(mix, 2**33 + 5, len(a), population=1000)
    sc = traffic.sizes(mix, 7, len(a), population=1000)
    assert np.array_equal(np.sort(sa), np.sort(sc))
    assert not np.array_equal(sa, sc)


def test_document_lengths():
    mix = traffic.load("infer-topics-open")
    n = 20_000
    s = traffic.sizes(mix, 1, n)
    ln = mix["query"]["length"]
    assert s.min() >= 1 and s.max() == ln["max"]
    assert s.mean() == pytest.approx(ln["mean"], rel=0.03)


def test_zipf_ranks_are_skewed():
    mix = traffic.load("recommend-zipf-open")
    r = traffic.sizes(mix, 1, 10_000, population=131_072)
    assert r.min() == 0 and r.max() < 131_072
    # s = 1.0 over 131,072 users: the top rank takes ~8 % of the queries
    assert np.mean(r == 0) == pytest.approx(1 / np.sum(
        1 / np.arange(1, 131_073)), rel=0.05)


def test_latency_runs_from_the_due_time():
    """Chunks that take 60 ms: a query due early in a chunk waits for its
    end, and its latency counts that wait."""
    run = small_run("mf-netflix.serve", seconds=0.6,
                    mix=small_mix("recommend-zipf-open",
                                  arrivals={"process": "poisson",
                                            "rate_per_s": 100.0}))
    cell = run.cell
    real = cell.run

    def slow(rounds, executor=None):
        time.sleep(0.06)
        real(rounds, executor)
    cell.run = slow
    win = run.measure()
    lat = win.latencies_ms
    assert win.due > 20 and not np.isnan(lat).any()
    # a due time falls uniformly in a 60 ms chunk: the median waits ~30
    assert np.median(lat) > 15.0
    assert lat.min() >= 0.0
