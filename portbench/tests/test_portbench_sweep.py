"""The knee: the highest rate that answers 99 % before the close, has no
growing backlog, and keeps p95 within the latency limit."""
from portbench.sweep import backlog, knee


def _rec(rate, p95, answered=1.0, growing=False):
    return {"rate_per_s": rate, "p95_ms": p95, "growing": growing,
            "answered_before_close": answered}


def test_knee_takes_all_three_conditions():
    recs = [_rec(100, 70), _rec(200, 80), _rec(400, 100),
            _rec(800, 106), _rec(1600, 90, growing=True),
            _rec(3200, 90, answered=0.98)]
    # limit 1.5 x 70 = 105: 800 reads 106
    assert knee(recs) == 400
    assert knee([]) is None
    assert knee([_rec(100, 70, growing=True)]) is None


def test_backlog_thirds():
    assert backlog([1, 1, 1, 2, 2, 2, 4, 4, 4]) == (2.0, 4.0)
    assert backlog([5]) == (5.0, 5.0)
