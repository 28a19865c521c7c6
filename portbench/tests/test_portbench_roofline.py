"""The count functions against numbers worked by hand."""
import pytest

from portbench import roofline


def test_peaks():
    assert roofline.PEAK_SFU_PER_S == pytest.approx(16 * 132 * 1.98e9)
    assert roofline.PEAK_BYTES_PER_S == 3.35e12


def test_lda_round_by_hand():
    # 10 tokens over 3 word rows and 2 doc rows at K = 4: 40 token-topics,
    # 80 + 20 logs, 160 flops, 4 B x 4 x 5 rows + 16 B x 10 tokens = 240 B,
    # and a table of 6 logs of counts, 24 B
    w = roofline.lda_round(10, 3, 2, 4, 6)
    assert (w.sfu, w.flops, w.nbytes) == (100.0, 160.0, 264.0)
    # 264 B at 3.35 TB/s (79 ps) outlast 100 logs at 4.18e12/s (24 ps)
    assert roofline.bound_by(w) == "bytes"
    assert roofline.least_seconds(w) == pytest.approx(264 / 3.35e12)


def test_lda_round_at_the_nytimes_shape():
    # ~777k tokens a round at K = 1,000: 1.55e9 logs, ~0.37 ms at the SFU
    # rate; every word row and every document row of B and D read once,
    # 1.6 GB, take longer: ~0.49 ms at 3.35 TB/s
    w = roofline.lda_round(777_344, 102_660, 299_752, 1_000, 1_000_000)
    assert w.sfu / roofline.PEAK_SFU_PER_S == pytest.approx(3.72e-4,
                                                            rel=1e-2)
    assert roofline.bound_by(w) == "bytes"
    assert roofline.least_seconds(w) == pytest.approx(4.85e-4, rel=1e-2)


def test_mf_round_by_hand():
    # 1,000 observed ratings of a 50 x 30 matrix: 12 kB of residuals and
    # indices, 640 B of the rank's column and row
    w = roofline.mf_round(1_000, 50, 30)
    assert (w.flops, w.sfu, w.nbytes) == (6_000.0, 0.0, 12_640.0)
    assert roofline.bound_by(w) == "bytes"
    assert roofline.least_seconds(w) == pytest.approx(12_640 / 3.35e12)


def test_work_adds():
    a = roofline.Work(1, 2, 3) + roofline.Work(4, 5, 6)
    assert (a.flops, a.sfu, a.nbytes) == (5, 7, 9)
