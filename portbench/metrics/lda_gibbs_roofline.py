"""``lda_gibbs_roofline`` (%): one ``lda_gibbs`` call's least time at the
card's published peaks (the same count as the LDA round's,
:func:`portbench.roofline.lda_round`), over its mean device time in the
traced window.  Nothing to read where no ``lda_gibbs`` kernel ran."""
from portbench import roofline


def read(ctx):
    if ctx.trace is None or not ctx.window.rounds:
        return None
    secs, calls = ctx.device_seconds("lda_gibbs")
    if not calls or secs <= 0:
        return None
    least = sum(roofline.least_seconds(ctx.cell.round_work(r))
                for r in ctx.rounds) / ctx.window.rounds
    return 100.0 * least / (secs / calls)
