"""``round_mfu`` (%): the least time of the window's rounds at the card's
published peaks (:mod:`portbench.roofline`, the work each round has to
do by its configuration's count), over the traced window's length."""
from portbench import roofline


def read(ctx):
    t = ctx.trace
    if t is None or t.window_s <= 0 or not ctx.window.rounds:
        return None
    least = sum(roofline.least_seconds(ctx.cell.round_work(r))
                for r in ctx.rounds)
    return 100.0 * least / t.window_s
