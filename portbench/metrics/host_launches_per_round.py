"""``host_launches_per_round`` (launches): the CUDA runtime and driver
launch calls the host made in the traced window (kernel launches and
graph launches, from the trace's host records), over the rounds the
window committed."""


def read(ctx):
    t = ctx.trace
    if t is None or not ctx.window.rounds or not t.launches:
        return None
    return t.launches / ctx.window.rounds
