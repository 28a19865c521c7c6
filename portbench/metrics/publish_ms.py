"""``publish_ms`` (ms): the mean length of the benchmark's own span
around ``ModelView.publish`` at each boundary of the window, closed by a
device sync so that a stale cache's refresh copies count."""


def read(ctx):
    spans = ctx.spans.get("publish")
    if not spans:
        return None
    return 1e3 * sum(spans) / len(spans)
