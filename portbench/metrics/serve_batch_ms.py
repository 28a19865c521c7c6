"""``serve_batch_ms`` (ms): the mean length of the program's own
``serve_batch`` Recorder spans in the window (``ServeFrontend.flush``;
each ends after a device sync), one a served batch."""


def read(ctx):
    spans = ctx.spans.get("serve_batch")
    if not spans:
        return None
    return 1e3 * sum(spans) / len(spans)
