"""``serve_publish_ms`` (ms): the mean device time of the program's
``serve_publish`` spans on ``StradsEngine.recorder`` (``ModelView.publish``
at each boundary of the window; the CUDA events at its open and close,
so the stale cache's refresh copies count)."""


def read(ctx):
    rec = getattr(ctx.cell.engine, "recorder", None)
    if rec is None:
        return None
    durs = [ev["device_dur"] for ev in rec.to_json_events()
            if ev["name"] == "serve_publish"
            and ev.get("device_dur") is not None]
    if not durs:
        return None
    return sum(durs) / len(durs) / 1e3
