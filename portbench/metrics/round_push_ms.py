"""``round_push_ms`` (ms): the device's time in the push of a round
(``push`` and the sum of its partials over the workers), from the
program's ``push`` timer (``StradsEngine.recorder``: in a traced run the
Recorder the serving frontend attached, else the one the engine attaches
itself inside the profiler session): the seconds between the CUDA events
at each interval's open and close, over its count.  Nothing to read off
the card, or unless the ``round`` timer counted exactly the window's
rounds."""


def read(ctx):
    rec = getattr(ctx.cell.engine, "recorder", None)
    timers = rec.timers() if rec is not None else {}
    t, r = timers.get("push"), timers.get("round")
    if not t or not r or r["count"] != ctx.window.rounds \
            or t["device_s"] is None:
        return None
    return 1e3 * t["device_s"] / t["count"]
