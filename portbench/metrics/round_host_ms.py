"""``round_host_ms`` (ms): the host's time a round, from the program's
``round`` timer (``StradsEngine.recorder``: in a traced run the Recorder
the serving frontend attached, else the one the engine attaches itself
inside the profiler session): its host seconds over its count.  Where
the device sets the pace, the host runs ahead within a chunk until the
launch queue is full and then waits in its launches, so this reads the
host's own cost only where that cost is the larger.  Nothing to read
unless the timer counted exactly the window's rounds."""


def read(ctx):
    rec = getattr(ctx.cell.engine, "recorder", None)
    t = rec.timers().get("round") if rec is not None else None
    if not t or t["count"] != ctx.window.rounds:
        return None
    return 1e3 * t["host_s"] / t["count"]
