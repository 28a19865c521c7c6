"""``round_schedule_ms`` (ms): the device's time in the scheduler's phase
of a round (noise, ``propose``, ``schedule_stats`` and their sum over
the workers, ``schedule``), from the program's ``schedule`` timer
(``StradsEngine.recorder``: in a traced run the Recorder the serving
frontend attached, else the one the engine attaches itself inside the
profiler session): the seconds between the CUDA events at each
interval's open and close, over its count.  Nothing to read off the
card, or unless the ``round`` timer counted exactly the window's rounds."""


def read(ctx):
    rec = getattr(ctx.cell.engine, "recorder", None)
    timers = rec.timers() if rec is not None else {}
    t, r = timers.get("schedule"), timers.get("round")
    if not t or not r or r["count"] != ctx.window.rounds \
            or t["device_s"] is None:
        return None
    return 1e3 * t["device_s"] / t["count"]
