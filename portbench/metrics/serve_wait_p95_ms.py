"""``serve_wait_p95_ms`` (ms): the 95th percentile of the queue waits of
every request the window served, from ``submit`` to its batch's start
on the frontend's clock (the ``waits_us`` of the program's
``serve_batch`` spans on ``StradsEngine.recorder``).  The benchmark
submits a query at the first boundary after it is due, so this is the
wait behind earlier batches, not the wait for a boundary."""
import numpy as np


def read(ctx):
    rec = getattr(ctx.cell.engine, "recorder", None)
    if rec is None:
        return None
    waits = [w for ev in rec.to_json_events() if ev["name"] == "serve_batch"
             for w in ev.get("waits_us", ())]
    if not waits:
        return None
    return float(np.percentile(waits, 95)) / 1e3
