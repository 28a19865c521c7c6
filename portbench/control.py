"""The readings a cell's limits are set from: the program's compared
numbers over many seeds, and the control's, in one process.

    python3 portbench/control.py --workload <name> --seeds 1,2,3 \
        --seconds 4

For each seed: the cell's set-up and a window of ``--seconds`` as a run
of ``run.py`` makes them, the program's numbers (the lower readings),
then the control's (the upper readings): the plain reference put in the
program's place for the closing round or cycle and for each recorded
answer, computed one precision below the configuration's float32
(bfloat16 logits for LDA, TF32 products for MF).  With ``--fault
<name>``, a fault of :mod:`portbench.faults` is planted under each
window instead, and the line holds the program's numbers under it.  One
JSON line a seed.  Not part of a benchmark run.
"""
import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def readings(run) -> dict:
    """The program's numbers and the control's after ``run``'s window."""
    cell, snap = run.cell, run.win.snapshot
    ctrl = cell.training_numbers(snap, cell.control_outputs(snap))
    if run.frontend is not None:
        ctrl.update(cell.query_numbers(cell.control_answers(run.answers())))
    return {"program": run.numbers(), "control": ctrl}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--fault", default=None)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch
    from portbench import harness
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        run = harness.Run(args.workload, seed, args.seconds, False)
        if args.fault:
            from portbench import faults
            patch = faults.Patch()
            faults.FAULTS[args.fault](patch, run.cfg["kind"])
            run.measure()
            patch.undo()
            got = {"fault": args.fault, "program": run.numbers()}
        else:
            run.measure()
            got = readings(run)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "rounds": run.win.rounds,
                          "phase_lead": run.cell.close_lead,
                          "peak_bytes": int(run.peak), **got,
                          "seconds": time.perf_counter() - t0}), flush=True)
        del run
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
