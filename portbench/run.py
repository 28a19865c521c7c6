"""Run one cell of the port's benchmark once, on the card it starts on.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  Prints one JSON object as the last line of
standard output: ``correct``, ``attempted``, ``failed``, ``metrics``
(the cell's end-to-end metrics, or with ``--trace 1`` its per-layer
ones), ``device``, with ``--trace 1`` ``breakdown``, and last ``check``,
each compared number beside its limit; the same numbers are the last
lines of standard error.  Exits with another code than 0, and prints no
result, without a card or with fewer cards than the cell asks for, when
the program cannot be imported, or when a module of JAX or of the JAX
package is loaded once the window has closed.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def _caches() -> None:
    """Every build and kernel cache at a fixed path inside the checkout."""
    base = ROOT / "build" / "portbench"
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda_cache")):
        os.environ[var] = str(base / sub)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _caches()
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    try:
        import torch
        from portbench import harness
        import repro_torch  # noqa: F401
    except ImportError as exc:
        print(f"portbench: cannot import the program: {exc}",
              file=sys.stderr)
        return 2
    bench = harness.load_benchmark()
    entry = harness.cell_entry(bench, args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < entry["chips"]:
        print(f"portbench: {args.workload} needs {entry['chips']} card(s); "
              f"CUDA available {torch.cuda.is_available()}, "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              f" found", file=sys.stderr)
        return 3
    out = harness.run_cell(args.workload, args.seed, args.seconds,
                           bool(args.trace), t_start=T_START, bench=bench)
    bad = harness.loaded_forbidden()
    if bad:
        print(f"portbench: modules of JAX or the JAX package loaded: {bad}",
              file=sys.stderr)
        return 4
    print(json.dumps(out["diag"]), file=sys.stderr)
    for name, v, lim in out["check"]:
        print(f"check {name} {v} limit {lim}", file=sys.stderr)
    print(json.dumps(out["result"]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
