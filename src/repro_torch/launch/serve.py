"""STRADS serving CLI of the port: bounded-staleness reads while training
continues, from the JAX package's ``launch/serve.py``.

    PYTHONPATH=src python -m repro_torch.launch.serve --engine lasso \\
        --plan examples/plans/ssp_s2.json --requests 64
    PYTHONPATH=src python -m repro_torch.launch.serve --engine lda \\
        --requests 32 --device cpu

Builds a small synthetic workload for one of the three paper apps (the
JAX package's sizes and numpy draws, from ``--seed``), runs
:func:`repro_torch.serve.serve_while_training` (or, with
``--serve-only``, trains first and serves the final state), and reports
p50/p99 request latency, throughput, and the measured staleness-at-read
histogram — every read is checked against ``ServeSpec.max_staleness``,
and the exit is nonzero if the bound was violated.  ``--trace`` exports
a Chrome trace of serve batches interleaved with training chunks;
``--out`` writes the JSON artifact (spec and plan embedded).  Runs on
the card unless ``--device cpu``.

``--stream`` folds a deterministic drift source (the JAX package's
``_drift_source`` dimensions, from ``--seed``) into the training data at
the chunk boundaries (``--stream-kind``: ``replace`` for lasso,
``extend`` otherwise; ``--ingest-every``: one SSP window by default,
aligned up to whole windows) and prints ``rows ingested=``.
"""
from __future__ import annotations

import argparse
import json
import math
import time

import numpy as np
import torch

ENGINES = ("lasso", "lda", "mf")


def _build(engine: str, workers: int, seed: int, device):
    """(eng, state, data, request payload fn) at serving-smoke scale."""
    rng = np.random.default_rng(seed)
    if engine == "lasso":
        from ..apps import lasso
        n, J = workers * 32, 128
        X, y, _ = lasso.synthetic_correlated(rng, n=n, J=J, k_true=8)
        cfg = lasso.LassoConfig(num_features=J, lam=0.02, block_size=8,
                                num_candidates=32)
        eng = lasso.make_engine(cfg, workers=workers, device=device)
        data = eng.shard_data({"X": X, "y": y})
        state = eng.init_state(y=y)
        Xq = X.copy()          # on the CPU the data shares X's memory,
                               # and --stream writes it in place

        def payload(i):
            return {"x": Xq[i % n]}
    elif engine == "lda":
        from ..apps import lda
        cfg = lda.LDAConfig(vocab=workers * 32, num_topics=8,
                            num_workers=workers, tokens_per_worker=64,
                            docs_per_worker=8)
        words, docs, z0 = lda.synthetic_corpus(rng, cfg, true_topics=4)
        eng = lda.make_engine(cfg, device=device)
        data = eng.shard_data({"words": words, "docs": docs})
        state = eng.init_state(words=words, docs=docs, z0=z0)
        docs_q = rng.integers(0, cfg.vocab, size=(256, 16)).astype(np.int32)

        def payload(i):
            return {"words": docs_q[i % len(docs_q)]}
    elif engine == "mf":
        from ..apps import mf
        N, M = workers * 16, 64
        A, mask = mf.synthetic_ratings(rng, N, M, true_rank=4)
        cfg = mf.MFConfig(num_rows=N, num_cols=M, rank=8)
        eng = mf.make_engine(cfg, workers=workers, device=device)
        data = eng.shard_data({"A": A, "mask": mask})
        state = eng.init_state(
            A=torch.as_tensor(A, device=eng.device),
            mask=torch.as_tensor(mask, device=eng.device),
            generator=torch.Generator(device=eng.device).manual_seed(seed))

        def payload(i):
            return {"user": np.int32(i % N)}
    else:
        raise SystemExit(f"unknown engine {engine!r}")
    return eng, state, data, payload


def _phase_period(engine: str, workers: int) -> int:
    return workers if engine == "lda" else {"lasso": 1, "mf": 2}[engine]


def _drift_source(engine: str, workers: int, kind: str, seed: int):
    """A deterministic drift source matching ``_build``'s workload
    dimensions (fresh rows every ingest boundary)."""
    from ..stream import LassoDriftSource, LDADriftSource, MFDriftSource
    if engine == "lasso":
        return LassoDriftSource(num_rows=workers * 32, num_features=128,
                                rows_per_ingest=4 * workers,
                                seed=seed + 2)
    if engine == "lda":
        return LDADriftSource(num_tokens=workers * 64,
                              vocab=workers * 32, num_topics=8,
                              docs_per_worker=8,
                              tokens_per_ingest=8 * workers, kind=kind,
                              seed=seed + 2)
    return MFDriftSource(num_rows=workers * 16, num_cols=64,
                         rows_per_ingest=2 * workers, true_rank=4,
                         kind=kind, seed=seed + 2)


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="serve model state out of the STRADS SSP caches")
    ap.add_argument("--engine", choices=ENGINES, required=True)
    ap.add_argument("--plan", default="",
                    help="ExecutionPlan JSON file (conflicts with "
                         "--rounds/--staleness/--workers)")
    ap.add_argument("--rounds", type=int, default=None)
    ap.add_argument("--staleness", type=int, default=None)
    ap.add_argument("--workers", type=int, default=None)
    ap.add_argument("--requests", type=int, default=32)
    ap.add_argument("--serve-kind", choices=("stale", "snapshot"),
                    default="stale")
    ap.add_argument("--max-staleness", type=int, default=None,
                    help="serving staleness bound in rounds (stale kind "
                         "only; default: the plan's SSP staleness)")
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--batch-window-ms", type=float, default=0.0)
    ap.add_argument("--serve-only", action="store_true",
                    help="train first, then serve the final state "
                         "(no interleaving)")
    ap.add_argument("--stream", action="store_true",
                    help="fold synthetic drift deltas into the training "
                         "data at chunk boundaries (repro_torch.stream)")
    ap.add_argument("--stream-kind", choices=("replace", "extend"),
                    default=None,
                    help="StreamSpec kind (default: replace for lasso, "
                         "extend otherwise)")
    ap.add_argument("--ingest-every", type=int, default=None,
                    help="ingest cadence in rounds (default: one SSP "
                         "window; aligned up like --rounds)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="where the engine runs (default: the card)")
    ap.add_argument("--trace", default="",
                    help="write a Chrome trace of the interleaved run")
    ap.add_argument("--out", default="",
                    help="write the JSON artifact (spec/plan embedded)")
    args = ap.parse_args(argv)

    if not args.stream:
        for flag, name in ((args.stream_kind, "--stream-kind"),
                           (args.ingest_every, "--ingest-every")):
            if flag is not None:
                raise SystemExit(f"{name} needs --stream (it configures "
                                 f"the streaming ingest)")

    from ..core import ExecutionPlan, resolve_device
    from ..obs import Recorder
    from ..serve import ServeSpec, serve_only, serve_while_training

    device = resolve_device(args.device)
    if args.plan:
        for flag, name in ((args.rounds, "--rounds"),
                           (args.staleness, "--staleness"),
                           (args.workers, "--workers")):
            if flag is not None:
                raise SystemExit(f"{name} conflicts with --plan (the "
                                 f"plan file already declares it)")
        with open(args.plan) as f:
            plan = ExecutionPlan.from_json(f.read())
        workers = plan.workers or 1
    else:
        workers = args.workers or 1
        staleness = 1 if args.staleness is None else args.staleness
        rounds = 12 if args.rounds is None else args.rounds
        # whole SSP windows: round up to lcm(s+1, phase_period) steps
        L = math.lcm(staleness + 1, _phase_period(args.engine, workers))
        aligned = -(-rounds // L) * L
        if aligned != rounds:
            print(f"[align] rounds {rounds} -> {aligned} "
                  f"(whole SSP windows of {L})")
        plan = ExecutionPlan(executor="ssp", rounds=aligned,
                             staleness=staleness, workers=workers)

    kw = dict(max_batch=args.max_batch,
              batch_window_ms=args.batch_window_ms)
    if args.serve_kind == "stale":
        kw["max_staleness"] = (args.max_staleness
                               if args.max_staleness is not None
                               else (plan.staleness
                                     if plan.executor == "ssp" else 0))
    elif args.max_staleness is not None:
        raise SystemExit("--max-staleness applies to --serve-kind stale "
                         "only (snapshot pins at boundaries)")
    spec = ServeSpec.default_for(args.serve_kind, **kw)

    eng, state, data, payload = _build(args.engine, workers, args.seed,
                                       device)
    rec = Recorder()
    gen = torch.Generator(device=device).manual_seed(args.seed + 1)

    stream_kw: dict = {}
    sspec = None
    if args.stream:
        from ..stream import StreamSpec
        kind = args.stream_kind or ("replace" if args.engine == "lasso"
                                    else "extend")
        L = math.lcm((plan.staleness + 1) if plan.executor == "ssp"
                     else 1, _phase_period(args.engine, workers))
        every = args.ingest_every if args.ingest_every else L
        aligned = -(-every // L) * L
        if aligned != every:
            print(f"[align] ingest-every {every} -> {aligned} "
                  f"(whole boundary windows of {L})")
        sspec = StreamSpec.default_for(kind, ingest_every=aligned)
        stream_kw = dict(stream=sspec,
                         source=_drift_source(args.engine, workers,
                                              kind, args.seed))

    t0 = time.perf_counter()
    if args.serve_only:
        rep0 = eng.execute(state, data, gen, plan, **stream_kw)
        srep = serve_only(eng, rep0.state, spec=spec,
                          requests=[payload(i)
                                    for i in range(args.requests)],
                          t=plan.rounds, recorder=rec)
        srep.ingest = rep0.stream
    else:
        reqs = [((i * plan.rounds) // max(args.requests, 1), payload(i))
                for i in range(args.requests)]
        srep = serve_while_training(eng, state, data, gen, plan,
                                    spec=spec, requests=reqs,
                                    recorder=rec, **stream_kw)
    secs = time.perf_counter() - t0

    pct = srep.latency_percentiles()
    hist = srep.staleness_hist()
    worst = srep.max_staleness_read()
    print(f"engine={args.engine} workers={workers} "
          f"executor={plan.executor} rounds={plan.rounds} "
          f"requests={len(srep.responses)} device={device}")
    print(f"serve spec: {spec.to_json()}")
    print(f"latency p50={pct['p50_ms']:.2f}ms p99={pct['p99_ms']:.2f}ms "
          f"({len(srep.responses) / secs:.1f} requests/s over {secs:.2f} s)")
    if srep.ingest is not None:
        print(f"stream spec: {sspec.to_json()}")
        print(f"rows ingested={int(srep.ingest['rows_in'])} "
              f"dropped={int(srep.ingest['rows_dropped'])}")
    print(f"staleness-at-read hist: "
          f"{ {k: hist[k] for k in sorted(hist)} } (max {worst})")
    if args.trace:
        rec.write_chrome_trace(args.trace)
        print(f"wrote {args.trace}")
    if args.out:
        artifact = {
            "engine": args.engine, "workers": workers,
            "device": str(device), "requests": len(srep.responses),
            "seconds": secs, "serve_spec": spec.to_json(),
            "plan": plan.to_json(), "latency": pct,
            "staleness_hist": {str(k): v for k, v in hist.items()},
            "max_staleness_read": worst, "reads": srep.reads,
        }
        if srep.ingest is not None:
            artifact["stream_spec"] = sspec.to_json()
            artifact["ingest"] = {k: int(v)
                                  for k, v in srep.ingest.items()}
        with open(args.out, "w") as f:
            json.dump(artifact, f, indent=1)
        print(f"wrote {args.out}")
    if spec.kind == "stale" and worst > spec.max_staleness:
        raise SystemExit(f"staleness bound violated: read at {worst} > "
                         f"max_staleness {spec.max_staleness}")
    return srep


if __name__ == "__main__":
    main()
