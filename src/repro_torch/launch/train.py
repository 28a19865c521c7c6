"""End-to-end training driver of the model zoo.

    PYTHONPATH=src python -m repro_torch.launch.train --arch minicpm-2b \
        --preset reduced --steps 200 --batch 8 --seq 256 --device cpu
    python -m repro_torch.launch.train --arch minicpm-2b --preset full \
        --batch 4 --seq 2048 --steps 8 [--strads]
    PYTHONPATH=src python -m repro_torch.launch.train --arch hubert-xlarge \
        --preset reduced --steps 4 --batch 2 --seq 32 --device cpu

The port of the JAX package's ``launch/train.py``, with its flags, its
errors, its log lines and its last JSON line: synthetic batches
(:func:`repro_torch.data.make_batch`; frame embeddings for an audio arch,
patch embeddings ahead of the tokens for a vision one) → train step
(AdamW and the
schedule: WSD for MiniCPM, its paper's, else cosine) → checkpoints.
``--strads`` trains block-coordinate scheduled (:mod:`repro_torch.sched.
block`); the block policy is a ``block_structural`` ``SchedulerSpec``
(``--scheduler``/``--rho``, or ``plan.scheduler``).  ``--staleness s``
serves the block schedule from a cache refreshed every s + 1 steps.
``--plan plan.json`` drives rounds → steps, ``phase_unroll`` → the scan
chunk, ``staleness`` and ``checkpoint_every`` from an
:class:`~repro_torch.core.ExecutionPlan`.

Added here: ``--device`` (default ``cuda``), ``--layers`` (cut the depth;
default the config's own) and ``--weight-decay`` (AdamW's decoupled
decay, default 0.1; at 0 the layers a STRADS step does not schedule keep
their bits).  ``--scan-steps K`` runs K eager steps between host reads of
the metrics (the JAX package scans them in one program); the states equal
K = 1's to the bit.  Steps write the new parameters and moments into the
state's tensors (the JAX package donates them).  Checkpoints
(``--ckpt-dir``) hold the full state, so ``--resume`` continues the run
to the bit.  ``main(argv)`` returns the history (one dict per logged
step); ``on_step(i, state, metrics)`` is called after each step (or
chunk), and once before the first with ``metrics=None``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time

import torch

from ..checkpoint import latest_step, restore_checkpoint, save_checkpoint
from ..configs import ARCHS, get_config
from ..core import resolve_device
from ..data import SyntheticLMConfig, frontend_batch_kwargs, make_batch
from ..optim import AdamWConfig, cosine_schedule, wsd_schedule
from ..sched import SchedulerSpec
from ..sched.block import config_from_spec
from ..train import TrainConfig, init_train_state, make_train_step
from ..train.step import (init_strads_state, make_strads_train_step,
                          num_layer_blocks)


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCHS, default="minicpm-2b")
    ap.add_argument("--preset", choices=("reduced", "full"),
                    default="reduced")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--schedule", choices=("cosine", "wsd"), default=None)
    ap.add_argument("--strads", action="store_true",
                    help="STRADS block-coordinate scheduled updates")
    ap.add_argument("--scan-steps", type=int, default=1,
                    help="steps between host reads of the metrics")
    ap.add_argument("--blocks-per-step", type=int, default=0,
                    help="U for --strads (default: half the blocks)")
    ap.add_argument("--staleness", type=int, default=0,
                    help="SSP-style stale block schedule for --strads: "
                         "recompute the schedule every s+1 steps only")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--resume", action="store_true",
                    help="continue from the latest checkpoint in "
                         "--ckpt-dir (bit-exact: full state is saved)")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--plan", default="",
                    help="ExecutionPlan JSON driving the run shape: "
                         "rounds→steps, phase_unroll→scan-steps (scanned "
                         "executors), staleness→--staleness (implies "
                         "--strads), checkpoint_every→--ckpt-every, "
                         "scheduler→the --strads block policy; overrides "
                         "those flags")
    ap.add_argument("--scheduler", default="",
                    help="SchedulerSpec kind for the --strads block "
                         "schedule (only 'block_structural' has a "
                         "trainer lowering); implies --strads")
    ap.add_argument("--rho", type=float, default=None,
                    help="structural-filter threshold ρ for --scheduler")
    ap.add_argument("--weight-decay", type=float,
                    default=AdamWConfig().weight_decay,
                    help="AdamW's decoupled weight decay")
    ap.add_argument("--layers", type=int, default=0,
                    help="layers (default: the config's own)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the kernels' plain "
                         "versions)")
    args = ap.parse_args(argv)

    if args.plan and (args.scheduler or args.rho is not None):
        ap.error("--scheduler/--rho conflict with --plan (the plan's "
                 "scheduler field — possibly null = default — is "
                 "authoritative); edit the plan file instead")
    args.sched_spec = None
    if args.plan:
        from ..core import ExecutionPlan
        with open(args.plan) as f:
            plan = ExecutionPlan.from_json(f.read())
        unsupported = [name for name, v in
                       (("telemetry", plan.telemetry),
                        ("collect_every", plan.collect_every),
                        ("workers", plan.workers),
                        # block-coordinate training has no variable-
                        # ownership store to repartition
                        ("partitioner", plan.partitioner),
                        # ...and no lasso_partial/gram_block hot-spots
                        ("kernels", plan.kernels)) if v]
        if unsupported:
            ap.error(f"--plan fields the trainer has no surface for "
                     f"(they would be silently dropped): {unsupported}")
        args.steps = plan.rounds
        args.scan_steps = (plan.phase_unroll
                           if plan.executor in ("scan", "pipelined")
                           else 1)
        args.staleness = plan.staleness
        if plan.staleness:
            args.strads = True           # stale schedules are strads-only
        if plan.checkpoint_every:
            args.ckpt_every = plan.checkpoint_every
        if plan.scheduler is not None:
            args.sched_spec = plan.scheduler
            args.strads = True           # a block policy is strads-only
        print(f"plan: {plan.to_json()}")
    elif args.scheduler or args.rho is not None:
        kind = args.scheduler or "block_structural"
        if kind != "block_structural":
            ap.error(f"the trainer's block-coordinate lowering only "
                     f"takes kind='block_structural'; got {kind!r} "
                     f"(the paper apps take any kind via their fit "
                     f"plans)")
        args.strads = True               # spec built once nblocks is known
    if (args.sched_spec is not None
            and args.sched_spec.kind != "block_structural"):
        ap.error(f"plan.scheduler kind {args.sched_spec.kind!r} has no "
                 f"trainer lowering (block-coordinate training needs "
                 f"'block_structural')")
    return args


def _schedule(args):
    """WSD for MiniCPM (its paper's schedule), else cosine."""
    kind = args.schedule or ("wsd" if args.arch == "minicpm-2b"
                             else "cosine")
    if kind == "wsd":
        return wsd_schedule(args.lr, args.steps // 10,
                            int(args.steps * 0.7),
                            args.steps - args.steps // 10
                            - int(args.steps * 0.7))
    return cosine_schedule(args.lr, args.steps // 10, args.steps)


def main(argv=None, on_step=None):
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.preset == "reduced":
        cfg = cfg.reduced()
    if args.layers:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    tc = TrainConfig(adamw=AdamWConfig(weight_decay=args.weight_decay),
                     schedule=_schedule(args))
    print(f"arch={cfg.name} preset={args.preset} layers={cfg.num_layers} "
          f"device={device}")

    gen = torch.Generator(device=device).manual_seed(args.seed)
    if args.strads:
        nblocks = num_layer_blocks(cfg) + 1
        u = args.blocks_per_step or max(1, nblocks // 2)
        sched_spec = args.sched_spec
        if sched_spec is None:
            # the conventional block_structural defaults, with the
            # trainer's adjacency radius of 1 layer group
            sched_spec = SchedulerSpec.default_for(
                "block_structural", block_size=u,
                num_candidates=min(nblocks, 2 * u), min_distance=1,
                **({"rho": args.rho} if args.rho is not None else {}))
        sched = config_from_spec(sched_spec, nblocks)
        state = init_strads_state(cfg, tc, sched, gen,
                                  staleness=args.staleness)
        step_fn = make_strads_train_step(cfg, tc, sched,
                                         staleness=args.staleness,
                                         donate=True)
        print(f"STRADS block scheduling: {sched.blocks_per_step}/"
              f"{nblocks} blocks per step "
              f"(spec: {sched_spec.to_json()})"
              + (f", schedule staleness {args.staleness}"
                 if args.staleness else ""))
    else:
        state = init_train_state(cfg, tc, gen)
        step_fn = make_train_step(cfg, tc, donate=True)
    dcfg = SyntheticLMConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                             batch_size=args.batch, seed=args.seed)
    dkw = {"device": device, **frontend_batch_kwargs(cfg)}

    def log_step(i, metrics, t0, history):
        m = {k: float(v) for k, v in metrics.items() if v.numel() == 1}
        now = time.time()
        m["step"] = i
        m["wall_s"] = round(now - t0, 1)
        m["step_ms"] = (now - clock["t"]) * 1e3 / (i - clock["i"])
        clock.update(t=now, i=i)
        history.append(m)
        print(f"step {i:5d}  loss {m['loss']:.4f}  acc {m['acc']:.3f}"
              f"  gnorm {m['grad_norm']:.2f}  lr {m['lr']:.2e}"
              f"  [{m['wall_s']}s]")

    def maybe_ckpt(i, chunk):
        # a chunk fires if ANY of its steps crossed a ckpt_every boundary
        # (the saved state is the chunk's last)
        if args.ckpt_dir and any((j + 1) % args.ckpt_every == 0
                                 for j in chunk):
            p = save_checkpoint(args.ckpt_dir, i + 1, state)
            print(f"checkpoint → {p}")

    start0 = 0
    if args.resume and args.ckpt_dir:
        last = latest_step(args.ckpt_dir)
        if last is not None:
            state = restore_checkpoint(args.ckpt_dir, last, state)
            start0 = last
            print(f"resumed from step {last} ({args.ckpt_dir})")

    history = []
    if on_step is not None:
        on_step(start0 - 1, state, None)
    t0 = time.time()
    clock = {"t": t0, "i": start0 - 1}
    K = max(1, args.scan_steps)
    for start in range(start0, args.steps, K):
        steps = range(start, min(start + K, args.steps))
        for j in steps:
            state, metrics = step_fn(state, make_batch(dcfg, j, **dkw))
        last = steps[-1]
        if on_step is not None:
            on_step(last, state, metrics)
        if (any(j % args.log_every == 0 for j in steps)
                or last == args.steps - 1):
            log_step(last, metrics, t0, history)
        maybe_ckpt(last, steps)
    if history:
        print(json.dumps({"first_loss": history[0]["loss"],
                          "last_loss": history[-1]["loss"],
                          "steps": args.steps,
                          "wall_s": history[-1]["wall_s"]}))
    return history


if __name__ == "__main__":
    main()
