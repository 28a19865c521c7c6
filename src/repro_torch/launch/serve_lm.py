"""Model-zoo LM decode driver: prefill a batch of prompts, decode N tokens.

    PYTHONPATH=src python -m repro_torch.launch.serve_lm \
        --arch phi3.5-moe-42b-a6.6b --preset full --layers 24 \
        --batch 4 --prompt-len 1024 --gen 32
    PYTHONPATH=src python -m repro_torch.launch.serve_lm \
        --arch zamba2-2.7b --preset full --batch 4 --prompt-len 1000 --gen 32
    PYTHONPATH=src python -m repro_torch.launch.serve_lm \
        --arch internvl2-1b --preset reduced --device cpu

The port of the JAX package's ``launch/serve_lm.py``, with the same
options plus ``--layers`` (cut the depth; default the config's own) and
``--device`` (default ``cuda``; ``cpu`` runs the plain versions of the
kernels).  For the hybrid family ``--layers`` must be a multiple of
``attn_every``.  Weights are random, drawn from ``--seed``; the prompts are
:func:`repro_torch.data.make_batch`'s synthetic tokens (a vision arch's
with its ``frontend_tokens`` patch embeddings ahead, which the cache
counts).  An encoder-only arch (HuBERT) is refused.  After a warm-up
it prints the prefill time, the generate rate (tokens over the whole
prefill + decode run) and the first sample tokens.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Optional

import torch

from ..configs import ARCHS, get_config
from ..core import resolve_device
from ..data import SyntheticLMConfig, frontend_batch_kwargs, make_batch
from ..models import model as M
from ..train.serve import greedy_generate


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", choices=ARCHS, default="granite-3-2b")
    ap.add_argument("--preset", choices=("reduced", "full"),
                    default="reduced")
    ap.add_argument("--layers", type=int, default=0,
                    help="number of layers (default: the config's own)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--window", type=int, default=0,
                    help="sliding-window decode (ring-buffer cache)")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


@dataclasses.dataclass
class Server:
    """A model ready to serve: config, weights, prompts and cache size."""
    cfg: object
    params: dict
    batch: dict
    cache_len: int
    window: Optional[int]
    device: torch.device

    def generate(self, steps: int, temperature: float = 0.0,
                 generator: Optional[torch.Generator] = None
                 ) -> torch.Tensor:
        return greedy_generate(self.cfg, self.params, self.batch,
                               steps=steps, cache_len=self.cache_len,
                               window=self.window, generator=generator,
                               temperature=temperature)


def build(args: argparse.Namespace) -> Server:
    """The config (preset, then ``--layers``), random weights from
    ``--seed`` on ``--device`` and the prompt batch."""
    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.preset == "reduced":
        cfg = cfg.reduced()
    if args.layers:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    if cfg.encoder_only:
        raise SystemExit(f"{cfg.name} is encoder-only: no decode serving")
    if cfg.family == "hybrid" and cfg.num_layers % cfg.attn_every:
        raise ValueError(f"{cfg.name}: --layers {cfg.num_layers} is not a "
                         f"multiple of attn_every={cfg.attn_every} (the "
                         f"shared attention block follows every "
                         f"{cfg.attn_every} mamba layers)")
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = M.init_params(cfg, gen)
    dcfg = SyntheticLMConfig(vocab_size=cfg.vocab_size,
                             seq_len=args.prompt_len,
                             batch_size=args.batch, seed=args.seed)
    batch = make_batch(dcfg, 0, device=device, **frontend_batch_kwargs(cfg))
    batch.pop("labels")
    window = args.window or None
    total = args.prompt_len + args.gen + M.num_frontend_tokens(cfg)
    cache_len = min(window, total) if window else total
    return Server(cfg, params, batch, cache_len, window, device)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None) -> torch.Tensor:
    args = parse_args(argv)
    srv = build(args)
    gen = torch.Generator(device=srv.device).manual_seed(args.seed)
    with torch.inference_mode():
        srv.generate(1)                           # warm-up, not timed
        _sync(srv.device)
        t0 = time.perf_counter()
        M.prefill(srv.cfg, srv.params, srv.batch, cache_len=srv.cache_len,
                  window=srv.window)
        _sync(srv.device)
        prefill_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        toks = srv.generate(args.gen, args.temperature, gen)
        _sync(srv.device)
        wall = time.perf_counter() - t0
    print(f"arch={srv.cfg.name} layers={srv.cfg.num_layers} "
          f"batch={args.batch} prompt={args.prompt_len} gen={args.gen} "
          f"cache={srv.cache_len} window={srv.window} device={srv.device}")
    print(f"prefill {prefill_s * 1e3:.1f} ms; generate (prefill + "
          f"{args.gen} decode steps) {wall:.2f} s, "
          f"{args.batch * args.gen / wall:.1f} tok/s")
    print("sample tokens:", toks[0, :16].tolist())
    return toks


if __name__ == "__main__":
    main()
