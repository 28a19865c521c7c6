"""Learning-rate schedules: cosine with warmup, and WSD (warmup–stable–
decay, the MiniCPM schedule [arXiv:2404.06395]).

The port of the JAX package's ``optim/schedules.py``.  A schedule maps a
step (an int or an integer tensor, on any device) to a 0-dim float32
tensor on the step's device, computed in float32 as the JAX package
computes it: a learning rate rounded from Python floats instead would
differ in its last bits, and every parameter with it after one step.
"""
from __future__ import annotations

import math

import torch


def _f32(step) -> torch.Tensor:
    if torch.is_tensor(step):
        return step.to(torch.float32)
    return torch.tensor(step, dtype=torch.float32)


def cosine_schedule(peak_lr: float, warmup: int, total: int,
                    floor_frac: float = 0.1):
    def lr(step):
        s = _f32(step)
        warm = peak_lr * s / max(warmup, 1)
        t = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = floor_frac * peak_lr + (1 - floor_frac) * peak_lr \
            * 0.5 * (1 + torch.cos(math.pi * t))
        return torch.where(s < warmup, warm, cos)
    return lr


def wsd_schedule(peak_lr: float, warmup: int, stable: int, decay: int,
                 floor_frac: float = 0.01):
    """Warmup → flat plateau → short exponential decay tail."""
    def lr(step):
        s = _f32(step)
        warm = peak_lr * s / max(warmup, 1)
        t = torch.clamp((s - warmup - stable) / max(decay, 1), 0.0, 1.0)
        tail = peak_lr * torch.pow(floor_frac, t)
        peak = torch.full_like(s, peak_lr)
        return torch.where(s < warmup, warm,
                           torch.where(s < warmup + stable, peak, tail))
    return lr
