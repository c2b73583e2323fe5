"""LR schedules: the port of ``repro.optim.schedule``, pure functions of
the step counter in f32 on the counter's device."""

from __future__ import annotations

import math

import torch


def cosine_schedule(step, *, peak: float, warmup: int = 100, total: int = 10000,
                    floor_ratio: float = 0.1) -> torch.Tensor:
    """Linear warmup from 0 (the lr at step 0 is 0) to ``peak`` over
    ``warmup`` steps, then a cosine down to ``floor_ratio * peak`` at
    ``total``. ``step`` is an int or an integer tensor; the result is an f32
    0-d tensor on its device. Each operation rounds as the reference's: the
    divisors are f32 tensors, not Python scalars (CUDA divides by a Python
    scalar as a multiply by its rounded reciprocal)."""
    t = torch.as_tensor(step).to(torch.float32)
    warm = peak * t / t.new_full((), max(1.0, float(warmup)))
    prog = torch.clamp((t - warmup) / t.new_full((), max(1.0, float(total - warmup))),
                       0.0, 1.0)
    cos = peak * (floor_ratio + (1 - floor_ratio) * 0.5 * (1 + torch.cos(math.pi * prog)))
    return torch.where(t < warmup, warm, cos)
