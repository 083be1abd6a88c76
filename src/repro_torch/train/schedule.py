"""Learning-rate schedules: pure functions of the step (an int or a
tensor) returning an f32 tensor, as the JAX package's ``train/schedule.py``
does."""

from __future__ import annotations

import math

import torch

F32 = torch.float32


def _step(step) -> torch.Tensor:
    return torch.as_tensor(step).to(F32)


def warmup_cosine(peak_lr: float, *, warmup_steps: int = 200,
                  total_steps: int = 10_000, final_frac: float = 0.1):
    """Linear warmup to ``peak_lr`` over ``warmup_steps``, then a cosine
    down to ``final_frac * peak_lr`` at ``total_steps``."""
    def lr(step):
        step = _step(step)
        warm = peak_lr * (step + 1.0) / max(warmup_steps, 1)
        frac = torch.clamp((step - warmup_steps)
                           / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = final_frac + (1 - final_frac) * 0.5 \
            * (1 + torch.cos(math.pi * frac))
        return torch.where(step < warmup_steps, warm, peak_lr * cos)
    return lr


def constant(lr_value: float):
    return lambda step: torch.full((), lr_value, dtype=F32,
                                   device=torch.as_tensor(step).device)
